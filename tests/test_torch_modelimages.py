"""Model images, the preprocess branches that use them, noise-model
catalogs, the given-filter step and the multi-pass ``filterSets`` config:
the port against the JAX package, float64 on the CPU, on numpy-seeded
inputs.

* ``maps.makeModelImage``, each of its three routes (one ``override``
  model, clusters row by row, point sources), rtol 1e-10 of the map's peak;
* each preprocess branch (``injectSources``, ``applyBeamConvolution``,
  ``smoothKernel``, ``subtractModelFromCatalog``,
  ``apodizeUsingSurveyMask``) against ``MapDict.preprocess``, 1e-10;
* a filter whose noise term subtracts a ``noiseModelCatalog``, 1e-9;
* the batched given-filter step (cached-filter reruns) against JAX's,
  lean, full and detection tails, 1e-10;
* the multi-pass config of ``tests/test_multipass.py`` (point sources,
  then clusters with the sources subtracted from the maps and the noise
  term) through both packages' pipelines: the catalogs of both passes
  equal at rtol 1e-6.
"""

import contextlib
import copy
import hashlib
import os
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from nemo_tpu import filters as jfilters
from nemo_tpu import maps as jmaps
from nemo_tpu import pipelines as jpipelines
from nemo_tpu import startup as jstartup
from nemo_tpu.parallel import distribute as jdist
from nemo_tpu.parallel.mesh import get_mesh
from nemo_tpu_torch import filters, maps, pipelines, startup
from nemo_tpu_torch.device import CPU
from nemo_tpu_torch.models import beams
from nemo_tpu_torch.ops import paint
from nemo_tpu_torch.parallel import distribute
from nemo_tpu_torch.utils import fits as nfits
from nemo_tpu_torch.utils import wcs as nwcs
from nemo_tpu_torch.utils.tables import Table
from tests.test_torch_cuda import STEP_GRID, step_inputs

SHAPE = (180, 240)
PIX_ARCMIN = 0.5
DEC = -35.0         # cos(dec) varies over the tile: dx_rows matters


def close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    """A seeded two-band tile of white noise written as FITS with weights,
    a survey mask covering a third of it, and Gaussian beams; catalogs for
    each model-image route."""
    work = str(tmp_path_factory.mktemp("modelimages"))
    rng = np.random.default_rng(17)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=40.0,
                     centreDecDeg=DEC)
    entries = []
    for band, freq, fwhm, noise in (("f150", 149.6, 1.4, 20.0),
                                    ("f090", 97.8, 2.1, 30.0)):
        beamPath = os.path.join(work, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamPath, fwhm)
        mapPath = os.path.join(work, "map_%s.fits" % band)
        nfits.write_image(mapPath, rng.normal(0, noise, SHAPE), w.header)
        weightPath = os.path.join(work, "ivar_%s.fits" % band)
        ivar = np.full(SHAPE, 1.0 / noise ** 2)
        ivar[:, :6] = 0.0
        nfits.write_image(weightPath, ivar, w.header)
        entries.append({"mapFileName": mapPath, "weightsFileName": weightPath,
                        "obsFreqGHz": freq, "units": "uK",
                        "beamFileName": beamPath})
    # the apodisation dilates the mask by 120 pixels before smoothing it:
    # only an area further than that from the survey is tapered
    mask = np.ones(SHAPE, dtype=np.uint8)
    mask[:, :170] = 0
    maskPath = os.path.join(work, "surveyMask.fits")
    nfits.write_image(maskPath, mask, w.header)

    def positions(n):
        xs = rng.uniform(15, SHAPE[1] - 15, n)
        ys = rng.uniform(15, SHAPE[0] - 15, n)
        c = w.pix2wcs(xs, ys)
        return c[:, 0], c[:, 1]

    ra, dec = positions(6)
    clusters = Table({"name": np.array(["c%d" % i for i in range(6)]),
                      "RADeg": ra, "decDeg": dec,
                      "y_c": rng.uniform(2, 6, 6),
                      "SNR": np.array([8.0, 3.0, 12.0, 6.0, 5.5, 9.0]),
                      "template": np.array(["Arnaud_M2e14_z0p4",
                                            "Arnaud_M4e14_z0p2"] * 3)})
    ra, dec = positions(4)
    truth = Table({"name": np.array(["t%d" % i for i in range(4)]),
                   "RADeg": ra, "decDeg": dec,
                   "true_M500c": np.array([1.5, 3.0, 6.0, 2.2]),
                   "redshift": np.array([0.3, 0.5, 0.2, 0.8]),
                   "true_y_c": rng.uniform(1, 5, 4)})
    ra, dec = positions(12)
    sources = Table({"name": np.array(["s%d" % i for i in range(12)]),
                     "RADeg": ra, "decDeg": dec,
                     "deltaT_c": rng.uniform(50, 3000, 12)})
    # each package reads its own Table class from a path
    sourcesPath = os.path.join(work, "sources.fits")
    sources.write(sourcesPath)
    return {"work": work, "wcs": w, "maps": entries, "mask": maskPath,
            "clusters": clusters, "truth": truth, "sources": sources,
            "sourcesPath": sourcesPath}


# -- makeModelImage ---------------------------------------------------------------

ROUTES = {
    # name: (catalog key, keyword arguments)
    "override": ("clusters", {"override": {"redshift": 0.4, "M500": 2e14}}),
    "override_valid_area": ("clusters", {
        "override": {"redshift": 0.4, "M500": 2e14}, "minSNR": 5.0,
        "validAreaSection": [20, 200, 10, 170]}),
    "template_rows": ("clusters", {}),
    "true_mass_rows": ("truth", {"profile": "B12"}),
    "point_sources": ("sources", {}),
    "no_pixel_window": ("sources", {"applyPixelWindow": False}),
}


def _checksum(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return hashlib.md5(str(a.dtype).encode() + str(a.shape).encode()
                       + a.tobytes()).hexdigest()[:12]


@contextlib.contextmanager
def recording_paint(log):
    """Record, for each ``paint_objects`` call, the torch thread count,
    whether denormals survive, a checksum of every input and of each stage
    in its order (the distances and profile values of ``interp``, the
    pixel index and values of ``_accumulate_in_order``, the output), and
    the objects' positions and window half-sizes."""
    paintObjects, interp, accumulate = (paint.paint_objects, paint.interp,
                                        paint._accumulate_in_order)

    def rec_interp(x, xp, fp, *a, **kw):
        out = interp(x, xp, fp, *a, **kw)
        if log and log[-1]["open"]:
            log[-1]["stages"] += [("interp x", _checksum(x)),
                                  ("interp xp", _checksum(xp)),
                                  ("interp fp", _checksum(fp)),
                                  ("interp out", _checksum(out))]
        return out

    def rec_accumulate(canvas, index, values):
        accumulate(canvas, index, values)
        if log and log[-1]["open"]:
            log[-1]["stages"] += [("pixel index", _checksum(index)),
                                  ("pixel values", _checksum(values)),
                                  ("canvas", _checksum(canvas))]

    def rec_paint(shape, pix, ys, xs, amps, r_prof, v_prof, rmax_rad,
                  dx_rows=None, **kw):
        dxr = np.full(shape[0], pix[1]) if dx_rows is None else dx_rows
        entry = {"open": True, "threads": torch.get_num_threads(),
                 "denormals": bool(torch.tensor(5e-324, dtype=torch.float64)
                                   * 1.0 != 0),
                 "inputs": {k: _checksum(v) for k, v in (
                     ("pix_scales", pix), ("ys", ys), ("xs", xs),
                     ("amps", amps), ("r_prof", r_prof),
                     ("v_prof", v_prof), ("rmax", rmax_rad),
                     ("dx_rows", dxr))},
                 "ys": np.atleast_1d(ys), "xs": np.atleast_1d(xs),
                 "wy": int(np.ceil(rmax_rad / pix[0])),
                 "wx": int(np.ceil(rmax_rad / np.min(dxr))), "stages": []}
        log.append(entry)
        out = paintObjects(shape, pix, ys, xs, amps, r_prof, v_prof,
                           rmax_rad, dx_rows=dx_rows, **kw)
        entry["stages"].append(("output", _checksum(out)))
        entry["open"] = False
        return out

    # paint_objects counts its calls on the name it is reached by
    rec_paint.calls = paintObjects.calls
    try:
        with mock.patch.object(paint, "paint_objects", rec_paint), \
                mock.patch.object(paint, "interp", rec_interp), \
                mock.patch.object(paint, "_accumulate_in_order",
                                  rec_accumulate):
            yield log
    finally:
        paintObjects.calls = rec_paint.calls


def describe_difference(got, dev, hostLog, devLog):
    """'' when the two maps are equal; else which pixels differ, by how
    much, in which objects' windows, and which recorded input or stage of
    ``paint_objects`` first differs between the two calls, with each
    call's torch thread count."""
    if np.array_equal(got, dev):
        return ""
    diff = np.abs(got - dev)
    bad = diff != 0
    lines = ["%d of %d pixels differ (max %.3e)" % (bad.sum(), bad.size,
                                                   diff.max())]
    for tag, log in (("host", hostLog), ("asDevice", devLog)):
        lines.append("%s call: %d paint_objects calls, torch threads %s, "
                     "denormals kept %s" % (tag, len(log),
                                            [e["threads"] for e in log],
                                            [e["denormals"] for e in log]))
    for i, (a, b) in enumerate(zip(hostLog, devLog)):
        inputs = [k for k in a["inputs"] if a["inputs"][k] != b["inputs"][k]]
        lines.append("paint_objects call %d: inputs that differ %s "
                     "(checksums host %s, asDevice %s)"
                     % (i, inputs or "none", a["inputs"], b["inputs"]))
        first = next((sa[0] for sa, sb in zip(a["stages"], b["stages"])
                      if sa != sb), None)
        lines.append("  first stage that differs: %s; stages host %s, "
                     "asDevice %s" % (first, a["stages"], b["stages"]))
        yy, xx = np.nonzero(bad)
        for j, (y0, x0) in enumerate(zip(a["ys"], a["xs"])):
            inWin = (np.abs(yy - np.floor(y0)) <= a["wy"] + 1) \
                & (np.abs(xx - np.floor(x0)) <= a["wx"] + 1)
            if inWin.any():
                lines.append("  object %d at (y %.3f, x %.3f): %d differing "
                             "pixels in its window, max %.3e"
                             % (j, y0, x0, inWin.sum(),
                                diff[yy[inWin], xx[inWin]].max()))
    return "\n".join(lines)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_make_model_image_matches_jax(sky, route):
    key, kw = ROUTES[route]
    args = (SHAPE, sky["wcs"], sky[key], sky["maps"][0]["beamFileName"])
    ref = jmaps.makeModelImage(*args, obsFreqGHz=149.6, **kw)
    with recording_paint([]) as hostLog:
        got = maps.makeModelImage(*args, obsFreqGHz=149.6, policy=CPU,
                                  **kw)
    assert got.dtype == np.float64 and got.flags.writeable
    close(got, ref, 1e-10)
    with recording_paint([]) as devLog:
        dev = maps.makeModelImage(*args, obsFreqGHz=149.6, asDevice=True,
                                  policy=CPU, **kw)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(
        dev.numpy(), got,
        err_msg=describe_difference(got, dev.numpy(), hostLog, devLog))


def test_make_model_image_outside_the_map_is_none(sky):
    far = Table({"RADeg": np.array([200.0]), "decDeg": np.array([40.0]),
                 "deltaT_c": np.array([100.0])})
    assert maps.makeModelImage(SHAPE, sky["wcs"], far,
                               sky["maps"][0]["beamFileName"],
                               policy=CPU) is None


# -- map operations ------------------------------------------------------------------

OPERATIONS = ["addWhiteNoise", "maskOutSources", "maskOutSources_whiteNoise",
              "applyPointSourceMask", "convertToY", "convertToDeltaT",
              "convolveMapWithBeam"]


@pytest.mark.parametrize("op", OPERATIONS)
def test_map_operation_matches_jax(sky, op):
    data, _ = nfits.read_image(sky["maps"][0]["mapFileName"])
    data = np.asarray(data, dtype=np.float64)
    w = sky["wcs"]
    out, holes = {}, {}
    for tag, mod, kw in (("jax", jmaps, {}), ("torch", maps, {"policy": CPU})):
        if op == "addWhiteNoise":
            out[tag] = mod.addWhiteNoise(data, 12.0, seed=5)
        elif op.startswith("maskOutSources"):
            mask = "whiteNoise" if op.endswith("whiteNoise") else -1.0
            res = mod.maskOutSources(data, w, sky["sources"],
                                     radiusArcmin=3.0, mask=mask)
            out[tag], holes[tag] = res["data"], res["mask"]
        elif op == "applyPointSourceMask":
            out[tag] = mod.applyPointSourceMask(sky["mask"], data, w,
                                                mask=-3.0)
        elif op == "convertToY":
            out[tag] = mod.convertToY(data, obsFrequencyGHz=97.8)
        elif op == "convertToDeltaT":
            out[tag] = mod.convertToDeltaT(data * 1e-6, obsFrequencyGHz=220.0)
        else:
            out[tag] = mod.convolveMapWithBeam(
                data, w, sky["maps"][1]["beamFileName"], **kw)
    assert not np.array_equal(out["torch"], data)
    close(out["torch"], out["jax"], 1e-10)
    if holes:
        np.testing.assert_array_equal(holes["torch"], holes["jax"])


# -- preprocess branches -----------------------------------------------------------

def branch_options(sky, branch):
    if branch == "injectSources":
        return {"injectSources": {
            "catalog": sky["clusters"], "GNFWParams": None,
            "override": {"redshift": 0.4, "M500": 2e14}, "profile": "A10"}}
    if branch == "applyBeamConvolution":
        return {"applyBeamConvolution": True}
    if branch == "smoothKernel":
        return {"smoothKernel": sky["maps"][1]["beamFileName"],
                "smoothAttenuationFactor": 0.8}
    if branch == "subtractModelFromCatalog":
        return {"subtractModelFromCatalog": [sky["sourcesPath"]]}
    if branch == "apodizeUsingSurveyMask":
        return {"apodizeUsingSurveyMask": True, "surveyMask": sky["mask"]}
    raise KeyError(branch)


BRANCHES = ["injectSources", "applyBeamConvolution", "smoothKernel",
            "subtractModelFromCatalog", "apodizeUsingSurveyMask"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_preprocess_branch_matches_jax(sky, branch):
    d = dict(sky["maps"][0], **branch_options(sky, branch))
    j = jmaps.MapDict(copy.deepcopy(d))
    j.preprocess("PRIMARY")
    t = maps.MapDict(copy.deepcopy(d), policy=CPU)
    t.preprocess("PRIMARY")
    plain = maps.MapDict(dict(sky["maps"][0]), policy=CPU)
    plain.preprocess("PRIMARY")
    # the branch changed the map, and the port changed it as JAX did
    assert not np.allclose(t["data"], plain["data"])
    close(t["data"], j["data"], 1e-10)
    for key in ("weights", "surveyMask", "pointSourceMask", "flagMask"):
        np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]))
    if branch == "subtractModelFromCatalog":
        assert np.asarray(t["flagMask"]).sum() > 0


def test_cmb_substitution_names_its_roadmap_item(sky):
    """The CMB substitution of sky-sim runs (ROADMAP item 10c, ported):
    the seeded source-free sky replaces the data, zero where the weights
    are; the same seed gives the same sky, another seed another.  Its
    parity with the JAX package is held in tests/test_torch_sims.py."""
    def preprocessed(seed):
        d = maps.MapDict(dict(sky["maps"][0], CMBSimSeed=seed), policy=CPU)
        d.preprocess("PRIMARY")
        return np.asarray(d["data"])
    a, b, c = preprocessed(3), preprocessed(3), preprocessed(4)
    raw = maps.MapDict(dict(sky["maps"][0]), policy=CPU)
    raw.preprocess("PRIMARY")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, raw["data"])
    assert np.all(np.isfinite(a)) and np.all(a[:, :6] == 0)
    assert a[:, 6:].std() > 20.0            # the 20 uK noise plus the CMB


# -- noise-model catalogs ---------------------------------------------------------

def test_noise_model_catalog_filter_matches_jax(sky):
    """The noise covariance from the maps less the model images of a
    catalog (the multi-pass config's pass 2): the built filter and the
    filtered and S/N maps at 1e-9."""
    f = {"label": "Beam", "class": "BeamMatchedFilter",
         "params": {"noiseParams": {"method": "dataMap",
                                    "noiseGridArcmin": 20.0},
                    "outputUnits": "uK", "edgeTrimArcmin": 5.0,
                    "noiseModelCatalog": [sky["sources"]]}}
    out = {}
    for tag, mod, mk, kw in (
            ("jax", jfilters, jmaps.MapDict, {}),
            ("torch", filters, maps.MapDict, {"policy": CPU})):
        mapDicts = [mk(dict(m), **kw) for m in sky["maps"]]
        out[tag] = mod.filterMaps(mapDicts, copy.deepcopy(f), "PRIMARY",
                                  diagnosticsDir=None, selFnDir=None,
                                  verbose=False, returnFilter=True, **kw)
    (jres, jobj), (tres, tobj) = out["jax"], out["torch"]
    close(tobj.filt.numpy(), np.asarray(jobj.filt), 1e-9)
    for key in ("data", "SNMap"):
        close(tres[key], jres[key], 1e-9)
    # the catalog did change the filter
    plainF = copy.deepcopy(f)
    plainF["params"].pop("noiseModelCatalog")
    _, plainObj = filters.filterMaps([maps.MapDict(dict(m), policy=CPU)
                                      for m in sky["maps"]], plainF,
                                     "PRIMARY", diagnosticsDir=None,
                                     selFnDir=None, verbose=False,
                                     returnFilter=True, policy=CPU)
    assert not np.allclose(plainObj.filt.numpy(), tobj.filt.numpy())


# -- the given-filter step ----------------------------------------------------------

TAILS = {"lean": {"lean_outputs": True},
         "full": {"undo_pixel_window": True},
         "detect": {"detect_params": (3.0, 24, 128, True, 8)}}


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("trimPix", [0, 10])
def test_given_step_matches_jax(tail, trimPix):
    """A pre-built filter (here the port's build step's) applied by both
    packages' given-filter steps: every output at 1e-10, masks and
    detections exact."""
    args, meta, grid = step_inputs()
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    build = distribute.make_matched_filter_step(grid, trimPix,
                                                lean_outputs=True,
                                                return_filter=True)
    filt = build(t["data"], t["data"], t["template"], t["calib"], t["w"],
                 t["apodM"], t["psMask"], t["surveyMask"], t["fg"],
                 t["peakYX"], meta)["filt"]
    kw = TAILS[tail]
    calls = dict(distribute.make_matched_filter_step.calls)
    tout = distribute.make_matched_filter_step(
        grid, trimPix, given_filter=True, **kw)(
        t["data"], filt, t["apodM"], t["psMask"], t["surveyMask"], meta)
    assert distribute.make_matched_filter_step.calls == dict(
        calls, given=calls["given"] + 1)
    jstep = jdist.make_sharded_matched_filter_step(
        get_mesh(n_devices=1), STEP_GRID, trimPix, given_filter=True, **kw)
    jout = jstep(*[jnp.asarray(a) for a in (args["data"], filt.numpy(),
                                            args["apodM"], args["psMask"],
                                            args["surveyMask"])],
                 {k: jnp.asarray(v) for k, v in meta.items()})
    assert set(tout) == set(jout)
    for key in tout:
        if key == "det":
            valid = np.asarray(jout["det"]["valid"])
            assert valid.sum() >= 4
            for k, v in tout["det"].items():
                ref = np.asarray(jout["det"][k])
                if v.dtype.is_floating_point:
                    close(v.numpy()[valid], ref[valid], 1e-10)
                else:
                    np.testing.assert_array_equal(v.numpy()[valid]
                                                  if v.dim() > 1
                                                  else v.numpy(),
                                                  ref[valid]
                                                  if ref.ndim > 1 else ref)
        elif key == "surveyMask":
            np.testing.assert_array_equal(tout[key].numpy(),
                                          np.asarray(jout[key]))
        else:
            close(tout[key], jout[key], 1e-10)
    np.testing.assert_array_equal(tout["signalNorm"].numpy(), 1.0)


# -- the multi-pass config ------------------------------------------------------------

MP_SHAPE = (400, 400)


@pytest.fixture(scope="module")
def multipass(tmp_path_factory):
    """tests/test_multipass.py's configuration on a seeded map of white
    noise, clusters and bright point sources, run through both packages:
    {package: config} after filterMapsAndMakeCatalogs."""
    work = str(tmp_path_factory.mktemp("multipass"))
    rng = np.random.default_rng(21)
    w = nwcs.makeWCS(MP_SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    beamPath = os.path.join(work, "beam_f150.txt")
    beams.makeGaussianBeamFile(beamPath, 1.4)

    def table(n, **cols):
        xs = rng.uniform(60, MP_SHAPE[1] - 60, n)
        ys = rng.uniform(60, MP_SHAPE[0] - 60, n)
        c = w.pix2wcs(xs, ys)
        return Table(dict({"RADeg": c[:, 0], "decDeg": c[:, 1]}, **cols))

    clusters = table(5, y_c=rng.uniform(3, 8, 5),
                     template=np.array(["Arnaud_M2e14_z0p4"] * 5))
    sources = table(6, deltaT_c=rng.uniform(2000, 8000, 6))
    sky = maps.makeModelImage(MP_SHAPE, w, clusters, beamPath,
                              obsFreqGHz=149.6, policy=CPU) \
        + maps.makeModelImage(MP_SHAPE, w, sources, beamPath, policy=CPU) \
        + rng.normal(0, 30.0, MP_SHAPE)
    simPath = os.path.join(work, "sim_f150.fits")
    nfits.write_image(simPath, sky, w.header)
    cfg = {
        "unfilteredMaps": [{"mapFileName": simPath, "weightsFileName": None,
                            "obsFreqGHz": 149.6, "units": "uK",
                            "beamFileName": beamPath}],
        "thresholdSigma": 4.0, "minObjPix": 1, "findCenterOfMass": True,
        "useInterpolator": True, "rejectBorder": 0, "longNames": False,
        "removeRings": False, "photFilter": "Arnaud_M2e14_z0p4",
        "filterSetOptions": {
            1: {"label": "sources", "saveCatalog": True,
                "thresholdSigma": 5.0, "objIdent": "ACT-S"},
            2: {"label": "clusters", "saveCatalog": True,
                "objIdent": "ACT-CL", "subtractModelFromSets": [1],
                "noiseModelCatalogFromSets": [1]}},
        "mapFilters": [
            {"label": "Beam_f150", "class": "BeamMatchedFilter",
             "filterSets": [1],
             "params": {"noiseParams": {"method": "dataMap",
                                        "noiseGridArcmin": 40.0},
                        "outputUnits": "uK", "edgeTrimArcmin": 10.0}},
            {"label": "Arnaud_M2e14_z0p4",
             "class": "ArnaudModelMatchedFilter", "filterSets": [2],
             "params": {"M500MSun": 2.0e14, "z": 0.4,
                        "noiseParams": {"method": "dataMap",
                                        "noiseGridArcmin": 40.0},
                        "outputUnits": "yc", "edgeTrimArcmin": 10.0,
                        "saveRMSMap": True}}]}
    out = {}
    for tag in ("jax", "torch"):
        d = copy.deepcopy(cfg)
        d["outputDir"] = os.path.join(work, tag)
        path = os.path.join(work, tag + ".yml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        if tag == "jax":
            config = jstartup.NemoConfig(path, writeTileInfo=True)
            jpipelines.filterMapsAndMakeCatalogs(config, verbose=False)
        else:
            config = startup.NemoConfig(path, device="cpu",
                                        writeTileInfo=True)
            pipelines.filterMapsAndMakeCatalogs(config, verbose=False)
        out[tag] = config
    return out, sources


@pytest.mark.parametrize("setNum", [1, 2])
def test_multipass_matches_jax(multipass, setNum):
    configs, sources = multipass
    ref = configs["jax"].filterSetOptions[setNum]["catalog"]
    got = configs["torch"].filterSetOptions[setNum]["catalog"]
    assert len(ref) >= 4 and len(got) == len(ref)
    assert list(got["name"]) == list(ref["name"])
    for key in ref.keys():
        col = np.asarray(ref[key])
        if col.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(got[key], dtype=float),
                                       col, rtol=1e-6, atol=1e-12)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), col)
    if setNum == 2:
        # the subtracted sources are gone from the cluster pass
        from nemo_tpu_torch import catalogs
        srcM, _, _ = catalogs.crossMatch(sources, got, radiusArcmin=1.0)
        assert len(srcM) <= 1
