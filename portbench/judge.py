"""The comparison that decides ``correct`` for the search cells.

After the window the reference (:mod:`.reference.mf`) works out, from
the same maps the program read, every filter of the bank on each judged
tile.  Each pass's outputs for those tiles are then judged:

* ``filter_rel_err``: the photometry filter the pass built (as the
  device cache holds it), the norm of program - reference over the
  reference's norm (over every band and Fourier pixel);
  ``signorm_rel_err``: its calibration;
* ``snr_err``: |SNR| of each catalog row against the reference's S/N
  map of the row's template, read at the row's position;
* ``fixed_snr_err``: the same of fixed_SNR (fixed_y_c over
  fixed_err_y_c, as the catalog carries it) against the photometry
  filter's S/N map: through fixed_err_y_c this holds the RMS map;
* ``fixed_y_err_sigma``: |fixed_y_c - reference| over the local noise
  of fixed_y_c (the reference's RMS in y units);
* ``opt_snr_err``: |SNR| against the best reference detection over the
  whole bank within 1.4' (the optimal catalog's choice of filter);
* ``pos_err_arcmin_median``: median distance from each row to the
  reference's detection of its template;
* ``missed``: reference rows at S/N >= 5 with no program row within
  1.4'; ``spurious``: program rows where the reference reads S/N < 3.5.

Each number is the worst over the judged tiles of every pass.
"""

import numpy as np

from .reference import mf

NAMES = ("filter_rel_err", "signorm_rel_err", "snr_err", "fixed_snr_err",
         "fixed_y_err_sigma", "opt_snr_err", "pos_err_arcmin_median",
         "missed", "spurious")
MISSED_SNR = 5.0
SPURIOUS_SNR = 3.5


def tile_pixel(survey, tile):
    """(y0, x0) of a tile in the survey."""
    for name, y0, x0 in survey.tiles:
        if name == tile:
            return y0, x0
    raise KeyError(tile)


def reference_tile(cfg, survey, tile, dev, control=None):
    """The reference's products of one tile (see :func:`mf.filter_tile`)."""
    ty, tx = survey.tileShape
    y0, x0 = tile_pixel(survey, tile)
    maps = np.stack([m[y0:y0 + ty, x0:x0 + tx].astype(np.float64)
                     for m in survey.maps])
    nemo = cfg["nemo"]
    fp = nemo["allFilters"]["params"]
    grid = int(round(fp["noiseParams"]["noiseGridArcmin"]
                     / cfg["survey"]["pixel_arcmin"]))
    trimArc = fp.get("edgeTrimArcmin", 0)
    trim = int(round(trimArc / cfg["survey"]["pixel_arcmin"])) \
        if trimArc else 3 * grid
    params = {"threshold": nemo["thresholdSigma"],
              "minObjPix": nemo["minObjPix"], "gridPix": grid,
              "trimPix": trim, "apodPix": 20,
              "bucket": (mf.good_fft_size(ty), mf.good_fft_size(tx))}
    bands = [(f, beam) for f, _, beam in survey.bands]
    ref = mf.filter_tile(maps, np.ones((ty, tx)),
                         survey.tile_scales(y0, x0), bank(cfg),
                         nemo["photFilter"], bands, params, dev,
                         control=control)

    def pix2sky(x, y):
        return survey.pix2sky(x + x0, y + y0)

    ref["rows"] = mf.optimal_rows(ref, bank(cfg), nemo["photFilter"],
                                  pix2sky)
    ref["origin"] = (y0, x0)
    return ref


def bank(cfg):
    return [(f["label"], f["params"]["M500MSun"], f["params"]["z"])
            for f in cfg["nemo"]["mapFilters"]]


def _rows_of(catalog, tile):
    if len(catalog) == 0:
        return []
    cols = catalog.keys() if hasattr(catalog, "keys") else catalog[0].keys()
    names = np.asarray(catalog["tileName"])
    sel = np.nonzero(names == tile)[0]
    return [{k: catalog[k][i] for k in cols} for i in sel]


def judge_tile(survey, ref, phot, filt, signorm, rows):
    """Numbers of one tile of one pass; ``filt``/``signorm`` the
    program's photometry filter, ``rows`` its catalog rows."""
    out = {}
    P = ref[phot]
    out["filter_rel_err"] = out["signorm_rel_err"] = np.inf
    if filt is not None:
        filt = np.asarray(filt, dtype=np.float64)
        out["filter_rel_err"] = float(
            np.linalg.norm(filt - P["filt"]) / np.linalg.norm(P["filt"])) \
            if filt.shape == P["filt"].shape else np.inf
        out["signorm_rel_err"] = abs(float(signorm) / P["signalNorm"] - 1)
    y0, x0 = ref["origin"]
    snrE, fsnrE, yE, optE, posE = [0.0], [0.0], [0.0], [0.0], []
    spurious = 0
    refRows = ref["rows"]
    rra = np.array([r["RADeg"] for r in refRows])
    rdec = np.array([r["decDeg"] for r in refRows])
    rsnr = np.array([r["SNR"] for r in refRows])
    pra = np.array([float(r["RADeg"]) for r in rows])
    pdec = np.array([float(r["decDeg"]) for r in rows])
    for r in rows:
        sx, sy = survey.sky2pix(float(r["RADeg"]), float(r["decDeg"]))
        x, y = float(sx) - x0, float(sy) - y0
        T = ref[r["template"]]
        snrRef = mf.spline_read(T["SN"], y, x)
        if snrRef < SPURIOUS_SNR:
            spurious += 1
        snrE.append(abs(float(r["SNR"]) - snrRef))
        fsnr = mf.spline_read(P["SN"], y, x)
        # the catalog carries fixed_SNR as fixed_y_c / fixed_err_y_c
        err = float(r["fixed_err_y_c"])
        fsnrP = float(r["fixed_y_c"]) / err if err != 0 else 0.0
        fsnrE.append(abs(fsnrP - fsnr))
        yRef = mf.spline_read(P["out"], y, x) * P["scale"] / 1e-4
        sig = P["RMS"][int(round(y)), int(round(x))] * P["scale"] / 1e-4
        if sig > 0:
            yE.append(abs(float(r["fixed_y_c"]) - yRef) / sig)
        if len(refRows):
            near = mf.ang_sep_deg(float(r["RADeg"]), float(r["decDeg"]),
                                  rra, rdec) <= mf.XMATCH_DEG
            if near.any():
                optE.append(abs(float(r["SNR"]) - rsnr[near].max()))
        dets = T["detections"]
        if dets:
            d = np.array([[q["y"], q["x"]] for q in dets])
            dist = np.hypot(d[:, 0] - y, d[:, 1] - x)
            k = int(np.argmin(dist))
            sepDeg = float(mf.ang_sep_deg(
                *survey.pix2sky(x + x0, y + y0),
                *survey.pix2sky(d[k, 1] + x0, d[k, 0] + y0)))
            if sepDeg <= mf.XMATCH_DEG:
                posE.append(60 * sepDeg)
    missed = 0
    for rr in refRows:
        if rr["SNR"] < MISSED_SNR:
            continue
        if not len(pra) or not (mf.ang_sep_deg(rr["RADeg"], rr["decDeg"],
                                               pra, pdec)
                                <= mf.XMATCH_DEG).any():
            missed += 1
    out.update({"snr_err": max(snrE), "fixed_snr_err": max(fsnrE),
                "fixed_y_err_sigma": max(yE), "opt_snr_err": max(optE),
                "pos_err_arcmin_median": float(np.median(posE))
                if posE else 0.0,
                "missed": missed, "spurious": spurious})
    return {k: (float(v) if np.isfinite(v) else np.inf)
            for k, v in out.items()}


def judge(cfg, survey, refs, passes):
    """The worst of each number over the judged tiles of every pass."""
    phot = cfg["nemo"]["photFilter"]
    worst = {}
    for p in passes:
        for tile, ref in refs.items():
            filt, signorm = p.filters.get(tile, (None, None))
            if filt is not None and hasattr(filt, "cpu"):
                filt = filt.double().cpu().numpy()
            nums = judge_tile(survey, ref, phot, filt, signorm,
                              _rows_of(p.catalog, tile))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number the configuration
    gives a limit is at or below it; one that is missing or not finite
    fails."""
    rows, ok = [], bool(limits)
    for name in NAMES:
        if name not in limits:
            continue
        v = numbers.get(name, np.inf)
        good = np.isfinite(v) and v <= limits[name]
        ok &= bool(good)
        rows.append((name, float(v), limits[name]))
    return ok, rows
