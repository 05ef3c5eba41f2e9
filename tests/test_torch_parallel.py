"""The port's device mesh, sharded steps, sharded engine and multi-process
runtime (nemo_tpu_torch.parallel.mesh / distribute / engine / multihost)
on the CPU in float64, against the JAX package on its 8-device virtual CPU
mesh (tests/conftest.py), on numpy inputs from a seed.  They mirror
tests/test_parallel.py and tests/test_device_batching.py: the sharded
benchmark step at rtol 1e-10 with the survey histogram and counts exact,
the sharded production and given-filter steps at rtol 1e-10 (and 1e-12
against each other), the batched engine at rtol 1e-8, and a two-process
gloo run of the survey collectives."""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from nemo_tpu import startup as jstartup
from nemo_tpu.ops import fourier as jfourier
from nemo_tpu.parallel import distribute as jdist
from nemo_tpu.parallel import engine as jengine
from nemo_tpu.parallel import mesh as jmesh
from nemo_tpu_torch import pipelines
from nemo_tpu_torch.ops import noise as tnoise
from nemo_tpu_torch.parallel import distribute as tdist
from nemo_tpu_torch.parallel import engine as tengine
from nemo_tpu_torch.parallel import mesh as tmesh
from nemo_tpu_torch.parallel import multihost
from tests.test_parallel import _make_batch
from tests.test_torch_cuda import STEP_GRID, step_inputs
from tests.test_torch_engine import (compare, make_survey, torch_config)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs: the suite's
    workers share the machine's cores, and torch's spinning worker
    threads slow every small op when the cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol=1e-10):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


def cat(parts):
    return torch.cat(list(parts)).numpy()


def cpu_mesh(n):
    return tmesh.get_mesh(n, device="cpu")


def tile_batch(nTiles=8, seed=3):
    nf, ny, nx = 2, 96, 96
    data, noise, tmpl = _make_batch(nTiles, nf, ny, nx, seed=seed)
    apod = np.array(jfourier.apod_mask((ny, nx), 10))
    ps = np.ones((nTiles, ny, nx))
    ps[1, 10:20, 30:40] = 0
    return (data, noise, tmpl, np.array([1.0, 0.8]), apod, ps,
            np.ones((nTiles, ny, nx)))


# -- the mesh ----------------------------------------------------------------

def test_mesh_rules():
    assert tmesh.get_mesh(device="cpu").size == 1
    m = cpu_mesh(8)
    assert m.devices == (torch.device("cpu"),) * 8
    # explicit devices may repeat (virtual shards)
    assert tmesh.get_mesh(devices=["cpu", "cpu"]).size == 2
    # contiguous shards in mesh order; uneven counts, no padding; fewer
    # tiles than positions leave the last ones empty
    sh = tmesh.tile_sharding(tmesh.get_mesh(3, device="cpu"))
    assert [s for _, s in sh.slices(7)] == [slice(0, 3), slice(3, 5),
                                            slice(5, 7)]
    assert [s for _, s in sh.slices(2)] == [slice(0, 1), slice(1, 2)]
    parts = sh.put(np.arange(7.0))
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4], [5, 6]]
    rep = tmesh.replicated(m).put(np.ones(3))
    assert list(rep) == [torch.device("cpu")]


def test_mesh_asks_for_no_more_cards_than_exist():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="devices requested but only"):
        tmesh.get_mesh(n_devices=n + 1)


# -- the sharded benchmark step -----------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_tile_step_matches_jax(n):
    args = tile_batch()
    jout = jdist.run_tile_batch(*args, gridSize=32, trimPix=10,
                                mesh=jmesh.get_mesh(n_devices=n), topK=16,
                                threshold=4.0)
    tout = tdist.run_tile_batch(*args, gridSize=32, trimPix=10,
                                mesh=cpu_mesh(n), topK=16, threshold=4.0)
    assert len(tout["SNMap"]) == n
    for k in ("filtered", "SNMap", "RMSMap", "peakVals"):
        close(cat(tout[k]), jout[k])
    above = np.asarray(jout["peakVals"]) > 4.0
    assert above.sum() >= 8
    for k in ("peakYs", "peakXs"):
        np.testing.assert_array_equal(cat(tout[k])[above],
                                      np.asarray(jout[k])[above])
    assert int(tout["surveyCandidateCount"]) == \
        int(jout["surveyCandidateCount"])
    np.testing.assert_array_equal(tout["surveyRMSHist"].numpy(),
                                  np.asarray(jout["surveyRMSHist"]))


def test_sharded_tile_step_uneven_shards_match_one_shard():
    """Seven tiles on three shards (3, 2, 2), which the JAX package cannot
    place without padding, equal one shard's run: maps to 1e-12, the
    histogram and count exactly."""
    args = tile_batch(nTiles=7, seed=5)
    one = tdist.run_tile_batch(*args, gridSize=32, trimPix=0,
                               mesh=cpu_mesh(1), topK=8)
    three = tdist.run_tile_batch(*args, gridSize=32, trimPix=0,
                                 mesh=cpu_mesh(3), topK=8)
    assert [p.shape[0] for p in three["SNMap"]] == [3, 2, 2]
    close(cat(three["SNMap"]), cat(one["SNMap"]), 1e-12)
    assert int(three["surveyCandidateCount"]) == \
        int(one["surveyCandidateCount"])
    np.testing.assert_array_equal(three["surveyRMSHist"].numpy(),
                                  one["surveyRMSHist"].numpy())


def test_sharded_step_rejects_shards_off_the_mesh():
    args = tile_batch(nTiles=2)
    step = tdist.make_sharded_tile_step(cpu_mesh(1), 32, 0, topK=8)
    sh = tmesh.tile_sharding(cpu_mesh(2))
    with pytest.raises(ValueError, match="shards on a mesh"):
        step(sh.put(args[0]), sh.put(args[1]), sh.put(args[2]),
             torch.as_tensor(args[3]), torch.as_tensor(args[4]),
             sh.put(args[5]), sh.put(args[6]))


# -- the sharded production and given-filter steps ----------------------------

@pytest.fixture(scope="module")
def step_case():
    args, meta, grid = step_inputs()
    return args, meta, grid


def _jax_step(args, meta, grid, trimPix, **kw):
    jm = jmesh.get_mesh(n_devices=2)
    sh = jmesh.tile_sharding(jm)
    import jax
    put = {k: (jnp.asarray(v) if k == "w" else jax.device_put(
        jnp.asarray(v), sh)) for k, v in args.items()}
    metaDev = {k: jax.device_put(jnp.asarray(v), sh)
               for k, v in meta.items()}
    build = jdist.make_sharded_matched_filter_step(
        jm, grid, trimPix, return_filter=True, **kw)
    out = build(put["data"], put["data"], put["template"], put["calib"],
                put["w"], put["apodM"], put["psMask"], put["surveyMask"],
                put["fg"], put["peakYX"], metaDev)
    return out


def _torch_step(args, meta, grid, trimPix, n=2, **kw):
    sh = tmesh.tile_sharding(cpu_mesh(n))
    put = {k: (torch.as_tensor(v) if k == "w" else sh.put(v))
           for k, v in args.items()}
    build = tdist.make_sharded_matched_filter_step(
        cpu_mesh(n), grid, trimPix, return_filter=True, **kw)
    return build(put["data"], put["data"], put["template"], put["calib"],
                 put["w"], put["apodM"], put["psMask"], put["surveyMask"],
                 put["fg"], put["peakYX"], meta), put


@pytest.mark.parametrize("tail", ["full", "lean", "detect"])
def test_sharded_matched_filter_step_matches_jax(step_case, tail):
    args, meta, grid = step_case
    kw = {"full": {}, "lean": {"lean_outputs": True},
          "detect": {"detect_params": (3.0, 24, 128, True, 8)}}[tail]
    jout = _jax_step(args, meta, grid, 10, **kw)
    tout, _ = _torch_step(args, meta, grid, 10, **kw)
    assert [p.shape[0] for p in tout["filtered"]] == [2, 2]
    assert len(tout["stepTimer"]) == 2
    for k in ("filtered", "signalNorm", "calibCrop", "filt") + {
            "full": ("SNMap", "RMSMap"), "lean": ("RMSCells",),
            "detect": ("SNMap", "RMSCells", "subSpline",
                       "subNearest")}[tail]:
        if tail == "detect" and k.startswith("sub"):
            continue
        close(cat(tout[k]), jout[k])
    np.testing.assert_array_equal(cat(tout["surveyMask"]),
                                  np.asarray(jout["surveyMask"]))
    if tail == "detect":
        valid = np.asarray(jout["det"]["valid"])
        np.testing.assert_array_equal(cat(tout["det"]["valid"]), valid)
        np.testing.assert_array_equal(cat(tout["det"]["nObjects"]),
                                      np.asarray(jout["det"]["nObjects"]))
        for k in ("numPix", "peakY", "peakX"):
            np.testing.assert_array_equal(cat(tout["det"][k])[valid],
                                          np.asarray(jout["det"][k])[valid])
        for k in ("comY", "comX", "peak"):
            close(cat(tout["det"][k])[valid],
                  np.asarray(jout["det"][k])[valid], 1e-12)
        for k in ("subSpline", "subNearest"):
            close(cat(tout[k])[valid], np.asarray(jout[k])[valid])


def test_given_filter_step_matches_build_step(step_case):
    """The sharded given-filter step applied with the sharded build step's
    own filters reproduces its maps (1e-12), and both equal JAX's on its
    2-device mesh (1e-10)."""
    args, meta, grid = step_case
    outB, put = _torch_step(args, meta, grid, 10, lean_outputs=True)
    given = tdist.make_sharded_matched_filter_step(
        cpu_mesh(2), grid, 10, lean_outputs=True, given_filter=True)
    outG = given(put["data"], outB["filt"], put["apodM"], put["psMask"],
                 put["surveyMask"], meta)
    close(cat(outG["filtered"]), cat(outB["filtered"]), 1e-12)
    close(cat(outG["RMSCells"]), cat(outB["RMSCells"]), 1e-12)
    np.testing.assert_array_equal(cat(outG["surveyMask"]),
                                  cat(outB["surveyMask"]))
    jout = _jax_step(args, meta, grid, 10, lean_outputs=True)
    close(cat(outG["filtered"]), jout["filtered"])
    close(cat(outG["RMSCells"]), jout["RMSCells"])


def test_sharded_realspace_step_matches_one_shard():
    """The real-space step on three uneven shards equals one shard's run
    (1e-12): the kernels, norms and noise cells follow their tiles."""
    rng = np.random.default_rng(11)
    T, nf, ny, nx, k = 5, 2, 70, 90, 7
    data = rng.normal(size=(T, nf, ny, nx))
    kern = rng.normal(size=(T, nf, k, k))
    norms = rng.uniform(0.5, 2.0, T)
    apod = np.ones((T, ny, nx))
    ps = np.ones((T, ny, nx))
    ps[2, 10:15, 10:15] = 0
    survey = np.ones((T, ny, nx))
    meta = tnoise.cell_meta_batch([(ny, nx)] * T, (ny, nx), 16)
    outs = []
    for n in (1, 3):
        sh = tmesh.tile_sharding(cpu_mesh(n))
        step = tdist.make_sharded_realspace_step(cpu_mesh(n), 16, 5)
        outs.append(step(*[sh.put(a) for a in (data, kern, norms, apod, ps,
                                               survey)], meta))
    for key in ("filtered", "SNMap", "RMSMap"):
        close(cat(outs[1][key]), cat(outs[0][key]), 1e-12)


# -- the engine on a mesh -----------------------------------------------------

@pytest.fixture(scope="module")
def engine_survey(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("torch_parallel"))
    cfg = make_survey(work)
    jcfg = copy.deepcopy(cfg)
    jcfg.update(useDeviceBatching=True, outputDir=os.path.join(work, "jax"))
    path = os.path.join(work, "jax.yml")
    with open(path, "w") as f:
        yaml.safe_dump(jcfg, f)
    jconfig = jstartup.NemoConfig(path, writeTileInfo=True)
    return work, cfg, jconfig


def test_batch_filter_tiles_on_two_shards(engine_survey):
    """batchFilterTiles on a 2-shard mesh equals JAX's on
    get_mesh(n_devices=2) and the port's one-shard run (1e-8, as
    test_chunked_device_batches); an odd chunk size rounds down to a
    multiple of the mesh."""
    work, cfg, jconfig = engine_survey
    config = torch_config(cfg, os.path.join(work, "shards"))
    f = config.parDict["mapFilters"][1]
    jf = next(x for x in jconfig.parDict["mapFilters"]
              if x["label"] == f["label"])
    ref = jengine.batchFilterTiles(jconfig, jf,
                                   mesh=jmesh.get_mesh(n_devices=2),
                                   verbose=False)
    one = tengine.batchFilterTiles(config, f, mesh=cpu_mesh(1),
                                   verbose=False)
    two = tengine.batchFilterTiles(config, f, mesh=cpu_mesh(2),
                                   verbose=False, deviceBatchSize=3)
    assert set(ref) == set(one) == set(two) == set(config.tileNames)
    for t in ref:
        for k in ("data", "SNMap"):
            np.testing.assert_allclose(two[t][k], one[t][k], rtol=1e-8,
                                       atol=1e-10 if k == "SNMap"
                                       else 1e-12)
            np.testing.assert_allclose(two[t][k], ref[t][k], rtol=1e-8,
                                       atol=1e-10 if k == "SNMap"
                                       else 1e-12)
        np.testing.assert_array_equal(two[t]["surveyMask"],
                                      one[t]["surveyMask"])


@pytest.mark.parametrize("n", [2, 8])
def test_device_detection_pipeline_on_a_mesh(engine_survey, n):
    """The whole pipeline with device detection on a mesh of n shards (8:
    more positions than a chunk's 4 tiles) gives the one-shard catalog
    (1e-10), and each chunk's budget names its shards."""
    import json
    work, cfg, _ = engine_survey
    cats = {}
    for shards in (1, n):
        d = dict(useDeviceBatching=True, useDeviceDetection=True,
                 deviceBatchSize=8)
        config = torch_config(cfg, os.path.join(work, "det%d_%d" % (n,
                                                                   shards)),
                              **d)
        config.mesh = cpu_mesh(shards)
        cats[shards] = pipelines.filterMapsAndMakeCatalogs(
            config, writeAreaMask=True, writeFlagMask=True, verbose=False)
        with open(os.path.join(config.diagnosticsDir,
                               "chunk_budgets.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["shards"] for r in recs] == \
            [[4] if shards == 1 else [2, 2] if n == 2 else [1, 1, 1, 1]]
        assert all(len(r["shardStep"]) == len(r["shards"]) for r in recs)
        assert sum(r["detectTiles"] for r in recs) == 8
    assert len(cats[n]) == len(cats[1])
    compare(cats[1], cats[n], rtol=1e-10, sepArcsec=1e-6)


# -- the multi-process runtime ------------------------------------------------

def test_multihost_skeleton_single_process(monkeypatch):
    """Inert by default (no process group on single-host runs), the
    coordinator gate true, and the local tile slice everything when one
    process owns the whole mesh."""
    monkeypatch.delenv("NEMO_TPU_MULTIHOST", raising=False)
    assert multihost.multihost_requested() is False
    assert multihost.initialize_from_env("cpu") is False
    assert multihost.process_index() == 0
    assert multihost.is_coordinator() is True
    names = ["t%d" % i for i in range(20)]
    assert multihost.local_tile_slice(names, cpu_mesh(8)) == names
    monkeypatch.setenv("NEMO_TPU_MULTIHOST", "1")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.multihost_requested() is True
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize_from_env("cpu")


def _two_process_worker(rank, initFile, outDir):
    """One of two gloo processes: its local tile slice, and the sharded
    benchmark step on its tiles (one shard) with the survey collectives
    reduced over both processes."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + initFile,
                            world_size=2, rank=rank)
    try:
        mesh = cpu_mesh(1)
        names = ["t%d" % i for i in range(7)]
        mine = multihost.local_tile_slice(names, mesh)
        args = tile_batch()
        idx = [int(n[1:]) for n in multihost.local_tile_slice(
            ["t%d" % i for i in range(len(args[0]))], mesh)]
        sh = tmesh.tile_sharding(mesh)
        step = tdist.make_sharded_tile_step(mesh, 32, 10, topK=16)
        out = step(*[sh.put(a[idx]) if i not in (3, 4)
                     else torch.as_tensor(a) for i, a in enumerate(args)])
        np.savez(os.path.join(outDir, "rank%d.npz" % rank),
                 names=np.array(mine), hist=out["surveyRMSHist"].numpy(),
                 count=int(out["surveyCandidateCount"]),
                 coordinator=multihost.is_coordinator())
    finally:
        dist.destroy_process_group()


def test_two_processes_reduce_the_survey_statistics(tmp_path):
    """Two gloo processes of one shard each: the two local tile slices
    partition the names by the JAX rule (tile i to the owner of global
    mesh position i mod 2), and the survey histogram and candidate count
    equal one process's over two shards."""
    ctx = torch.multiprocessing.get_context("spawn")
    initFile = str(tmp_path / "init")
    procs = [ctx.Process(target=_two_process_worker,
                         args=(r, initFile, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, "processes %s did not finish in 60 s" % alive
    assert [p.exitcode for p in procs] == [0, 0]
    res = [np.load(str(tmp_path / ("rank%d.npz" % r))) for r in range(2)]
    assert list(res[0]["names"]) == ["t0", "t2", "t4", "t6"]
    assert list(res[1]["names"]) == ["t1", "t3", "t5"]
    assert bool(res[0]["coordinator"]) and not bool(res[1]["coordinator"])
    ref = tdist.run_tile_batch(*tile_batch(), gridSize=32, trimPix=10,
                               mesh=cpu_mesh(2), topK=16)
    for r in res:
        np.testing.assert_array_equal(r["hist"],
                                      ref["surveyRMSHist"].numpy())
        assert int(r["count"]) == int(ref["surveyCandidateCount"])
