"""The port's device-resident filter cache and background cache-file writer
(nemo_tpu_torch.parallel.filtercache), mirroring tests/test_parallel.py's
writer test and tests/test_device_batching.py's cache test: the writer's
per-file errors, ensure_written and flush; the byte budget; and, after a
batched engine run on the CPU in float64, fitQ and getFRelWeights reading
the cache, with the Q table and RW weights bitwise equal to a run whose
cache budget is 0, and the deferred FITS written by
``flush(materialize_deferred=True)``."""

import os
import shutil

import numpy as np
import pytest
import torch

from nemo_tpu_torch import completeness, pipelines, startup
from nemo_tpu_torch.models import qfit
from nemo_tpu_torch.parallel import filtercache
from nemo_tpu_torch.utils import fits as nfits
from tests.test_torch_engine import PHOT
from tests.test_torch_selfn import qtabs, selfn_config, write_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs: the suite's
    workers share the machine's cores, and torch's spinning worker
    threads slow every small op when the cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_background_writer_per_file_errors(tmp_path):
    """A failed background write is charged to its file only: readers of
    other files see no error, the failing file's reader gets a hard
    error, and flush drains the rest."""
    w = filtercache.BackgroundFITSWriter()
    good = str(tmp_path / "sub" / "good.fits")
    blocker = str(tmp_path / "blocker")
    open(blocker, "w").write("x")          # a FILE where a dir is needed
    bad = os.path.join(blocker, "sub", "bad.fits")
    w.enqueue(good, torch.ones((4, 4), dtype=torch.float32), nfits.Header())
    w.enqueue(bad, np.ones((4, 4)), nfits.Header())
    w.ensure_written(good)                 # must NOT raise
    assert os.path.exists(good)
    data, _ = nfits.read_image(good)
    assert np.asarray(data).dtype == np.float64
    with pytest.raises(RuntimeError, match="bad.fits"):
        w.ensure_written(bad)
    later = str(tmp_path / "later.fits")
    w.enqueue(later, np.zeros((2, 2)), nfits.Header())
    w.flush()                              # bad's error already consumed
    assert os.path.exists(later) and w.written == 2


def test_device_cache_budget_and_eviction():
    t = torch.zeros((2, 10, 6), dtype=torch.float64)      # 960 bytes
    cache = filtercache.DeviceFilterCache(maxBytes=2000)
    assert cache.put("a", t, 1.0, {150.0: 0.6})
    assert cache.put("b", t, 2.0, {150.0: 0.4})
    assert not cache.put("c", t, 3.0, {})                 # over budget
    assert cache.get("c") is None
    assert cache.put("a", t, 1.5, {}) and cache.get("a")["signalNorm"] == 1.5
    assert cache.pop("b")["signalNorm"] == 2.0
    assert cache.put("c", t, 3.0, {})                     # room again
    assert cache.hits == 1
    cache.clear()
    assert cache.get("a") is None
    assert not filtercache.DeviceFilterCache(maxBytes=0).put("x", t, 1, {})
    # the header's values: a float whose repr is too long for its card
    # keeps ~14 digits
    v = 1.2345678901234567e-05
    assert filtercache.header_value(v) == nfits._parse_value(
        nfits._format_card("X", v)[10:]) != v


@pytest.fixture(scope="module")
def cached_runs(tmp_path_factory):
    """The same batched run twice: with the device cache, and with a cache
    of budget 0 (every filter FITS written by the background writer); for
    each, getFRelWeights and fitQ (tile-batched) as the nemo CLI runs them,
    with the cache's hits counted."""
    work = str(tmp_path_factory.mktemp("torch_filtercache"))
    cfg = selfn_config(work)
    cfg.update(useDeviceBatching=True, useDeviceDetection=True,
               qfitTileBatch=True, qfitBatchSize=8, qfitTileBatchSize=3)
    cfg["mapFilters"][0]["params"]["saveFilteredMaps"] = False
    runs = {}
    saved = filtercache.DEVICE_CACHE
    try:
        for name, budget in (("cached", None), ("uncached", 0)):
            filtercache.DEVICE_CACHE = filtercache.DeviceFilterCache(
                maxBytes=budget)
            path = write_config(cfg, os.path.join(work, name + ".yml"),
                                os.path.join(work, name))
            config = startup.NemoConfig(path, device="cpu",
                                        writeTileInfo=True)
            deferred0 = filtercache.deferred_count()
            pipelines.filterMapsAndMakeCatalogs(config, verbose=False)
            names = [os.path.join(config.diagnosticsDir, t,
                                  "filter_%s#%s.fits" % (PHOT, t))
                     for t in config.tileNames]
            rec = {"config": config, "names": names,
                   "deferred": filtercache.deferred_count() - deferred0,
                   "existed": [os.path.exists(n) for n in names],
                   "entries": {n: filtercache.DEVICE_CACHE.get(n)
                               for n in names}}
            hits0 = filtercache.DEVICE_CACHE.hits
            rec["RW"] = completeness.getFRelWeights(config)
            rec["rwHits"] = filtercache.DEVICE_CACHE.hits - hits0
            qfit.fitQ(config)
            rec["Q"] = qtabs(os.path.join(config.selFnDir, "QFit.fits"))
            rec["left"] = [filtercache.DEVICE_CACHE.get(n) for n in names]
            filtercache.flush()
            rec["written"] = [os.path.exists(n) for n in names]
            runs[name] = rec
    finally:
        filtercache.DEVICE_CACHE = saved
    return runs


def test_fitq_and_weights_read_the_cache(cached_runs):
    c, u = cached_runs["cached"], cached_runs["uncached"]
    assert len(c["names"]) == 4
    # the cached run held every photometry filter, its FITS deferred
    assert all(e is not None for e in c["entries"].values())
    assert c["deferred"] == 4 and not any(c["existed"])
    assert c["rwHits"] == 4
    # the uncached run wrote every FITS before the engine returned
    assert all(e is None for e in u["entries"].values())
    assert u["deferred"] == 0 and all(u["existed"]) and u["rwHits"] == 0
    # fitQ read the cache (its budget record counts the loads) and
    # released every filter, whose FITS then landed
    with open(os.path.join(c["config"].diagnosticsDir,
                           "chunk_budgets.jsonl")) as f:
        cum = [r["cum"] for r in map(__import__("json").loads, f)
               if r.get("stage") == "fitQ"][-1]
    assert cum["cacheLoads"] == 4
    assert c["left"] == [None] * 4 and all(c["written"])


def test_q_table_and_weights_bitwise_without_the_cache(cached_runs):
    c, u = cached_runs["cached"], cached_runs["uncached"]
    assert c["RW"] == u["RW"] and len(c["RW"]) == 4
    assert sorted(c["Q"]) == sorted(u["Q"])
    for tile in c["Q"]:
        (tc, zc), (tu, zu) = c["Q"][tile], u["Q"][tile]
        assert zc == zu
        for col in tc.keys():
            np.testing.assert_array_equal(np.asarray(tc[col]),
                                          np.asarray(tu[col]))


def test_deferred_files_exist_after_flush(cached_runs, tmp_path):
    """A deferred filter is written by flush(materialize_deferred=True)
    with the cache's values and header: the float64 of the filter, the
    SIGNORM and RW weights a header reader gets."""
    c = cached_runs["cached"]
    name = str(tmp_path / "T" / "filter_x#T.fits")
    ent = next(iter(c["entries"].values()))
    header = nfits.Header()
    header["SIGNORM"] = 0.00012345678901234567
    cache = filtercache.DEVICE_CACHE
    assert cache.put(name, ent["filt"], header["SIGNORM"], {})
    filtercache.register_deferred(name, ent["filt"], header)
    try:
        assert filtercache.deferred_count() >= 1
        assert not os.path.exists(name)
        filtercache.flush(materialize_deferred=True)
        assert filtercache.deferred_count() == 0
        data, h = nfits.read_image(name)
        np.testing.assert_array_equal(np.asarray(data),
                                      ent["filt"].numpy().astype(np.float64))
        assert h["SIGNORM"] == cache.get(name)["signalNorm"]
    finally:
        cache.pop(name)
    # the cached run's own files hold its entries' values
    for n, e in c["entries"].items():
        data, h = nfits.read_image(n)
        np.testing.assert_array_equal(np.asarray(data),
                                      e["filt"].numpy().astype(np.float64))
        assert h["SIGNORM"] == e["signalNorm"]
    shutil.rmtree(str(tmp_path / "T"))
