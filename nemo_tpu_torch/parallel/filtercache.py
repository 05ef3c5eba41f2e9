"""Device-resident filter cache and background cache-file writer.

Port of ``nemo_tpu/parallel/filtercache.py``.  The reference caches each
built filter to ``diagnostics/<tile>/filter_<label>#<tile>.fits`` and
reloads it for fitQ, injection sims and forced photometry
(``filters.py:154,536,691-696``).  The batched engine used to download
every built filter and write its FITS synchronously as each chunk
finished, and fitQ read every reference filter back from the FITS.

This module keeps the reference (``photFilter``) filters resident on the
devices between the filtering and Q-fit phases (each on the device of the
shard that built it), and moves the cache-FITS writes off the chunk's
critical path into a daemon writer thread.  A filter held in the cache
defers its FITS write until something needs the file
(:func:`ensure_written`), fitQ retires it (:func:`release`) or the
process exits (the ``atexit`` flush).  Readers that miss the cache call
:func:`ensure_written` first, so the reference's file-based idempotency
holds.

Both routes give the same values: the FITS stores the float64 of the
compute-dtype filter, and the cache's SIGNORM and RW weights are the
values a reader of the FITS header gets (:func:`header_value`).
"""

import atexit
import os
import queue
import threading
import time

import numpy as np
import torch

_GiB = 1024 ** 3


def header_value(value):
    """``value`` as a reader of a FITS header card gets it back: the card
    keeps ~14 significant digits of a float whose repr is too long."""
    from ..utils import fits as nfits
    return nfits._parse_value(nfits._format_card("X", value)[10:])


class DeviceFilterCache:
    """Byte-budgeted map of filterFileName -> device filter + metadata.

    An entry holds one tile's Fourier filter as the engine's step built it
    ((nf, PY, PX//2+1), the compute dtype, on its shard's device) and the
    scalars ``loadFilter`` reads from the FITS header (signalNorm,
    fRelWeights).  ``hits`` counts the reads that found an entry.
    """

    def __init__(self, maxBytes=None):
        self._entries = {}
        self._bytes = 0
        self._maxBytes = maxBytes
        self._lock = threading.Lock()
        self.hits = 0

    def _budget(self, device):
        if self._maxBytes is None:
            # A quarter of the card's memory, capped at 4 GiB; 4 GiB on
            # the CPU (entries there are small).
            self._maxBytes = 4 * _GiB
            if device.type == "cuda":
                total = torch.cuda.mem_get_info(device)[1]
                self._maxBytes = min(total // 4, 4 * _GiB)
        return self._maxBytes

    def put(self, fileName, filtDev, signalNorm, fRelWeights):
        """Hold ``filtDev`` under ``fileName``; False (nothing held) when
        it would exceed the budget."""
        nbytes = filtDev.numel() * filtDev.element_size()
        with self._lock:
            if fileName in self._entries:
                self._bytes -= self._entries.pop(fileName)["nbytes"]
            if self._bytes + nbytes > self._budget(filtDev.device):
                return False
            self._entries[fileName] = {
                "filt": filtDev, "signalNorm": header_value(signalNorm),
                "fRelWeights": {header_value(k): header_value(v)
                                for k, v in fRelWeights.items()},
                "nbytes": nbytes}
            self._bytes += nbytes
            return True

    def get(self, fileName):
        with self._lock:
            ent = self._entries.get(fileName)
            self.hits += ent is not None
            return ent

    def pop(self, fileName):
        with self._lock:
            ent = self._entries.pop(fileName, None)
            if ent is not None:
                self._bytes -= ent["nbytes"]
            return ent

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


class BackgroundFITSWriter:
    """Daemon thread draining (fileName, array, header) FITS writes.

    The download of a device tensor (``.cpu()``) and the disk write run on
    the thread, overlapping the main thread's staging and compute.
    ``ensure_written`` lets a reader block until a specific file has
    landed; ``flush`` drains everything.  Write errors are re-raised on
    the next flush or ensure call for that file rather than lost in the
    thread.  ``written`` counts the files written.
    """

    def __init__(self, maxQueued=16):
        # Bounded: each queued item pins a device buffer until its
        # download and write complete; enqueue blocks when the writer
        # falls behind (the old synchronous behaviour, rate-limited).
        self._q = queue.Queue(maxsize=maxQueued)
        self._pending = set()
        self._done = threading.Condition()
        self._errors = {}           # fileName -> exception
        self._thread = None
        self.written = 0

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        from ..utils import fits as nfits
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fileName, data, header = item
            try:
                if isinstance(data, torch.Tensor):
                    data = data.cpu().numpy()
                data = np.asarray(data, dtype=np.float64)
                os.makedirs(os.path.dirname(fileName), exist_ok=True)
                nfits.write_image(fileName, data, header)
                self.written += 1
            except Exception as exc:      # surfaced per file
                self._errors[fileName] = exc
            finally:
                with self._done:
                    self._pending.discard(fileName)
                    self._done.notify_all()
                self._q.task_done()

    def enqueue(self, fileName, data, header):
        with self._done:
            self._pending.add(fileName)
        self._ensure_thread()
        self._q.put((fileName, data, header))

    def ensure_written(self, fileName):
        """Block until fileName's pending write (if any) completes.
        Raises only for THIS file's write failure: a reader must never
        fall back to a silent rebuild because some other file's write
        failed (nor see another file's error charged to this one)."""
        with self._done:
            while fileName in self._pending:
                self._done.wait(timeout=60)
        exc = self._errors.pop(fileName, None)
        if exc is not None:
            raise RuntimeError("background filter-cache write of %s "
                               "failed" % fileName) from exc

    def flush(self, timeout=None):
        """Drain all pending writes.  ``timeout`` (seconds) bounds the
        wait - the atexit hook uses it so a hung device cannot stop the
        interpreter from exiting; unpersisted files are reported
        instead."""
        if self._thread is None:
            return
        if timeout is not None:
            end = time.time() + timeout
            with self._done:
                while self._pending and time.time() < end:
                    self._done.wait(timeout=5)
                if self._pending:
                    print("... WARNING: %d filter-cache write(s) still "
                          "pending at exit: %s"
                          % (len(self._pending), sorted(self._pending)[:3]))
                    return
        else:
            self._q.join()
        if self._errors:
            fileName, exc = next(iter(self._errors.items()))
            self._errors.pop(fileName)
            raise RuntimeError(
                "background filter-cache write of %s failed (%d write "
                "error(s) total)" % (fileName, 1 + len(self._errors))) \
                from exc


DEVICE_CACHE = DeviceFilterCache()
WRITER = BackgroundFITSWriter()

# Filters whose cache-FITS write is DEFERRED: the device tensor and header
# are held here, and the download happens only if something needs the
# file (ensure_written), fitQ retires the filter (release) or the process
# exits (the flush).  Deferral is registered only for filters held in the
# byte-budgeted DEVICE_CACHE, so the device memory it pins stays inside
# the cache budget.
_DEFERRED = {}
_DEF_LOCK = threading.Lock()


def register_deferred(fileName, filtDev, header):
    with _DEF_LOCK:
        _DEFERRED[fileName] = (filtDev, header)


def _materialize(fileName):
    """Move a deferred entry into the background writer (download and
    FITS write happen on the writer thread)."""
    with _DEF_LOCK:
        item = _DEFERRED.pop(fileName, None)
    if item is None:
        return False
    WRITER.enqueue(fileName, item[0], item[1])
    return True


def deferred_count():
    with _DEF_LOCK:
        return len(_DEFERRED)


def ensure_written(fileName):
    _materialize(fileName)
    WRITER.ensure_written(fileName)


def release(fileName):
    """Retire a device-resident filter once its last in-process consumer
    is done with it (fitQ releases each tile's reference filter after
    measuring Q): its deferred FITS write is queued on the background
    writer and the device copy is dropped, so the cache's memory falls
    tile by tile.  Later readers (injection reruns) read the FITS."""
    _materialize(fileName)
    DEVICE_CACHE.pop(fileName)


def flush(timeout=None, materialize_deferred=False):
    """Drain in-flight writes.  ``materialize_deferred`` also turns every
    deferred filter into a file (the exit hook uses it so that a later
    process can read the caches without a rebuild)."""
    if materialize_deferred:
        with _DEF_LOCK:
            names = list(_DEFERRED)
        for name in names:
            _materialize(name)
    WRITER.flush(timeout=timeout)


atexit.register(lambda: flush(timeout=120, materialize_deferred=True))
