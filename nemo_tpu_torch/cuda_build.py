"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``nemo_tpu_torch/_build/`` (git-ignored), named by a hash of the source and
flags so an edited kernel is rebuilt, and loaded with ctypes.  Nothing is
built or loaded at import time: the first launch builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
# -fmad=false: no fused multiply-adds, so each sum, product and clip
# threshold rounds as the plain torch version's separate operations do.
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills (kept in BUILD_LOGS).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
BUILD_SECONDS = {}
BUILD_LOGS = {}


def find_nvcc():
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _split(source):
    """(file name, nvcc -D flags) of a build name: ``"x.cu"``, or
    ``"x.cu -DNAME"`` for the same source built with a macro defined."""
    name, *defines = source.split()
    return name, defines


def _lib_path(source):
    """(source path, library path) of ``csrc/<source>``; the library's name
    carries a hash of the source, the flags and the defines."""
    name, defines = _split(source)
    path = os.path.join(CSRC_DIR, name)
    with open(path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS + defines).encode()
                         ).hexdigest()
    return path, os.path.join(BUILD_DIR, "%s_%s.so"
                              % (os.path.splitext(name)[0], key[:16]))


def build(sources):
    """Compile every ``csrc/<source>`` whose library is missing, one nvcc
    process each, all started together.  A source may name -D flags after
    the file name.  Raises RuntimeError naming every source that failed to
    build."""
    with _lock:
        _build_locked(sources)


def _build_locked(sources):
    todo = [(s,) + _lib_path(s) for s in sources]
    todo = [t for t in todo if not os.path.exists(t[2])]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for source, path, lib_path in todo:
        tmp = "%s.%d.tmp" % (lib_path, os.getpid())
        procs.append((source, lib_path, tmp, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + _split(source)[1] + ["-o", tmp, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, lib_path, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[source] = log
        if proc.returncode != 0:
            failed.append("nvcc failed for %s:\n%s" % (source, log))
            continue
        os.replace(tmp, lib_path)
        BUILD_SECONDS[source] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source, declare):
    """Build (if needed) and load ``csrc/<source>`` (a file name, and any
    -D flags after it); ``declare(lib)`` sets the ctypes signatures.
    Raises RuntimeError if the build fails."""
    with _lock:
        if source in _libs:
            return _libs[source]
        _build_locked([source])
        lib = ctypes.CDLL(_lib_path(source)[1])
        declare(lib)
        _libs[source] = lib
        return lib
