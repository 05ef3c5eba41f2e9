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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs = {}
BUILD_SECONDS = {}


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


def load_library(source, declare):
    """Build (if needed) and load ``csrc/<source>``; ``declare(lib)`` sets
    the ctypes signatures.  Raises RuntimeError if the build fails."""
    with _lock:
        if source in _libs:
            return _libs[source]
        path = os.path.join(CSRC_DIR, source)
        with open(path, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        lib_path = os.path.join(BUILD_DIR, "%s_%s.so"
                                % (os.path.splitext(source)[0], key[:16]))
        if not os.path.exists(lib_path):
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (lib_path, os.getpid())
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc] + NVCC_FLAGS + ["-o", tmp, path],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for %s:\n%s%s"
                                   % (source, proc.stdout, proc.stderr))
            os.replace(tmp, lib_path)
            BUILD_SECONDS[source] = time.perf_counter() - t0
        lib = ctypes.CDLL(lib_path)
        declare(lib)
        _libs[source] = lib
        return lib
