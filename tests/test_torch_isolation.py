"""The port stands alone: nemo_tpu_torch imports neither jax nor nemo_tpu
(the machine with the GPU has no JAX), and its copies of nemo_tpu's
host-only numpy modules stay identical to their sources apart from import
lines."""

import os
import re
import subprocess
import sys

import pytest

import nemo_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Copied modules: identical to nemo_tpu's apart from import lines (and, in
# utils/timing.py, the profiler: torch.profiler replaces jax.profiler).
COPIED = ["utils/fits.py", "utils/wcs.py", "utils/tables.py",
          "utils/timing.py", "utils/__init__.py", "native/__init__.py",
          "native/rice_py.py", "native/rice.cpp", "ops/interp.py",
          "ops/hankel.py", "models/beams.py", "models/gnfw.py",
          "models/sz.py", "models/cosmology.py", "catalogs.py",
          "photometry.py"]

_IMPORT = re.compile(r"^\s*(import \w|from \S+ import )")

_BLOCKER = r"""
import importlib, importlib.abc, os, sys
BLOCKED = ("jax", "jaxlib", "nemo_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
hits = []
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            hits.append(name)
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Blocker())
names = []
for dirpath, _, files in os.walk("nemo_tpu_torch"):
    for f in sorted(files):
        if f.endswith(".py"):
            mod = os.path.join(dirpath, f)[:-3].replace(os.sep, ".")
            names.append(mod[:-len(".__init__")]
                         if mod.endswith(".__init__") else mod)
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("IMPORTED", len(names))
print("NAMES", " ".join(sorted(names)))
print("HITS", sorted(set(hits)))
print("LEAKED", leaked)
"""


def test_port_imports_no_jax_and_no_nemo_tpu():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("IMPORTED", "HITS", "LEAKED",
                                              "NAMES"))
    assert int(lines["IMPORTED"]) >= 20
    # the batched engine and the device detection are covered
    for mod in ("nemo_tpu_torch.parallel.engine",
                "nemo_tpu_torch.parallel.distribute",
                "nemo_tpu_torch.ops.detect", "nemo_tpu_torch.completeness"):
        assert mod in lines["NAMES"].split(), mod
    assert lines["HITS"] == "[]"
    assert lines["LEAKED"] == "[]"


def test_no_import_statement_names_jax_or_nemo_tpu():
    """Lazy imports inside functions included, which an import run
    cannot reach."""
    pattern = re.compile(r"\s*(import|from)\s+(jax|jaxlib|nemo_tpu)\b")
    pkg = os.path.dirname(nemo_tpu_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        assert not pattern.match(line), (f, line)


def _normalised(path, rel):
    with open(path) as f:
        text = f.read()
    if rel == "utils/timing.py":
        # the module docstring and profile_trace name their profiler
        text = text[text.index('"""', 3) + 3:]
        text = text[:text.index("@contextlib.contextmanager\n"
                                "def profile_trace")]
    return [line for line in text.splitlines() if not _IMPORT.match(line)]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_source(rel):
    src = _normalised(os.path.join(ROOT, "nemo_tpu", rel), rel)
    dst = _normalised(os.path.join(ROOT, "nemo_tpu_torch", rel), rel)
    assert dst == src, "nemo_tpu_torch/%s drifted from nemo_tpu/%s" % (rel,
                                                                        rel)
