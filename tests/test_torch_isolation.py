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

# Copied modules: identical to nemo_tpu's apart from import lines, the
# port's recorder counts (``timing.count(...)`` lines) and, in the
# DEVICE_THREADED modules, the explicit device passed down to the
# Boltzmann solve.
COPIED = ["utils/fits.py", "utils/wcs.py", "utils/tables.py",
          "utils/__init__.py", "native/__init__.py",
          "native/rice_py.py", "native/rice.cpp", "ops/interp.py",
          "ops/hankel.py", "models/beams.py", "models/gnfw.py",
          "models/sz.py", "models/cosmology.py", "catalogs.py",
          "photometry.py", "mock.py", "plotSettings.py"]
DEVICE_THREADED = ("models/cosmology.py", "mock.py")
# Top-level definitions of a copied module that the port owns: a copied
# definition the port changes, and the helpers it adds.  They are taken
# out of both files before the comparison; every other line is held to
# the source.  The port changes a copied definition in place and names it
# here, rather than overlaying the module with another.
OWNED = {"utils/fits.py": ("_compressed_image_hdu_bytes", "_rows_library",
                           "_quantise", "_encode_rows")}
# a device argument, parameter or attribute, and the line that stores it
_DEVICE_ARG = re.compile(r",\s*(self\.)?device\b(=[\w.\"']+)?")
_DEVICE_LINE = re.compile(r"^\s*self\.device = .*\n", re.M)

_IMPORT = re.compile(r"^\s*(import \w|from \S+ import )")
_COUNT = re.compile(r"^\s*timing\.count\(.*\)$")

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
                "nemo_tpu_torch.ops.detect", "nemo_tpu_torch.ops.paint",
                "nemo_tpu_torch.maps", "nemo_tpu_torch.filters",
                "nemo_tpu_torch.models.profiles",
                "nemo_tpu_torch.cli.nemo_main", "nemo_tpu_torch.completeness",
                "nemo_tpu_torch.models.boltzmann",
                "nemo_tpu_torch.models.qfit",
                "nemo_tpu_torch.models.scaling", "nemo_tpu_torch.mock",
                "nemo_tpu_torch.plotSettings",
                "nemo_tpu_torch.cli.nemoMass_main",
                "nemo_tpu_torch.ops.grf", "nemo_tpu_torch.ops.sht",
                "nemo_tpu_torch.cli.nemoModel_main",
                "nemo_tpu_torch.cli.nemoMock_main",
                "nemo_tpu_torch.cli.nemoSpec_main",
                "nemo_tpu_torch.cli.nemoCatalogCheck_main",
                "nemo_tpu_torch.parallel.mesh",
                "nemo_tpu_torch.parallel.multihost",
                "nemo_tpu_torch.parallel.filtercache",
                "nemo_tpu_torch.ops._exact"):
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


def _top_level(text):
    """{name: (first line, end line)} of each top-level function, class
    and assignment of a module's source, 0-based and end-exclusive, with
    its decorators."""
    import ast
    spans = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            continue
        first = min([node.lineno]
                    + [d.lineno for d in getattr(node, "decorator_list", [])])
        for name in names:
            spans[name] = (first - 1, node.end_lineno)
    return spans


def _without_owned(text, rel):
    """``text`` less the definitions ``OWNED`` names for ``rel``, each with
    the blank lines that follow it."""
    lines = text.splitlines()
    spans = _top_level(text)
    drop = set()
    for name in OWNED.get(rel, ()):
        if name in spans:
            first, end = spans[name]
            while end < len(lines) and not lines[end].strip():
                end += 1
            drop.update(range(first, end))
    return "\n".join(line for i, line in enumerate(lines) if i not in drop)


def _normalised(path, rel):
    with open(path) as f:
        text = f.read()
    if rel in OWNED:
        text = _without_owned(text, rel)
    if rel in DEVICE_THREADED:
        text = _DEVICE_ARG.sub("", _DEVICE_LINE.sub("", text))
    return [line for line in text.splitlines()
            if not _IMPORT.match(line) and not _COUNT.match(line)]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_source(rel):
    src = _normalised(os.path.join(ROOT, "nemo_tpu", rel), rel)
    dst = _normalised(os.path.join(ROOT, "nemo_tpu_torch", rel), rel)
    assert dst == src, "nemo_tpu_torch/%s drifted from nemo_tpu/%s" % (rel,
                                                                        rel)


@pytest.mark.parametrize("rel", sorted(OWNED))
def test_port_adds_only_owned_definitions(rel):
    """The port's copy defines at top level nothing its source lacks but
    the definitions ``OWNED`` names, and it defines each of those: an
    unnamed addition fails here, as an edit elsewhere in the file fails
    the comparison."""
    tops = {}
    for pkg in ("nemo_tpu", "nemo_tpu_torch"):
        with open(os.path.join(ROOT, pkg, rel)) as f:
            tops[pkg] = set(_top_level(f.read()))
    owned = set(OWNED[rel])
    assert tops["nemo_tpu_torch"] - tops["nemo_tpu"] <= owned, rel
    assert owned <= tops["nemo_tpu_torch"], rel


def test_device_threading_is_all_that_differs():
    """The device normalisation removes only what the port added: the JAX
    modules name no device, and the port's copies pass one down."""
    for rel in DEVICE_THREADED:
        with open(os.path.join(ROOT, "nemo_tpu", rel)) as f:
            assert "device" not in f.read(), rel
        with open(os.path.join(ROOT, "nemo_tpu_torch", rel)) as f:
            assert "device=" in f.read(), rel


# Data files the port carries as its own copies of nemo_tpu's.
COPIED_DATA = ["data/lensed_cl_tt.txt"]


@pytest.mark.parametrize("rel", COPIED_DATA)
def test_copied_data_matches_source(rel):
    """The port reads its own copy, so a copy that drifts (or goes
    missing) would change results silently."""
    with open(os.path.join(ROOT, "nemo_tpu", rel), "rb") as f:
        src = f.read()
    with open(os.path.join(ROOT, "nemo_tpu_torch", rel), "rb") as f:
        assert f.read() == src, "nemo_tpu_torch/%s drifted" % rel


def test_no_path_into_nemo_tpu():
    """Neither the port nor chip_smoke.py builds a path into the JAX
    package's tree (a bare "nemo_tpu" path component, or a "nemo_tpu/..."
    string other than a source reference "file.py:line"), which the
    machine with the card may not have."""
    pattern = re.compile(r"""(["'])nemo_tpu\1|["']nemo_tpu/(?![\w/]+\.py:)""")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    pkg = os.path.dirname(nemo_tpu_torch.__file__)
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                assert not pattern.search(line), (path, n, line)


# Host functions the port copies out of modules it otherwise ports: the
# same source text as nemo_tpu's.
COPIED_FUNCTIONS = [("maps.py", name) for name in (
    "addWhiteNoise", "maskOutSources", "applyPointSourceMask",
    "sourceInjectionTest", "positionRecoveryAnalysis", "noiseBiasAnalysis",
    "pixScaleXRadPerRow", "maxAbsDecDeg", "resolveSimMethod",
    "estimateContaminationFromInvertedMaps",
    "estimateContaminationFromSkySim", "plotContamination",
    "estimateContamination", "saveFITS")] + [
    ("ops/sht.py", name) for name in (
        "_lgc_table", "car_ring_geometry", "ring_weights")] + [
    ("ops/grf.py", "dec_band_count"),
    ("ops/fourier.py", "radial_distance_map")]


def _function_source(path, name):
    import ast
    with open(path) as f:
        text = f.read()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise KeyError("%s has no function %s" % (path, name))


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS)
def test_copied_function_matches_source(rel, name):
    src = _function_source(os.path.join(ROOT, "nemo_tpu", rel), name)
    dst = _function_source(os.path.join(ROOT, "nemo_tpu_torch", rel), name)
    assert dst == src, "nemo_tpu_torch/%s:%s drifted" % (rel, name)
