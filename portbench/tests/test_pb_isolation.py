"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names, compared
whole: nemo_tpu_torch begins with nemo_tpu)."""

import ast
import os

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(sub=""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = top_level_imports(path) & {"jax", "jaxlib", "flax",
                                         "nemo_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in modules("reference"):
        names = top_level_imports(path)
        assert not names & {"nemo_tpu_torch", "jax", "nemo_tpu"}, path


def test_top_level_names_compare_whole():
    from portbench import harness
    assert harness.forbidden_modules(["nemo_tpu_torch", "nemo_tpu_torch.ops",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["nemo_tpu.filters", "jax.numpy",
                                      "jaxlib", "flax"]) \
        == ["flax", "jax", "jaxlib", "nemo_tpu"]
