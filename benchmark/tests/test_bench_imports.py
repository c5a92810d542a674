"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: pbwt_tpu_torch is not pbwt_tpu), and the plain
references import nothing of the program."""

import ast
import os

from benchmark import harness
from conftest import ROOT

HOME = os.path.join(ROOT, "benchmark")


def imported(path):
    """Top-level names of the modules a file imports."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HOME, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    found = {p: imported(p) & set(harness.FORBIDDEN) for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_references_import_nothing_of_the_program():
    for p in sources("reference"):
        assert imported(p) <= {"__future__", "numpy", "torch"}, p


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["pbwt_tpu_torch.ops", "jaxtyping",
                                      "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["pbwt_tpu.cli", "jaxlib.xla", "jax",
                                      "flax"]) == ["flax", "jax", "jaxlib",
                                                   "pbwt_tpu"]
