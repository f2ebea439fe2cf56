"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared
whole: `dawnsearch_tpu_torch` begins with `dawnsearch_tpu`."""

import ast
import os
import sys

from benchmark import run
from benchmark.tests.conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "dawnsearch_tpu"}


def _imports(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & JAX for p in _modules()}
    assert not {p: n for p, n in found.items() if n}
    assert len(found) > 20


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for p in _modules():
        if p.startswith(ref):
            assert "dawnsearch_tpu_torch" not in _imports(p), p
            assert not _imports(p) & JAX, p


def test_the_runs_look_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dawnsearch_tpu_torch_fake", sys)
    assert "dawnsearch_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dawnsearch_tpu.fake", sys)
    assert "dawnsearch_tpu" in run.loaded_forbidden()


def test_the_walk_sees_a_planted_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom dawnsearch_tpu.x import y\n"
                 "import dawnsearch_tpu_torch\n")
    assert _imports(str(p)) == {"jax", "dawnsearch_tpu",
                                "dawnsearch_tpu_torch"}
