"""No module of the benchmark imports JAX or the JAX package, compared
by whole top-level name (``presto_tpu_torch`` is the program, and
``presto_tpu`` is not); the references import nothing of the program
either."""

from __future__ import annotations

import ast

from conftest import BENCH

NEVER = {"jax", "jaxlib", "flax", "presto_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & NEVER, f


def test_references_stand_alone():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) >= 16
    for f in files:
        tops = set(_imports(f))
        assert not tops & (NEVER | {"presto_tpu_torch", "harness",
                                    "datagen"}), f
        assert tops <= {"__future__", "decimal", "numpy", "torch",
                        "reference"}, (f, tops)


def test_scanner_sees_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom presto_tpu.kernels import x\n"
                 "import presto_tpu_torch\n")
    assert set(_imports(p)) == {"jax", "presto_tpu", "presto_tpu_torch"}
