"""The port stands alone: it imports neither jax nor the presto_tpu
package (not even its pure-Python modules), and its Engine refuses to
run without CUDA unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "presto_tpu_torch"


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "presto_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_module_of_the_port_imports_jax_or_presto_tpu():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "profile_port.py"]
    assert len(files) > 40
    bad = [f"{f.relative_to(REPO)}:{line}: {mod}"
           for f in files for line, mod in _imports(f) if _forbidden(mod)]
    assert not bad, bad
    # the prefix rule itself: presto_tpu_torch is allowed
    assert not _forbidden("presto_tpu_torch.ops.hash")
    assert _forbidden("presto_tpu.ops.hash") and _forbidden("jax.numpy")


def test_query_in_a_fresh_process_loads_neither_jax_nor_presto_tpu():
    code = """
import json, sys
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
e = Engine(device="cpu")
e.register_catalog("tpch", TpchConnector(scale=0.01))
rows = e.execute("select count(*), sum(l_quantity) from lineitem "
                 "where l_discount < 0.05")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu"))
print(json.dumps({"rows": len(rows), "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rows": 1, "bad": []}


def test_engine_without_a_device_needs_cuda():
    from presto_tpu_torch import Engine
    if torch.cuda.is_available():
        assert Engine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(device="cuda")
    assert Engine(device="cpu").device.type == "cpu"
