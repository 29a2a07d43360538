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
                                          REPO / "profile_port.py",
                                          REPO / "kernel_ab.py"]
    assert len(files) > 40
    # the statement surface's, the cluster tier's (with the native
    # codec's loader) and the server tier's modules are among them
    for module in ("events.py", "security.py", "transaction.py",
                   "memory.py", "client.py", "dbapi.py", "cli.py",
                   "exec/batch.py", "kernels/lanes.py",
                   *(f"server/{m}.py" for m in (
                       "__init__", "results", "governance",
                       "resource_groups", "ui", "server", "serving")),
                   "obs/trace.py", "obs/jsonlog.py",
                   "connectors/information_schema.py",
                   "connectors/blackhole.py", "plan/serde.py",
                   "connectors/split.py", "server/httpbase.py",
                   "native/__init__.py", "obs/qstats.py",
                   "cost/adapt.py", "ft/faults.py", "ft/retry.py",
                   "ft/spool.py", "ft/speculate.py",
                   *(f"parallel/{m}.py" for m in (
                       "auth", "exchange_host", "wire", "buffer",
                       "fragmenter", "worker", "coordinator",
                       "adaptive")),
                   # parquet scans, the device observatory and the
                   # test tooling
                   "formats/__init__.py", "formats/parquet.py",
                   "connectors/parquet.py", "obs/devprof.py",
                   "obs/procstats.py", "testing/__init__.py",
                   "testing/oracle.py", "testing/verifier.py",
                   "sql/sqlite_dialect.py"):
        assert PORT / module in files, module
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


def test_statements_in_a_fresh_process_load_neither_jax_nor_presto_tpu():
    code = """
import json, sys
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.blackhole import BlackholeConnector
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.security import AccessRule, RuleBasedAccessControl
e = Engine(device="cpu")
e.register_catalog("tpch", TpchConnector(scale=0.01))
e.register_catalog("memory", MemoryConnector())
e.register_catalog("blackhole", BlackholeConnector())
e.access_control = RuleBasedAccessControl([AccessRule()])
for sql in ("create table memory.n as select n_name, n_regionkey from nation",
            "start transaction", "update memory.n set n_regionkey = 9",
            "rollback", "delete from memory.n where n_regionkey = 0",
            "create table blackhole.x as select 1 as a", "show catalogs",
            "describe memory.n", "drop table memory.n"):
    e.execute(sql)
rows = e.execute("select count(*) from system.runtime.queries")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu"))
print(json.dumps({"rows": int(rows[0][0]), "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rows": 9, "bad": []}


def test_cluster_in_a_fresh_process_loads_neither_jax_nor_presto_tpu():
    """Two workers on the CPU and a coordinator run a partial aggregate
    and a fragmented join over loopback HTTP, the native page codec
    loads, and neither jax nor presto_tpu is imported."""
    code = """
import json, sys
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.native import codec
from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
from presto_tpu_torch.parallel.worker import WorkerServer
conn = TpchConnector(scale=0.01)
workers = [WorkerServer({"tpch": conn}, device="cpu").start()
           for _ in range(2)]
coord = None
try:
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    coord = ClusterCoordinator(e).start()
    for w in workers:
        coord.add_worker(w.uri)
    n = coord.execute("select count(*) from lineitem")[0][0]
    j = coord.execute("select count(*) from orders, lineitem "
                      "where o_orderkey = l_orderkey")[0][0]
    mode = coord.last_distribution["mode"]
finally:
    if coord is not None:
        coord.stop()
    for w in workers:
        w.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu"))
print(json.dumps({"same": int(n) == int(j), "mode": mode,
                  "codec": codec() is not None, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"same": True, "mode": "fragments", "codec": True,
                   "bad": []}


def test_server_in_a_fresh_process_loads_neither_jax_nor_presto_tpu():
    """A CoordinatorServer over a CPU engine answers a JSON and an arrow
    client, a cross-query batch runs under torch.func.vmap, and
    neither jax nor presto_tpu is imported."""
    code = """
import json, sys, threading
from presto_tpu_torch import Engine
from presto_tpu_torch import templates as TPL
from presto_tpu_torch.client import Client
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import batch as B
from presto_tpu_torch.server import CoordinatorServer
import presto_tpu_torch.dbapi, presto_tpu_torch.cli
e = Engine(device="cpu")
e.register_catalog("tpch", TpchConnector(scale=0.01))
srv = CoordinatorServer(e).start()
try:
    base = f"http://127.0.0.1:{srv.port}"
    j = Client(base).execute("select count(*) from nation")[1]
    a = Client(base, result_format="arrow").execute(
        "select count(*) from region")[1]
finally:
    srv.stop()
sqls = [f"select count(*) from lineitem where l_quantity < {q}"
        for q in (10, 20)]
lanes = B.run_plan_batched(e, [TPL.parameterize(e.plan_sql(s)[0])
                               for s in sqls])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu"))
print(json.dumps({"rows": [j, a], "lanes": len(lanes), "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rows": [[[25]], [[5]]], "lanes": 2, "bad": []}


def test_parquet_and_observatory_in_a_fresh_process_load_neither():
    """A parquet table written by pyarrow, read and queried under
    device_profile (a torch.profiler capture), its cost columns, a
    worker's /metrics and profile endpoints and the port's own sqlite
    oracle, and neither jax nor presto_tpu is imported."""
    code = """
import json, os, sys, tempfile, urllib.request
import numpy as np
import pyarrow as pa, pyarrow.parquet as pq
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.parquet import ParquetConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.obs import devprof
from presto_tpu_torch.parallel.worker import WorkerServer
from presto_tpu_torch.testing import SqliteOracle, assert_query
d = tempfile.mkdtemp()
os.environ[devprof.ENV_PROFILE_DIR] = os.path.join(d, "prof")
pq.write_table(pa.table({"k": np.arange(100) % 7, "v": np.arange(100)}),
               os.path.join(d, "t.parquet"))
conn = ParquetConnector(d)
e = Engine(device="cpu")
e.register_catalog("pq", conn)
e.session.catalog = "pq"
e.session.set("device_profile", True)
sql = "select k, sum(v) from t group by k order by k"
rows = e.execute(sql)
e.session.set("device_profile", False)
o = SqliteOracle()
o.load_connector(conn)
assert_query(e, o, sql)
costed = e.execute("select count(*) from system.operator_stats "
                   "where flops > 0")[0][0]
w = WorkerServer({"tpch": TpchConnector(scale=0.01)}, device="cpu").start()
try:
    req = urllib.request.Request(w.uri + "/v1/profile/start", data=b"{}",
                                 method="POST")
    started = urllib.request.urlopen(req, timeout=60).status
    req = urllib.request.Request(w.uri + "/v1/profile/stop", data=b"{}",
                                 method="POST")
    stopped = urllib.request.urlopen(req, timeout=60).status
    metrics = urllib.request.urlopen(w.uri + "/metrics").read().decode()
finally:
    w.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "presto_tpu"))
print(json.dumps({"rows": len(rows), "costed": bool(costed > 0),
                  "endpoints": [started, stopped],
                  "gauge": "presto_tpu_process_rss_bytes" in metrics,
                  "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rows": 7, "costed": True, "endpoints": [200, 200],
                   "gauge": True, "bad": []}


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
