"""The port's device observatory (presto_tpu_torch/obs/devprof.py, its
wiring into the executor, qstats, events, the coordinator and the
worker, obs/procstats.py and the overflow counters of ops/hash.py) on
the CPU: the attribution arithmetic equal to presto_tpu's on the same
inputs, under the peak overrides; the wall-split regression of
tests/test_observatory.py; a first-pass harvest that counts, pickles,
rides the program cache, stays on its thread and composes with
torch.func.vmap; the cost columns of system.operator_stats;
``maybe_capture`` and the ``device_profile`` session property writing
a Chrome trace; the profile endpoints and process gauges of the worker
and the coordinator; the two overflow counters moving as presto_tpu's
on the same forced rung; and chip_smoke's phase 13 rehearsed on the
CPU."""

from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.obs import devprof as REF
from presto_tpu.obs.metrics import REGISTRY as REF_REGISTRY

from presto_tpu_torch import Engine
from presto_tpu_torch import kernels as K
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import progcache as PC
from presto_tpu_torch.obs import devprof
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs.metrics import REGISTRY

from tpch_queries import QUERIES

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

NODES = [
    [("TableScan", 0, 10_000, 80_000), ("Join", 10_000, 100, 800)],
    [("TableScan", 0, 60_000, 480_000), ("Filter", 60_000, 1200, 9600),
     ("Aggregate", 1200, 4, 64), ("Sort", 4, 4, 64),
     ("Output", 4, 4, 64)],
    [("MultiJoin", 5_000_000, 77_191, 1_800_000), ("Unnest", 3, 9, 72),
     ("Values", 0, 0, 0), ("Window", -1, 12, 96)],
]
COSTS = [None, {}, {"bytes": 5.0}, {"flops": 1e9, "bytes": 1e8},
         {"flops": 11913788.0, "bytes": 137696819.0, "ops": 317},
         {"flops": 3.0, "arg_bytes": 100, "out_bytes": 28,
          "temp_bytes": 4},
         {"flops": 7e12}]
ENVS = [{}, {devprof.ENV_PEAK_FLOPS: "1e12"},
        {devprof.ENV_PEAK_FLOPS: "1e12", devprof.ENV_PEAK_BW: "garbage"},
        {devprof.ENV_PEAK_FLOPS: "6.7e13", devprof.ENV_PEAK_BW: "3.35e12"},
        {devprof.ENV_PEAK_BW: "-4"}]
Q5 = QUERIES["q05"]
RUNG_SQL = CS.OBSERVE_RUNG_SQL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def torch_tpch():
    return TpchConnector(scale=0.01)


@pytest.fixture(autouse=True)
def _no_known_costs(monkeypatch):
    """Each test starts with a process that has counted no program
    (other test files in the worker run the same queries)."""
    monkeypatch.setattr(devprof, "_KNOWN", {})


def _engine(conn) -> Engine:
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    return e


def _set_env(monkeypatch, env: dict) -> None:
    for name in (devprof.ENV_PEAK_FLOPS, devprof.ENV_PEAK_BW):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


# -- the attribution arithmetic against presto_tpu's -------------------------

@pytest.mark.parametrize("env", ENVS)
def test_device_peaks_equal_the_reference(monkeypatch, env):
    _set_env(monkeypatch, env)
    assert devprof.device_peaks() == REF.device_peaks()
    assert devprof.device_peaks("cpu") == REF.device_peaks()


@pytest.mark.parametrize("env", ENVS)
def test_device_peaks_of_the_card(monkeypatch, env):
    """A CUDA engine's defaults are the H100's (3.35 TB/s, 67 TFLOP/s
    on the CUDA cores); the overrides win over them as over the host's."""
    _set_env(monkeypatch, env)
    flops, bw = devprof.device_peaks("cuda:0")
    try:
        want_flops = float(env.get(devprof.ENV_PEAK_FLOPS, "x"))
    except ValueError:
        want_flops = 0.0
    try:
        want_bw = float(env.get(devprof.ENV_PEAK_BW, "x"))
    except ValueError:
        want_bw = 0.0
    assert flops == (want_flops if want_flops > 0 else 6.7e13)
    assert bw == (want_bw if want_bw > 0 else 3.35e12)


@pytest.mark.parametrize("nodes", NODES)
def test_flop_weight_equals_the_reference(nodes):
    for nt, i, o, _b in nodes:
        assert devprof.flop_weight(nt, i, o) == REF.flop_weight(nt, i, o)
    assert devprof._FLOP_FACTOR == REF._FLOP_FACTOR
    assert devprof._DEFAULT_FLOP_FACTOR == REF._DEFAULT_FLOP_FACTOR


@pytest.mark.parametrize("cost", COSTS[1:])
def test_program_bytes_equals_the_reference(cost):
    assert devprof.program_bytes(cost) == REF.program_bytes(cost)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("nodes", NODES + [[]])
def test_attribute_equals_the_reference(monkeypatch, env, cost, nodes):
    _set_env(monkeypatch, env)
    assert devprof.attribute(cost, nodes) == REF.attribute(cost, nodes)


def test_wall_split_regression_cheap_wide_vs_expensive_narrow():
    """tests/test_observatory.py's pin on the port's attribute: under
    the rows split a cheap-wide TableScan absorbed an expensive-narrow
    Join's wall; with a cost the Join's flops share dominates, the
    parts carry intensity and roofline and sum to the program's flops
    within rounding."""
    nodes = [("TableScan", 0, 10_000, 80_000),
             ("Join", 10_000, 100, 800)]
    rows_w = [0 + 10_000 + 1, 10_000 + 100 + 1]
    join_rows_share = rows_w[1] / sum(rows_w)
    per_node, fw = devprof.attribute({"flops": 1e9, "bytes": 1e8}, nodes)
    assert fw is not None and len(fw) == 2
    join_flops_share = fw[1] / sum(fw)
    assert join_rows_share < 0.55
    assert join_flops_share > 0.85
    for op in per_node:
        assert op["flops"] > 0 and op["hbmBytes"] > 0
        assert op["intensity"] > 0 and op["roofline"] > 0
    assert abs(sum(op["flops"] for op in per_node) - 1e9) < 2
    wall = [100.0 * w / sum(fw) for w in fw]
    assert wall[1] > wall[0]


def test_attribute_without_cost_falls_back_to_rows():
    nodes = [("TableScan", 0, 100, 800), ("Filter", 100, 10, 80)]
    assert devprof.attribute(None, nodes) == ([{}, {}], None)
    assert devprof.attribute({"bytes": 5.0}, nodes)[1] is None
    assert devprof.attribute(None, []) == ([], None)


def test_roofline_of_a_card_engine_uses_the_card_ridge(monkeypatch):
    """The same cost on a CUDA device divides by the H100's ridge
    (67e12 / 3.35e12 = 20 operations a byte)."""
    _set_env(monkeypatch, {})
    nodes = [("Aggregate", 1000, 10, 80)]
    cost = {"flops": 2e6, "bytes": 1e6}
    (host,), _ = devprof.attribute(cost, nodes)
    (card,), _ = devprof.attribute(cost, nodes, "cuda")
    assert host["intensity"] == card["intensity"] == 2.0
    assert host["roofline"] == round(2.0 / 2.5, 4)
    assert card["roofline"] == round(2.0 / 20.0, 4)


# -- the first-pass harvest --------------------------------------------------

def test_harvest_of_a_query_is_nonzero_and_pickles(torch_tpch):
    """Q5's first pass counts operations, bytes and its kernel entries;
    the process keeps the summary under the program's key without the
    kernel backend, and it pickles."""
    e = _engine(torch_tpch)
    harvests = REGISTRY.counter("presto_tpu_cost_harvests_total")
    h0 = harvests.total()
    e.execute(Q5)
    costs = e.last_run.costs
    assert costs and all(c is not None for c in costs)
    assert harvests.total() - h0 == len(costs)
    for cost in costs:
        assert cost["flops"] > 0 and devprof.program_bytes(cost) > 0
        assert cost["ops"] > 0
        assert pickle.loads(pickle.dumps(cost)) == cost
    assert sum(c["kernels"] for c in costs) > 0
    keys = [key for key, _caps in e._program_cache._entries]
    assert [devprof.known_cost(PC.backend_free(k)) for k in keys] == costs
    # a cache hit counts nothing and carries the same cost
    e.execute(Q5)
    assert harvests.total() - h0 == len(costs)
    assert e.last_run.costs == costs


def test_a_program_is_counted_once_per_process(torch_tpch):
    """The process keeps each program's cost under its key without the
    kernel backend: the other backend's run of Q5, a run after its
    cache entries were evicted and another engine's run count nothing
    again and carry the same costs."""
    e = _engine(torch_tpch)
    harvests = REGISTRY.counter("presto_tpu_cost_harvests_total")
    e.session.set("kernel_backend", "torch")
    e.execute(Q5)
    costs, h0 = list(e.last_run.costs), harvests.total()
    # on the CPU the cuda backend's wrappers take the plain versions,
    # under programs of their own in the cache
    e.session.set("kernel_backend", "cuda")
    e.execute(Q5)
    assert harvests.total() == h0 and e.last_run.costs == costs
    assert len(e._program_cache) == 2 * len(costs)
    e.session.set("program_cache_entries", 1)
    e.execute("select count(*) from region")  # one new program
    e.execute(Q5)
    assert harvests.total() == h0 + 1 and e.last_run.costs == costs
    other = _engine(torch_tpch)
    other.execute(Q5)
    assert harvests.total() == h0 + 1 and other.last_run.costs == costs


def test_the_cost_memory_is_bounded(monkeypatch):
    monkeypatch.setattr(devprof, "KNOWN_PROGRAMS", 3)
    for k in range(5):
        devprof.remember_cost(("p", k), {"flops": float(k + 1)})
    devprof.remember_cost(("p", 9), None)  # nothing counted: not kept
    assert [devprof.known_cost(("p", k)) for k in range(5)] == [
        None, None, {"flops": 3.0}, {"flops": 4.0}, {"flops": 5.0}]
    assert devprof.known_cost(("p", 9)) is None


def test_forgotten_costs_are_counted_again(torch_tpch):
    """After ``forget_costs`` a fresh engine's first pass of Q5 counts
    each program again, to the same cost."""
    e = _engine(torch_tpch)
    e.execute(Q5)
    costs = list(e.last_run.costs)
    harvests = REGISTRY.counter("presto_tpu_cost_harvests_total")
    devprof.forget_costs()
    h0 = harvests.total()
    other = _engine(torch_tpch)
    other.execute(Q5)
    assert harvests.total() - h0 == len(costs)
    assert other.last_run.costs == costs


# a first use of the observatory in a fresh process: (code, its output)
FIRST_USES = {
    "harvest": ("with devprof.harvest() as c:\n"
                "    torch.ones(8) * 2\n"
                "print(c.ops)\n", "2"),
    "capture": ("with devprof.maybe_capture(True, cuda=False) as d:\n"
                "    torch.ones(8) * 2\n"
                "print(os.path.exists(os.path.join(d, devprof.TRACE_FILE)))\n",
                "True"),
}


@pytest.mark.parametrize("use", sorted(FIRST_USES))
def test_first_use_of_a_process_imports_no_compiler(tmp_path, use):
    """The counting mode's and a capture's first call in a process
    import neither torch._dynamo nor sympy: a mode's
    ``__torch_dispatch__`` made in its class body would, through torch's
    compile guard, and so would ``torch.profiler.profile``'s start;
    seconds once a process, paid by its first query."""
    import subprocess
    code, want = FIRST_USES[use]
    code = ("import os, sys, torch\n"
            "from presto_tpu_torch.obs import devprof\n" + code +
            "print('torch._dynamo' in sys.modules, 'sympy' in sys.modules)\n")
    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=root,
        env={**os.environ, "PYTHONPATH": root,
             devprof.ENV_PROFILE_DIR: str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, "False", "False"], out.stdout


def test_kernel_entry_counts_by_its_formula():
    """A kernel entry under a harvest counts its COSTS formula and none
    of the torch operations inside it, on either backend; outside a
    harvest it counts nothing."""
    data = torch.arange(1000, dtype=torch.int64)
    ids = (torch.arange(1000) % 7).to(torch.int32)
    flops, nbytes = K.COSTS["agg_sum"](data, ids, 7)
    assert (flops, nbytes) == (1000, 1000 * 8 + 1000 * 4 + 7 * 8)
    for backend in ("torch", "cuda"):
        with devprof.harvest() as counted:
            out = K.dispatch("agg_sum", backend)(data, ids, 7)
        assert counted.kernels == 1 and counted.ops == 0
        assert (counted.flops, counted.bytes) == (flops, nbytes)
        assert torch.equal(out, torch.bincount(ids.long(), data, 7).long())
    assert not devprof.harvesting()


def test_harvest_stays_on_its_thread():
    """The dispatch mode and the counter are per thread: another
    thread's operations while one thread harvests count nothing."""
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait()
        a = torch.arange(10_000)
        for _ in range(50):
            a = a + 1
        done.set()
    with devprof.harvest() as alone:
        torch.ones(10) * 2
    t = threading.Thread(target=other)
    t.start()
    with devprof.harvest() as counted:
        started.set()
        done.wait(30)
        torch.ones(10) * 2
    t.join()
    assert alone.ops == 2 and alone.flops == 20
    assert (counted.ops, counted.flops, counted.bytes) == (
        alone.ops, alone.flops, alone.bytes)


def test_harvest_composes_with_vmap():
    """Under torch.func.vmap the harvest sees the physical operations,
    and a kernel entry's lane rule counts its one folded launch."""
    data = torch.arange(4 * 100, dtype=torch.int64).reshape(4, 100)
    ids = (torch.arange(100) % 5).to(torch.int32)

    def lane(d):
        return K.dispatch("agg_sum", "torch")(d * 3, ids, 5)
    with devprof.harvest() as counted:
        out = torch.func.vmap(lane)(data)
    assert out.shape == (4, 5)
    assert counted.kernels == 1
    assert counted.flops >= 4 * 100 * 2  # the multiply and the fold
    for k in range(4):
        assert torch.equal(out[k], torch.bincount(ids.long(),
                                                  data[k] * 3, 5).long())


def test_batched_first_pass_harvests(torch_tpch):
    """exec/batch.py's vmapped first pass counts the batched program's
    cost, which the process keeps under the batch's key."""
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec.batch import run_plan_batched
    e = _engine(torch_tpch)
    sqls = [f"select count(*), sum(l_quantity) from lineitem "
            f"where l_discount < 0.0{d}" for d in (2, 4, 6)]
    templates = [TPL.parameterize(e.plan_sql(sql)[0]) for sql in sqls]
    out = run_plan_batched(e, templates)
    assert [t.to_pylist() for t in out] == [e.execute(sql) for sql in sqls]
    batch = [k for k, _caps in e._program_cache._entries
             if ("batch", 4) in k]
    assert len(batch) == 1
    assert devprof.known_cost(PC.backend_free(batch[0]))["flops"] > 0


def test_operator_stats_carry_the_cost(torch_tpch):
    """Every operator row of a query has nonzero flops, hbm_bytes,
    intensity and roofline; each program's rows sum to its harvested
    flops within rounding; a cache hit's rows carry the cost too."""
    e = _engine(torch_tpch)
    qids: list = []
    e.events.add_listener(lambda ev: qids.append(ev.query_id)
                          if hasattr(ev, "end_time") else None)
    e.execute(Q5)
    cold = CS.check_costs(e, qids[-1], e.last_run.costs)
    e.execute(Q5)
    hit = CS.check_costs(e, qids[-1], e.last_run.costs)
    assert cold["flops"] == hit["flops"]
    # the wall splits by the flops share: the MultiJoin leads
    rows = e.execute(
        "select node_type, wall_ms, flops from system.operator_stats "
        f"where query_id = '{qids[-2]}' order by flops desc")
    assert rows[0][0] == "MultiJoin"


# -- the capture -------------------------------------------------------------

def _trace(artifact: str) -> list:
    with open(os.path.join(artifact, devprof.TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_maybe_capture_writes_a_cpu_trace(tmp_path, monkeypatch):
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path))
    captures = REGISTRY.counter("presto_tpu_profile_captures_total")
    c0 = captures.value(result="started")
    with devprof.maybe_capture(True, "q/1 x", cuda=False) as d:
        assert d.startswith(str(tmp_path)) and devprof.capturing()
        assert os.path.basename(d).startswith("q_1_x-")
        torch.sort(torch.arange(1000) % 7)
    assert not devprof.capturing()
    names = {e.get("name") for e in _trace(d)}
    assert "aten::sort" in names
    assert captures.value(result="started") == c0 + 1
    with devprof.maybe_capture(False) as none:
        assert none is None


def test_capture_is_one_per_process(tmp_path, monkeypatch):
    """A second start reports the live capture; a stop without one is a
    no-op; a capture that cannot start reports its error and counts a
    failure, and maybe_capture then yields None."""
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path))
    first = devprof.start_capture("a", cuda=False)
    try:
        assert first["started"] and first["profiling"]
        assert devprof.start_capture("b", cuda=False) == {
            "profiling": True, "dir": first["dir"], "started": False}
    finally:
        stopped = devprof.stop_capture()
    assert stopped == {"profiling": False, "artifact": first["dir"]}
    assert devprof.stop_capture() == {"profiling": False,
                                      "artifact": None}

    def broken(cuda):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(devprof, "_profiler", broken)
    failed = REGISTRY.counter("presto_tpu_profile_captures_total")
    f0 = failed.value(result="failed")
    res = devprof.start_capture("c", cuda=False)
    assert res == {"profiling": False, "started": False,
                   "error": "RuntimeError: no profiler here"}
    assert failed.value(result="failed") == f0 + 1
    with devprof.maybe_capture(True) as d:
        assert d is None


def test_device_profile_session_property(torch_tpch, tmp_path,
                                         monkeypatch):
    """SET SESSION device_profile = true wraps the query in a capture:
    the artifact directory is on the query's record and history, its
    trace holds the query's operations, and the property keys no
    program."""
    from presto_tpu_torch.exec import progcache as PC
    assert "device_profile" not in PC.TRACE_RELEVANT_PROPERTIES
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path / "prof"))
    monkeypatch.setenv("PRESTO_TPU_HISTORY_DIR", str(tmp_path / "hist"))
    e = _engine(torch_tpch)
    qids: list = []
    e.events.add_listener(lambda ev: qids.append(ev.query_id)
                          if hasattr(ev, "end_time") else None)
    e.execute("select count(*) from region")
    e.execute("set session device_profile = true")
    rows = e.execute("select n_regionkey, count(*) from nation "
                     "group by n_regionkey order by n_regionkey")
    assert rows == [(k, 5) for k in range(5)]
    qid = qids[-1]
    e.execute("set session device_profile = false")
    artifact = QS.STORE.get(qid).snapshot()["profile"]
    assert artifact.startswith(str(tmp_path / "prof"))
    assert os.path.basename(artifact).startswith(qid)
    assert any(str(ev.get("name", "")).startswith("aten::")
               for ev in _trace(artifact))
    hist = e.execute("select query_id from system.query_history")
    assert (qid,) in [tuple(r) for r in hist]
    with open(tmp_path / "hist" / "query_history.jsonl") as f:
        recs = {r["query_id"]: r for r in map(json.loads, f)}
    assert recs[qid]["profile"] == artifact
    assert recs[qids[0]]["profile"] is None


# -- the endpoints and the process gauges ------------------------------------

def _post(url: str):
    req = urllib.request.Request(url, data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _metrics(url: str) -> str:
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        return r.read().decode()


def test_worker_profile_endpoints_and_gauges(torch_tpch, tmp_path,
                                             monkeypatch):
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path))
    worker = WorkerServer({"tpch": torch_tpch}, node_id="obsw0",
                          device="cpu").start()
    local = _engine(torch_tpch)
    coord = ClusterCoordinator(local, heartbeat_interval_s=0.2).start()
    try:
        coord.add_worker(worker.uri)
        CS.wait_all_live(coord)
        status, started = _post(worker.uri + "/v1/profile/start")
        assert status == 200 and started["started"]
        assert started["dir"].startswith(str(tmp_path))
        got = coord.execute(CS.OBSERVE_WORKER_SQL)
        status, stopped = _post(worker.uri + "/v1/profile/stop")
        metrics = _metrics(worker.uri)
    finally:
        coord.stop()
        worker.stop()
    assert got == local.execute(CS.OBSERVE_WORKER_SQL)
    assert status == 200 and stopped["artifact"] == started["dir"]
    assert any(str(ev.get("name", "")).startswith("aten::")
               for ev in _trace(stopped["artifact"]))
    for gauge in CS.PROCESS_GAUGES:
        assert f'{gauge}{{node="obsw0"}}' in metrics, gauge
    rss = [ln for ln in metrics.splitlines()
           if ln.startswith('presto_tpu_process_rss_bytes{node="obsw0"}')]
    assert float(rss[0].split()[-1]) > 10 << 20


def test_coordinator_profile_endpoints_and_gauges(torch_tpch, tmp_path,
                                                  monkeypatch):
    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server import CoordinatorServer
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path))
    srv = CoordinatorServer(_engine(torch_tpch)).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, started = _post(base + "/v1/profile/start")
        assert status == 200 and started["profiling"]
        again = _post(base + "/v1/profile/start")
        assert again == (200, {"profiling": True, "dir": started["dir"],
                               "started": False})
        rows = Client(base, user="u").execute(
            "select count(*) from nation")[1]
        status, stopped = _post(base + "/v1/profile/stop")
        assert _post(base + "/v1/profile/stop") == (
            200, {"profiling": False, "artifact": None})
        metrics = _metrics(base)
    finally:
        srv.stop()
    assert rows == [[25]] or rows == [(25,)]
    assert status == 200 and stopped["artifact"] == started["dir"]
    assert os.path.isfile(os.path.join(stopped["artifact"],
                                       devprof.TRACE_FILE))
    for gauge in CS.PROCESS_GAUGES:
        assert f'{gauge}{{node="coordinator"}}' in metrics, gauge


# -- the overflow counters ---------------------------------------------------

def test_overflow_counters_move_as_the_reference(torch_tpch, tpch_tiny):
    """The same group-by with its table hinted too small climbs the same
    rungs on both engines, and each package's two counters move by the
    same amounts: one retry per rung, one probe overflow per hash-table
    rung."""
    deltas = []
    for engine, registry in ((_engine(torch_tpch), REGISTRY),
                             (RefEngine(), REF_REGISTRY)):
        if isinstance(engine, RefEngine):
            engine.register_catalog("tpch", tpch_tiny)
        want = engine.execute(RUNG_SQL)
        engine.session.set("groupby_table_size", CS.OBSERVE_TABLE_SIZE)
        retries = registry.counter(
            "presto_tpu_capacity_overflow_retries_total")
        probes = registry.counter("presto_tpu_hash_probe_overflow_total")
        r0, p0 = retries.total(), probes.total()
        f0 = retries.value(operator="final")
        t0 = retries.value(operator="table")
        assert engine.execute(RUNG_SQL) == want
        deltas.append((retries.total() - r0, probes.total() - p0,
                       retries.value(operator="final") - f0
                       + retries.value(operator="table") - t0))
    assert deltas[0] == deltas[1]
    assert deltas[0][0] >= 1 and deltas[0][0] == deltas[0][1]


def test_grow_overflowed_counts_each_failed_key():
    from presto_tpu_torch.ops import hash as H
    retries = REGISTRY.counter("presto_tpu_capacity_overflow_retries_total")
    probes = REGISTRY.counter("presto_tpu_hash_probe_overflow_total")
    before = {k: retries.value(operator=k) for k in ("table", "out")}
    p0 = probes.total()
    caps: dict = {}
    keys = [(0, "table"), (1, "out"), (2, "table")]
    n = H.grow_overflowed(caps, keys, np.array([False, False, True]),
                          {k: 8 for k in keys}, 4)
    assert n == 1 and caps == {(0, "table"): 32, (1, "out"): 32}
    assert retries.value(operator="table") - before["table"] == 1
    assert retries.value(operator="out") - before["out"] == 1
    assert probes.total() - p0 == 1


# -- chip_smoke's phase 13 on the CPU ----------------------------------------

def test_chip_smoke_observe_cases_on_the_cpu(monkeypatch, torch_tpch):
    """Phase 13 of chip_smoke.py at SF0.01 with every engine on the CPU
    (its card calls stubbed; the trace must hold aten operations, where
    the card's names its kernels): O1's harvests (a first pass counted
    once a program when its costs are forgotten, never when they are
    known; a cold run and its hit), O2's trace, O3's cost columns, O4's
    worker endpoints and gauges, O5's rung counted once. The launch
    counts need the card: here 0."""
    import presto_tpu_torch
    from presto_tpu_torch.parallel import worker as W

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)

    class CpuEngine(Engine):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    class CpuWorker(W.WorkerServer):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    monkeypatch.setattr(presto_tpu_torch, "Engine", CpuEngine)
    monkeypatch.setattr(W, "WorkerServer", CpuWorker)
    one = _engine(torch_tpch)
    out = CS.observe_cases(torch_tpch, torch_tpch, one.execute(Q5),
                           trace_names=("aten::",))
    # Q5's programs were counted by the run above, on the same tables
    o1 = out["O1"]
    assert o1["cold_harvests"] == 0 and o1["programs"] >= 1
    assert o1["hit_harvests"] == 0
    assert len(o1["first_s"]) == len(o1["first_counted_s"]) \
        == CS.OBSERVE_FIRST_PASS_PAIRS
    assert out["O5"]["rungs"] == out["O5"]["retries"] >= 1
    assert not any(out["launches"].values())
