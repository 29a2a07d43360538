"""The port's runtime query statistics (presto_tpu_torch/obs/qstats.py)
and what reads them: the Query -> Stage -> Task -> Operator tree of a
distributed TPC-H Q5 over workers on device="cpu", the system.tasks /
operator_stats / plan_divergence / query_history / nodes tables, the
history file across an engine restart, and the cost model reading the
divergence ledger. The counterparts of tests/test_runtime_stats.py
(whose coordinator server, protocol client and process gauges are
ROADMAP Queue 1 items 9 and 11: here the queries run through
ClusterCoordinator.execute), then held against presto_tpu: after the
same queries the two ledgers' records, the two clusters' system.tasks
and operator_stats rows, and the estimates over a poisoned ledger
agree. Plus Engine.device_array under concurrent uploads."""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.cost import row_estimates as ref_row_estimates
from presto_tpu.obs import qstats as REF_QS

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.cost import row_estimates
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
from presto_tpu_torch.parallel.worker import WorkerServer

from tpch_queries import QUERIES

Q5 = QUERIES["q05"]


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


@pytest.fixture(scope="module")
def stats_cluster(torch_tpch, tpch_tiny):
    workers, coord = [], None
    try:
        workers = [WorkerServer({"tpch": torch_tpch}, node_id=f"statw{i}",
                                device="cpu").start()
                   for i in range(2)]
        engine = Engine(device="cpu")
        engine.register_catalog("tpch", torch_tpch)
        engine.session.catalog = "tpch"
        coord = ClusterCoordinator(engine, heartbeat_interval_s=0.2).start()
        for w in workers:
            coord.add_worker(w.uri)
        ref = RefEngine()
        ref.register_catalog("tpch", tpch_tiny)
        yield coord, workers, engine, ref.execute(Q5)
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


def _run(coord, engine, want, sql=Q5) -> str:
    """Run ``sql`` on the cluster (rows equal to ``want``); returns its
    query id."""
    assert coord.execute(sql) == want
    return engine.events.history[-1].query_id


def _tree(qid: str) -> dict:
    rec = QS.STORE.get(qid)
    assert rec is not None
    return rec.snapshot()


def test_distributed_q5_stats_tree_and_conservation(stats_cluster):
    """After a distributed Q5 the recorder holds the whole tree, and
    stage output rows sum consistently with consumer input rows
    (partitioned sources) and the coordinator's gathered partials."""
    coord, _workers, engine, want = stats_cluster
    qid = _run(coord, engine, want)
    assert coord.last_distribution["mode"] == "fragments"

    qs = _tree(qid)
    assert qs["state"] == "FINISHED"
    stages = {s["stage"]: s for s in qs["stages"]}
    worker_stages = [s for n, s in stages.items() if n != "coordinator"]
    assert len(worker_stages) >= 2
    for s in worker_stages:
        assert len(s["tasks"]) == 2
        for t in s["tasks"]:
            assert t["state"] == "finished"
            assert t["node"].startswith("statw")
            assert t["wallMillis"] >= 0
            assert t["operators"], t["taskId"]
            for op in t["operators"]:
                assert op["outputRows"] >= 0

    checked = 0
    for s in qs["stages"]:
        for tname, src in (s.get("sources") or {}).items():
            producer = stages[src["stage"]]
            got = s["inputRowsBySource"].get(tname, 0)
            expect = producer["outputRows"]
            if src["mode"] == "all":
                expect *= len(s["tasks"])
            assert got == expect, (s["stage"], tname, got, expect)
            checked += 1
    assert checked >= 1

    coordinator = stages["coordinator"]
    gathered = coordinator["inputRowsBySource"].get("__partials__", 0)
    assert gathered > 0
    assert any(s["outputRows"] == gathered for s in worker_stages)
    assert qs["outputRows"] == coordinator["outputRows"] == len(want)


def test_warm_rerun_populates_tree_from_the_program_cache(stats_cluster):
    """A warm rerun of Q5 still populates the whole tree, and its worker
    tasks report program-cache hits, not misses (the stats ride the
    cached path)."""
    coord, _workers, engine, want = stats_cluster
    _run(coord, engine, want)  # warm
    qs = _tree(_run(coord, engine, want))
    worker_stages = [s for s in qs["stages"]
                     if s["stage"] != "coordinator"]
    assert worker_stages and all(s["tasks"] for s in worker_stages)
    warm_tasks = [t for s in worker_stages for t in s["tasks"]]
    assert sum(t["cacheHits"] for t in warm_tasks) > 0
    assert sum(t["compiles"] for t in warm_tasks) == 0
    assert all(op["outputRows"] >= 0
               for t in warm_tasks for op in t["operators"])


def test_system_tables_queryable_mid_flight_and_after(stats_cluster,
                                                      torch_tpch):
    """system.tasks answers after a query and while one is in flight (a
    second engine probes the process-wide store; the probing query's
    own task is running at scan time)."""
    coord, _workers, engine, want = stats_cluster
    qid = _run(coord, engine, want)
    # after: the finished Q5's tasks and operators are SQL-visible (read
    # before the probe engine runs: query ids count per engine, and a
    # later recorder under the same id replaces this one in the store)
    rows = engine.execute(
        f"select stage, output_rows from system.tasks "
        f"where query_id = '{qid}' order by stage")
    assert len(rows) >= 3
    ops = engine.execute(
        f"select node_type, output_rows, est_rows from "
        f"system.operator_stats where query_id = '{qid}'")
    assert {"TableScan", "Aggregate"} <= {r[0] for r in ops}
    div = engine.execute(
        "select node_type, est_rows, actual_rows, ratio "
        "from system.plan_divergence")
    kinds = {r[0] for r in div}
    assert {"TableScan", "Filter", "Aggregate"} <= kinds
    assert all(r[1] >= 0 and r[2] >= 0 and r[3] >= 0.0 for r in div)
    assert QS._DIVERGENCE_RATIO.count(node_type="TableScan") > 0

    probe = Engine(device="cpu")
    probe.register_catalog("tpch", torch_tpch)
    done = threading.Event()
    err: list = []

    def bg():
        try:
            assert coord.execute(Q5) == want
        except Exception as e:  # noqa: BLE001 - reported below
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=bg, daemon=True)
    t.start()
    saw_running = False
    for _ in range(100):
        rows = probe.execute("select task_id, state from system.tasks")
        assert rows
        if any(state == "running" for _tid, state in rows):
            saw_running = True
        if done.is_set():
            break
        time.sleep(0.05)
    done.wait(120)
    t.join(10)
    assert not err, err
    assert saw_running


def test_history_jsonl_survives_engine_restart(tmp_path, torch_tpch,
                                               monkeypatch):
    """Finished-query profiles persist to the history JSONL and a fresh
    engine repopulates system.query_history from disk."""
    hist = str(tmp_path / "hist")
    monkeypatch.setenv("PRESTO_TPU_HISTORY_DIR", hist)
    e1 = Engine(device="cpu")
    e1.register_catalog("tpch", torch_tpch)
    e1.execute("select count(*) from nation")
    rows = e1.execute(
        "select query_id, state, output_rows from system.query_history")
    assert len(rows) == 1 and rows[0][1] == "FINISHED"
    qid = rows[0][0]
    with open(os.path.join(hist, "query_history.jsonl"),
              encoding="utf-8") as f:
        recs = [json.loads(ln) for ln in f]
    rec = next(r for r in recs if r["query_id"] == qid)
    assert rec["stats"]["stages"]

    e2 = Engine(device="cpu")
    e2.register_catalog("tpch", torch_tpch)
    rows2 = e2.execute("select query_id, state from system.query_history")
    assert (qid, "FINISHED") in [tuple(r) for r in rows2]


def test_system_nodes_reflects_live_cluster(stats_cluster):
    """system.nodes reports every worker's uri and lifecycle state from
    the live cluster view."""
    coord, workers, engine, _want = stats_cluster
    deadline = time.time() + 10
    by_id = {}
    while time.time() < deadline:
        rows = engine.execute(
            "select node_id, http_uri, coordinator, state "
            "from system.nodes order by node_id")
        by_id = {r[0]: r for r in rows}
        if {"statw0", "statw1"} <= set(by_id):
            break
        time.sleep(0.2)
    assert {"coordinator", "statw0", "statw1"} <= set(by_id)
    assert by_id["statw0"][1] == workers[0].uri
    assert by_id["coordinator"][2] == "true"
    assert all(r[3] == "active" for r in rows)

    def put_state(state):
        req = urllib.request.Request(
            f"{workers[1].uri}/v1/info/state", method="PUT",
            data=json.dumps({"state": state}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10):
            pass

    put_state("SHUTTING_DOWN")
    try:
        deadline = time.time() + 10
        state = None
        while time.time() < deadline:
            state = dict(engine.execute(
                "select node_id, state from system.nodes")).get("statw1")
            if state == "draining":
                break
            time.sleep(0.2)
        assert state == "draining"
    finally:
        put_state("ACTIVE")
    deadline = time.time() + 10
    while time.time() < deadline and len(coord.live_workers()) < 2:
        time.sleep(0.1)
    assert len(coord.live_workers()) == 2


def test_worker_join_scale_out(stats_cluster, torch_tpch):
    """A worker admitted through join_worker enters ``joining`` (in
    system.nodes), turns ``active`` on its first heartbeat, and the
    next query fans out over the grown cluster."""
    coord, workers, engine, _want = stats_cluster
    sql = ("select l_returnflag, count(*) as c from lineitem "
           "group by l_returnflag order by l_returnflag")
    want = engine.execute(sql)
    assert coord.execute(sql) == want
    assert coord.last_distribution["nshards"] == len(workers)

    w3 = WorkerServer({"tpch": torch_tpch}, node_id="statw2",
                      device="cpu").start()
    try:
        handle = coord.join_worker(w3.uri)
        assert handle.state == "joining"
        nodes = {r[0]: r[1] for r in engine.execute(
            "select node_id, state from system.nodes")}
        assert nodes.get("statw2", nodes.get(w3.uri)) in ("joining",
                                                          "active")
        deadline = time.time() + 10
        while time.time() < deadline and handle.state != "active":
            time.sleep(0.1)
        assert handle.state == "active"
        assert coord.execute(sql) == want
        assert coord.last_distribution["nshards"] == len(workers) + 1
        assert coord.join_worker(w3.uri) is handle  # idempotent
        assert len(coord.workers) == len(workers) + 1
    finally:
        coord.workers[:] = [w for w in coord.workers if w.uri != w3.uri]
        w3.stop()


# -- held against presto_tpu -------------------------------------------------


@pytest.fixture()
def fresh_ledgers(monkeypatch):
    """Empty divergence ledgers in both packages, so each records and
    reads only this test's queries."""
    monkeypatch.setattr(REF_QS, "DIVERGENCE", REF_QS.DivergenceLedger())
    monkeypatch.setattr(QS, "DIVERGENCE", QS.DivergenceLedger())


DIVERGENCE_QUERIES = {
    "filter_agg": "select l_returnflag, count(*) from lineitem "
                  "where l_quantity < 10 group by l_returnflag",
    "q06": QUERIES["q06"],
    "ndv": "select o_orderpriority, count(*) from orders "
           "group by o_orderpriority",
    "q03": QUERIES["q03"],
    "q05": Q5,
}


def _ledger_rows(records) -> collections.Counter:
    return collections.Counter(
        (r["node_type"], r["table"], r["est_rows"], r["actual_rows"])
        for r in records)


@pytest.mark.parametrize("name", sorted(DIVERGENCE_QUERIES))
def test_divergence_ledger_agrees_with_the_reference(name, tpch_tiny,
                                                     torch_tpch,
                                                     fresh_ledgers):
    """After the same query on each package's single engine, the two
    ledgers hold the same (node, table, estimated rows, actual rows)
    records, in DIVERGENCE.records() and in system.plan_divergence, and
    the same observed selectivities and NDVs."""
    sql = DIVERGENCE_QUERIES[name]
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    port = Engine(device="cpu")
    port.register_catalog("tpch", torch_tpch)
    assert port.execute(sql) == ref.execute(sql)
    want = _ledger_rows(REF_QS.DIVERGENCE.records())
    assert want
    assert _ledger_rows(QS.DIVERGENCE.records()) == want
    cols = "node_type, table_name, est_rows, actual_rows"
    got_sql = port.execute(f"select {cols} from system.plan_divergence")
    want_sql = ref.execute(f"select {cols} from system.plan_divergence")
    assert collections.Counter(map(tuple, got_sql)) == \
        collections.Counter(map(tuple, want_sql))
    assert QS.DIVERGENCE._selectivity == REF_QS.DIVERGENCE._selectivity
    assert QS.DIVERGENCE._ndv == REF_QS.DIVERGENCE._ndv


_POISON_KEY = ("tpch.customer", "eq(c_mktsegment, ?)")


@pytest.mark.parametrize("qname", ["q03", "q10", "q18"])
def test_row_estimates_after_poisoned_ledger_equal(qname, tpch_tiny,
                                                   torch_tpch,
                                                   fresh_ledgers):
    """The cost model reads the ledger in both packages: after the same
    poisoned observation, each plan node's row estimate is equal (and
    the poison moved it)."""
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    port = Engine(device="cpu")
    port.register_catalog("tpch", torch_tpch)
    sql = QUERIES[qname]

    def estimates():
        from presto_tpu.exec.executor import preorder_index as ref_order
        from presto_tpu_torch.exec.executor import preorder_index
        rp, _ = ref.plan_sql(sql)
        pp, _ = port.plan_sql(sql)
        ro, po = ref_order(rp), preorder_index(pp)
        return ({ro[k]: v for k, v in ref_row_estimates(rp, ref).items()
                 if k in ro},
                {po[k]: v for k, v in row_estimates(pp, port).items()
                 if k in po})

    clean_ref, clean_port = estimates()
    assert clean_port == clean_ref
    for ledger in (REF_QS.DIVERGENCE, QS.DIVERGENCE):
        for _ in range(400):
            ledger.observe_selectivity(*_POISON_KEY, 1500, 1)
    poisoned_ref, poisoned_port = estimates()
    assert poisoned_port == poisoned_ref
    if qname == "q03":  # filters c_mktsegment = 'BUILDING'
        assert poisoned_port != clean_port


def test_forget_selectivity_drops_one_key():
    """A forgotten (table, shape) reads as never observed, until it is
    observed again; the other keys keep their readings."""
    ledger = QS.DivergenceLedger()
    other = ("tpch.orders", "lt(o_orderdate, ?)")
    ledger.observe_selectivity(*_POISON_KEY, 1500, 1)
    ledger.observe_selectivity(*other, 10, 5)
    ledger.forget_selectivity(*_POISON_KEY)
    assert ledger.observed_selectivity(*_POISON_KEY) is None
    assert ledger.observed_selectivity(*other) == 0.5
    ledger.observe_selectivity(*_POISON_KEY, 10, 2)
    assert ledger.observed_selectivity(*_POISON_KEY) == 0.2


def _stage_rows(rows) -> collections.Counter:
    """(stage, shard, input rows, output rows) of a query's worker
    tasks, the stage name without the query id."""
    return collections.Counter(
        (stage, shard, inp, out) for stage, shard, inp, out in rows)


@pytest.fixture(scope="module")
def both_clusters(torch_tpch, tpch_tiny):
    """The same query on a 2-worker cluster of each package; the
    system.tasks and operator_stats rows of each."""
    from presto_tpu.parallel.coordinator import (
        ClusterCoordinator as RefCoordinator)
    from presto_tpu.parallel.worker import WorkerServer as RefWorker

    sql = ("select o_orderpriority, count(*) as c from orders, lineitem "
           "where o_orderkey = l_orderkey group by o_orderpriority "
           "order by o_orderpriority")
    out = {}
    for pkg in ("port", "ref"):
        workers, coord = [], None
        try:
            if pkg == "port":
                workers = [WorkerServer({"tpch": torch_tpch},
                                        device="cpu").start()
                           for _ in range(2)]
                engine = Engine(device="cpu")
                engine.register_catalog("tpch", torch_tpch)
                coord = ClusterCoordinator(engine).start()
            else:
                workers = [RefWorker({"tpch": tpch_tiny}).start()
                           for _ in range(2)]
                engine = RefEngine()
                engine.register_catalog("tpch", tpch_tiny)
                coord = RefCoordinator(engine).start()
            for w in workers:
                coord.add_worker(w.uri)
            rows = coord.execute(sql)
            qid = engine.events.history[-1].query_id
            out[pkg] = {
                "rows": rows, "dist": dict(coord.last_distribution),
                "tasks": engine.execute(
                    "select stage, shard, input_rows, output_rows "
                    f"from system.tasks where query_id = '{qid}'"),
                "ops": engine.execute(
                    "select stage, node_type, label, output_rows "
                    f"from system.operator_stats where query_id = '{qid}'"
                    " and stage <> 'coordinator'")}
        finally:
            if coord is not None:
                coord.stop()
            for w in workers:
                w.stop()
    return out


def test_cluster_tasks_agree_with_the_reference(both_clusters):
    port, ref = both_clusters["port"], both_clusters["ref"]
    assert port["rows"] == ref["rows"]
    assert port["dist"]["stages"] == ref["dist"]["stages"]
    assert _stage_rows(port["tasks"]) == _stage_rows(ref["tasks"])


def test_cluster_operator_stats_agree_with_the_reference(both_clusters):
    port, ref = both_clusters["port"], both_clusters["ref"]
    got = collections.Counter(map(tuple, port["ops"]))
    want = collections.Counter(map(tuple, ref["ops"]))
    assert got == want


# -- the device cache under concurrent uploads -------------------------------


def test_device_array_thread_safe_under_eviction():
    """8 threads upload one shared array and 64 distinct ones into one
    engine whose dev_cache_limit forces eviction: no exception, the
    byte ledger equals the resident arrays' bytes, one copy per key."""
    e = Engine(device="cpu")
    shared = np.arange(4096, dtype=np.int64)
    distinct = [np.full(1024, i, dtype=np.int64) for i in range(64)]
    e.dev_cache_limit = 16 * distinct[0].nbytes
    errors: list = []
    start = threading.Barrier(8)

    def work(k):
        try:
            start.wait()
            for i in range(200):
                got = e.device_array(shared)
                assert torch.equal(got, torch.from_numpy(shared))
                a = distinct[(k * 7 + i) % 64]
                assert int(e.device_array(a)[0]) == int(a[0])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    with e._dev_cache_lock:
        entries = dict(e._dev_cache)
        ledger = e._dev_cache_bytes
    assert ledger == sum(np.asarray(a).nbytes for a, _ in entries.values())
    assert ledger <= e.dev_cache_limit
    keys = [id(a) for a, _ in entries.values()]
    assert len(keys) == len(set(keys)) == len(entries)
    assert all(k == id(a) for k, (a, _) in entries.items())


def test_stats_tree_served_by_the_coordinator_server(stats_cluster):
    """The server case of tests/test_runtime_stats.py: a Q5 submitted
    to a CoordinatorServer over the cluster is served, under its
    protocol query id, by GET /v1/query/{id} with the whole tree, and
    its rows are the reference's."""
    import time
    import urllib.request

    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server import CoordinatorServer

    coord, _workers, engine, want = stats_cluster
    srv = CoordinatorServer(engine, cluster=coord).start()
    try:
        c = Client(f"http://127.0.0.1:{srv.port}", user="tester")
        qid, _ = c.submit(Q5)
        for _ in range(1200):
            if c.query_state(qid) not in ("QUEUED", "RUNNING"):
                break
            time.sleep(0.1)
        assert c.query_state(qid) == "FINISHED"
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/query/{qid}",
            headers={"X-Trino-User": "tester"})
        with urllib.request.urlopen(req, timeout=10) as r:
            info = json.loads(r.read())
        qs = info["queryStats"]
        assert qs["state"] == "FINISHED"
        stages = {st["stage"]: st for st in qs["stages"]}
        assert len([n for n in stages if n != "coordinator"]) >= 2
        assert qs["outputRows"] == stages["coordinator"]["outputRows"] \
            == len(want)
        _cols, rows = c.execute(Q5)
        assert [tuple(r) for r in rows] == [
            (n, str(v)) for n, v in want]
    finally:
        srv.stop()
