"""Cross-worker trace propagation in the port: a ClusterCoordinator and
two HTTP workers on device="cpu" run a fragmented query; the query's
Chrome trace holds worker-side spans parented under the coordinator's
task-dispatch spans (the X-Presto-TPU-Trace header did the linking),
and each worker's /metrics serves nonzero task counters. The
counterparts of tests/test_trace_cluster.py: most run the query
through ClusterCoordinator.execute inside a trace the test opens (the
server's part), so the query span is its child; the last submits it
to the port's CoordinatorServer over the cluster, as the reference's
do, and reads the trace at /v1/query/{id}/trace. Rows are held against
presto_tpu's single engine."""

from __future__ import annotations

import json
import uuid
import urllib.request

import pytest
import torch

from presto_tpu import Engine as RefEngine

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
from presto_tpu_torch.parallel.worker import WorkerServer

FRAGMENTED_SQL = (
    "select o_orderpriority, count(*) as c from orders, lineitem "
    "where o_orderkey = l_orderkey group by o_orderpriority "
    "order by o_orderpriority")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def traced_cluster(tpch_tiny):
    conn = TpchConnector(scale=0.01)
    workers, coord = [], None
    try:
        workers = [
            WorkerServer({"tpch": conn}, node_id=f"tracew{i}",
                         device="cpu").start()
            for i in range(2)]
        engine = Engine(device="cpu")
        engine.register_catalog("tpch", conn)
        engine.session.catalog = "tpch"
        coord = ClusterCoordinator(engine, heartbeat_interval_s=0.2).start()
        for w in workers:
            coord.add_worker(w.uri)
        ref = RefEngine()
        ref.register_catalog("tpch", tpch_tiny)
        yield coord, workers, engine, ref.execute(FRAGMENTED_SQL)
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass


def _run(coord, want) -> str:
    """Run the fragmented query in a fresh trace; its rows must be the
    reference's. Returns the trace id."""
    tid = f"trace-{uuid.uuid4().hex[:12]}"
    with OT.TRACER.trace(tid, "client-query"):
        assert coord.execute(FRAGMENTED_SQL) == want
    return tid


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def test_distributed_query_trace_links_worker_spans(traced_cluster):
    coord, workers, engine, want = traced_cluster
    qid = _run(coord, want)
    assert coord.last_distribution is not None
    assert coord.last_distribution["mode"] == "fragments"

    trace = OT.TRACER.chrome_trace(qid)
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in events}
    assert {"query", "plan", "task-dispatch", "worker-task"} <= names

    dispatch_ids = {e["args"]["span_id"] for e in events
                    if e["name"] == "task-dispatch"}
    worker_spans = [e for e in events if e["name"] == "worker-task"]
    assert worker_spans, "no worker-side spans in the trace"
    for w in worker_spans:
        assert w["args"]["parent_id"] in dispatch_ids
    worker_nodes = {pe["args"]["name"]
                    for pe in trace["traceEvents"]
                    if pe["ph"] == "M" and pe["name"] == "process_name"}
    assert {"tracew0", "tracew1"} <= worker_nodes
    by_id = {e["args"]["span_id"]: e for e in events}
    roots = [e for e in events if "parent_id" not in e["args"]]
    assert [r["name"] for r in roots] == ["client-query"]
    root = roots[0]
    for e in events:
        cur, hops = e, 0
        while "parent_id" in cur["args"] and hops < 30:
            cur = by_id[cur["args"]["parent_id"]]
            hops += 1
        assert cur is root


def test_worker_metrics_and_trace_endpoints(traced_cluster):
    coord, workers, engine, want = traced_cluster
    qid = _run(coord, want)
    for w in workers:
        with urllib.request.urlopen(f"{w.uri}/metrics", timeout=10) as r:
            assert "text/plain" in r.headers["Content-Type"]
            text = r.read().decode()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("presto_tpu_worker_tasks_total")
                 and f'node="{w.node_id}"' in ln]
        assert lines, text
        assert sum(float(ln.rsplit(" ", 1)[1]) for ln in lines) > 0
        assert "presto_tpu_worker_cached_engines" in text
    spans = _get_json(f"{workers[0].uri}/v1/trace/{qid}")["spans"]
    assert any(s["name"] == "worker-task" for s in spans)
    assert all(s["trace_id"] == qid for s in spans)


def test_exchange_metrics_count_partitioned_transfer(traced_cluster):
    """A partitioned multi-stage plan moves pages worker-to-worker:
    the exchange serve counters advance."""
    coord, workers, engine, want = traced_cluster
    pages = REGISTRY.counter("presto_tpu_exchange_pages_total")
    before = sum(pages.value(node=w.node_id) for w in workers)
    engine.session.set("join_distribution_type", "partitioned")
    try:
        _run(coord, want)
    finally:
        engine.session.set("join_distribution_type", "automatic")
    after = sum(pages.value(node=w.node_id) for w in workers)
    assert after > before


def test_worker_profile_endpoint_captures_a_task(traced_cluster,
                                                 tmp_path, monkeypatch):
    """The worker's on-demand profiler (obs/devprof): /v1/profile/start,
    a fragmented query whose tasks run on the workers, then
    /v1/profile/stop answer 200; the artifact directory is the one the
    start named, under PRESTO_TPU_PROFILE_DIR, and holds the capture's
    Chrome trace. A second start while live reports the live capture;
    a second stop is a no-op."""
    import os

    from presto_tpu_torch.obs import devprof

    coord, workers, _engine, want = traced_cluster
    monkeypatch.setenv(devprof.ENV_PROFILE_DIR, str(tmp_path))

    def post(path):
        req = urllib.request.Request(f"{workers[0].uri}{path}",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())

    status, res = post("/v1/profile/start")
    assert status == 200 and res["started"] and res["profiling"]
    assert res["dir"].startswith(str(tmp_path))
    again = post("/v1/profile/start")
    assert again == (200, {"profiling": True, "dir": res["dir"],
                           "started": False})
    try:
        _run(coord, want)
    finally:
        status, stopped = post("/v1/profile/stop")
    assert status == 200 and stopped["artifact"] == res["dir"]
    trace = os.path.join(stopped["artifact"], devprof.TRACE_FILE)
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert post("/v1/profile/stop") == (200, {"profiling": False,
                                              "artifact": None})


def test_server_query_trace_links_worker_spans(traced_cluster):
    """The server case of tests/test_trace_cluster.py: a query submitted
    to a CoordinatorServer over the cluster exports, at
    /v1/query/{id}/trace, one tree rooted at its "query" span with the
    workers' spans parented under the coordinator's task dispatches."""
    import time

    from presto_tpu_torch.client import Client
    from presto_tpu_torch.server import CoordinatorServer

    coord, _workers, engine, want = traced_cluster
    srv = CoordinatorServer(engine, cluster=coord).start()
    try:
        c = Client(f"http://127.0.0.1:{srv.port}", user="tester")
        qid, _ = c.submit(FRAGMENTED_SQL)
        for _ in range(1200):
            if c.query_state(qid) not in ("QUEUED", "RUNNING"):
                break
            time.sleep(0.1)
        assert c.query_state(qid) == "FINISHED"
        assert coord.last_distribution["mode"] == "fragments"
        trace = _get_json(
            f"http://127.0.0.1:{srv.port}/v1/query/{qid}/trace")
    finally:
        srv.stop()
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {"query", "plan", "task-dispatch", "worker-task"} <= {
        e["name"] for e in events}
    dispatch_ids = {e["args"]["span_id"] for e in events
                    if e["name"] == "task-dispatch"}
    for w in (e for e in events if e["name"] == "worker-task"):
        assert w["args"]["parent_id"] in dispatch_ids
    by_id = {e["args"]["span_id"]: e for e in events}
    root = next(e for e in events
                if e["name"] == "query" and "parent_id" not in e["args"])
    for e in events:
        cur, hops = e, 0
        while "parent_id" in cur["args"] and hops < 30:
            cur = by_id[cur["args"]["parent_id"]]
            hops += 1
        assert cur is root
