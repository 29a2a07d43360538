"""Fault-tolerant distributed execution of the port (presto_tpu_torch/
ft/, the TASK retry policy of parallel/coordinator.py): the counterparts
of tests/test_fault_tolerance.py over workers on device="cpu", every
query's rows also held against presto_tpu's single engine over the same
SF0.01 data.

Deterministic, seeded chaos: fault points (ft/faults.py) are armed
in-process against a 3-worker cluster sharing a spool directory, and
every recovery the subsystem claims is asserted end-to-end — the
Trino-FTE analog contract:

- a worker crash injected mid-TPC-H-Q5 under ``retry_policy=TASK``
  returns byte-identical results with ZERO full-query restarts, the
  retries visible as ``task-retry`` spans and
  ``presto_tpu_task_retries_total`` in the /metrics registry;
- ``retry_policy=NONE`` on the same seed fails loudly;
- a heartbeat blackout marks the node dead, un-blackout recovers it;
- draining (PUT /v1/info/state SHUTTING_DOWN) rejects new tasks with
  503, finishes in-flight ones, keeps serving buffers, and the
  coordinator stops scheduling to the node;
- the spooled exchange serves a dead producer's pages from a
  surviving worker sharing the spool directory.

Teardown asserts no non-daemon thread leaks (the
HeartbeatFailureDetector.stop() interruptible-join fix).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch

from presto_tpu import Engine as RefEngine
from presto_tpu_torch.testing.oracle import rows_equal

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.ft import retry as FTR
from presto_tpu_torch.ft.faults import FAULTS, FaultRegistry
from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel.coordinator import (ClusterCoordinator,
                                                   NoWorkersError,
                                                   TaskError)
from presto_tpu_torch.parallel.worker import WorkerServer

from tpch_queries import QUERIES

_TASK_RETRIES = REGISTRY.counter("presto_tpu_task_retries_total")
_QUERY_RETRIES = REGISTRY.counter("presto_tpu_query_retries_total")
_FAULTS_FIRED = REGISTRY.counter("presto_tpu_faults_injected_total")
_CALL_RETRIES = REGISTRY.counter("presto_tpu_call_retries_total")
_SPOOLED = REGISTRY.counter("presto_tpu_spooled_pages_total")
_SPOOL_SERVED = REGISTRY.counter("presto_tpu_spool_served_pages_total")


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
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    return e


def check(got, ref, sql):
    ok, msg = rows_equal(got, ref.execute(sql),
                         ordered="order by" in sql.lower())
    assert ok, msg


@pytest.fixture(autouse=True)
def _no_armed_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


@pytest.fixture(scope="module")
def _thread_leak_guard():
    before = {t for t in threading.enumerate() if not t.daemon}
    yield
    leaked = {t for t in threading.enumerate()
              if not t.daemon} - before
    assert not leaked, f"non-daemon threads leaked: {leaked}"


@pytest.fixture(scope="module")
def chaos_cluster(torch_tpch, tmp_path_factory, _thread_leak_guard):
    """3 workers sharing one spool directory + a coordinator engine."""
    spool = str(tmp_path_factory.mktemp("spool"))
    workers, coord = [], None
    try:
        workers = [
            WorkerServer({"tpch": torch_tpch}, node_id=f"w{i}",
                         spool_dir=spool, device="cpu").start()
            for i in range(3)]
        local = Engine(device="cpu")
        local.register_catalog("tpch", torch_tpch)
        coord = ClusterCoordinator(local, heartbeat_interval_s=0.2).start()
        for w in workers:
            coord.add_worker(w.uri)
        yield coord, workers, local, spool
        coord.stop()
        # the detector's interruptible stop must actually join the thread
        assert not any(t.name == "presto-tpu-heartbeat" and t.is_alive()
                       for t in threading.enumerate())
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001
                pass


# -- unit: retry/backoff/deadline discipline --------------------------------


def test_backoff_full_jitter_bounds():
    import random
    b = FTR.BackoffPolicy(attempts=6, initial_delay_s=0.1,
                          max_delay_s=1.0, multiplier=2.0)
    rng = random.Random(0)
    for attempt in range(6):
        cap = min(1.0, 0.1 * 2.0 ** attempt)
        for _ in range(50):
            d = b.delay_s(attempt, rng)
            assert 0.0 <= d <= cap


def test_retrying_call_classification_and_counter():
    base = _CALL_RETRIES.value(op="unit-test")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("blip")
        return "ok"

    out = FTR.retrying_call(flaky, op="unit-test",
                            backoff=FTR.BackoffPolicy(
                                attempts=4, initial_delay_s=0.001,
                                max_delay_s=0.002),
                            sleep=lambda _s: None)
    assert out == "ok" and len(calls) == 3
    assert _CALL_RETRIES.value(op="unit-test") == base + 2

    # application errors never retry
    def app_error():
        calls.append(1)
        raise TaskError("deterministic")

    calls.clear()
    with pytest.raises(TaskError):
        FTR.retrying_call(app_error, op="unit-test",
                          sleep=lambda _s: None)
    assert len(calls) == 1

    # transient HTTP codes are retryable, worker 500s are not
    assert FTR.is_transient(
        urllib.error.HTTPError("u", 503, "unavailable", {}, None))
    assert not FTR.is_transient(
        urllib.error.HTTPError("u", 500, "task failed", {}, None))


def test_deadline_budget_exhaustion():
    d = FTR.Deadline(0.01)
    time.sleep(0.02)
    assert d.expired
    with pytest.raises(FTR.DeadlineExceeded):
        d.check("unit")

    unlimited = FTR.Deadline(0.0)
    assert not unlimited.expired
    assert unlimited.clamp(7.0) == 7.0

    def always_fails():
        raise ConnectionResetError("down")

    with pytest.raises(FTR.DeadlineExceeded):
        FTR.retrying_call(always_fails, op="unit-test",
                          backoff=FTR.BackoffPolicy(attempts=100),
                          deadline=d, sleep=lambda _s: None)


# -- unit: deterministic fault registry -------------------------------------


def test_fault_registry_determinism_and_env():
    reg = FaultRegistry()
    reg.arm("worker-task-crash", prob=0.5, seed=42)
    seq1 = [reg.should_fire("worker-task-crash", key=f"k{i}")
            for i in range(40)]
    reg.arm("worker-task-crash", prob=0.5, seed=42)  # re-arm: reset
    seq2 = [reg.should_fire("worker-task-crash", key=f"k{i}")
            for i in range(40)]
    assert seq1 == seq2
    assert any(seq1) and not all(seq1)  # ~half fire

    # match + limit
    reg.arm("task-post-503", prob=1.0, match="w1", limit=2)
    assert not reg.should_fire("task-post-503", key="w0:t")
    assert reg.should_fire("task-post-503", key="w1:t1")
    assert reg.should_fire("task-post-503", key="w1:t2")
    assert not reg.should_fire("task-post-503", key="w1:t3")  # limit

    # env syntax
    reg2 = FaultRegistry()
    reg2.load_env("heartbeat-blackout:1.0:7:node3:5, compile-slow")
    assert reg2.armed_points() == ["compile-slow",
                                   "heartbeat-blackout"]
    assert not reg2.should_fire("heartbeat-blackout", key="node1")
    assert reg2.should_fire("heartbeat-blackout", key="node3:x")

    with pytest.raises(ValueError):
        reg.arm("not-a-point")


# -- unit: spool + buffer released-page guard -------------------------------


def test_spool_roundtrip_and_buffer_guard(tmp_path):
    from presto_tpu_torch.ft.spool import TaskSpool
    from presto_tpu_torch.parallel.buffer import OutputBuffer, TaskFailed

    spool = TaskSpool(str(tmp_path))
    buf = OutputBuffer(2, capacity_bytes=1 << 20,
                       spool=spool.writer("q.stage.0"))
    buf.add(0, b"page-a", 1)
    buf.add(0, b"page-b", 1)
    buf.add(1, b"page-c", 2)
    buf.set_complete()

    # consumer reads and ACKS pages away from the memory buffer
    assert buf.page(0, 0)[0] == b"page-a"
    assert buf.page(0, 1)[0] == b"page-b"
    buf.page(0, 2)
    # a retried consumer restarting at token 0 must NOT silently get
    # holes — the buffer refuses and the spool serves instead
    with pytest.raises(TaskFailed):
        buf.page(0, 0)
    blob, nxt, complete = spool.page("q.stage.0", 0, 0)
    assert blob == b"page-a" and nxt == 1 and not complete
    blob, nxt, complete = spool.page("q.stage.0", 0, 2)
    assert blob is None and complete
    assert spool.rows("q.stage.0") == [2, 2]

    # a failed attempt's spool is aborted, never served
    buf2 = OutputBuffer(1, capacity_bytes=1 << 20,
                        spool=spool.writer("q.stage.1"))
    buf2.add(0, b"half", 1)
    buf2.fail("injected")
    with pytest.raises(FileNotFoundError):
        spool.page("q.stage.1", 0, 0)

    spool.delete_prefix("q.")
    with pytest.raises(FileNotFoundError):
        spool.page("q.stage.0", 0, 0)


# -- session knobs ----------------------------------------------------------


def test_timeouts_are_session_configurable(chaos_cluster):
    coord, _workers, local, _spool = chaos_cluster
    assert coord._task_timeout() == 300.0  # defaults preserved
    assert coord._ping_timeout() == 2.0
    local.session.set("task_request_timeout_s", 123.0)
    local.session.set("heartbeat_timeout_s", 0.5)
    try:
        assert coord._task_timeout() == 123.0
        assert coord._ping_timeout() == 0.5
        assert coord.detector.timeout_s() == 0.5
    finally:
        local.session.set("task_request_timeout_s", 300.0)
        local.session.set("heartbeat_timeout_s", 2.0)


# -- the acceptance chaos run: TPC-H Q5, crash mid-query --------------------


def test_task_retry_recovers_injected_worker_crash(chaos_cluster, ref):
    """retry_policy=TASK + a crash of every task POST on worker w1:
    byte-identical results to the fault-free run, zero full-query
    restarts, retries visible as spans and counters;
    retry_policy=NONE on the same seed fails loudly."""
    coord, _workers, local, _spool = chaos_cluster
    want = local.execute(QUERIES["q05"])
    check(want, ref, QUERIES["q05"])
    local.session.set("retry_policy", "TASK")
    try:
        # fault-free TASK run: the spooled/sync mode is oracle-correct
        got = coord.execute(QUERIES["q05"])
        assert got == want
        assert coord.last_distribution["retry_policy"] == "TASK"
        assert coord.last_distribution["task_retries"] == 0

        FAULTS.arm("worker-task-crash", prob=1.0, seed=7, match="w1")
        t_base = _TASK_RETRIES.value()
        q_base = _QUERY_RETRIES.value()
        f_base = _FAULTS_FIRED.value(point="worker-task-crash")
        with OT.TRACER.trace("chaos-q5", "chaos-test"):
            got2 = coord.execute(QUERIES["q05"])
        assert got2 == want  # byte-identical recovery
        assert coord.last_distribution["task_retries"] > 0
        assert _TASK_RETRIES.value() > t_base
        assert _QUERY_RETRIES.value() == q_base  # zero full restarts
        assert _FAULTS_FIRED.value(point="worker-task-crash") > f_base
        # retries ride the trace as task-retry spans
        names = {s.name for s in OT.TRACER.spans("chaos-q5")}
        assert "task-retry" in names
        # and the counter is in the /metrics exposition both servers
        # render from this registry
        assert "presto_tpu_task_retries_total" in REGISTRY.render()

        # NONE on the same armed seed: loud failure, no recovery
        local.session.set("retry_policy", "NONE")
        with pytest.raises((NoWorkersError, TaskError, OSError)):
            coord.execute(QUERIES["q05"])
    finally:
        FAULTS.clear()
        local.session.set("retry_policy", "QUERY")


def test_transient_exchange_drops_recover_worker_locally(chaos_cluster,
                                                         ref):
    """Injected exchange-fetch drops retry inside the worker's
    ft.retrying_call wrapper — no coordinator-level retry needed."""
    coord, _workers, local, _spool = chaos_cluster
    sql = ("select o_orderpriority, count(*) as c from orders, "
           "lineitem where o_orderkey = l_orderkey "
           "group by o_orderpriority order by o_orderpriority")
    want = local.execute(sql)
    check(want, ref, sql)
    FAULTS.arm("exchange-fetch-drop", prob=1.0, seed=3, limit=2)
    base = _CALL_RETRIES.value(op="exchange-fetch")
    try:
        assert coord.execute(sql) == want
    finally:
        FAULTS.clear()
    assert _CALL_RETRIES.value(op="exchange-fetch") >= base + 2


# -- heartbeat blackout -----------------------------------------------------


def test_heartbeat_blackout_marks_dead_then_recovers(chaos_cluster):
    coord, workers, _local, _spool = chaos_cluster
    target = workers[2].uri
    FAULTS.arm("heartbeat-blackout", prob=1.0, match=target)
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(coord.live_workers()) == 2:
            break
        time.sleep(0.1)
    assert len(coord.live_workers()) == 2
    assert {w.uri for w in coord.live_workers()} == {
        w.uri for w in coord.workers if w.uri != target}
    # un-blackout: the decayed failure ratio recovers within a few
    # heartbeats
    FAULTS.disarm("heartbeat-blackout")
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(coord.live_workers()) == 3:
            break
        time.sleep(0.1)
    assert len(coord.live_workers()) == 3


# -- graceful drain ---------------------------------------------------------


def _put_state(uri: str, state: str) -> dict:
    req = urllib.request.Request(
        f"{uri}/v1/info/state", data=json.dumps(state).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def test_drain_rejects_new_tasks_but_finishes_in_flight(chaos_cluster):
    from presto_tpu_torch.plan.serde import fragment_to_dict

    coord, workers, local, _spool = chaos_cluster
    w0 = workers[0]
    plan, _ = local.plan_sql(
        "select l_orderkey, l_extendedprice from lineitem",
        enable_latemat=False)
    frag = fragment_to_dict(plan)

    # launch an async (in-flight) task, then drain immediately
    tid = "draintest.stage.0"
    post = urllib.request.Request(
        f"{w0.uri}/v1/task",
        data=json.dumps({"fragment": frag, "task_id": tid,
                         "shard": 0, "nshards": 1, "store": True,
                         "async": True}).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(post, timeout=30) as resp:
            assert json.loads(resp.read())["state"] == "running"
        out = _put_state(w0.uri, "SHUTTING_DOWN")
        assert out["state"] == "shutting_down"

        # new tasks are rejected with 503 (transient for retriers)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(
                f"{w0.uri}/v1/task",
                data=json.dumps({"sql": "select 1", "shard": 0,
                                 "nshards": 1}).encode(),
                method="POST",
                headers={"Content-Type": "application/json"}),
                timeout=10)
        assert exc.value.code == 503

        # the coordinator stops scheduling to the draining node...
        deadline = time.time() + 10
        while time.time() < deadline:
            if len(coord.live_workers()) == 2:
                break
            time.sleep(0.1)
        assert {w.uri for w in coord.live_workers()} == {
            workers[1].uri, workers[2].uri}
        # ...but the node pings healthy (not blacklisted)
        draining = next(w for w in coord.workers if w.uri == w0.uri)
        assert draining.ping(timeout=5)
        assert draining.alive and not draining.schedulable

        # the in-flight task finishes (NOT failed) and its buffer
        # still serves pages through the drain
        deadline = time.time() + 30
        state = {}
        while time.time() < deadline:
            with urllib.request.urlopen(
                    f"{w0.uri}/v1/task/{tid}/status",
                    timeout=10) as resp:
                state = json.loads(resp.read())
            if state.get("state") != "running":
                break
            time.sleep(0.1)
        assert state.get("state") == "finished", state
        with urllib.request.urlopen(
                f"{w0.uri}/v1/task/{tid}/results/0/0/0",
                timeout=10) as resp:
            assert len(resp.read()) > 0

        # queries still succeed on the remaining two workers
        sql = ("select l_returnflag, count(*) as c from lineitem "
               "group by l_returnflag order by l_returnflag")
        assert coord.execute(sql) == local.execute(sql)
        assert coord.last_distribution["nshards"] == 2
    finally:
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{w0.uri}/v1/task/draintest", method="DELETE"),
                timeout=10)
        except Exception:  # noqa: BLE001
            pass
        assert _put_state(w0.uri, "ACTIVE")["state"] == "active"
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(coord.live_workers()) == 3:
            break
        time.sleep(0.1)
    assert len(coord.live_workers()) == 3


# -- spooled exchange: dead producer's pages survive ------------------------


def test_spool_serves_dead_producers_pages(torch_tpch,
                                           tmp_path_factory):
    """A producer task's spooled pages are served by a SURVIVING
    worker sharing the spool directory after the producer dies — the
    repair path TASK retries use instead of recomputing."""
    from presto_tpu_torch.plan.serde import fragment_to_dict
    from presto_tpu_torch.parallel.wire import bytes_to_columns

    spool = str(tmp_path_factory.mktemp("spool2"))
    w1 = WorkerServer({"tpch": torch_tpch}, node_id="p1",
                      spool_dir=spool, device="cpu").start()
    w2 = WorkerServer({"tpch": torch_tpch}, node_id="p2",
                      spool_dir=spool, device="cpu").start()
    local = Engine(device="cpu")
    local.register_catalog("tpch", torch_tpch)
    plan, _ = local.plan_sql(
        "select l_orderkey, l_quantity from lineitem",
        enable_latemat=False)
    tid = "spooltest.scan.0"
    base = _SPOOLED.value()
    served_base = _SPOOL_SERVED.value()
    try:
        post = urllib.request.Request(
            f"{w1.uri}/v1/task",
            data=json.dumps({
                "fragment": fragment_to_dict(plan), "task_id": tid,
                "shard": 0, "nshards": 1, "spool": True,
                "partition": {"nparts": 2,
                              "keys": ["l_orderkey"]}}).encode(),
            method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=60) as resp:
            rows = json.loads(resp.read())["rows"]
        assert sum(rows) > 0
        assert _SPOOLED.value() > base

        w1.stop()  # the producer node dies; its buffers are gone

        pages = []
        token = 0
        while True:
            with urllib.request.urlopen(
                    f"{w2.uri}/v1/task/{tid}/results/0/{token}/0",
                    timeout=10) as resp:
                blob = resp.read()
                nxt = int(resp.headers["X-PrestoTpu-Next-Token"])
                complete = resp.headers["X-PrestoTpu-Complete"] == "1"
            if blob:
                pages.append(blob)
            if nxt == token and complete:
                break
            token = nxt
        got = sum(bytes_to_columns(b)[1] for b in pages)
        assert got == rows[0]  # partition 0, fully recovered
        assert _SPOOL_SERVED.value() > served_base
    finally:
        for w in (w1, w2):
            try:
                w.stop()
            except Exception:  # noqa: BLE001
                pass
