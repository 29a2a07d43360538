"""The port's concurrent-serving robustness suite, mirroring
tests/test_concurrent_serving.py on CPU engines and CPU workers (the
pool units are in tests/test_torch_memory_pool.py).

A real HTTP coordinator in front of a 3-worker cluster takes 8 mixed
TPC-H queries AT ONCE while seeded chaos (worker crashes) and a
query-level memory squeeze are active: every query must end in
byte-identical rows or a loud CLASSIFIED error (CLUSTER_OUT_OF_MEMORY /
EXCEEDED_TIME_LIMIT / QUERY_QUEUE_FULL / ...), with zero hangs, zero
residual pool reservations, and zero leaked non-daemon threads.

Also covered, deterministically:
- cluster memory governance: blocking admission + the low-memory
  killer choosing the largest reservation (memory.MemoryPool);
- query lifetime discipline: query_max_queued_time /
  query_max_planning_time / query_max_run_time, the last verified by
  WORKER-side task-state assertions (the reaper DELETEs in-flight
  fragment tasks, not just the client error);
- overload backpressure: coordinator queue-full -> HTTP 429
  QUERY_QUEUE_FULL + Retry-After, worker task-queue cap -> 503
  classified transient;
- concurrent-session isolation: per-client SET SESSION overrides must
  not bleed across simultaneously-executing queries.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from presto_tpu_torch import BIGINT
from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.client import Client, QueryFailed
from presto_tpu_torch.connectors.blackhole import BlackholeConnector
from presto_tpu_torch.ft import retry as FTR
from presto_tpu_torch.ft.faults import FAULTS
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
from presto_tpu_torch.parallel.worker import WorkerServer as TorchWorker
from presto_tpu_torch.server import CoordinatorServer
from presto_tpu_torch.server.resource_groups import GroupSpec

_TIMEOUTS = REGISTRY.counter("presto_tpu_query_timeout_total")
_SHED = REGISTRY.counter("presto_tpu_query_shed_total")

# the loud, classified failure modes a query may end in
CLASSIFIED = ("CLUSTER_OUT_OF_MEMORY", "EXCEEDED_MEMORY_LIMIT",
              "EXCEEDED_TIME_LIMIT", "QUERY_QUEUE_FULL",
              "QUERY_REJECTED", "GENERIC_INTERNAL_ERROR")

# 8 concurrent queries, 3 distinct shapes (aggregate, join, point):
# repeated shapes share compiled programs, so the test exercises
# concurrency, not compile throughput
Q_AGG = ("select l_returnflag, count(*) as c, sum(l_quantity) as q "
         "from lineitem group by l_returnflag order by l_returnflag")
Q_JOIN = ("select o_orderpriority, count(*) as c from orders, lineitem "
          "where o_orderkey = l_orderkey group by o_orderpriority "
          "order by o_orderpriority")
Q_SMALL = ("select n_regionkey, count(*) as c from nation "
           "group by n_regionkey order by n_regionkey")
MIX = [Q_AGG, Q_JOIN, Q_SMALL, Q_AGG, Q_JOIN, Q_SMALL, Q_AGG, Q_JOIN]


def Engine(**kw):  # noqa: N802 - the reference tests' name
    return TorchEngine(device="cpu", **kw)


def WorkerServer(*args, **kw):  # noqa: N802
    return TorchWorker(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def tpch_tiny():
    """The port's SF0.01 connector (byte-identical to the reference's)."""
    from presto_tpu_torch.connectors.tpch import TpchConnector
    return TpchConnector(scale=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
def serving_cluster(tpch_tiny, tmp_path_factory, _thread_leak_guard):
    """HTTP coordinator + 3 workers sharing a spool, TASK retries."""
    spool = str(tmp_path_factory.mktemp("serve_spool"))
    workers = [
        WorkerServer({"tpch": tpch_tiny}, node_id=f"sw{i}",
                     spool_dir=spool).start()
        for i in range(3)]
    engine = Engine()
    engine.register_catalog("tpch", tpch_tiny)
    engine.session.set("retry_policy", "TASK")
    coord = ClusterCoordinator(engine, heartbeat_interval_s=0.2).start()
    for w in workers:
        coord.add_worker(w.uri)
    srv = CoordinatorServer(engine, cluster=coord).start()
    yield srv, coord, workers, engine
    srv.stop()
    coord.stop()
    for w in workers:
        try:
            w.stop()
        except Exception:  # noqa: BLE001
            pass


@pytest.fixture(scope="module")
def expected(serving_cluster):
    """Fault-free protocol-form rows per distinct query shape,
    through the REAL server — the chaos run's byte-identical oracle
    (this also compiles every shape before chaos starts, so the load
    test measures serving, not XLA)."""
    srv, _coord, _workers, _engine = serving_cluster
    c = Client(f"http://127.0.0.1:{srv.port}", user="oracle")
    return {sql: c.execute(sql)[1] for sql in set(MIX)}


# -- lifetime discipline ----------------------------------------------------


def test_query_max_planning_time_fails_loudly(tpch_tiny):
    from presto_tpu_torch.exec.cancel import QueryCanceled
    e = Engine()
    e.register_catalog("tpch", tpch_tiny)
    e.session.set("query_max_planning_time", 1e-9)
    with pytest.raises(QueryCanceled, match="query_max_planning_time"):
        e.execute("select count(*) from nation")
    e.session.set("query_max_planning_time", 0.0)
    assert e.execute("select count(*) from nation")[0][0] == 25


def _slow_server(delay_s: float, groups=None, query_memory_bytes=None):
    """Coordinator over a blackhole catalog whose scans stall, for
    deterministic in-flight states."""
    engine = Engine()
    bh = BlackholeConnector(rows_per_table=10,
                            page_processing_delay_s=delay_s)
    bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
    engine.register_catalog("bh", bh)
    srv = CoordinatorServer(engine, resource_groups=groups,
                            query_memory_bytes=query_memory_bytes
                            ).start()
    return srv, engine


def test_query_max_queued_time_reaps_queued_query():
    srv, _engine = _slow_server(
        8.0, groups=[GroupSpec("tiny", hard_concurrency_limit=1,
                               max_queued=4)])
    try:
        base = _TIMEOUTS.value(kind="queued")
        c = Client(f"http://127.0.0.1:{srv.port}", user="u")
        qid1, _ = c.submit("select count(*) from bh.slow")
        for _ in range(100):
            if c.query_state(qid1) == "RUNNING":
                break
            time.sleep(0.05)
        c.session_properties["query_max_queued_time"] = 0.4
        with pytest.raises(QueryFailed) as exc:
            c.execute("select count(*) from bh.slow")
        assert "query_max_queued_time" in str(exc.value)
        assert exc.value.error_name == "EXCEEDED_TIME_LIMIT"
        assert _TIMEOUTS.value(kind="queued") == base + 1
        c.cancel(qid1)
    finally:
        srv.stop()


def test_query_max_run_time_reaped_with_worker_tasks_cancelled(
        serving_cluster):
    """A query over its run-time budget is
    failed by the reaper AND its in-flight worker fragment tasks are
    cancelled — asserted on the WORKERS' task state, not just the
    client error."""
    srv, _coord, workers, _engine = serving_cluster
    # consumers stall pulling exchange pages, so the query is reliably
    # mid-flight (buffers + task state live on workers) when the
    # reaper fires
    FAULTS.arm("exchange-fetch-delay", prob=1.0, delay_s=3.0)
    base = _TIMEOUTS.value(kind="run")
    c = Client(f"http://127.0.0.1:{srv.port}", user="u")
    c.session_properties["query_max_run_time"] = 1.0
    qid, _ = c.submit(Q_JOIN)
    t0 = time.monotonic()
    state = None
    while time.monotonic() - t0 < 20:
        state = c.query_state(qid)
        if state not in ("QUEUED", "RUNNING"):
            break
        time.sleep(0.1)
    # the protocol fails the query promptly (the client stops waiting
    # long before in-flight worker POSTs drain)
    assert state == "FAILED"
    assert time.monotonic() - t0 < 10
    assert _TIMEOUTS.value(kind="run") == base + 1
    info = srv.manager.get(qid)
    assert info.error_name == "EXCEEDED_TIME_LIMIT"
    assert "query_max_run_time" in info.error
    # worker-side: every task of this query (ids are prefixed with the
    # protocol query id) is deleted — buffers dropped, state cleared
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        left = [tid for w in workers
                for tid in list(w.buffers) + list(w.task_state)
                if tid.startswith(qid)]
        if not left:
            break
        time.sleep(0.2)
    assert not left, f"worker tasks survived the reap: {left}"
    FAULTS.clear()


# -- overload backpressure --------------------------------------------------


def test_queue_full_is_fast_429_with_retry_after():
    srv, _engine = _slow_server(
        6.0, groups=[GroupSpec("tiny", hard_concurrency_limit=1,
                               max_queued=0)])
    try:
        base = _SHED.value(site="coordinator-queue-full")
        c = Client(f"http://127.0.0.1:{srv.port}", user="u")
        qid1, _ = c.submit("select count(*) from bh.slow")
        for _ in range(100):
            if c.query_state(qid1) == "RUNNING":
                break
            time.sleep(0.05)
        # the raw protocol answer: HTTP 429 + Retry-After, errorName
        # QUERY_QUEUE_FULL (shed BEFORE any planning/device work)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/statement",
            data=b"select count(*) from bh.slow", method="POST",
            headers={"X-Trino-User": "u"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 429
        assert exc.value.headers.get("Retry-After")
        body = json.loads(exc.value.read())
        assert body["error"]["errorName"] == "QUERY_QUEUE_FULL"
        assert _SHED.value(site="coordinator-queue-full") == base + 1
        # and through the client library: classified QueryFailed
        with pytest.raises(QueryFailed) as qf:
            c.execute("select 1")
        assert qf.value.error_name == "QUERY_QUEUE_FULL"
        c.cancel(qid1)
    finally:
        srv.stop()


def test_worker_task_queue_cap_sheds_with_503(tpch_tiny):
    """The reference holds the first task's slot with the compile-slow
    fault; the port compiles nothing, so a blackhole scan that stalls
    holds it instead."""
    bh = BlackholeConnector(rows_per_table=10,
                            page_processing_delay_s=2.0)
    bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
    w = WorkerServer({"bh": bh}, node_id="capw", max_tasks=1).start()
    try:
        from presto_tpu_torch.plan.serde import fragment_to_dict
        local = Engine()
        local.register_catalog("bh", bh)
        plan, _ = local.plan_sql("select count(*) as c from bh.slow",
                                 enable_latemat=False)
        payload = json.dumps({
            "fragment": fragment_to_dict(plan), "task_id": "cap.t.0",
            "shard": 0, "nshards": 1}).encode()

        errs: list = []

        def post_one():
            req = urllib.request.Request(
                f"{w.uri}/v1/task", data=payload, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    resp.read()
            except urllib.error.HTTPError as e:
                errs.append(e)

        t1 = threading.Thread(target=post_one, daemon=True)
        t1.start()
        time.sleep(0.5)  # the first task is inside its slow scan
        post_one()
        t1.join(timeout=30)
        assert len(errs) == 1, "second POST should have been shed"
        shed = errs[0]
        assert shed.code == 503
        assert shed.headers.get("Retry-After")
        assert "queue is full" in json.loads(shed.read())["error"]
        # classified transient: the retry layers rotate workers
        assert FTR.is_transient(shed)
    finally:
        FAULTS.clear()
        w.stop()


# -- concurrent-session isolation -------------------------------------------


def test_concurrent_session_overrides_do_not_bleed(serving_cluster):
    srv, _coord, _workers, engine = serving_cluster
    base = f"http://127.0.0.1:{srv.port}"
    stop = time.monotonic() + 3.0
    failures: list = []

    def show_value(client) -> str:
        _cols, rows = client.execute("show session")
        return next(r[1] for r in rows
                    if r[0] == "broadcast_join_threshold_rows")

    def with_override():
        c = Client(base, user="alice")
        c.execute("set session broadcast_join_threshold_rows = 7")
        while time.monotonic() < stop:
            v = show_value(c)
            if v != "7":
                failures.append(("alice", v))
                return

    def without_override():
        c = Client(base, user="bob")
        default = str(1 << 20)
        while time.monotonic() < stop:
            v = show_value(c)
            if v != default:
                failures.append(("bob", v))
                return

    threads = [threading.Thread(target=with_override, daemon=True),
               threading.Thread(target=without_override, daemon=True),
               threading.Thread(target=with_override, daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not failures, failures
    # the shared engine session was never polluted by any override
    assert "broadcast_join_threshold_rows" not in \
        engine.session.properties


def test_failed_manager_construction_leaks_no_reaper():
    """A constructor that rejects its config (group allowance > 256)
    must not leave a live reaper thread sweeping a half-built
    manager forever."""
    from presto_tpu_torch.server.server import QueryManager
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(ValueError, match="256"):
        QueryManager(Engine(), resource_groups=[
            GroupSpec("big", hard_concurrency_limit=300)])
    leaked = {t.name for t in threading.enumerate()} - before
    assert not any("reaper" in n for n in leaked), leaked


def test_admission_planning_aborts_on_killed_token(tpch_tiny):
    """The reaper's kill must abort the admission-time planning pass
    at its first planning seam — with a query pool configured this IS
    the query's only planning, and a reaped/abandoned query must not
    plan to completion first."""
    from presto_tpu_torch.exec.cancel import CancelToken, TimeLimitExceeded
    from presto_tpu_torch.server.server import QueryInfo, QueryManager
    e = Engine()
    e.register_catalog("tpch", tpch_tiny)
    mgr = QueryManager(e, query_memory_bytes=1 << 30)
    try:
        q = QueryInfo("q1", "select count(*) from lineitem", "u")
        q.cancel_token = CancelToken()
        q.cancel_token.kill(TimeLimitExceeded(
            "query exceeded query_max_run_time (reaped)"))
        with pytest.raises(TimeLimitExceeded):
            with mgr._admission(q, {}):
                raise AssertionError("admission should have aborted")
        assert mgr.query_pool.reserved == 0
    finally:
        mgr.close()


# -- the chaos run ----------------------------------------------------------


def test_chaos_under_load_eight_concurrent_queries(serving_cluster,
                                                   expected):
    """8 mixed queries at once + seeded worker crashes + a query-pool
    memory squeeze: every query ends byte-identical or loudly
    classified; no hangs, no leaked reservations."""
    srv, _coord, _workers, engine = serving_cluster
    manager = srv.manager
    # memory squeeze: the query pool fits ~2 admission charges at
    # once, so concurrent queries BLOCK at admission and drain through
    # (sized from the real estimate so the test tracks the estimator)
    from presto_tpu_torch.memory import estimate_plan_memory
    plan, _ = engine.plan_sql(Q_JOIN)
    est, _pn = estimate_plan_memory(plan, engine)
    manager.query_pool.capacity = int(est * 2.5)
    engine.session.set("memory_reserve_timeout_s", 60.0)
    # the squeeze must drain through BLOCKING admission, not the
    # killer: with the default 5s killer delay the number of kills
    # depends on host speed (a loaded 2-vCPU box blocks queries past
    # the delay and kills a timing-dependent subset, flaking the
    # progress assertion below). The killer has its own deterministic
    # tests; here it stays out of reach.
    engine.session.set("low_memory_killer_delay_s", 300.0)
    # crash a third of sw1's task POSTs: TASK retries must absorb them
    FAULTS.arm("worker-task-crash", prob=0.34, seed=11, match="sw1")
    results: dict = {}

    def drive(i: int) -> None:
        c = Client(f"http://127.0.0.1:{srv.port}", user=f"load{i}")
        try:
            _cols, rows = c.execute(MIX[i], poll_interval=0.05)
            results[i] = ("ok", rows)
        except QueryFailed as e:
            results[i] = ("failed", e)
        except Exception as e:  # noqa: BLE001 - hang/protocol break
            results[i] = ("broken", e)

    try:
        threads = [threading.Thread(target=drive, args=(i,),
                                    daemon=True)
                   for i in range(len(MIX))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert all(not t.is_alive() for t in threads), "queries hung"
        assert len(results) == len(MIX)
        ok = 0
        for i, (kind, payload) in sorted(results.items()):
            if kind == "ok":
                # byte-identical to the fault-free protocol rows:
                # chaos recovery must never corrupt another query's
                # results
                assert payload == expected[MIX[i]], \
                    f"query {i} rows diverged"
                ok += 1
            elif kind == "failed":
                assert payload.error_name in CLASSIFIED, payload
            else:
                raise AssertionError(f"query {i} broke the protocol: "
                                     f"{payload!r}")
        # the crash-absorbing retry layer should carry most queries
        # home
        assert ok >= len(MIX) // 2, results
        FAULTS.clear()

        # zero residual reservations once every query settled
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if (manager.query_pool.reserved == 0
                    and engine.memory_pool.reserved == 0):
                break
            time.sleep(0.2)
        assert manager.query_pool.reserved == 0
        assert manager.query_pool.by_tag == {}
        assert engine.memory_pool.reserved == 0
    finally:
        manager.query_pool.capacity = 0
        engine.session.set("memory_reserve_timeout_s", 0.0)
        engine.session.set("low_memory_killer_delay_s", 5.0)


def test_memory_killer_end_to_end_kills_running_query():
    """Two queries against a tiny query pool: the second blocks at
    admission, the killer kills the first (largest reservation) with a
    loud CLUSTER_OUT_OF_MEMORY, and the blocked one completes."""
    srv, engine = _slow_server(3.0, query_memory_bytes=1)
    try:
        manager = srv.manager
        engine.session.set("memory_reserve_timeout_s", 30.0)
        engine.session.set("low_memory_killer_delay_s", 0.5)
        from presto_tpu_torch.memory import estimate_plan_memory
        plan, _ = engine.plan_sql("select count(*) from bh.slow")
        est, _pn = estimate_plan_memory(plan, engine)
        # fits one slow-scan admission, not two
        manager.query_pool.capacity = max(int(est * 1.5), 2)

        c1 = Client(f"http://127.0.0.1:{srv.port}", user="victim")
        qid1, _ = c1.submit("select count(*) from bh.slow")
        for _ in range(200):
            if manager.query_pool.reserved > 0:
                break
            time.sleep(0.05)
        assert manager.query_pool.reserved > 0

        c2 = Client(f"http://127.0.0.1:{srv.port}", user="survivor")
        _cols, rows = c2.execute("select count(*) from bh.slow")
        assert rows == [[10]]  # the blocked query made progress

        for _ in range(200):
            if c1.query_state(qid1) == "FAILED":
                break
            time.sleep(0.05)
        assert c1.query_state(qid1) == "FAILED"
        q1 = manager.get(qid1)
        assert q1.error_name == "CLUSTER_OUT_OF_MEMORY"
        assert "low-memory killer" in q1.error
        assert "pool 'query'" in q1.error  # diagnostics to the client
        assert manager.query_pool.reserved == 0
    finally:
        srv.stop()


