"""The port's multi-host control plane (presto_tpu_torch/parallel/
coordinator.py, worker.py): a ClusterCoordinator over WorkerServers on
device="cpu" at TPC-H SF0.01, the counterparts of tests/test_cluster.py.
Every query's rows are held against the reference's single
presto_tpu.Engine over the same data (float sums within the oracle's
tolerance) and against the port's own local engine; the distribution
asserts are the reference's. Then WorkerServer's explicit device: no
device means CUDA and raises here, and PRESTO_TPU_WORKER_MEMORY_BYTES
names the memory pool the port does not have yet."""

import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu_torch.testing.oracle import rows_equal

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.parallel import auth as A
from presto_tpu_torch.parallel.coordinator import (ClusterCoordinator,
                                                   NoWorkersError,
                                                   TaskError)
from presto_tpu_torch.parallel.worker import WorkerServer

from tpch_queries import QUERIES as TPCH

QUERIES = [
    ("select count(*) from lineitem", None),
    ("select l_returnflag, l_linestatus, sum(l_quantity) as q, "
     "count(*) as c, avg(l_extendedprice) as a, min(l_discount) as mn, "
     "max(l_tax) as mx from lineitem "
     "where l_shipdate <= date '1998-09-02' "
     "group by l_returnflag, l_linestatus "
     "order by l_returnflag, l_linestatus", None),
    ("select l_shipmode, sum(l_extendedprice * (1 - l_discount)) as rev "
     "from lineitem group by l_shipmode order by rev desc limit 3",
     None),
    # checksum/approx_distinct states cross the wire
    ("select l_returnflag, checksum(l_partkey) as ck, "
     "approx_distinct(l_suppkey) as ad from lineitem "
     "group by l_returnflag order by l_returnflag", None),
]


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


def check(got, want, sql):
    ok, msg = rows_equal(got, want, ordered="order by" in sql.lower())
    assert ok, msg


@pytest.fixture(scope="module")
def cluster(torch_tpch):
    workers, coord = [], None
    try:
        workers = [WorkerServer({"tpch": torch_tpch}, node_id=f"w{i}",
                                device="cpu").start()
                   for i in range(3)]
        local = Engine(device="cpu")
        local.register_catalog("tpch", torch_tpch)
        coord = ClusterCoordinator(local, heartbeat_interval_s=0.2).start()
        for w in workers:
            coord.add_worker(w.uri)
        yield coord, workers, local
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - stopped by a test
                pass


@pytest.mark.parametrize("sql,_x", QUERIES)
def test_cluster_matches_local(sql, _x, cluster, ref):
    coord, _workers, local = cluster
    got = coord.execute(sql)
    assert got == local.execute(sql)
    check(got, ref.execute(sql), sql)
    assert coord.last_distribution is not None
    assert coord.last_distribution["nshards"] == len(
        coord.live_workers())


def test_join_distributes_as_fragments(cluster, ref):
    coord, _workers, local = cluster
    sql = ("select o_orderpriority, count(*) as c from orders, lineitem "
           "where o_orderkey = l_orderkey group by o_orderpriority "
           "order by o_orderpriority")
    got = coord.execute(sql)
    assert got == local.execute(sql) == ref.execute(sql)
    assert coord.last_distribution is not None
    assert coord.last_distribution["mode"] == "fragments"
    assert coord.last_distribution["nshards"] == len(
        coord.live_workers())


def test_multi_join_distributes(cluster, ref):
    """TPC-H Q3 shape: two joins on different keys."""
    coord, _workers, local = cluster
    sql = ("select o_orderdate, o_shippriority, "
           "sum(l_extendedprice * (1 - l_discount)) as revenue "
           "from customer, orders, lineitem "
           "where c_mktsegment = 'BUILDING' "
           "and c_custkey = o_custkey and l_orderkey = o_orderkey "
           "and o_orderdate < date '1995-03-15' "
           "and l_shipdate > date '1995-03-15' "
           "group by o_orderdate, o_shippriority "
           "order by revenue desc, o_orderdate limit 10")
    got = coord.execute(sql)
    assert got == local.execute(sql)
    check(got, ref.execute(sql), sql)
    assert coord.last_distribution is not None
    assert coord.last_distribution["mode"] == "fragments"
    assert coord.last_distribution["stages"] >= 3


def test_join_no_aggregate_distributes(cluster, ref):
    """Raw join rows return over the binary wire (no partial agg)."""
    coord, _workers, local = cluster
    sql = ("select o_orderkey, o_orderdate, l_quantity from orders, "
           "lineitem where o_orderkey = l_orderkey "
           "and o_totalprice > 500000 order by o_orderkey, l_quantity "
           "limit 20")
    got = coord.execute(sql)
    assert got == local.execute(sql)
    check(got, ref.execute(sql), sql)
    assert coord.last_distribution["mode"] == "fragments"


@pytest.mark.parametrize("name", ["q03", "q05", "q08", "q09"])
def test_general_fragmenter_distributes_tpch(name, cluster, ref):
    """Arbitrary join-tree plans distribute as stage DAGs; with
    require_distribution set, a local fallback is an error."""
    coord, _workers, local = cluster
    local.session.set("require_distribution", True)
    try:
        got = coord.execute(TPCH[name])
    finally:
        local.session.set("require_distribution", False)
    assert got == local.execute(TPCH[name])
    check(got, ref.execute(TPCH[name]), TPCH[name])
    assert coord.last_distribution["mode"] == "fragments"
    assert coord.last_distribution["stages"] >= 2


def test_general_fragmenter_partitioned_mode(cluster, ref):
    """join_distribution_type=partitioned forces FIXED_HASH stage cuts."""
    coord, _workers, local = cluster
    local.session.set("join_distribution_type", "partitioned")
    try:
        got = coord.execute(TPCH["q03"])
        want = local.execute(TPCH["q03"])
    finally:
        local.session.set("join_distribution_type", "automatic")
    assert got == want
    check(got, ref.execute(TPCH["q03"]), TPCH["q03"])
    assert coord.last_distribution["mode"] == "fragments"
    assert coord.last_distribution["stages"] >= 4


def test_require_distribution_fails_loudly(cluster):
    coord, _workers, local = cluster
    local.session.set("require_distribution", True)
    try:
        with pytest.raises(NoWorkersError):
            coord.execute(
                "select o_orderkey, row_number() over (order by "
                "o_orderkey) from orders limit 5")
    finally:
        local.session.set("require_distribution", False)


def test_window_distributes(cluster, ref):
    """Window functions over a non-empty PARTITION BY distribute."""
    coord, _workers, local = cluster
    sql = ("select o_custkey, o_orderkey, "
           "sum(o_totalprice) over (partition by o_custkey "
           "order by o_orderkey) as running, "
           "rank() over (partition by o_custkey "
           "order by o_totalprice desc) as rk "
           "from orders where o_custkey < 200 "
           "order by o_custkey, o_orderkey")
    local.session.set("require_distribution", True)
    try:
        got = coord.execute(sql)
    finally:
        local.session.set("require_distribution", False)
    assert got == local.execute(sql)
    check(got, ref.execute(sql), sql)
    assert coord.last_distribution["mode"] == "fragments"


def test_distinct_aggregate_distributes(cluster, ref):
    coord, _workers, local = cluster
    sql = ("select o_custkey, count(distinct o_orderpriority) as c, "
           "sum(o_totalprice) as s from orders "
           "where o_custkey < 300 group by o_custkey "
           "order by o_custkey")
    local.session.set("require_distribution", True)
    try:
        got = coord.execute(sql)
    finally:
        local.session.set("require_distribution", False)
    assert got == local.execute(sql)
    check(got, ref.execute(sql), sql)


def test_full_join_distributes(cluster, ref):
    coord, _workers, local = cluster
    sql = ("select count(*) as n, count(c_custkey) as nc, "
           "count(o_orderkey) as no from customer "
           "full join orders on c_custkey = o_custkey")
    local.session.set("require_distribution", True)
    local.session.set("join_distribution_type", "partitioned")
    try:
        got = coord.execute(sql)
    finally:
        local.session.set("require_distribution", False)
        local.session.set("join_distribution_type", "automatic")
    assert got == local.execute(sql) == ref.execute(sql)


def test_worker_failure_detected_and_split_retried(cluster, ref):
    """Runs after the cluster's other cases: it stops a worker."""
    coord, workers, local = cluster
    sql = ("select l_returnflag, count(*) as c from lineitem "
           "group by l_returnflag order by l_returnflag")
    want = local.execute(sql)
    assert want == ref.execute(sql)
    # kill a worker WITHOUT telling the coordinator: the in-flight
    # dispatch must fail over to the survivors
    workers[1].stop()
    assert coord.execute(sql) == want
    deadline = time.time() + 10
    while time.time() < deadline:
        if len(coord.live_workers()) == 2:
            break
        time.sleep(0.2)
    assert len(coord.live_workers()) == 2
    assert coord.execute(sql) == want
    assert coord.last_distribution["nshards"] == 2


def test_worker_rpc_authentication(torch_tpch):
    """Unauthenticated task POSTs and buffer fetches are rejected; an
    authed request runs."""
    secret = "test-internal-secret"
    w = WorkerServer({"tpch": torch_tpch}, node_id="authed",
                     shared_secret=secret, device="cpu").start()
    try:
        req = urllib.request.Request(
            f"{w.uri}/v1/task",
            data=json.dumps({"sql": "select 1", "shard": 0,
                             "nshards": 1}).encode(),
            method="POST",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 401
        req2 = urllib.request.Request(
            f"{w.uri}/v1/task/x/results/0",
            headers={A.HEADER: "123.deadbeef"})
        with pytest.raises(urllib.error.HTTPError) as exc2:
            urllib.request.urlopen(req2, timeout=10)
        assert exc2.value.code == 401
        with urllib.request.urlopen(f"{w.uri}/v1/status",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["state"] == "active"
        req3 = urllib.request.Request(
            f"{w.uri}/v1/task",
            data=json.dumps({"sql": "select count(*) from lineitem",
                             "shard": 0, "nshards": 1}).encode(),
            method="POST",
            headers={"Content-Type": "application/json",
                     A.HEADER: A.make_token(secret)})
        with urllib.request.urlopen(req3, timeout=120) as resp:
            out = json.loads(resp.read())
        assert "error" not in out
        assert out["columns"][0]["values"] == [
            torch_tpch.table("lineitem").nrows]
        assert not A.check_token(secret, A.make_token(
            secret, now=time.time() - 3600))
    finally:
        w.stop()


def test_worker_death_failover_and_loud_failure(torch_tpch, ref):
    """A worker killed mid-query triggers one stage-DAG retry on the
    survivors; with every worker dead the query fails, and
    allow_local_fallback opts back into the local rerun."""
    cats = {"tpch": torch_tpch}
    workers, coord = [], None
    local = Engine(device="cpu")
    local.register_catalog("tpch", torch_tpch)
    local.session.catalog = "tpch"
    local.session.set("join_distribution_type", "partitioned")
    sql = ("select c_mktsegment, count(*) from customer, orders "
           "where c_custkey = o_custkey group by c_mktsegment "
           "order by c_mktsegment")
    try:
        workers = [WorkerServer(cats, device="cpu").start()
                   for _ in range(3)]
        coord = ClusterCoordinator(local)
        for w in workers:
            coord.add_worker(w.uri)
        coord.start()
        want = local.execute(sql)
        assert want == ref.execute(sql)
        assert coord.execute(sql) == want
        workers[2].stop()
        assert coord.execute(sql) == want
        for w in workers[:2]:
            w.stop()
        with pytest.raises((NoWorkersError, TaskError, OSError)):
            coord.execute(sql)
        local.session.set("allow_local_fallback", True)
        assert coord.execute(sql) == want
    finally:
        local.session.set("allow_local_fallback", False)
        if coord is not None:
            coord.stop()
        for w in workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001 - stopped above
                pass


# -- the port's explicit device ---------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="without CUDA only")
def test_worker_without_device_needs_cuda(torch_tpch):
    """WorkerServer() with no device builds its engines on CUDA, as
    Engine() does: without CUDA it raises at construction."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorkerServer({"tpch": torch_tpch})


def test_worker_memory_cap_names_the_missing_pool(torch_tpch, monkeypatch):
    """PRESTO_TPU_WORKER_MEMORY_BYTES caps each worker engine's
    MemoryPool, as in the reference: a task runs under the cap, its
    reservations are freed, and /v1/status reports the pool's bytes."""
    monkeypatch.setenv("PRESTO_TPU_WORKER_MEMORY_BYTES", str(1 << 30))
    w = WorkerServer({"tpch": torch_tpch}, device="cpu").start()
    try:
        req = urllib.request.Request(
            f"{w.uri}/v1/task",
            data=json.dumps({"sql": "select count(*) from lineitem",
                             "shard": 0, "nshards": 1}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        engines = list(w._engines.values())
        assert [e.memory_pool.capacity for e in engines] == [1 << 30]
        info = engines[0].memory_pool.info()
        assert info["reservedBytes"] == 0 and info["peakBytes"] > 0
        with urllib.request.urlopen(f"{w.uri}/v1/status",
                                    timeout=10) as resp:
            status = json.loads(resp.read())
        assert status["memory"] == {"reservedBytes": 0,
                                    "peakBytes": info["peakBytes"]}
    finally:
        w.stop()
