"""The port's runtime memory pool (presto_tpu_torch/memory.py
``MemoryPool``, ``MemoryKilledError``), on the CPU: the pool cases of
tests/test_memory.py (each program reserves its measured input and
output tensor bytes and frees them; a capacity is enforced; the
largest tag is the killer's victim), the pool units of
tests/test_concurrent_serving.py (blocking reserve, a loud deadline,
the low-memory killer), the worker's pool under
``PRESTO_TPU_WORKER_MEMORY_BYTES``, and the port's reservation sites
(segments, spill partitions, EXPLAIN ANALYZE, a batch) against the
reference's ledger on the same queries."""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import pytest
import torch

from presto_tpu import Engine as RefEngine

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import templates as TPL
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.exec import batch as B
from presto_tpu_torch.memory import (MemoryKilledError, MemoryLimitExceeded,
                                     MemoryPool)
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.parallel.worker import WorkerServer

from tpch_queries import QUERIES

_KILLED = REGISTRY.counter("presto_tpu_query_killed_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def torch_tpch():
    return TorchTpch(scale=0.01)


@pytest.fixture()
def eng(torch_tpch):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    return e


def test_runtime_pool_tracks_reservations(eng):
    pool = eng.memory_pool
    assert pool.reserved == 0
    eng.execute("select count(*) from lineitem")
    assert pool.reserved == 0  # released after materialization
    li_bytes = sum(
        c.data.nbytes
        for c in eng.catalogs["tpch"].table("lineitem").columns.values())
    # the peak covers at least the scanned column's input bytes
    assert pool.peak >= li_bytes // 20
    assert pool.by_tag == {}


def test_runtime_pool_capacity_enforced(eng):
    eng.memory_pool.capacity = 1024  # absurdly small
    with pytest.raises(MemoryLimitExceeded):
        eng.execute("select count(*) from lineitem")
    assert eng.memory_pool.reserved == 0  # failed query fully released


def test_pool_largest_tag_victim_choice():
    p = MemoryPool()
    p.reserve("small", 100)
    p.reserve("big", 10_000)
    assert p.largest_tag() == ("big", 10_000)


def test_peak_counts_the_program_tensors_like_the_reference(eng,
                                                           tpch_tiny):
    """On Q6 (one program) the port's peak reservation is its scanned
    columns' bytes plus its output's; the reference reserves the same
    host input arrays plus its output arrays."""
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    ref.execute(QUERIES["q06"])
    eng.execute(QUERIES["q06"])
    cols = ("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    li = eng.catalogs["tpch"].table("lineitem").columns
    inputs = sum(li[c].data.nbytes for c in cols)
    assert inputs <= eng.memory_pool.peak <= inputs + 1024
    assert inputs <= ref.memory_pool.peak <= inputs + 1024


@pytest.mark.parametrize("sql", [
    QUERIES["q05"],  # a MultiJoin: one program at SF0.01
    QUERIES["q09"],  # segmented: carriers reserved under a seg- tag
    "explain analyze " + QUERIES["q09"]])
def test_every_route_frees_its_reservations(eng, sql):
    eng.execute(sql)
    assert eng.memory_pool.reserved == 0
    assert eng.memory_pool.by_tag == {}
    assert eng.memory_pool.peak > 0


def test_spill_partitions_reserve_and_free(eng):
    eng.session.set("query_max_memory_bytes", 400_000)
    rows = eng.execute("select l_orderkey, count(*) from lineitem "
                       "group by l_orderkey order by l_orderkey limit 3")
    assert eng.last_spill is not None and len(rows) == 3
    assert eng.memory_pool.reserved == 0 and eng.memory_pool.peak > 0


def test_a_batch_reserves_its_scans(eng):
    sqls = [QUERIES["q06"].replace("0.05 and 0.07", f"0.0{d} and 0.0{d + 2}")
            for d in (1, 3)]
    tpls = [TPL.parameterize(eng.plan_sql(s)[0]) for s in sqls]
    eng.memory_pool.capacity = 1024
    with pytest.raises(MemoryLimitExceeded):
        B.run_plan_batched(eng, tpls)
    eng.memory_pool.capacity = 0
    B.run_plan_batched(eng, tpls)
    assert eng.memory_pool.reserved == 0 and eng.memory_pool.peak > 0


# -- the pool units of tests/test_concurrent_serving.py ---------------------


class _Token:
    def __init__(self):
        self.killed: BaseException | None = None

    def kill(self, exc):
        self.killed = exc


def test_pool_blocking_reserve_unblocks_on_free():
    pool = MemoryPool(1000, name="unit")
    pool.reserve("a", 900)
    done = []

    def blocked():
        pool.reserve("b", 500, block_s=10.0)
        done.append(True)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not done  # blocked, not failed: the governance contract
    pool.free("a")
    t.join(timeout=5)
    assert done and pool.reserved == 500
    pool.free("b")
    assert pool.reserved == 0 and pool.by_tag == {}


def test_pool_blocking_reserve_deadline_is_loud():
    pool = MemoryPool(100, name="unit2")
    pool.reserve("holder", 90)
    t0 = time.monotonic()
    with pytest.raises(MemoryLimitExceeded) as exc:
        pool.reserve("late", 50, block_s=0.3)
    assert 0.25 <= time.monotonic() - t0 < 5
    assert "after blocking" in str(exc.value)
    assert "pool 'unit2'" in str(exc.value)  # diagnostics ride along
    pool.free("holder")


def test_low_memory_killer_kills_largest_reservation():
    pool = MemoryPool(1000, name="unit3")
    big, small = _Token(), _Token()
    pool.reserve("small", 100, owner=small)
    pool.reserve("big", 800, owner=big)
    base = _KILLED.value(pool="unit3")
    victim_reserve: list = []

    def release_when_killed():
        deadline = time.monotonic() + 10
        while big.killed is None and time.monotonic() < deadline:
            time.sleep(0.02)
        try:
            pool.reserve("big", 1, block_s=0.0)
            victim_reserve.append("no-raise")
        except MemoryKilledError:
            victim_reserve.append("raised")
        pool.free("big")

    t = threading.Thread(target=release_when_killed, daemon=True)
    t.start()
    pool.reserve("waiter", 500, block_s=10.0, kill_after_s=0.2)
    t.join(timeout=5)
    assert isinstance(big.killed, MemoryKilledError)
    assert "largest" in str(big.killed)
    assert "pool 'unit3'" in str(big.killed)
    assert small.killed is None
    assert victim_reserve == ["raised"]
    assert _KILLED.value(pool="unit3") == base + 1
    pool.free("waiter")
    pool.free("small")
    assert pool.reserved == 0


def test_killed_query_in_the_engine_fails_loudly(eng):
    """A query whose runtime reservation blocks is killed when it holds
    the largest reservation: the engine raises MemoryKilledError."""
    pool = eng.memory_pool
    pool.capacity = 10_000_000
    pool.reserve("holder", 9_999_000)
    eng.session.set("memory_reserve_timeout_s", 5.0)
    eng.session.set("low_memory_killer_delay_s", 0.1)
    try:
        # the holder is the largest: it is killed, never freed here,
        # so the query's own reserve keeps waiting and then fails
        with pytest.raises(MemoryLimitExceeded):
            eng.execute("select count(*) from lineitem")
        assert "holder" in pool.info()["killedQueries"]
    finally:
        pool.free("holder")
        pool.capacity = 0
    assert pool.reserved == 0


def test_worker_pool_capped_by_environment(torch_tpch, monkeypatch):
    monkeypatch.setenv("PRESTO_TPU_WORKER_MEMORY_BYTES", "2048")
    w = WorkerServer({"tpch": torch_tpch}, device="cpu").start()
    try:
        req = urllib.request.Request(
            f"{w.uri}/v1/task",
            data=json.dumps({"sql": "select count(*) from lineitem",
                             "shard": 0, "nshards": 1}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=60)
        assert "MemoryLimitExceeded" in json.loads(exc.value.read())["error"]
        with urllib.request.urlopen(f"{w.uri}/metrics", timeout=10) as r:
            assert "presto_tpu_memory_reserved_bytes" in r.read().decode()
        with urllib.request.urlopen(f"{w.uri}/v1/status", timeout=10) as r:
            assert json.loads(r.read())["memory"]["reservedBytes"] == 0
    finally:
        w.stop()
