"""The port's tenant-scale serving (presto_tpu_torch/server/serving.py +
exec/batch.py), mirroring tests/test_serving.py on an
``Engine(device="cpu")``.

Covers the three serving rungs end to end through the real HTTP
protocol:

- result cache: identical re-issued SELECTs are protocol-layer hits
  (``cacheHit`` marker), an UPDATE between them invalidates through
  the connector-version SPI and the re-issue returns the NEW rows;
- invalidation chaos: concurrent hits racing a writer only ever see a
  result byte-identical to one of the two serial oracles;
- cross-query batching: concurrent template variants under
  ``batch_window_ms`` stack into one vmapped dispatch, byte-identical
  to serial execution;
- subplan dedup: concurrent identical queries await one in-flight
  execution;
- observability: ``system.result_cache`` and the serving counters.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

from presto_tpu_torch import types as T
from presto_tpu_torch.client import Client
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.engine import Engine as TorchEngine
from presto_tpu_torch.server import serving as SV
from presto_tpu_torch.server.server import CoordinatorServer


def Engine(**kw):  # noqa: N802 - the reference tests' name
    return TorchEngine(device="cpu", **kw)


def _info(base: str, qid: str) -> dict:
    req = urllib.request.Request(base + f"/v1/query/{qid}",
                                 headers={"X-Trino-User": "u"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def _last_infos(base: str, sql: str) -> list[dict]:
    req = urllib.request.Request(base + "/v1/query",
                                 headers={"X-Trino-User": "u"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        qs = json.loads(resp.read())
    return [_info(base, q["queryId"]) for q in qs
            if q["query"] == sql]


@pytest.fixture()
def serving_server():
    engine = Engine()
    mem = MemoryConnector()
    engine.register_catalog("mem", mem)
    mem.create_table(
        "t", {"x": T.BIGINT, "g": T.BIGINT},
        {"x": np.array([10, 20, 30, 40], dtype=np.int64),
         "g": np.array([0, 1, 0, 1], dtype=np.int64)},
        {"x": None, "g": None})
    srv = CoordinatorServer(engine).start()
    yield engine, mem, srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


def test_repeated_select_is_cache_hit(serving_server):
    _engine, _mem, _srv, base = serving_server
    c = Client(base, user="u")
    sql = "select x from mem.t order by x"
    first = c.execute(sql)
    second = c.execute(sql)
    assert first == second
    infos = _last_infos(base, sql)
    assert [i["cacheHit"] for i in infos] == [False, True]


def test_update_between_identical_selects_invalidates(serving_server):
    _engine, _mem, _srv, base = serving_server
    c = Client(base, user="u")
    sql = "select x from mem.t order by x"
    assert c.execute(sql)[1] == [[10], [20], [30], [40]]
    assert c.execute(sql)[1] == [[10], [20], [30], [40]]
    c.execute("update mem.t set x = 99 where x = 20")
    # the write bumped mem.t's version: the re-issue must MISS and
    # return the post-write rows, never the cached pre-write ones
    cols, rows = c.execute(sql)
    assert rows == [[10], [30], [40], [99]]
    infos = _last_infos(base, sql)
    assert infos[2]["cacheHit"] is False
    # and the fresh result is cached again
    assert c.execute(sql)[1] == rows
    assert _last_infos(base, sql)[3]["cacheHit"] is True


def test_invalidation_chaos_stays_byte_identical(serving_server):
    """Concurrent hits racing a writer: every result equals one of
    the two serial oracles (pre- or post-update), never a mix."""
    _engine, _mem, _srv, base = serving_server
    sql = "select x from mem.t order by x"
    pre = [[10], [20], [30], [40]]
    post = [[10], [30], [40], [77]]
    results: list = []
    errors: list = []

    def reader(i: int) -> None:
        c = Client(base, user="u")
        try:
            for _ in range(30):
                results.append(c.execute(sql)[1])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    def writer() -> None:
        c = Client(base, user="u")
        try:
            c.execute("update mem.t set x = 77 where x = 20")
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=reader, args=(i,))
               for i in range(4)] + [threading.Thread(target=writer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for rows in results:
        assert rows in (pre, post)
    # after the dust settles the post-write rows are what's served
    assert Client(base, user="u").execute(sql)[1] == post


def test_scan_after_an_update_sees_it_before_the_sweep():
    """A scan that sees a table's new version sees its new contents,
    even before the write's statement has swept the device cache (the
    window a concurrent reader of the chaos test above can hit): an
    update replaces the arrays it writes instead of writing into the
    ones a device copy is keyed by."""
    engine = Engine()
    mem = MemoryConnector()
    engine.register_catalog("mem", mem)
    mem.create_table("t", {"x": T.BIGINT},
                     {"x": np.array([10, 20, 30, 40], dtype=np.int64)},
                     {"x": None})
    sql = "select x from mem.t order by x"
    assert engine.execute(sql) == [(10,), (20,), (30,), (40,)]
    version = mem.table_version("t")
    # the connector's write, before the statement's device-cache sweep
    mem.update_rows("t", {"x": np.full(4, 77, dtype=np.int64)}, None,
                    np.array([False, True, False, False]))
    assert mem.table_version("t") == version + 1
    assert engine.execute(sql) == [(10,), (30,), (40,), (77,)]


def test_result_cache_toggle_off(serving_server):
    _engine, _mem, _srv, base = serving_server
    c = Client(base, user="u")
    c.session_properties = {"result_cache": False,
                            "subplan_dedup": False}
    sql = "select g, count(*) as c from mem.t group by g order by g"
    assert c.execute(sql) == c.execute(sql)
    infos = _last_infos(base, sql)
    assert [i["cacheHit"] for i in infos] == [False, False]


def test_system_result_cache_table(serving_server):
    _engine, _mem, _srv, base = serving_server
    c = Client(base, user="u")
    c.execute("select x from mem.t order by x")
    c.execute("select x from mem.t order by x")
    cols, rows = c.execute("select * from system.result_cache")
    assert [col["name"] for col in cols] == [
        "fingerprint", "tables", "rows", "bytes", "hits", "age_ms"]
    assert len(rows) == 1
    assert rows[0][1] == "mem.t@1"
    assert rows[0][2] == 4  # live rows cached
    assert rows[0][4] >= 1  # hits


def test_subplan_dedup_concurrent_identical(serving_server):
    _engine, _mem, _srv, base = serving_server
    sql = ("select g, sum(x) as s from mem.t "
           "group by g order by g")
    barrier = threading.Barrier(6)
    results: list = []

    def run(i: int) -> None:
        c = Client(base, user="u")
        # cache off isolates the DEDUP rung: every query must either
        # lead the one execution or await it
        c.session_properties = {"result_cache": False}
        barrier.wait()
        results.append(c.execute(sql)[1])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    want = [[0, 40], [1, 60]]
    assert all(r == want for r in results)
    infos = _last_infos(base, sql)
    assert any(i["deduped"] for i in infos)


def _serial_and_concurrent(base: str, literals: list) -> tuple:
    """The serial oracle (a serving-disabled session), then the same
    literal variants as concurrent clients inside one batch window:
    (oracle, got, errors)."""
    oracle = {}
    c0 = Client(base, user="u")
    c0.session_properties = {"result_cache": False,
                             "subplan_dedup": False}
    for v in literals:
        oracle[v] = c0.execute(
            f"select count(*) as c from mem.t where x > {v}")[1]
    barrier = threading.Barrier(len(literals))
    got: dict = {}
    errors: list = []

    def run(v: int) -> None:
        c = Client(base, user="u")
        c.session_properties = {"result_cache": False,
                                "subplan_dedup": False,
                                "batch_window_ms": 150.0}
        barrier.wait()
        try:
            got[v] = c.execute(
                f"select count(*) as c from mem.t where x > {v}")[1]
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(v,))
               for v in literals]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return oracle, got, errors


def test_cross_query_batching_byte_identical(serving_server):
    """Concurrent literal variants under batch_window_ms stack into
    one vmapped dispatch; each client's rows must be byte-identical
    to its own serial execution, and no batch falls back to serial
    runs."""
    _engine, _mem, _srv, base = serving_server
    literals = [5, 15, 25, 35]
    fallbacks = SV.BATCH_FALLBACKS.total()
    oracle, got, errors = _serial_and_concurrent(base, literals)
    assert not errors
    assert got == oracle
    assert SV.BATCH_FALLBACKS.total() == fallbacks
    # at least one group formed: the batched marker carries its size
    sql_of = {v: f"select count(*) as c from mem.t where x > {v}"
              for v in literals}
    batched = [
        info["batched"]
        for v in literals
        for info in _last_infos(base, sql_of[v])]
    assert any(b > 1 for b in batched)


def test_batch_failure_falls_back_counted(serving_server, monkeypatch):
    """A batched run that raises (a lane rule failing, say) leaves every
    member to its serial run, as the reference's serving layer does,
    and is counted by exception type, so that it shows."""
    _engine, _mem, _srv, base = serving_server

    def broken(engine, templates):
        raise RuntimeError("lane rule failed")

    monkeypatch.setattr(SV.B, "run_plan_batched", broken)
    before = SV.BATCH_FALLBACKS.value(error="RuntimeError")
    literals = [6, 16, 26, 36]
    oracle, got, errors = _serial_and_concurrent(base, literals)
    assert not errors
    assert got == oracle
    assert SV.BATCH_FALLBACKS.value(error="RuntimeError") > before
    for v in literals:
        sql = f"select count(*) as c from mem.t where x > {v}"
        assert all(not i["batched"] for i in _last_infos(base, sql))


def test_serving_metrics_exposed(serving_server):
    _engine, _mem, _srv, base = serving_server
    c = Client(base, user="u")
    c.execute("select x from mem.t order by x")
    c.execute("select x from mem.t order by x")
    with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
        text = resp.read().decode()
    for name in ("presto_tpu_result_cache_hits_total",
                 "presto_tpu_result_cache_misses_total",
                 "presto_tpu_result_cache_invalidations_total",
                 "presto_tpu_batched_queries_total",
                 "presto_tpu_batch_size_queries",
                 "presto_tpu_batch_fallbacks_total",
                 "presto_tpu_deduped_queries_total"):
        assert name in text


def test_tpch_variant_batch_through_the_server():
    """Concurrent Q5 region variants (a VARCHAR and two date
    parameters) under batch_window_ms stack into one vmapped pass on
    the server: every client's rows equal its serial run, at least one
    query is marked batched, and the batched-queries counter rises."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.obs.metrics import REGISTRY

    engine = Engine()
    engine.register_catalog("tpch", TpchConnector(scale=0.01))
    srv = CoordinatorServer(engine).start()
    base = f"http://127.0.0.1:{srv.port}"
    sqls = CS.batch_variants("q05", 0.01, 4)
    try:
        serial = Client(base, user="u")
        serial.session_properties = {"result_cache": False,
                                     "subplan_dedup": False}
        oracle = {s: serial.execute(s)[1] for s in sqls}
        counter = REGISTRY.counter("presto_tpu_batched_queries_total")
        before = counter.value()
        fallbacks = SV.BATCH_FALLBACKS.total()
        barrier = threading.Barrier(len(sqls))
        got: dict = {}

        def run(sql: str) -> None:
            c = Client(base, user="u")
            c.session_properties = {"result_cache": False,
                                    "subplan_dedup": False,
                                    "batch_window_ms": 300.0}
            barrier.wait()
            got[sql] = c.execute(sql)[1]

        threads = [threading.Thread(target=run, args=(s,)) for s in sqls]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == oracle
        batched = [i["batched"] for s in sqls for i in _last_infos(base, s)]
        assert any(b > 1 for b in batched)
        assert counter.value() - before == sum(b > 1 for b in batched)
        assert SV.BATCH_FALLBACKS.total() == fallbacks
    finally:
        srv.stop()


def test_chip_smoke_serving_cases_on_the_cpu(monkeypatch):
    """Phase 11 of chip_smoke.py (SV1-SV5) at SF0.01 with every engine
    on the CPU (its card calls stubbed): the 22 TPC-H queries through
    dbapi in both result formats equal one engine's rows, the result
    cache hit and its invalidation, the dedup of 8 Q5s, the six batch
    groups of 8 (each lane equal to its serial run on both backends,
    the batched counter up by 8 a group) and the pool cases. The launch
    counts need the card: here they stay empty."""
    import sys
    from pathlib import Path

    import torch

    import presto_tpu_torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    from presto_tpu_torch.connectors.tpch import TpchConnector

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    class CpuEngine(TorchEngine):
        def __init__(self, *args, device=None, **kw):
            super().__init__(*args, device="cpu", **kw)

    monkeypatch.setattr(presto_tpu_torch, "Engine", CpuEngine)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        conn = TpchConnector(scale=0.01)
        one = Engine()
        one.register_catalog("tpch", conn)
        local = {q: one.execute(sql) for q, sql in CS.TPCH.items()}
        out = CS.serving_cases(conn, conn, local)
    finally:
        torch.set_num_threads(threads)
    assert set(out["groups"]) == set(CS.BATCH_KERNELS)
    assert all(g["lanes"] == 8 and g["launches"] == {}
               for g in out["groups"].values())
    assert set(out["launches"]) == set(CS.KERNELS)
    assert not any(out["launches"].values())
    assert set(out["SV1"]) == {"cold", "timed", "arrow"}
