"""The statement surface of the port (presto_tpu_torch/engine.py: SHOW,
SET SESSION, EXPLAIN, CREATE TABLE AS, INSERT, DELETE, UPDATE, DROP
TABLE; connectors/blackhole.py), held against presto_tpu on the SQL of
tests/test_statements.py (all but its mesh test) over the same SF0.01
data: each statement's rows, or its error's type and message, equal
the reference's. Then the device cache: a write drops every device
copy of a host array, and the copies are bounded by dev_cache_limit
(oldest first); the planning-time limit (query_max_planning_time);
DELETE and UPDATE on a table larger than one streamed block."""

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.connectors.memory import MemoryConnector as RefMemory

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch


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
    return TorchTpch(scale=0.01)


@pytest.fixture()
def ref(tpch_tiny):
    e = RefEngine()
    e.register_catalog("tpch", tpch_tiny)
    e.register_catalog("memory", RefMemory())
    return e


@pytest.fixture()
def port(torch_tpch):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    e.register_catalog("memory", MemoryConnector())
    return e


def outcome(engine, sql: str):
    """The rows of ``sql``, or its error's type name and message."""
    try:
        return engine.execute(sql)
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc).__name__, str(exc)


def same(ref, port, sql: str):
    """Run ``sql`` on both engines; their outcomes must be equal."""
    want = outcome(ref, sql)
    got = outcome(port, sql)
    assert got == want, sql
    return got


def test_show_catalogs(ref, port):
    assert same(ref, port, "show catalogs") == [
        ("information_schema",), ("memory",), ("system",), ("tpch",)]


@pytest.mark.parametrize("sql", [
    "show tables",
    "show tables from memory",
    "show columns from nation",
    "show columns from tpch.lineitem",
    "show columns from no_such_table",
])
def test_show_tables_and_columns(ref, port, sql):
    same(ref, port, sql)


def test_show_columns_types(ref, port):
    cols = dict(same(ref, port, "show columns from nation"))
    assert cols["n_nationkey"] == "bigint" and cols["n_name"] == "varchar"


def test_set_show_session(ref, port):
    for e in (ref, port):
        e.execute("set session join_distribution_type = 'BROADCAST'")
    rows = {r[0]: r[1] for r in port.execute("show session")}
    assert rows["join_distribution_type"] == "BROADCAST"


def test_explain(ref, port):
    sql = "explain select count(*) from nation"
    (text,) = same(ref, port, sql)[0]
    assert "Aggregate" in text and "TableScan" in text


def test_explain_analyze(port):
    (text,) = port.execute(
        "explain analyze select count(*) from nation "
        "where n_regionkey = 1")[0]
    assert "rows:" in text and "execute" in text


def test_ctas_insert_drop(ref, port):
    for sql in [
        "create table memory.top_nations as select n_name, n_regionkey "
        "from nation where n_regionkey < 2",
        "select count(*) from memory.top_nations",
        "insert into memory.top_nations select n_name, n_regionkey "
        "from nation where n_regionkey = 2",
        "select n_regionkey, count(*) from memory.top_nations "
        "group by n_regionkey order by n_regionkey",
        "select count(*) from memory.top_nations t, tpch.nation n "
        "where t.n_name = n.n_name",
        "show tables from memory",
        "drop table memory.top_nations",
        "show tables from memory",
        "drop table memory.top_nations",
        "drop table if exists memory.top_nations",
    ]:
        same(ref, port, sql)
    assert port.execute("select count(*) from nation") == [(25,)]


def test_ctas_decimal_roundtrip(ref, port):
    same(ref, port, "create table memory.big_orders as select o_orderkey, "
         "o_totalprice from orders where o_totalprice > 300000")
    a = same(ref, port, "select sum(o_totalprice) from memory.big_orders")
    b = same(ref, port, "select sum(o_totalprice) from orders "
             "where o_totalprice > 300000")
    assert a == b


def test_ctas_preserves_nulls(ref, port):
    same(ref, port, "create table memory.nullable as select n_name, "
         "case when n_nationkey > 10 then n_nationkey end as k from nation")
    assert same(ref, port, "select count(*), count(k) from "
                "memory.nullable") == [(25, 14)]
    assert same(ref, port, "select count(*) from memory.nullable "
                "where k is null") == [(11,)]


def test_multiple_computed_distinct_aggregates(ref, port):
    same(ref, port, "select l_returnflag, count(distinct l_suppkey + 1), "
         "count(distinct l_partkey + 1), count(*), sum(l_quantity) "
         "from lineitem group by l_returnflag order by l_returnflag")


def test_delete_from_memory_table(ref, port):
    for sql in [
        "create table memory.t1 as select o_orderkey, o_totalprice, "
        "o_orderpriority from orders",
        "select count(*) from memory.t1",
        "delete from memory.t1 where o_totalprice > 100000",
        "select count(*) from memory.t1",
        "select count(*) from memory.t1 where o_totalprice > 100000",
        "select o_orderpriority, count(*), sum(o_totalprice) "
        "from memory.t1 group by 1 order by 1",
        "delete from memory.t1",
        "select count(*) from memory.t1",
    ]:
        same(ref, port, sql)


def test_update_memory_table(ref, port):
    for sql in [
        "create table memory.t2 as select o_orderkey, o_totalprice, "
        "o_orderpriority from orders",
        "update memory.t2 set o_orderpriority = 'X-DONE', "
        "o_totalprice = o_totalprice * 2 where o_orderkey < 100",
        "select count(*) from memory.t2 where o_orderpriority = 'X-DONE'",
        "select count(*) from memory.t2 where o_orderkey >= 100 "
        "and o_orderpriority = 'X-DONE'",
        "select count(*) from memory.t2, orders "
        "where memory.t2.o_orderkey = orders.o_orderkey "
        "and memory.t2.o_orderkey < 100 "
        "and memory.t2.o_totalprice <> orders.o_totalprice * 2",
        "select o_orderpriority, count(*), sum(o_totalprice) "
        "from memory.t2 group by 1 order by 1",
        "update memory.t2 set no_such_column = 1",
        "update memory.t2 set o_orderkey = null where o_orderkey < 10",
        "select count(*), count(o_orderkey) from memory.t2",
    ]:
        same(ref, port, sql)


def test_blackhole_connector(ref, port):
    from presto_tpu.connectors.blackhole import \
        BlackholeConnector as RefBlackhole
    from presto_tpu_torch.connectors.blackhole import BlackholeConnector

    holes = RefBlackhole(), BlackholeConnector()
    for e, bh in zip((ref, port), holes):
        e.register_catalog("blackhole", bh)
    same(ref, port, "create table blackhole.sink as "
         "select o_orderkey, o_totalprice from orders")
    assert same(ref, port, "select count(*) from blackhole.sink") == [(0,)]
    for bh in holes:
        bh.set_split_count("sink", 1000)
    assert same(ref, port, "select count(*) from blackhole.sink") == \
        [(1000,)]
    same(ref, port, "insert into blackhole.sink "
         "select o_orderkey, o_totalprice from orders limit 5")
    assert holes[1].rows_written == holes[0].rows_written
    assert holes[1].rows_written["sink"] == 15005


def test_blackhole_stall_observes_cancellation():
    from presto_tpu_torch import BIGINT
    from presto_tpu_torch.connectors.blackhole import BlackholeConnector
    from presto_tpu_torch.exec import cancel as C

    bh = BlackholeConnector(rows_per_table=10, page_processing_delay_s=5.0)
    bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
    e = TorchEngine(device="cpu")
    e.register_catalog("bh", bh)
    token = C.CancelToken()
    token.cancel()
    with pytest.raises(C.QueryCanceled):
        e.execute("select count(*) from bh.slow", cancel_token=token)
    bh.page_processing_delay_s = 0.0
    assert e.execute("select count(*) from bh.slow") == [(10,)]


def test_update_invalidates_device_cache(ref, port):
    for e in (ref, port):
        e.execute("create table memory.dc as select 1 as x union all "
                  "select 2 union all select 3")
        assert sorted(e.execute("select x from memory.dc")) == \
            [(1,), (2,), (3,)]
        assert len(e._dev_cache) > 0  # the SELECT kept its scan arrays
        host = e.catalogs["memory"]._data["dc"]["x"]
        e.execute("update memory.dc set x = 9 where x = 2")
        assert len(e._dev_cache) == 0  # the UPDATE dropped them
        assert sorted(e.execute("select x from memory.dc")) == \
            [(1,), (3,), (9,)]
    # the UPDATE wrote a new array; the repeat uploaded it anew
    new = port.catalogs["memory"]._data["dc"]["x"]
    assert new is not host and port.resident(host) is None
    assert port.resident(new) is not None
    assert port._dev_cache_bytes == new.nbytes


def test_insert_invalidates_device_cache(ref, port):
    for sql in ["create table memory.dc2 as select 1 as x",
                "select x from memory.dc2",
                "insert into memory.dc2 select 5",
                "select x from memory.dc2 order by x"]:
        same(ref, port, sql)
    assert port.execute("select x from memory.dc2 order by x") == \
        [(1,), (5,)]


@pytest.mark.parametrize("kind", ["ctas", "insert", "delete", "update",
                                  "drop", "commit", "rollback"])
def test_every_write_drops_device_copies(port, kind):
    """After each statement that may change table data, no device copy
    of a host array is left, and the invalidation listeners ran."""
    port.execute("create table memory.w as select o_orderkey, "
                 "o_orderpriority from orders")
    calls = []
    port.add_invalidation_listener(lambda: calls.append(1))
    port.execute("select o_orderpriority, count(*) from memory.w "
                 "group by 1")
    assert port._dev_cache and port._dev_cache_bytes > 0
    sql = {"ctas": "create table memory.w2 as select 1 as x",
           "insert": "insert into memory.w select 1, 'x'",
           "delete": "delete from memory.w where o_orderkey < 100",
           "update": "update memory.w set o_orderkey = 0 "
                     "where o_orderkey < 100",
           "drop": "drop table memory.w"}.get(kind)
    if sql is None:
        port.execute("start transaction")
        port.execute("delete from memory.w where o_orderkey < 100")
        port.execute("select count(*) from memory.w")
        assert port._dev_cache
        sql = kind
    port.execute(sql)
    assert port._dev_cache == {} and port._dev_cache_bytes == 0
    assert port._lists_cache == {}
    assert calls


def test_scaled_writers(ref, port):
    import presto_tpu.engine as RE
    import presto_tpu_torch.engine as PE

    same(ref, port, "create table memory.small as select 1 as x")
    assert port.last_write == ref.last_write == \
        {"writer_tasks": 1, "rows": 1}
    old = RE.WRITER_SCALING_CELLS, PE.WRITER_SCALING_CELLS
    RE.WRITER_SCALING_CELLS = PE.WRITER_SCALING_CELLS = 64
    try:
        same(ref, port, "create table memory.big as select l_orderkey, "
             "l_partkey, l_quantity from lineitem")
        assert port.last_write == ref.last_write
        assert port.last_write["writer_tasks"] > 1
    finally:
        RE.WRITER_SCALING_CELLS, PE.WRITER_SCALING_CELLS = old
    assert same(ref, port, "select count(*), sum(l_quantity) from "
                "memory.big") == same(ref, port, "select count(*), "
                                      "sum(l_quantity) from lineitem")


def test_stream_to_sink_pages(monkeypatch):
    """A connector's own sink takes pages of WRITE_PAGE_ROWS rows and
    commits once; a failure aborts it."""
    import presto_tpu_torch.engine as PE
    from presto_tpu_torch.connectors.base import PageSink

    class Sink(PageSink):
        def __init__(self):
            self.pages, self.aborted = [], False

        def append_page(self, data, valid):
            if len(data["x"]) and data["x"][0] < 0:
                raise ValueError("bad page")
            self.pages.append((list(data["x"]), valid["x"]))

        def finish(self):
            return sum(len(p) for p, _ in self.pages)

        def abort(self):
            self.aborted = True

    monkeypatch.setattr(PE, "WRITE_PAGE_ROWS", 4)
    sink = Sink()
    x = np.arange(10)
    assert PE._stream_to_sink(sink, {"x": x}, {"x": None}) == 10
    assert [p for p, _ in sink.pages] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                          [8, 9]]
    empty = Sink()
    assert PE._stream_to_sink(empty, {"x": x[:0]}, {"x": None}) == 0
    assert empty.pages == [([], None)]
    bad = Sink()
    with pytest.raises(ValueError):
        PE._stream_to_sink(bad, {"x": -x}, {"x": None})
    assert bad.aborted


# -- the device cache's bound (P9) ------------------------------------------


def _varchar_table(e):
    """memory.t: a VARCHAR key and a numeric value, 7,999 rows."""
    e.execute("create table memory.t as select o_orderpriority as k, "
              "o_totalprice as v from orders where o_orderkey < 8000")


GROUP_SQL = "select k, sum(v) from memory.t group by k order by k"


def test_varchar_scans_grow_the_cache_as_the_reference(ref, port):
    """A memory table re-encodes its VARCHAR columns at every scan, so
    every run uploads a fresh codes array; under the default limit the
    cache grows by one copy a run, on both engines (the reference also
    keeps its pow2-padded scans' row mask, one copy more)."""
    for e in (ref, port):
        _varchar_table(e)
    sizes = []
    for _ in range(4):
        same(ref, port, GROUP_SQL)
        sizes.append((len(port._dev_cache), len(ref._dev_cache),
                      port._dev_cache_bytes))
    assert [p for p, _, _ in sizes] == [2, 3, 4, 5]
    assert [r - p for p, r, _ in sizes] == [1, 1, 1, 1]
    # the ledger: the numeric column once, a codes array a run
    assert [b for _, _, b in sizes] == [7999 * (8 + 4 * n)
                                        for n in (1, 2, 3, 4)]
    assert port.dev_cache_limit == ref.dev_cache_limit == 8 << 30


def test_dev_cache_limit_bounds_the_copies(ref, port):
    """Above dev_cache_limit the oldest copies go first, on both
    engines; the rows stay right, and the ledger is the host bytes of
    the copies held."""
    for e in (ref, port):
        _varchar_table(e)
        e.dev_cache_limit = 100_000
    first = same(ref, port, GROUP_SQL)
    for _ in range(5):
        assert same(ref, port, GROUP_SQL) == first
        for e in (ref, port):
            assert e._dev_cache_bytes <= e.dev_cache_limit
        assert port._dev_cache_bytes == sum(
            np.asarray(h).nbytes for h, _ in port._dev_cache.values())
        assert 1 <= len(port._dev_cache) <= 3
    # a copy larger than the limit is still kept: the newest
    port.dev_cache_limit = 1
    assert port.execute(GROUP_SQL) == first
    assert len(port._dev_cache) == 1


def test_a_query_leaves_no_scan_input_to_the_cycle_collector(port):
    """A query's scan inputs (its device tensors, a fresh re-encoded
    codes array among them) go when the query ends, not when the cycle
    collector next runs, so a copy the bound lets go is freed at once."""
    import gc
    from presto_tpu_torch.exec.executor import ScanInput

    _varchar_table(port)
    port.dev_cache_limit = 1
    port.execute(GROUP_SQL)
    gc.collect()
    gc.disable()
    try:
        port.execute(GROUP_SQL)
        left = [o for o in gc.get_objects() if type(o) is ScanInput]
    finally:
        gc.enable()
    assert left == []


def test_a_dropped_engine_frees_its_device_copies_at_del(torch_tpch):
    """P10: an Engine is no reference cycle, so ``del`` frees it and its
    device copies with the cycle collector off, after queries that
    plan, optimize, estimate (EXPLAIN, EXPLAIN ANALYZE, a memory
    budget's estimate), write, and run over a shard group."""
    import gc
    import weakref

    from presto_tpu_torch.parallel.group import LocalShardGroup
    from tpch_queries import QUERIES

    gc.collect()
    gc.disable()
    try:
        e = TorchEngine(device="cpu")
        e.register_catalog("tpch", torch_tpch)
        e.register_catalog("memory", MemoryConnector())
        for sql in ["create table memory.t as select o_orderkey, "
                    "o_orderstatus from orders",
                    "select o_orderstatus, count(*) from memory.t "
                    "group by 1",
                    "explain " + QUERIES["q05"],
                    "explain analyze " + QUERIES["q05"],
                    "select n_name, rank() over (partition by n_regionkey "
                    "order by n_name) from nation"]:
            e.execute(sql)
        e.session.set("query_max_memory_bytes", 1 << 20)
        e.execute(QUERIES["q05"])
        e.session.set("query_max_memory_bytes", 0)
        e.execute(QUERIES["q05"], mesh=LocalShardGroup(4, "cpu"))
        tensors = [weakref.ref(t) for _h, t in e._dev_cache.values()]
        assert len(tensors) > 10
        engine = weakref.ref(e)
        del e
        assert engine() is None
        assert [t for t in tensors if t() is not None] == []
    finally:
        gc.enable()


def test_lists_cache_dropped_after_update_of_array_table():
    """An ARRAY column's padded layout is cached per host column; an
    UPDATE of its table drops it, and the repeat query equals the
    reference. SET of the ARRAY column itself fails on both engines
    alike: their CAST does not parse an ARRAY type name (ROADMAP R14);
    the copies are dropped all the same."""
    import torch_array_cases as AC
    from presto_tpu import types as RT
    from presto_tpu_torch import types as PT

    ref = AC.memory_engine(RefEngine(), RefMemory(), RT,
                           {"t": AC.random_arrays(RT)})
    port = AC.memory_engine(TorchEngine(device="cpu"), MemoryConnector(),
                            PT, {"t": AC.random_arrays(PT)})
    read = "select k, cardinality(a), a[1], array_sum(b) from t"
    same(ref, port, read)
    assert port._lists_cache
    same(ref, port, "update t set k = k + 100 where k % 3 = 0")
    assert port._lists_cache == {} and port._dev_cache == {}
    same(ref, port, read)
    assert port._lists_cache
    err = same(ref, port, "update t set a = b where k < 3")
    assert err[0] == "ValueError"
    assert port._lists_cache == {}
    same(ref, port, read)


# -- the planning-time limit (P8) -------------------------------------------


def test_query_max_planning_time_fails_loudly(ref, port):
    from presto_tpu_torch.exec import cancel as C

    sql = "select count(*) from nation"
    for e in (ref, port):
        e.session.set("query_max_planning_time", 1e-9)
    with pytest.raises(C.QueryCanceled, match="query_max_planning_time"):
        port.execute(sql)
    assert same(ref, port, sql) == (
        "TimeLimitExceeded",
        "query exceeded query_max_planning_time (1e-09s)")
    with pytest.raises(C.TimeLimitExceeded):
        port.plan_sql(sql)
    assert port.events.history[-1].state == "FAILED"
    for e in (ref, port):
        e.session.set("query_max_planning_time", 0.0)
    assert same(ref, port, sql) == [(25,)]


def test_planning_observes_a_cancelled_token(port):
    from presto_tpu_torch.exec import cancel as C

    token = C.CancelToken()
    token.cancel()
    with pytest.raises(C.QueryCanceled, match="canceled"):
        port.execute("select count(*) from nation", cancel_token=token)
    assert port.last_run is None  # stopped before any program ran


# -- DELETE and UPDATE past one streamed block --------------------------------


def test_streamed_delete_and_update(ref, port):
    """DELETE and UPDATE pair each result row with a table row by
    position, so the route must keep table order; the table here is
    larger than one streamed block, and the streamed aggregate over it
    is read before and after each write."""
    for e in (ref, port):
        e.session.set("scan_block_rows", 4096)
    agg = ("select o_orderpriority, count(*), sum(o_totalprice), "
           "min(o_orderkey) from memory.s group by 1 order by 1")
    for sql in [
        "create table memory.s as select o_orderkey, o_totalprice, "
        "o_orderpriority from orders",
        agg,
        "delete from memory.s where o_orderkey % 5 = 0",
        agg,
        "update memory.s set o_totalprice = o_totalprice + 1, "
        "o_orderpriority = 'Z' where o_orderkey % 7 = 0",
        agg,
    ]:
        same(ref, port, sql)
    assert port.last_streamed_blocks > 1
    # against numpy over the generator's orders
    orders = port.catalogs["tpch"].table("orders")
    key = np.asarray(orders.columns["o_orderkey"].data)
    price = np.asarray(orders.columns["o_totalprice"].data)
    keep = key % 5 != 0
    key, price = key[keep], price[keep]
    hit = key % 7 == 0
    data = port.catalogs["memory"]._data["s"]
    np.testing.assert_array_equal(data["o_orderkey"], key)
    np.testing.assert_array_equal(data["o_totalprice"],
                                  np.where(hit, price + 100, price))
    assert list(np.flatnonzero(data["o_orderpriority"] == "Z")) == \
        list(np.flatnonzero(hit))


# -- chip_smoke's statements phase, rehearsed on the CPU ----------------------


def test_chip_smoke_statement_cases_on_the_cpu(torch_tpch, monkeypatch):
    """Phase 8 of chip_smoke.py at SF0.01 with the plain versions on the
    CPU (its card calls stubbed, writer scaling lowered to this size):
    every case's checks hold. The kernel checks need the card."""
    import sys
    from pathlib import Path

    import presto_tpu_torch.engine as PE

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(PE, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(PE, "WRITER_SCALING_CELLS", 1 << 14)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *args: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    out = chip_smoke.statement_cases(torch_tpch, "torch", None)
    assert sorted(out) == ["ST1", "ST2", "ST3", "ST4", "ST5", "ST6", "ST7"]
    assert out["ST1"]["li"] == [(torch_tpch.table("lineitem").nrows,)]
    assert out["ST6"][2].count("FAILED") == 1
