"""The information_schema and system catalogs, DESCRIBE and the query
events of the port (presto_tpu_torch/connectors/information_schema.py,
events.py), held against presto_tpu on the SQL of
tests/test_metadata.py over the same SF0.01 data: rows, or the error's
type and message, equal the reference's. The system tables that read
the runtime-stats recorders keep the reference's schemas (their rows:
tests/test_torch_qstats.py, test_torch_observatory.py)."""

import pytest
import torch

from presto_tpu import Engine as RefEngine

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.events import QueryCompletedEvent


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
    return e


@pytest.fixture()
def port(torch_tpch):
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", torch_tpch)
    return e


def outcome(engine, sql: str):
    """The rows of ``sql``, or its error's type name and message."""
    try:
        return engine.execute(sql)
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc).__name__, str(exc)


def same(ref, port, sql: str):
    want = outcome(ref, sql)
    got = outcome(port, sql)
    assert got == want, sql
    return got


def test_information_schema_tables(ref, port):
    rows = same(ref, port, "select table_name from information_schema.tables "
                "where table_catalog = 'tpch' order by table_name")
    assert ("lineitem",) in rows and ("region",) in rows
    assert len(rows) == 8


def test_information_schema_columns_joinable(ref, port):
    by_name = dict(same(
        ref, port,
        "select t.table_name, count(*) as ncols "
        "from information_schema.tables t, information_schema.columns c "
        "where t.table_name = c.table_name and t.table_catalog = 'tpch' "
        "group by t.table_name order by t.table_name"))
    assert by_name["region"] == 3 and by_name["lineitem"] == 16


# session properties whose description is the port's own: the
# reference's program_cache_entries speaks of compiled XLA programs, the
# port's of its entries and its persistent store (exec/progcache.py)
PORT_DESCRIBED = ("program_cache_entries",)


@pytest.mark.parametrize("sql", [
    "select * from information_schema.schemata order by 1",
    "select * from information_schema.tables order by 1, 3",
    "select * from information_schema.columns "
    "order by table_catalog, table_name, ordinal_position",
    "select * from system.runtime.nodes",
    "select name, value, \"default\", type from "
    "system.runtime.session_properties order by name",
    "select * from system.runtime.session_properties "
    "where name <> 'kernel_backend' order by name",
    "select * from system.runtime.result_cache",
    "select * from system.runtime.query_history",
    "describe system.runtime.tasks",
    "describe system.runtime.operator_stats",
    "describe system.runtime.plan_divergence",
    "describe system.runtime.adaptive_decisions",
    "show tables from system",
    "show tables from information_schema",
    "select * from information_schema.no_such_table",
])
def test_metadata_scans_equal_the_reference(ref, port, sql):
    if not sql.startswith("select * from system.runtime.session_properties"):
        same(ref, port, sql)
        return
    # the description (last column) of a property in PORT_DESCRIBED is
    # the port's own; every other column and row is the reference's
    want, got = outcome(ref, sql), outcome(port, sql)
    assert [r[:-1] if r[0] in PORT_DESCRIBED else r for r in got] == \
        [r[:-1] if r[0] in PORT_DESCRIBED else r for r in want], sql
    described = {r[0]: r[-1] for r in got if r[0] in PORT_DESCRIBED}
    assert "XLA" not in described["program_cache_entries"]
    assert "PRESTO_TPU_PROGRAM_CACHE_DIR" in \
        described["program_cache_entries"]


@pytest.mark.parametrize("table", ["tasks", "operator_stats",
                                   "plan_divergence", "adaptive_decisions"])
def test_qstats_tables_raise_until_ported(ref, port, table):
    # the runtime-stats recorders (obs/qstats) are ported: a scan of the
    # table answers, as the reference's does
    assert port.execute(
        f"select count(*) from system.runtime.{table}")[0][0] >= 0
    # their schemas are the reference's
    want = ref.catalogs["system"].table_schema(table)
    got = port.catalogs["system"].table_schema(table)
    assert [(c, str(t)) for c, t in got.items()] == \
        [(c, str(t)) for c, t in want.items()]


def test_every_system_table_has_the_reference_schema(ref, port):
    want = ref.catalogs["system"]
    got = port.catalogs["system"]
    assert got.table_names() == want.table_names()
    for name in want.table_names():
        assert [(c, str(t)) for c, t in got.table_schema(name).items()] \
            == [(c, str(t)) for c, t in want.table_schema(name).items()]


def test_describe_matches_show_columns(ref, port):
    assert same(ref, port, "describe region") == \
        same(ref, port, "show columns from region")
    assert same(ref, port, "desc region")[0][0] == "r_regionkey"


def test_system_runtime_queries_records_history(ref, port):
    sqls = ["select count(*) from region",
            "select no_such_column from region",
            "show catalogs"]
    for sql in sqls:
        same(ref, port, sql)
    read = ("select state, user, query, output_rows, error "
            "from system.runtime.queries order by query_id")
    rows = same(ref, port, read)
    assert [r[2] for r in rows] == sqls
    assert [r[0] for r in rows] == ["FINISHED", "FAILED", "FINISHED"]
    assert rows[1][4].startswith("SemanticError")
    # the read itself was running, so it shows up in the next one
    assert len(port.execute(read)) == 4


def test_event_listeners_see_lifecycle(port):
    events = []
    port.events.add_listener(events.append)
    port.execute("select count(*) from region")
    assert [type(e).__name__ for e in events] == \
        ["QueryCreatedEvent", "QueryCompletedEvent"]
    done = events[1]
    assert isinstance(done, QueryCompletedEvent)
    assert done.state == "FINISHED" and done.output_rows == 1
    assert done.elapsed_ms >= 0 and done.query_id == events[0].query_id
    tbl = port.execute_table("select r_name from region where "
                             "r_regionkey < 3")
    assert events[-1].output_rows == len(tbl.to_pylist()) == 3


def test_execute_of_a_prepared_statement_records_its_text(ref, port):
    for e in (ref, port):
        e.execute("prepare p from select count(*) from region "
                  "where r_regionkey < ?")
        e.execute("execute p using 3")
    assert port.events.history[-1].sql == ref.events.history[-1].sql
    assert port.events.history[-1].output_rows == 1


def test_broken_listener_does_not_fail_query(port):
    def bad(_event):
        raise RuntimeError("boom")
    port.events.add_listener(bad)
    assert port.execute("select count(*) from region") == [(5,)]


def test_session_properties_table_reflects_set_session(ref, port):
    for e in (ref, port):
        e.execute("set session distributed_sort = false")
    assert same(ref, port, "select value from "
                "system.runtime.session_properties "
                "where name = 'distributed_sort'") == [("False",)]


def test_show_rewrites_to_information_schema(port):
    from presto_tpu_torch.sql import ast as A
    from presto_tpu_torch.sql.parser import parse_statement
    from presto_tpu_torch.sql.rewrite import rewrite_statement

    stmt = rewrite_statement(parse_statement("show tables"), port)
    assert isinstance(stmt, A.QueryStatement)
    plan, _ = port.plan_sql(
        "select table_name from information_schema.tables")
    assert plan is not None
    assert ("region",) in port.execute("show tables")


def test_monitoring_adds_no_sync_or_upload(port):
    """events.monitored counts rows from the host result: the query's
    syncs and uploads are those of the executor alone."""
    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.exec.executor import execute_plan

    sql = "select r_name, count(*) from region, nation " \
          "where r_regionkey = n_regionkey group by r_name"
    port.execute(sql)  # the columns go up once
    counts = []
    for run in (lambda: port.execute(sql),
                lambda: execute_plan(port, port.plan_sql(sql)[0])):
        s0, u0 = HS.SYNCS.total(), HS.UPLOADS.total()
        run()
        counts.append((HS.SYNCS.total() - s0, HS.UPLOADS.total() - u0))
    assert counts[0] == counts[1]


def test_spans_of_a_traced_query(port):
    from presto_tpu_torch.obs.trace import TRACER

    with TRACER.trace("t-meta", "outer"):
        port.execute("select count(*) from region")
    names = [s.name for s in TRACER.spans("t-meta")]
    assert names[:3] == ["outer", "query", "plan"]
