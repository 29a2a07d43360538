"""The port's memory budget, host-partitioned spill and grouped
execution (presto_tpu_torch/memory.py, exec/spill.py), held against
presto_tpu on the same SQL: the cases of tests/test_memory.py (its
spill and estimate tests) and tests/test_connector_partitioning.py (its
grouped execution tests) at SF0.01. ``estimate_plan_memory``'s total
and per-node bytes, ``last_spill`` and ``last_grouped`` equal the
reference's; rows equal presto_tpu's and sqlite's."""

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.memory import MemoryLimitExceeded as RefMemoryLimitExceeded
from presto_tpu.memory import estimate_plan_memory as ref_estimate
from presto_tpu_torch.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.memory import (MemoryLimitExceeded,
                                     estimate_plan_memory, largest_join)
from presto_tpu_torch.plan import nodes as N

JOIN_SQL = """
    select o_orderpriority, count(*) as c, sum(l_quantity) as q
    from orders, lineitem
    where o_orderkey = l_orderkey and l_shipdate > date '1995-01-01'
    group by o_orderpriority
    order by o_orderpriority"""

OUTER_SQL = """
    select c_mktsegment, count(o_orderkey) as n
    from customer left outer join orders on c_custkey = o_custkey
    group by c_mktsegment
    order by c_mktsegment"""

EMPTY_PROBE_SQL = (
    "select o_orderpriority, count(*) as c from orders, lineitem "
    "where o_orderkey = l_orderkey "
    "and l_shipdate > date '2999-01-01' "
    "group by o_orderpriority order by o_orderpriority")

MULTI_JOIN_SQL = (
    "select n_name, count(*) as c from customer, orders, nation "
    "where c_custkey = o_custkey and c_nationkey = n_nationkey "
    "group by n_name order by n_name")

AGG_SQL = """
    select l_orderkey, l_linenumber, count(*) as c,
           sum(l_quantity) as q, min(l_shipdate) as d
    from lineitem
    group by l_orderkey, l_linenumber
    order by l_orderkey, l_linenumber limit 50"""

GROUPED_SQL = ("select o_orderpriority, count(*) as c, "
               "sum(l_quantity) as q from orders, lineitem "
               "where o_orderkey = l_orderkey "
               "group by o_orderpriority order by o_orderpriority")

ESTIMATE_SQL = {
    "sum": "select sum(l_quantity) from lineitem",
    "join": JOIN_SQL,
    "outer": OUTER_SQL,
    "multi_join": MULTI_JOIN_SQL,
    "aggregate": AGG_SQL,
    "order_by": ("select l_orderkey, l_quantity from lineitem "
                 "order by l_quantity"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_reference_ledger(monkeypatch):
    """The reference's cost model reads a process-wide ledger of what
    earlier queries observed (``presto_tpu.obs.qstats.DIVERGENCE``), so
    its plans depend on which tests ran before in the same process; the
    port has no such ledger yet (ROADMAP item 7). Each test plans the
    reference against an empty one."""
    from presto_tpu.obs import qstats
    monkeypatch.setattr(qstats, "DIVERGENCE", qstats.DivergenceLedger())


@pytest.fixture(scope="module")
def torch_tpch():
    return TorchTpch(scale=0.01)


def _pair(tpch_tiny, torch_tpch, **props):
    """A reference engine and a port engine with the same session
    properties."""
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    port = TorchEngine(device="cpu")
    port.register_catalog("tpch", torch_tpch)
    for name, value in props.items():
        ref.session.set(name, value)
        port.session.set(name, value)
    return ref, port


def _spilled(tpch_tiny, torch_tpch, oracle, sql, budget):
    """Run ``sql`` under ``budget`` on both packages: the port's
    ``last_spill`` equals the reference's and is set, its rows equal
    the reference's, its unspilled run's and sqlite's."""
    ref, port = _pair(tpch_tiny, torch_tpch, query_max_memory_bytes=budget)
    got = port.execute(sql)
    assert port.last_spill is not None, "expected the plan to spill"
    assert got == ref.execute(sql)
    assert port.last_spill == ref.last_spill
    spill = port.last_spill
    port.session.set("query_max_memory_bytes", 0)
    assert port.execute(sql) == got
    assert port.last_spill is None
    assert_query(port, oracle, sql)
    return spill, got


@pytest.mark.parametrize("name", sorted(ESTIMATE_SQL))
def test_plan_memory_estimate_equals_reference(tpch_tiny, torch_tpch, name):
    ref, port = _pair(tpch_tiny, torch_tpch)
    sql = ESTIMATE_SQL[name]
    rplan, _ = ref.plan_sql(sql)
    plan, _ = port.plan_sql(sql)
    rtotal, rnodes = ref_estimate(rplan, ref)
    total, nodes = estimate_plan_memory(plan, port)
    assert total == rtotal
    assert [(type(m.node).__name__, m.rows, m.resident) for m in nodes] \
        == [(type(m.node).__name__, m.rows, m.resident) for m in rnodes]
    joins = [m.node for m in nodes if isinstance(m.node, N.Join)]
    assert (largest_join(nodes) is None) == (not joins)


def test_plan_memory_estimate_scales_with_tables(tpch_tiny, torch_tpch):
    _ref, port = _pair(tpch_tiny, torch_tpch)
    plan, _ = port.plan_sql("select sum(l_quantity) from lineitem")
    total, per_node = estimate_plan_memory(plan, port)
    li_rows = port.catalogs["tpch"].row_count_estimate("lineitem")
    assert li_rows * 8 <= total <= li_rows * 1000
    assert any(m.resident > 0 for m in per_node)


def test_join_spills_under_budget_and_matches_oracle(tpch_tiny, torch_tpch,
                                                     oracle):
    spill, _got = _spilled(tpch_tiny, torch_tpch, oracle, JOIN_SQL, 200_000)
    assert spill["partitions"] >= 2 and spill["build_rows"] > 0


def test_left_join_spill_keeps_unmatched_probe_rows(tpch_tiny, torch_tpch,
                                                    oracle):
    _spilled(tpch_tiny, torch_tpch, oracle, OUTER_SQL, 100_000)


def test_spill_with_empty_probe_side(tpch_tiny, torch_tpch, oracle):
    # every partition empty: the empty join output keeps a dictionary
    # for its VARCHAR columns
    _spill, got = _spilled(tpch_tiny, torch_tpch, oracle, EMPTY_PROBE_SQL,
                           200_000)
    assert got == []


def test_multi_join_spills_top_join(tpch_tiny, torch_tpch, oracle):
    # the root-chain join spills and its sides cascade through the same
    # check (a MultiJoin unfuses first)
    _spilled(tpch_tiny, torch_tpch, oracle, MULTI_JOIN_SQL, 400_000)


def test_aggregation_spills_under_budget(tpch_tiny, torch_tpch, oracle):
    spill, _got = _spilled(tpch_tiny, torch_tpch, oracle, AGG_SQL, 400_000)
    assert spill["kind"] == "aggregate" and spill["partitions"] >= 2


@pytest.mark.parametrize("sql", [JOIN_SQL, AGG_SQL],
                         ids=["join", "aggregate"])
def test_memory_limit_without_spill_raises(tpch_tiny, torch_tpch, sql):
    ref, port = _pair(tpch_tiny, torch_tpch, query_max_memory_bytes=10_000,
                      spill_enabled=False)
    with pytest.raises(RefMemoryLimitExceeded):
        ref.execute(sql)
    with pytest.raises(MemoryLimitExceeded, match="spill is disabled"):
        port.execute(sql)


def test_unspillable_shape_fails_instead_of_running_unbounded(
        tpch_tiny, torch_tpch):
    # no join and no grouped aggregate on the root chain: the budget
    # cannot be kept, so the query fails rather than ignoring it
    sql = ESTIMATE_SQL["order_by"]
    ref, port = _pair(tpch_tiny, torch_tpch, query_max_memory_bytes=10_000)
    with pytest.raises(RefMemoryLimitExceeded):
        ref.execute(sql)
    with pytest.raises(MemoryLimitExceeded, match="no spillable join"):
        port.execute(sql)


def test_too_many_partitions_fail(tpch_tiny, torch_tpch):
    ref, port = _pair(tpch_tiny, torch_tpch, query_max_memory_bytes=1_000)
    with pytest.raises(RefMemoryLimitExceeded):
        ref.execute(JOIN_SQL)
    with pytest.raises(MemoryLimitExceeded, match="64 spill partitions"):
        port.execute(JOIN_SQL)


def test_streamable_aggregate_runs_under_budget(tpch_tiny, torch_tpch):
    # a block-streamed scan bounds its own working set: the budget does
    # not veto it
    sql = "select sum(l_quantity) from lineitem"
    ref, port = _pair(tpch_tiny, torch_tpch, query_max_memory_bytes=300_000,
                      scan_block_rows=16384)
    got = port.execute(sql)
    assert port.last_streamed_blocks >= 2 and port.last_spill is None
    assert got == ref.execute(sql)
    port.session.set("query_max_memory_bytes", 0)
    port.session.set("scan_block_rows", 1 << 24)
    assert port.execute(sql) == got


def test_spill_runs_partitions_through_the_query_run(tpch_tiny, torch_tpch):
    # both join sides, every partition and the rest of the plan are
    # programs of the one query; each partition went up as a carrier
    from presto_tpu_torch.exec import hostsync as HS
    _ref, port = _pair(tpch_tiny, torch_tpch,
                       query_max_memory_bytes=200_000)
    before = HS.UPLOADS.by_site.get("spill-partition", 0)
    port.execute(JOIN_SQL)
    parts = port.last_spill["partitions"]
    uploads = HS.UPLOADS.by_site.get("spill-partition", 0) - before
    run = port.last_run
    # 2 sides + at most one program per partition + the rest
    assert 3 < len(run.programs) <= 3 + parts
    assert uploads > 0


def test_grouped_execution_bucket_by_bucket(tpch_tiny, torch_tpch, oracle):
    ref, port = _pair(tpch_tiny, torch_tpch, grouped_execution=True,
                      grouped_execution_partitions=4)
    got = port.execute(GROUPED_SQL)
    assert port.last_grouped is not None
    assert got == ref.execute(GROUPED_SQL)
    assert port.last_grouped == ref.last_grouped
    assert port.last_grouped["partitions"] == 4
    assert port.last_grouped["build_rows"] > 0
    assert_query(port, oracle, GROUPED_SQL)


def test_grouped_execution_requires_cobucketed_sides(tpch_tiny, torch_tpch):
    # customer is not bucketed: grouped execution must not trigger
    sql = ("select count(*) from customer, orders "
           "where c_custkey = o_custkey")
    ref, port = _pair(tpch_tiny, torch_tpch, grouped_execution=True)
    assert port.execute(sql) == ref.execute(sql)
    assert port.last_grouped is None
    assert getattr(ref, "last_grouped", None) is None


NULL_KEY_SQL = {
    # probe rows whose key is NULL meet no build row, but a LEFT join
    # still emits them
    "left_join": ("select count(*), count(w), sum(v), sum(w) from p "
                  "left join b on k = bk", 40_000),
    # NULL keys are one group, whichever partition they hash to
    "aggregate": ("select k, count(*), sum(v) from p group by k "
                  "order by k nulls first limit 20", 40_000),
}


@pytest.mark.parametrize("name", sorted(NULL_KEY_SQL))
def test_spill_with_null_keys(name):
    rng = np.random.default_rng(7)
    n, m = 3000, 500
    data = {"k": rng.integers(0, 800, n), "v": np.arange(n)}
    valid = {"k": rng.random(n) > 0.2}
    engines = []
    for engine, conn, types in (
            (RefEngine(), RefMemory(), RT),
            (TorchEngine(device="cpu"), MemoryConnector(), T)):
        conn.create_table("p", {"k": types.BIGINT, "v": types.BIGINT},
                          data, valid)
        conn.create_table("b", {"bk": types.BIGINT, "w": types.BIGINT},
                          {"bk": np.arange(m) * 2, "w": np.arange(m)})
        engine.register_catalog("mem", conn)
        engine.session.catalog = "mem"
        engines.append(engine)
    ref, port = engines
    sql, budget = NULL_KEY_SQL[name]
    whole = port.execute(sql)
    for engine in engines:
        engine.session.set("query_max_memory_bytes", budget)
    got = port.execute(sql)
    assert port.last_spill["partitions"] >= 2
    assert got == whole == ref.execute(sql)
    assert port.last_spill == ref.last_spill
