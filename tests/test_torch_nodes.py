"""Union, Values, MarkDistinct and FULL joins through the port
(exec/executor._r_union/_r_values/_r_markdistinct and
exec/operators.apply_union, concat_dtables, apply_mark_distinct and the
FULL arm of apply_expand_join), at SF0.01 on the CPU.

The ROLLUP / CUBE / GROUPING SETS queries of tests/test_grouping_sets.py
plan as a Union of Aggregates that project constant grouping ids;
they are held against presto_tpu.Engine (exact rows) and against the
oracle's hand-written UNION ALL expansions, as that file does. The
other statements are new here, so they are held against sqlite only."""

import pytest
import torch

from presto_tpu.testing.oracle import assert_query, rows_equal

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

# tests/test_grouping_sets.py: (engine SQL, oracle SQL)
GROUPING_SQL = {
    "rollup": ("""
        select n_regionkey, n_name, count(*) as c from nation
        group by rollup(n_regionkey, n_name)
        order by n_regionkey, n_name, c""", """
        select * from (
          select n_regionkey, n_name, count(*) from nation
            group by n_regionkey, n_name
          union all select n_regionkey, null, count(*) from nation
            group by n_regionkey
          union all select null, null, count(*) from nation)
        order by 1 nulls last, 2 nulls last, 3"""),
    "grouping_sets": ("""
        select n_regionkey, count(*) from nation
        group by grouping sets ((n_regionkey), ())
        order by n_regionkey""", """
        select * from (
          select n_regionkey, count(*) from nation group by n_regionkey
          union all select null, count(*) from nation)
        order by 1 nulls last"""),
    "cube_with_aggs": ("""
        select n_regionkey, r_name, count(*), sum(n_nationkey)
        from nation, region where n_regionkey = r_regionkey
        group by cube(n_regionkey, r_name) order by 1, 2, 3""", """
        select * from (
          select n_regionkey, r_name, count(*), sum(n_nationkey)
            from nation, region where n_regionkey = r_regionkey
            group by n_regionkey, r_name
          union all select n_regionkey, null, count(*), sum(n_nationkey)
            from nation, region where n_regionkey = r_regionkey
            group by n_regionkey
          union all select null, r_name, count(*), sum(n_nationkey)
            from nation, region where n_regionkey = r_regionkey
            group by r_name
          union all select null, null, count(*), sum(n_nationkey)
            from nation, region where n_regionkey = r_regionkey)
        order by 1 nulls last, 2 nulls last, 3"""),
    "mixed_simple_and_rollup": ("""
        select n_regionkey, n_name, count(*) from nation
        group by n_regionkey, rollup(n_name)
        order by 1, 2""", """
        select * from (
          select n_regionkey, n_name, count(*) from nation
            group by n_regionkey, n_name
          union all select n_regionkey, null, count(*) from nation
            group by n_regionkey)
        order by 1 nulls last, 2 nulls last"""),
}

# tests/test_grouping_sets.py::test_grouping_function
GROUPING_FUNCTION_SQL = [
    "select n_regionkey, grouping(n_regionkey), count(*) "
    "from nation group by rollup(n_regionkey) order by 2, 1",
    "select n_regionkey, n_name, grouping(n_regionkey, n_name), count(*) "
    "from nation group by cube(n_regionkey, n_name) order by 3, 1, 2",
]

NODE_SQL = {
    # Union of branches over different tables: the string dictionaries
    # merge, a decimal branch and an integer branch cast to one type
    "union_all_strings_and_casts": """
        select name, v from (
          select r_name as name, r_regionkey as v from region
          union all select n_name, n_nationkey from nation
          union all select 'EXTRA', 99 from region where r_regionkey = 0)
        order by name, v""",
    "union_all_decimal_and_bigint": """
        select k, sum(x) from (
          select l_returnflag as k, l_quantity as x from lineitem
            where l_orderkey < 200
          union all select o_orderstatus, o_custkey from orders
            where o_orderkey < 200)
        group by k order by k""",
    "union_distinct": """
        select n_regionkey from nation union select r_regionkey from region
        order by 1""",
    # Values: the one-row relation under a FROM-less SELECT, and under
    # each branch of a union of constants (projected literals)
    "union_of_constants": """
        select x from (select 1 as x union all select 2 union all select 3)
        order by x""",
    "constants_joined_to_a_table": """
        select r_name, t.w from region
        join (select 0 as k, 10 as w union all select 2, 30) t
        on r_regionkey = t.k order by r_name""",
    "select_without_from": "select 1 + 2, 'x'",
    # MarkDistinct: a global count(distinct) beside plain aggregates, and
    # two distinct arguments in one grouped query
    "global_count_distinct": """
        select count(distinct l_suppkey), count(*), sum(l_quantity)
        from lineitem""",
    "two_count_distincts_grouped": """
        select l_returnflag, count(distinct l_suppkey),
               count(distinct l_partkey), count(*)
        from lineitem group by l_returnflag order by l_returnflag""",
    "sum_distinct_with_nulls": """
        select n_regionkey,
               count(distinct case when n_nationkey > 10 then n_name end)
        from nation group by n_regionkey order by n_regionkey""",
    # FULL joins: unmatched rows of both sides, with and without a
    # residual filter, over a many-to-many key
    "full_join_both_sides_unmatched": """
        select a.k, b.k, a.c, b.c from
          (select n_regionkey as k, count(*) as c from nation
             where n_regionkey < 3 group by 1) a
        full join
          (select r_regionkey as k, count(*) as c from region
             where r_regionkey > 1 group by 1) b
        on a.k = b.k order by 1, 2""",
    "full_join_expanding": """
        select count(*), count(c_custkey), count(o_orderkey)
        from (select * from customer where c_custkey < 300) c
        full join (select * from orders where o_orderkey < 3000) o
        on c_custkey = o_custkey""",
    "long_decimal_count_distinct": """
        select count(distinct l_extendedprice * l_quantity),
               count(distinct l_suppkey)
        from lineitem where l_orderkey < 3000""",
    "union_all_long_decimals": """
        select s from (select sum(l_extendedprice) as s from lineitem
                       union all select sum(o_totalprice) from orders)
        order by s""",
    "full_join_string_keys": """
        select a.n_name, b.r_name
        from (select distinct n_name from nation) a
        full join (select distinct r_name from region) b
        on a.n_name = b.r_name order by 1, 2""",
    "full_join_with_filter": """
        select n_name, r_name from nation full join region
        on n_regionkey = r_regionkey and n_nationkey < 8
        order by n_name, r_name""",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=0.01))
    return e


@pytest.mark.parametrize("name", sorted(GROUPING_SQL))
def test_grouping_sets_equal_reference_and_oracle(name, port, engine,
                                                  oracle):
    sql, oracle_sql = GROUPING_SQL[name]
    got = port.execute(sql)
    assert "Union" in port.explain(sql)
    assert got == engine.execute(sql)
    ok, msg = rows_equal(got, oracle.query(oracle_sql), ordered=True)
    assert ok, msg


@pytest.mark.parametrize("sql", GROUPING_FUNCTION_SQL)
def test_grouping_function(sql, port, engine, oracle):
    assert port.execute(sql) == engine.execute(sql)
    assert_query(port, oracle, sql)


def test_plain_group_by_grouping_is_zero(port):
    rows = port.execute("select grouping(n_regionkey) from nation "
                        "group by n_regionkey limit 1")
    assert rows[0][0] == 0


@pytest.mark.parametrize("name", sorted(NODE_SQL))
def test_nodes_rows_equal_oracle(name, port, oracle):
    got = port.execute(NODE_SQL[name])
    assert len(got) > 0
    assert_query(port, oracle, NODE_SQL[name])


@pytest.mark.parametrize("name,node", [
    ("union_all_strings_and_casts", "Union"),
    ("select_without_from", "Values"),
    ("global_count_distinct", "MarkDistinct"),
    ("two_count_distincts_grouped", "MarkDistinct"),
    ("full_join_expanding", "Join[full, expanding"),
])
def test_statement_plans_the_node(name, node, port):
    assert node in port.explain(NODE_SQL[name])


def test_values_columns_upload_through_hostsync(port):
    from presto_tpu_torch.exec import hostsync as HS
    before = HS.UPLOADS.by_site.get("values", 0)
    port.execute(NODE_SQL["union_of_constants"])
    assert HS.UPLOADS.by_site.get("values", 0) - before == 3


def test_capacity_hints_are_bounded_by_their_inputs():
    # a planner hint past what the inputs can need (estimates compound
    # over chained joins: a 2^42-slot table for TPC-DS q95 at scale 10)
    # is cut; a retry-ladder override still grows past the bound
    import types
    from presto_tpu_torch.exec.executor import PlanInterpreter
    interp = PlanInterpreter({}, {}, None, "cpu", {})
    node = types.SimpleNamespace(capacity=1 << 42, output_capacity=1 << 44)
    assert interp._capacity(node, 1 << 10, most=1 << 12) == 1 << 12
    assert interp._capacity(node, 1 << 20, "out", most=1 << 20) == 1 << 20
    small = types.SimpleNamespace(capacity=64, output_capacity=None)
    assert interp._capacity(small, 1 << 10, most=1 << 12) == 64
    interp.capacities[(id(node), "table")] = 1 << 14
    assert interp._capacity(node, 1 << 10, most=1 << 12) == 1 << 14
