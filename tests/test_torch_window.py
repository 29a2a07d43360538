"""Window functions through the port (exec/operators.apply_window and
its frames): the SQL of tests/test_window.py through
presto_tpu_torch.Engine(device="cpu") at SF0.01, rows equal to
presto_tpu.Engine's and to the sqlite oracle's. Ranks, running and
full-partition aggregates, lag/lead, first/last value, ROWS, value
RANGE and GROUPS frames, and NULL sort keys under RANGE offsets; and,
against sqlite only, bounded ROWS min/max/avg frames, ntile,
percent_rank, cume_dist, nth_value and lag/lead with offsets."""

import numpy as np
import pytest
import torch

from presto_tpu.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

WINDOW_SQL = {
    "rank_dense_rank_row_number": """
        select n_name, r_name,
               rank() over (partition by n_regionkey order by n_name) as rk,
               dense_rank() over (partition by n_regionkey
                                  order by n_name) as drk,
               row_number() over (partition by n_regionkey
                                  order by n_name) as rn
        from nation, region where n_regionkey = r_regionkey
        order by r_name, rk, n_name""",
    "running_sum_and_count": """
        select o_custkey, o_orderkey,
               sum(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) as running,
               count(*) over (partition by o_custkey
                              order by o_orderkey) as cnt
        from orders where o_custkey < 50
        order by o_custkey, o_orderkey""",
    "full_partition_agg": """
        select o_orderkey, o_custkey,
               sum(o_totalprice) over (partition by o_custkey) as tot,
               max(o_totalprice) over (partition by o_custkey) as mx
        from orders where o_custkey < 30
        order by o_orderkey""",
    "lag_lead": """
        select o_orderkey,
               lag(o_orderkey) over (partition by o_custkey
                                     order by o_orderkey) as prev_o,
               lead(o_orderkey) over (partition by o_custkey
                                      order by o_orderkey) as next_o
        from orders where o_custkey < 40
        order by o_orderkey""",
    "window_over_aggregation": """
        select n_regionkey, count(*) as cnt,
               rank() over (order by count(*) desc, n_regionkey) as rk
        from nation group by n_regionkey
        order by rk""",
    "running_min": """
        select o_orderkey,
               min(o_totalprice) over (partition by o_custkey
                                       order by o_orderkey) as run_min
        from orders where o_custkey < 40
        order by o_orderkey""",
    "rows_frame_vs_range_default": """
        select n_nationkey,
               sum(n_nationkey) over (order by n_regionkey
                 rows between unbounded preceding and current row) as r
        from nation order by n_regionkey, n_nationkey, r""",
    "varchar_window_functions": """
        select n_name,
               first_value(n_name) over (partition by n_regionkey
                                         order by n_name) as fv,
               lag(n_name) over (partition by n_regionkey
                                 order by n_name) as lg,
               max(n_name) over (partition by n_regionkey) as mx
        from nation order by n_name""",
    "range_offset_frame_sum": """
        select o_orderkey,
               sum(o_totalprice) over (partition by o_custkey
                 order by o_orderkey
                 range between 5 preceding and 5 following) as s
        from orders where o_custkey < 40
        order by o_orderkey""",
    "range_offset_preceding_only": """
        select o_orderkey,
               count(*) over (order by o_orderkey
                 range 1000 preceding) as c
        from orders where o_custkey < 60
        order by o_orderkey""",
    "range_offset_min_max": """
        select o_orderkey,
               max(o_totalprice) over (order by o_orderkey
                 range between 500 preceding and 500 following) as mx,
               min(o_totalprice) over (order by o_orderkey
                 range between 500 preceding and 500 following) as mn
        from orders where o_custkey < 60
        order by o_orderkey""",
    "range_offset_desc": """
        select o_orderkey,
               sum(o_totalprice) over (order by o_orderkey desc
                 range between 700 preceding and 300 following) as s
        from orders where o_custkey < 50
        order by o_orderkey""",
    "range_unbounded_to_offset": """
        select o_orderkey,
               sum(o_totalprice) over (order by o_orderkey
                 range between unbounded preceding
                 and 100 following) as s,
               count(*) over (order by o_orderkey
                 range between 100 preceding
                 and unbounded following) as c
        from orders where o_custkey < 50
        order by o_orderkey""",
    "range_frame_with_peers": """
        select n_nationkey,
               sum(n_nationkey) over (order by n_regionkey
                 range between 1 preceding and 1 following) as s
        from nation order by n_nationkey""",
    "range_first_last_value": """
        select o_orderkey,
               first_value(o_orderkey) over (order by o_orderkey
                 range between 300 preceding and 300 following) as fv,
               last_value(o_orderkey) over (order by o_orderkey
                 range between 300 preceding and 300 following) as lv
        from orders where o_custkey < 40
        order by o_orderkey""",
    "groups_frame_sum": """
        select n_nationkey,
               sum(n_nationkey) over (order by n_regionkey
                 groups between 1 preceding and 1 following) as s
        from nation order by n_nationkey""",
    "groups_frame_current_row": """
        select n_nationkey,
               count(*) over (order by n_regionkey
                 groups between current row and current row) as c
        from nation order by n_nationkey""",
    "groups_frame_min_max_partitioned": """
        select o_orderkey,
               max(o_totalprice) over (partition by o_orderstatus
                 order by o_custkey
                 groups between 2 preceding and 2 following) as mx
        from orders where o_custkey < 50
        order by o_orderkey""",
    "groups_frame_unbounded_side": """
        select n_nationkey,
               sum(n_nationkey) over (order by n_regionkey
                 groups between unbounded preceding
                 and 1 following) as s
        from nation order by n_nationkey""",
}

# statements of this file, held against sqlite only (no reference test
# runs them): bounded ROWS min/max/avg/count frames, the rank family,
# the value functions and a frame unbounded on its following side
ORACLE_WINDOW_SQL = {
    "rows_bounded_minmax_avg": """
        select o_orderkey,
          min(o_totalprice) over (partition by o_custkey order by o_orderkey
            rows between 2 preceding and 1 following) as mn,
          max(o_totalprice) over (partition by o_custkey order by o_orderkey
            rows between 1 preceding and 2 following) as mx,
          avg(o_totalprice) over (partition by o_custkey order by o_orderkey
            rows between 2 preceding and current row) as av,
          count(*) over (partition by o_custkey order by o_orderkey
            rows between 3 preceding and 1 preceding) as c
        from orders where o_custkey < 60 order by o_orderkey""",
    "rank_family": """
        select n_name,
          ntile(3) over (partition by n_regionkey order by n_name) as nt,
          percent_rank() over (partition by n_regionkey
                               order by n_name) as pr,
          cume_dist() over (order by n_regionkey) as cd,
          dense_rank() over (order by n_regionkey) as dr
        from nation order by n_name""",
    "value_functions": """
        select o_orderkey,
          lag(o_totalprice, 2) over (partition by o_custkey
                                     order by o_orderkey) as l2,
          lead(o_orderdate, 1) over (partition by o_custkey
                                     order by o_orderkey) as l1,
          nth_value(o_orderkey, 2) over (partition by o_custkey
            order by o_orderkey rows between unbounded preceding
            and unbounded following) as nv,
          last_value(o_orderkey) over (partition by o_custkey
            order by o_orderkey rows between unbounded preceding
            and unbounded following) as lv
        from orders where o_custkey < 60 order by o_orderkey""",
    "unbounded_following_min": """
        select o_orderkey,
          min(o_totalprice) over (partition by o_custkey order by o_orderkey
            rows between current row and unbounded following) as m
        from orders where o_custkey < 60 order by o_orderkey""",
}

NULL_KEY_SQL = """
    select id,
           sum(id) over (order by v asc nulls last
             range between 10 preceding and 10 following) as s,
           count(*) over (order by v desc nulls first
             range between 15 preceding and 5 following) as c
    from mem.t order by id"""


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


@pytest.mark.parametrize("name", sorted(WINDOW_SQL))
def test_window_rows_equal_reference_and_oracle(name, port, engine, oracle):
    sql = WINDOW_SQL[name]
    got = port.execute(sql)
    assert len(got) > 0
    assert got == engine.execute(sql)
    assert_query(port, oracle, sql)


@pytest.mark.parametrize("name", sorted(ORACLE_WINDOW_SQL))
def test_window_rows_equal_oracle(name, port, oracle):
    assert len(port.execute(ORACLE_WINDOW_SQL[name])) > 0
    assert_query(port, oracle, ORACLE_WINDOW_SQL[name])


def test_range_frame_null_keys(port, engine, oracle):
    # NULL sort keys: offset frames cover the null peer group only
    from presto_tpu import types as RT
    from presto_tpu.connectors.memory import MemoryConnector as RefMemory
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.connectors.memory import MemoryConnector
    vals = np.asarray([10, 20, 20, 35, 0, 0, 50], dtype=np.int64)
    valid = np.asarray([1, 1, 1, 1, 0, 0, 1], dtype=bool)
    data = {"id": np.arange(7), "v": vals}
    ref_mem, port_mem = RefMemory(), MemoryConnector()
    ref_mem.create_table("t", {"id": RT.BIGINT, "v": RT.BIGINT}, data,
                         {"id": None, "v": valid})
    port_mem.create_table("t", {"id": PT.BIGINT, "v": PT.BIGINT}, data,
                          {"id": None, "v": valid})
    engine.register_catalog("mem", ref_mem)
    port.register_catalog("mem", port_mem)
    oracle.load_connector(ref_mem)
    got = port.execute(NULL_KEY_SQL)
    assert got == engine.execute(NULL_KEY_SQL)
    assert_query(port, oracle, NULL_KEY_SQL)


def test_window_scatters_back_to_row_order(port):
    # one Window node's output keeps the input's rows: an unordered
    # projection of the window column still pairs with its own row
    rows = port.execute(
        "select n_nationkey, row_number() over (order by n_nationkey desc) "
        "from nation")
    assert sorted(rows) == [(k, 25 - k) for k in range(25)]
