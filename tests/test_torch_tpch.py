"""The TPC-H sweep through the port: the 17 queries that
tests/test_torch_engine.py does not cover (it holds Q1, Q3, Q5, Q6 and
Q9), each at SF0.01 through presto_tpu_torch.Engine(device="cpu"),
presto_tpu.Engine and the sqlite oracle, rows exactly equal between
the two engines; and a general (non-scalar) cross join, which reaches
the compaction kernel entry.

tests/test_tpch.py keeps q19 and q21 under ``slow`` because the
reference takes over 10 s to compile them; here their tier-1 case
holds the port against the oracle, and a ``slow`` case holds it
against the reference. The sweep's oracle is the conftest's sqlite
oracle over the same data plus two indexes (see ``indexed_oracle``)."""

import pytest
import torch

from presto_tpu.testing.oracle import SqliteOracle, assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch

from tpch_queries import QUERIES

COVERED = {"q01", "q03", "q05", "q06", "q09"}  # test_torch_engine.py
SWEEP = sorted(set(QUERIES) - COVERED)
REFERENCE_SLOW = {"q19", "q21"}  # as tests/test_tpch.py

# a fact table crossed with a small dimension: a general cross join,
# whose filtered left side is compacted before the product
CROSS_JOIN_SQL = """
select r_name, count(*) as c, sum(l_extendedprice) as s
from lineitem cross join region
where l_orderkey < 600
group by r_name
order by r_name
"""


# the extremes of each line status: a direct group-by whose min/max
# fold through the agg_min/agg_max entries
EXTREMA_SQL = """
select l_returnflag, l_linestatus, min(l_shipdate) as first_ship,
  max(l_receiptdate) as last_receipt, min(l_extendedprice) as min_price,
  max(l_quantity) as max_qty, min(l_discount) as min_disc
from lineitem
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host
    (its spinning threads slowed the whole suite several times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def port():
    e = TorchEngine(device="cpu")
    e.register_catalog("tpch", TorchTpch(scale=0.01))
    return e


def _notes(e) -> set[str]:
    return {t for tags in e.last_kernel_notes.values() for t in tags}


def test_sweep_covers_all_22_queries():
    assert len(SWEEP) == 17 and set(SWEEP) | COVERED == set(QUERIES)
    assert len(QUERIES) == 22


@pytest.fixture(scope="module")
def indexed_oracle(tpch_tiny):
    """The sqlite oracle over the same SF0.01 data, with indexes on the
    keys Q19's and Q21's correlated lookups probe: without them sqlite
    scans lineitem once per outer row (minutes for Q21). An index is an
    access path only; the answers are the oracle's."""
    o = SqliteOracle()
    o.load_connector(tpch_tiny)
    o.conn.execute("create index lineitem_orderkey on lineitem(l_orderkey)")
    o.conn.execute("create index part_partkey on part(p_partkey)")
    return o


@pytest.mark.parametrize("qname", SWEEP)
def test_query_rows_equal_oracle(qname, port, indexed_oracle):
    got = port.execute(QUERIES[qname])
    assert len(got) > 0
    assert_query(port, indexed_oracle, QUERIES[qname])


@pytest.mark.parametrize("qname", [
    pytest.param(q, marks=pytest.mark.slow) if q in REFERENCE_SLOW else q
    for q in SWEEP])
def test_query_rows_equal_reference(qname, port, engine):
    assert port.execute(QUERIES[qname]) == engine.execute(QUERIES[qname])


def test_q15_global_max_and_q02_sorted_min(port):
    # Q15's max over a long decimal folds through the agg_max entry;
    # Q2's min grouped by part key takes the sorted path (seg_min)
    port.execute(QUERIES["q15"])
    assert "torch:agg_max" in _notes(port)
    assert "Aggregate" in port.explain(QUERIES["q02"])


def test_cross_join_compacts_and_matches(port, engine, oracle):
    plan = port.explain(CROSS_JOIN_SQL)
    assert "CrossJoin[expanding]" in plan
    got = port.execute(CROSS_JOIN_SQL)
    assert "torch:compact" in _notes(port)
    assert got == engine.execute(CROSS_JOIN_SQL)
    assert len(got) == 5
    assert_query(port, oracle, CROSS_JOIN_SQL)


def test_cross_join_compaction_overflow_retries(port, engine):
    # a capacity far below the live rows: compact_dtable reports the
    # overflow and the retry ladder grows the left rung until it fits
    from presto_tpu_torch.exec import hostsync as HS
    before = HS.SYNCS.by_site.get("ok-ladder", 0)
    sql = CROSS_JOIN_SQL.replace("< 600", "< 6000")
    got = port.execute(sql)
    assert got == engine.execute(sql)
    assert HS.SYNCS.by_site.get("ok-ladder", 0) - before >= 1


def test_grouped_extrema_fold_through_min_and_max(port, engine, oracle):
    got = port.execute(EXTREMA_SQL)
    assert {"torch:agg_min", "torch:agg_max"} <= _notes(port)
    assert got == engine.execute(EXTREMA_SQL)
    assert len(got) == 4
    assert_query(port, oracle, EXTREMA_SQL)
