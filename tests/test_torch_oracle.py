"""The port's own test tooling (presto_tpu_torch/testing/ and
sql/sqlite_dialect.py) against the reference's: ``to_sqlite`` gives
presto_tpu's strings for the 22 TPC-H and the 101 TPC-DS texts; the
cases of tests/test_sqlite_dialect.py and tests/test_verifier.py on the
port's copies; the port's SqliteOracle loaded from the port's connector
holding the same rows as presto_tpu's loaded from presto_tpu's; and a
Verifier with presto_tpu's engine as control and the port's as test
over the 22 TPC-H queries at SF0.01, every one a MATCH."""

from __future__ import annotations

import sqlite3

import numpy as np
import pytest
import torch

from presto_tpu import Engine as RefEngine
from presto_tpu.sql.parser import parse_statement as ref_parse
from presto_tpu.sql.sqlite_dialect import to_sqlite as ref_to_sqlite
from presto_tpu.testing.oracle import SqliteOracle as RefOracle

import presto_tpu_torch.sql.ast as A
from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.sql.parser import parse_statement
from presto_tpu_torch.sql.sqlite_dialect import (
    _emulate_full_join, _full_join_anti_key, to_sqlite)
from presto_tpu_torch import types as T
from presto_tpu_torch.testing import SqliteOracle, assert_query
from presto_tpu_torch.testing.oracle import rows_equal, values_equal
from presto_tpu_torch.testing.verifier import (Verifier, VerifyResult,
                                               format_report)

from test_tpcds import QUERIES as TPCDS
from tpch_queries import QUERIES as TPCH


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


def _engine(conn) -> Engine:
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    return e


# -- the dialect ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TPCH))
def test_to_sqlite_of_tpch_equals_the_reference(name):
    sql = TPCH[name]
    assert to_sqlite(parse_statement(sql)) == ref_to_sqlite(ref_parse(sql))


@pytest.mark.parametrize("name", sorted(TPCDS))
def test_to_sqlite_of_tpcds_equals_the_reference(name):
    sql = TPCDS[name]
    assert to_sqlite(parse_statement(sql)) == ref_to_sqlite(ref_parse(sql))


def _spec(sql: str) -> A.QuerySpec:
    return parse_statement(sql).query.body


def test_anti_key_from_conjuncts():
    s = _spec("SELECT * FROM l la FULL JOIN r ra"
              " ON la.a = ra.a AND la.b = ra.b")
    key = _full_join_anti_key(s.from_relation.on, "la")
    assert isinstance(key, A.Dereference) and key.parts == ("la", "a")


def test_anti_key_declines_disjunctive_on():
    # ON l.a = r.a OR l.b = r.b can match rows whose l.a is NULL, so no
    # single left column is non-null on every matched row
    s = _spec("SELECT * FROM l la FULL JOIN r ra"
              " ON la.a = ra.a OR la.b = ra.b")
    assert _full_join_anti_key(s.from_relation.on, "la") is None
    assert _emulate_full_join(s) is None


def test_anti_key_declines_negated_on():
    s = _spec("SELECT * FROM l la FULL JOIN r ra"
              " ON NOT (la.a = ra.a)")
    assert _full_join_anti_key(s.from_relation.on, "la") is None


def test_emulation_matches_full_join_semantics():
    """The FULL JOIN rewrite over tables with NULL keys and unmatched
    rows on both sides equals the hand-computed full join."""
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE l (a INTEGER, v TEXT)")
    conn.execute("CREATE TABLE r (a INTEGER, w TEXT)")
    conn.executemany("INSERT INTO l VALUES (?, ?)",
                     [(1, "l1"), (2, "l2"), (None, "lN")])
    conn.executemany("INSERT INTO r VALUES (?, ?)",
                     [(2, "r2"), (3, "r3"), (None, "rN")])
    s = _spec("SELECT la.v, ra.w FROM l la FULL JOIN r ra"
              " ON la.a = ra.a")
    rewritten = _emulate_full_join(s)
    assert rewritten is not None
    sql = to_sqlite(A.Query(rewritten))
    assert "FULL JOIN" not in sql.upper()
    got = sorted(conn.execute(sql).fetchall(),
                 key=lambda t: (str(t[0]), str(t[1])))
    want = sorted([("l1", None), ("l2", "r2"), ("lN", None),
                   (None, "r3"), (None, "rN")],
                  key=lambda t: (str(t[0]), str(t[1])))
    assert got == want


@pytest.mark.parametrize("sql", [
    "select a from t where not exists (select 1 from u where u.k = t.k)",
    "select a from t where a not in (select k from u)",
    "select t.a, u.b from t full join u on t.k = u.k",
    "select t.a, u.b from t full outer join u on t.k = u.k and t.j = u.j",
])
def test_anti_and_full_joins_render_as_the_reference(sql):
    assert to_sqlite(parse_statement(sql)) == ref_to_sqlite(ref_parse(sql))


# -- the oracle ----------------------------------------------------------------

def test_oracle_loads_the_port_connector_as_the_reference_loads_its_own(
        torch_tpch, tpch_tiny):
    """The port's oracle over the port's TPC-H tables and presto_tpu's
    over its own (identical data) hold identical rows: dictionaries
    decoded, decimals unscaled, dates as ISO text."""
    port, ref = SqliteOracle(), RefOracle()
    port.load_connector(torch_tpch)
    ref.load_connector(tpch_tiny)
    for name in torch_tpch.table_names():
        sql = f"select * from {name} order by 1, 2, 3"
        assert port.query(sql) == ref.query(sql), name


def test_oracle_loads_nulls_and_every_type():
    mem = MemoryConnector()
    mem.create_table(
        "t", {"i": T.BIGINT, "d": T.DOUBLE, "s": T.VARCHAR,
              "day": T.DATE, "m": T.DecimalType(12, 2)},
        {"i": np.arange(4), "d": np.array([0.5, 1.5, 2.5, 3.5]),
         "s": np.array(["a", "b", "a", "c"], dtype=object),
         "day": np.array([0, 1, 2, 3], dtype=np.int32),
         "m": np.array([100, 250, -5, 0], dtype=np.int64)},
        {"i": None, "d": np.array([True, False, True, True]),
         "s": None, "day": None, "m": None})
    o = SqliteOracle()
    o.load_connector(mem)
    assert o.query("select * from t order by i") == [
        (0, 0.5, "a", "1970-01-01", 1.0), (1, None, "b", "1970-01-02", 2.5),
        (2, 2.5, "a", "1970-01-03", -0.05), (3, 3.5, "c", "1970-01-04", 0.0)]


def test_rows_equal_tolerances():
    assert rows_equal([(1, 698.47)], [(1, 698.4685714)], True)[0]
    assert not rows_equal([(5.0,)], [(5.4,)], True)[0]
    assert rows_equal([(1,), (2,)], [(2,), (1,)], False)[0]
    assert not rows_equal([(1,), (2,)], [(2,), (1,)], True)[0]
    assert values_equal(np.int64(3), 3) and values_equal(None, None)
    assert not values_equal(None, 0)


def test_assert_query_against_the_port(torch_tpch):
    e = _engine(torch_tpch)
    o = SqliteOracle()
    o.load_connector(torch_tpch)
    for q in ("q01", "q03", "q06", "q13"):
        assert_query(e, o, TPCH[q])
    with pytest.raises(AssertionError, match="query mismatch"):
        assert_query(e, o, "select count(*) from nation",
                     sqlite_sql="select count(*) + 1 from nation")


# -- the verifier --------------------------------------------------------------

def test_identical_engines_match(torch_tpch):
    a, b = _engine(torch_tpch), _engine(torch_tpch)
    v = Verifier(a.execute, b.execute)
    results = v.run_suite([
        "select count(*) from lineitem",
        "select l_returnflag, sum(l_quantity) from lineitem "
        "group by l_returnflag order by l_returnflag",
        "select o_orderpriority, count(*) from orders, lineitem "
        "where o_orderkey = l_orderkey group by o_orderpriority",
    ])
    assert all(r.status == "MATCH" for r in results)
    assert "MATCH=3" in format_report(results)


def test_mismatch_detected(torch_tpch):
    a, b = _engine(torch_tpch), _engine(torch_tpch)

    def corrupted(sql):
        rows = b.execute(sql)
        return [tuple(v + 1 if isinstance(v, (int, np.integer)) else v
                      for v in r) for r in rows]

    r = Verifier(a.execute, corrupted).run_one(
        "select count(*) from lineitem")
    assert r.status == "MISMATCH"


def test_errors_reported_not_raised(torch_tpch):
    a = _engine(torch_tpch)

    def broken(sql):
        raise RuntimeError("boom")

    r = Verifier(a.execute, broken).run_one("select 1")
    assert r.status == "TEST_ERROR" and "boom" in r.detail
    r = Verifier(broken, a.execute).run_one("select 1")
    assert r.status == "CONTROL_ERROR" and "boom" in r.detail


def test_unordered_results_compare_as_sets(torch_tpch):
    a, b = _engine(torch_tpch), _engine(torch_tpch)

    def reversed_rows(sql):
        return list(reversed(b.execute(sql)))

    r = Verifier(a.execute, reversed_rows).run_one(
        "select l_returnflag, count(*) from lineitem group by l_returnflag")
    assert r.status == "MATCH"


def test_verifier_reference_control_port_test(torch_tpch, tpch_tiny):
    """presto_tpu's engine as the control and the port's as the test
    over the 22 TPC-H queries at SF0.01: every checksum matches."""
    ref = RefEngine()
    ref.register_catalog("tpch", tpch_tiny)
    port = _engine(torch_tpch)
    results = Verifier(ref.execute, port.execute).run_suite(
        [TPCH[q] for q in sorted(TPCH)])
    report = format_report(results)
    assert all(isinstance(r, VerifyResult) for r in results)
    assert [r.status for r in results] == ["MATCH"] * 22, report
    assert "MATCH=22" in report
