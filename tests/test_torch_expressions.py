"""The expressions and aggregates the TPC-DS slice ported, through
presto_tpu_torch.Engine(device="cpu") at SF0.01 (and, for the variance
family, its fold/merge/finalize entries on numpy inputs):

- projected constants (ROADMAP Queue 3, P1): each query of the P1
  table against presto_tpu.Engine and sqlite; the three R6 divisions
  by a literal, which the reference fails, against sqlite only;
- IS [NOT] NULL, coalesce, nullif and the NOT IN null semantics of
  tests/test_null_semantics.py;
- modulus/mod, negate, abs, round, greatest/least, concat, upper/lower
  (tests/test_functions.py) and the varchar -> date/timestamp casts
  (tests/test_datetime.py);
- variance, var_samp, var_pop, stddev, stddev_samp, stddev_pop.

SQL taken from a reference test that its tier 1 runs is held against
the reference engine too; new statements are held against sqlite."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.expr import aggregates as RA
from presto_tpu_torch.testing.oracle import assert_query

from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.expr import aggregates as PA

P1_SQL = [
    "select 1 from region",
    "select 'x' from region",
    "select null from region",
    "select r_name, 7 from region order by 1",
    "select r_name, 2.50 from region order by 1",
    "select count(*) from nation where n_nationkey in (select 3 from region)",
    "select count(*) from nation where n_nationkey in "
    "(select null from region)",
    "select count(*) from nation where n_nationkey not in "
    "(select null from region)",
    "select count(*) from nation join (select 1 as k from region) t "
    "on n_regionkey = t.k",
    "select n_regionkey, sum(1) from nation group by 1",
    "select count(*) from region where 1 = 0",
]

# ROADMAP Queue 3, R6: the reference raises on these projections
R6_SQL = [
    "select n_nationkey / 3 from nation",
    "select cast(n_nationkey as double) / 2.0e0 from nation",
    "select l_quantity / 2.00 from lineitem",
]

# tests/test_null_semantics.py
NULL_SEMANTICS_SQL = [
    "select count(*) from orders where o_orderkey not in "
    "(select case when l_linenumber = 3 then null "
    "else l_orderkey end from lineitem)",
    "select count(*) from lineitem where "
    "(case when l_linenumber = 3 then null else l_orderkey end) "
    "not in (select o_orderkey from orders where o_orderkey > 5)",
    "select count(*) from lineitem where "
    "(case when l_linenumber = 3 then null else l_orderkey end) "
    "not in (select o_orderkey from orders where o_orderkey < 0)",
    "select count(*) from orders where o_orderkey in "
    "(select l_orderkey from lineitem where l_quantity < 5)",
]

# held against sqlite
EXPRESSION_SQL = {
    "is_null_and_is_not_null": """
        select count(*), count(case when n is null then 1 end),
               count(case when n is not null then 1 end)
        from (select case when l_linenumber > 2 then l_quantity end as n
              from lineitem)""",
    "is_null_filter_on_outer_join": """
        select count(*) from customer left join orders
        on c_custkey = o_custkey where o_orderkey is null""",
    "coalesce_mixed_types": """
        select o_orderkey,
               coalesce(case when o_orderkey % 3 = 0 then o_totalprice end,
                        case when o_orderkey % 2 = 0 then 1.5 end, 0)
        from orders where o_orderkey < 100 order by 1""",
    "coalesce_strings": """
        select coalesce(case when n_regionkey = 1 then n_name end,
                        r_name) as c
        from nation, region where n_regionkey = r_regionkey order by c""",
    "coalesce_over_left_join": """
        select coalesce(n_name, 'none'), count(*) from region
        left join nation on r_regionkey = n_regionkey and n_nationkey < 3
        group by 1 order by 1""",
    "nullif_and_upper_is_null": """
        select nullif(r_name, 'ASIA'), upper(r_comment) is null
        from region order by 1""",
    "round_of_aggregates": """
        select round(avg(o_totalprice), 1),
               round(sum(o_totalprice) / count(*), 2) from orders""",
    "grouped_variance": """
        select o_orderpriority, stddev_samp(o_totalprice),
               variance(o_totalprice)
        from orders group by 1 order by 1""",
    "nullif_columns": """
        select n_nationkey, nullif(n_regionkey, 2) from nation order by 1""",
    "modulus_and_negate": """
        select n_nationkey % 4, -n_nationkey, mod(n_nationkey, -3),
               -(l_quantity) % 7
        from nation, lineitem where n_nationkey = l_orderkey
        order by 1, 2, 4""",
    "abs_round_decimals": """
        select abs(o_totalprice - 100000), round(o_totalprice, 1),
               round(o_totalprice), abs(-o_custkey)
        from orders where o_orderkey < 60 order by o_totalprice""",
    "round_double": """
        select round(cast(o_totalprice as double) / 7e0, 2)
        from orders where o_orderkey < 60 order by 1""",
    "upper_lower_concat": """
        select upper(lower(n_name)), lower(r_name),
               concat(r_name, '/'), concat(n_name, r_name)
        from nation, region where n_regionkey = r_regionkey
        order by 1""",
    "cast_varchar_to_date": """
        select count(*) from orders
        where o_orderdate between cast('1995-01-01' as date)
                              and cast('1995-03-31' as date)""",
    "cast_varchar_column_to_date": """
        select cast(concat('199', substring(c_phone, 1, 1)) || '-01-01'
                    as date) as d, count(*)
        from customer group by 1 order by 1""",
}

VARIANCE_SQL = """
  select l_returnflag,
         stddev(l_quantity) as sd, stddev_pop(l_quantity) as sdp,
         variance(l_quantity) as v, var_pop(l_quantity) as vp,
         var_samp(l_extendedprice), stddev_samp(l_discount)
  from lineitem group by l_returnflag order by l_returnflag"""


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


@pytest.mark.parametrize("sql", P1_SQL)
def test_projected_constants_equal_reference_and_oracle(sql, port, engine,
                                                        oracle):
    assert port.execute(sql) == engine.execute(sql)
    assert_query(port, oracle, sql)


def test_a_scalar_literal_stays_0d():
    from presto_tpu_torch.exec import hostsync as HS
    before = HS.UPLOADS.total()
    t = HS.upload(np.asarray(7, np.int64), "cpu", "literal")
    assert t.shape == () and int(t) == 7
    assert HS.UPLOADS.total() - before == 1
    strided = HS.upload(np.arange(10)[::3], "cpu", "literal")
    assert strided.tolist() == [0, 3, 6, 9]


@pytest.mark.parametrize("sql", R6_SQL)
def test_division_by_a_literal_equals_oracle(sql, port, oracle):
    assert_query(port, oracle, sql)


@pytest.mark.parametrize("sql", NULL_SEMANTICS_SQL)
def test_null_semantics_equal_reference_and_oracle(sql, port, engine,
                                                   oracle):
    assert port.execute(sql) == engine.execute(sql)
    assert_query(port, oracle, sql)


@pytest.mark.parametrize("name", sorted(EXPRESSION_SQL))
def test_expressions_equal_oracle(name, port, oracle):
    assert len(port.execute(EXPRESSION_SQL[name])) > 0
    assert_query(port, oracle, EXPRESSION_SQL[name])


def test_greatest_least_equal_oracle(port, oracle):
    # sqlite spells greatest/least as its multi-argument max/min
    sql = """select greatest(n_nationkey, n_regionkey * 5),
                    least(n_nationkey, n_regionkey * 5, 7),
                    greatest(n_name, 'JAPAN'), least(o_totalprice, 1000.5)
             from nation, orders where n_nationkey = o_orderkey
             order by 1, 2, 3"""
    assert_query(port, oracle, sql, sqlite_sql=(
        sql.replace("greatest", "max").replace("least", "min")
))


def test_round_negative_digits(port, tpch_tiny):
    # round(x, -2) counts hundreds half away from zero (sqlite ignores
    # negative digits, so numpy holds the values here)
    got = port.execute("select o_orderkey, round(o_totalprice, -2) "
                       "from orders where o_orderkey < 200 order by 1")
    orders = tpch_tiny.table("orders")
    key = np.asarray(orders.columns["o_orderkey"].data)
    cents = np.asarray(orders.columns["o_totalprice"].data)[key < 200]
    want = np.sign(cents) * ((np.abs(cents) + 5000) // 10000) * 100
    order = np.argsort(key[key < 200])
    assert [float(r[1]) for r in got] == want[order].astype(float).tolist()


# -- tests/test_functions.py and tests/test_datetime.py -----------------------


def test_conditional_scalars(port, engine):
    sql = ("select greatest(1, 2, 3), least(4, 5, 6), "
           "nullif(1, 1), nullif(2, 1), coalesce(nullif(1, 1), 9)")
    assert port.execute(sql) == engine.execute(sql) == [(3, 4, None, 2, 9)]


def test_concat_two_string_columns(port, engine, oracle):
    sql = ("select concat(o_orderpriority, c_mktsegment) as c, "
           "count(*) as n from orders, customer "
           "where o_custkey = c_custkey "
           "group by o_orderpriority, c_mktsegment order by c")
    assert port.execute(sql) == engine.execute(sql)
    assert_query(port, oracle, sql)


def test_mod_negative_dividend_truncates(port, engine):
    sql = "select mod(-5, 3), mod(5, -3), mod(-5.0, 3.0), -5 % 3"
    assert port.execute(sql) == engine.execute(sql) == [(-2, 2, -2.0, -2)]


def test_mod_decimal_alignment(port, engine):
    sql = ("select mod(l_quantity, 7), l_quantity from lineitem "
           "where l_orderkey = 1 and l_linenumber = 1")
    (row,) = port.execute(sql)
    assert abs(row[0] - (row[1] % 7)) < 1e-9
    assert [row] == engine.execute(sql)


def test_cast_varchar_to_timestamp_and_date(port, engine):
    sql = ("select cast('2020-05-06 07:08:09' as timestamp), "
           "cast('2020-05-06' as date), cast('1969-12-31' as date)")
    [row] = port.execute(sql)
    assert row == (np.datetime64("2020-05-06T07:08:09", "us"),
                   np.datetime64("2020-05-06"), np.datetime64("1969-12-31"))
    assert [row] == engine.execute(sql)


def test_malformed_varchar_casts_are_null(port):
    [row] = port.execute("select cast(r_comment as date), "
                         "cast(r_comment as timestamp) from region "
                         "where r_regionkey = 0")
    assert row == (None, None)


# -- the variance family -------------------------------------------------------


def test_variance_family_vs_numpy(port, tpch_tiny):
    li = tpch_tiny.table("lineitem")
    rf = np.asarray(li.columns["l_returnflag"].dictionary)[
        np.asarray(li.columns["l_returnflag"].data)]
    q = np.asarray(li.columns["l_quantity"].data) / 100.0
    price = np.asarray(li.columns["l_extendedprice"].data) / 100.0
    disc = np.asarray(li.columns["l_discount"].data) / 100.0
    rows = port.execute(VARIANCE_SQL)
    assert len(rows) == len(np.unique(rf))
    for row in rows:
        m = rf == row[0]
        x = q[m]
        np.testing.assert_allclose(row[1:], [
            np.std(x, ddof=1), np.std(x), np.var(x, ddof=1), np.var(x),
            np.var(price[m], ddof=1), np.std(disc[m], ddof=1)],
            rtol=1e-9)


def test_variance_family_equals_oracle(port, oracle):
    # sqlite has no variance: the oracle computes it from its moments
    got = port.execute(
        "select var_pop(n_nationkey), stddev_samp(n_nationkey) from nation")
    want = oracle.query(
        "select avg(n_nationkey * n_nationkey) - avg(n_nationkey) * "
        "avg(n_nationkey), count(*) from nation")
    var_pop, n = want[0]
    np.testing.assert_allclose(got[0], [var_pop, np.sqrt(
        var_pop * n / (n - 1))], rtol=1e-12)


def test_variance_of_less_than_two_rows_is_null(port, engine):
    sql = ("select var_samp(l_quantity), stddev_samp(l_quantity), "
           "var_pop(l_quantity) from lineitem where l_orderkey < 0")
    assert port.execute(sql) == engine.execute(sql) == [(None, None, None)]
    one = port.execute("select var_samp(l_quantity), var_pop(l_quantity) "
                       "from lineitem where l_orderkey = 1 "
                       "and l_linenumber = 1")
    assert one == [(None, 0.0)]


def test_variance_numerically_stable_with_large_mean(port):
    got = port.execute("select var_pop(l_orderkey + 1000000000), "
                       "var_pop(l_orderkey) from lineitem")
    shifted, plain = got[0]
    assert plain > 0
    assert abs(shifted - plain) / plain < 1e-6, (shifted, plain)


VAR_FNS = sorted(PA.VAR_FNS)


def _var_inputs(n=3000, k=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(1e4, 3.0, n)  # mean >> spread
    w = rng.random(n) > 0.25
    slots = rng.integers(0, k // 2, n).astype(np.int32)  # upper half empty
    slots[:3] = [0, 0, 1]
    w[:3] = [True, False, True]
    return x, w, slots, k


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("fn", VAR_FNS)
def test_fold_merge_finalize_match_reference(fn):
    x, w, slots, k = _var_inputs(seed=len(fn))
    px = PA.prepare_arg(fn, _t(x), None)
    rx = RA.prepare_arg(fn, jnp.asarray(x), None)
    got = PA.fold(fn, px, _t(w), _t(slots), k)
    want = RA.fold(fn, rx, jnp.asarray(w), jnp.asarray(slots), k)
    assert set(got) == set(want) == {"count", "sum", "m2"}
    for f in want:
        _close(got[f], want[f])
    # the k slot states merge into 4 groups (partial -> final)
    to = (np.arange(k) % 4).astype(np.int32)
    live = np.arange(k) < k - 3
    mg = PA.merge(fn, got, _t(to), 4, _t(live))
    mw = RA.merge(fn, want, jnp.asarray(to), 4, jnp.asarray(live))
    for f in mw:
        _close(mg[f], mw[f])
    data, valid = PA.finalize(fn, mg, None, None)
    rdata, rvalid = RA.finalize(fn, mw, None, None)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    _close(torch.where(valid, data, 0.0), np.where(rvalid, rdata, 0.0))


@pytest.mark.parametrize("fn", VAR_FNS)
def test_scan_fold_and_merge_match_reference(fn):
    from presto_tpu.ops import hash as RH
    from presto_tpu_torch.ops import hash as PH
    x, w, slots, _k = _var_inputs(seed=7 + len(fn))
    keys = slots.astype(np.int64)
    pg = PH.SortedGroups(PH.hash_int_column(_t(keys)), _t(w))
    rg = RH.SortedGroups(RH.hash_int_column(jnp.asarray(keys)),
                         jnp.asarray(w))
    perm = pg.sidx.numpy().astype(np.int64)
    np.testing.assert_array_equal(perm, np.asarray(rg.sidx))
    px = PA.prepare_arg(fn, _t(x[perm]), None)
    got = PA.scan_fold(fn, px, _t(w[perm]), pg)
    want = RA.scan_fold(fn, jnp.asarray(x[perm]), jnp.asarray(w[perm]), rg)
    last = pg.is_last.numpy()
    for f in want:
        _close(got[f][last], np.asarray(want[f])[last])
    mg = PA.scan_merge(fn, got, pg.live, pg)
    mw = RA.scan_merge(fn, want, rg.live, rg)
    for f in mw:
        _close(mg[f][last], np.asarray(mw[f])[last])
