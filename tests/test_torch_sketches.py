"""presto_tpu_torch's value hashes and the aggregates of ROADMAP Queue 1
item 3d against presto_tpu on the CPU:

- ``ops/hash.splitmix64`` and ``value_hash`` equal the reference's
  ``_splitmix64`` and ``expr/aggregates._value_hash`` bit for bit over
  int64, int32, bool, date, short-decimal and float64 columns (+-0.0,
  NaN, +-inf, values past the f32 range);
- for each of the 17 aggregates (count_if, bool_and, bool_or, every,
  skewness, kurtosis, geometric_mean, checksum, min_by, max_by, corr,
  covar_samp, covar_pop, regr_slope, regr_intercept, approx_distinct,
  approx_percentile), fold, merge and finalize (and scan_fold and
  scan_merge where the reference's SCAN_FNS has them) equal the
  reference's on the same numpy inputs: exactly for integer, register,
  reservoir and checksum states, within a relative 1e-12 for float
  states;
- the SQL of the local aggregate tests of tests/test_functions.py,
  through presto_tpu_torch.Engine(device="cpu") at SF0.01, against
  presto_tpu, numpy or python. min_by/max_by name a row that attains
  the extremum (SQL allows any), equal to the reference only where the
  key is unique; a tie keeps value and validity from one row, the same
  row on every run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.expr import aggregates as RA
from presto_tpu.ops import hash as RH
from presto_tpu_torch import Engine as TorchEngine
from presto_tpu_torch import types as PT
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector as TorchTpch
from presto_tpu_torch.expr import aggregates as PA
from presto_tpu_torch.ops import hash as PH


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


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    """A state as numpy; uint64 hashes as their int64 bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


# -- the value hashes ---------------------------------------------------------


def _hash_columns(seed=0, n=512):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1e6, n)
    f[:12] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e300, -1e300,
              3.5e38, 1e-320, 1.0, -1.5]
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    i64[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    return {"int64": i64,
            "int32": rng.integers(-(1 << 31), (1 << 31) - 1, n)
            .astype(np.int32),
            "bool": rng.random(n) > 0.5,
            # epoch days, before and after 1970
            "date": rng.integers(-40000, 80000, n).astype(np.int32),
            # decimal(12, 2) in cents
            "short_decimal": rng.integers(-10**12, 10**12, n),
            "float64": f}


@pytest.mark.parametrize("kind", sorted(_hash_columns()))
def test_value_hash_equals_reference(kind):
    x = _hash_columns()[kind]
    want = np.asarray(RA._value_hash(jnp.asarray(x))).view(np.int64)
    np.testing.assert_array_equal(PH.value_hash(_t(x)).numpy(), want)


def test_splitmix64_equals_reference():
    x = _hash_columns()["int64"]
    want = np.asarray(RH._splitmix64(jnp.asarray(x.view(np.uint64))))
    np.testing.assert_array_equal(PH.splitmix64(_t(x)).numpy(),
                                  want.view(np.int64))


# -- fold / merge / finalize against the reference ---------------------------

N, K = 1000, 64


def _agg_inputs(fn: str, seed: int, n: int = N):
    """(data, data2, data_valid, weight, slots) numpy inputs for ``fn``
    (``n`` rows); slots fill the lower half of K, so the upper half
    stays empty."""
    N = n
    rng = np.random.default_rng(seed)
    w = rng.random(N) > 0.2
    slots = rng.integers(0, K // 2, N).astype(np.int32)
    data2 = data_valid = None
    if fn == "count_if" or fn in PA.BOOL_FNS:
        data = rng.random(N) > (0.1 if fn != "bool_or" else 0.97)
    elif fn in ("approx_distinct", "checksum"):
        data = rng.integers(0, 700, N).astype(np.int64)
    elif fn == "approx_percentile":
        data = np.round(rng.normal(5e4, 1e4, N), 2)
    elif fn in PA.BY_FNS:
        data = rng.integers(-1000, 1000, N).astype(np.int64)
        data2 = rng.permutation(N).astype(np.int64) * 7 - 9000  # unique
        data_valid = rng.random(N) > 0.1
    elif fn in PA.COVAR_FNS:
        data2 = rng.normal(1e3, 30.0, N)
        data = 0.5 * data2 + rng.normal(0, 5.0, N)
    else:  # moments, geometric_mean: positive, mean >> spread
        data = rng.normal(1e4, 40.0, N)
    return data, data2, data_valid, w, slots


def _prepared(fn, data, data2):
    pd = PA.prepare_arg(fn, _t(data), None)
    rd = RA.prepare_arg(fn, jnp.asarray(data), None)
    if data2 is None:
        return pd, rd, None, None
    return (pd, rd, PA.prepare_arg2(fn, _t(data2), None),
            RA.prepare_arg2(fn, jnp.asarray(data2), None))


def _same_states(got: dict, want: dict, rows=None, rtol=1e-12):
    assert set(got) == set(want)
    for f in want:
        g, r = _np(got[f]), _np(want[f])
        if rows is not None:
            g, r = g[rows], r[rows]
        if r.dtype.kind in "iub":  # counts, extrema, sketches, checksums
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol,
                                       err_msg=f)


def _same_final(fn, got, want, out_type=None):
    (gd, gv), (rd, rv) = got, want
    gv = None if gv is None else gv.numpy()
    rv = None if rv is None else np.asarray(rv)
    if rv is None:
        assert gv is None
        keep = slice(None)
    else:
        np.testing.assert_array_equal(gv, rv)
        keep = rv
    gd, rd = _np(gd)[keep], _np(rd)[keep]
    if gd.dtype.kind == "f":
        np.testing.assert_allclose(gd, rd, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(gd, rd)


AGG_FNS = sorted(PA.BOOL_FNS | PA.MOMENT_FNS | PA.COVAR_FNS | PA.BY_FNS
                 | {"count_if", "geometric_mean", "checksum",
                    "approx_distinct", "approx_percentile"})


def test_every_reference_aggregate_is_ported():
    assert len(AGG_FNS) == 17
    import presto_tpu.plan.planner as RP
    fns = set(RP.AGG_FUNCTIONS) - RA.VARLEN_FNS - {"grouping"}
    assert fns <= PA.PORTED_FNS | {"count_star"}


@pytest.mark.parametrize("fn", AGG_FNS)
def test_fold_merge_finalize_equal_reference(fn):
    data, data2, dvalid, w, slots = _agg_inputs(fn, seed=len(fn))
    pd, rd, pd2, rd2 = _prepared(fn, data, data2)
    param = 0.3 if fn == "approx_percentile" else None
    got = PA.fold(fn, pd, _t(w), _t(slots), K, data2=pd2,
                  data_valid=None if dvalid is None else _t(dvalid),
                  param=param)
    want = RA.fold(fn, rd, jnp.asarray(w), jnp.asarray(slots), K,
                   data2=rd2,
                   data_valid=None if dvalid is None
                   else jnp.asarray(dvalid), param=param)
    _same_states(got, want)
    # the K slot states merge into 4 groups (partial -> final), the
    # last three partial rows dead
    to = (np.arange(K) % 4).astype(np.int32)
    live = np.arange(K) < K - 3
    mg = PA.merge(fn, got, _t(to), 4, _t(live))
    mw = RA.merge(fn, want, jnp.asarray(to), 4, jnp.asarray(live))
    _same_states(mg, mw)
    out_type = PT.DOUBLE if fn == "approx_percentile" else None
    _same_final(fn, PA.finalize(fn, mg, out_type, None, param=param),
                RA.finalize(fn, mw, out_type, None, param=param))
    _same_final(fn, PA.finalize(fn, got, out_type, None, param=param),
                RA.finalize(fn, want, out_type, None, param=param))


@pytest.mark.parametrize("fn", sorted(set(AGG_FNS) & PA.SCAN_FNS))
def test_scan_fold_and_merge_equal_reference(fn):
    # fewer rows: the reference's scans compile one program a round
    data, data2, dvalid, w, slots = _agg_inputs(fn, seed=7 + len(fn),
                                                n=300)
    keys = slots.astype(np.int64)
    pg = PH.SortedGroups(PH.hash_int_column(_t(keys)), _t(w))
    rg = RH.SortedGroups(RH.hash_int_column(jnp.asarray(keys)),
                         jnp.asarray(w))
    perm = pg.sidx.numpy().astype(np.int64)
    np.testing.assert_array_equal(perm, np.asarray(rg.sidx))

    def sort(a):
        return None if a is None else a[perm]
    pd, rd, pd2, rd2 = _prepared(fn, sort(data), sort(data2))
    dv = sort(dvalid)
    got = PA.scan_fold(fn, pd, _t(w[perm]), pg, data2=pd2,
                       data_valid=None if dv is None else _t(dv))
    want = RA.scan_fold(fn, rd, jnp.asarray(w[perm]), rg, data2=rd2,
                        data_valid=None if dv is None else jnp.asarray(dv))
    # a scan state is the difference of two running sums, so its float
    # rounding scales with the running total, not the group's value:
    # float states within a relative 1e-9 here (as the variance family's
    # in tests/test_torch_expressions.py)
    last = pg.is_last.numpy()
    _same_states(got, want, last, rtol=1e-9)
    mg = PA.scan_merge(fn, got, pg.live, pg)
    mw = RA.scan_merge(fn, want, rg.live, rg)
    _same_states(mg, mw, last, rtol=1e-9)


@pytest.mark.parametrize("fn", ["approx_distinct", "approx_percentile"])
def test_sketch_capacity_limit_is_the_reference_s(fn):
    data, _, _, w, slots = _agg_inputs(fn, 0)
    x = PA.prepare_arg(fn, _t(data), None)
    with pytest.raises(ValueError):
        PA.fold(fn, x, _t(w), _t(slots), 1 << 21)


def test_min_by_ties_take_one_row():
    """Every key ties within its slot: the winner is the lowest row
    index attaining the extremum, its value and validity from that one
    row, on every run."""
    rng = np.random.default_rng(3)
    n = 3000
    slots = rng.integers(0, 8, n).astype(np.int32)
    key = rng.integers(0, 3, n).astype(np.int64)  # many ties
    x = np.arange(n, dtype=np.int64) * 10
    x_ok = rng.random(n) > 0.5
    w = rng.random(n) > 0.1
    for fn, best in (("min_by", np.min), ("max_by", np.max)):
        runs = [PA.fold(fn, _t(x), _t(w), _t(slots), 8, data2=_t(key),
                        data_valid=_t(x_ok)) for _ in range(2)]
        for f in runs[0]:
            np.testing.assert_array_equal(runs[0][f].numpy(),
                                          runs[1][f].numpy())
        for s in range(8):
            rows = np.nonzero(w & (slots == s))[0]
            ext = best(key[rows])
            first = rows[key[rows] == ext][0]
            assert runs[0]["val"][s] == ext
            assert runs[0]["xval"][s] == x[first]
            assert bool(runs[0]["xok"][s]) == bool(x_ok[first])


# -- SQL (tests/test_functions.py) -------------------------------------------

AGG_SQL = """
  select l_returnflag,
         stddev(l_quantity) as sd, stddev_pop(l_quantity) as sdp,
         variance(l_quantity) as v, var_pop(l_quantity) as vp,
         geometric_mean(l_quantity) as gm,
         count_if(l_quantity > 25) as ci,
         bool_and(l_quantity > 0) as ba, bool_or(l_quantity > 49) as bo,
         approx_distinct(l_suppkey) as ad
  from lineitem group by l_returnflag order by l_returnflag"""


def _lineitem(conn):
    li = conn.table("lineitem").columns
    rf = np.asarray(li["l_returnflag"].dictionary)[
        np.asarray(li["l_returnflag"].data)]
    return (rf, np.asarray(li["l_quantity"].data) / 100.0,
            np.asarray(li["l_extendedprice"].data) / 100.0,
            np.asarray(li["l_orderkey"].data),
            np.asarray(li["l_suppkey"].data))


def test_statistical_aggregates_vs_numpy(port, engine, tpch_tiny):
    rows = port.execute(AGG_SQL)
    rf, q, _p, _k, sup = _lineitem(tpch_tiny)
    assert len(rows) == len(np.unique(rf))
    for row in rows:
        m = rf == row[0]
        x = q[m]
        np.testing.assert_allclose(row[1:6], [
            np.std(x, ddof=1), np.std(x), np.var(x, ddof=1), np.var(x),
            np.exp(np.mean(np.log(x)))], rtol=1e-9)
        assert row[6] == int((x > 25).sum())
        assert row[7] == bool((x > 0).all())
        assert row[8] == bool((x > 49).any())
        exact = len(np.unique(sup[m]))
        assert abs(row[9] - exact) <= max(0.1 * exact, 2), (row[9], exact)
    # the exact columns (counts, bools, HLL estimates) equal the reference
    want = engine.execute(AGG_SQL)
    assert [r[:1] + r[6:] for r in rows] == [r[:1] + r[6:] for r in want]


def test_variance_of_less_than_two_rows_is_null(port, engine):
    sql = ("select var_samp(l_quantity), stddev_samp(l_quantity), "
           "var_pop(l_quantity), skewness(l_quantity), "
           "corr(l_quantity, l_tax), min_by(l_orderkey, l_quantity), "
           "approx_percentile(l_quantity, 0.5), count_if(l_tax > 0), "
           "bool_and(l_tax > 0) from lineitem where l_orderkey < 0")
    assert port.execute(sql) == engine.execute(sql) == [
        (None,) * 7 + (0, None)]


def test_approx_distinct_near_exact(port, engine):
    sql = ("select approx_distinct(l_suppkey), count(distinct l_suppkey), "
           "approx_distinct(l_orderkey), count(distinct l_orderkey) "
           "from lineitem")
    got = port.execute(sql)
    for est, exact in (got[0][:2], got[0][2:]):
        assert abs(est - exact) <= max(0.1 * exact, 2), (est, exact)
    assert got == engine.execute(sql)


SKETCH_SQL = [
    "select approx_distinct(l_partkey), approx_distinct(l_extendedprice), "
    "approx_distinct(l_shipdate), approx_distinct(cast(l_tax as double)), "
    "checksum(l_orderkey), checksum(l_comment), checksum(l_shipdate), "
    "approx_percentile(l_extendedprice, 0.25), "
    "approx_percentile(l_quantity, 0.9) from lineitem",
    "select l_linestatus, approx_distinct(l_partkey), checksum(l_suppkey), "
    "approx_percentile(l_discount, 0.5), "
    "checksum(case when l_linenumber = 2 then null else l_partkey end) "
    "from lineitem group by 1 order by 1",
    # the sorted-groups path: sketches fold by segment ops over its slots
    "select l_linenumber, approx_distinct(l_partkey), "
    "approx_percentile(l_extendedprice, 0.75), checksum(l_partkey) "
    "from lineitem group by 1 order by 1",
    # 2000 groups: the port's sketch capacity climbs its ladder from 512
    "select l_partkey, approx_distinct(l_suppkey), "
    "approx_percentile(l_quantity, 0.5), checksum(l_orderkey) "
    "from lineitem group by 1 order by 1",
]


@pytest.mark.parametrize("sql", SKETCH_SQL)
def test_sketches_and_checksum_equal_reference(port, engine, sql):
    assert port.execute(sql) == engine.execute(sql)


def test_covariance_family_vs_numpy(port, tpch_tiny):
    _rf, q, p, _k, _s = _lineitem(tpch_tiny)
    (row,) = port.execute(
        "select corr(l_quantity, l_extendedprice), "
        "covar_pop(l_quantity, l_extendedprice), "
        "covar_samp(l_quantity, l_extendedprice), "
        "regr_slope(l_quantity, l_extendedprice), "
        "regr_intercept(l_quantity, l_extendedprice) from lineitem")
    slope, intercept = np.polyfit(p, q, 1)
    want = (np.corrcoef(q, p)[0, 1], np.cov(q, p, bias=True)[0, 1],
            np.cov(q, p)[0, 1], slope, intercept)
    for got, exp in zip(row, want):
        assert abs(got - exp) <= 1e-9 * max(1.0, abs(exp)), (got, exp)


def test_grouped_covariance_equals_reference(port, engine):
    sql = ("select l_returnflag, corr(l_quantity, l_extendedprice), "
           "covar_samp(l_quantity, l_extendedprice), "
           "regr_intercept(l_tax, l_discount) from lineitem "
           "group by l_returnflag order by l_returnflag")
    got, want = port.execute(sql), engine.execute(sql)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want],
                               rtol=1e-9)


def test_min_by_max_by(port, tpch_tiny):
    _rf, _q, p, k, _s = _lineitem(tpch_tiny)
    (row,) = port.execute(
        "select min_by(l_orderkey, l_extendedprice), "
        "max_by(l_orderkey, l_extendedprice) from lineitem")
    # ties allow any attaining row
    assert row[0] in set(k[p == p.min()])
    assert row[1] in set(k[p == p.max()])


def test_min_by_unique_key_equals_reference(port, engine):
    # (l_orderkey, l_linenumber) is unique: one row attains each extremum
    sql = ("select l_returnflag, "
           "min_by(l_comment, l_orderkey * 10 + l_linenumber), "
           "max_by(l_shipdate, l_orderkey * 10 + l_linenumber) "
           "from lineitem group by 1 order by 1")
    assert port.execute(sql) == engine.execute(sql)


def test_min_by_null_key_rows_ignored(tpch_tiny):
    """Rows whose key is NULL are skipped; a NULL x of the winning row
    is returned."""
    _rf, _q, p, k, _s = _lineitem(tpch_tiny)
    ln = np.asarray(tpch_tiny.table("lineitem").columns["l_linenumber"]
                    .data)
    m = k < 200
    mem = MemoryConnector()
    mem.create_table("minby_t", {"x": PT.BIGINT, "y": PT.DOUBLE},
                     {"x": k[m], "y": p[m]},
                     {"x": None, "y": ln[m] != 1})
    e = TorchEngine(device="cpu")
    e.register_catalog("memory", mem)
    e.session.catalog = "memory"
    (row,) = e.execute("select min_by(x, y), max_by(x, y) from minby_t")
    keep = m & (ln != 1)
    assert row[0] in set(k[keep & (p == p[keep].min())])
    assert row[1] in set(k[keep & (p == p[keep].max())])


def test_checksum_order_invariant(port):
    a = port.execute("select checksum(l_partkey) from lineitem")[0][0]
    b = port.execute("select checksum(l_partkey) from "
                     "(select l_partkey from lineitem order by "
                     "l_extendedprice)")[0][0]
    assert a == b
    assert a != port.execute("select checksum(l_suppkey) from lineitem")[0][0]


def test_approx_percentile_rank_error(port, tpch_tiny):
    _rf, _q, p, _k, _s = _lineitem(tpch_tiny)
    (row,) = port.execute(
        "select approx_percentile(l_extendedprice, 0.5), "
        "approx_percentile(l_extendedprice, 0.9) from lineitem")
    for got, target in zip(row, (0.5, 0.9)):
        rank = (p <= got).mean()
        assert abs(rank - target) < 0.06, (got, rank, target)


def test_approx_percentile_grouped_median(port):
    rows = port.execute(
        "select l_returnflag, approx_percentile(l_quantity, 0.5) "
        "from lineitem group by l_returnflag order by l_returnflag")
    for _, med in rows:
        assert 20 <= med <= 30  # uniform 1..50 per group


def test_aggregate_filter_clause(port, engine):
    sql = ("select sum(n_nationkey) filter (where n_regionkey = 0), "
           "count(*) filter (where n_regionkey = 1), "
           "count_if(n_nationkey > 3) filter (where n_regionkey = 2), "
           "bool_or(n_nationkey > 20) filter (where n_regionkey = 3), "
           "count(*) from nation")
    assert port.execute(sql) == engine.execute(sql)


def test_skewness_kurtosis_vs_scipy_formulas(port, tpch_tiny):
    rows = port.execute(
        "select l_returnflag, skewness(l_extendedprice), "
        "kurtosis(l_extendedprice) from lineitem "
        "group by l_returnflag order by l_returnflag")
    rf, _q, price, _k, _s = _lineitem(tpch_tiny)
    for flag, skew, kurt in rows:
        x = price[rf == flag]
        n = len(x)
        d = x - x.mean()
        m2, m3, m4 = (d**2).sum(), (d**3).sum(), (d**4).sum()
        want_skew = np.sqrt(n) * m3 / m2**1.5
        d23 = (n - 2) * (n - 3)
        want_kurt = ((n - 1) * n * (n + 1)) / d23 * m4 / m2**2 \
            - 3 * (n - 1) ** 2 / d23
        assert abs(skew - want_skew) < 1e-6 * max(1, abs(want_skew))
        assert abs(kurt - want_kurt) < 1e-6 * max(1, abs(want_kurt))


def test_moments_small_groups_null(port, engine):
    sql = ("select skewness(n_nationkey), kurtosis(n_nationkey) "
           "from nation where n_nationkey < 2")  # n = 2
    assert port.execute(sql) == engine.execute(sql) == [(None, None)]


def test_long_decimal_moments_raise(port):
    with pytest.raises(NotImplementedError, match="long decimals"):
        port.execute("select skewness(l_quantity * l_extendedprice) "
                     "from lineitem")


STREAMED_SQL = """
  select l_returnflag, l_linestatus, count_if(l_discount > 0.05),
         bool_and(l_quantity < 50), bool_or(l_tax = 0),
         every(l_shipdate < l_receiptdate), approx_distinct(l_partkey),
         min_by(l_orderkey, l_extendedprice),
         max_by(l_orderkey, l_extendedprice), checksum(l_orderkey),
         approx_percentile(l_extendedprice, 0.5),
         corr(l_quantity, l_extendedprice), skewness(l_discount),
         geometric_mean(l_quantity)
  from lineitem group by 1, 2 order by 1, 2"""


def test_streamed_partials_merge_like_one_fold(port, tpch_tiny):
    """lineitem in blocks of 16384 rows, each a PARTIAL aggregate: the
    merged integer and sketch states equal one whole-table fold (the
    min_by winner is the lowest row either way); float states within
    1e-9; the percentile, whose row decorrelation restarts per block,
    within its rank error."""
    whole = port.execute(STREAMED_SQL)
    block = port.session.get("scan_block_rows")
    port.session.set("scan_block_rows", 16384)
    try:
        streamed = port.execute(STREAMED_SQL)
        assert port.last_streamed_blocks > 1
    finally:
        port.session.set("scan_block_rows", block)
    assert [r[:10] for r in streamed] == [r[:10] for r in whole]
    np.testing.assert_allclose([r[11:] for r in streamed],
                               [r[11:] for r in whole], rtol=1e-9)
    _rf, _q, p, _k, _s = _lineitem(tpch_tiny)
    for r in streamed:
        assert abs(float(r[10]) - float(np.median(p))) < 0.2 * np.median(p)
