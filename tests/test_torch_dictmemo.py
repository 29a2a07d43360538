"""The host dictionary memo (presto_tpu_torch/expr/dictmemo.py): every
memoized union, merge, alignment and keyed string transform equals a
fresh computation (the algorithm the operators ran on every query
before the memo, written out here), a second derivation hits and
returns the same objects, small dictionaries hit by content, entries go
with their dictionary and in LRU order past the bound, and two threads
get equal results. Then TPC-DS q27 (a rollup: a Union over strings)
and q19 (``substr`` on both sides of ``<>``) run twice in one engine,
rows equal to the reference engine's both times, the second run all
hits."""

import gc
import sys
import threading

import numpy as np
import pytest
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch.expr import compile as EC
from presto_tpu_torch.expr import dictmemo as DM
from presto_tpu_torch.expr import ir
from presto_tpu_torch.obs.metrics import REGISTRY

COUNTER = REGISTRY.counter("presto_tpu_dictionary_memo_total")
KINDS = ("union", "merge", "align", "transform")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel, and torch's default of one
    OpenMP thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_memo():
    DM.MEMO.clear()
    yield
    DM.MEMO.clear()


def counts(result: str) -> dict:
    return {k: COUNTER.value(kind=k, result=result) for k in KINDS}


def moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in KINDS if after[k] != before[k]}


def obj(strings) -> np.ndarray:
    return np.array(list(strings), dtype=object)


def sorted_dict(strings) -> np.ndarray:
    return obj(sorted(set(strings)))


def random_words(rng, n, alphabet="abcxyz", lo=0, hi=12):
    return ["".join(rng.choice(list(alphabet), size=int(k)))
            for k in rng.integers(lo, hi, size=n)]


def _cases():
    """Named lists of dictionaries (each an object array, as a Val
    carries it): unsorted, duplicated, empty, single-string, empty-string,
    non-ASCII and suffix-only dictionaries."""
    rng = np.random.default_rng(20261019)
    big = sorted_dict(random_words(rng, 400))
    other = sorted_dict(random_words(rng, 300))
    return {
        "sorted-large": [big, other],
        "sorted-large-twice-and-null": [big, big, obj([""])],
        "unsorted": [obj(random_words(rng, 90)), obj(random_words(rng, 80))],
        "duplicated": [obj(["b", "a", "b", "a", "c"] * 20),
                       obj(["c", "c", "d"])],
        "empty": [obj([]), sorted_dict(["x", "y"])],
        "both-empty": [obj([]), obj([])],
        "single": [obj(["only"]), sorted_dict(random_words(rng, 100))],
        "empty-string": [obj(["", "a", "b"]), obj([""])],
        "non-ascii": [sorted_dict(["é", "ü", "日本", "a", "Z", "ß"] +
                                  random_words(rng, 70, "éüß日本ab")),
                      sorted_dict(["日", "é", "e"])],
        "suffix-only": [sorted_dict(["abc", "abcd", "abcde", "abc "]),
                        sorted_dict(["abcd", "abcdef", "ab"])],
    }


CASES = _cases()


# --- the algorithms before the memo, written out ---------------------------


def fresh_union(dicts):
    union = np.unique(np.concatenate([d.astype("U") for d in dicts]))
    return union.astype(object), [
        np.searchsorted(union, d.astype("U")).astype(np.int32)
        for d in dicts]


def fresh_align(a, b):
    idx = np.searchsorted(b, a.astype("U"))
    idx = np.clip(idx, 0, max(len(b) - 1, 0))
    ok = (b.astype("U")[idx] == a.astype("U")) if len(b) \
        else np.zeros(len(a), bool)
    return np.where(ok, idx, -1).astype(np.int32)


def fresh_transform(d, fn):
    new_strings = fn(d.astype("U")).astype(object)
    new_dict, inverse = np.unique(new_strings.astype("U"),
                                  return_inverse=True)
    return new_dict.astype(object), inverse.astype(np.int32)


def same_array(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and \
        list(x.tolist()) == list(y.tolist())


def column(d: np.ndarray, rows: int = 37, seed: int = 1) -> EC.Val:
    """A VARCHAR column over ``d``: every code at least once."""
    rng = np.random.default_rng(seed)
    codes = np.concatenate([np.arange(len(d)),
                            rng.integers(0, max(len(d), 1), rows)])
    codes = codes[:len(d) + rows] if len(d) else np.zeros(0, np.int64)
    return EC.Val(T.VARCHAR, torch.from_numpy(codes.astype(np.int32)),
                  None, d)


def strings_of(v: EC.Val) -> list:
    return [v.dictionary[c] for c in v.data.tolist()]


# --- each derivation against its fresh computation -------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_union_equals_fresh_and_hits(case):
    dicts = CASES[case]
    want_u, want_r = fresh_union(dicts)
    got_u, got_r = DM.union(dicts)
    assert same_array(got_u, want_u)
    assert all(same_array(g, w) for g, w in zip(got_r, want_r))
    before = counts("hit")
    again_u, again_r = DM.union(dicts)
    assert moved(before, counts("hit")) == {"union": 1}
    assert again_u is got_u and all(a is g for a, g in zip(again_r, got_r))
    assert not got_u.flags.writeable
    assert not any(r.flags.writeable for r in got_r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_unify_string_vals_equals_fresh(case):
    dicts = CASES[case]
    vals = [column(d, seed=i) for i, d in enumerate(dicts)]
    want = [strings_of(v) for v in vals]
    first = OP._unify_string_vals(vals)
    misses = counts("miss")
    second = OP._unify_string_vals(vals)
    assert moved(misses, counts("miss")) == {}
    for f, s, w in zip(first, second, want):
        assert strings_of(f) == w and strings_of(s) == w
        assert s.dictionary is f.dictionary is first[0].dictionary
        assert torch.equal(f.data, s.data)
    want_u, want_r = fresh_union(dicts)
    assert same_array(first[0].dictionary, want_u)
    for v, f, r in zip(vals, first, want_r):
        assert f.data.tolist() == r[v.data.long().numpy()].tolist()


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_dicts_equals_fresh(case):
    a, b = CASES[case][0], CASES[case][-1]
    va, vb = column(a, seed=3), column(b, seed=4)
    ma, mb = EC._merge_dicts(va, vb)
    want_u, (ra, rb) = fresh_union([a, b])
    assert same_array(ma.dictionary, want_u)
    assert ma.dictionary is mb.dictionary
    assert ma.data.tolist() == ra[va.data.long().numpy()].tolist()
    assert mb.data.tolist() == rb[vb.data.long().numpy()].tolist()
    before = counts("hit")
    ma2, mb2 = EC._merge_dicts(va, vb)
    assert moved(before, counts("hit")) == {"merge": 1}
    assert ma2.dictionary is ma.dictionary
    assert torch.equal(ma2.data, ma.data) and torch.equal(mb2.data, mb.data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_equals_fresh_and_hits(case):
    a, b = CASES[case][0], CASES[case][-1]
    want = fresh_align(a, b)
    got = DM.align(a, b)
    assert same_array(got, want) and not got.flags.writeable
    before = counts("hit")
    assert DM.align(a, b) is got
    assert moved(before, counts("hit")) == {"align": 1}
    va, vb = column(a, seed=5), column(b, seed=6)
    da, db = EC._align_strings(va, vb)
    assert da.tolist() == want[va.data.long().numpy()].tolist()
    assert db is vb.data


# every keyed transform: (function, extra literal arguments, the
# transform written out over a unicode array)
TRANSFORMS = {
    "substring": ("substring", (ir.Literal(T.BIGINT, 2),
                                ir.Literal(T.BIGINT, 3)),
                  lambda d: np.array([s[1:4] for s in d], object)),
    "substring-to-end": ("substring", (ir.Literal(T.BIGINT, 3),),
                         lambda d: np.array([s[2:] for s in d], object)),
    "lower": ("lower", (), lambda d: np.char.lower(d).astype(object)),
    "upper": ("upper", (), lambda d: np.char.upper(d).astype(object)),
    "trim": ("trim", (), np.char.strip),
    "ltrim": ("ltrim", (), np.char.lstrip),
    "rtrim": ("rtrim", (), np.char.rstrip),
    "reverse": ("reverse", (),
                lambda d: np.array([s[::-1] for s in d], object)),
    "replace": ("replace", (ir.Literal(T.VARCHAR, "b"),
                            ir.Literal(T.VARCHAR, "XY")),
                lambda d: np.char.replace(d, "b", "XY") if len(d) else d),
    "lpad": ("lpad", (ir.Literal(T.BIGINT, 5), ir.Literal(T.VARCHAR, "*")),
             lambda d: np.array([s.rjust(5, "*")[:5] for s in d], object)),
    "rpad": ("rpad", (ir.Literal(T.BIGINT, 4), ir.Literal(T.VARCHAR, "-")),
             lambda d: np.array([s.ljust(4, "-")[:4] for s in d], object)),
    "translate": ("translate", (ir.Literal(T.VARCHAR, "abé"),
                                ir.Literal(T.VARCHAR, "x")),
                  lambda d: np.array([s.translate({ord("a"): "x",
                                                   ord("b"): None,
                                                   ord("é"): None})
                                      for s in d], object)),
}


def run_transform(name: str, d: np.ndarray) -> tuple[EC.Val, EC.Val]:
    fn, extra, _ = TRANSFORMS[name]
    v = column(d, seed=7)
    call = ir.Call(T.VARCHAR, fn, (ir.ColumnRef(T.VARCHAR, "s"),) + extra)
    return v, EC.ExprCompiler({"s": v}, "cpu").compile(call)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_keyed_transform_equals_fresh_and_hits(name, case):
    d = CASES[case][0]
    want_d, want_inv = fresh_transform(d, TRANSFORMS[name][2])
    v, out = run_transform(name, d)
    assert same_array(out.dictionary, want_d)
    assert out.data.tolist() == want_inv[v.data.long().numpy()].tolist()
    before = counts("hit")
    _, again = run_transform(name, d)
    assert moved(before, counts("hit")) == {"transform": 1}
    assert again.dictionary is out.dictionary
    assert not out.dictionary.flags.writeable
    assert torch.equal(again.data, out.data)


def test_a_transform_without_a_key_is_not_memoized():
    d = CASES["sorted-large"][0]
    before = counts("hit"), counts("miss")
    u1, inv1 = DM.transform(d, np.char.upper)
    u2, inv2 = DM.transform(d, np.char.upper)
    assert (counts("hit"), counts("miss")) == before and len(DM.MEMO) == 0
    assert u1 is not u2 and same_array(u1, u2) and same_array(inv1, inv2)


def test_a_derivation_on_a_memo_output_hits_by_identity():
    # q19's shape: substr on both sides, then the two outputs aligned
    rng = np.random.default_rng(5)
    za = sorted_dict(random_words(rng, 500, "0123456789", 9, 10))
    zb = sorted_dict(random_words(rng, 300, "0123456789", 9, 10))
    key = ("substring", 1, 5)
    cut = TRANSFORMS["substring"][2]
    sa, _ = DM.transform(za, cut, key)
    sb, _ = DM.transform(zb, cut, key)
    first = DM.align(sa, sb)
    before = counts("hit"), counts("miss")
    sa2, _ = DM.transform(za, cut, key)
    sb2, _ = DM.transform(zb, cut, key)
    assert sa2 is sa and sb2 is sb
    assert DM.align(sa2, sb2) is first
    hits, misses = counts("hit"), counts("miss")
    assert moved(before[0], hits) == {"transform": 2, "align": 1}
    assert moved(before[1], misses) == {}


# --- keys, lifetime, bound, threads ----------------------------------------


def test_a_small_dictionary_hits_by_content_across_fresh_objects():
    big = CASES["sorted-large"][0]
    first = DM.union([big, big, obj([""])])
    before = counts("hit")
    again = DM.union([big, big, obj([""])])  # q27's rollup NULL, made anew
    assert moved(before, counts("hit")) == {"union": 1}
    assert again[0] is first[0]
    lit = obj(["BUILDING"])
    segs = sorted_dict(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                        "MACHINERY"])
    m = DM.align(segs, lit)
    assert DM.align(segs.copy(), obj(["BUILDING"])) is m
    assert m.tolist() == [-1, 0, -1, -1, -1]


def test_a_large_dictionary_is_keyed_by_identity():
    big = CASES["sorted-large"][0]
    first = DM.union([big, obj(["x"])])
    before = counts("miss")
    other = DM.union([big.copy(), obj(["x"])])  # equal strings, new object
    assert moved(before, counts("miss")) == {"union": 1}
    assert other[0] is not first[0] and same_array(other[0], first[0])


def test_an_entry_goes_when_its_dictionary_is_collected():
    rng = np.random.default_rng(9)
    d = sorted_dict(random_words(rng, 200))
    DM.align(d, obj(["a"]))
    DM.union([d, obj(["zz"])])
    assert len(DM.MEMO) == 2
    del d
    gc.collect()
    assert len(DM.MEMO) == 0


def test_a_new_dictionary_at_a_dead_ones_address_misses():
    # an identity key is an address: a dictionary made where a collected
    # one lay must compute its own value, never get the dead one's
    memo = DM.DictMemo()
    rng = np.random.default_rng(11)
    computed = []

    def derive(d):
        return memo.derive("align", "align", (d, obj(["a"])), (),
                           lambda: computed.append(1) or fresh_align(
                               d, obj(["a"])))
    d = sorted_dict(random_words(rng, 100))
    got = [derive(d)]
    for _ in range(100):
        del d
        d = sorted_dict(random_words(rng, 100))
        got.append(derive(d))
        assert same_array(got[-1], fresh_align(d, obj(["a"])))
    assert len(computed) == 101
    assert len(memo) == 1


def test_the_bound_evicts_least_recently_used_first():
    memo = DM.DictMemo(max_entries=3)
    made = []

    def get(s):
        return memo.derive("align", "align", (obj([s]), obj(["q"])), (),
                           lambda: made.append(s) or np.zeros(1, np.int32))
    for s in "abc":
        get(s)
    get("a")  # a is now the most recently used
    get("d")  # evicts b, the least recently used
    get("a")
    get("c")
    assert made == ["a", "b", "c", "d"]
    get("b")
    assert made == ["a", "b", "c", "d", "b"]
    assert len(memo) == 3
    assert DM.MAX_ENTRIES >= 32 and DM.SMALL_DICT == 64


def test_two_threads_deriving_at_once_get_equal_results():
    # more threads than cores, switching often: every thread gets the
    # fresh computation's arrays, and all get the one value stored first
    # (a lost store would hand two threads two different objects)
    rng = np.random.default_rng(13)
    dicts = [sorted_dict(random_words(rng, 2000)) for _ in range(3)]
    want_u, want_r = fresh_union(dicts)
    want_m = fresh_align(dicts[0], dicts[1])
    n = 16
    start = threading.Barrier(n)
    results = [None] * n
    lookups = sum(counts("hit").values()) + sum(counts("miss").values())

    def work(i):
        start.wait(timeout=30)
        results[i] = (DM.union(dicts), DM.align(dicts[0], dicts[1]))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for (u, r), m in results:
        assert same_array(u, want_u) and same_array(m, want_m)
        assert all(same_array(x, y) for x, y in zip(r, want_r))
    stored_u, stored_m = DM.union(dicts)[0], DM.align(dicts[0], dicts[1])
    assert all(u is stored_u and m is stored_m for (u, _), m in results)
    assert len(DM.MEMO) == 2
    assert sum(counts("hit").values()) + sum(counts("miss").values()) \
        == lookups + 2 * n + 2


# --- end to end: q27's rollup and q19's substr, twice in one engine --------


E2E_SCALE = 0.01


@pytest.fixture(scope="module")
def e2e_engines():
    from presto_tpu import Engine as RefEngine
    from presto_tpu.connectors.tpcds import TpcdsConnector as RefTpcds
    from presto_tpu_torch import Engine as TorchEngine
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    port = TorchEngine(device="cpu")
    port.register_catalog("tpcds", TpcdsConnector(scale=E2E_SCALE))
    port.session.catalog = "tpcds"
    ref = RefEngine()
    ref.register_catalog("tpcds", RefTpcds(scale=E2E_SCALE))
    ref.session.catalog = "tpcds"
    return port, ref


@pytest.mark.parametrize("qname", ["q27", "q19"])
def test_second_run_hits_and_rows_equal_the_reference(qname, e2e_engines):
    from presto_tpu_torch.testing.oracle import rows_equal
    from test_tpcds import QUERIES
    port, ref = e2e_engines
    sql = QUERIES[qname]
    want = ref.execute(sql)
    ordered = "order by" in sql.lower()
    first = port.execute(sql)
    ok, msg = rows_equal(first, want, ordered=ordered)
    assert ok, msg
    hits, misses = counts("hit"), counts("miss")
    second = port.execute(sql)
    ok, msg = rows_equal(second, want, ordered=ordered)
    assert ok, msg
    assert sum(moved(hits, counts("hit")).values()) > 0
    assert moved(misses, counts("miss")) == {}
    if qname == "q27":
        assert moved(hits, counts("hit")).get("union", 0) >= 1
    else:
        assert moved(hits, counts("hit")).get("transform", 0) >= 2
        assert moved(hits, counts("hit")).get("align", 0) >= 1
