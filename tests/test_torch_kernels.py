"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels (interpret mode off-TPU, as tests/test_kernels.py
runs them) and their XLA fallbacks, with exact equality (live rows
only for the compaction, whose dead rows differ by design). The CUDA
kernels against these plain versions are tests/test_torch_cuda.py.

Inputs come from numpy with a fixed seed and go to both sides as
arrays."""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from presto_tpu import kernels as RK
from presto_tpu import types as RT
from presto_tpu.exec import operators as ROP
from presto_tpu.expr.compile import Val as RVal
from presto_tpu.kernels import compact as RCP
from presto_tpu.kernels import hashjoin as RHJ
from presto_tpu.kernels import segagg as RSA
from presto_tpu.ops import hash as RH

from presto_tpu_torch import kernels as PK
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec import operators as POP
from presto_tpu_torch.expr.compile import Val as PVal
from presto_tpu_torch.kernels import compact as PCP
from presto_tpu_torch.kernels import hashjoin as PHJ
from presto_tpu_torch.kernels import segagg as PSA
from presto_tpu_torch.ops import hash as PH


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



def _t(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


# -- segment sum ------------------------------------------------------------

_DTYPES = {"int8": np.int8, "int32": np.int32, "int64": np.int64,
           "bool": np.bool_}


def _seg_inputs(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    if dtype is np.bool_:
        x = rng.random(n) > 0.4
    elif dtype is np.int64:
        x = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        # wraparound near +-2^63: these pairs overflow int64
        x[:4] = [(1 << 63) - 5, (1 << 63) - 7, -(1 << 63) + 3,
                 -(1 << 63) + 9]
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype)
    ids = rng.integers(-3, k + 3, n).astype(np.int32)  # out of range drop
    ids[:4] = 0
    return x, ids


def _xla_sum(x, ids, k):
    """The XLA fallback's sum. Past its one-hot path (k > 512) the
    fallback is jax.ops.segment_sum, which takes no bool column; the
    contract sums a bool column as int64, so it gets that column."""
    if x.dtype == np.bool_ and k > 512:
        x = x.astype(np.int64)
    return np.asarray(RSA.segment_sum_xla(jnp.asarray(x), jnp.asarray(ids),
                                          k))


@pytest.mark.parametrize("k", [1, 33, 65536])
@pytest.mark.parametrize("dname", list(_DTYPES))
def test_segment_sum_plain_matches_pallas_and_xla(dname, k):
    x, ids = _seg_inputs(_DTYPES[dname], 3000, k, seed=k)
    with RK.use_backend("pallas"):
        pallas = np.asarray(RSA.segment_sum_pallas(
            jnp.asarray(x), jnp.asarray(ids), k))
    xla = _xla_sum(x, ids, k)
    got = PSA.segment_sum_torch(_t(x), _t(ids), k).numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == xla.dtype


@pytest.mark.parametrize("dname", list(_DTYPES))
def test_segment_sum_past_the_tpu_gate(dname):
    # k = 70 000 is past the Pallas kernel's VMEM gate (65 536): the
    # port has no gate, and holds to the XLA fallback there
    k = 70_000
    x, ids = _seg_inputs(_DTYPES[dname], 5000, k, seed=7)
    want = _xla_sum(x, ids, k)
    np.testing.assert_array_equal(
        PSA.segment_sum_torch(_t(x), _t(ids), k).numpy(), want)
    # on CPU tensors the kernel entry takes the plain version
    np.testing.assert_array_equal(
        PSA.segment_sum_cuda(_t(x), _t(ids), k).numpy(), want)


# -- segment max / min ------------------------------------------------------

_CMP_DTYPES = {"int8": np.int8, "int32": np.int32, "int64": np.int64}


def _cmp_inputs(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    x[:4] = [info.max, info.min, info.max - 1, info.min + 1]
    # segments past k // 2 get no row (empty: they hold the identity);
    # ids below 0 and at or past k drop
    ids = rng.integers(-3, k // 2 + 1, n).astype(np.int32)
    ids[-6:] = [k, k + 1, -1, k + 7, 0, k // 2]
    return x, ids


def _plain_cmp(x, ids, k, is_max):
    fn = PSA.segment_max_torch if is_max else PSA.segment_min_torch
    return fn(_t(x), _t(ids), k).numpy()


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("k", [1, 2, 33, 65536])
@pytest.mark.parametrize("dname", list(_CMP_DTYPES))
def test_segment_max_min_plain_matches_pallas_and_xla(dname, k, is_max):
    x, ids = _cmp_inputs(_CMP_DTYPES[dname], 3000, k, seed=k + is_max)
    with RK.use_backend("pallas"):
        pallas = np.asarray(RSA._cmp_pallas(
            jnp.asarray(x), jnp.asarray(ids), k, is_max))
    xla_fn = RSA.segment_max_xla if is_max else RSA.segment_min_xla
    xla = np.asarray(xla_fn(jnp.asarray(x), jnp.asarray(ids), k))
    got = _plain_cmp(x, ids, k, is_max)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == xla.dtype == x.dtype
    if k > 2:
        info = np.iinfo(x.dtype)
        assert got[-1] == (info.min if is_max else info.max)  # empty


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("dname", list(_CMP_DTYPES))
def test_segment_max_min_past_the_tpu_gate(dname, is_max):
    # k = 70 000 is past the Pallas kernel's VMEM gate (65 536): the
    # port has no gate, and holds to the XLA fallback there
    k = 70_000
    x, ids = _cmp_inputs(_CMP_DTYPES[dname], 5000, k, seed=9 + is_max)
    xla_fn = RSA.segment_max_xla if is_max else RSA.segment_min_xla
    want = np.asarray(xla_fn(jnp.asarray(x), jnp.asarray(ids), k))
    np.testing.assert_array_equal(_plain_cmp(x, ids, k, is_max), want)
    # on CPU tensors the kernel entry takes the plain version
    entry = PSA.segment_max_cuda if is_max else PSA.segment_min_cuda
    np.testing.assert_array_equal(entry(_t(x), _t(ids), k).numpy(), want)


def test_segment_max_min_float_columns_stay_plain():
    from presto_tpu.ops import segred as RSR
    from presto_tpu_torch.ops import segred as PSR
    rng = np.random.default_rng(3)
    x = rng.normal(size=500)
    ids = rng.integers(-1, 40, 500).astype(np.int32)
    with PK.use_backend("cuda"), PK.collect() as used:
        got = PSR.segment_max(_t(x), _t(ids), 50).numpy()
    assert used == ["torch:agg_max"]
    want = np.asarray(RSR.segment_max(jnp.asarray(x), jnp.asarray(ids),
                                      50))
    np.testing.assert_array_equal(got, want)  # -inf in empty segments


# -- filter compaction ------------------------------------------------------


def _compact_inputs(n, seed, frac=0.3):
    rng = np.random.default_rng(seed)
    live = rng.random(n) < frac
    arrays = {"i64": rng.integers(-(1 << 62), 1 << 62, n),
              "f64": rng.normal(size=n),
              "i32": rng.integers(-1000, 1000, n).astype(np.int32),
              "flag": rng.random(n) > 0.5,
              "dec": rng.integers(-(1 << 62), 1 << 62, (n, 2))}
    return live, arrays


@pytest.mark.parametrize("capacity", [64, 512, 2048])
def test_filter_compact_plain_matches_pallas_and_xla(capacity):
    # 1000 rows, about 300 live: capacity 64 overflows (rows past it
    # drop), 512 and 2048 hold every live row
    live, arrays = _compact_inputs(1000, seed=capacity)
    jl = jnp.asarray(live)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    with RK.use_backend("pallas"):
        pallas = RCP.filter_compact_pallas(jl, ja, capacity)
    xla = RCP.filter_compact_xla(jl, ja, capacity)
    got = PCP.filter_compact_torch(_t(live),
                                   {k: _t(v) for k, v in arrays.items()},
                                   capacity)
    entry = PCP.filter_compact_cuda(_t(live),
                                    {k: _t(v) for k, v in arrays.items()},
                                    capacity)
    rows = min(int(live.sum()), capacity)  # the count both report
    for k in arrays:
        assert got[k].shape == tuple(np.asarray(xla[k]).shape)
        for other in (pallas, xla):  # live rows only (R3)
            np.testing.assert_array_equal(got[k].numpy()[:rows],
                                          np.asarray(other[k])[:rows], k)
        np.testing.assert_array_equal(entry[k].numpy(), got[k].numpy())
        assert not got[k].numpy()[rows:].any()  # pad rows zero


def test_compact_dtable_matches_reference():
    rng = np.random.default_rng(11)
    n = 700
    live = rng.random(n) < 0.2
    cols = {"a": (rng.integers(0, 99, n), rng.random(n) > 0.1),
            "d": (rng.integers(-(1 << 40), 1 << 40, (n, 2)), None)}
    typ = {"a": (RT.BIGINT, PT.BIGINT),
           "d": (RT.DecimalType(38, 2), PT.DecimalType(38, 2))}
    rdt = ROP.DTable({k: RVal(typ[k][0], jnp.asarray(d),
                              None if v is None else jnp.asarray(v))
                      for k, (d, v) in cols.items()}, jnp.asarray(live), n)
    pdt = POP.DTable({k: PVal(typ[k][1], _t(d),
                              None if v is None else _t(v))
                      for k, (d, v) in cols.items()}, _t(live), n, "cpu")
    for cap in (64, 256):  # 64 overflows the ~140 live rows
        with RK.use_backend("xla"):
            want, wok = ROP.compact_dtable(rdt, cap)
        with PK.use_backend("torch"), PK.collect() as used:
            got, gok = POP.compact_dtable(pdt, cap)
        assert used == ["torch:compact"]
        assert bool(gok) == bool(wok)
        wl = np.asarray(want.live)
        np.testing.assert_array_equal(got.live.numpy(), wl)
        for k in cols:
            np.testing.assert_array_equal(
                got.cols[k].data.numpy()[wl], np.asarray(want.cols[k].data)[wl])
            if cols[k][1] is not None:
                np.testing.assert_array_equal(
                    got.cols[k].valid.numpy()[wl],
                    np.asarray(want.cols[k].valid)[wl])


# -- join build + probe -----------------------------------------------------


def _lookup_inputs(seed=0, nb=700, npr=1300, key_range=400):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, key_range, nb)  # duplicate build keys
    pk = rng.integers(0, 2 * key_range, npr)
    bh = np.asarray(RH.combine_hashes([RH.hash_int_column(jnp.asarray(bk))]))
    ph = np.asarray(RH.combine_hashes([RH.hash_int_column(jnp.asarray(pk))]))
    return bh, rng.random(nb) > 0.15, ph, rng.random(npr) > 0.15


def _ref_lookups(bh, bl, ph, pl, cap, **kw):
    args = [jnp.asarray(a) for a in (bh, bl, ph, pl)]
    with RK.use_backend("pallas"):
        pallas = RHJ.lookup_join_pallas(*args, cap, **kw)
    return pallas, RHJ.lookup_join_xla(*args, cap, **kw)


@pytest.mark.parametrize("case", ["duplicates", "dead_rows",
                                  "empty_build"])
def test_lookup_join_plain_matches_pallas_and_xla(case):
    bh, bl, ph, pl = _lookup_inputs()
    if case == "dead_rows":
        bl[::3] = False
        pl[::2] = False
    if case == "empty_build":
        bl[:] = False
    pallas, xla = _ref_lookups(bh, bl, ph, pl, 2048)
    got = PHJ.lookup_join_torch(_t(bh), _t(bl), _t(ph), _t(pl), 2048)
    for g, p, x in zip(got[:2], pallas[:2], xla[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
    assert bool(got[2]) and bool(np.asarray(pallas[2]))
    if case == "empty_build":
        assert not got[1].any()
    else:
        assert got[1].any()


def _one_slot_hashes(n: int, capacity: int) -> np.ndarray:
    """``n`` distinct row hashes whose open-addressing home slot (the
    kernels' slot32 mix) is the same at ``capacity``."""
    from presto_tpu.kernels import u64
    rng = np.random.default_rng(99)
    cand = rng.integers(0, 1 << 62, 400_000, dtype=np.uint64)
    hi, lo = u64.split(jnp.asarray(cand))
    slot = np.asarray(u64.slot32(hi, lo)) & np.uint32(capacity - 1)
    pick = cand[slot == np.bincount(slot).argmax()]
    assert len(pick) >= n
    return pick[:n]


def test_lookup_join_chain_past_max_probes():
    # 300 distinct hashes in ONE home slot: the chain outgrows the 256
    # probes, the Pallas kernel reports ok=False (the capacity ladder's
    # signal); the plain version has no chains and answers exactly
    h = _one_slot_hashes(300, 512)
    live = np.ones(300, bool)
    pallas, xla = _ref_lookups(h, live, h, live, 512)
    assert not bool(np.asarray(pallas[2]))
    got = PHJ.lookup_join_torch(_t(h), _t(live), _t(h), _t(live), 512)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(xla[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(xla[1]))
    assert got[1].all() and bool(got[2])


# -- the fused multi-join walk ----------------------------------------------


def _star(seed=5):
    """A spine of 2000 rows and three unique builds; the third build's
    key is a column of the first build (a chained key)."""
    rng = np.random.default_rng(seed)
    n = 2000
    spine = {"s_a": rng.integers(0, 120, n), "s_b": rng.integers(0, 60, n),
             "s_v": rng.integers(-1000, 1000, n)}
    spine_live = rng.random(n) > 0.1
    b1 = {"a_key": rng.permutation(150)[:100], "a_c": rng.integers(0, 40, 100)}
    b2 = {"b_key": rng.permutation(80)[:50], "b_w": rng.integers(0, 9, 50)}
    b3 = {"c_key": rng.permutation(40)[:35], "c_name": rng.integers(0, 5, 35)}
    builds = [(b1, rng.random(100) > 0.1), (b2, np.ones(50, bool)),
              (b3, rng.random(35) > 0.05)]
    criteria = [[("s_a", "a_key")], [("s_b", "b_key")], [("a_c", "c_key")]]
    return spine, spine_live, builds, criteria


def _ref_multi_join(spine, spine_live, builds, criteria, backend):
    def table(cols, live):
        return ROP.DTable({k: RVal(RT.BIGINT, jnp.asarray(v))
                           for k, v in cols.items()},
                          jnp.asarray(live), len(live))
    node = types.SimpleNamespace(criteria=criteria)
    with RK.use_backend(backend):
        out, ok = ROP.apply_multi_join(
            table(spine, spine_live), [table(c, lv) for c, lv in builds],
            node)
    return out, ok


def _port_multi_join(spine, spine_live, builds, criteria, backend,
                     device="cpu"):
    def table(cols, live):
        return POP.DTable({k: PVal(PT.BIGINT, _t(v, device))
                           for k, v in cols.items()},
                          _t(live, device), len(live), torch.device(device))
    node = types.SimpleNamespace(criteria=criteria)
    with PK.use_backend(backend):
        return POP.apply_multi_join(
            table(spine, spine_live), [table(c, lv) for c, lv in builds],
            node)


def _live_rows(dt, live, cols):
    live = np.asarray(live)
    return {c: np.asarray(dt.cols[c].data)[live] for c in cols}


@pytest.mark.parametrize("ref_backend", ["pallas", "xla"])
def test_multijoin_plain_walk_matches_reference(ref_backend):
    spine, spine_live, builds, criteria = _star()
    ref, rok = _ref_multi_join(spine, spine_live, builds, criteria,
                               ref_backend)
    got, ok = _port_multi_join(spine, spine_live, builds, criteria, "torch")
    assert bool(ok) and bool(np.asarray(rok))
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(ref.live))
    assert 0 < int(got.live.sum()) < len(spine_live)
    cols = ["s_v", "a_c", "b_w", "c_name"]
    want = _live_rows(ref, ref.live, cols)
    have = _live_rows(got, got.live.numpy(), cols)
    for c in cols:
        np.testing.assert_array_equal(have[c], want[c])


def test_multijoin_cuda_entry_on_cpu_takes_plain_version():
    spine, spine_live, builds, criteria = _star(seed=8)
    plain, _ = _port_multi_join(spine, spine_live, builds, criteria, "torch")
    entry, _ = _port_multi_join(spine, spine_live, builds, criteria, "cuda")
    np.testing.assert_array_equal(entry.live.numpy(), plain.live.numpy())
    for c in ("a_c", "b_w", "c_name"):
        np.testing.assert_array_equal(entry.cols[c].data.numpy(),
                                      plain.cols[c].data.numpy())


def test_cuda_wrappers_reject_bad_inputs():
    # the checks run before any launch, so they hold on any host
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PHJ.build_table(x, torch.ones(8, dtype=torch.bool), 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PHJ.probe_table(x, x.to(torch.int32), x, x.to(torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        PSA._segment_cmp_cuda(x, x.to(torch.int32), 4, True)
    assert PH.next_pow2(1000) == 1024
    assert PHJ.table_capacity(3) == 8 and PHJ.table_capacity(1000) == 1024
