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

import torch_kernel_cases as KC


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


# The routing boundaries of the segment_sum kernel (csrc/segment_sum.cu):
# registers up to k = 8 and lane columns of shared memory up to 32 (both
# with KP = k rounded up to a power of two), shared-memory partials up
# to 6144, global atomics past it; these cases pin the contract the
# kernel keeps at each edge
_BOUNDARY_KS = [1, 2, 6, 7, 8, 9, 16, 17, 32, 33, 6144, 6145, 70_000]
_ALL_SUM_DTYPES = {"bool": np.bool_, "uint8": np.uint8, "int8": np.int8,
                   "int16": np.int16, "int32": np.int32, "int64": np.int64}


def _padded_k(k: int) -> int:
    return 1 << (k - 1).bit_length()


def _boundary_inputs(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    if dtype is np.bool_:
        x = rng.random(n) > 0.4
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        x[:2] = [info.max, info.min]
    ids = rng.integers(0, k, n).astype(np.int32)
    # -1 and k drop; KP - 1 drops unless k is a power of two
    ids[3::7] = -1
    ids[5::11] = k
    ids[6::13] = _padded_k(k) - 1
    ids[:2] = 0  # the extremes wrap in one segment
    return x, ids


@pytest.mark.parametrize("k", _BOUNDARY_KS)
@pytest.mark.parametrize("dname", list(_ALL_SUM_DTYPES))
def test_segment_sum_plain_matches_pallas_at_kernel_boundaries(dname, k):
    # an odd row count, and the same sum over an offset-1 view of the
    # data and ids (the column slices a kernel may be handed)
    x, ids = _boundary_inputs(_ALL_SUM_DTYPES[dname], 1001, k, seed=k)
    with RK.use_backend("pallas"):
        pallas = np.asarray(RSA.segment_sum_pallas(
            jnp.asarray(x), jnp.asarray(ids), k))
        pallas_tail = np.asarray(RSA.segment_sum_pallas(
            jnp.asarray(x[1:]), jnp.asarray(ids[1:]), k))
    got = PSA.segment_sum_torch(_t(x), _t(ids), k).numpy()
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == pallas.dtype
    tx, tids = _t(x), _t(ids)
    tail = PSA.segment_sum_cuda(tx[1:], tids[1:], k).numpy()
    np.testing.assert_array_equal(tail, pallas_tail)


@pytest.mark.parametrize("dname", list(_ALL_SUM_DTYPES))
def test_segment_sum_vector_span(dname):
    # the rows the kernel reads four at a time: ids 16-byte aligned from
    # vbeg, data aligned to its four-row word there, else all scalar
    # torch's own allocations are 64-byte aligned
    x = torch.zeros(1001, dtype=_t(np.zeros(1, _ALL_SUM_DTYPES[dname])).dtype)
    ids = torch.zeros(1001, dtype=torch.int32)
    size = x.element_size()
    assert x.data_ptr() % 64 == 0 and ids.data_ptr() % 64 == 0
    assert PSA.vector_span(x, ids) == (0, 250)
    # both offset by one row: three scalar head rows, then aligned
    assert PSA.vector_span(x[1:], ids[1:]) == (3, 249)
    assert PSA.vector_span(x[4:], ids[4:]) == (0, 249)
    # one of the two offset alone: the data is not aligned where the
    # ids are, so every row takes scalar loads
    assert PSA.vector_span(x[:1000], ids[1:]) == (0, 0)
    assert PSA.vector_span(x[1:], ids[:1000]) == (0, 0)
    # fewer rows than the head
    assert PSA.vector_span(x[1:3], ids[1:3]) == (0, 0)
    for lo in range(4):
        vbeg, nvec = PSA.vector_span(x[lo:], ids[lo:])
        assert (ids[lo:].data_ptr() + 4 * vbeg) % 16 == 0
        assert (x[lo:].data_ptr() + vbeg * size) % min(4 * size, 16) == 0
        assert vbeg + 4 * nvec <= 1001 - lo < vbeg + 4 * nvec + 4


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


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("k", KC.CMP_BOUNDARY_KS)
@pytest.mark.parametrize("dname", list(KC.CMP_DTYPES))
def test_segment_max_min_plain_matches_pallas_at_kernel_boundaries(
        dname, k, is_max):
    # the segment_max/min kernel's routing edges (csrc/segment_cmp.cu):
    # an odd row count, ids -1, k and KP - 1, an empty segment, and the
    # same fold over an offset-1 view of the data and ids
    x, ids = KC.cmp_boundary_inputs(KC.CMP_DTYPES[dname], 1001, k,
                                    seed=k + 7 * is_max)
    with RK.use_backend("pallas"):
        pallas = np.asarray(RSA._cmp_pallas(
            jnp.asarray(x), jnp.asarray(ids), k, is_max))
        pallas_tail = np.asarray(RSA._cmp_pallas(
            jnp.asarray(x[1:]), jnp.asarray(ids[1:]), k, is_max))
    got = _plain_cmp(x, ids, k, is_max)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == pallas.dtype == x.dtype
    entry = PSA.segment_max_cuda if is_max else PSA.segment_min_cuda
    tail = entry(_t(x)[1:], _t(ids)[1:], k).numpy()
    np.testing.assert_array_equal(tail, pallas_tail)


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


@pytest.mark.parametrize("case", KC.COMPACT_EDGES)
def test_filter_compact_plain_matches_pallas_at_the_edges(case):
    # none live, all live, a live count at the capacity and one past
    # it, rows of 1 to 24 bytes, and more columns than one launch of
    # the kernel takes
    live, arrays, capacity = KC.compact_edge_inputs(case, 1001, seed=5)
    jl = jnp.asarray(live)
    ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    with RK.use_backend("pallas"):
        pallas = RCP.filter_compact_pallas(jl, ja, capacity)
    xla = RCP.filter_compact_xla(jl, ja, capacity)
    ta = {k: _t(v) for k, v in arrays.items()}
    got = PCP.filter_compact_torch(_t(live), ta, capacity)
    entry = PCP.filter_compact_cuda(_t(live), ta, capacity)
    rows = min(int(live.sum()), capacity)
    for k in arrays:
        assert got[k].shape == tuple(np.asarray(xla[k]).shape)
        assert got[k].dtype == ta[k].dtype
        for other in (pallas, xla):  # live rows only (R3)
            np.testing.assert_array_equal(got[k].numpy()[:rows],
                                          np.asarray(other[k])[:rows], k)
        np.testing.assert_array_equal(entry[k].numpy(), got[k].numpy())
        assert not got[k].numpy()[rows:].any()  # pad rows zero


def test_compact_descriptor_layout():
    # the compaction's kernel parameter, packed on the host with no
    # library loaded: the kernel's struct layout (776 bytes, three words
    # a column), at most 32 columns a struct, a source and an output
    # address and the row bytes per column
    from presto_tpu_torch.kernels import build as B
    assert B.compact_layout() == (32, 776, 0, 8, 24, 0, 8, 16)
    assert [f for f, _t in B.CompactCol._fields_] == ["src", "dst",
                                                       "row_bytes"]
    live, arrays, cap = KC.compact_edge_inputs("many_columns", 64, seed=1)
    ta = {k: _t(v) for k, v in arrays.items()}
    out = {k: torch.empty((cap,) + tuple(a.shape[1:]), dtype=a.dtype)
           for k, a in ta.items()}
    descs = PCP.descriptors(ta, out)
    assert [d.ncols for d in descs] == [32, 8]
    cols = [c for d in descs for c in d.cols[:d.ncols]]
    assert len(cols) == len(ta) == 40
    for c, (k, a) in zip(cols, ta.items()):
        assert c.src == a.data_ptr() and c.dst == out[k].data_ptr()
        assert c.row_bytes == a.element_size() * (a.shape[1] if a.ndim == 2
                                                  else 1)
    assert {c.row_bytes for c in cols} == {1, 2, 4, 8, 16, 24}
    assert all(c.src is None for c in descs[1].cols[8:])
    assert B.LIBRARY._lib is None


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


def _home(h: np.ndarray, capacity: int) -> np.ndarray:
    from presto_tpu.kernels import u64
    hi, lo = u64.split(jnp.asarray(h.view(np.uint64)))
    return np.asarray(u64.slot32(hi, lo)) & np.uint32(capacity - 1)


def _special_lookup(case: str):
    """Build and probe inputs at the table's edges: ``empty_hash``, a
    build key and a probe key equal to the EMPTY sentinel (the probe
    tests a match before empty), with the other keys' home slots away
    from the sentinel's; ``min_table``, duplicates in the 8-slot
    minimum table."""
    rng = np.random.default_rng(21)
    if case == "min_table":
        bh = rng.integers(0, 1 << 62, 3)[[0, 1, 0, 2, 1]]
        ph = np.concatenate([bh, rng.integers(0, 1 << 62, 5)])
        return (bh.view(np.uint64), np.array([True, True, True, False,
                                               True]),
                ph.view(np.uint64), np.ones(10, bool), 1)
    cap = 2048
    empty = np.int64(-1)
    cand = rng.integers(0, 1 << 62, 64)
    homes = _home(cand, cap)
    far = cand[np.abs(homes.astype(np.int64)
                      - int(_home(np.array([empty]), cap)[0])) > 16]
    far = far[np.unique(_home(far, cap), return_index=True)[1]][:4]
    bh = np.array([empty, far[0], empty, far[1], far[0]], np.int64)
    ph = np.array([empty, far[0], far[1], far[2], far[3], empty], np.int64)
    return (bh.view(np.uint64), np.array([True, True, True, True, False]),
            ph.view(np.uint64), np.ones(6, bool), cap)


@pytest.mark.parametrize("case", ["empty_hash", "min_table"])
def test_lookup_join_plain_matches_pallas_at_the_edges(case):
    bh, bl, ph, pl, cap = _special_lookup(case)
    pallas, xla = _ref_lookups(bh, bl, ph, pl, cap)
    got = PHJ.lookup_join_torch(_t(bh), _t(bl), _t(ph), _t(pl), cap)
    sentinel = ph == np.uint64(0xFFFFFFFFFFFFFFFF)
    for g, p, x in zip(got[:2], pallas[:2], xla[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(g.numpy()[~sentinel],
                                      np.asarray(p)[~sentinel])
    assert bool(got[2]) and bool(np.asarray(pallas[2]))
    if case == "empty_hash":
        # the reference's two paths part at the sentinel: the Pallas
        # kernel tests a match before empty, so a probe hash equal to
        # EMPTY finds the build rows hashed EMPTY (duplicates: the
        # larger row), while the sorted path drops EMPTY hashes with
        # the dead rows. combine_hashes remaps EMPTY away from every
        # row hash, so no join meets it; the CUDA kernel keeps the
        # Pallas kernel's answer (tests/test_torch_cuda.py)
        np.testing.assert_array_equal(np.asarray(pallas[0])[sentinel],
                                      [2, 2])
        assert np.asarray(pallas[1])[sentinel].all()
        assert not got[1].numpy()[sentinel].any()


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

# the chain shapes the walk kernel must take (kernels/multijoin.py):
# each is held against the reference's Pallas walk and its XLA walk
_CHAIN_SHAPES = ["star", "one_step", "composite", "nulls", "chain_middle",
                 "dead_spine", "empty_build"]


def _star(seed=5, shape="star"):
    """A spine of 2000 rows and unique builds, chained as ``shape``
    says. A column is an array, or (array, validity) where it has
    nulls.

    - star: three builds; the third's key is a column of the first (a
      key chained from step 0);
    - one_step: the first build alone;
    - composite: the second build on a two-column key;
    - nulls: nulls in a spine key, a chained key and a build key;
    - chain_middle: four builds; the fourth's key is a column of the
      second (a key chained from a middle step);
    - dead_spine: the star with every spine row dead;
    - empty_build: the star with a second build whose rows are all
      dead, so its table holds nothing (the reference's Pallas walk
      takes no zero-row build)."""
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
    if shape == "one_step":
        builds, criteria = builds[:1], criteria[:1]
    elif shape == "composite":
        pairs = rng.permutation(80 * 3)[:50]
        b2.update(b_key=pairs // 3, b_key2=pairs % 3)
        spine["s_c"] = rng.integers(0, 3, n)
        criteria[1] = [("s_b", "b_key"), ("s_c", "b_key2")]
    elif shape == "nulls":
        spine["s_a"] = (spine["s_a"], rng.random(n) > 0.2)
        b1["a_c"] = (b1["a_c"], rng.random(100) > 0.25)
        b3["c_key"] = (b3["c_key"], rng.random(35) > 0.2)
    elif shape == "chain_middle":
        b2["b_d"] = rng.integers(0, 30, 50)
        builds.append(({"d_key": rng.permutation(30)[:25],
                        "d_x": rng.integers(0, 7, 25)},
                       rng.random(25) > 0.1))
        criteria.append([("b_d", "d_key")])
    elif shape == "dead_spine":
        spine_live = np.zeros(n, bool)
    elif shape == "empty_build":
        builds[1] = (b2, np.zeros(50, bool))
    return spine, spine_live, builds, criteria


def _data_valid(v):
    return v if isinstance(v, tuple) else (v, None)


def _ref_multi_join(spine, spine_live, builds, criteria, backend):
    def table(cols, live):
        vals = {}
        for k, v in cols.items():
            data, valid = _data_valid(v)
            vals[k] = RVal(RT.BIGINT, jnp.asarray(data),
                           None if valid is None else jnp.asarray(valid))
        return ROP.DTable(vals, jnp.asarray(live), len(live))
    node = types.SimpleNamespace(criteria=criteria)
    with RK.use_backend(backend):
        out, ok = ROP.apply_multi_join(
            table(spine, spine_live), [table(c, lv) for c, lv in builds],
            node)
    return out, ok


def _port_multi_join(spine, spine_live, builds, criteria, backend,
                     device="cpu"):
    def table(cols, live):
        vals = {}
        for k, v in cols.items():
            data, valid = _data_valid(v)
            vals[k] = PVal(PT.BIGINT, _t(data, device),
                           None if valid is None else _t(valid, device))
        return POP.DTable(vals, _t(live, device), len(live),
                          torch.device(device))
    node = types.SimpleNamespace(criteria=criteria)
    with PK.use_backend(backend):
        return POP.apply_multi_join(
            table(spine, spine_live), [table(c, lv) for c, lv in builds],
            node)


def _live_rows(dt, live, cols):
    live = np.asarray(live)
    return {c: np.asarray(dt.cols[c].data)[live] for c in cols}


@pytest.mark.parametrize(
    "ref_backend,shape",
    [(b, s) for s in _CHAIN_SHAPES for b in ("pallas", "xla")],
    ids=[b if s == "star" else f"{b}-{s}"
         for s in _CHAIN_SHAPES for b in ("pallas", "xla")])
def test_multijoin_plain_walk_matches_reference(ref_backend, shape):
    spine, spine_live, builds, criteria = _star(shape=shape)
    ref, rok = _ref_multi_join(spine, spine_live, builds, criteria,
                               ref_backend)
    got, ok = _port_multi_join(spine, spine_live, builds, criteria, "torch")
    assert bool(ok) and bool(np.asarray(rok))
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(ref.live))
    if shape in ("dead_spine", "empty_build"):
        assert not got.live.any()
    else:
        assert 0 < int(got.live.sum()) < len(spine_live)
    cols = ["s_v"] + [c for bcols, _lv in builds for c in bcols]
    want = _live_rows(ref, ref.live, cols)
    have = _live_rows(got, got.live.numpy(), cols)
    for c in cols:
        np.testing.assert_array_equal(have[c], want[c])


def test_multijoin_descriptor_layout():
    # the walk's kernel parameter, packed on the host with no library
    # loaded: the field order the kernel's structs have (960 bytes, 15
    # words a step), the sources a chain resolves to, and the limits
    from presto_tpu_torch.kernels import build as B
    from presto_tpu_torch.kernels import multijoin as PMJ
    from presto_tpu_torch.ops import hash as PH
    assert B.mj_layout() == (8, 4, 960, 120, 0, 8, 16, 24, 24, 0, 8, 16)
    assert [f for f, _t in B.MjStep._fields_] == ["table", "mask", "nkeys",
                                                  "keys"]
    assert [f for f, _t in B.MjKey._fields_] == ["source", "hash", "valid"]
    spine, spine_live, builds, criteria = _star(shape="nulls")
    spine_cols = {k: PVal(PT.BIGINT, _t(_data_valid(v)[0]),
                          None if _data_valid(v)[1] is None
                          else _t(_data_valid(v)[1]))
                  for k, v in spine.items()}
    bl = []
    for cols, live in builds:
        bl.append(({k: PVal(PT.BIGINT, _t(_data_valid(v)[0]),
                            None if _data_valid(v)[1] is None
                            else _t(_data_valid(v)[1]))
                    for k, v in cols.items()}, _t(live), len(live)))
    steps = PMJ._resolve(spine_cols, bl, criteria)
    assert [[src for src, _v, _bv in keys] for keys in steps] == \
        [[-1], [-1], [0]]
    tables = [torch.full((PH.next_pow2(2 * n), 2), -1, dtype=torch.int64)
              for _c, _l, n in bl]
    desc, keep = PMJ.descriptor(steps, tables)
    assert B.LIBRARY._lib is None
    got = []
    for st, keys, table in zip(desc.steps, steps, tables):
        assert st.table == table.data_ptr()
        assert st.mask == table.shape[0] - 1 and st.nkeys == len(keys)
        for key, (src, v, _bv) in zip(st.keys, keys):
            got.append(key.source)
            held = {t.data_ptr(): t for t in keep}
            np.testing.assert_array_equal(
                held[key.hash].numpy(),
                PH.hash_int_column(v.data, v.valid).numpy())
            if v.valid is None:
                assert key.valid is None
            else:
                assert torch.equal(held[key.valid], v.valid)
    assert got == [-1, -1, 0]
    assert all(st.table is None for st in desc.steps[3:])
    # the limits: at most 8 steps of 1 to 4 keys, before any build
    with pytest.raises(ValueError, match="9 steps"):
        PMJ.step_descriptors(steps * 3, bl * 3)
    with pytest.raises(ValueError, match="1 to 4 keys"):
        PMJ.descriptor([steps[0] * 5], tables[:1])
    assert B.LIBRARY._lib is None


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
        PHJ.probe_table(x.view(4, 2), x, x.to(torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        PSA._segment_cmp_cuda(x, x.to(torch.int32), 4, True)
    assert PH.next_pow2(1000) == 1024
    assert PHJ.table_capacity(3) == 8 and PHJ.table_capacity(1000) == 1024
