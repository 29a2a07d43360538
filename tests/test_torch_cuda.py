"""On the card only (marker ``cuda``): each CUDA kernel of
presto_tpu_torch against its plain PyTorch version, with exact
equality (live rows for the compaction), and the 22 TPC-H queries and
a general cross join end to end on both backends. Elsewhere
every test skips with its reason. This file imports neither jax nor
presto_tpu, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch import kernels as K
from presto_tpu_torch import types as T
from presto_tpu_torch.expr.compile import Val
from presto_tpu_torch.kernels import build as B
from presto_tpu_torch.kernels import compact as CP
from presto_tpu_torch.kernels import hashjoin as HJ
from presto_tpu_torch.kernels import multijoin as MJ
from presto_tpu_torch.kernels import segagg as SA
from presto_tpu_torch.ops import hash as H

import torch_kernel_cases as KC

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test run, never at
    import (pytest-xdist workers must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card (this host has no CUDA device)")
    return torch.device("cuda")


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _seg_inputs(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    if dtype is np.bool_:
        x = rng.random(n) > 0.4
    elif dtype is np.int64:
        x = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        x[:4] = [(1 << 63) - 5, (1 << 63) - 7, -(1 << 63) + 3,
                 -(1 << 63) + 9]
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype)
    ids = rng.integers(-3, k + 3, n).astype(np.int32)
    # -1 and k drop, and so does KP - 1 (k rounded up to a power of
    # two, the accumulator count of the small-k paths) unless k is one
    ids[3::7] = -1
    ids[5::11] = k
    ids[6::13] = (1 << (k - 1).bit_length()) - 1
    return x, ids


# the kernel's routing boundaries: registers to k = 8, lane columns of
# shared memory to 32, shared-memory partials to 6144, global atomics
# past it
_BOUNDARY_KS = [1, 2, 6, 7, 8, 9, 16, 17, 32, 33, 6144, 6145, 70_000]
_SUM_DTYPES = [np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64]


@pytest.mark.parametrize("k", _BOUNDARY_KS)
@pytest.mark.parametrize("dtype", _SUM_DTYPES)
def test_segment_sum_matches_plain(cuda, dtype, k):
    x, ids = _seg_inputs(dtype, 200_001, k, seed=k)  # an odd row count
    want = SA.segment_sum_torch(_t(x, cuda), _t(ids, cuda), k)
    before = B.LAUNCHES.snapshot()["segment_sum"]
    got = SA.segment_sum_cuda(_t(x, cuda), _t(ids, cuda), k)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()["segment_sum"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("offset", ["both", "data", "ids"])
@pytest.mark.parametrize("k", [6, 33, 70_000])
@pytest.mark.parametrize("dtype", [np.bool_, np.int16, np.int64])
def test_segment_sum_offset_views(cuda, dtype, k, offset):
    # views one row in: both alike keep vector loads after a scalar
    # head, one alone sends every row to scalar loads
    x, ids = _seg_inputs(dtype, 100_003, k, seed=3 * k)
    tx, tids = _t(x, cuda), _t(ids, cuda)
    dx = tx[1:] if offset in ("both", "data") else tx[:-1]
    di = tids[1:] if offset in ("both", "ids") else tids[:-1]
    span = SA.vector_span(dx, di)
    assert span == ((3, (len(dx) - 3) // 4) if offset == "both"
                    else (0, 0))
    want = SA.segment_sum_torch(dx, di, k)
    got = SA.segment_sum_cuda(dx, di, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _cmp_inputs(dtype, n, k, seed):
    rng = np.random.default_rng(seed)
    if dtype is np.int64:
        x = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        x[:4] = [(1 << 63) - 1, -(1 << 63), (1 << 63) - 2, -(1 << 63) + 1]
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, n, dtype=dtype,
                         endpoint=True)
    # ids past k and below 0 drop; ids >= k // 2 + 1 never occur except
    # as the out-of-range ones, so those segments stay empty
    ids = rng.integers(-3, k // 2 + 1, n).astype(np.int32)
    ids[-5:] = k + 2
    return x, ids


@pytest.mark.parametrize("k", [1, 6, 4096, 70_000])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int32, np.int64])
@pytest.mark.parametrize("is_max", [True, False])
def test_segment_max_min_match_plain(cuda, dtype, k, is_max):
    x, ids = _cmp_inputs(dtype, 200_000, k, seed=k + int(is_max))
    name = "segment_max" if is_max else "segment_min"
    plain = SA.segment_max_torch if is_max else SA.segment_min_torch
    kernel = SA.segment_max_cuda if is_max else SA.segment_min_cuda
    want = plain(_t(x, cuda), _t(ids, cuda), k)
    before = B.LAUNCHES.snapshot()[name]
    got = kernel(_t(x, cuda), _t(ids, cuda), k)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()[name] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("k", KC.CMP_BOUNDARY_KS)
@pytest.mark.parametrize("dname", list(KC.CMP_DTYPES))
def test_segment_cmp_at_kernel_boundaries(cuda, dname, k, is_max, view):
    # the inputs of the CPU test that holds the plain version to the
    # Pallas kernel, at an odd 200 001 rows; "offset" views data and
    # ids one row in (a scalar head, then vector loads)
    x, ids = KC.cmp_boundary_inputs(KC.CMP_DTYPES[dname], 200_001, k,
                                    seed=k + 7 * is_max)
    tx, tids = _t(x, cuda), _t(ids, cuda)
    if view == "offset":
        tx, tids = tx[1:], tids[1:]
        assert SA.vector_span(tx, tids)[0] > 0
    plain = SA.segment_max_torch if is_max else SA.segment_min_torch
    kernel = SA.segment_max_cuda if is_max else SA.segment_min_cuda
    want = plain(tx, tids, k)
    got = kernel(tx, tids, k)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_segment_cmp_ordered_values(cuda, order, is_max):
    # k = 1 << 20 by global atomics: rows whose values rise (or fall)
    # beat every partial before them, so no read skips an atomic; the
    # values reach +-2^63 at the two ends
    n, k = 3_000_001, 1 << 20
    rng = np.random.default_rng(17)
    # evenly spaced over the whole int64 range (the sign bit flipped
    # maps the unsigned order onto the signed one)
    step = np.uint64(((1 << 64) - 1) // (n - 1))
    x = ((np.arange(n, dtype=np.uint64) * step)
         ^ np.uint64(1 << 63)).view(np.int64)
    x[-1] = (1 << 63) - 1
    if order == "descending":
        x = x[::-1].copy()
    ids = rng.integers(-1, k + 1, n).astype(np.int32)
    tx, tids = _t(x, cuda), _t(ids, cuda)
    plain = SA.segment_max_torch if is_max else SA.segment_min_torch
    kernel = SA.segment_max_cuda if is_max else SA.segment_min_cuda
    want = plain(tx, tids, k)
    got = kernel(tx, tids, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("capacity", [1 << 12, 1 << 17])
def test_filter_compact_matches_plain(cuda, capacity):
    # 1-D int64, float64 and bool columns and a [n, 2] long-decimal
    # column; at 1 << 12 the live rows overflow the capacity
    rng = np.random.default_rng(capacity)
    n = 300_007
    live = _t(rng.random(n) < 0.04, cuda)
    arrays = {"i": _t(rng.integers(-(1 << 62), 1 << 62, n), cuda),
              "f": _t(rng.random(n), cuda),
              "b": _t(rng.random(n) > 0.5, cuda),
              "d": _t(rng.integers(-(1 << 62), 1 << 62, (n, 2)), cuda),
              "s": _t(rng.integers(0, 1 << 15, n).astype(np.int16), cuda)}
    want = CP.filter_compact_torch(live, arrays, capacity)
    before = B.LAUNCHES.snapshot()["filter_compact"]
    got = CP.filter_compact_cuda(live, arrays, capacity)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()["filter_compact"] == before + 1
    live_rows = min(int(live.sum()), capacity)
    for name in arrays:
        assert got[name].shape == want[name].shape
        assert torch.equal(got[name][:live_rows], want[name][:live_rows])


@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("case", KC.COMPACT_EDGES)
def test_filter_compact_at_the_edges(cuda, case, view):
    # the CPU test's edges at 300 007 rows (19 tiles of 16 384); "offset"
    # views the mask and the columns one row in (the mask's first tile
    # then starts before it)
    live, arrays, capacity = KC.compact_edge_inputs(case, 300_007, seed=5)
    tl = _t(live, cuda)
    ta = {k: _t(v, cuda) for k, v in arrays.items()}
    if view == "offset":
        tl = tl[1:]
        ta = {k: a[1:] for k, a in ta.items()}
    want = CP.filter_compact_torch(tl, ta, capacity)
    before = B.LAUNCHES.snapshot()["filter_compact"]
    got = CP.filter_compact_cuda(tl, ta, capacity)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()["filter_compact"] == before + 1
    rows = min(int(tl.sum()), capacity)
    for k in ta:
        assert got[k].shape == want[k].shape and got[k].dtype == ta[k].dtype
        assert torch.equal(got[k][:rows], want[k][:rows])
        assert not got[k][rows:].any()  # the tail zeroed


@pytest.mark.parametrize("view", ["aligned", "offset"])
def test_filter_compact_across_many_tiles(cuda, view):
    # 9 000 011 rows are 550 tiles, so a tile's look-back can pass
    # several rounds of 32 status words; runs of dead, sparse, dense and
    # all-live tiles; the capacity cuts the live rows short
    rng = np.random.default_rng(23)
    n = 9_000_011
    density = np.repeat(rng.choice([0.0, 0.01, 0.5, 1.0], n // 50_000 + 1),
                        50_000)[:n]
    live = _t(rng.random(n) < density, cuda)
    arrays = {"i": _t(rng.integers(-(1 << 62), 1 << 62, n), cuda),
              "s": _t(rng.integers(0, 1 << 15, n).astype(np.int16), cuda),
              "d": _t(rng.integers(-(1 << 62), 1 << 62, (n, 2)), cuda)}
    if view == "offset":
        live = live[1:]
        arrays = {k: a[1:] for k, a in arrays.items()}
    nlive = int(live.sum())
    for capacity in (nlive, nlive - 12_345):
        want = CP.filter_compact_torch(live, arrays, capacity)
        got = CP.filter_compact_cuda(live, arrays, capacity)
        torch.cuda.synchronize()
        rows = min(nlive, capacity)
        for k in arrays:
            assert torch.equal(got[k][:rows], want[k][:rows])
            assert not got[k][rows:].any()


_NO_SYNC_CASES = ["compact", "compact_many_columns", "dictionary_predicate",
                  "dictionary_hashes", "literal", "decimal_rescale",
                  "int128_constant"]


def _no_sync_case(case: str, device):
    """A closure that runs one upload site (or the compaction) on the
    card, and the hostsync.UPLOADS site it counts against (None: it
    uploads nothing)."""
    from presto_tpu_torch.expr import compile as C
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.ops import int128 as I
    if case.startswith("compact"):
        live, arrays, cap = KC.compact_edge_inputs(
            "many_columns" if case.endswith("columns") else
            "live_past_capacity", 100_003, seed=2)
        tl = _t(live, device)
        ta = {k: _t(v, device) for k, v in arrays.items()}
        return (lambda: CP.filter_compact_cuda(tl, ta, cap)), None
    codes = _t(np.array([0, 3, 1, 4, 2, 3], dtype=np.int32), device)
    if case == "dictionary_predicate":
        v = Val(T.VARCHAR, codes, None, np.array(
            ["AIR", "MAIL", "RAIL", "REG AIR", "SHIP"], dtype=object))
        return (lambda: C._dict_predicate(
            v, lambda s: np.char.find(s, "AIR") >= 0)), "dictionary-lut"
    if case == "dictionary_hashes":
        # a fresh dictionary each call: nothing of it is cached
        return (lambda: H.hash_string_column(codes, np.array(
            ["a", "b", "c", "d", "e"], dtype=object))), "dictionary-hashes"
    if case == "literal":
        comp = C.ExprCompiler({}, device)
        return (lambda: comp.compile(ir.Literal(T.BIGINT, 42))), "literal"
    d = I.from_i64(_t(np.arange(-500, 500, 7, dtype=np.int64) * 10 ** 12,
                      device))
    if case == "decimal_rescale":
        return (lambda: C._rescale128(d, 25, 3)), None
    return (lambda: I.mul_small(d, 10 ** 9)), None


@pytest.mark.parametrize("case", _NO_SYNC_CASES)
def test_uploads_add_no_stream_sync(cuda, case):
    # the compaction (its descriptors by value, its outputs unzeroed)
    # and every upload site of the execute path (pinned, non-blocking
    # copies or device-side constants) never wait for the stream: torch
    # raises on a synchronizing call in this mode
    from presto_tpu_torch.exec import hostsync as HS
    run, site = _no_sync_case(case, cuda)
    run()  # the kernel build and the pinned allocator's first block
    torch.cuda.synchronize()
    before = HS.UPLOADS.by_site.get(site, 0)
    total = HS.UPLOADS.total()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if site is None:
        assert HS.UPLOADS.total() == total
    else:
        assert HS.UPLOADS.by_site[site] == before + 1


def _lookup_inputs(device, nb, npr, key_range, seed=0):
    rng = np.random.default_rng(seed)
    bk = _t(rng.integers(0, key_range, nb), device)
    pk = _t(rng.integers(0, 2 * key_range, npr), device)
    return (H.combine_hashes([H.hash_int_column(bk)]),
            _t(rng.random(nb) > 0.15, device),
            H.combine_hashes([H.hash_int_column(pk)]),
            _t(rng.random(npr) > 0.15, device))


@pytest.mark.parametrize("case", ["duplicates", "dead_rows",
                                  "empty_build", "min_table",
                                  "partitioned"])
def test_lookup_join_matches_plain(cuda, case):
    bh, bl, ph, pl = _lookup_inputs(cuda, 70_000, 200_000, 40_000)
    capacity = 1 << 17
    if case == "partitioned":
        # a table past PARTITION_MIN_SLOTS builds by home-slot buckets
        bh, bl, ph, pl = _lookup_inputs(cuda, 1_500_000, 3_000_000,
                                        1_000_000)
        capacity = 1 << 22
        assert capacity > HJ.PARTITION_MIN_SLOTS
    if case == "dead_rows":
        bl[::3] = False
    if case == "empty_build":
        bl[:] = False
    if case == "min_table":
        # capacity 1 gives the 8-slot minimum table: five build rows
        # on three keys, one dead
        bh, bl = bh[[0, 1, 0, 2, 1]], bl[:5].clone()
        bl[:] = True
        bl[3] = False
        ph = torch.cat([bh, ph[:5]])
        pl = torch.ones(10, dtype=torch.bool, device=cuda)
        capacity = 1
    want = HJ.lookup_join_torch(bh, bl, ph, pl, capacity)
    got = HJ.lookup_join_cuda(bh, bl, ph, pl, capacity)
    torch.cuda.synchronize()
    assert bool(got[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("capacity", [1 << 17, 1 << 21])
def test_build_table_layout(cuda, capacity):
    # one 16-byte slot a key: word 0 the key, word 1 the largest live
    # row with that key over a high word of -1; empty slots all ones.
    # 1 << 21 slots take the partitioned build
    bh, bl, _ph, _pl = _lookup_inputs(cuda, 70_000, 10, 40_000)
    table, ok = HJ.build_table(bh, bl, capacity)
    torch.cuda.synchronize()
    assert bool(ok) and table.shape == (capacity, 2)
    assert table.dtype == torch.int64 and table.data_ptr() % 16 == 0
    t = table.cpu().numpy()
    h, live = bh.cpu().numpy(), bl.cpu().numpy()
    want = {}
    for row in np.flatnonzero(live):
        want[h[row]] = row  # rows ascend: the last is the largest
    used = t[:, 0] != -1
    assert (t[~used] == -1).all()
    assert (t[:, 1] >> 32 == -1).all()
    got = dict(zip(t[used, 0], t[used, 1] & 0xFFFFFFFF))
    assert got == want


def test_lookup_join_empty_hash(cuda):
    _empty_hash_lookup(cuda)


def _empty_hash_lookup(cuda, cap=2048):
    # a build key and a probe key equal to the EMPTY sentinel: the
    # kernel tests a match before empty, as the Pallas kernel does, so
    # the sentinel probe rows find the sentinel build rows (duplicates:
    # the larger row); the plain (sorted) version drops EMPTY hashes
    # with the dead rows. combine_hashes keeps EMPTY off every row
    # hash, so no join meets this. The other keys' home slots lie away
    # from the sentinel's.
    rng = np.random.default_rng(21)
    cand = rng.integers(0, 1 << 62, 64).astype(np.uint64)

    def home(h):
        hi = (h >> np.uint64(32)).astype(np.uint32)
        return _mix32(h.astype(np.uint32) ^ _mix32(hi)) & np.uint32(cap - 1)
    empty = np.array([0xFFFFFFFFFFFFFFFF], np.uint64)
    far = cand[np.abs(home(cand).astype(np.int64)
                      - int(home(empty)[0])) > 16]
    far = far[np.unique(home(far), return_index=True)[1]][:4].view(np.int64)
    bh = _t(np.array([-1, far[0], -1, far[1], far[0]]), cuda)
    bl = _t(np.array([True, True, True, True, False]), cuda)
    ph = _t(np.array([-1, far[0], far[1], far[2], far[3], -1]), cuda)
    pl = torch.ones(6, dtype=torch.bool, device=cuda)
    got = HJ.lookup_join_cuda(bh, bl, ph, pl, cap)
    want = HJ.lookup_join_torch(bh, bl, ph, pl, cap)
    torch.cuda.synchronize()
    assert bool(got[2])
    real = [1, 2, 3, 4]
    assert torch.equal(got[0][real], want[0][real])
    assert torch.equal(got[1][real], want[1][real])
    assert got[0][[0, 5]].tolist() == [2, 2] and bool(got[1][[0, 5]].all())
    assert not bool(want[1][[0, 5]].any())


def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def _unmix32(x: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_mix32` (each step of fmix32 inverts)."""
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(pow(0xC2B2AE35, -1, 1 << 32))
        x ^= (x >> np.uint32(13)) ^ (x >> np.uint32(26))
        x *= np.uint32(pow(0x85EBCA6B, -1, 1 << 32))
        x ^= x >> np.uint32(16)
    return x


@pytest.mark.parametrize("capacity", [512, 1 << 21])
def test_lookup_join_chain_past_max_probes(cuda, capacity):
    # 300 distinct hashes with one home slot (the kernels' slot mix,
    # inverted: any high word, the low word that lands on slot 77): the
    # chain outgrows 256 probes and ok must clear, in the direct build
    # and in the partitioned one
    hi = np.arange(1, 301, dtype=np.uint32) * np.uint32(2654435761)
    lo = _unmix32(np.full(300, 77, np.uint32)) ^ _mix32(hi)
    assert (_mix32(lo ^ _mix32(hi)) == 77).all()
    h = ((hi.astype(np.uint64) << np.uint64(32))
         | lo.astype(np.uint64)).view(np.int64)
    assert len(np.unique(h)) == 300
    live = np.ones(300, bool)
    _row, _found, ok = HJ.lookup_join_cuda(
        _t(h, cuda), _t(live, cuda), _t(h, cuda), _t(live, cuda), capacity)
    assert not bool(ok)


def _star(device, seed=5):
    rng = np.random.default_rng(seed)
    n = 200_000

    def table(cols, live):
        return OP.DTable({k: Val(T.BIGINT, _t(v, device))
                          for k, v in cols.items()},
                         _t(live, device), len(live), device)
    spine = table({"s_a": rng.integers(0, 12_000, n),
                   "s_b": rng.integers(0, 600, n)}, rng.random(n) > 0.1)
    builds = [table({"a_key": rng.permutation(15_000)[:10_000],
                     "a_c": rng.integers(0, 4000, 10_000)},
                    rng.random(10_000) > 0.1),
              table({"b_key": rng.permutation(800)[:500],
                     "b_w": rng.integers(0, 9, 500)}, np.ones(500, bool)),
              table({"c_key": rng.permutation(4000)[:3500],
                     "c_name": rng.integers(0, 5, 3500)},
                    rng.random(3500) > 0.05)]
    crit = [[("s_a", "a_key")], [("s_b", "b_key")], [("a_c", "c_key")]]
    return spine, builds, type("Node", (), {"criteria": crit})()


def test_multijoin_matches_plain(cuda):
    spine, builds, node = _star(cuda)
    with K.use_backend("torch"):
        want, _ = OP.apply_multi_join(spine, builds, node)
    before = B.LAUNCHES.snapshot()
    with K.use_backend("cuda"):
        got, ok = OP.apply_multi_join(spine, builds, node)
    torch.cuda.synchronize()
    after = B.LAUNCHES.snapshot()
    assert bool(ok)
    assert after["multijoin_walk"] == before["multijoin_walk"] + 1
    assert after["build_table"] == before["build_table"] + 3
    assert torch.equal(got.live, want.live)
    for c in ("a_c", "b_w", "c_name"):
        assert torch.equal(got.cols[c].data, want.cols[c].data)


@pytest.mark.parametrize("case", ["width_1", "width_7", "remainder",
                                  "offset_alike", "offset_apart",
                                  "partitioned"])
def test_probe_table_matches_plain(cuda, case):
    # odd probe widths, views of the hash and live columns at offsets
    # (alike and apart), and a table past PARTITION_MIN_SLOTS
    n = {"width_1": 1, "width_7": 7}.get(case, 200_003)
    nb, cap = ((600_000, 1 << 21) if case == "partitioned"
               else (70_000, 1 << 17))
    bh, bl, ph, pl = _lookup_inputs(cuda, nb, n + 8, 4 * nb // 7, seed=n)
    assert (cap > HJ.PARTITION_MIN_SLOTS) == (case == "partitioned")
    lo = {"offset_alike": (1, 1), "offset_apart": (2, 1)}.get(case, (0, 0))
    hv, lv = ph[lo[0]:lo[0] + n], pl[lo[1]:lo[1] + n]
    table, b_ok = HJ.build_table(bh, bl, cap)
    before = B.LAUNCHES.snapshot()["probe_table"]
    row, found, ok = HJ.probe_table(table, hv, lv)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()["probe_table"] == before + 1
    want = HJ.lookup_join_torch(bh, bl, hv, lv, cap)
    assert bool(b_ok) and bool(ok)
    assert row.shape == found.shape == (n,)
    assert torch.equal(row, want[0]) and torch.equal(found, want[1])


@pytest.mark.parametrize("cap", [2048, 1 << 21])
def test_probe_table_empty_hash(cuda, cap):
    # R4 (test_lookup_join_empty_hash) in a table that fits the L2 and
    # in one past PARTITION_MIN_SLOTS
    _empty_hash_lookup(cuda, cap)


def test_probe_table_chain_past_max_probes(cuda):
    # 300 keys on one home slot of a table past PARTITION_MIN_SLOTS,
    # built with room for the chain: probed at 256 slots the chain's
    # tail is undecided and ok clears; at 512 every key is found
    cap = 1 << 21
    hi = np.arange(1, 301, dtype=np.uint32) * np.uint32(2654435761)
    lo = _unmix32(np.full(300, 77, np.uint32)) ^ _mix32(hi)
    h = _t(((hi.astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint64)).view(np.int64), cuda)
    live = torch.ones(300, dtype=torch.bool, device=cuda)
    table, b_ok = HJ.build_table(h, live, cap, max_probes=512)
    short = HJ.probe_table(table, h, live)
    full = HJ.probe_table(table, h, live, max_probes=512)
    torch.cuda.synchronize()
    assert bool(b_ok) and not bool(short[2]) and bool(full[2])
    assert full[0].tolist() == list(range(300)) and bool(full[1].all())


def _walk_chain(device, case, seed=11):
    """A spine and unique builds chained as ``case`` says, for the walk
    against its plain version: (spine cols, spine live, width, builds
    as (cols, live, n), criteria).

    - k1, k2, k3, k8: that many steps; step i is keyed by a column of
      step i - 1 when i is odd (a key chained from step 0 at i = 1,
      from a middle step at i = 3, 5, 7), by a spine column when even;
    - composite4: a step on a four-column key, then a chained step;
    - chain_middle: the third of three steps keyed by the second's
      column;
    - nulls: nulls in a spine key, a chained key and a build key;
    - width_3, offset_1, offset_4: the k3 chain over 3 spine rows, or
      with the spine live mask a view 1 or 4 rows into a longer one;
    - partitioned: a first build past PARTITION_MIN_SLOTS; in_l2: every
      table a few KB."""
    rng = np.random.default_rng(seed)
    width = {"width_3": 3, "partitioned": 1_500_003}.get(case, 200_003)
    k = {"k1": 1, "k2": 2, "k8": 8, "composite4": 2}.get(case, 3)
    size = {"partitioned": 600_000, "in_l2": 500}.get(case, 40_000)

    def col(a, valid=None):
        return Val(T.BIGINT, _t(a, device),
                   None if valid is None else _t(valid, device))
    spine = {}
    builds, crit = [], []
    for i in range(k):
        n = size if i == 0 else max(size // (i + 1), 50)
        keys = rng.permutation(2 * n)[:n]
        bcols = {f"b{i}_key": col(keys),
                 f"b{i}_x": col(rng.integers(0, 2 * max(size // (i + 2), 50),
                                             n))}
        chained = i % 2 == 1 or (case == "chain_middle" and i == 2)
        if case == "chain_middle" and i == 1:
            chained = False
        if chained:
            crit.append([(f"b{i - 1}_x", f"b{i}_key")])
        else:
            spine[f"s{i}"] = col(rng.integers(0, 2 * n, width))
            crit.append([(f"s{i}", f"b{i}_key")])
        builds.append((bcols, _t(rng.random(n) > 0.1, device), n))
    if case == "composite4":
        n = 3000
        combo = rng.permutation(20 ** 4)[:n]
        parts = [combo // 20 ** j % 20 for j in range(4)]
        builds[0] = ({**{f"b0_k{j}": col(parts[j]) for j in range(4)},
                      "b0_x": col(rng.integers(0, 2 * builds[1][2], n))},
                     _t(rng.random(n) > 0.1, device), n)
        for j in range(4):
            spine[f"s0_{j}"] = col(rng.integers(0, 20, width))
        crit[0] = [(f"s0_{j}", f"b0_k{j}") for j in range(4)]
    if case == "nulls":
        s0 = spine["s0"]
        spine["s0"] = col(s0.data.cpu().numpy(), rng.random(width) > 0.2)
        x = builds[0][0]["b0_x"]
        builds[0][0]["b0_x"] = col(x.data.cpu().numpy(),
                                   rng.random(x.data.shape[0]) > 0.25)
        key = builds[2][0]["b2_key"]
        builds[2][0]["b2_key"] = col(key.data.cpu().numpy(),
                                     rng.random(key.data.shape[0]) > 0.2)
    live = _t(rng.random(width + 8) > 0.05, device)
    at = {"offset_1": 1, "offset_4": 4}.get(case, 0)
    return spine, live[at:at + width], width, builds, crit


_WALK_CASES = ["k1", "k2", "k3", "k8", "composite4", "chain_middle",
               "nulls", "width_3", "offset_1", "offset_4", "partitioned",
               "in_l2"]


@pytest.mark.parametrize("case", _WALK_CASES)
def test_multijoin_walk_matches_plain(cuda, case):
    args = _walk_chain(cuda, case)
    spine, live, width, builds, crit = args
    if case == "partitioned":
        assert H.next_pow2(2 * builds[0][2]) > HJ.PARTITION_MIN_SLOTS
    want = MJ.multijoin_torch(*args)
    before = B.LAUNCHES.snapshot()
    with K.use_backend("cuda"):
        got = MJ.multijoin_cuda(*args)
    torch.cuda.synchronize()
    after = B.LAUNCHES.snapshot()
    assert after["multijoin_walk"] == before["multijoin_walk"] + 1
    assert after["build_table"] == before["build_table"] + len(builds)
    assert bool(got[2])
    assert torch.equal(got[1], want[1])
    if width > 3:
        assert 0 < int(got[1].sum()) < width
    for g, w in zip(got[0], want[0]):
        assert g.shape == (width,) and torch.equal(g, w)


def test_multijoin_walk_chain_past_max_probes(cuda):
    # one probe a row: a row whose home slot holds another key is left
    # undecided, and the walk alone clears ok (the tables built fine)
    spine, live, width, builds, crit = _walk_chain(cuda, "k3")
    steps = MJ._resolve(spine, builds, crit)
    desc, keep, oks = MJ.step_descriptors(steps, builds)
    _g, _a, ok = MJ.multijoin_walk(desc, len(steps), live, width)
    _g, _a, short = MJ.multijoin_walk(desc, len(steps), live, width,
                                      max_probes=1)
    torch.cuda.synchronize()
    assert all(bool(b) for b in oks) and bool(ok) and not bool(short)
    del keep


@pytest.mark.parametrize("case", ["nulls", "partitioned"])
def test_fused_walk_adds_no_host_sync(cuda, case):
    # the step descriptors go to the kernel as its parameter: no
    # blocking copy to the device, so the fused walk never waits on the
    # stream (torch raises on a synchronizing call in this mode), with
    # small tables and with a partitioned build's scratch
    args = _walk_chain(cuda, case)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with K.use_backend("cuda"):
            got = MJ.multijoin_cuda(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = MJ.multijoin_torch(*args)
    assert torch.equal(got[1], want[1])


CROSS_JOIN_SQL = """
select r_name, count(*) as c, sum(l_extendedprice) as s
from lineitem cross join region
where l_orderkey < 600
group by r_name
order by r_name"""


EXTREMA_SQL = """
select l_returnflag, l_linestatus, min(l_shipdate) as first_ship,
  max(l_receiptdate) as last_receipt, min(l_extendedprice) as min_price,
  max(l_quantity) as max_qty, min(l_discount) as min_disc
from lineitem
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""


@pytest.mark.parametrize("qname", [f"q{i:02d}" for i in range(1, 23)]
                         + ["cross_join", "extrema"])
def test_main_path_backends_agree(cuda, qname):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from tpch_queries import QUERIES
    sql = {"cross_join": CROSS_JOIN_SQL,
           "extrema": EXTREMA_SQL}.get(qname) or QUERIES[qname]
    e = Engine()
    e.register_catalog("tpch", TpchConnector(scale=0.01))
    rows = {}
    for backend in ("cuda", "torch"):
        e.session.set("kernel_backend", backend)
        rows[backend] = e.execute(sql)
    assert rows["cuda"] == rows["torch"] and rows["cuda"]
    if qname == "cross_join":
        notes = {t for tags in e.last_kernel_notes.values() for t in tags}
        assert "torch:compact" in notes
