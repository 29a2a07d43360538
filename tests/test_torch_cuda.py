"""On the card only (marker ``cuda``): each CUDA kernel of
presto_tpu_torch against its plain PyTorch version, with exact
equality (live rows for the compaction), the 22 TPC-H queries and a
general cross join end to end on both backends, the projected
constants of ROADMAP's P1 against the port on the CPU, the 101
TPC-DS queries at scale 0.1 on both backends, and the executor's
default paths: carrier compaction through the kernel, a block-streamed
Q1 on both backends, and dynamic filtering and segmented plans without
a synchronizing call; the function library's aggregates and chip_smoke's
functions-phase queries on both backends (F1 and F4 also without a
synchronizing call) and min_by ties resolved to one row on every
backend; ARRAY values, lambdas, UNNEST, the variable-length aggregates
and MATCH_RECOGNIZE (the queries of the CPU tests and of chip_smoke's
arrays phase) on both backends against the port on the CPU, an UNNEST
and a lambda query without a synchronizing call, and the compaction of
an array's [n, 5] int32 and bool columns; a spilled join and a spilled
aggregate on both backends, a repeat query and a literal variant with
0 capacity rungs, and templated and prepared queries without a
synchronizing call. Elsewhere every test skips with its reason. This
file imports neither jax nor presto_tpu, so it runs where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import executor as EX
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

import torch_array_cases as AC
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


# -- the TPC-DS slice --------------------------------------------------------

# ROADMAP Queue 3, P1: projected constants (rows held against the
# reference and sqlite on the CPU by tests/test_torch_expressions.py),
# and the R6 divisions by a literal
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
    "select n_nationkey / 3 from nation",
    "select cast(n_nationkey as double) / 2.0e0 from nation",
    "select l_quantity / 2.00 from lineitem",
]


@pytest.fixture(scope="module")
def tpch_pair():
    """A card engine and a CPU engine over one SF0.01 connector."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card (this host has no CUDA device)")
    conn = TpchConnector(scale=0.01)
    card, host = Engine(), Engine(device="cpu")
    card.register_catalog("tpch", conn)
    host.register_catalog("tpch", conn)
    return card, host


@pytest.mark.parametrize("sql", P1_SQL)
def test_projected_constants_on_the_card(tpch_pair, sql):
    card, host = tpch_pair
    want = host.execute(sql)
    for backend in ("cuda", "torch"):
        card.session.set("kernel_backend", backend)
        assert card.execute(sql) == want, backend


def _tpcds_queries() -> dict[str, str]:
    """tests/test_tpcds.py's texts, read by chip_smoke's loader (that
    module imports presto_tpu; this file does not)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import tpcds_queries
    return tpcds_queries()


@pytest.fixture(scope="module")
def tpcds_card():
    """The port on the card over its TPC-DS connector at scale 0.1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card (this host has no CUDA device)")
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    e = Engine()
    e.register_catalog("tpcds", TpcdsConnector(scale=0.1))
    e.session.catalog = "tpcds"
    return e, _tpcds_queries()


@pytest.mark.parametrize("qname", sorted(_tpcds_queries()))
def test_tpcds_backends_agree(tpcds_card, qname):
    engine, queries = tpcds_card
    rows = {}
    for backend in ("cuda", "torch"):
        engine.session.set("kernel_backend", backend)
        rows[backend] = engine.execute(queries[qname])
        notes = {t for tags in engine.last_kernel_notes.values()
                 for t in tags}
        assert all(t.startswith(backend + ":") for t in notes), notes
    assert rows["cuda"] == rows["torch"]


# one statement for each node and expression family the TPC-DS slice
# ported
NEW_PATH_SQL = {
    "window": "select n_name, rank() over (partition by n_regionkey "
              "order by n_name), sum(n_nationkey) over (order by n_regionkey "
              "range between 1 preceding and 1 following) from nation",
    "union_rollup": "select n_regionkey, n_name, count(*) from nation "
                    "group by rollup(n_regionkey, n_name)",
    "full_join": "select count(*), count(c_custkey), count(o_orderkey) "
                 "from (select * from customer where c_custkey < 300) c "
                 "full join (select * from orders where o_orderkey < 3000) o "
                 "on c_custkey = o_custkey",
    "mark_distinct": "select count(distinct l_suppkey), count(distinct "
                     "l_partkey), count(*) from lineitem",
    "values": "select x from (select 1 as x union all select 2)",
    "expressions": "select coalesce(nullif(n_regionkey, 2), -n_nationkey), "
                   "abs(n_nationkey - 12) % 5, upper(concat(n_name, '!')), "
                   "n_comment is null, cast('1995-01-01' as date) "
                   "from nation",
    "variance": "select l_returnflag, stddev_samp(l_quantity), "
                "var_pop(l_extendedprice) from lineitem group by 1",
    # the executor's paths: a bloom of the part keys prunes lineitem;
    # TPC-H Q18 runs as two segments and a last program at SF0.01
    "dynamic_filter": "select sum(l_extendedprice) / 7.0 from lineitem, "
                      "part where p_partkey = l_partkey and p_brand = "
                      "'Brand#23' and p_container = 'MED BOX'",
    "segmented": "q18",
}


def _tpch_sql(name: str) -> str:
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from tpch_queries import QUERIES
    return QUERIES[name]


def _run_without_syncs(engine, sql, monkeypatch):
    """``engine.execute(sql)`` with every synchronizing CUDA call an
    error, except inside the executor's counted fetches."""
    from presto_tpu_torch.exec import hostsync as HS
    torch.cuda.synchronize()
    fetch = HS.fetch

    def counted_fetch(tree, site):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fetch(tree, site)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(HS, "fetch", counted_fetch)
    torch.cuda.set_sync_debug_mode("error")
    try:
        return engine.execute(sql)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        monkeypatch.setattr(HS, "fetch", fetch)


@pytest.mark.parametrize("name", sorted(NEW_PATH_SQL))
def test_new_paths_add_no_stream_sync(tpch_pair, name, monkeypatch):
    # between the executor's counted fetches (the ok ladder, the
    # segment widths and the result), the statement's operators never
    # wait for the stream: torch raises on a synchronizing call in this
    # mode
    card, host = tpch_pair
    sql = NEW_PATH_SQL[name]
    if sql.startswith("q"):
        sql = _tpch_sql(sql)
    on_host = host.execute(sql)
    card.session.set("kernel_backend", "cuda")
    want = card.execute(sql)  # uploads the columns, builds the kernels
    got = _run_without_syncs(card, sql, monkeypatch)
    if name == "segmented":
        assert card.last_run.segments
    if name == "dynamic_filter":
        (pruned,) = EX.scan_live_rows(card, "lineitem")
        assert pruned < 1000
    # float sums (the variance family's) may round apart between the
    # card and the CPU, or between two runs of a float atomic
    for rows in (want, on_host):
        assert len(got) == len(rows)
        for g, w in zip(got, rows):
            assert all(x == y or (isinstance(x, float) and
                                  abs(x - y) <= 1e-9 * max(abs(y), 1.0))
                       for x, y in zip(g, w)), (g, w)


def test_tpcds_segmented_query_adds_no_stream_sync(tpcds_card, monkeypatch):
    # q58 at scale 0.1 runs as seven segments in three waves
    engine, queries = tpcds_card
    engine.session.set("kernel_backend", "cuda")
    want = engine.execute(queries["q58"])
    got = _run_without_syncs(engine, queries["q58"], monkeypatch)
    assert [len(w) for w in engine.last_run.segments] == [2, 3, 2]
    assert got == want


def test_carrier_compaction_matches_plain(cuda):
    # a segment's output with about 5% live rows compacts to
    # pow2(live) through the compact kernel: int64 with NULLs, float64,
    # a LONG decimal's [n, 2] limbs, bool and a projected literal
    n = 300_007
    rng = np.random.default_rng(3)
    live = rng.random(n) < 0.05
    cols = {
        "i64": Val(T.BIGINT, _t(rng.integers(-2**62, 2**62, n), cuda),
                   _t(rng.random(n) < 0.9, cuda)),
        "f64": Val(T.DOUBLE, _t(rng.random(n), cuda)),
        "dec": Val(T.DecimalType(30, 2),
                   _t(rng.integers(-2**62, 2**62, (n, 2)), cuda)),
        "flag": Val(T.BOOLEAN, _t(rng.random(n) < 0.5, cuda)),
        "lit": Val(T.BIGINT, torch.tensor(7, device=cuda)),
    }
    dt = OP.DTable(cols, _t(live, cuda), n, cuda)
    outs = {}
    for backend in ("cuda", "torch"):
        before = B.LAUNCHES.snapshot().get("filter_compact", 0)
        with K.use_backend(backend):
            outs[backend] = EX.device_outputs(dt)
        launched = B.LAUNCHES.snapshot().get("filter_compact", 0) - before
        assert launched == (1 if backend == "cuda" else 0)
    got, want = outs["cuda"], outs["torch"]
    assert got[3] == want[3] == H.next_pow2(int(live.sum()))
    assert torch.equal(got[4], want[4])
    rows = got[4]
    assert int(rows.sum()) == int(live.sum())
    for k in want[0]:
        assert torch.equal(got[0][k][rows], want[0][k][rows]), k
    assert bool((got[0]["lit"][rows] == 7).all())


def test_streamed_q1_equals_whole_table_on_both_backends(cuda):
    sql = _tpch_sql("q01")
    e = Engine()
    e.register_catalog("tpch", TpchConnector(scale=0.01))
    rows = {}
    for backend in ("cuda", "torch"):
        e.session.set("kernel_backend", backend)
        for block in (0, 7000):
            e.session.set("scan_block_rows", block)
            rows[(backend, block)] = e.execute(sql)
            assert e.last_streamed_blocks == (9 if block else 0)
    assert len(set(map(repr, rows.values()))) == 1 and rows[("cuda", 0)]


# -- the function library (ROADMAP Queue 1 items 3a and 3d) -------------------


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


# one statement per aggregate of item 3d, folded over the sorted groups
# of l_suppkey % 16 (and, for the sketches, globally)
NEW_AGG_SQL = {
    "count_if": "count_if(l_discount > 0.05)",
    "bool_and": "bool_and(l_quantity < 50)",
    "bool_or": "bool_or(l_tax = 0)",
    "every": "every(l_shipdate < l_receiptdate)",
    "skewness": "skewness(l_discount)",
    "kurtosis": "kurtosis(l_extendedprice)",
    "geometric_mean": "geometric_mean(l_quantity)",
    "checksum": "checksum(l_comment)",
    "min_by": "min_by(l_orderkey, l_extendedprice)",
    "max_by": "max_by(l_shipdate, l_orderkey * 8 + l_linenumber)",
    "corr": "corr(l_quantity, l_extendedprice)",
    "covar_samp": "covar_samp(l_quantity, l_tax)",
    "covar_pop": "covar_pop(l_discount, l_tax)",
    "regr_slope": "regr_slope(l_quantity, l_extendedprice)",
    "regr_intercept": "regr_intercept(l_quantity, l_extendedprice)",
    "approx_distinct": "approx_distinct(l_partkey)",
    "approx_percentile": "approx_percentile(l_extendedprice, 0.3)",
}
FLOAT_AGGS = {"skewness", "kurtosis", "geometric_mean", "corr", "covar_samp",
              "covar_pop", "regr_slope", "regr_intercept"}


@pytest.fixture(scope="module")
def tpch_sf01():
    """The port on the card over TPC-H at scale 0.1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card (this host has no CUDA device)")
    e = Engine()
    e.register_catalog("tpch", TpchConnector(scale=0.1))
    return e


def _agree(got, want, floats=()) -> bool:
    """Identical rows; the columns in ``floats`` (float states, which
    sum with atomics on the card) as chip_smoke.rows_agree takes them."""
    cs = _chip_smoke()
    return len(got) == len(want) and all(
        (a == b) if i not in floats else cs.floats_agree(a, b)
        for g, w in zip(got, want) for i, (a, b) in enumerate(zip(g, w)))


@pytest.mark.parametrize("shape", ["grouped", "global"])
@pytest.mark.parametrize("fn", sorted(NEW_AGG_SQL))
def test_new_aggregates_backends_agree(tpch_sf01, fn, shape):
    expr = NEW_AGG_SQL[fn]
    sql = (f"select l_suppkey % 16 as g, {expr} from lineitem group by 1 "
           "order by 1" if shape == "grouped"
           else f"select {expr} from lineitem")
    rows, notes = {}, {}
    for backend in ("cuda", "torch"):
        tpch_sf01.session.set("kernel_backend", backend)
        rows[backend] = tpch_sf01.execute(sql)
        notes[backend] = {t for tags in tpch_sf01.last_kernel_notes.values()
                          for t in tags}
    floats = (len(rows["cuda"][0]) - 1,) if fn in FLOAT_AGGS else ()
    assert rows["cuda"] and _agree(rows["cuda"], rows["torch"], floats)
    if fn == "approx_distinct":
        assert "cuda:agg_max" in notes["cuda"]
    if fn == "approx_percentile":
        assert "cuda:agg_min" in notes["cuda"]


@pytest.mark.parametrize("name", ["F1", "F2", "F3", "F4_dates",
                                  "F4_date_format", "F5", "F6", "F7"])
def test_function_queries_backends_agree(tpch_sf01, name):
    cs = _chip_smoke()
    sql = cs.FUNCTION_QUERIES[name]
    rows, notes = {}, {}
    for backend in ("cuda", "torch"):
        tpch_sf01.session.set("kernel_backend", backend)
        rows[backend] = tpch_sf01.execute(sql)
        notes[backend] = {t for tags in tpch_sf01.last_kernel_notes.values()
                          for t in tags}
    assert rows["cuda"] and cs.rows_agree(name, rows["cuda"], rows["torch"])
    if name in cs.SKETCH_QUERIES:
        assert {"cuda:agg_max", "cuda:agg_min"} <= notes["cuda"]


@pytest.mark.parametrize("name", ["F1", "F4_dates", "F4_date_format"])
def test_function_queries_add_no_stream_sync(tpch_pair, name, monkeypatch):
    card, host = tpch_pair
    cs = _chip_smoke()
    sql = cs.FUNCTION_QUERIES[name]
    card.session.set("kernel_backend", "cuda")
    want = card.execute(sql)  # uploads the columns, builds the kernels
    got = _run_without_syncs(card, sql, monkeypatch)
    assert cs.rows_agree(name, got, want)
    assert cs.rows_agree(name, got, host.execute(sql))


MIN_BY_TIES_SQL = """
select l_suppkey % 7 as g, min_by(l_orderkey, l_quantity),
  max_by(l_linenumber, l_tax),
  min_by(case when l_linenumber = 2 then null else l_partkey end, l_discount)
from lineitem group by 1 order by 1"""


@pytest.mark.parametrize("block", [0, 20_000])
def test_min_by_ties_pick_one_row_on_every_backend(tpch_pair, block):
    """l_quantity, l_tax and l_discount take a few dozen values, so each
    group's extremum ties over many rows: every backend names the same
    row (the lowest index attaining it), its value and validity alike,
    also merged over streamed blocks."""
    card, host = tpch_pair
    rows = {"host": host.execute(MIN_BY_TIES_SQL)}
    for backend in ("cuda", "torch"):
        card.session.set("kernel_backend", backend)
        card.session.set("scan_block_rows", block)
        try:
            rows[backend] = card.execute(MIN_BY_TIES_SQL)
            if block:
                assert card.last_streamed_blocks > 1
            rows[backend + " again"] = card.execute(MIN_BY_TIES_SQL)
        finally:
            card.session.set("scan_block_rows", 1 << 24)
    assert len(set(map(repr, rows.values()))) == 1 and rows["host"]
    globally = "select min_by(l_orderkey, l_quantity) from lineitem"
    want = host.execute(globally)
    for backend in ("cuda", "torch"):
        card.session.set("kernel_backend", backend)
        assert card.execute(globally) == want


# -- ARRAY values, lambdas, UNNEST, varlen, MATCH_RECOGNIZE (items 3e, 4) --------


@pytest.mark.parametrize("n", [1000, 300_007])
def test_filter_compact_array_columns(cuda, n):
    # an ARRAY column's [n, 5] int32 data (20-byte rows), its [n, 5]
    # bool element mask (5-byte rows), its int32 lengths and a [n, 3]
    # int64 array beside them
    rng = np.random.default_rng(n)
    live = _t(rng.random(n) < 0.3, cuda)
    arrays = {"d": _t(rng.integers(-(1 << 30), 1 << 30, (n, 5))
                      .astype(np.int32), cuda),
              "e": _t(rng.random((n, 5)) < 0.7, cuda),
              "l": _t(rng.integers(0, 6, n).astype(np.int32), cuda),
              "w": _t(rng.integers(-(1 << 62), 1 << 62, (n, 3)), cuda)}
    for view in ("aligned", "offset"):
        tl = live if view == "aligned" else live[1:]
        ta = arrays if view == "aligned" else {k: a[1:]
                                               for k, a in arrays.items()}
        capacity = int(tl.sum())
        want = CP.filter_compact_torch(tl, ta, capacity)
        before = B.LAUNCHES.snapshot()["filter_compact"]
        got = CP.filter_compact_cuda(tl, ta, capacity)
        torch.cuda.synchronize()
        assert B.LAUNCHES.snapshot()["filter_compact"] == before + 1
        for k in ta:
            assert got[k].shape == want[k].shape
            assert torch.equal(got[k], want[k]), (view, k)


def _card_and_host(tables: dict):
    """A card engine and a CPU engine over the memory tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on "
                    "the card (this host has no CUDA device)")
    from presto_tpu_torch.connectors.memory import MemoryConnector
    return tuple(AC.memory_engine(e, MemoryConnector(), T, tables)
                 for e in (Engine(), Engine(device="cpu")))


def _rows_close(got, want) -> bool:
    """Equal rows; doubles (also inside arrays) within 1e-9 relative:
    the card sums in another order."""
    def close(a, b):
        if isinstance(b, list):
            return (isinstance(a, list) and len(a) == len(b)
                    and all(close(x, y) for x, y in zip(a, b)))
        if isinstance(b, (float, np.floating)):
            return a is not None and abs(a - b) <= 1e-9 * max(abs(b), 1.0)
        return a == b
    return len(got) == len(want) and all(
        len(g) == len(w) and all(close(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want))


def _both_backends(card, host, sql):
    want = host.execute(sql)
    for backend in ("cuda", "torch"):
        card.session.set("kernel_backend", backend)
        got = card.execute(sql)
        assert _rows_close(got, want), (backend, got[:3], want[:3])
    return want


@pytest.mark.parametrize("sql", AC.ARRAY_SQL + AC.VARLEN_SQL
                         + [AC.ORDERS_BY_CUSTOMER_SQL])
def test_array_sql_backends_agree(tpch_pair, sql):
    _both_backends(*tpch_pair, sql)


@pytest.fixture(scope="module")
def random_arrays_card():
    return _card_and_host({"t": AC.random_arrays(T)})


@pytest.mark.parametrize("name", sorted(AC.RANDOM_SQL))
def test_array_scalars_backends_agree(random_arrays_card, name):
    _both_backends(*random_arrays_card, AC.RANDOM_SQL[name])


@pytest.fixture(scope="module")
def nulls_card():
    return _card_and_host({"t": AC.nulls_and_ties(T)})


@pytest.mark.parametrize("name", sorted(AC.NULLS_SQL))
def test_varlen_nulls_backends_agree(nulls_card, name):
    _both_backends(*nulls_card, AC.NULLS_SQL[name])


@pytest.fixture(scope="module")
def series_card():
    return _card_and_host({"ticks": AC.bigint_table(T, AC.TICKS),
                           "series": AC.bigint_table(T, AC.random_series())})


@pytest.mark.parametrize("name", sorted(AC.MR_HAND) + [
    f"random_{q}" for q in sorted(AC.MR_RANDOM_SQL)])
def test_match_recognize_backends_agree(series_card, name):
    if name.startswith("random_"):
        sql = AC.MR_RANDOM_SQL[name[len("random_"):]]
        want = None
    else:
        sql, want = AC.MR_HAND[name]
    rows = _both_backends(*series_card, sql)
    assert rows and (want is None or rows == want)


ARRAY_NO_SYNC_SQL = {
    "unnest": "select n_name, x, o from nation, unnest(split(n_comment, "
              "' ')) with ordinality t(x, o) where o < 4",
    "lambda": "select p_partkey, transform(split(p_type, ' '), "
              "s -> upper(s)), reduce(filter(array[p_size, p_partkey % 7, "
              "3], x -> x % 2 = 1), 0, (a, x) -> a + x), "
              "any_match(array[p_size], x -> x > 40), "
              "array_position(array_sort(array[p_size % 5, 2, 1]), 2), "
              "cardinality(array_distinct(array[p_size % 3, p_size % 2])), "
              "element_at(map(array['SM CASE', 'LG BOX'], array[1, 2]), "
              "p_container) from part where p_partkey < 200",
}


@pytest.mark.parametrize("name", sorted(ARRAY_NO_SYNC_SQL))
def test_array_paths_add_no_stream_sync(tpch_pair, name, monkeypatch):
    card, host = tpch_pair
    sql = ARRAY_NO_SYNC_SQL[name]
    card.session.set("kernel_backend", "cuda")
    want = card.execute(sql)  # uploads the columns, builds the kernels
    got = _run_without_syncs(card, sql, monkeypatch)
    assert got == want == host.execute(sql) and got


def test_array_queries_backends_agree(tpch_sf01):
    # chip_smoke's arrays phase at SF0.1 (every customer is inside A5's
    # cut), held to its numpy checks
    cs = _chip_smoke()
    conn = tpch_sf01.catalogs["tpch"]
    cut = cs.cut_orders(conn)
    tpch_sf01.register_catalog("cut", cut)
    rows = {}
    for name, sql in cs.ARRAY_QUERIES.items():
        by_backend, notes = {}, {}
        for backend in ("cuda", "torch"):
            tpch_sf01.session.set("kernel_backend", backend)
            by_backend[backend] = tpch_sf01.execute(sql)
            notes[backend] = {t for tags in
                              tpch_sf01.last_kernel_notes.values()
                              for t in tags}
        assert by_backend["cuda"] and \
            by_backend["cuda"] == by_backend["torch"], name
        # A2's carrier is cut (and compacted) only past
        # AGG_SPLIT_MIN_ROWS scan rows, which SF0.1 does not reach
        if name in cs.ARRAY_QUERY_KERNELS and name != "A2":
            assert cs.ARRAY_QUERY_KERNELS[name] in notes["cuda"], name
        rows[name] = by_backend["cuda"]
    cs.check_arrays(conn, cut, rows)


# -- spill, the capacity memory and templates (ROADMAP Queue 1 items 4, 5)

SPILL_CASES = {
    # (the SQL, query_max_memory_bytes): tests/test_torch_spill.py's
    "join": ("select o_orderpriority, count(*) as c, sum(l_quantity) as q "
             "from orders, lineitem where o_orderkey = l_orderkey and "
             "l_shipdate > date '1995-01-01' group by o_orderpriority "
             "order by o_orderpriority", 200_000),
    "aggregate": ("select l_orderkey, l_linenumber, count(*) as c, "
                  "sum(l_quantity) as q, min(l_shipdate) as d from lineitem "
                  "group by l_orderkey, l_linenumber "
                  "order by l_orderkey, l_linenumber limit 50", 400_000),
}


@pytest.mark.parametrize("name", sorted(SPILL_CASES))
def test_spill_backends_agree(tpch_pair, name):
    # host-partitioned under the budget on both backends, rows equal to
    # the unspilled run on the CPU
    card, host = tpch_pair
    sql, budget = SPILL_CASES[name]
    want = host.execute(sql)
    rows = {}
    try:
        card.session.set("query_max_memory_bytes", budget)
        for backend in ("cuda", "torch"):
            card.session.set("kernel_backend", backend)
            rows[backend] = card.execute(sql)
            assert card.last_spill["partitions"] >= 2, card.last_spill
            notes = {t for tags in card.last_kernel_notes.values()
                     for t in tags}
            assert all(t.startswith(backend + ":") for t in notes), notes
    finally:
        card.session.set("query_max_memory_bytes", 0)
    assert rows["cuda"] == rows["torch"] == want and want


def test_repeat_and_variant_take_no_rungs(tpch_pair):
    # Q18 overflows a 16-slot group table on its first run; the repeat
    # and the literal variant start from the remembered capacities
    card, host = tpch_pair
    sql = _tpch_sql("q18")
    variant = sql.replace("> 300", "> 312")
    assert variant != sql
    card.session.set("kernel_backend", "cuda")
    card.session.set("groupby_table_size", 16)
    try:
        first = card.execute(sql)
        assert card.last_run.rungs > 0
        assert card.execute(sql) == first
        assert card.last_run.rungs == 0 and all(card.last_run.from_memory)
        got = card.execute(variant)
        assert card.last_run.rungs == 0 and all(card.last_run.from_memory)
    finally:
        card.session.set("groupby_table_size", 0)
    assert first == host.execute(sql)
    assert got == host.execute(variant)


TEMPLATE_NO_SYNC = {
    # (the first statement, the variant run without a synchronizing
    # call): a date, decimal and varchar parameter of a template hit
    "q05": ("q05", ("ASIA", "EUROPE")),
    "q06": ("q06", ("0.05 and 0.07", "0.03 and 0.05")),
}


@pytest.mark.parametrize("name", sorted(TEMPLATE_NO_SYNC) + ["prepared"])
def test_templated_query_adds_no_stream_sync(tpch_pair, name, monkeypatch):
    card, host = tpch_pair
    card.session.set("kernel_backend", "cuda")
    if name == "prepared":
        card.execute("prepare card_q from select count(*) from orders "
                     "where o_orderdate < ? and o_orderpriority = ?")
        card.execute("execute card_q using date '1995-01-01', '1-URGENT'")
        sql = "execute card_q using date '1996-01-01', '2-HIGH'"
        want = host.execute("select count(*) from orders where o_orderdate "
                            "< date '1996-01-01' and o_orderpriority = "
                            "'2-HIGH'")
    else:
        qname, (old, new) = TEMPLATE_NO_SYNC[name]
        card.execute(_tpch_sql(qname))
        sql = _tpch_sql(qname).replace(old, new)
        want = host.execute(sql)
    got = _run_without_syncs(card, sql, monkeypatch)
    assert all(card.last_run.from_memory)
    assert got == want and got
