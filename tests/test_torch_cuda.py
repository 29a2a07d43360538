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
from presto_tpu_torch.kernels import segagg as SA
from presto_tpu_torch.ops import hash as H

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
    return x, ids


@pytest.mark.parametrize("k", [1, 6, 4096, 70_000])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.bool_])
def test_segment_sum_matches_plain(cuda, dtype, k):
    x, ids = _seg_inputs(dtype, 200_000, k, seed=k)
    want = SA.segment_sum_torch(_t(x, cuda), _t(ids, cuda), k)
    before = B.LAUNCHES.snapshot()["segment_sum"]
    got = SA.segment_sum_cuda(_t(x, cuda), _t(ids, cuda), k)
    torch.cuda.synchronize()
    assert B.LAUNCHES.snapshot()["segment_sum"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


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


def _lookup_inputs(device, nb, npr, key_range, seed=0):
    rng = np.random.default_rng(seed)
    bk = _t(rng.integers(0, key_range, nb), device)
    pk = _t(rng.integers(0, 2 * key_range, npr), device)
    return (H.combine_hashes([H.hash_int_column(bk)]),
            _t(rng.random(nb) > 0.15, device),
            H.combine_hashes([H.hash_int_column(pk)]),
            _t(rng.random(npr) > 0.15, device))


@pytest.mark.parametrize("case", ["duplicates", "dead_rows",
                                  "empty_build"])
def test_lookup_join_matches_plain(cuda, case):
    bh, bl, ph, pl = _lookup_inputs(cuda, 70_000, 200_000, 40_000)
    if case == "dead_rows":
        bl[::3] = False
    if case == "empty_build":
        bl[:] = False
    want = HJ.lookup_join_torch(bh, bl, ph, pl, 1 << 17)
    got = HJ.lookup_join_cuda(bh, bl, ph, pl, 1 << 17)
    torch.cuda.synchronize()
    assert bool(got[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def test_lookup_join_chain_past_max_probes(cuda):
    # 300 distinct hashes with one home slot (the kernels' slot mix):
    # the chain outgrows 256 probes and ok must clear
    rng = np.random.default_rng(99)
    cand = rng.integers(0, 1 << 62, 400_000, dtype=np.uint64)
    hi = (cand >> np.uint64(32)).astype(np.uint32)
    lo = cand.astype(np.uint32)
    slot = _mix32(lo ^ _mix32(hi)) & np.uint32(511)
    h = cand[slot == np.bincount(slot).argmax()][:300].view(np.int64)
    assert len(h) == 300
    live = np.ones(300, bool)
    _row, _found, ok = HJ.lookup_join_cuda(
        _t(h, cuda), _t(live, cuda), _t(h, cuda), _t(live, cuda), 512)
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
