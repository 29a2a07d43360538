"""The distributed slice's building blocks against presto_tpu, on the
same numpy inputs: partition_id and its numpy twins bit for bit
(presto_tpu_torch/ops/hash.py), bucket_by_partition, repartition and
broadcast_gather over LocalShardGroup(8, "cpu") against the
reference's under a shard_map on the 8 CPU devices
(presto_tpu_torch/parallel/exchange.py), a scan's shard placement,
block and bucketed (parallel/executor._shard_scan_arrays), and the
merge-exchange operators merge_runs_perm, merge_sorted_runs and head
(exec/operators.py). Exact equality throughout: no float is computed,
only moved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from presto_tpu.exec import operators as ROP
from presto_tpu.exec.executor import ScanInput as RefScanInput
from presto_tpu.expr.compile import Val as RVal
from presto_tpu.ops import hash as RH
from presto_tpu.parallel import exchange as RX
from presto_tpu.parallel.executor import _shard_scan_arrays as ref_shard
from presto_tpu.plan import nodes as RN
from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch.exec.executor import ScanInput
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr.compile import Val
from presto_tpu_torch.ops import hash as H
from presto_tpu_torch.parallel import exchange as X
from presto_tpu_torch.parallel.executor import _shard_scan_arrays
from presto_tpu_torch.parallel.group import (COLLECTIVES, LocalShardGroup)
from presto_tpu_torch.plan import nodes as N

try:  # new jax: top-level API
    _shard_map = jax.shard_map
except AttributeError:  # 0.4.x
    from jax.experimental.shard_map import shard_map as _shard_map
import inspect as _inspect

_NOCHECK = ({"check_vma": False}
            if "check_vma" in _inspect.signature(_shard_map).parameters
            else {"check_rep": False})

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module
    runs: the test workers run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261018)


def _ints(rng, n):
    x = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    x[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    return x


# -- partition_id and the numpy twins ---------------------------------------


@pytest.mark.parametrize("nparts", [2, 3, 8])
def test_partition_id_bit_for_bit(rng, nparts):
    h = _ints(rng, 20000)
    assert (h < 0).sum() > 1000  # negative int64 patterns: hashes >= 2^63
    want = np.asarray(RH.partition_id(jnp.asarray(h.view(np.uint64)),
                                      nparts))
    got = H.partition_id(torch.from_numpy(h), nparts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        H.np_partition_id(h.view(np.uint64), nparts), want)
    np.testing.assert_array_equal(
        RH.np_partition_id(h.view(np.uint64), nparts),
        H.np_partition_id(h.view(np.uint64), nparts))


def test_numpy_twins_bit_for_bit(rng):
    x = _ints(rng, 5000)
    valid = rng.random(x.shape[0]) > 0.2
    np.testing.assert_array_equal(H.np_splitmix64(x),
                                  RH.np_splitmix64(x))
    for v in (None, valid):
        np.testing.assert_array_equal(H.np_hash_int_column(x, v),
                                      RH.np_hash_int_column(x, v))
        # the host twin equals the device hash's bits
        np.testing.assert_array_equal(
            H.np_hash_int_column(x, v),
            H.hash_int_column(torch.from_numpy(x), None if v is None
                              else torch.from_numpy(v)).numpy()
            .view(np.uint64))
    d = np.asarray(["aa", "bb", "", "dd", "é"], object)
    codes = rng.integers(0, len(d), 2000).astype(np.int32)
    for v in (None, valid[:2000]):
        np.testing.assert_array_equal(
            H.np_hash_string_column(codes, d, v),
            RH.np_hash_string_column(codes, d, v))
    np.testing.assert_array_equal(
        H.np_hash_string_column(codes, np.asarray([], object)),
        RH.np_hash_string_column(codes, np.asarray([], object)))
    hs = [H.np_hash_int_column(x), H.np_hash_int_column(x[::-1].copy()),
          H.np_splitmix64(x)]
    np.testing.assert_array_equal(H.np_combine_hashes(hs),
                                  RH.np_combine_hashes(hs))
    np.testing.assert_array_equal(
        H.np_combine_hashes(hs),
        H.combine_hashes([torch.from_numpy(h.view(np.int64)) for h in hs])
        .numpy().view(np.uint64))


# -- bucket_by_partition ----------------------------------------------------


def _cols(rng, n):
    return {"i": _ints(rng, n),
            "f": rng.standard_normal(n),
            "limbs": rng.integers(-(1 << 40), 1 << 40, (n, 2)),
            "b": rng.random(n) > 0.5,
            "i$valid": rng.random(n) > 0.1}


@pytest.mark.parametrize("capacity", [512, 64])
def test_bucket_by_partition_equals_reference(rng, capacity):
    n, parts = 2000, 8
    cols = _cols(rng, n)
    live = rng.random(n) > 0.25
    pid = rng.integers(0, parts, n).astype(np.int32)
    want, wvalid, wok = RX.bucket_by_partition(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(live),
        jnp.asarray(pid), parts, capacity)
    got, valid, ok = X.bucket_by_partition(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        torch.from_numpy(live), torch.from_numpy(pid), parts, capacity)
    assert bool(ok) == bool(wok) == (capacity == 512)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    for k in cols:
        assert got[k].shape == (parts, capacity) + cols[k].shape[1:]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- repartition and broadcast_gather over 8 shards -------------------------


def _shards(rng, nshards=8, n=300):
    return [({"k": rng.integers(0, 50, n).astype(np.int64),
              "f": rng.standard_normal(n),
              "limbs": rng.integers(-99, 99, (n, 2)),
              "k$valid": rng.random(n) > 0.1},
             rng.random(n) > 0.3) for _ in range(nshards)]


def _ref_repartition(mesh, shards, capacity, nparts=8):
    names = list(shards[0][0])
    stacked = [np.concatenate([c[k] for c, _ in shards]) for k in names]
    live = np.concatenate([lv for _, lv in shards])

    def body(live, *arrays):
        cols = dict(zip(names, arrays))
        pid = RH.partition_id(RH.hash_int_column(cols["k"]), nparts)
        ex, valid, ok = RX.repartition(cols, live, pid, nparts, capacity,
                                       "d")
        return tuple(ex[k] for k in names), valid, ok[None]

    f = _shard_map(body, mesh=mesh, in_specs=(P("d"),) * (len(names) + 1),
                   out_specs=((P("d"),) * len(names), P("d"), P("d")),
                   **_NOCHECK)
    ex, valid, ok = jax.jit(f)(jnp.asarray(live),
                               *[jnp.asarray(a) for a in stacked])
    return dict(zip(names, map(np.asarray, ex))), np.asarray(valid), \
        np.asarray(ok)


@pytest.mark.parametrize("capacity", [256, 16])
def test_repartition_equals_reference_shard_map(rng, mesh, capacity):
    shards = _shards(rng)
    want, wvalid, wok = _ref_repartition(mesh, shards, capacity)
    group = LocalShardGroup(8, "cpu")
    COLLECTIVES.reset()
    cols = [{k: torch.from_numpy(v) for k, v in c.items()}
            for c, _ in shards]
    pid = [H.partition_id(H.hash_int_column(c["k"]), 8) for c in cols]
    ex, valid, ok = X.repartition(group, cols,
                                  [torch.from_numpy(lv) for _, lv in shards],
                                  pid, 8, capacity)
    assert [bool(o) for o in ok] == [bool(o) for o in wok]
    assert all(bool(o) for o in ok) == (capacity == 256)
    np.testing.assert_array_equal(torch.cat(valid).numpy(), wvalid)
    for k in want:
        np.testing.assert_array_equal(
            torch.cat([e[k] for e in ex]).numpy(), want[k])
    # one all_to_all per column and one for the mask; one min-reduce of ok
    calls = COLLECTIVES.snapshot()["calls"]
    assert calls == {"all_to_all": len(want) + 1, "all_reduce": 1}
    if capacity == 256:
        # every live row arrived exactly once, on the shard of its key
        sent = sorted(int(v) for c, lv in shards for v in c["k"][lv])
        got = [int(v) for e, vm in zip(ex, valid)
               for v in e["k"][vm].tolist()]
        assert sorted(got) == sent
        for s, (e, vm) in enumerate(zip(ex, valid)):
            keys = e["k"][vm]
            assert (H.partition_id(H.hash_int_column(keys), 8) == s).all()


def test_broadcast_gather_equals_reference_shard_map(rng, mesh):
    shards = _shards(rng)
    names = list(shards[0][0])

    def body(live, *arrays):
        out, valid = RX.broadcast_gather(dict(zip(names, arrays)), live, "d")
        return tuple(out[k] for k in names), valid

    f = _shard_map(body, mesh=mesh, in_specs=(P("d"),) * (len(names) + 1),
                   out_specs=((P(),) * len(names), P()), **_NOCHECK)
    wout, wvalid = jax.jit(f)(
        jnp.asarray(np.concatenate([lv for _, lv in shards])),
        *[jnp.asarray(np.concatenate([c[k] for c, _ in shards]))
          for k in names])
    group = LocalShardGroup(8, "cpu")
    COLLECTIVES.reset()
    out, valid = X.broadcast_gather(
        group, [{k: torch.from_numpy(v) for k, v in c.items()}
                for c, _ in shards],
        [torch.from_numpy(lv) for _, lv in shards])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    for k, w in zip(names, wout):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(w))
    snap = COLLECTIVES.snapshot()
    assert snap["calls"] == {"all_gather": len(names) + 1}
    # the bytes are what the whole group contributes
    assert snap["bytes"]["all_gather"] == sum(
        v.nbytes for c, lv in shards for v in list(c.values()) + [lv])


def test_local_group_collectives():
    g = LocalShardGroup(3, "cpu")
    xs = [torch.arange(12).reshape(3, 2, 2) + 100 * s for s in range(3)]
    out = g.all_to_all(xs)
    for s in range(3):
        np.testing.assert_array_equal(
            out[s].numpy(), np.concatenate([x[s].numpy() for x in xs]))
    red = [torch.tensor([1, 5, -2]), torch.tensor([3, 0, 4]),
           torch.tensor([2, 2, 2])]
    assert g.all_reduce(red, "sum")[0].tolist() == [6, 7, 4]
    assert g.all_reduce(red, "min")[1].tolist() == [1, 0, -2]
    assert g.all_reduce(red, "max")[2].tolist() == [3, 5, 4]
    flags = [torch.tensor([True, False]), torch.tensor([True, True]),
             torch.tensor([False, True])]
    assert g.all_reduce(flags, "min")[0].tolist() == [False, False]
    assert g.all_reduce(flags, "max")[0].tolist() == [True, True]
    gathered = g.all_gather(red)
    assert gathered[0] is gathered[2]  # held once per process
    assert gathered[0].tolist() == [1, 5, -2, 3, 0, 4, 2, 2, 2]


# -- a scan's shard placement -----------------------------------------------


def _scan_pair(rng, n, with_mask):
    keys = rng.integers(0, 1000, n).astype(np.int64)
    names = np.asarray(["x", "yy", "zzz"], object)
    codes = rng.integers(0, 3, n).astype(np.int32)
    vals = rng.standard_normal(n)
    valid = rng.random(n) > 0.2
    mask = rng.random(n) > 0.1 if with_mask else None
    tbl = Table({"k": Column(T.BIGINT, keys, None),
                 "s": Column(T.VARCHAR, codes, None, names),
                 "v": Column(T.DOUBLE, vals, valid)}, n, mask)
    node = N.TableScan("c", "t", {"k1": "k", "s1": "s", "v1": "v"},
                       {"k1": T.BIGINT, "s1": T.VARCHAR, "v1": T.DOUBLE})
    host = {"k1": keys, "s1": codes, "v1": vals, "v1$valid": valid}
    port = ScanInput(node, {k: torch.from_numpy(a) for k, a in host.items()},
                     {"k1": None, "s1": names, "v1": None},
                     dict(node.types), n,
                     None if mask is None else torch.from_numpy(mask),
                     host_table=tbl)
    ref_arrays = dict(host)
    if mask is not None:
        ref_arrays["__live__"] = mask
    ref = RefScanInput(None, ref_arrays, {"k1": None, "s1": names,
                                          "v1": None}, {}, n)
    return port, ref


@pytest.mark.parametrize("n", [1000, 3, 0])
def test_block_sharding_equals_reference(rng, n):
    port, ref = _scan_pair(rng, n, with_mask=False)
    want = ref_shard(ref, 8)
    got = _shard_scan_arrays(port, LocalShardGroup(8, "cpu"))
    assert len(got) == 8
    for k, w in want.items():
        np.testing.assert_array_equal(
            torch.cat([g[k] for g in got]).numpy(), w)


@pytest.mark.parametrize("part_cols", [("k1",), ("s1", "k1")])
@pytest.mark.parametrize("with_mask", [False, True])
def test_bucketed_sharding_equals_reference(rng, part_cols, with_mask):
    port, ref = _scan_pair(rng, 1000, with_mask)
    port.part_cols = ref.part_cols = part_cols
    want = ref_shard(ref, 8, bucketed=True)
    got = _shard_scan_arrays(port, LocalShardGroup(8, "cpu"), bucketed=True)
    for k, w in want.items():
        np.testing.assert_array_equal(
            torch.cat([g[k] for g in got]).numpy(), w, err_msg=k)
    # a shard holds the rows whose key hashes to it
    for s, g in enumerate(got):
        h = H.combine_hashes([
            H.hash_string_column(g[c], port.dictionaries[c])
            if c == "s1" else H.hash_int_column(g[c]) for c in part_cols])
        assert (H.partition_id(h, 8)[g["__live__"]] == s).all()


# -- merge exchange operators -----------------------------------------------


def _runs(rng, k, m):
    n = k * m
    a = rng.integers(-5, 5, n).astype(np.int64)  # ties across runs
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.05] = np.nan
    fvalid = rng.random(n) > 0.1
    live = rng.random(n) > 0.2
    return a, f, fvalid, live


def _port_dt(a, f, fvalid, live):
    return DTable({"a": Val(T.BIGINT, torch.from_numpy(a)),
                   "f": Val(T.DOUBLE, torch.from_numpy(f),
                            torch.from_numpy(fvalid))},
                  torch.from_numpy(live), len(a), CPU)


def _ref_dt(a, f, fvalid, live):
    return ROP.DTable({"a": RVal(T.BIGINT, jnp.asarray(a)),
                       "f": RVal(T.DOUBLE, jnp.asarray(f),
                                 jnp.asarray(fvalid))},
                      jnp.asarray(live), len(a))


ORDERINGS = [[N.Ordering("f", False, None), N.Ordering("a", True, None)],
             [N.Ordering("a", True, True)]]


@pytest.mark.parametrize("oi", [0, 1])
@pytest.mark.parametrize("k,m", [(8, 64), (3, 17), (2, 1)])
def test_merge_sorted_runs_equals_reference(rng, oi, k, m):
    orderings = ORDERINGS[oi]
    r_orderings = [RN.Ordering(o.symbol, o.ascending, o.nulls_first)
                   for o in orderings]
    arrays = _runs(rng, k, m)
    # each run sorted on its own first, as the shards would
    parts = []
    rparts = []
    for j in range(k):
        sl = [x[j * m:(j + 1) * m] for x in arrays]
        parts.append(OP.apply_sort(_port_dt(*sl), orderings))
        rparts.append(ROP.apply_sort(_ref_dt(*sl), r_orderings))
    runs = OP.concat_dtables(parts)
    rruns = ROP.concat_dtables(rparts)
    np.testing.assert_array_equal(
        OP.merge_runs_perm(OP._sort_keys(runs, orderings), k, m).numpy(),
        np.asarray(ROP.merge_runs_perm(ROP._sort_keys(rruns, r_orderings),
                                       k, m)))
    got = OP.merge_sorted_runs(runs, orderings, k)
    want = ROP.merge_sorted_runs(rruns, r_orderings, k)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
    for sym in ("a", "f"):
        np.testing.assert_array_equal(got.cols[sym].data.numpy(),
                                      np.asarray(want.cols[sym].data))
    # the merge equals one stable sort of the concatenation
    full = OP.apply_sort(runs, orderings)
    np.testing.assert_array_equal(got.cols["a"].data.numpy(),
                                  full.cols["a"].data.numpy())


def test_head_equals_reference(rng):
    arrays = _runs(rng, 1, 50)
    for count in (7, 50, 80):
        got = OP.head(_port_dt(*arrays), count)
        want = ROP.head(_ref_dt(*arrays), count)
        assert got.n == want.n == min(count, 50)
        np.testing.assert_array_equal(got.live.numpy(),
                                      np.asarray(want.live))
        for sym in ("a", "f"):
            np.testing.assert_array_equal(got.cols[sym].data.numpy(),
                                          np.asarray(want.cols[sym].data))
            np.testing.assert_array_equal(got.cols["f"].valid.numpy(),
                                          np.asarray(want.cols["f"].valid))


def test_head_keeps_array_companions_and_scalars():
    data = torch.tensor([[1, 2, 0], [3, 0, 0], [4, 5, 6]])
    v = Val(T.ArrayType(T.BIGINT), data, None, None,
            torch.tensor([2, 1, 3], dtype=torch.int32),
            torch.tensor([[True, False, True]] * 3))
    lit = Val(T.BIGINT, torch.tensor(7))  # a projected literal: 0-d
    out = OP.head(DTable({"a": v, "c": lit}, None, 3, CPU), 2)
    assert out.n == 2
    assert out.cols["a"].lengths.tolist() == [2, 1]
    assert out.cols["a"].elem_valid.shape == (2, 3)
    assert out.cols["c"].data.tolist() == [7, 7]
