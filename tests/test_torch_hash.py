"""presto_tpu_torch.ops.hash against presto_tpu.ops.hash, bit for bit.

Inputs come from numpy with a fixed seed and go through both the JAX
function and its port; hashes compare as uint64 (the port carries them
as int64 bit patterns), including hashes >= 2^63."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from presto_tpu.ops import hash as RH
from presto_tpu_torch.ops import hash as PH


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def _ref(x) -> np.ndarray:
    return np.asarray(x)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20260117)


def _ints(rng, n=3000):
    x = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    x[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    return x


@pytest.mark.parametrize("with_valid", [False, True])
def test_hash_int_column(rng, with_valid):
    x = _ints(rng)
    valid = rng.random(x.shape[0]) > 0.2 if with_valid else None
    want = _ref(RH.hash_int_column(
        jnp.asarray(x), None if valid is None else jnp.asarray(valid)))
    got = PH.hash_int_column(_t(x), None if valid is None else _t(valid))
    np.testing.assert_array_equal(_u64(got), want)
    assert (want >= np.uint64(1 << 63)).any()  # the top half is covered


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_hash_int_column_narrow_types(rng, dtype):
    x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, 500,
                     dtype=dtype)
    np.testing.assert_array_equal(
        _u64(PH.hash_int_column(_t(x))),
        _ref(RH.hash_int_column(jnp.asarray(x))))


def test_hash_string_column(rng):
    dictionary = np.array(sorted({f"w{i}" for i in range(37)} | {""}),
                          dtype=object)
    codes = rng.integers(0, len(dictionary), 800).astype(np.int32)
    valid = rng.random(800) > 0.1
    want = _ref(RH.hash_string_column(jnp.asarray(codes), dictionary,
                                      jnp.asarray(valid)))
    got = PH.hash_string_column(_t(codes), dictionary, _t(valid))
    np.testing.assert_array_equal(_u64(got), want)
    np.testing.assert_array_equal(PH.hash_string_dictionary(dictionary),
                                  RH.hash_string_dictionary(dictionary))


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_combine_hashes(rng, ncols):
    cols = [rng.integers(0, np.iinfo(np.uint64).max, 2000,
                         dtype=np.uint64) for _ in range(ncols)]
    # the EMPTY sentinel itself must be remapped, as in the reference
    cols[0][:3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if ncols > 1:
        cols[1][:3] = 0
    want = _ref(RH.combine_hashes([jnp.asarray(c) for c in cols]))
    got = PH.combine_hashes([_t(c) for c in cols])
    np.testing.assert_array_equal(_u64(got), want)
    assert not (want == np.uint64(0xFFFFFFFFFFFFFFFF)).any()


def _row_hashes(rng, n, key_range):
    keys = rng.integers(0, key_range, n)
    keys[: n // 10] = (1 << 62) + keys[: n // 10]  # hashes >= 2^63
    return np.asarray(RH.combine_hashes(
        [RH.hash_int_column(jnp.asarray(keys))]))


def test_group_by_slots(rng):
    h = _row_hashes(rng, 3000, 500)
    live = rng.random(3000) > 0.25
    want = RH.group_by_slots(jnp.asarray(h), jnp.asarray(live), 1024)
    got = PH.group_by_slots(_t(h), _t(live), 1024)
    np.testing.assert_array_equal(got[0].numpy(), _ref(want[0]))
    np.testing.assert_array_equal(_u64(got[1]), _ref(want[1]))
    assert bool(got[2]) == bool(want[2])
    # overflow: more groups than capacity
    small = PH.group_by_slots(_t(h), _t(live), 64)
    assert not bool(small[2])
    assert not bool(RH.group_by_slots(jnp.asarray(h), jnp.asarray(live),
                                      64)[2])


def test_sorted_group_ids_and_sorted_groups(rng):
    h = _row_hashes(rng, 2500, 300)
    live = rng.random(2500) > 0.3
    key = rng.integers(0, 3, 2500).astype(np.int64)
    payload = rng.integers(-50, 50, 2500).astype(np.int64)
    want = RH._sorted_group_ids(jnp.asarray(h), jnp.asarray(live))
    got = PH._sorted_group_ids(_t(h), _t(live))
    np.testing.assert_array_equal(_u64(got[0]), _ref(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), _ref(w))
    rs = RH.SortedGroups(jnp.asarray(h), jnp.asarray(live),
                         [jnp.asarray(key), jnp.asarray(payload)], 1)
    ps = PH.SortedGroups(_t(h), _t(live), [_t(key), _t(payload)], 1)
    np.testing.assert_array_equal(_u64(ps.sh), _ref(rs.sh))
    for name in ("sidx", "live", "is_new", "is_last", "start", "gidc"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      _ref(getattr(rs, name)), name)
    assert int(ps.ngroups) == int(rs.ngroups)
    for p, r in zip(ps.payloads, rs.payloads):
        np.testing.assert_array_equal(p.numpy(), _ref(r))
    np.testing.assert_array_equal(ps.slots().numpy(), _ref(rs.slots()))
    for cap in (256, 4096):
        pc, po = ps.compact([_t(payload)], cap)
        rc, ro = rs.compact([jnp.asarray(payload)], cap)
        np.testing.assert_array_equal(pc[0].numpy(), _ref(rc[0]))
        np.testing.assert_array_equal(po.numpy(), _ref(ro))


def test_sort_build_side_and_probe_runs(rng):
    bh = _row_hashes(rng, 900, 400)
    ph = _row_hashes(rng, 1700, 800)
    bl = rng.random(900) > 0.15
    pl = rng.random(1700) > 0.15
    want = RH.sort_build_side(jnp.asarray(bh), jnp.asarray(bl))
    got = PH.sort_build_side(_t(bh), _t(bl))
    np.testing.assert_array_equal(_u64(got[0]), _ref(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), _ref(want[1]))
    want = RH.probe_runs(jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(ph),
                         jnp.asarray(pl))
    got = PH.probe_runs(_t(bh), _t(bl), _t(ph), _t(pl))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _ref(w))
    assert got[2].any() and not got[2].all()


def test_unsigned_order_helpers(rng):
    x = rng.integers(0, np.iinfo(np.uint64).max, 1000, dtype=np.uint64)
    order = torch.sort(PH.unsigned_key(_t(x)), stable=True).indices
    np.testing.assert_array_equal(x[order.numpy()], np.sort(x))
    for k in (1, 7, 32, 63):
        np.testing.assert_array_equal(_u64(PH.srl(_t(x), k)),
                                      x >> np.uint64(k))


@pytest.mark.parametrize("left_join", [False, True])
def test_expand_matches(rng, left_join):
    bh = _row_hashes(rng, 600, 150)  # duplicate build keys: many-to-many
    ph = _row_hashes(rng, 900, 300)
    bl = rng.random(600) > 0.1
    pl = rng.random(900) > 0.1
    lo, cnt, found = RH.probe_runs(*[jnp.asarray(a) for a in (bh, bl, ph,
                                                              pl)])
    _sh, sidx = RH.sort_build_side(jnp.asarray(bh), jnp.asarray(bl))
    for cap in (512, 8192):  # overflowing and fitting output capacity
        want = RH.expand_matches(lo, cnt, sidx, found, jnp.asarray(pl),
                                 cap, left_join)
        got = PH.expand_matches(_t(np.asarray(lo)), _t(np.asarray(cnt)),
                                _t(np.asarray(sidx)), _t(np.asarray(found)),
                                _t(pl), cap, left_join)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _ref(w))
