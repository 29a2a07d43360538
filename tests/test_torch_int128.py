"""presto_tpu_torch.ops.int128 against presto_tpu.ops.int128, bit for
bit: add, sub, neg, mul (64x64 and 128x128), rescale,
div_round_half_up, rem_trunc (floor versus truncating division), the
order helpers, sort_keys, to_f64, and the long-decimal a/b/hi limb
sums of the aggregate states."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from presto_tpu.expr import aggregates as RA
from presto_tpu.ops import int128 as RI
from presto_tpu_torch.expr import aggregates as PA
from presto_tpu_torch.ops import int128 as PI


def _limbs(values: list[int]) -> np.ndarray:
    out = np.empty((len(values), 2), np.int64)
    for i, v in enumerate(values):
        m = v & ((1 << 128) - 1)
        lo, hi = m & ((1 << 64) - 1), m >> 64
        out[i] = [lo - (1 << 64) if lo >= 1 << 63 else lo,
                  hi - (1 << 64) if hi >= 1 << 63 else hi]
    return out


def _value(row) -> int:
    v = (int(row[1]) << 64) | (int(row[0]) & ((1 << 64) - 1))
    return v - (1 << 128) if v >= 1 << 127 else v


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(128)
    edge = [0, 1, -1, (1 << 63) - 1, -(1 << 63), 1 << 64, -(1 << 64),
            (1 << 126) + 12345, -(1 << 126) - 999, 10 ** 37, -(10 ** 37)]
    rand = [int(x) * int(y) for x, y in zip(
        rng.integers(-(1 << 62), 1 << 62, 200),
        rng.integers(-(1 << 40), 1 << 40, 200))]
    a = edge + rand
    b = list(reversed(edge)) + [int(x) or 7 for x in rng.integers(
        -(1 << 50), 1 << 50, 200)]
    return _limbs(a), _limbs(b)


def _both(fn_ref, fn_port, *args):
    ref = np.asarray(fn_ref(*[jnp.asarray(a) for a in args]))
    got = fn_port(*[torch.from_numpy(np.array(a)) for a in args])
    return ref, got.numpy()


@pytest.mark.parametrize("name", ["add", "sub", "mul", "eq", "lt", "le",
                                  "div_round_half_up", "rem_trunc"])
def test_binary_ops(operands, name):
    a, b = operands
    ref, got = _both(getattr(RI, name), getattr(PI, name), a, b)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["neg", "abs_", "is_neg", "shift_left1",
                                  "to_f64"])
def test_unary_ops(operands, name):
    a, _ = operands
    ref, got = _both(getattr(RI, name), getattr(PI, name), a)
    np.testing.assert_array_equal(got, ref)


def test_division_rounds_half_away_and_remainder_truncates():
    a = _limbs([7, -7, 5, -5, 15, -15])
    b = _limbs([2, 2, 2, 2, -10, -10])
    got = [_value(r) for r in PI.div_round_half_up(
        torch.from_numpy(a), torch.from_numpy(b)).numpy()]
    assert got == [4, -4, 3, -3, -2, 2]
    rem = [_value(r) for r in PI.rem_trunc(
        torch.from_numpy(a), torch.from_numpy(b)).numpy()]
    assert rem == [1, -1, 1, -1, 5, -5]


def test_mul_i64_and_rescale(operands):
    rng = np.random.default_rng(64)
    x = rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64)
    y = rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64)
    x[:2], y[:2] = [-(1 << 63), -1], [-(1 << 63), (1 << 63) - 1]
    ref, got = _both(RI.mul_i64, PI.mul_i64, x, y)
    np.testing.assert_array_equal(got, ref)
    a, _ = operands
    for k in (0, 5, 18, 25):
        np.testing.assert_array_equal(
            PI.rescale_up(torch.from_numpy(a), k).numpy(),
            np.asarray(RI.rescale_up(jnp.asarray(a), k)))


def test_sort_keys(operands):
    a, _ = operands
    rh, rl = RI.sort_keys(jnp.asarray(a))
    ph, pl = PI.sort_keys(torch.from_numpy(a))
    np.testing.assert_array_equal(ph.numpy().view(np.uint64), np.asarray(rh))
    np.testing.assert_array_equal(pl.numpy().view(np.uint64), np.asarray(rl))


def test_long_decimal_limb_sums(operands):
    """The a/b/hi limb states of a long-decimal sum, folded, merged and
    recombined, equal the reference's and the exact Python sums."""
    a, _ = operands
    rng = np.random.default_rng(3)
    n = a.shape[0]
    slots = rng.integers(0, 5, n).astype(np.int32)
    w = rng.random(n) > 0.2
    lo, hi = a[:, 0], a[:, 1]
    ref = RA.fold("sum", jnp.asarray(lo), jnp.asarray(w),
                  jnp.asarray(slots), 5, data2=jnp.asarray(hi))
    got = PA.fold("sum", torch.from_numpy(lo.copy()), torch.from_numpy(w),
                  torch.from_numpy(slots), 5,
                  data2=torch.from_numpy(hi.copy()))
    for f in ("a", "b", "hi", "count"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref[f]))
    total = PA.finalize("sum", got, None, None)[0].numpy()
    for s in range(5):
        exact = sum(_value(a[i]) for i in range(n)
                    if w[i] and slots[i] == s)
        m = exact & ((1 << 128) - 1)
        assert _value(total[s]) == (m - (1 << 128) if m >= 1 << 127 else m)
    merged_ref = RA.merge("avg", {f: jnp.asarray(np.asarray(ref[f]))
                                  for f in ref}, jnp.asarray([0, 0, 1, 1, 1],
                                                             np.int32),
                          2, jnp.ones(5, bool))
    merged = PA.merge("avg", got, torch.tensor([0, 0, 1, 1, 1],
                                               dtype=torch.int32),
                      2, torch.ones(5, dtype=torch.bool))
    for f in ("a", "b", "hi", "count"):
        np.testing.assert_array_equal(merged[f].numpy(),
                                      np.asarray(merged_ref[f]))
    avg_ref = RA.finalize("avg", merged_ref, None, None)
    avg = PA.finalize("avg", merged, None, None)
    np.testing.assert_array_equal(avg[0].numpy(), np.asarray(avg_ref[0]))
    np.testing.assert_array_equal(avg[1].numpy(), np.asarray(avg_ref[1]))
