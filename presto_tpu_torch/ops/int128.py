"""Signed int128 arithmetic for LONG DECIMALS (precision 19..38) as
two int64 limbs — the port of ``presto_tpu/ops/int128.py``.

A value is an [..., 2] int64 tensor: lane 0 holds the low 64 bits
(unsigned, stored as an int64 bit pattern), lane 1 the signed high 64
bits. torch has no usable uint64 arithmetic, so the unsigned steps use
int64 bit patterns: addition and multiplication wrap identically, a
logical shift is :func:`presto_tpu_torch.ops.hash.srl`, and an unsigned
compare flips the sign bit first. Results are bit-identical to the
reference's.

Division is bit-serial long division (128 elementwise iterations);
decimal division runs post-aggregation at group-count width.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.ops.hash import INT64_MIN, srl

_U32 = 0xFFFFFFFF


def _ult(a, b):
    """Unsigned a < b over int64 bit patterns."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def lo(v):
    return v[..., 0]


def hi(v):
    return v[..., 1]


def pack(lo64, hi64):
    return torch.stack([lo64.to(torch.int64), hi64.to(torch.int64)],
                       dim=-1)


def from_i64(x):
    """Sign-extend int64 -> int128."""
    x = x.to(torch.int64)
    return pack(x, x >> 63)


def to_i64(v):
    """Truncate to the low 64 bits (caller guarantees range)."""
    return lo(v)


def add(a, b):
    slo = lo(a) + lo(b)
    carry = _ult(slo, lo(a)).to(torch.int64)
    return pack(slo, hi(a) + hi(b) + carry)


def neg(a):
    slo = ~lo(a) + 1
    carry = (slo == 0).to(torch.int64)
    return pack(slo, ~hi(a) + carry)


def sub(a, b):
    return add(a, neg(b))


def is_neg(a):
    return hi(a) < 0


def abs_(a):
    return torch.where(is_neg(a)[..., None], neg(a), a)


def eq(a, b):
    return (lo(a) == lo(b)) & (hi(a) == hi(b))


def lt(a, b):
    """Signed a < b: high limbs signed, low limbs unsigned."""
    return (hi(a) < hi(b)) | ((hi(a) == hi(b)) & _ult(lo(a), lo(b)))


def le(a, b):
    return lt(a, b) | eq(a, b)


def mul_u64(a64, b64):
    """Unsigned 64x64 -> (lo, hi) bit patterns via 32-bit limbs."""
    a, b = a64.to(torch.int64), b64.to(torch.int64)
    a0, a1 = a & _U32, srl(a, 32)
    b0, b1 = b & _U32, srl(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = srl(p00, 32) + (p01 & _U32) + (p10 & _U32)
    lo_ = (p00 & _U32) | (mid << 32)
    hi_ = p11 + srl(p01, 32) + srl(p10, 32) + srl(mid, 32)
    return lo_, hi_


def mul_i64(a64, b64):
    """Signed 64x64 -> exact int128."""
    a64, b64 = a64.to(torch.int64), b64.to(torch.int64)
    ulo, uhi = mul_u64(a64, b64)
    zero = torch.zeros((), dtype=torch.int64, device=a64.device)
    corr = (torch.where(a64 < 0, b64, zero)
            + torch.where(b64 < 0, a64, zero))
    return pack(ulo, uhi - corr)


def mul(a, b):
    """int128 x int128, low 128 bits (overflow past 128 wraps)."""
    ulo, uhi = mul_u64(lo(a), lo(b))
    uhi = uhi + lo(a) * hi(b) + hi(a) * lo(b)
    return pack(ulo, uhi)


def _const(k: int, like: torch.Tensor):
    return torch.tensor(k, dtype=torch.int64, device=like.device)


def mul_small(a, k: int):
    """int128 x non-negative python-int constant (fits int64)."""
    return mul(a, from_i64(_const(k, a)))


_POW10 = [10 ** i for i in range(39)]


def rescale_up(a, k: int):
    """a * 10^k (k >= 0), wrapping past 128 bits."""
    v = a
    while k > 18:
        v = mul_small(v, _POW10[18])
        k -= 18
    if k:
        v = mul_small(v, _POW10[k])
    return v


def shift_left1(v):
    return pack(lo(v) << 1, (hi(v) << 1) | srl(lo(v), 63))


def _uge(r, b):
    """Unsigned 128-bit r >= b."""
    return (_ult(hi(b), hi(r))
            | ((hi(r) == hi(b)) & ~_ult(lo(r), lo(b))))


def divmod_u(a, b):
    """Unsigned 128/128 long division -> (quotient, remainder)."""
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    for i in range(128):
        bit_idx = 127 - i
        limb = hi(a) if bit_idx >= 64 else lo(a)
        bit = (limb >> (bit_idx & 63)) & 1
        r = shift_left1(r)
        r = pack(lo(r) | bit, hi(r))
        ge = _uge(r, b)
        r = torch.where(ge[..., None], sub(r, b), r)
        q = shift_left1(q)
        q = pack(lo(q) | ge.to(torch.int64), hi(q))
    return q, r


def _safe_divisor(ub):
    one = from_i64(torch.ones(ub.shape[:-1], dtype=torch.int64,
                              device=ub.device))
    return torch.where(eq(ub, torch.zeros_like(ub))[..., None], one, ub)


def div_round_half_up(a, b):
    """Signed a / b rounded half away from zero. b == 0 yields 0
    (callers mask validity)."""
    a, b = torch.broadcast_tensors(a, b)
    sign_neg = is_neg(a) ^ is_neg(b)
    ua, ub = abs_(a), abs_(b)
    ub_safe = _safe_divisor(ub)
    q, r = divmod_u(ua, ub_safe)
    ge = _uge(shift_left1(r), ub_safe)
    q = torch.where(ge[..., None], add(q, from_i64(torch.ones_like(lo(q)))),
                    q)
    return torch.where(sign_neg[..., None], neg(q), q)


def rem_trunc(a, b):
    """Signed remainder truncating toward zero: the result takes the
    DIVIDEND's sign. b == 0 yields 0 (callers mask validity)."""
    a, b = torch.broadcast_tensors(a, b)
    ua, ub = abs_(a), abs_(b)
    _q, r = divmod_u(ua, _safe_divisor(ub))
    return torch.where(is_neg(a)[..., None], neg(r), r)


def sort_keys(v):
    """Order-preserving (primary, secondary) uint64 sort-key pair as
    int64 bit patterns: the sign-flipped high limb, then the low limb
    (compare both unsigned)."""
    return hi(v) ^ INT64_MIN, lo(v)


def to_f64(v):
    ulo = lo(v)
    return (hi(v).to(torch.float64) * (2.0 ** 64)
            + (srl(ulo, 32).to(torch.float64) * (2.0 ** 32)
               + (ulo & _U32).to(torch.float64)))

