"""Aggregate fold, merge and finalize on tensors — the port of
``presto_tpu/expr/aggregates.py`` for count, sum, avg, min, max,
arbitrary and the variance family (variance, var_samp, var_pop,
stddev, stddev_samp, stddev_pop).

``fold`` reduces rows into per-slot states with segment sums
(ops/segred.py, the ``agg_sum`` kernel for integer states);
``scan_fold`` does the same over hash-sorted rows with segmented
scans (ops/segscan.py); ``merge`` / ``scan_merge`` combine partial
states; ``finalize`` turns states into the output column. LONG-decimal
sum/avg states are the exact int128 limb decomposition a/b/hi (the
low limb split into two 32-bit halves that each sum exactly in int64,
the high limb summing mod 2^64). LONG-decimal min/max/arbitrary
states are the extremum's two limbs vlo/vhi, found in two passes:
the signed high-limb extremum, then the low limb (in an
order-preserving signed view) among the high-limb winners. The
variance family folds float64 (count, sum, m2) states: m2 is the
second moment about the group mean, taken in a second pass (the
sum-of-squares form cancels when the mean dwarfs the spread), and
partial states merge by Chan's parallel combination.

The call metadata (AggCall, output and state types) lives in
:mod:`presto_tpu_torch.expr.aggmeta` and is re-exported here. Every
other aggregate function raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr.aggmeta import (  # noqa: F401 (re-exports)
    BOOL_FNS, BY_FNS, COVAR_FNS, MOMENT_FNS, SCAN_FNS, VAR_FNS, VARLEN_FNS,
    AggCall, is_long_decimal, long_minmax_call, long_sum_call,
    output_type, state_fields, state_type)
from presto_tpu_torch.ops import segred
from presto_tpu_torch.ops.hash import srl

PORTED_FNS = frozenset({"count", "count_star", "sum", "avg", "min", "max",
                        "arbitrary"}) | VAR_FNS
# max and arbitrary reduce with segment max, min with segment min
_MAX_FNS = ("max", "arbitrary")
_I64_MIN = -(1 << 63)


def _unported(fn: str):
    return NotImplementedError(
        f"aggregate {fn} is not ported to presto_tpu_torch yet")


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=like.dtype, device=like.device)


def _lo_sortable(lo64):
    """Low limb's bit pattern -> an int64 whose signed order is the
    limb's unsigned order (its own inverse)."""
    return lo64 ^ _I64_MIN


def _masked(w, data, is_max: bool):
    """``data`` where ``w``, else a value no row beats (the dtype's min
    for max, its max for min)."""
    return torch.where(w, data, segred.identity(data.dtype, is_max))


def _long_extremum(reduce, back, present, lo, hi, is_max: bool) -> dict:
    """LONG-decimal extremum states in two passes: the signed high-limb
    extremum, then the low limb (order-preserving signed view) among
    the rows whose high limb won. ``reduce`` folds a per-row column
    per group, ``back`` brings a per-group result back to the rows."""
    bh = reduce(_masked(present, hi, is_max))
    winner = present & (hi == back(bh))
    bl = reduce(_masked(winner, _lo_sortable(lo), is_max))
    return {"vlo": _lo_sortable(bl), "vhi": bh}


def _slot_fns(ext, slots, capacity: int):
    """(reduce, back) of :func:`_long_extremum` over slot ids."""
    gather = slots.to(torch.int64).clamp(0, max(capacity - 1, 0))
    return (lambda x: ext(x, slots, capacity)), (lambda b: b[gather])


def _limb32(lo64):
    """Non-negative int64 halves of a low limb's bit pattern: each sums
    exactly in int64 for up to 2^31 rows."""
    return lo64 & 0xFFFFFFFF, srl(lo64, 32)


def _recombine128(a, b, hi64):
    """Per-slot limb sums -> int128 [n, 2] (see _limb32)."""
    from presto_tpu_torch.ops import int128 as I
    lo = a + (b << 32)
    carry = I._ult(lo, a).to(torch.int64)
    hi = hi64 + srl(b, 32) + carry
    return I.pack(lo, hi)


def _normalize_limbs(states: dict) -> dict:
    """Carry-normalize LONG-decimal a/b partial sums back into the
    32-bit limb domain before a merge re-sums them."""
    packed = _recombine128(states["a"], states["b"], states["hi"])
    u = packed[..., 0]
    return {**states, "a": u & 0xFFFFFFFF, "b": srl(u, 32),
            "hi": packed[..., 1]}


def prepare_arg(fn: str, data, arg_type: T.DataType | None):
    """Argument pre-conversion: the variance family folds float64
    values (decimals unscaled); the others fold the raw value."""
    if fn not in PORTED_FNS:
        raise _unported(fn)
    if fn not in VAR_FNS:
        return data
    x = data.to(torch.float64)
    if isinstance(arg_type, T.DecimalType):
        x = x / arg_type.unscale_factor
    return x


def _var_states(c, s, m2) -> dict:
    return {"count": c, "sum": s, "m2": m2}


def _mean(s, c):
    return s / torch.clamp(c, min=1).to(torch.float64)


def fold(fn: str, data, weight, slots, capacity: int, *,
         data2=None, data_valid=None, param=None):
    """Fold rows into per-slot states. ``weight`` is bool live&valid."""
    w = weight
    if fn in ("count", "count_star"):
        return {"count": segred.segment_sum(
            w.to(torch.int64), slots, capacity)}
    if fn in ("sum", "avg"):
        c = segred.segment_sum(w.to(torch.int64), slots, capacity)
        if data2 is not None:
            # LONG decimal: data/data2 are the int128 low/high limbs
            a, b = _limb32(torch.where(w, data, _zero(data)))
            return {"a": segred.segment_sum(a, slots, capacity),
                    "b": segred.segment_sum(b, slots, capacity),
                    "hi": segred.segment_sum(
                        torch.where(w, data2, _zero(data2)), slots,
                        capacity),
                    "count": c}
        if not data.dtype.is_floating_point:
            data = data.to(torch.int64)  # int32 args must not wrap
        s = segred.segment_sum(torch.where(w, data, _zero(data)), slots,
                               capacity)
        return {"sum": s, "count": c}
    if fn in ("min", "max", "arbitrary"):
        c = segred.segment_sum(w.to(torch.int64), slots, capacity)
        is_max = fn in _MAX_FNS
        ext = segred.segment_max if is_max else segred.segment_min
        if data2 is not None:
            return {**_long_extremum(*_slot_fns(ext, slots, capacity), w,
                                     data, data2, is_max), "count": c}
        return {"val": ext(_masked(w, data, is_max), slots, capacity),
                "count": c}
    if fn in VAR_FNS:
        # data is float64 (prepare_arg); m2 about the group mean
        c = segred.segment_sum(w.to(torch.int64), slots, capacity)
        s = segred.segment_sum(torch.where(w, data, _zero(data)), slots,
                               capacity)
        gather = slots.to(torch.int64).clamp(0, max(capacity - 1, 0))
        d = data - _mean(s, c)[gather]
        return _var_states(c, s, segred.segment_sum(
            torch.where(w, d * d, _zero(d)), slots, capacity))
    raise _unported(fn)


def scan_fold(fn: str, data, weight, sg, *, data2=None, data_valid=None,
              param=None):
    """Sorted-order fold (inputs in hash-sorted row order; state
    arrays are per-row running values, meaningful at each run's last
    row)."""
    from presto_tpu_torch.ops import segscan as S
    w = weight
    if fn in ("count", "count_star"):
        return {"count": S.seg_sum(w.to(torch.int64), sg)}
    if fn in ("sum", "avg"):
        c = S.seg_sum(w.to(torch.int64), sg)
        if data2 is not None:
            a, b = _limb32(torch.where(w, data, _zero(data)))
            return {"a": S.seg_sum(a, sg), "b": S.seg_sum(b, sg),
                    "hi": S.seg_sum(torch.where(w, data2, _zero(data2)),
                                    sg),
                    "count": c}
        if not data.dtype.is_floating_point:
            data = data.to(torch.int64)
        s = S.seg_sum(torch.where(w, data, _zero(data)), sg)
        return {"sum": s, "count": c}
    if fn in ("min", "max", "arbitrary"):
        c = S.seg_sum(w.to(torch.int64), sg)
        is_max = fn in _MAX_FNS
        ext = S.seg_max if is_max else S.seg_min
        if data2 is not None:
            return {**_long_extremum(lambda x: ext(x, sg),
                                     lambda b: S.broadcast_last(b, sg), w,
                                     data, data2, is_max), "count": c}
        return {"val": ext(_masked(w, data, is_max), sg), "count": c}
    if fn in VAR_FNS:
        c = S.seg_sum(w.to(torch.int64), sg)
        s = S.seg_sum(torch.where(w, data, _zero(data)), sg)
        d = data - _mean(S.broadcast_last(s, sg), S.broadcast_last(c, sg))
        return _var_states(c, s, S.seg_sum(torch.where(w, d * d, _zero(d)),
                                           sg))
    raise _unported(fn)


def scan_merge(fn: str, states: dict, live, sg):
    """Sorted-order merge of partial states."""
    from presto_tpu_torch.ops import segscan as S
    w = live
    if fn in ("count", "count_star"):
        return {"count": S.seg_sum(
            torch.where(w, states["count"], _zero(states["count"])), sg)}
    if fn in ("sum", "avg"):
        if "a" in states:
            states = _normalize_limbs(states)
            return {f: S.seg_sum(torch.where(w, states[f],
                                             _zero(states[f])), sg)
                    for f in ("a", "b", "hi", "count")}
        return {f: S.seg_sum(torch.where(w, states[f], _zero(states[f])),
                             sg)
                for f in ("sum", "count")}
    if fn in ("min", "max", "arbitrary"):
        is_max = fn in _MAX_FNS
        ext = S.seg_max if is_max else S.seg_min
        c = S.seg_sum(torch.where(w, states["count"],
                                  _zero(states["count"])), sg)
        if "vlo" in states:
            return {**_long_extremum(
                lambda x: ext(x, sg), lambda b: S.broadcast_last(b, sg),
                w & (states["count"] > 0), states["vlo"], states["vhi"],
                is_max), "count": c}
        return {"val": ext(_masked(w, states["val"], is_max), sg),
                "count": c}
    if fn in VAR_FNS:
        n_i, s_i, m2_i = _var_parts(states, w)
        n, s = S.seg_sum(n_i, sg), S.seg_sum(s_i, sg)
        dev = _mean(s_i, n_i) - _mean(S.broadcast_last(s, sg),
                                      S.broadcast_last(n, sg))
        return _var_states(n, s, S.seg_sum(
            m2_i + n_i.to(torch.float64) * dev * dev, sg))
    raise _unported(fn)


def _var_parts(states: dict, w):
    """Live partial (count, sum, m2) states; dead rows contribute 0."""
    return tuple(torch.where(w, states[f], _zero(states[f]))
                 for f in ("count", "sum", "m2"))


def merge(fn: str, states: dict, slots, capacity: int, live):
    """Merge partial states (rows of state columns) into a final state
    table."""
    w = live
    if fn in ("count", "count_star"):
        return {"count": segred.segment_sum(
            torch.where(w, states["count"], _zero(states["count"])),
            slots, capacity)}
    if fn in ("sum", "avg"):
        fields = ("a", "b", "hi", "count") if "a" in states \
            else ("sum", "count")
        if "a" in states:
            states = _normalize_limbs(states)
        return {f: segred.segment_sum(
            torch.where(w, states[f], _zero(states[f])), slots, capacity)
            for f in fields}
    if fn in ("min", "max", "arbitrary"):
        is_max = fn in _MAX_FNS
        ext = segred.segment_max if is_max else segred.segment_min
        c = segred.segment_sum(torch.where(w, states["count"],
                                           _zero(states["count"])),
                               slots, capacity)
        if "vlo" in states:
            return {**_long_extremum(
                *_slot_fns(ext, slots, capacity), w & (states["count"] > 0),
                states["vlo"], states["vhi"], is_max), "count": c}
        return {"val": ext(_masked(w, states["val"], is_max), slots,
                           capacity),
                "count": c}
    if fn in VAR_FNS:
        # Chan et al.: M2 = sum(M2_i) + sum(n_i * (mean_i - mean)^2)
        n_i, s_i, m2_i = _var_parts(states, w)
        n = segred.segment_sum(n_i, slots, capacity)
        s = segred.segment_sum(s_i, slots, capacity)
        gather = slots.to(torch.int64).clamp(0, max(capacity - 1, 0))
        dev = _mean(s_i, n_i) - _mean(s, n)[gather]
        return _var_states(n, s, segred.segment_sum(
            m2_i + n_i.to(torch.float64) * dev * dev, slots, capacity))
    raise _unported(fn)


def finalize(fn: str, states: dict, out_type: T.DataType,
             arg_type: T.DataType | None, param: float | None = None):
    """States -> (data, valid) final columns."""
    if fn in ("count", "count_star"):
        return states["count"], None
    if fn in ("min", "max", "arbitrary"):
        if "vlo" in states:
            from presto_tpu_torch.ops import int128 as I
            return (I.pack(states["vlo"], states["vhi"]),
                    states["count"] > 0)
        return states["val"], states["count"] > 0
    if fn == "sum" and "a" in states:
        return (_recombine128(states["a"], states["b"], states["hi"]),
                states["count"] > 0)
    if fn == "avg" and "a" in states:
        from presto_tpu_torch.ops import int128 as I
        total = _recombine128(states["a"], states["b"], states["hi"])
        c = states["count"]
        q = I.div_round_half_up(total, I.from_i64(torch.clamp(c, min=1)))
        return q, c > 0
    if fn == "sum":
        return states["sum"], states["count"] > 0
    if fn == "avg":
        s, c = states["sum"], states["count"]
        safe = torch.clamp(c, min=1)
        if isinstance(out_type, T.DecimalType):
            # HALF_UP integer division in the scaled domain:
            # sign(s) * ((2|s| + c) // 2c)
            q = torch.sign(s) * ((2 * torch.abs(s) + safe) // (2 * safe))
            return q, c > 0
        sf = s.to(torch.float64)
        if isinstance(arg_type, T.DecimalType):
            sf = sf / arg_type.unscale_factor
        return sf / safe.to(torch.float64), c > 0
    if fn in VAR_FNS:
        c = states["count"]
        safe = torch.clamp(c, min=1).to(torch.float64)
        if fn.endswith("_pop"):
            var, ok = states["m2"] / safe, c > 0
        else:
            # sample variance M2 / (n - 1), undefined for n < 2
            var = states["m2"] / torch.clamp(safe - 1.0, min=1.0)
            ok = c > 1
        return (torch.sqrt(var) if fn.startswith("stddev") else var), ok
    raise _unported(fn)
