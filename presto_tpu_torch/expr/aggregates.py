"""Aggregate fold, merge and finalize on tensors — the port of
``presto_tpu/expr/aggregates.py``.

``fold`` reduces rows into per-slot states with segment reductions
(ops/segred.py: the ``agg_sum``, ``agg_max`` and ``agg_min`` kernels for
integer states); ``scan_fold`` does the same over hash-sorted rows with
segmented scans (ops/segscan.py); ``merge`` / ``scan_merge`` combine
partial states; ``finalize`` turns states into the output column.

- count, count_if, sum, avg: integer sums. LONG-decimal sum/avg states
  are the exact int128 limb decomposition a/b/hi (the low limb split
  into two 32-bit halves that each sum exactly in int64, the high limb
  summing mod 2^64).
- min, max, arbitrary, bool_and/bool_or/every: extremum states (bools
  as int32 0/1). LONG-decimal extremum states are the two limbs
  vlo/vhi, found in two passes: the signed high-limb extremum, then
  the low limb (in an order-preserving signed view) among the
  high-limb winners.
- The variance, central-moment (skewness, kurtosis) and co-moment
  (corr, covar_*, regr_*) families fold float64 states about the group
  mean, taken in a second pass (the sum-of-squares form cancels when
  the mean dwarfs the spread), and partial states merge by Chan's
  parallel combination. geometric_mean sums logs.
- min_by/max_by: the extremum of the key, then one winning row per slot
  whose value and validity both come from that row: the lowest row
  index among the rows attaining the extremum (a segment min over the
  row index), so every backend picks the same row.
- checksum: a wrapping int64 sum of value hashes (the reference's
  uint64 sum, bit for bit).
- approx_distinct: HyperLogLog, 2048 uint8 registers per slot folded
  by one flattened segment max. approx_percentile: a min-hash
  reservoir, per (slot, cell) the row whose hash is the least in
  unsigned order, found by one flattened segment min over
  ``unsigned_key(hash)``.

64-bit hashes are int64 bit patterns (ops/hash.py). The call metadata
(AggCall, output and state types) lives in
:mod:`presto_tpu_torch.expr.aggmeta` and is re-exported here. The
variable-length aggregates (``VARLEN_FNS``) never fold here:
``exec/varlen.py`` builds their values on the host.
"""

from __future__ import annotations

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr.aggmeta import (  # noqa: F401 (re-exports)
    BOOL_FNS, BY_FNS, COVAR_FNS, MOMENT_FNS, SCAN_FNS, SKETCH_FNS, VAR_FNS,
    VARLEN_FNS, AggCall, is_long_decimal, long_minmax_call, long_sum_call,
    output_type, state_fields, state_type)
from presto_tpu_torch.ops import segred
from presto_tpu_torch.ops.hash import (INT64_MIN, splitmix64, srl,
                                       unsigned_key, value_hash)

PORTED_FNS = (frozenset({"count", "count_star", "count_if", "sum", "avg",
                         "min", "max", "arbitrary", "geometric_mean",
                         "checksum", "approx_distinct",
                         "approx_percentile"})
              | VAR_FNS | MOMENT_FNS | BOOL_FNS | COVAR_FNS | BY_FNS)
# these reduce with segment max; the other extremum states with min
_MAX_FNS = ("max", "arbitrary", "bool_or")
_I64_MIN = INT64_MIN
_I64_MAX = (1 << 63) - 1
# HyperLogLog registers per slot (p = 11, standard error 1.04/sqrt(2048))
HLL_M = 2048
# min-hash reservoir cells per slot for approx_percentile
PCT_K = 1024
# an empty reservoir cell's hash: uint64 all ones as an int64 bit pattern
_U64_MAX = -1
# the row-index multiplier 0xBF58476D1CE4E5B9 as a signed int64
_ROW_MIX = 0xBF58476D1CE4E5B9 - (1 << 64)
# checksum's hash for a NULL row (the reference's constant)
CHECKSUM_NULL = 0x2545F4914F6CDD1D
# the flattened register and reservoir ids must fit int32
_MAX_CELLS = 1 << 30


def _unported(fn: str):
    if fn in VARLEN_FNS:
        # their lists, maps and strings are built on the host, and
        # execute_plan routes every plan holding one there first
        return NotImplementedError(
            f"aggregate {fn} is host-finalized (exec/varlen.py) and never "
            "folds on the device")
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


def _gather_ids(slots, capacity: int):
    """Slot ids as int64 gather indices into a [capacity] state."""
    return slots.to(torch.int64).clamp(0, max(capacity - 1, 0))


def _slot_fns(ext, slots, capacity: int):
    """(reduce, back) of :func:`_long_extremum` over slot ids."""
    gather = _gather_ids(slots, capacity)
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


def _unscaled(data, arg_type):
    x = data.to(torch.float64)
    if isinstance(arg_type, T.DecimalType):
        x = x / arg_type.unscale_factor
    return x


def prepare_arg(fn: str, data, arg_type: T.DataType | None):
    """Argument pre-conversion: the float families fold float64 values
    (decimals unscaled; geometric_mean their logs), the hash sketches
    and checksum fold value hashes, approx_percentile the value as
    float64 in its scaled domain; the others fold the raw value."""
    if fn not in PORTED_FNS:
        raise _unported(fn)
    if fn in ("approx_distinct", "checksum"):
        return value_hash(data)
    if fn == "approx_percentile":
        return data.to(torch.float64)
    if fn in VAR_FNS or fn in MOMENT_FNS or fn in COVAR_FNS:
        return _unscaled(data, arg_type)
    if fn == "geometric_mean":
        return torch.log(_unscaled(data, arg_type))
    return data


def prepare_arg2(fn: str, data, arg2_type: T.DataType | None):
    """The second argument: the co-moment family's x as float64
    (decimals unscaled); min_by/max_by's key as it is."""
    if fn in COVAR_FNS:
        return _unscaled(data, arg2_type)
    return data


def _mean(s, c):
    return s / torch.clamp(c, min=1).to(torch.float64)


def _count(w, slots, capacity: int):
    return segred.segment_sum(w.to(torch.int64), slots, capacity)


def _bitlen(x):
    """Bit length of non-negative int64 values (0 for 0), by six
    shift-and-compare rounds."""
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big.to(torch.int32) * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0).to(torch.int32)


def _cell_ids(slots, capacity: int, width: int, cell):
    """int32 ids ``slot * width + cell`` of a flattened [capacity,
    width] state; a slot past the capacity gets -1, which drops."""
    s = slots.to(torch.int64)
    if s.ndim < cell.ndim:
        s = s[:, None]
    ids = s * width + cell
    return torch.where(s < capacity, ids, torch.full_like(ids, -1)).to(
        torch.int32)


def _require_cells(fn: str, capacity: int, width: int) -> None:
    if capacity * width > _MAX_CELLS:
        raise ValueError(f"{fn}: group capacity too large for its sketch "
                         f"({capacity} slots x {width})")


def _hll_fold(h, w, slots, capacity: int):
    """Registers [capacity, HLL_M] uint8: the low 11 bits of the hash
    pick the register, the rank of the other 53 bits (leading zeros
    plus one) folds in by one flattened segment max."""
    _require_cells("approx_distinct", capacity, HLL_M)
    rank = (54 - _bitlen(srl(h, 11))).to(torch.uint8)
    ids = _cell_ids(slots, capacity, HLL_M, h & (HLL_M - 1))
    regs = segred.segment_max(torch.where(w, rank, _zero(rank)), ids,
                              capacity * HLL_M)
    return regs.reshape(capacity, HLL_M)


def _reservoir(key, values, w, ids, cells: int) -> tuple:
    """Per cell, the least ``key`` (the signed view of a hash's
    unsigned order) among the rows where ``w``, and the value of a row
    attaining it; a cell no row reaches keeps ``_U64_MAX`` and 0."""
    best = segred.segment_min(torch.where(w, key, _I64_MAX), ids, cells)
    gather = ids.to(torch.int64).clamp(0, max(cells - 1, 0))
    winner = w & (ids >= 0) & (key == best[gather])
    dest = torch.where(winner, gather, torch.full_like(gather, cells))
    val = torch.zeros(cells + 1, dtype=torch.float64, device=key.device)
    val = val.index_copy(0, dest, values)
    return best ^ _I64_MIN, val[:cells]


def _percentile_fold(x, w, slots, capacity: int) -> dict:
    """Min-hash reservoir [capacity, PCT_K]: each row's value hash,
    decorrelated by its row index, picks a cell (its low 10 bits) and
    competes there by its unsigned order."""
    _require_cells("approx_percentile", capacity, PCT_K)
    idx = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    h = splitmix64(value_hash(x) ^ (idx * _ROW_MIX))
    ids = _cell_ids(slots, capacity, PCT_K, h & (PCT_K - 1))
    rhash, rval = _reservoir(unsigned_key(h), x, w, ids, capacity * PCT_K)
    return {"rhash": rhash.reshape(capacity, PCT_K),
            "rval": rval.reshape(capacity, PCT_K)}


def _by_winner(x, x_ok, winner, slots, capacity: int) -> tuple:
    """Each slot's winning row: the lowest row index among its
    ``winner`` rows. Returns (its value, its validity); a slot without
    one holds (0, False)."""
    n = winner.shape[0]
    if n == 0:
        return (torch.zeros(capacity, dtype=x.dtype, device=x.device),
                torch.zeros(capacity, dtype=torch.bool, device=x.device))
    idx = torch.arange(n, dtype=torch.int64, device=winner.device)
    first = segred.segment_min(torch.where(winner, idx, n), slots,
                               capacity)
    has = first < n
    row = first.clamp(0, n - 1)
    return (torch.where(has, x[row], _zero(x)), has & x_ok[row])


def _by_fold(fn: str, x, x_ok, key, present, slots, capacity: int):
    """min_by/max_by: the key's extremum over the ``present`` rows,
    then the winning row's value and validity."""
    is_max = fn == "max_by"
    ext = segred.segment_max if is_max else segred.segment_min
    best = ext(_masked(present, key, is_max), slots, capacity)
    winner = present & (key == best[_gather_ids(slots, capacity)])
    xval, xok = _by_winner(x, x_ok, winner, slots, capacity)
    return {"val": best, "xval": xval, "xok": xok}


def _moments(fn: str, c, s, d, w, reduce) -> dict:
    """(count, sum) and the second central moment (with the third and
    fourth for skewness/kurtosis) from the deviations ``d``."""
    z = _zero(d)
    out = {"count": c, "sum": s, "m2": reduce(torch.where(w, d * d, z))}
    if fn in MOMENT_FNS:
        out["m3"] = reduce(torch.where(w, d * d * d, z))
        out["m4"] = reduce(torch.where(w, d * d * d * d, z))
    return out


def fold(fn: str, data, weight, slots, capacity: int, *,
         data2=None, data_valid=None, param=None):
    """Fold rows into per-slot states. ``weight`` is bool live&valid.
    Sketch states are [capacity, width]."""
    w = weight
    if fn == "approx_distinct":
        return {"regs": _hll_fold(data, w, slots, capacity)}
    if fn == "approx_percentile":
        return _percentile_fold(data, w, slots, capacity)
    if fn == "checksum":
        return {"sum": segred.segment_sum(torch.where(w, data, _zero(data)),
                                          slots, capacity)}
    if fn in ("count", "count_star"):
        return {"count": _count(w, slots, capacity)}
    if fn == "count_if":
        return {"count": _count(w & data.to(torch.bool), slots, capacity)}
    if fn in ("sum", "avg"):
        c = _count(w, slots, capacity)
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
    if fn in ("min", "max", "arbitrary") or fn in BOOL_FNS:
        c = _count(w, slots, capacity)
        is_max = fn in _MAX_FNS
        ext = segred.segment_max if is_max else segred.segment_min
        if data2 is not None:
            return {**_long_extremum(*_slot_fns(ext, slots, capacity), w,
                                     data, data2, is_max), "count": c}
        if fn in BOOL_FNS:  # 0/1; an absent row is 0 for or, 1 for and
            b = data.to(torch.int32)
            v = torch.where(w, b, torch.full_like(b, 0 if is_max else 1))
        else:
            v = _masked(w, data, is_max)
        return {"val": ext(v, slots, capacity), "count": c}
    if fn in BY_FNS:
        # x = data (NULL allowed), key = data2 (NULL keys are off in w)
        x_ok = torch.ones_like(w) if data_valid is None else data_valid
        return {**_by_fold(fn, data, x_ok, data2, w, slots, capacity),
                "count": _count(w, slots, capacity)}
    gather = _gather_ids(slots, capacity)
    if fn in COVAR_FNS:
        # y = data, x = data2, both float64: co-moments about the means
        z = _zero(data)
        c = _count(w, slots, capacity)
        sy = segred.segment_sum(torch.where(w, data, z), slots, capacity)
        sx = segred.segment_sum(torch.where(w, data2, z), slots, capacity)
        dy = data - _mean(sy, c)[gather]
        dx = data2 - _mean(sx, c)[gather]

        def seg(v):
            return segred.segment_sum(torch.where(w, v, z), slots,
                                      capacity)
        return {"count": c, "sumx": sx, "sumy": sy, "cxy": seg(dx * dy),
                "m2x": seg(dx * dx), "m2y": seg(dy * dy)}
    if fn in VAR_FNS or fn in MOMENT_FNS:
        # data is float64 (prepare_arg); moments about the group mean
        c = _count(w, slots, capacity)
        s = segred.segment_sum(torch.where(w, data, _zero(data)), slots,
                               capacity)
        d = data - _mean(s, c)[gather]
        return _moments(fn, c, s, d, w, lambda v: segred.segment_sum(
            v, slots, capacity))
    if fn == "geometric_mean":
        return {"count": _count(w, slots, capacity),
                "sumlog": segred.segment_sum(
                    torch.where(w, data, _zero(data)), slots, capacity)}
    raise _unported(fn)


def scan_fold(fn: str, data, weight, sg, *, data2=None, data_valid=None,
              param=None):
    """Sorted-order fold (inputs in hash-sorted row order; state
    arrays are per-row running values, meaningful at each run's last
    row). The sketches (not in ``SCAN_FNS``) fold by ``fold``."""
    from presto_tpu_torch.ops import segscan as S
    w = weight

    def count():
        return S.seg_sum(w.to(torch.int64), sg)
    if fn in ("count", "count_star"):
        return {"count": count()}
    if fn == "count_if":
        return {"count": S.seg_sum((w & data.to(torch.bool))
                                   .to(torch.int64), sg)}
    if fn == "checksum":
        return {"sum": S.seg_sum(torch.where(w, data, _zero(data)), sg)}
    if fn in ("sum", "avg"):
        c = count()
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
    if fn in ("min", "max", "arbitrary") or fn in BOOL_FNS:
        c = count()
        is_max = fn in _MAX_FNS
        ext = S.seg_max if is_max else S.seg_min
        if data2 is not None:
            return {**_long_extremum(lambda x: ext(x, sg),
                                     lambda b: S.broadcast_last(b, sg), w,
                                     data, data2, is_max), "count": c}
        if fn in BOOL_FNS:
            b = data.to(torch.int32)
            v = torch.where(w, b, torch.full_like(b, 0 if is_max else 1))
        else:
            v = _masked(w, data, is_max)
        return {"val": ext(v, sg), "count": c}
    if fn in BY_FNS:
        maximize = fn == "max_by"
        x_ok = (torch.ones_like(w) if data_valid is None
                else data_valid) & w
        best, (xval, xok) = S.seg_argbest(_masked(w, data2, maximize),
                                          (data, x_ok), sg, maximize)
        return {"val": best, "xval": xval, "xok": xok, "count": count()}
    z = torch.zeros((), dtype=torch.float64, device=w.device)
    if fn in COVAR_FNS:
        c = count()
        sy = S.seg_sum(torch.where(w, data, z), sg)
        sx = S.seg_sum(torch.where(w, data2, z), sg)
        cl = S.broadcast_last(c, sg)
        dy = data - _mean(S.broadcast_last(sy, sg), cl)
        dx = data2 - _mean(S.broadcast_last(sx, sg), cl)
        return {"count": c, "sumx": sx, "sumy": sy,
                "cxy": S.seg_sum(torch.where(w, dx * dy, z), sg),
                "m2x": S.seg_sum(torch.where(w, dx * dx, z), sg),
                "m2y": S.seg_sum(torch.where(w, dy * dy, z), sg)}
    if fn in VAR_FNS or fn in MOMENT_FNS:
        c = count()
        s = S.seg_sum(torch.where(w, data, z), sg)
        d = data - _mean(S.broadcast_last(s, sg), S.broadcast_last(c, sg))
        return _moments(fn, c, s, d, w, lambda v: S.seg_sum(v, sg))
    if fn == "geometric_mean":
        return {"count": count(),
                "sumlog": S.seg_sum(torch.where(w, data, z), sg)}
    raise _unported(fn)


def _live(states: dict, w, fields) -> tuple:
    """Live partial states; dead rows contribute 0."""
    return tuple(torch.where(w, states[f], _zero(states[f]))
                 for f in fields)


def _moment_merge(states: dict, w, reduce, back, moments: bool) -> dict:
    """Chan et al.: each partial's moments shift by its mean's
    deviation d from the total mean: M2 += n_i d^2, and for the third
    and fourth M3 += 3 d M2_i + n_i d^3, M4 += 4 d M3_i + 6 d^2 M2_i +
    n_i d^4. ``reduce`` folds per group, ``back`` brings a group's
    total back to its rows."""
    n_i, s_i, m2_i = _live(states, w, ("count", "sum", "m2"))
    n, s = reduce(n_i), reduce(s_i)
    d = _mean(s_i, n_i) - _mean(back(s), back(n))
    nf = n_i.to(torch.float64)
    out = {"count": n, "sum": s, "m2": reduce(m2_i + nf * d * d)}
    if moments:
        m3_i, m4_i = _live(states, w, ("m3", "m4"))
        out["m3"] = reduce(m3_i + 3 * d * m2_i + nf * d ** 3)
        out["m4"] = reduce(m4_i + 4 * d * m3_i + 6 * d * d * m2_i
                           + nf * d ** 4)
    return out


def _covar_merge(states: dict, w, reduce, back) -> dict:
    """Chan et al., bivariate: co-moments shift by the product of the
    partial means' deviations."""
    n_i, sx_i, sy_i, cxy, m2x, m2y = _live(
        states, w, ("count", "sumx", "sumy", "cxy", "m2x", "m2y"))
    n, sx, sy = reduce(n_i), reduce(sx_i), reduce(sy_i)
    dx = _mean(sx_i, n_i) - _mean(back(sx), back(n))
    dy = _mean(sy_i, n_i) - _mean(back(sy), back(n))
    nw = n_i.to(torch.float64)
    return {"count": n, "sumx": sx, "sumy": sy,
            "cxy": reduce(cxy + nw * dx * dy),
            "m2x": reduce(m2x + nw * dx * dx),
            "m2y": reduce(m2y + nw * dy * dy)}


def scan_merge(fn: str, states: dict, live, sg):
    """Sorted-order merge of partial states."""
    from presto_tpu_torch.ops import segscan as S
    w = live

    def reduce(v):
        return S.seg_sum(v, sg)

    def back(v):
        return S.broadcast_last(v, sg)
    if fn in ("count", "count_star", "count_if"):
        return {"count": reduce(*_live(states, w, ("count",)))}
    if fn == "checksum":
        return {"sum": reduce(*_live(states, w, ("sum",)))}
    if fn in ("sum", "avg"):
        fields = ("a", "b", "hi", "count") if "a" in states \
            else ("sum", "count")
        if "a" in states:
            states = _normalize_limbs(states)
        return {f: reduce(v) for f, v in zip(fields,
                                             _live(states, w, fields))}
    if fn in ("min", "max", "arbitrary") or fn in BOOL_FNS:
        is_max = fn in _MAX_FNS
        ext = S.seg_max if is_max else S.seg_min
        c = reduce(*_live(states, w, ("count",)))
        if "vlo" in states:
            return {**_long_extremum(
                lambda x: ext(x, sg), back, w & (states["count"] > 0),
                states["vlo"], states["vhi"], is_max), "count": c}
        return {"val": ext(_masked(w, states["val"], is_max), sg),
                "count": c}
    if fn in BY_FNS:
        maximize = fn == "max_by"
        present = w & (states["count"] > 0)
        best, (xval, xok) = S.seg_argbest(
            _masked(present, states["val"], maximize),
            (states["xval"], states["xok"] & present), sg, maximize)
        return {"val": best, "xval": xval, "xok": xok,
                "count": reduce(*_live(states, w, ("count",)))}
    if fn in VAR_FNS or fn in MOMENT_FNS:
        return _moment_merge(states, w, reduce, back, fn in MOMENT_FNS)
    if fn in COVAR_FNS:
        return _covar_merge(states, w, reduce, back)
    if fn == "geometric_mean":
        return {f: reduce(v) for f, v in zip(
            ("count", "sumlog"), _live(states, w, ("count", "sumlog")))}
    raise _unported(fn)


def merge(fn: str, states: dict, slots, capacity: int, live):
    """Merge partial states (rows of state columns) into a final state
    table."""
    w = live

    def reduce(v):
        return segred.segment_sum(v, slots, capacity)
    gather = _gather_ids(slots, capacity)

    def back(v):
        return v[gather]
    if fn == "approx_distinct":
        # register-wise max over the partials, flattened
        regs = states["regs"]
        _require_cells(fn, capacity, regs.shape[1])
        cells = torch.arange(regs.shape[1], dtype=torch.int64,
                             device=regs.device)[None, :]
        ids = _cell_ids(slots, capacity, regs.shape[1], cells)
        data = torch.where(w[:, None], regs, _zero(regs))
        return {"regs": segred.segment_max(
            data.reshape(-1), ids.reshape(-1),
            capacity * regs.shape[1]).reshape(capacity, regs.shape[1])}
    if fn == "approx_percentile":
        # the same min-hash winner rule per (slot, cell) across partials
        rhash, rval = states["rhash"], states["rval"]
        k = rhash.shape[1]
        _require_cells(fn, capacity, k)
        cells = torch.arange(k, dtype=torch.int64,
                             device=rhash.device)[None, :]
        ids = _cell_ids(slots, capacity, k, cells).reshape(-1)
        wk = w[:, None].expand(rhash.shape).reshape(-1)
        h, v = _reservoir(unsigned_key(rhash).reshape(-1), rval.reshape(-1),
                          wk, ids, capacity * k)
        return {"rhash": h.reshape(capacity, k), "rval": v.reshape(capacity,
                                                                   k)}
    if fn in ("count", "count_star", "count_if"):
        return {"count": reduce(*_live(states, w, ("count",)))}
    if fn == "checksum":
        return {"sum": reduce(*_live(states, w, ("sum",)))}
    if fn in ("sum", "avg"):
        fields = ("a", "b", "hi", "count") if "a" in states \
            else ("sum", "count")
        if "a" in states:
            states = _normalize_limbs(states)
        return {f: reduce(v) for f, v in zip(fields,
                                             _live(states, w, fields))}
    if fn in ("min", "max", "arbitrary") or fn in BOOL_FNS:
        is_max = fn in _MAX_FNS
        ext = segred.segment_max if is_max else segred.segment_min
        c = reduce(*_live(states, w, ("count",)))
        if "vlo" in states:
            return {**_long_extremum(
                *_slot_fns(ext, slots, capacity), w & (states["count"] > 0),
                states["vlo"], states["vhi"], is_max), "count": c}
        return {"val": ext(_masked(w, states["val"], is_max), slots,
                           capacity),
                "count": c}
    if fn in BY_FNS:
        present = w & (states["count"] > 0)
        return {**_by_fold(fn, states["xval"], states["xok"], states["val"],
                           present, slots, capacity),
                "count": reduce(*_live(states, w, ("count",)))}
    if fn in VAR_FNS or fn in MOMENT_FNS:
        return _moment_merge(states, w, reduce, back, fn in MOMENT_FNS)
    if fn in COVAR_FNS:
        return _covar_merge(states, w, reduce, back)
    if fn == "geometric_mean":
        return {f: reduce(v) for f, v in zip(
            ("count", "sumlog"), _live(states, w, ("count", "sumlog")))}
    raise _unported(fn)


def _hll_estimate(regs):
    """HyperLogLog's estimate with the linear-counting correction for
    small cardinalities (Flajolet et al.)."""
    m = float(regs.shape[1])
    r = regs.to(torch.float64)
    z = torch.sum(torch.exp2(-r), dim=1)
    v = torch.sum(regs == 0, dim=1).to(torch.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    e = alpha * m * m / z
    lin = m * torch.log(m / torch.clamp(v, min=1.0))
    e = torch.where((e <= 2.5 * m) & (v > 0), lin, e)
    return torch.round(e).to(torch.int64)


def _percentile(rhash, rval, out_type, param):
    """The value at rank round(p * (count - 1)) among a group's
    occupied reservoir cells."""
    occupied = rhash != _U64_MAX
    cnt = torch.sum(occupied, dim=1)
    vals = torch.sort(torch.where(occupied, rval, float("inf")),
                      dim=1).values
    p = 0.5 if param is None else float(param)
    idx = torch.clamp(torch.round((cnt - 1).to(torch.float64) * p)
                      .to(torch.int64), 0,
                      rhash.shape[1] - 1)
    out = torch.gather(vals, 1, idx[:, None])[:, 0]
    out = torch.where(cnt > 0, out, torch.zeros_like(out))
    if isinstance(out_type, (T.DecimalType, T.BigintType, T.IntegerType,
                             T.DateType)):
        out = torch.round(out).to(torch.int64)
    return out, cnt > 0


def _covar_final(fn: str, states: dict):
    c = states["count"]
    cf = torch.clamp(c, min=1).to(torch.float64)
    cxy, m2x, m2y = states["cxy"], states["m2x"], states["m2y"]
    one = torch.ones((), dtype=torch.float64, device=c.device)
    if fn == "covar_pop":
        return cxy / cf, c > 0
    if fn == "covar_samp":
        return cxy / torch.clamp(cf - 1.0, min=1.0), c > 1
    if fn == "corr":
        ok = (c > 1) & (m2x > 0) & (m2y > 0)
        return cxy / torch.where(ok, torch.sqrt(m2x * m2y), one), ok
    slope = cxy / torch.where(m2x > 0, m2x, one)
    ok = (c > 0) & (m2x > 0)
    if fn == "regr_slope":
        return slope, ok
    return states["sumy"] / cf - slope * (states["sumx"] / cf), ok


def _moment_final(fn: str, states: dict):
    """The reference's CentralMomentsAggregation finalization."""
    c = states["count"]
    nf = c.to(torch.float64)
    m2 = states["m2"]
    if fn == "skewness":
        denom = torch.clamp(m2, min=1e-300) ** 1.5
        return torch.sqrt(nf) * states["m3"] / denom, c > 2
    d23 = torch.clamp((nf - 2) * (nf - 3), min=1.0)
    val = ((nf - 1) * nf * (nf + 1)) / d23 * states["m4"] \
        / torch.clamp(m2 * m2, min=1e-300) \
        - 3 * ((nf - 1) * (nf - 1)) / d23
    return val, c > 3


def finalize(fn: str, states: dict, out_type: T.DataType,
             arg_type: T.DataType | None, param: float | None = None):
    """States -> (data, valid) final columns."""
    if fn in ("count", "count_star", "count_if"):
        return states["count"], None
    if fn == "approx_distinct":
        return _hll_estimate(states["regs"]), None
    if fn == "approx_percentile":
        return _percentile(states["rhash"], states["rval"], out_type, param)
    if fn == "checksum":  # the wrapped int64 is the uint64's bit pattern
        return states["sum"], None
    if fn in COVAR_FNS:
        return _covar_final(fn, states)
    if fn in BY_FNS:
        return states["xval"], (states["count"] > 0) & states["xok"]
    if fn in BOOL_FNS:
        return states["val"] > 0, states["count"] > 0
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
    if fn in MOMENT_FNS:
        return _moment_final(fn, states)
    if fn == "geometric_mean":
        c = states["count"]
        return torch.exp(_mean(states["sumlog"], c)), c > 0
    raise _unported(fn)
