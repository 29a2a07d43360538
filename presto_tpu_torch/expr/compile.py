"""Expression IR -> eager tensor code — the port of
``presto_tpu/expr/compile.py``.

The compiler walks the IR and runs torch ops over the input columns on
their device. Value model (``Val``): (dtype, data, valid, dictionary)

- data: a tensor [n] (or a 0-d tensor for a literal); LONG decimals
  are [n, 2] int64 limbs (ops/int128.py);
- valid: a bool tensor or None (None = all valid); Kleene logic for
  AND, null propagation elsewhere;
- dictionary: the host-side sorted numpy string array of a VARCHAR
  value. String operations are dictionary transforms evaluated on the
  host (LIKE matches the pattern over the dictionary and gathers a
  boolean lookup table by code).

The port covers what the 22 TPC-H queries and the TPC-DS suite use:
column references, literals, IS [NOT] NULL, IN lists, CASE, casts
among numeric, decimal and date types and from varchar to date and
timestamp, and the scalar functions add, subtract, multiply, divide,
modulus (and mod), negate, abs, round, greatest, least, coalesce,
nullif, row_index, eq, neq, lt, lte, gt, gte, and, or, not, between,
like, substring, concat, upper, lower and year. Every other expression
form and function raises ``NotImplementedError`` naming itself.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.expr import ir


@dataclasses.dataclass
class Val:
    """One columnar value."""

    dtype: T.DataType
    data: object
    valid: object | None = None
    dictionary: np.ndarray | None = None

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.VarcharType)


def is_long_dec(t) -> bool:
    """LONG decimal (precision 19..38): int128 as [n, 2] int64 limbs."""
    return isinstance(t, T.DecimalType) and t.is_long


def _lit128_np(value: int) -> np.ndarray:
    """Python int -> [2] int64 limb constant (low word bit pattern,
    signed high word)."""
    m = value & ((1 << 128) - 1)
    lov, hiv = m & ((1 << 64) - 1), (m >> 64) & ((1 << 64) - 1)
    tos = lambda x: x - (1 << 64) if x >= (1 << 63) else x  # noqa: E731
    return np.asarray([tos(lov), tos(hiv)], np.int64)


def as128(v: Val, scale: int):
    """A decimal/integer Val's data as int128 limbs at ``scale``
    (rescaling up only — callers align to the wider scale)."""
    from presto_tpu_torch.ops import int128 as I
    if is_long_dec(v.dtype):
        d = v.data
        ds = v.dtype.scale
    else:
        d = I.from_i64(v.data)
        ds = v.dtype.scale if isinstance(v.dtype, T.DecimalType) else 0
    if scale > ds:
        d = I.rescale_up(d, scale - ds)
    return d


def where_data(cond, x, y, long: bool = False):
    """``torch.where`` that broadcasts a scalar or [n] condition over
    [n, 2] limb data. ``long`` marks LONG-decimal branches: a scalar
    LONG value is [2]-shaped, like a 2-row column."""
    if long or max(x.ndim, y.ndim) == 2:
        if long:
            x = x[None, :] if x.ndim == 1 else x
            y = y[None, :] if y.ndim == 1 else y
        cond = cond.reshape(cond.shape + (1,) * (2 - cond.ndim)) \
            if cond.ndim < 2 else cond
    return torch.where(cond, x, y)


def and_valid(*vs):
    """AND of validity masks, None = all-valid."""
    masks = [v for v in vs if v is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def _bool(data, valid=None) -> Val:
    return Val(T.BOOLEAN, data, valid)


def _lut(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return HS.upload(values, like.device, "dictionary-lut")


def _by_code(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``lut`` at dictionary ``codes`` of any shape, a literal's 0-d code
    included (indexing with a 0-d tensor would read it on the host)."""
    return torch.take(lut, codes.to(torch.int64))


# --- dictionary helpers (host side) ----------------------------------------


def _dict_transform(v: Val, fn: Callable[[np.ndarray], np.ndarray]) -> Val:
    """Apply a host string->string function over the dictionary and
    remap codes to the new sorted dictionary."""
    new_strings = fn(v.dictionary.astype("U")).astype(object)
    new_dict, inverse = np.unique(new_strings.astype("U"),
                                  return_inverse=True)
    remap = _lut(inverse.astype(np.int32), v.data)
    return Val(T.VARCHAR, _by_code(remap, v.data), v.valid,
               new_dict.astype(object))


def _merge_dicts(a: Val, b: Val) -> tuple[Val, Val]:
    """Bring two string Vals onto one shared sorted dictionary."""
    if a.dictionary is b.dictionary:
        return a, b
    union = np.unique(np.concatenate(
        [a.dictionary.astype("U"), b.dictionary.astype("U")]))
    ra = _lut(np.searchsorted(union, a.dictionary.astype("U"))
              .astype(np.int32), a.data)
    rb = _lut(np.searchsorted(union, b.dictionary.astype("U"))
              .astype(np.int32), b.data)
    u = union.astype(object)
    return (Val(a.dtype, _by_code(ra, a.data), a.valid, u),
            Val(b.dtype, _by_code(rb, b.data), b.valid, u))


def _dict_predicate(v: Val, pred: Callable[[np.ndarray], np.ndarray]) -> Val:
    """Host-evaluate a string predicate over the dictionary, gather by
    code."""
    lut = _lut(pred(v.dictionary.astype("U")).astype(np.bool_), v.data)
    return _bool(_by_code(lut, v.data), v.valid)


def _like_regex(pattern: str, escape: str | None = None) -> re.Pattern:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)


def _align_strings(a: Val, b: Val) -> tuple[object, object]:
    """Comparable code tensors for two string Vals (equality only,
    unless the dictionaries are one object): a's codes translate into
    b's code space through a host-computed mapping (-1 where a's
    string is absent from b's dictionary)."""
    if a.dictionary is b.dictionary:
        return a.data, b.data
    idx = np.searchsorted(b.dictionary, a.dictionary.astype("U"))
    idx = np.clip(idx, 0, max(len(b.dictionary) - 1, 0))
    ok = (b.dictionary.astype("U")[idx] == a.dictionary.astype("U")) if len(
        b.dictionary) else np.zeros(len(a.dictionary), bool)
    mapping = np.where(ok, idx, -1).astype(np.int32)
    return _by_code(_lut(mapping, a.data), a.data), b.data


# --- the compiler ----------------------------------------------------------


class ExprCompiler:
    """Compiles IR against a set of named input columns (Vals) on
    ``device``."""

    def __init__(self, columns: dict[str, Val], device):
        self.columns = columns
        self.device = torch.device(device)

    def compile(self, expr: ir.Expr) -> Val:
        method = getattr(self, "_c_" + type(expr).__name__.lower(), None)
        if method is None:
            raise NotImplementedError(
                f"{type(expr).__name__} expressions are not ported to "
                "presto_tpu_torch yet")
        return method(expr)

    def _tensor(self, value: np.ndarray) -> torch.Tensor:
        return HS.upload(value, self.device, "literal")

    # -- leaves

    def _c_columnref(self, e: ir.ColumnRef) -> Val:
        return self.columns[e.name]

    def _c_literal(self, e: ir.Literal) -> Val:
        if e.value is None:
            zero = np.zeros((2,) if is_long_dec(e.dtype) else (),
                            dtype=e.dtype.physical_dtype)
            dictionary = (np.array([""], dtype=object)
                          if isinstance(e.dtype, T.VarcharType) else None)
            return Val(e.dtype, self._tensor(zero),
                       self._tensor(np.asarray(False)), dictionary)
        if isinstance(e.dtype, T.VarcharType):
            return Val(e.dtype, self._tensor(np.asarray(0, np.int32)), None,
                       np.array([e.value], dtype=object))
        if is_long_dec(e.dtype):
            return Val(e.dtype, self._tensor(_lit128_np(int(e.value))))
        return Val(e.dtype, self._tensor(
            np.asarray(e.value, dtype=e.dtype.physical_dtype)))

    # -- structured forms

    def _c_cast(self, e: ir.Cast) -> Val:
        return cast_val(self.compile(e.arg), e.dtype)

    def _c_isnull(self, e: ir.IsNull) -> Val:
        v = self.compile(e.arg)
        isnull = (torch.zeros((), dtype=torch.bool, device=self.device)
                  if v.valid is None else ~v.valid)
        return _bool(~isnull if e.negated else isnull)

    def _c_inlist(self, e: ir.InList) -> Val:
        v = self.compile(e.arg)
        if v.is_string:
            values = [lit.value for lit in e.values]
            return _dict_predicate(v, lambda d: np.isin(d, values))
        acc = None
        for lit in e.values:
            hit = v.data == cast_val(self.compile(lit), v.dtype).data
            acc = hit if acc is None else (acc | hit)
        return _bool(acc, v.valid)

    def _c_casewhen(self, e: ir.CaseWhen) -> Val:
        default = (self.compile(e.default) if e.default is not None
                   else self.compile(ir.Literal(e.dtype, None)))
        result = cast_val(default, e.dtype)
        long = is_long_dec(e.dtype)
        # WHENs in reverse, so earlier conditions win
        for cond, res in list(zip(e.conditions, e.results))[::-1]:
            c = self.compile(cond)
            r = cast_val(self.compile(res), e.dtype)
            take = c.data if c.valid is None else (c.data & c.valid)
            if r.is_string or result.is_string:
                r, result = _merge_dicts(r, result)
            data = where_data(take, r.data, result.data, long=long)
            rv = torch.ones_like(take) if r.valid is None else r.valid
            dv = torch.ones_like(take) if result.valid is None \
                else result.valid
            result = Val(e.dtype, data, torch.where(take, rv, dv),
                         result.dictionary)
        return result

    def _c_call(self, e: ir.Call) -> Val:
        fn = SCALARS.get(e.fn)
        if fn is None:
            raise NotImplementedError(
                f"scalar function {e.fn} is not ported to presto_tpu_torch "
                "yet")
        return fn(e, [self.compile(a) for a in e.args])


# --- casts -----------------------------------------------------------------


def _rescale128(d, from_scale: int, to_scale: int):
    """int128 limbs rescaled between decimal scales (HALF_UP down)."""
    from presto_tpu_torch.ops import int128 as I
    if to_scale >= from_scale:
        return I.rescale_up(d, to_scale - from_scale)
    k = from_scale - to_scale
    f = I.from_i64(torch.full((), 10 ** min(k, 18), dtype=torch.int64,
                              device=d.device))
    if k > 18:
        f = I.rescale_up(f, k - 18)
    return I.div_round_half_up(d, f.expand(d.shape))


def _cast_long_decimal(v: Val, to: T.DecimalType) -> Val:
    """Casts where the source or target is a LONG decimal."""
    from presto_tpu_torch.ops import int128 as I
    if isinstance(v.dtype, T.DecimalType):
        src_scale = v.dtype.scale
        d = v.data if is_long_dec(v.dtype) else I.from_i64(v.data)
    elif isinstance(v.dtype, (T.BigintType, T.IntegerType)):
        src_scale = 0
        d = I.from_i64(v.data)
    else:
        raise NotImplementedError(f"cast {v.dtype} -> {to} is not ported "
                                  "to presto_tpu_torch yet")
    d = _rescale128(d, src_scale, to.scale)
    if not to.is_long:
        return Val(to, I.to_i64(d), v.valid)
    return Val(to, d, v.valid)


def _div_round(x, f: int):
    """Integer division rounding half away from zero."""
    half = f // 2
    return torch.where(x >= 0, (x + half) // f, -((-x + half) // f))


def cast_val(v: Val, to: T.DataType) -> Val:
    if v.dtype == to:
        return v
    d = v.data
    if isinstance(to, T.DoubleType) and not v.is_string:
        if is_long_dec(v.dtype):
            from presto_tpu_torch.ops import int128 as I
            return Val(to, I.to_f64(d) / v.dtype.unscale_factor, v.valid)
        if isinstance(v.dtype, T.DecimalType):
            return Val(to, d.to(torch.float64) / v.dtype.unscale_factor,
                       v.valid)
        return Val(to, d.to(torch.float64), v.valid)
    if isinstance(to, T.DecimalType) and not v.is_string:
        if to.is_long or is_long_dec(v.dtype):
            return _cast_long_decimal(v, to)
        if isinstance(v.dtype, T.DecimalType):
            ds, ts = v.dtype.scale, to.scale
            if ts >= ds:
                return Val(to, d * (10 ** (ts - ds)), v.valid)
            return Val(to, _div_round(d, 10 ** (ds - ts)), v.valid)
        if isinstance(v.dtype, (T.BigintType, T.IntegerType)):
            return Val(to, d.to(torch.int64) * to.unscale_factor, v.valid)
        if isinstance(v.dtype, T.DoubleType):
            return Val(to, torch.round(d * to.unscale_factor)
                       .to(torch.int64), v.valid)
    if isinstance(to, T.BigintType) and not v.is_string:
        if is_long_dec(v.dtype):
            from presto_tpu_torch.ops import int128 as I
            scaled = _rescale128(d, v.dtype.scale, 0)
            return Val(to, I.to_i64(scaled), v.valid)
        if isinstance(v.dtype, T.DecimalType):
            return Val(to, _div_round(d, v.dtype.unscale_factor), v.valid)
        return Val(to, d.to(torch.int64), v.valid)
    if isinstance(to, T.IntegerType) and not v.is_string:
        return Val(to, d.to(torch.int32), v.valid)
    if isinstance(to, T.TimestampType) and isinstance(v.dtype, T.DateType):
        return Val(to, d.to(torch.int64) * T.US_PER_DAY, v.valid)
    if isinstance(to, T.DateType) and isinstance(v.dtype, T.TimestampType):
        return Val(to, torch.div(d, T.US_PER_DAY, rounding_mode="floor")
                   .to(torch.int32), v.valid)
    if isinstance(to, T.TimestampType) and v.is_string:
        return _parse_dictionary(v, to, "us", np.int64)
    if isinstance(to, T.DateType) and v.is_string:
        return _parse_dictionary(v, to, "D", np.int32)
    raise NotImplementedError(f"cast {v.dtype} -> {to} is not ported to "
                              "presto_tpu_torch yet")


def _gather_lut(values: np.ndarray, ok: np.ndarray, v: Val, to) -> Val:
    """Rows of a per-dictionary-entry parse: each row gathers its
    entry's value and parse flag by code (codes clamped); a failed
    parse is NULL."""
    if not len(values):  # an empty dictionary: every row fails
        values, ok = np.zeros(1, values.dtype), np.zeros(1, bool)
    codes = torch.clamp(v.data.to(torch.int64), 0, len(values) - 1)
    return Val(to, _by_code(_lut(values, v.data), codes),
               and_valid(v.valid, _by_code(_lut(ok, v.data), codes)))


def _parse_dictionary(v: Val, to: T.DataType, unit: str,
                      dtype) -> Val:
    """varchar -> date (``unit="D"``) or timestamp (``"us"``): one ISO
    parse per dictionary entry (a date reads the first ten characters,
    a timestamp may use a space for the 'T'); malformed strings become
    NULL (reference castToDate / _parse_datetime_dictionary)."""
    epoch = np.datetime64("1970-01-01", unit)
    values = np.zeros(len(v.dictionary), dtype=dtype)
    ok = np.zeros(len(v.dictionary), dtype=bool)
    for i, s in enumerate(v.dictionary):
        text = str(s).strip()
        text = text[:10] if unit == "D" else text.replace(" ", "T")
        try:
            d64 = np.datetime64(text, unit)
        except (ValueError, OverflowError):
            continue
        if not np.isnat(d64):  # '' and 'NaT' parse to NaT
            values[i] = int((d64 - epoch).astype(np.int64))
            ok[i] = True
    return _gather_lut(values, ok, v, to)


# --- scalar function registry ---------------------------------------------

SCALARS: dict[str, Callable] = {}


def scalar(name: str):
    def deco(fn):
        SCALARS[name] = fn
        return fn
    return deco


def _decimal_align(a: Val, b: Val) -> tuple[Val, Val, int]:
    sa = a.dtype.scale if isinstance(a.dtype, T.DecimalType) else 0
    sb = b.dtype.scale if isinstance(b.dtype, T.DecimalType) else 0
    s = max(sa, sb)
    da = a.data * (10 ** (s - sa))
    db = b.data * (10 ** (s - sb))
    return (Val(a.dtype, da, a.valid), Val(b.dtype, db, b.valid), s)


def _arith(e: ir.Call, args: list[Val], op) -> Val:
    from presto_tpu_torch.ops import int128 as I
    a, b = args
    valid = and_valid(a.valid, b.valid)
    if isinstance(e.dtype, T.DoubleType):
        a, b = cast_val(a, T.DOUBLE), cast_val(b, T.DOUBLE)
        return Val(e.dtype, op(a.data, b.data), valid)
    if isinstance(e.dtype, T.DecimalType):
        long_any = (e.dtype.is_long or is_long_dec(a.dtype)
                    or is_long_dec(b.dtype))
        if e.fn in ("add", "subtract"):
            if long_any:
                s = e.dtype.scale
                x, y = as128(a, s), as128(b, s)
                d = I.add(x, y) if e.fn == "add" else I.sub(x, y)
                if not e.dtype.is_long:
                    d = I.to_i64(d)
                return Val(e.dtype, d, valid)
            a2, b2, _ = _decimal_align(a, b)
            return Val(e.dtype, op(a2.data, b2.data), valid)
        if e.fn == "multiply":
            if long_any:
                if not (is_long_dec(a.dtype) or is_long_dec(b.dtype)):
                    # short x short -> exact int128 product
                    d = I.mul_i64(a.data, b.data)
                else:
                    sa = (a.dtype.scale if isinstance(
                        a.dtype, T.DecimalType) else 0)
                    sb = (b.dtype.scale if isinstance(
                        b.dtype, T.DecimalType) else 0)
                    d = I.mul(as128(a, sa), as128(b, sb))
                if not e.dtype.is_long:
                    d = I.to_i64(d)
                return Val(e.dtype, d, valid)
            return Val(e.dtype, a.data * b.data, valid)
    return Val(e.dtype, op(a.data, b.data), valid)


@scalar("add")
def _add(e, args):
    if isinstance(e.dtype, T.DateType):  # date + interval(days)
        a, b = args
        return Val(e.dtype, (a.data + b.data).to(torch.int32),
                   and_valid(a.valid, b.valid))
    return _arith(e, args, lambda x, y: x + y)


@scalar("subtract")
def _sub(e, args):
    if isinstance(e.dtype, T.DateType):
        a, b = args
        return Val(e.dtype, (a.data - b.data).to(torch.int32),
                   and_valid(a.valid, b.valid))
    return _arith(e, args, lambda x, y: x - y)


@scalar("multiply")
def _mul(e, args):
    return _arith(e, args, lambda x, y: x * y)


def _scale(t) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


@scalar("divide")
def _div(e, args):
    a, b = args
    valid = and_valid(a.valid, b.valid)
    if isinstance(e.dtype, T.DoubleType):
        af, bf = cast_val(a, T.DOUBLE), cast_val(b, T.DOUBLE)
        # division by zero is an error in SQL; it reads as NULL here,
        # as in the reference
        safe = torch.where(bf.data == 0.0, 1.0, bf.data)
        return Val(e.dtype, af.data / safe,
                   and_valid(valid, bf.data != 0.0))
    if isinstance(e.dtype, T.DecimalType):
        # decimal / decimal at result scale s: (a * 10^(s + sb - sa)) / b
        # rounded half up (the reference's divideShortShortShort)
        sa, sb, s = _scale(a.dtype), _scale(b.dtype), e.dtype.scale
        pa = a.dtype.precision if isinstance(a.dtype, T.DecimalType) \
            else 19
        if (e.dtype.is_long or is_long_dec(a.dtype)
                or is_long_dec(b.dtype) or s + sb - sa + pa > 18):
            from presto_tpu_torch.ops import int128 as I
            num = I.rescale_up(as128(a, sa), s + sb - sa)
            den = as128(b, sb)
            num, den = torch.broadcast_tensors(num, den)
            bz = I.eq(den, torch.zeros_like(den))
            q = I.div_round_half_up(num, den)
            if not e.dtype.is_long:
                q = I.to_i64(q)
            return Val(e.dtype, q, and_valid(valid, ~bz))
        num = a.data.to(torch.int64) * (10 ** (s + sb - sa))
        den = torch.where(b.data == 0, 1, b.data.to(torch.int64))
        q = (torch.abs(num) + torch.abs(den) // 2) // torch.abs(den)
        q = torch.where((num >= 0) == (den >= 0), q, -q)
        return Val(e.dtype, q, and_valid(valid, b.data != 0))
    # SQL integer division truncates toward zero
    safe = torch.where(b.data == 0, 1, b.data)
    q = torch.abs(a.data) // torch.abs(safe)
    q = torch.where((a.data >= 0) == (safe >= 0), q, -q)
    return Val(e.dtype, q, and_valid(valid, b.data != 0))


@scalar("modulus")
@scalar("mod")
def _mod(e, args):
    """Remainder truncating toward zero (the dividend's sign), NULL
    for a zero divisor."""
    a, b = args
    if isinstance(e.dtype, T.DoubleType):
        a, b = cast_val(a, T.DOUBLE), cast_val(b, T.DOUBLE)
    elif (is_long_dec(a.dtype) or is_long_dec(b.dtype)
          or is_long_dec(e.dtype)):
        from presto_tpu_torch.ops import int128 as I
        sa, sb = _scale(a.dtype), _scale(b.dtype)
        s = max(sa, sb)
        pa = a.dtype.precision if isinstance(a.dtype, T.DecimalType) \
            else 19
        pb = b.dtype.precision if isinstance(b.dtype, T.DecimalType) \
            else 19
        need = max(pa + s - sa, pb + s - sb)
        if need > 38:
            raise NotImplementedError(
                f"decimal remainder aligning {a.dtype} and {b.dtype} "
                f"needs {need} digits, exceeding the maximum decimal "
                f"precision 38")
        x, y = torch.broadcast_tensors(as128(a, s), as128(b, s))
        bz = I.eq(y, torch.zeros_like(y))
        r = I.rem_trunc(x, y)
        out = r if is_long_dec(e.dtype) else I.to_i64(r)
        return Val(e.dtype, out, and_valid(a.valid, b.valid, ~bz))
    elif isinstance(a.dtype, T.DecimalType) or \
            isinstance(b.dtype, T.DecimalType):
        # (a*f) mod (b*f) = f*(a mod b): already at the common scale
        a, b, _ = _decimal_align(a, b)
    safe = torch.where(b.data == 0, torch.ones_like(b.data), b.data)
    out = torch.fmod(a.data, safe)
    nz = b.data != 0
    if nz.ndim == 0 and out.ndim > 0:
        nz = nz.expand(out.shape)  # literal divisor
    return Val(e.dtype, out, and_valid(a.valid, b.valid, nz))


@scalar("negate")
def _neg(e, args):
    (a,) = args
    if is_long_dec(e.dtype):
        from presto_tpu_torch.ops import int128 as I
        return Val(e.dtype, I.neg(a.data), a.valid)
    return Val(e.dtype, -a.data, a.valid)


@scalar("abs")
def _abs(e, args):
    (a,) = args
    if is_long_dec(e.dtype):
        from presto_tpu_torch.ops import int128 as I
        return Val(e.dtype, I.abs_(a.data), a.valid)
    return Val(e.dtype, torch.abs(a.data), a.valid)


@scalar("round")
def _round(e, args):
    """round(x[, digits]): decimals round half up in the scaled domain
    (through int128 for LONG decimals); doubles round half to even,
    as the reference's ``jnp.round`` does."""
    a = args[0]
    digits = 0
    if len(e.args) > 1:
        if not isinstance(e.args[1], ir.Literal):
            raise NotImplementedError("round with non-literal digits")
        digits = int(e.args[1].value)
    if not isinstance(a.dtype, T.DecimalType):
        f = 10.0 ** digits
        return Val(e.dtype, torch.round(a.data * f) / f, a.valid)
    drop = a.dtype.scale - digits
    if drop <= 0:
        return Val(e.dtype, a.data, a.valid)
    keep_scale = (isinstance(e.dtype, T.DecimalType)
                  and e.dtype.scale == a.dtype.scale)
    if is_long_dec(a.dtype) or is_long_dec(e.dtype):
        from presto_tpu_torch.ops import int128 as I
        d = a.data if is_long_dec(a.dtype) else I.from_i64(a.data)
        if drop > 38:
            # |x| < 10^38 <= 0.5 * 10^drop: every value rounds to zero
            q = torch.zeros_like(d)
        else:
            q = _rescale128(d, drop, 0)
            if keep_scale:
                q = I.rescale_up(q, drop)
            elif digits < 0:
                # round(123.45, -1): 12 tens at scale 0 -> 120
                q = I.rescale_up(q, -digits)
        return Val(e.dtype, q if is_long_dec(e.dtype) else I.to_i64(q),
                   a.valid)
    if drop > 18:
        # |x| < 10^18 <= 0.5 * 10^drop
        return Val(e.dtype, torch.zeros_like(a.data), a.valid)
    mult = ((10 ** drop) if keep_scale
            else (10 ** -digits) if digits < 0 else 1)
    return Val(e.dtype, _div_round(a.data, 10 ** drop) * mult, a.valid)


@scalar("greatest")
@scalar("least")
def _greatest_least(e, args):
    """NULL if any argument is NULL. Strings compare by code over
    their merged (sorted) dictionary."""
    op = torch.maximum if e.fn == "greatest" else torch.minimum
    if any(a.is_string for a in args):
        out = args[0]
        valid = out.valid
        for v in args[1:]:
            v, out = _merge_dicts(v, out)
            valid = and_valid(valid, v.valid)
            out = Val(e.dtype, op(out.data, v.data), None, out.dictionary)
        return Val(e.dtype, out.data, valid, out.dictionary)
    out = cast_val(args[0], e.dtype)
    valid = out.valid
    for v in args[1:]:
        v = cast_val(v, e.dtype)
        if is_long_dec(e.dtype):
            from presto_tpu_torch.ops import int128 as I
            sel = I.lt(out.data, v.data)
            pick_v = sel if e.fn == "greatest" else ~sel
            out = Val(e.dtype, where_data(pick_v, v.data, out.data,
                                          long=True))
        else:
            out = Val(e.dtype, op(out.data, v.data))
        valid = and_valid(valid, v.valid)
    return Val(e.dtype, out.data, valid)


@scalar("coalesce")
def _coalesce(e, args):
    """The first non-NULL argument, row by row."""
    long = is_long_dec(e.dtype)
    if not any(a.is_string for a in args) \
            and not isinstance(e.dtype, T.VarcharType):
        # align to the result type (a DATE branch under a TIMESTAMP
        # result must not mix days with micros)
        args = [cast_val(a, e.dtype) for a in args]
    out = args[-1]
    for v in args[:-1][::-1]:
        if v.valid is not None:
            take = v.valid
        else:
            rows = () if (long and v.data.ndim == 1) else v.data.shape[:1]
            take = torch.ones(rows, dtype=torch.bool, device=v.data.device)
        if v.is_string or out.is_string:
            v, out = _merge_dicts(v, out)
        data = where_data(take, v.data, out.data, long=long)
        valid = None if out.valid is None else (take | out.valid)
        out = Val(e.dtype, data, valid, out.dictionary)
    return out


@scalar("row_index")
def _row_index(e, args):
    """A per-row identifier (planner-internal: it keys the residual
    EXISTS decorrelation when the outer relation has no unique key).
    One device, so the row position is unique."""
    (a,) = args
    return Val(e.dtype, torch.arange(a.data.shape[0], dtype=torch.int64,
                                     device=a.data.device))


@scalar("nullif")
def _nullif(e, args):
    a, b = args
    eqv = _compare(ir.Call(T.BOOLEAN, "eq", e.args), args,
                   lambda x, y: x == y, lambda x, y: x == y)
    both = eqv.data if eqv.valid is None else (eqv.data & eqv.valid)
    valid = (torch.ones_like(both) if a.valid is None else a.valid) & ~both
    return Val(e.dtype, a.data, valid, a.dictionary)


def _compare(e: ir.Call, args: list[Val], op, eq_only_op) -> Val:
    a, b = args
    valid = and_valid(a.valid, b.valid)
    if a.is_string or b.is_string:
        if e.fn in ("eq", "neq"):
            da, db = _align_strings(a, b)
            return _bool(eq_only_op(da, db), valid)
        # ordering: same dictionary -> codes are collation-ordered;
        # against a literal -> host-evaluate over the dictionary
        if a.dictionary is b.dictionary:
            return _bool(op(a.data, b.data), valid)
        if len(b.dictionary) == 1:
            s = str(b.dictionary[0])
            out = _dict_predicate(a, lambda d: op(d, np.asarray(s)))
            return _bool(out.data, valid)
        if len(a.dictionary) == 1:
            s = str(a.dictionary[0])
            out = _dict_predicate(b, lambda d: op(np.asarray(s), d))
            return _bool(out.data, valid)
        raise NotImplementedError(
            "ordering comparison between differently-encoded strings")
    da, db = a.data, b.data
    if isinstance(a.dtype, T.DecimalType) or isinstance(b.dtype, T.DecimalType):
        if isinstance(a.dtype, T.DoubleType) or isinstance(b.dtype, T.DoubleType):
            da = cast_val(a, T.DOUBLE).data
            db = cast_val(b, T.DOUBLE).data
        elif is_long_dec(a.dtype) or is_long_dec(b.dtype):
            from presto_tpu_torch.ops import int128 as I
            sc = max(a.dtype.scale if isinstance(a.dtype, T.DecimalType)
                     else 0,
                     b.dtype.scale if isinstance(b.dtype, T.DecimalType)
                     else 0)
            x, y = as128(a, sc), as128(b, sc)
            res = {"eq": lambda: I.eq(x, y), "neq": lambda: ~I.eq(x, y),
                   "lt": lambda: I.lt(x, y), "lte": lambda: I.le(x, y),
                   "gt": lambda: I.lt(y, x), "gte": lambda: I.le(y, x)}
            return _bool(res[e.fn](), valid)
        else:
            a2, b2, _ = _decimal_align(a, b)
            da, db = a2.data, b2.data
    elif isinstance(a.dtype, T.DoubleType) != isinstance(b.dtype, T.DoubleType):
        da = cast_val(a, T.DOUBLE).data
        db = cast_val(b, T.DOUBLE).data
    elif {type(a.dtype), type(b.dtype)} == {T.DateType, T.TimestampType}:
        da = cast_val(a, T.TIMESTAMP).data
        db = cast_val(b, T.TIMESTAMP).data
    return _bool(op(da, db), valid)


@scalar("eq")
def _eq(e, args):
    return _compare(e, args, lambda x, y: x == y, lambda x, y: x == y)


@scalar("neq")
def _neq(e, args):
    return _compare(e, args, lambda x, y: x != y, lambda x, y: x != y)


@scalar("lt")
def _lt(e, args):
    return _compare(e, args, lambda x, y: x < y, None)


@scalar("lte")
def _lte(e, args):
    return _compare(e, args, lambda x, y: x <= y, None)


@scalar("gt")
def _gt(e, args):
    return _compare(e, args, lambda x, y: x > y, None)


@scalar("gte")
def _gte(e, args):
    return _compare(e, args, lambda x, y: x >= y, None)


@scalar("and")
def _and(e, args):
    """Kleene AND: FALSE dominates NULL."""
    data, valid = None, None
    for v in args:
        d, vl = v.data, v.valid
        if data is None:
            data, valid = d, vl
            continue
        new_data = data & d
        if valid is None and vl is None:
            new_valid = None
        else:
            av = torch.ones_like(data) if valid is None else valid
            bv = torch.ones_like(d) if vl is None else vl
            known_false = (av & ~data) | (bv & ~d)
            new_valid = (av & bv) | known_false
        data, valid = new_data, new_valid
    return _bool(data, valid)


@scalar("or")
def _or(e, args):
    """Kleene OR: TRUE dominates NULL."""
    data, valid = None, None
    for v in args:
        d, vl = v.data, v.valid
        if data is None:
            data, valid = d, vl
            continue
        new_data = data | d
        if valid is None and vl is None:
            new_valid = None
        else:
            av = torch.ones_like(data) if valid is None else valid
            bv = torch.ones_like(d) if vl is None else vl
            known_true = (av & data) | (bv & d)
            new_valid = (av & bv) | known_true
        data, valid = new_data, new_valid
    return _bool(data, valid)


@scalar("not")
def _not(e, args):
    (a,) = args
    return _bool(~a.data, a.valid)


@scalar("like")
def _like(e, args):
    col, pat = args[0], args[1]
    escape = str(args[2].dictionary[0]) if len(args) > 2 else None
    rx = _like_regex(str(pat.dictionary[0]), escape)
    return _dict_predicate(
        col, lambda d: np.array([rx.fullmatch(s) is not None for s in d],
                                dtype=bool))


@scalar("between")
def _between(e, args):
    v, lo, hi = args
    ge = _compare(ir.Call(T.BOOLEAN, "gte", ()), [v, lo],
                  lambda x, y: x >= y, None)
    le = _compare(ir.Call(T.BOOLEAN, "lte", ()), [v, hi],
                  lambda x, y: x <= y, None)
    return _and(e, [ge, le])


# -- date/time ---------------------------------------------------------------


def _civil_from_days(days):
    """Hinnant's civil_from_days: epoch days -> (y, m, d). ``//`` on
    integer tensors floors, as the reference's does."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_of(v: Val):
    """Epoch days of a DATE or TIMESTAMP Val (floor for pre-epoch)."""
    if isinstance(v.dtype, T.TimestampType):
        return torch.div(v.data, T.US_PER_DAY, rounding_mode="floor")
    return v.data


@scalar("year")
def _year(e, args):
    (a,) = args
    y, _, _ = _civil_from_days(_days_of(a))
    return Val(e.dtype, y, a.valid)


# -- strings -----------------------------------------------------------------


@scalar("substring")
def _substring(e, args):
    """A host transform over the dictionary (start and length must be
    literals, read from the IR); rows remap by code."""
    if not all(isinstance(a, ir.Literal) for a in e.args[1:]):
        raise NotImplementedError("substring with non-literal start/length")
    s0 = int(e.args[1].value)  # SQL 1-based
    ln = int(e.args[2].value) if len(e.args) > 2 else None

    def f(d):
        if ln is None:
            return np.array([s[s0 - 1:] for s in d], object)
        return np.array([s[s0 - 1:s0 - 1 + ln] for s in d], object)

    return _dict_transform(args[0], f)


@scalar("lower")
def _lower(e, args):
    return _dict_transform(args[0], lambda d: np.char.lower(d).astype(object))


@scalar("upper")
def _upper(e, args):
    return _dict_transform(args[0], lambda d: np.char.upper(d).astype(object))


# the largest dictionary product a concat of two string columns builds
_CONCAT_PRODUCT_MAX = 1 << 16


@scalar("concat")
def _concat(e, args):
    """A literal side is a dictionary transform of the other side; two
    columns take the sorted dictionary of every pair's concatenation,
    gathered at ca * |db| + cb."""
    a, b = args
    valid = and_valid(a.valid, b.valid)
    if len(a.dictionary) == 1:
        s = str(a.dictionary[0])
        out = _dict_transform(
            b, lambda d: np.array([s + x for x in d], object))
        return Val(e.dtype, out.data, valid, out.dictionary)
    if len(b.dictionary) == 1:
        s = str(b.dictionary[0])
        out = _dict_transform(
            a, lambda d: np.array([x + s for x in d], object))
        return Val(e.dtype, out.data, valid, out.dictionary)
    na, nb = len(a.dictionary), len(b.dictionary)
    if na * nb > _CONCAT_PRODUCT_MAX:
        raise NotImplementedError(
            f"concat of string columns with {na}x{nb} dictionary product "
            f"(> {_CONCAT_PRODUCT_MAX})")
    product = np.array([str(x) + str(y) for x in a.dictionary
                        for y in b.dictionary], dtype="U")
    d, inverse = np.unique(product, return_inverse=True)
    pair = (torch.clamp(a.data.to(torch.int64), 0, na - 1) * nb
            + torch.clamp(b.data.to(torch.int64), 0, nb - 1))
    remap = _lut(inverse.astype(np.int32), a.data)
    return Val(e.dtype, _by_code(remap, pair), valid, d.astype(object))
