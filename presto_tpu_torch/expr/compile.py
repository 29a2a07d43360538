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

The port covers column references, literals, IS [NOT] NULL, IN lists,
CASE, casts among numeric, decimal and date types and from varchar to
every scalar type, and every scalar function of the reference:
arithmetic, comparisons and logic; math
(sign, the DOUBLE-valued families, log, is_nan/is_finite/is_infinite,
width_bucket) and bitwise functions; strings (length, trim, pads,
replace, strpos, starts_with, split_part, reverse, codepoint, chr,
translate, the edit distances, regexp_like/replace/extract, contains)
and their JSON, URL and binary encodings; dates and times (the
extracts, date_trunc, date_add, date_diff, add_months, from/to
unixtime, date_format); ARRAY and MAP values, lambdas and the array
functions (below). String functions run once per dictionary entry on
the host and gather by code on the device; date functions are integer
arithmetic on the device (``//`` and ``%`` floor, as the reference's
do). Every other expression form and function raises
``NotImplementedError`` naming itself.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import threading
from typing import Callable

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.expr import dictmemo as DM
from presto_tpu_torch.expr import ir


@dataclasses.dataclass
class Val:
    """One columnar value.

    Scalar columns: data [n]. ARRAY columns are fixed-capacity padded
    2-D values, the reference's layout: data [n, cap] element values
    (codes in ``dictionary`` for string elements), ``lengths`` [n]
    int32 element counts, ``elem_valid`` [n, cap] per-element non-NULL
    mask (None = no NULL element); positions past the length are dead
    padding. A MAP value also carries its key array in ``map_keys``.
    An ARRAY built from literals alone has one row and broadcasts."""

    dtype: T.DataType
    data: object
    valid: object | None = None
    dictionary: np.ndarray | None = None
    lengths: object | None = None
    elem_valid: object | None = None
    map_keys: "Val | None" = None

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.VarcharType)

    @property
    def is_array(self) -> bool:
        return isinstance(self.dtype, T.ArrayType)

    def elem_mask(self):
        """[n, cap] mask of live (present, non-NULL) elements."""
        cap = self.data.shape[1]
        m = (torch.arange(cap, device=self.data.device)[None, :]
             < self.lengths[:, None])
        if self.elem_valid is not None:
            m = m & self.elem_valid
        return m


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
    included (indexing with a 0-d tensor would read it on the host); a
    table of rows ([k, 2] limbs) gathers whole rows."""
    codes = codes.to(torch.int64)
    if lut.ndim == 1:
        return torch.take(lut, codes)
    rows = torch.index_select(lut, 0, codes.reshape(-1))
    return rows.reshape(tuple(codes.shape) + tuple(lut.shape[1:]))


# --- dictionary helpers (host side) ----------------------------------------


def _dict_transform(v: Val, fn: Callable[[np.ndarray], np.ndarray],
                    key=None) -> Val:
    """Apply a host string->string function over the dictionary and
    remap codes to the new sorted dictionary. ``key`` (the function's
    name and its literal parameters) memoizes the host part
    (``dictmemo.transform``)."""
    new_dict, inverse = DM.transform(v.dictionary, fn, key)
    remap = _lut(inverse, v.data)
    return Val(T.VARCHAR, _by_code(remap, v.data), v.valid, new_dict)


def _merge_dicts(a: Val, b: Val) -> tuple[Val, Val]:
    """Bring two string Vals onto one shared sorted dictionary."""
    if a.dictionary is b.dictionary:
        return a, b
    u, (ra, rb) = DM.union((a.dictionary, b.dictionary), kind="merge")
    return (Val(a.dtype, _by_code(_lut(ra, a.data), a.data), a.valid, u),
            Val(b.dtype, _by_code(_lut(rb, b.data), b.data), b.valid, u))


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
    mapping = DM.align(a.dictionary, b.dictionary)
    return _by_code(_lut(mapping, a.data), a.data), b.data


# the compilers of the _c_call frames in flight, innermost last: a lambda
# body binds the innermost one's columns and device. Per thread, so
# that compilations on two threads never bind each other's columns.
_COMPILER_TLS = threading.local()


def _compilers() -> list:
    stack = getattr(_COMPILER_TLS, "stack", None)
    if stack is None:
        stack = _COMPILER_TLS.stack = []
    return stack


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

    def _c_parameter(self, e: ir.Parameter) -> Val:
        # a literal hoisted into a plan template (templates/): it
        # compiles exactly as the literal it replaced, its value read on
        # the host from the active binding, so a templated run makes
        # the same uploads and syncs as an untemplated one
        from presto_tpu_torch.templates import runtime as TR
        value = TR.current_value(e.index)
        if isinstance(value, torch.Tensor):
            # a batch binding (exec/batch.py): the lane's physical
            # value, already on the device, mapped by the batch axis
            return Val(e.dtype, value, None,
                       TR.current_dictionary(e.index)
                       if isinstance(e.dtype, T.VarcharType) else None)
        return self._c_literal(ir.Literal(e.dtype, value))

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
        args = [self.compile(a) for a in e.args]
        # higher-order functions compile their lambda bodies against
        # this call's columns (outer captures) on its device
        stack = _compilers()
        stack.append(self)
        try:
            return fn(e, args)
        finally:
            stack.pop()

    def _c_lambda(self, e: ir.Lambda) -> Val:
        # a lambda is not a value: the higher-order functions read it
        # from the call's arguments and bind its parameters themselves
        return Val(e.dtype, None)


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
    if v.is_string and v.dictionary is not None and isinstance(
            to, (T.BigintType, T.IntegerType, T.DoubleType, T.DecimalType)):
        return _parse_numeric_dictionary(v, to)
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


def _lut_gather(values: np.ndarray, v: Val) -> torch.Tensor:
    """Each row's entry of a per-dictionary-entry host table, gathered
    on the device by code (codes clamped; an empty dictionary gathers
    a zero)."""
    if not len(values):
        values = np.zeros((1,) + values.shape[1:], values.dtype)
    codes = torch.clamp(v.data.to(torch.int64), 0, len(values) - 1)
    return _by_code(_lut(values, v.data), codes)


def _gather_lut(values: np.ndarray, ok: np.ndarray, v: Val, to) -> Val:
    """Rows of a per-dictionary-entry parse: each row gathers its
    entry's value and parse flag by code; a failed parse (and every row
    of an empty dictionary) is NULL."""
    return Val(to, _lut_gather(values, v),
               and_valid(v.valid, _lut_gather(ok, v)))


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

    return _dict_transform(args[0], f, key=("substring", s0, ln))


@scalar("lower")
def _lower(e, args):
    return _dict_transform(args[0], lambda d: np.char.lower(d).astype(object),
                           key=("lower",))


@scalar("upper")
def _upper(e, args):
    return _dict_transform(args[0], lambda d: np.char.upper(d).astype(object),
                           key=("upper",))


# the largest dictionary product a concat of two string columns builds
_CONCAT_PRODUCT_MAX = 1 << 16


@scalar("concat")
def _concat(e, args):
    """A literal side is a dictionary transform of the other side; two
    columns take the sorted dictionary of every pair's concatenation,
    gathered at ca * |db| + cb."""
    a, b = args
    if a.is_array and b.is_array:  # ``||`` of two arrays
        return _array_concat_fn(e, args)
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


# -- per-entry helpers --------------------------------------------------------


def _dict_values(v: Val, fn, dtype=np.int64) -> np.ndarray:
    """``fn`` of each dictionary entry, as a host array."""
    return np.array([fn(str(s)) for s in v.dictionary], dtype)


def _literal_args(e: ir.Call, what: str) -> None:
    if not all(isinstance(a, ir.Literal) for a in e.args[1:]):
        raise NotImplementedError(f"{what} with non-literal arguments")


def _per_entry(fn):
    """A dictionary transform body applying ``fn`` to each entry."""
    return lambda d: np.array([fn(str(s)) for s in d], object)


# -- numbers -----------------------------------------------------------------


@scalar("sign")
def _sign(e, args):
    """-1, 0 or 1. A LONG decimal reads its sign from the high limb and
    zero from both limbs (the reference applies ``jnp.sign`` to each
    limb of the pair, ROADMAP R7)."""
    (a,) = args
    if is_long_dec(a.dtype):
        lo, hi = a.data[..., 0], a.data[..., 1]
        s = torch.where(hi < 0, -1, ((hi != 0) | (lo != 0)).to(torch.int64))
        return Val(e.dtype, s, a.valid)
    return Val(e.dtype, torch.sign(a.data), a.valid)


def _as_f64(v: Val):
    return cast_val(v, T.DOUBLE).data


def _cbrt(x):
    """Real cube root: the power of |x|, one Newton step, the sign."""
    y = torch.pow(torch.abs(x), 1.0 / 3.0)
    y = torch.where(y > 0, y - (y * y * y - torch.abs(x)) / (3 * y * y), y)
    return torch.copysign(y, x)


def _mathfn(name, op, arity=1):
    """A DOUBLE-valued math function (reference MathFunctions.java)."""
    @scalar(name)
    def _f(e, args, _op=op, _n=arity):
        if _n == 1:
            (a,) = args
            return Val(e.dtype, _op(_as_f64(a)), a.valid)
        a, b = args
        return Val(e.dtype, _op(_as_f64(a), _as_f64(b)),
                   and_valid(a.valid, b.valid))
    return _f


for _name, _op in (("sqrt", torch.sqrt), ("cbrt", _cbrt), ("exp", torch.exp),
                   ("ln", torch.log), ("log10", torch.log10),
                   ("log2", torch.log2), ("floor", torch.floor),
                   ("ceiling", torch.ceil), ("ceil", torch.ceil),
                   ("truncate", torch.trunc), ("sin", torch.sin),
                   ("cos", torch.cos), ("tan", torch.tan),
                   ("asin", torch.asin), ("acos", torch.acos),
                   ("atan", torch.atan), ("sinh", torch.sinh),
                   ("cosh", torch.cosh), ("tanh", torch.tanh),
                   ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
                   ("exp2", torch.exp2)):
    _mathfn(_name, _op)
for _name, _op in (("power", torch.pow), ("pow", torch.pow),
                   ("atan2", torch.atan2)):
    _mathfn(_name, _op, arity=2)
del _name, _op


@scalar("log")
def _log_base(e, args):
    """log(base, x)."""
    b, x = args
    return Val(e.dtype, torch.log(_as_f64(x)) / torch.log(_as_f64(b)),
               and_valid(b.valid, x.valid))


@scalar("is_nan")
def _is_nan(e, args):
    (a,) = args
    return Val(e.dtype, torch.isnan(_as_f64(a)), a.valid)


@scalar("is_finite")
def _is_finite(e, args):
    (a,) = args
    return Val(e.dtype, torch.isfinite(_as_f64(a)), a.valid)


@scalar("is_infinite")
def _is_infinite(e, args):
    (a,) = args
    return Val(e.dtype, torch.isinf(_as_f64(a)), a.valid)


def _srl_by(a, b):
    """Logical right shift of int64 bit patterns by a tensor of
    amounts in [0, 64)."""
    keep = (torch.ones_like(a) << (64 - b)) - 1
    return torch.where(b == 0, a, (a >> b) & keep)


def _bitfn(name, op, arity=2):
    @scalar(name)
    def _f(e, args, _op=op, _n=arity):
        if _n == 1:
            (a,) = args
            return Val(e.dtype, _op(a.data.to(torch.int64)), a.valid)
        a, b = args
        x, y = torch.broadcast_tensors(a.data.to(torch.int64),
                                       b.data.to(torch.int64))
        return Val(e.dtype, _op(x, y), and_valid(a.valid, b.valid))
    return _f


_bitfn("bitwise_and", torch.bitwise_and)
_bitfn("bitwise_or", torch.bitwise_or)
_bitfn("bitwise_xor", torch.bitwise_xor)
_bitfn("bitwise_not", torch.bitwise_not, arity=1)
_bitfn("bitwise_left_shift", torch.bitwise_left_shift)
_bitfn("bitwise_right_shift", _srl_by)


def _popcount(x):
    """Set bits of int64 bit patterns (SWAR; the multiply wraps)."""
    from presto_tpu_torch.ops.hash import srl
    x = x - (srl(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (srl(x, 2) & 0x3333333333333333)
    x = (x + srl(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return srl(x * 0x0101010101010101, 56)


@scalar("bit_count")
def _bit_count(e, args):
    """Set bits of the value as a ``bits``-wide two's complement
    integer (64 by default)."""
    a = args[0]
    bits = int(e.args[1].value) if len(e.args) > 1 else 64
    v = a.data.to(torch.int64)
    if bits < 64:
        v = v & ((1 << bits) - 1)
    return Val(e.dtype, _popcount(v), a.valid)


@scalar("width_bucket")
def _width_bucket(e, args):
    """The bucket of x among n equal buckets over [lo, hi): 0 below,
    n + 1 at or above hi."""
    x, lo, hi, nb = (cast_val(a, T.DOUBLE) for a in args)
    n = nb.data.to(torch.int64)
    span = hi.data - lo.data
    frac = (x.data - lo.data) / torch.where(span == 0, 1.0, span)
    b = torch.floor(frac * n).to(torch.int64) + 1
    b = torch.where(x.data < lo.data, 0, b)
    b = torch.where(x.data >= hi.data, n + 1, b)
    return Val(e.dtype, b, and_valid(*[a.valid for a in args]))


def _parse_numeric_dictionary(v: Val, to: T.DataType) -> Val:
    """varchar -> bigint, integer, double or decimal: one parse per
    dictionary entry into a host table that rows gather by code;
    malformed strings become NULL (an integral-valued decimal string
    such as '5.0' casts to an integer)."""
    from decimal import Decimal, InvalidOperation
    k = len(v.dictionary)
    ok = np.zeros(k, bool)
    if isinstance(to, T.DoubleType):
        vals = np.zeros(k, np.float64)
    elif isinstance(to, T.DecimalType):
        vals = np.zeros((k, 2) if to.is_long else k, np.int64)
    else:
        vals = np.zeros(k, to.physical_dtype)
    for i, s in enumerate(v.dictionary):
        t = str(s).strip()
        try:
            if isinstance(to, T.DoubleType):
                vals[i] = float(t)
            elif isinstance(to, T.DecimalType):
                raw = int(Decimal(t).scaleb(to.scale).to_integral_value())
                vals[i] = _lit128_np(raw) if to.is_long else raw
            else:
                try:
                    vals[i] = int(t)
                except ValueError:
                    f = float(t)
                    if f != int(f):
                        continue
                    vals[i] = int(f)
            ok[i] = True
        except (InvalidOperation, ValueError, OverflowError):
            continue
    return _gather_lut(vals, ok, v, to)


# -- strings -----------------------------------------------------------------


def _text(v: Val) -> np.ndarray:
    """The dictionary as a numpy unicode array (np.char's operand)."""
    return v.dictionary.astype("U")


@scalar("length")
def _length(e, args):
    (col,) = args
    return Val(e.dtype, _lut_gather(np.char.str_len(_text(col))
                                    .astype(np.int64), col), col.valid)


@scalar("trim")
def _trim(e, args):
    return _dict_transform(args[0], np.char.strip, key=("trim",))


@scalar("ltrim")
def _ltrim(e, args):
    return _dict_transform(args[0], np.char.lstrip, key=("ltrim",))


@scalar("rtrim")
def _rtrim(e, args):
    return _dict_transform(args[0], np.char.rstrip, key=("rtrim",))


@scalar("reverse")
def _reverse(e, args):
    return _dict_transform(args[0], _per_entry(lambda s: s[::-1]),
                           key=("reverse",))


@scalar("replace")
def _replace(e, args):
    _literal_args(e, "replace")
    pat = str(e.args[1].value)
    rep = str(e.args[2].value) if len(e.args) > 2 else ""
    # np.char.replace raises on an empty array (numpy 2.0)
    return _dict_transform(
        args[0], lambda d: np.char.replace(d, pat, rep) if len(d) else d,
        key=("replace", pat, rep))


@scalar("starts_with")
def _starts_with(e, args):
    _literal_args(e, "starts_with")
    prefix = str(e.args[1].value)
    return _dict_predicate(args[0], lambda d: np.char.startswith(d, prefix))


@scalar("strpos")
def _strpos(e, args):
    """1-based position of the first occurrence, 0 if absent."""
    _literal_args(e, "strpos")
    needle = str(e.args[1].value)
    col = args[0]
    pos = np.char.find(_text(col), needle).astype(np.int64) + 1
    return Val(e.dtype, _lut_gather(pos, col), col.valid)


@scalar("lpad")
def _lpad(e, args):
    _literal_args(e, "lpad")
    n = int(e.args[1].value)
    fill = str(args[2].dictionary[0]) if len(args) > 2 else " "
    return _dict_transform(args[0], _per_entry(lambda s: s.rjust(n, fill)[:n]),
                           key=("lpad", n, fill))


@scalar("rpad")
def _rpad(e, args):
    _literal_args(e, "rpad")
    n = int(e.args[1].value)
    fill = str(args[2].dictionary[0]) if len(args) > 2 else " "
    return _dict_transform(args[0], _per_entry(lambda s: s.ljust(n, fill)[:n]),
                           key=("rpad", n, fill))


@scalar("split_part")
def _split_part(e, args):
    """The 1-based ``index``-th field split by ``sep`` ('' past the
    last)."""
    _literal_args(e, "split_part")
    sep = str(args[1].dictionary[0])
    idx = int(e.args[2].value)

    def part(s):
        parts = s.split(sep)
        return parts[idx - 1] if 0 < idx <= len(parts) else ""
    return _dict_transform(args[0], _per_entry(part))


@scalar("regexp_like")
def _regexp_like(e, args):
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError("regexp_like with non-literal pattern")
    rx = re.compile(str(args[1].dictionary[0]))
    return _dict_predicate(args[0], lambda d: np.array(
        [rx.search(s) is not None for s in d], dtype=bool))


@scalar("regexp_replace")
def _regexp_replace(e, args):
    _literal_args(e, "regexp_replace")
    rx = re.compile(str(args[1].dictionary[0]))
    repl = str(args[2].dictionary[0]) if len(args) > 2 else ""
    # SQL replacement groups are $1; python's are \1
    repl_py = re.sub(r"\$(\d+)", r"\\\1", repl)
    return _dict_transform(args[0], _per_entry(lambda s: rx.sub(repl_py, s)))


@scalar("regexp_extract")
def _regexp_extract(e, args):
    """The match (or its ``group``); NULL where the pattern does not
    match."""
    _literal_args(e, "regexp_extract")
    rx = re.compile(str(args[1].dictionary[0]))
    group = int(e.args[2].value) if len(e.args) > 2 else 0
    col = args[0]
    found = [rx.search(str(s)) for s in col.dictionary]
    matched = np.array([m is not None for m in found], dtype=bool)
    v = _dict_transform(col, lambda d: np.array(
        ["" if m is None else (m.group(group) or "") for m in found],
        object))
    return Val(v.dtype, v.data, and_valid(v.valid, _lut_gather(matched, col)),
               v.dictionary)


@scalar("contains")
def _contains(e, args):
    """The string form: whether the needle occurs (the ARRAY form is
    ``_array_contains``)."""
    if args[0].is_array:
        return _array_contains(e, args)
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError("contains with non-literal needle")
    needle = str(args[1].dictionary[0])
    return _dict_predicate(args[0], lambda d: np.array(
        [needle in s for s in d], dtype=bool))


@scalar("codepoint")
def _codepoint(e, args):
    (col,) = args
    return Val(e.dtype, _lut_gather(_dict_values(
        col, lambda s: ord(s[0]) if s else 0), col), col.valid)


@scalar("chr")
def _chr(e, args):
    (a,) = args
    if not isinstance(e.args[0], ir.Literal):
        raise NotImplementedError("chr() requires a literal")
    return Val(T.VARCHAR, HS.upload(np.asarray(0, np.int32), a.data.device,
                                    "literal"), a.valid,
               np.array([chr(int(e.args[0].value))], object))


@scalar("translate")
def _translate(e, args):
    _literal_args(e, "translate")
    src, dst = str(e.args[1].value), str(e.args[2].value)
    table = {ord(c): (dst[i] if i < len(dst) else None)
             for i, c in enumerate(src)}
    return _dict_transform(args[0], _per_entry(lambda s: s.translate(table)),
                           key=("translate", src, dst))


def _levenshtein_to(want: str):
    def dist(s: str) -> int:
        prev = list(range(len(want) + 1))
        for i, ca in enumerate(s, 1):
            cur = [i]
            for j, cb in enumerate(want, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]
    return dist


@scalar("levenshtein_distance")
def _levenshtein(e, args):
    a, b = args
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError(
            "levenshtein_distance needs a literal second argument")
    lut = _dict_values(a, _levenshtein_to(str(e.args[1].value)))
    return Val(e.dtype, _lut_gather(lut, a), and_valid(a.valid, b.valid))


@scalar("hamming_distance")
def _hamming(e, args):
    """Differing positions; NULL where the lengths differ."""
    a, b = args
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError(
            "hamming_distance needs a literal second argument")
    want = str(e.args[1].value)
    lut = _dict_values(a, lambda s: sum(x != y for x, y in zip(s, want))
                       if len(s) == len(want) else -1)
    return Val(e.dtype, _lut_gather(lut, a),
               and_valid(a.valid, b.valid, _lut_gather(lut >= 0, a)))


# -- URLs and binary encodings (dictionary transforms) ------------------------


def _url_parts(s: str):
    from urllib.parse import urlparse
    try:
        return urlparse(s)
    except ValueError:
        return urlparse("")


def _query_params(s: str) -> dict:
    from urllib.parse import parse_qs
    return parse_qs(_url_parts(s).query, keep_blank_values=True)


def _urlfn(name, extract):
    @scalar(name)
    def _f(e, args, _x=extract):
        return _dict_transform(args[0], _per_entry(_x))
    return _f


def _b64(s: str) -> str:
    import base64
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    import base64
    return base64.b64decode(s.encode()).decode("utf-8", "replace")


def _quote(s: str) -> str:
    from urllib.parse import quote_plus
    return quote_plus(s)


def _unquote(s: str) -> str:
    from urllib.parse import unquote_plus
    return unquote_plus(s)


def _digest(algo: str):
    import hashlib
    return lambda s: hashlib.new(algo, s.encode()).hexdigest()


_urlfn("url_extract_protocol", lambda s: _url_parts(s).scheme)
_urlfn("url_extract_host", lambda s: _url_parts(s).hostname or "")
_urlfn("url_extract_path", lambda s: _url_parts(s).path)
_urlfn("url_extract_query", lambda s: _url_parts(s).query)
_urlfn("url_extract_fragment", lambda s: _url_parts(s).fragment)
_urlfn("url_encode", _quote)
_urlfn("url_decode", _unquote)
_urlfn("to_hex", lambda s: s.encode().hex().upper())
_urlfn("from_hex", lambda s: bytes.fromhex(s).decode("utf-8", "replace"))
_urlfn("md5", _digest("md5"))
_urlfn("sha256", _digest("sha256"))
_urlfn("to_base64", _b64)
_urlfn("from_base64", _unb64)


@scalar("url_extract_port")
def _url_port(e, args):
    """The URL's port; NULL where it names none."""
    (col,) = args
    ports = _dict_values(col, lambda s: _url_parts(s).port or -1)
    return Val(e.dtype, _lut_gather(np.clip(ports, 0, None), col),
               and_valid(col.valid, _lut_gather(ports >= 0, col)))


@scalar("url_extract_parameter")
def _url_param(e, args):
    """The first value of a query parameter; NULL where it is absent."""
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError(
            "url_extract_parameter needs a literal name")
    name = str(e.args[1].value)
    col = args[0]
    out = _dict_transform(col, _per_entry(
        lambda s: (_query_params(s).get(name) or [""])[0]))
    has = _dict_values(col, lambda s: name in _query_params(s), bool)
    return Val(T.VARCHAR, out.data,
               and_valid(col.valid, _lut_gather(has, col)), out.dictionary)


# -- JSON (each distinct document parses once, on the host) -------------------


def _json_path_steps(path: str) -> list:
    """A JSONPath subset: $, .key, [index], ["key"] (strict or lax)."""
    if path.startswith("lax ") or path.startswith("strict "):
        path = path.split(" ", 1)[1]
    if not path.startswith("$"):
        raise NotImplementedError(f"unsupported JSON path {path!r}")
    steps: list = []
    i = 1
    while i < len(path):
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            steps.append(path[i + 1:j])
            i = j
        elif path[i] == "[":
            j = path.index("]", i)
            body = path[i + 1:j].strip()
            steps.append(body[1:-1] if body[:1] in ("'", '"')
                         else int(body))
            i = j + 1
        else:
            raise NotImplementedError(f"unsupported JSON path {path!r}")
    return steps


def _json_eval(doc: str, steps: list):
    """(value, found) of ``steps`` in the document."""
    import json
    try:
        v = json.loads(doc)
    except (ValueError, TypeError):
        return None, False
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or not -len(v) <= s < len(v):
                return None, False
        elif not isinstance(v, dict) or s not in v:
            return None, False
        v = v[s]
    return v, True


def _json_lut(col: Val, e, per_doc) -> Val:
    """Rows gather each document's (value, found) by code; a document
    that yields found=False reads as NULL."""
    results = [per_doc(str(doc)) for doc in col.dictionary]
    found = np.array([ok for _, ok in results], dtype=bool)
    valid = and_valid(col.valid, _lut_gather(found, col))
    if isinstance(e.dtype, T.VarcharType):
        uniq = sorted({v for v, ok in results if ok}) or [""]
        pos = {v: i for i, v in enumerate(uniq)}
        remap = np.array([pos[v] if ok else 0 for v, ok in results],
                         np.int32)
        return Val(T.VARCHAR, _lut_gather(remap, col), valid,
                   np.asarray(uniq, dtype=object))
    vals = np.array([v if ok else 0 for v, ok in results], np.int64)
    return Val(e.dtype, _lut_gather(vals, col), valid)


def _literal_path(e) -> list:
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError("JSON path must be a literal")
    return _json_path_steps(str(e.args[1].value))


@scalar("json_extract_scalar")
def _json_extract_scalar(e, args):
    steps = _literal_path(e)

    def per_doc(doc):
        v, ok = _json_eval(doc, steps)
        if not ok or isinstance(v, (dict, list)) or v is None:
            return None, False
        if isinstance(v, bool):
            return ("true" if v else "false"), True
        if isinstance(v, float) and v.is_integer():
            return str(int(v)), True
        return str(v), True
    return _json_lut(args[0], e, per_doc)


@scalar("json_extract")
def _json_extract(e, args):
    import json
    steps = _literal_path(e)

    def per_doc(doc):
        v, ok = _json_eval(doc, steps)
        if not ok:
            return None, False
        return json.dumps(v, separators=(",", ":"), sort_keys=True), True
    return _json_lut(args[0], e, per_doc)


@scalar("json_array_length")
def _json_array_length(e, args):
    import json

    def per_doc(doc):
        try:
            v = json.loads(doc)
        except (ValueError, TypeError):
            return None, False
        return (len(v), True) if isinstance(v, list) else (None, False)
    return _json_lut(args[0], e, per_doc)


@scalar("json_size")
def _json_size(e, args):
    steps = _literal_path(e)

    def per_doc(doc):
        v, ok = _json_eval(doc, steps)
        if not ok:
            return None, False
        return (len(v) if isinstance(v, (dict, list)) else 0), True
    return _json_lut(args[0], e, per_doc)


@scalar("json_parse")
@scalar("json_format")
def _json_identity(e, args):
    """JSON values are dictionary-encoded strings end to end."""
    a = args[0]
    return Val(T.VARCHAR, a.data, a.valid, a.dictionary)


# -- dates and times ---------------------------------------------------------


def _us_of(v: Val):
    """Epoch micros of a DATE or TIMESTAMP Val."""
    if isinstance(v.dtype, T.DateType):
        return v.data.to(torch.int64) * T.US_PER_DAY
    return v.data


def _tod_us(v: Val):
    """Micros since midnight of a TIME, DATE or TIMESTAMP Val."""
    if isinstance(v.dtype, T.TimeType):
        return v.data
    return _us_of(v) - _days_of(v).to(torch.int64) * T.US_PER_DAY


def _days_from_civil(y, m, d):
    """Hinnant's days_from_civil, the inverse of _civil_from_days
    (``//`` floors)."""
    y = y - (m <= 2).to(y.dtype)
    era = y // 400
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _month_days(y, m):
    """Days in month ``m`` of year ``y`` (30 + the parity of m, m + 1
    from August on; February 28 or 29)."""
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    long = (m + (m >= 8).to(m.dtype)) & 1
    return torch.where(m == 2, 28 + leap.to(m.dtype), 30 + long)


def _add_months_days(days, months):
    """Epoch days plus whole months, the day of month clamped to the
    target month's length."""
    y, m, d = _civil_from_days(days)
    total = (y * 12 + (m - 1)) + months
    ny = total // 12
    nm = total - ny * 12 + 1
    return _days_from_civil(ny, nm, torch.minimum(d, _month_days(ny, nm)))


def _extract(name, fn):
    @scalar(name)
    def _f(e, args, _fn=fn):
        (a,) = args
        return Val(e.dtype, _fn(a), a.valid)
    return _f


_extract("month", lambda a: _civil_from_days(_days_of(a))[1])
_extract("day", lambda a: _civil_from_days(_days_of(a))[2])
_extract("quarter", lambda a: (_civil_from_days(_days_of(a))[1] - 1) // 3
         + 1)
# ISO: Monday 1 .. Sunday 7; epoch day 0 was a Thursday
_extract("day_of_week", lambda a: (_days_of(a).to(torch.int64) + 3) % 7 + 1)
_extract("hour", lambda a: _tod_us(a) // T.US_PER_HOUR)
_extract("minute", lambda a: (_tod_us(a) // T.US_PER_MINUTE) % 60)
_extract("second", lambda a: (_tod_us(a) // T.US_PER_SECOND) % 60)
_extract("millisecond", lambda a: (_tod_us(a) // 1000) % 1000)


def _jan1(days):
    y = _civil_from_days(days)[0]
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


@scalar("day_of_year")
def _day_of_year(e, args):
    (a,) = args
    days = _days_of(a).to(torch.int64)
    return Val(e.dtype, days - _jan1(days) + 1, a.valid)


@scalar("week")
def _week(e, args):
    """ISO week of the year: the year of the week's Thursday."""
    (a,) = args
    d = _days_of(a).to(torch.int64)
    thursday = d - ((d + 3) % 7) + 3
    return Val(e.dtype, (thursday - _jan1(thursday)) // 7 + 1, a.valid)


@scalar("add_months")
def _add_months(e, args):
    """date + N months [+ D days], the day of month clamped."""
    a, months = args[0], args[1]
    out = _add_months_days(a.data, months.data)
    if len(args) > 2:
        out = out + args[2].data
    return Val(e.dtype, out.to(torch.int32), a.valid)


@scalar("ts_add_months")
def _ts_add_months(e, args):
    a, months = args
    days = _days_of(a)
    tod = a.data - days * T.US_PER_DAY
    out = _add_months_days(days, months.data) * T.US_PER_DAY + tod
    return Val(e.dtype, out, and_valid(a.valid, months.valid))


def _trunc_days(unit: str, days):
    """Epoch days truncated to the start of a civil unit."""
    y, m, _d = _civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "year":
        return _days_from_civil(y, one, one)
    if unit == "quarter":
        return _days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    if unit == "month":
        return _days_from_civil(y, m, one)
    if unit == "week":  # ISO weeks start on Monday
        d = days.to(torch.int64)
        return d - ((d + 3) % 7)
    raise NotImplementedError(f"date_trunc unit {unit}")


_US_PER = {"second": T.US_PER_SECOND, "minute": T.US_PER_MINUTE,
           "hour": T.US_PER_HOUR, "day": T.US_PER_DAY}
_MONTHS_PER = {"year": 12, "quarter": 3, "month": 1}


def _unit(e: ir.Call) -> str:
    unit = str(e.args[0].value).lower()
    return unit[:-1] if unit.endswith("s") else unit


@scalar("date_trunc")
def _date_trunc(e, args):
    unit = str(e.args[0].value).lower()
    v = args[1]
    if isinstance(v.dtype, T.DateType):
        if unit == "day":
            return v
        return Val(e.dtype, _trunc_days(unit, v.data).to(torch.int32),
                   v.valid)
    per = _US_PER.get(unit)
    if per is not None:
        return Val(e.dtype, (v.data // per) * per, v.valid)
    return Val(e.dtype, _trunc_days(unit, _days_of(v)) * T.US_PER_DAY,
               v.valid)


@scalar("date_add")
def _date_add(e, args):
    unit = _unit(e)
    n, v = args[1], args[2]
    valid = and_valid(n.valid, v.valid)
    months = _MONTHS_PER.get(unit)
    if isinstance(v.dtype, T.DateType):
        if months is not None:
            out = _add_months_days(v.data, n.data * months)
            return Val(e.dtype, out.to(torch.int32), valid)
        per_day = {"day": 1, "week": 7}.get(unit)
        if per_day is None:
            raise NotImplementedError(f"date_add({unit}) on a date value")
        return Val(e.dtype, (v.data + n.data * per_day).to(torch.int32),
                   valid)
    if months is not None:
        days = _days_of(v)
        tod = v.data - days * T.US_PER_DAY
        out = _add_months_days(days, n.data * months) * T.US_PER_DAY + tod
        return Val(e.dtype, out, valid)
    per = {**_US_PER, "week": 7 * T.US_PER_DAY,
           "millisecond": 1000}.get(unit)
    if per is None:
        raise NotImplementedError(f"date_add unit {unit}")
    return Val(e.dtype, v.data + n.data * per, valid)


def _trunc_div(x, d: int):
    """Integer division truncating toward zero."""
    return torch.where(x >= 0, x // d, -((-x) // d))


@scalar("date_diff")
def _date_diff(e, args):
    unit = _unit(e)
    a, b = args[1], args[2]
    valid = and_valid(a.valid, b.valid)
    months = _MONTHS_PER.get(unit)
    if months is not None:
        # the calendar-month difference, floored to the unit
        ya, ma, _ = _civil_from_days(_days_of(a))
        yb, mb, _ = _civil_from_days(_days_of(b))
        diff = (yb * 12 + mb) - (ya * 12 + ma)
        return Val(e.dtype, diff // months, valid)
    if unit in ("day", "week") and isinstance(a.dtype, T.DateType) \
            and isinstance(b.dtype, T.DateType):
        d = (b.data.to(torch.int64) - a.data.to(torch.int64))
        return Val(e.dtype, _trunc_div(d, 7) if unit == "week" else d, valid)
    per = {**_US_PER, "week": 7 * T.US_PER_DAY,
           "millisecond": 1000}.get(unit)
    if per is None:
        raise NotImplementedError(f"date_diff unit {unit}")
    return Val(e.dtype, _trunc_div(_us_of(b) - _us_of(a), per), valid)


@scalar("from_unixtime")
def _from_unixtime(e, args):
    (a,) = args
    sec = a.data.to(torch.float64)
    if isinstance(a.dtype, T.DecimalType):
        sec = sec / a.dtype.unscale_factor
    return Val(e.dtype, torch.round(sec * T.US_PER_SECOND).to(torch.int64),
               a.valid)


@scalar("to_unixtime")
def _to_unixtime(e, args):
    (a,) = args
    return Val(e.dtype, _us_of(a).to(torch.float64) / T.US_PER_SECOND,
               a.valid)


# MySQL date_format specifiers of day granularity (a time-of-day
# specifier would need per-row strings, which no dictionary encodes)
_MYSQL_STRFTIME = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%-m", "%d": "%d",
    "%e": "%-d", "%j": "%j", "%M": "%B", "%b": "%b", "%W": "%A",
    "%a": "%a",
}
_DATE_FORMAT_LO = -40179  # 1860-01-01
_DATE_FORMAT_HI = 80468   # 2190-04-25
_DATE_FORMAT_CACHE: dict[str, tuple] = {}


def _date_format_table(fmt: str) -> tuple[np.ndarray, np.ndarray]:
    """(the sorted distinct strings, each day's code among them) over
    the supported day range, for one format."""
    import datetime
    hit = _DATE_FORMAT_CACHE.get(fmt)
    if hit is None:
        pyfmt = re.sub(
            "%.", lambda m: _MYSQL_STRFTIME.get(m.group(0), m.group(0)),
            fmt)
        base = datetime.date(1970, 1, 1).toordinal()
        per_day = np.array(
            [datetime.date.fromordinal(base + d).strftime(pyfmt)
             for d in range(_DATE_FORMAT_LO, _DATE_FORMAT_HI)], dtype="U")
        strings, codes = np.unique(per_day, return_inverse=True)
        hit = (strings.astype(object), codes.astype(np.int32))
        if len(_DATE_FORMAT_CACHE) > 16:
            _DATE_FORMAT_CACHE.clear()
        _DATE_FORMAT_CACHE[fmt] = hit
    return hit


@scalar("date_format")
def _date_format(e, args):
    """A per-day string table over 1860-2190, made unique (each string
    one code, so code equality is string equality: the reference keeps
    one entry per day, ROADMAP R8); a day outside the range is NULL."""
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError("date_format with non-literal format")
    fmt = str(e.args[1].value)
    if re.search(r"%[HhiSsfprT]", fmt):
        raise NotImplementedError("date_format with time-of-day specifiers")
    v = args[0]
    strings, day_codes = _date_format_table(fmt)
    day = _days_of(v).to(torch.int64) - _DATE_FORMAT_LO
    in_range = (day >= 0) & (day < len(day_codes))
    day = torch.clamp(day, 0, len(day_codes) - 1)
    return Val(T.VARCHAR, _by_code(_lut(day_codes, v.data), day),
               and_valid(v.valid, in_range), strings)


# --- arrays, maps and lambdas (the fixed-capacity 2-D layout; see Val) ------
# Every array function stays on the device: no host read, no boolean
# mask indexing; gathers along the capacity clamp their positions, and a
# sort along it is stable, so ties keep their positions (the reference's
# two-key ``lax.sort`` over (key, position)).


def _elem_string(t: T.DataType) -> bool:
    return isinstance(t, T.VarcharType)


def _rows_of(*tensors) -> int:
    """The row count the operands broadcast to (a literal array has
    one row)."""
    return max(x.shape[0] for x in tensors if x is not None and x.ndim)


def _at_rows(x, n: int):
    """``x`` ([m, ...] with m 1 or n) as n rows."""
    return x if x.shape[0] == n else x.expand((n,) + tuple(x.shape[1:]))


def _gather_pos(x, pos):
    """x[i, pos[i]] of a [m, cap] tensor for positions [n] (clamped;
    a one-row x broadcasts)."""
    x = _at_rows(x, pos.shape[0])
    pos = torch.clamp(pos.to(torch.int64), 0, x.shape[1] - 1)
    return torch.gather(x, 1, pos[:, None])[:, 0]


def _compact_elems(keep, *operands):
    """Each row's kept elements moved to its front, in position order:
    a stable sort of ``~keep`` along the capacity, every operand
    gathered by it."""
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True)[1]
    return [None if x is None else torch.gather(
        _at_rows(x, keep.shape[0]).expand(keep.shape), 1, order)
        for x in operands]


def _broadcast_cols_2d(columns: dict[str, Val]) -> dict:
    """Outer scalar columns as [n, 1] views, so that a lambda body
    broadcasts them against [n, cap] element values."""
    out = {}
    for sym, v in columns.items():
        if (v.is_array or v.data is None or v.data.ndim != 1
                or is_long_dec(v.dtype)):
            out[sym] = v
            continue
        out[sym] = Val(v.dtype, v.data[:, None],
                       None if v.valid is None else v.valid[:, None],
                       v.dictionary)
    return out


def _bind_lambda(lam: ir.Lambda, arrays: list[Val]) -> Val:
    """Compile a lambda body with each parameter bound to its array's
    [n, cap] element values (outer columns broadcast as [n, 1]); the
    body's [n, cap] Val."""
    outer = _compilers()[-1]
    cols = _broadcast_cols_2d(outer.columns)
    for p, arr in zip(lam.params, arrays):
        cols[p] = Val(arr.dtype.element, arr.data,
                      arr.elem_mask() if arr.elem_valid is not None
                      else None, arr.dictionary)
    return ExprCompiler(cols, outer.device).compile(lam.body)


@scalar("array_ctor")
def _array_ctor(e, args):
    """ARRAY[e1, ..., ek]: k scalar columns stacked into [n, k]."""
    dev = _compilers()[-1].device
    if not args:
        return Val(e.dtype, torch.zeros((1, 1), dtype=torch.int64,
                                        device=dev), None, None,
                   torch.zeros(1, dtype=torch.int32, device=dev), None)
    dictionary = None
    if _elem_string(e.dtype.element):
        base = args[0]
        unified = [base]
        for v in args[1:]:
            v, base = _merge_dicts(v, base)
            unified.append(v)
        # earlier arguments again, against the final dictionary
        args = [_merge_dicts(v, base)[0] for v in unified]
        dictionary = args[0].dictionary
    n = max([v.data.shape[0] for v in args if v.data.ndim == 1],
            default=1)
    datas, valids = [], []
    for v in args:
        datas.append(v.data.expand(n) if v.data.ndim == 0 else v.data)
        va = v.valid
        if va is None:
            va = torch.ones(n, dtype=torch.bool, device=dev)
        elif va.ndim == 0:
            va = va.expand(n)
        valids.append(va)
    lengths = torch.full((n,), len(args), dtype=torch.int32, device=dev)
    return Val(e.dtype, torch.stack(datas, dim=1), None, dictionary,
               lengths, torch.stack(valids, dim=1))


def _wanted(vd, want):
    """Element values [n, cap] against a scalar or per-row value."""
    return vd == (want[:, None] if want.ndim == 1 else want)


def _elem_codes(v: Val, x: Val):
    """(element values, probe value) comparable for equality: string
    elements translate into the probe's code space."""
    if _elem_string(v.dtype.element) and x.is_string:
        vd, _ = _align_strings(Val(T.VARCHAR, v.data, None, v.dictionary),
                               x)
        return vd, x.data
    return v.data, x.data


@scalar("element_at")
@scalar("subscript")
def _element_at(e, args):
    v, idx = args
    if isinstance(v.dtype, T.MapType):
        # map lookup: the first matching key's position
        keys = v.map_keys
        kd, want = _elem_codes(keys, idx)
        hit = _wanted(kd, want) & keys.elem_mask()
        pos = torch.argmax(hit.to(torch.uint8), dim=1)
        found = hit.any(dim=1)
        ev = (found if v.elem_valid is None
              else found & _gather_pos(v.elem_valid, pos))
        return Val(e.dtype, _gather_pos(v.data, pos), and_valid(v.valid, ev),
                   v.dictionary)
    # SQL arrays are 1-based; out of range is NULL
    i0 = idx.data.to(torch.int64) - 1
    n = _rows_of(v.data, i0)
    i0 = i0.expand(n) if i0.ndim == 0 else i0
    in_range = (i0 >= 0) & (i0 < v.lengths.to(torch.int64))
    if v.elem_valid is not None:
        in_range = in_range & _gather_pos(v.elem_valid, i0)
    return Val(e.dtype, _gather_pos(v.data, i0),
               and_valid(v.valid, and_valid(idx.valid, in_range)),
               v.dictionary)


@scalar("cardinality")
def _cardinality(e, args):
    (v,) = args
    return Val(e.dtype, v.lengths.to(torch.int64), v.valid)


def _array_contains(e, args):
    v, x = args
    vd, want = _elem_codes(v, x)
    hit = _wanted(vd, want) & v.elem_mask()
    return Val(e.dtype, hit.any(dim=1), and_valid(v.valid, x.valid))


@scalar("transform")
def _transform(e, args):
    v = args[0]
    body = _bind_lambda(e.args[1], [v])
    data = body.data
    if data.ndim != 2:
        data = data.expand(v.data.shape)
    # an outer-column capture widens a literal array's one row to the
    # table's rows: the companions follow the body's shape
    n = data.shape[0]
    valid = v.valid
    if valid is not None and valid.ndim and valid.shape[0] != n:
        valid = valid.expand(n)
    ev = body.valid
    if ev is not None and ev.shape != data.shape:
        ev = ev.expand(data.shape)
    return Val(e.dtype, data, valid, body.dictionary,
               _at_rows(v.lengths, n), ev)


@scalar("filter")
def _filter_array(e, args):
    v = args[0]
    body = _bind_lambda(e.args[1], [v])
    keep = body.data if body.valid is None else (body.data & body.valid)
    # PRESENT positions only: a NULL element the lambda accepts stays
    # (filter(array[1, null], x -> x is null) keeps the NULL)
    cap = v.data.shape[1]
    present = (torch.arange(cap, device=v.data.device)[None, :]
               < v.lengths[:, None])
    keep = (keep & present).expand(
        _rows_of(keep if keep.ndim == 2 else None, present), cap)
    data, ev = _compact_elems(keep, v.data, v.elem_valid)
    return Val(e.dtype, data, v.valid, v.dictionary,
               keep.sum(dim=1).to(torch.int32), ev)


@scalar("reduce")
def _reduce_array(e, args):
    v, init = args[0], args[1]
    lam = e.args[2]  # (acc, x) -> expr
    out_lam = e.args[3] if len(e.args) > 3 else None
    outer = _compilers()[-1]
    n, cap = v.data.shape
    acc_data = init.data.expand(n) if init.data.ndim == 0 else init.data
    acc = Val(init.dtype, acc_data, init.valid)
    mask = v.elem_mask()
    ones = torch.ones(n, dtype=torch.bool, device=v.data.device)
    for j in range(cap):
        cols = dict(outer.columns)
        cols[lam.params[0]] = acc
        cols[lam.params[1]] = Val(v.dtype.element, v.data[:, j], None,
                                  v.dictionary)
        stepped = ExprCompiler(cols, outer.device).compile(lam.body)
        take = mask[:, j]
        sd = stepped.data.expand(n) if stepped.data.ndim == 0 \
            else stepped.data
        new_valid = None
        if acc.valid is not None or stepped.valid is not None:
            new_valid = torch.where(
                take, ones if stepped.valid is None else stepped.valid,
                ones if acc.valid is None else acc.valid)
        acc = Val(init.dtype, torch.where(take, sd, acc.data), new_valid)
    if out_lam is not None:
        cols = dict(outer.columns)
        cols[out_lam.params[0]] = acc
        acc = ExprCompiler(cols, outer.device).compile(out_lam.body)
    return Val(e.dtype, acc.data, and_valid(v.valid, acc.valid))


def _match_reduce(e, args, op: str) -> Val:
    v = args[0]
    body = _bind_lambda(e.args[1], [v])
    hit = body.data if body.valid is None else (body.data & body.valid)
    m = v.elem_mask()
    if op == "any":
        out = (hit & m).any(dim=1)
    else:
        out = torch.where(m, hit, True).all(dim=1)
    return Val(e.dtype, out, v.valid)


@scalar("any_match")
def _any_match(e, args):
    return _match_reduce(e, args, "any")


@scalar("all_match")
def _all_match(e, args):
    return _match_reduce(e, args, "all")


@scalar("none_match")
def _none_match(e, args):
    r = _match_reduce(e, args, "any")
    return Val(e.dtype, ~r.data, r.valid)


@scalar("array_position")
def _array_position(e, args):
    v, x = args
    vd, want = _elem_codes(v, x)
    hit = _wanted(vd, want) & v.elem_mask()
    # argmax over uint8: the FIRST matching position (argmax of a bool
    # tensor is not supported everywhere)
    pos = torch.argmax(hit.to(torch.uint8), dim=1) + 1
    found = hit.any(dim=1)
    return Val(e.dtype, torch.where(found, pos, 0).to(torch.int64),
               and_valid(v.valid, x.valid))


def _extreme(dtype: torch.dtype, largest: bool):
    """The largest (or least) value of ``dtype``: dead padding for a
    min (max) or a sort."""
    if dtype == torch.bool:
        return largest
    if dtype.is_floating_point:
        return float("inf") if largest else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if largest else info.min


@scalar("array_max")
@scalar("array_min")
def _array_minmax(e, args):
    (v,) = args
    is_max = e.fn == "array_max"
    m = v.elem_mask()
    masked = torch.where(m, v.data, _extreme(v.data.dtype, not is_max))
    out = masked.amax(dim=1) if is_max else masked.amin(dim=1)
    return Val(e.dtype, out, and_valid(v.valid, m.any(dim=1)),
               v.dictionary)


@scalar("array_sum")
def _array_sum(e, args):
    (v,) = args
    m = v.elem_mask()
    return Val(e.dtype, torch.where(m, v.data, 0).sum(dim=1), v.valid)


@scalar("array_concat_fn")
def _array_concat_fn(e, args):
    a, b = args
    if _elem_string(e.dtype.element):
        av, bv = _merge_dicts(Val(T.VARCHAR, a.data, None, a.dictionary),
                              Val(T.VARCHAR, b.data, None, b.dictionary))
        a = dataclasses.replace(a, data=av.data, dictionary=av.dictionary)
        b = dataclasses.replace(b, data=bv.data, dictionary=bv.dictionary)
    n = _rows_of(a.data, b.data)
    data = torch.cat([_at_rows(a.data, n), _at_rows(b.data, n)], dim=1)
    am, bm = _at_rows(a.elem_mask(), n), _at_rows(b.elem_mask(), n)
    # a's live elements, then b's, in order (NULL elements drop, as in
    # the reference)
    keep = torch.cat([am, bm], dim=1)
    (data,) = _compact_elems(keep, data)
    lengths = (am.sum(dim=1) + bm.sum(dim=1)).to(torch.int32)
    return Val(e.dtype, data, and_valid(a.valid, b.valid), a.dictionary,
               lengths, None)


def _sorted_elems(v: Val):
    """(each row's live elements sorted, dead padding last as the
    largest value; the live count)."""
    m = v.elem_mask()
    big = torch.where(m, v.data, _extreme(v.data.dtype, True))
    return torch.sort(big, dim=1)[0], m.sum(dim=1)


@scalar("array_distinct")
def _array_distinct(e, args):
    """Distinct live elements in VALUE order (the reference's
    documented divergence: Trino keeps first-occurrence order)."""
    (v,) = args
    sdata, cnt = _sorted_elems(v)
    n, cap = sdata.shape
    first = torch.cat([torch.ones((n, 1), dtype=torch.bool,
                                  device=sdata.device),
                       sdata[:, 1:] != sdata[:, :-1]], dim=1)
    keep = first & (torch.arange(cap, device=sdata.device)[None, :]
                    < cnt[:, None])
    (data,) = _compact_elems(keep, sdata)
    return Val(e.dtype, data, v.valid, v.dictionary,
               keep.sum(dim=1).to(torch.int32), None)


@scalar("array_sort_fn")
def _array_sort_fn(e, args):
    (v,) = args
    sdata, cnt = _sorted_elems(v)
    return Val(e.dtype, sdata, v.valid, v.dictionary, cnt.to(torch.int32),
               None)


@scalar("sequence")
def _sequence(e, args):
    lo, hi = e.args[0], e.args[1]
    if not (isinstance(lo, ir.Literal) and isinstance(hi, ir.Literal)):
        raise NotImplementedError(
            "sequence() requires literal bounds (static array capacity)")
    step = int(e.args[2].value) if len(e.args) > 2 else 1
    vals = np.arange(int(lo.value),
                     int(hi.value) + (1 if step > 0 else -1), step,
                     dtype=np.int64)
    dev = _compilers()[-1].device
    n = max([v.data.shape[0] for v in args if v.data.ndim == 1],
            default=1)
    data = HS.upload(vals, dev, "literal")[None, :].expand(n, len(vals))
    return Val(e.dtype, data, None, None,
               torch.full((n,), len(vals), dtype=torch.int32, device=dev),
               None)


@scalar("split")
def _split(e, args):
    """split(string, delim): each dictionary entry split on the host
    into a padded [k, cap] table of word codes (one sorted vocabulary),
    rows gathered by code on the device (a dictionary transform with an
    array output)."""
    v = args[0]
    if not isinstance(e.args[1], ir.Literal):
        raise NotImplementedError("split() delimiter must be a literal")
    delim = str(e.args[1].value)
    parts = [str(s).split(delim) for s in v.dictionary]
    lens = np.fromiter(map(len, parts), np.int32, len(parts))
    cap = max(int(lens.max()) if len(parts) else 1, 1)
    flat = list(itertools.chain.from_iterable(parts))
    vocab = sorted(set(flat))
    code_of = {w: i for i, w in enumerate(vocab)}
    k = max(len(parts), 1)
    lut = np.zeros((k, cap), np.int32)
    total = len(flat)
    rows = np.repeat(np.arange(len(parts)), lens)
    cols = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    lut[rows, cols] = np.fromiter(map(code_of.__getitem__, flat), np.int32,
                                  total)
    codes = v.data if v.data.ndim else v.data[None]
    codes = torch.clamp(codes.to(torch.int64), 0, k - 1)
    if not len(parts):
        lens = np.zeros(1, np.int32)
    return Val(e.dtype, _by_code(_lut(lut, codes), codes), v.valid,
               np.array(vocab, dtype=object),
               _by_code(_lut(lens, codes), codes), None)


@scalar("map_ctor")
def _map_ctor(e, args):
    karr, varr = args
    return Val(e.dtype, varr.data, and_valid(karr.valid, varr.valid),
               varr.dictionary, varr.lengths, varr.elem_valid,
               map_keys=karr)


@scalar("map_keys")
def _map_keys(e, args):
    (v,) = args
    k = v.map_keys
    return Val(e.dtype, k.data, v.valid, k.dictionary, k.lengths,
               k.elem_valid)


@scalar("map_values")
def _map_values(e, args):
    (v,) = args
    return Val(e.dtype, v.data, v.valid, v.dictionary, v.lengths,
               v.elem_valid)
