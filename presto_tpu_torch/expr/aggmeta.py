"""Aggregate-call metadata: the host half of the aggregate registry.

The planner, the optimizer and the plan sanity checks need to know an
aggregate's output type and the names and types of its partial-state
columns, but never touch device data. This module holds that
metadata, so the plan layer imports no tensor code; the fold, merge
and finalize bodies live in :mod:`presto_tpu_torch.expr.aggregates`.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir


@dataclasses.dataclass(frozen=True)
class AggCall:
    """A planned aggregate: function name, argument expression (None for
    count(*)), distinct flag, output type."""

    fn: str
    arg: ir.Expr | None
    dtype: T.DataType
    distinct: bool = False
    # boolean column restricting which rows this call folds (reference
    # Aggregation.mask, fed by MarkDistinct for DISTINCT aggregates)
    mask: str | None = None
    # second argument for two-argument aggregates (min_by/max_by's
    # comparison key, corr/covar/regr's x)
    arg2: ir.Expr | None = None
    # literal parameter (approx_percentile's percentile)
    param: float | None = None
    # varlen aggregates (array_agg/map_agg/listagg): separator literal
    # and intra-group ordering column (host-finalized, exec/varlen.py)
    sep: str | None = None
    order_sym: str | None = None
    order_desc: bool = False

    def __str__(self) -> str:
        inner = "*" if self.arg is None else str(self.arg)
        if self.arg2 is not None:
            inner += f", {self.arg2}"
        if self.param is not None:
            inner += f", {self.param:g}"
        d = "distinct " if self.distinct else ""
        m = f" mask {self.mask}" if self.mask else ""
        return f"{self.fn}({d}{inner}){m}"


# sample/population variance family — all DOUBLE-valued (reference
# operator/aggregation/VarianceAggregation + DoubleSumAggregation kin)
VAR_FNS = frozenset({"variance", "var_samp", "var_pop",
                     "stddev", "stddev_samp", "stddev_pop"})
BOOL_FNS = frozenset({"bool_and", "bool_or", "every"})
# central-moments family: skewness/kurtosis carry (count, sum, m2, m3,
# m4) states (reference CentralMomentsAggregation /
# AggregationUtils.mergeCentralMomentsState)
MOMENT_FNS = frozenset({"skewness", "kurtosis"})
# bivariate co-moment family (reference CentralMomentsAggregation /
# CorrelationAggregation / CovarianceAggregation / RegressionAggregation):
# SQL shape fn(y, x), all DOUBLE-valued, rows with a NULL in either
# argument excluded
COVAR_FNS = frozenset({"corr", "covar_samp", "covar_pop",
                       "regr_slope", "regr_intercept"})
BY_FNS = frozenset({"min_by", "max_by"})
# variable-length-output aggregates: computed host-side at finalization
# (exec/varlen.py) because their results cannot live in fixed-width HBM
# arrays (reference operator/aggregation/ArrayAggregationFunction,
# MapAggAggregationFunction, ListaggAggregationFunction)
VARLEN_FNS = frozenset({"array_agg", "map_agg", "listagg"})


def output_type(fn: str, arg_type: T.DataType | None) -> T.DataType:
    if fn in ("count", "count_star", "count_if"):
        return T.BIGINT
    if fn in VAR_FNS or fn in MOMENT_FNS or fn == "geometric_mean":
        return T.DOUBLE
    if fn in BOOL_FNS:
        return T.BOOLEAN
    if fn == "sum":
        if isinstance(arg_type, T.DecimalType):
            # LONG input sums exactly in int128 limbs -> decimal(38, s)
            # (reference DecimalSumAggregation); short inputs keep the
            # int64 state (documented headroom: |sum| < 2^63)
            return T.DecimalType(38 if arg_type.is_long else 18,
                                 arg_type.scale)
        if isinstance(arg_type, T.DoubleType):
            return T.DOUBLE
        return T.BIGINT
    if fn == "avg":
        if isinstance(arg_type, T.DecimalType):
            # decimal in -> decimal out at the same scale, HALF_UP
            # (reference AverageAggregations decimal path); this repo's
            # tpch catalog serves decimal columns, so parity demands the
            # decimal behavior, not the DOUBLE the reference shows on
            # its own all-DOUBLE tpch catalog
            return T.DecimalType(38 if arg_type.is_long else 18,
                                 arg_type.scale)
        return T.DOUBLE
    if fn in ("min", "max", "arbitrary"):
        return arg_type
    if fn in ("approx_distinct", "checksum"):
        return T.BIGINT
    if fn in COVAR_FNS:
        return T.DOUBLE
    if fn in BY_FNS or fn == "approx_percentile":
        return arg_type
    if fn == "array_agg":
        return T.ArrayType(arg_type if arg_type is not None else T.UNKNOWN)
    if fn == "listagg":
        return T.VARCHAR
    raise NotImplementedError(f"aggregate {fn}")


def state_type(call: "AggCall", field: str) -> T.DataType:
    """Type of one partial-state column (the wire schema of partial
    aggregation states shipped through exchanges)."""
    if field == "count":
        return T.BIGINT
    if field in ("a", "b", "hi"):
        return T.BIGINT  # int128 limb sums (long-decimal sum/avg)
    if field in ("vlo", "vhi"):
        return T.BIGINT  # int128 extremum limbs (long-decimal min/max)
    if field == "sum":
        if call.fn == "checksum":
            return T.BIGINT  # wrapping uint64 hash sum, bitcast
        if call.fn == "avg":
            at = call.arg.dtype if call.arg is not None else T.BIGINT
            if isinstance(at, T.DecimalType):
                return T.DecimalType(18, at.scale)
            if isinstance(at, T.DoubleType):
                return T.DOUBLE
            return T.BIGINT
        return call.dtype
    if field == "val":
        if call.fn in BOOL_FNS:
            return T.INTEGER  # bool folded as 0/1 through min/max
        if call.fn in BY_FNS:  # extremum of the comparison key (arg2)
            return call.arg2.dtype
        return call.arg.dtype if call.arg is not None else call.dtype
    if field in ("m2", "m3", "m4", "sumlog", "sumx", "sumy", "cxy",
                 "m2x", "m2y", "rval"):
        return T.DOUBLE
    if field in ("regs", "rhash"):
        return T.BIGINT  # nominal: arrays carry their real dtype
    if field == "xval":
        return call.arg.dtype
    if field == "xok":
        return T.BOOLEAN
    raise NotImplementedError(field)


# state column suffixes per function (partial aggregation schema)
def state_fields(fn) -> list[str]:
    """``fn`` is a function name or an AggCall (needed to distinguish
    the long-decimal sum/avg limb states from the int64 state)."""
    if not isinstance(fn, str):
        call = fn
        if long_sum_call(call):
            return ["a", "b", "hi", "count"]
        if long_minmax_call(call):
            return ["vlo", "vhi", "count"]
        fn = call.fn
    if fn in ("count", "count_star", "count_if"):
        return ["count"]
    if fn == "sum":
        return ["sum", "count"]  # count tracks non-null presence for SQL sum
    if fn == "avg":
        return ["sum", "count"]
    if fn in ("min", "max", "arbitrary") or fn in BOOL_FNS:
        return ["val", "count"]
    if fn in VAR_FNS:
        return ["count", "sum", "m2"]
    if fn in MOMENT_FNS:
        return ["count", "sum", "m2", "m3", "m4"]
    if fn == "geometric_mean":
        return ["count", "sumlog"]
    if fn == "approx_distinct":
        return ["regs"]
    if fn == "checksum":
        return ["sum"]
    if fn in COVAR_FNS:
        return ["count", "sumx", "sumy", "cxy", "m2x", "m2y"]
    if fn in BY_FNS:
        return ["val", "xval", "xok", "count"]
    if fn == "approx_percentile":
        return ["rhash", "rval"]
    raise NotImplementedError(fn)


def is_long_decimal(t) -> bool:
    return isinstance(t, T.DecimalType) and t.is_long


def long_minmax_call(call) -> bool:
    """min/max/arbitrary over a LONG decimal argument: the state is the
    extremum's two int64 limbs (vlo/vhi)."""
    return (call.fn in ("min", "max", "arbitrary")
            and call.arg is not None
            and is_long_decimal(call.arg.dtype))


def long_sum_call(call) -> bool:
    """True for sum/avg over a LONG decimal argument: the state is the
    exact int128 limb decomposition (fields a/b/hi/count) instead of an
    int64 running sum (reference DecimalSumAggregation's
    Int128State)."""
    return (call.fn in ("sum", "avg") and call.arg is not None
            and is_long_decimal(call.arg.dtype))


# aggregates foldable by segmented scans over hash-sorted rows (all but
# the 2D-register sketches, which keep the segment-op path)
SCAN_FNS = (frozenset({"count", "count_star", "count_if", "sum", "avg",
                       "min", "max", "arbitrary", "geometric_mean",
                       "checksum"})
            | VAR_FNS | MOMENT_FNS | BOOL_FNS | COVAR_FNS | BY_FNS)
