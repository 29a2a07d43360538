"""AST -> logical plan.

The analog of the reference's sql/analyzer + sql/planner front half:
StatementAnalyzer/ExpressionAnalyzer name+type resolution
(sql/analyzer/StatementAnalyzer.java, ExpressionAnalyzer.java),
RelationPlanner/QueryPlanner AST lowering (sql/planner/QueryPlanner.java,
RelationPlanner.java), SubqueryPlanner apply-style subquery planning
(sql/planner/SubqueryPlanner.java) and the load-bearing rewrites that the
reference runs as optimizer rules but fit naturally at plan time here:

- implicit/inner joins are flattened into a leg list; WHERE conjuncts
  become leg filters, equi-join edges, or residual filters; a greedy
  join-graph walk orders the joins largest-leg-first so every build side
  is small (reference EliminateCrossJoins + ReorderJoins +
  PredicatePushDown).
- correlated subqueries are decorrelated into group-by + equi-join
  (reference TransformCorrelatedScalarSubquery / TransformCorrelated*
  rule family), EXISTS/IN become multi-key semijoins
  (TransformUncorrelatedSubqueryToJoin, SemiJoinNode).
- OR predicates sharing common conjuncts are factored so join edges hide
  inside ORs are still found (TPC-H Q19 shape).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import aggmeta as AGG
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.aggmeta import AggCall
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.sql import ast as A


class SemanticError(Exception):
    pass


AGG_FUNCTIONS = {"count", "sum", "avg", "min", "max", "arbitrary",
                 "count_if", "bool_and", "bool_or", "every",
                 "variance", "var_samp", "var_pop",
                 "stddev", "stddev_samp", "stddev_pop",
                 "geometric_mean", "approx_distinct", "checksum",
                 "corr", "covar_samp", "covar_pop",
                 "regr_slope", "regr_intercept",
                 "min_by", "max_by", "approx_percentile",
                 "skewness", "kurtosis",
                 "array_agg", "map_agg", "listagg"}

_COMPARISONS = {"=": "eq", "<>": "neq", "<": "lt", "<=": "lte",
                ">": "gt", ">=": "gte"}
_ARITH = {"+": "add", "-": "subtract", "*": "multiply", "/": "divide",
          "%": "modulus", "||": "concat"}


# ---------------------------------------------------------------------------
# scopes


@dataclasses.dataclass(frozen=True)
class Field:
    name: str | None
    qualifier: str | None
    symbol: str
    dtype: T.DataType


class Scope:
    def __init__(self, fields: list[Field]):
        self.fields = list(fields)

    def try_resolve(self, parts: tuple[str, ...]) -> Field | None:
        if len(parts) == 1:
            matches = [f for f in self.fields if f.name == parts[0]]
        elif len(parts) == 2:
            matches = [f for f in self.fields
                       if f.qualifier == parts[0] and f.name == parts[1]]
        else:
            matches = [f for f in self.fields
                       if f.qualifier == parts[-2] and f.name == parts[-1]]
        if not matches:
            return None
        if len(matches) > 1:
            raise SemanticError(f"column {'.'.join(parts)} is ambiguous")
        return matches[0]

    def concat(self, other: "Scope") -> "Scope":
        return Scope(self.fields + other.fields)


class SymbolAllocator:
    def __init__(self) -> None:
        self._next = 0

    def fresh(self, base: str) -> str:
        self._next += 1
        base = base or "expr"
        return f"{base}_{self._next}"


# ---------------------------------------------------------------------------
# expression planning


@dataclasses.dataclass
class ExprCtx:
    scope: Scope
    planner: "LogicalPlanner"
    outer: Scope | None = None
    correlated: list[Field] = dataclasses.field(default_factory=list)
    agg_syms: dict[A.FunctionCall, tuple[str, T.DataType]] | None = None
    # AST of a grouping expression -> (output symbol, type): selecting
    # or ordering by the VERBATIM group expression resolves to the
    # aggregation output instead of re-planning base columns that are
    # no longer in scope (reference TranslationMap's rewrite of
    # groupings; official q99-style `substr(...) GROUP BY substr(...)`)
    group_ast: dict[A.Expression, tuple[str, T.DataType]] | None = None
    subquery_syms: dict[A.Expression, ir.Expr] = dataclasses.field(
        default_factory=dict)

    def resolve(self, parts: tuple[str, ...]) -> Field:
        f = self.scope.try_resolve(parts)
        if f is not None:
            return f
        if self.outer is not None:
            f = self.outer.try_resolve(parts)
            if f is not None:
                self.correlated.append(f)
                return f
        raise SemanticError(f"column '{'.'.join(parts)}' cannot be resolved")


def _days(s: str) -> int:
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def plan_literal_number(text: str) -> ir.Literal:
    if "e" in text or "E" in text:
        return ir.Literal(T.DOUBLE, float(text))
    if "." in text:
        intpart, frac = text.split(".")
        scale = len(frac)
        digits = (intpart.lstrip("0") or "") + frac
        precision = max(len(digits), scale + 1)
        if precision > 38:
            return ir.Literal(T.DOUBLE, float(text))
        return ir.Literal(T.DecimalType(precision, scale),
                          int(intpart or "0") * 10 ** scale
                          + int(frac or "0"))
    return ir.Literal(T.BIGINT, int(text))


def _ts_micros(s: str) -> int:
    """Epoch micros of a 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' literal."""
    s = s.strip().replace(" ", "T")
    d64 = np.datetime64(s, "us")
    return int((d64 - np.datetime64("1970-01-01", "us")).astype(np.int64))


def _time_micros(s: str) -> int:
    """Micros since midnight of a 'HH:MM:SS[.ffffff]' literal."""
    parts = s.strip().split(":")
    h, m = int(parts[0]), int(parts[1]) if len(parts) > 1 else 0
    sec = float(parts[2]) if len(parts) > 2 else 0.0
    return ((h * 60 + m) * 60) * T.US_PER_SECOND + round(
        sec * T.US_PER_SECOND)


# micros per day-time interval unit
_INTERVAL_US = {
    "second": T.US_PER_SECOND, "minute": T.US_PER_MINUTE,
    "hour": T.US_PER_HOUR, "day": T.US_PER_DAY,
    "week": 7 * T.US_PER_DAY,
}


def _interval_value(e: A.IntervalLiteral) -> tuple[T.DataType, int]:
    """(type, value) of an interval literal: months for year-month,
    micros for day-second. 'D HH:MM:SS' day-to-second strings
    supported."""
    sign = -1 if e.negative else 1
    if e.unit in ("year", "month"):
        v = int(e.value)
        return (T.INTERVAL_YEAR_MONTH,
                sign * (12 * v if e.unit == "year" else v))
    if e.unit in _INTERVAL_US:
        text = str(e.value).strip()
        if text.startswith("-"):
            sign, text = -sign, text[1:].strip()
        if " " in text or ":" in text:
            # '[D ]HH:MM:SS' day-to-second body: one sign for the WHOLE
            # magnitude (SQL interval semantics — the day and time
            # parts never carry opposite signs)
            days, _, rest = text.partition(" ")
            if ":" in days:  # no day part, just a time body
                days, rest = "0", text
            us = int(days or 0) * T.US_PER_DAY
            if rest:
                us += _time_micros(rest)
            return T.INTERVAL_DAY_TIME, sign * us
        return (T.INTERVAL_DAY_TIME,
                sign * round(float(text) * _INTERVAL_US[e.unit]))
    raise SemanticError(f"unsupported interval unit {e.unit}")


def _interval_months_days(e: A.IntervalLiteral) -> tuple[int, int]:
    v = int(e.value)
    if e.negative:
        v = -v
    if e.unit == "year":
        return 12 * v, 0
    if e.unit == "month":
        return v, 0
    if e.unit == "week":
        return 0, 7 * v
    if e.unit == "day":
        return 0, v
    raise SemanticError(f"unsupported interval unit {e.unit}")


def _unwrap_unnest(rel: A.Relation):
    """(A.Unnest, alias, column_aliases) when ``rel`` is an (aliased)
    UNNEST relation, else (None, None, None)."""
    if isinstance(rel, A.AliasedRelation) \
            and isinstance(rel.relation, A.Unnest):
        return rel.relation, rel.alias, rel.column_aliases
    if isinstance(rel, A.Unnest):
        return rel, None, ()
    return None, None, None


def _const_eq_symbol(e: ir.Expr) -> str | None:
    """The column symbol of an eq(column, literal) predicate, else
    None."""
    if isinstance(e, ir.Call) and e.fn == "eq" and len(e.args) == 2:
        a, b = e.args
        if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Literal):
            return a.name
        if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
            return b.name
    return None


def narrow_unique_by_consts(uniques: list[frozenset],
                            predicate: ir.Expr) -> list[frozenset]:
    """Constant-equality narrows unique keys: a relation unique on
    {a, b} filtered to b = const is unique on {a}. Shared by the
    planner's leg-filter pushdown and the post-optimization uniqueness
    recomputation (plan/dense.py)."""
    preds = [predicate]
    if isinstance(predicate, ir.Call) and predicate.fn == "and":
        preds = list(predicate.args)
    consts = {s for p in preds
              if (s := _const_eq_symbol(p)) is not None}
    if not consts:
        return uniques
    return sorted({u - consts for u in uniques}, key=len)


def _shift_date_days(days: int, months: int, delta_days: int) -> int:
    d = np.datetime64("1970-01-01") + np.timedelta64(days, "D")
    if months:
        m = d.astype("datetime64[M]") + np.timedelta64(months, "M")
        dom = (d - d.astype("datetime64[M]")).astype(int)
        d = m.astype("datetime64[D]") + np.timedelta64(int(dom), "D")
    d = d + np.timedelta64(delta_days, "D")
    return int((d - np.datetime64("1970-01-01")).astype(int))


def parse_type_name(name: str) -> T.DataType:
    name = name.strip().lower()
    if "(" in name:
        base, rest = name.split("(", 1)
        params = [int(p) for p in rest.rstrip(")").split(",")]
        base = base.strip()
        if base == "decimal":
            scale = params[1] if len(params) > 1 else 0
            if params[0] > 38:
                raise SemanticError(
                    f"decimal precision {params[0]} exceeds 38")
            if scale > params[0]:
                raise SemanticError(
                    f"decimal scale {scale} exceeds precision")
            return T.DecimalType(params[0], scale)
        if base in ("varchar", "char"):
            return T.VarcharType(params[0])
        raise SemanticError(f"unknown type {name}")
    return {
        "bigint": T.BIGINT, "integer": T.INTEGER, "int": T.INTEGER,
        "smallint": T.INTEGER, "tinyint": T.INTEGER,
        "double": T.DOUBLE, "real": T.DOUBLE, "float": T.DOUBLE,
        "boolean": T.BOOLEAN, "date": T.DATE,
        "timestamp": T.TIMESTAMP, "time": T.TIME,
        "varchar": T.VARCHAR, "char": T.VARCHAR,
        "decimal": T.DecimalType(18, 0),
    }[name]


def _decimal_scale(t: T.DataType) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


def _decimal_prec_scale(t: T.DataType) -> tuple[int, int]:
    """(precision, scale) with integer types as decimal(19,0)
    (reference TypeCoercion BIGINT->decimal(19,0))."""
    if isinstance(t, T.DecimalType):
        return t.precision, t.scale
    return 19, 0


def arith_result_type(op: str, a: T.DataType, b: T.DataType) -> T.DataType:
    if op == "||":
        if isinstance(a, T.ArrayType) and isinstance(b, T.ArrayType):
            return a
        return T.VARCHAR
    if isinstance(a, T.TimestampType) or isinstance(b, T.TimestampType):
        return T.TIMESTAMP
    if isinstance(a, T.DateType) or isinstance(b, T.DateType):
        return T.DATE
    if isinstance(a, T.DoubleType) or isinstance(b, T.DoubleType):
        return T.DOUBLE
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        # reference derivation rules, DecimalOperators.java:84,261,339
        pa, sa = _decimal_prec_scale(a)
        pb, sb = _decimal_prec_scale(b)
        if op in ("+", "-"):
            return T.DecimalType(
                min(38, max(pa - sa, pb - sb) + max(sa, sb) + 1),
                max(sa, sb))
        if op == "%":
            # DecimalOperators.java:503
            if max(pa - sa, pb - sb) + max(sa, sb) > 38:
                # remainder aligns both operands to max(sa, sb) in
                # int128 at runtime; an operand needing > 38 digits
                # after alignment wraps silently (the reference uses
                # wider intermediates here) — wrong answers are worse
                # than loud failures
                raise SemanticError(
                    f"DECIMAL remainder requires aligning {a} and {b} "
                    f"to {max(pa - sa, pb - sb) + max(sa, sb)} digits, "
                    f"exceeding the maximum decimal precision 38 "
                    f"(cast an operand to DOUBLE for approximate "
                    f"arithmetic)")
            return T.DecimalType(
                max(1, min(38, min(pa - sa, pb - sb) + max(sa, sb))),
                max(sa, sb))
        if op == "*":
            if sa + sb > 38:
                # reference DecimalOperators rejects out-of-range
                # derivations; silently degrading to DOUBLE loses
                # exactness the caller asked DECIMAL for
                raise SemanticError(
                    f"DECIMAL scale {sa + sb} must be in range "
                    f"[0, 38]: {a} * {b} exceeds the maximum decimal "
                    f"precision (cast an operand to DOUBLE for "
                    f"approximate arithmetic)")
            return T.DecimalType(min(38, pa + pb), sa + sb)
        if op == "/":
            return T.DecimalType(
                min(38, pa + sb + max(sb - sa, 0)), max(sa, sb))
    return T.BIGINT


class ExprPlanner:
    """AST expression -> typed IR, resolving names against a scope chain.
    Aggregate calls and planned subqueries are substituted from side
    tables (reference TranslationMap analog)."""

    def __init__(self, ctx: ExprCtx):
        self.ctx = ctx

    def plan(self, e: A.Expression) -> ir.Expr:
        if e in self.ctx.subquery_syms:
            return self.ctx.subquery_syms[e]
        if self.ctx.group_ast is not None:
            hit = self.ctx.group_ast.get(e)
            if hit is not None:
                return ir.ColumnRef(hit[1], hit[0])
        m = getattr(self, "_p_" + type(e).__name__.lower(), None)
        if m is None:
            raise SemanticError(
                f"unsupported expression {type(e).__name__}")
        return m(e)

    # -- leaves

    def _p_identifier(self, e: A.Identifier) -> ir.Expr:
        f = self.ctx.resolve((e.name,))
        return ir.ColumnRef(f.dtype, f.symbol)

    def _p_dereference(self, e: A.Dereference) -> ir.Expr:
        f = self.ctx.resolve(e.parts)
        return ir.ColumnRef(f.dtype, f.symbol)

    def _p_numericliteral(self, e: A.NumericLiteral) -> ir.Expr:
        return plan_literal_number(e.text)

    def _p_stringliteral(self, e: A.StringLiteral) -> ir.Expr:
        return ir.Literal(T.VARCHAR, e.value)

    def _p_booleanliteral(self, e: A.BooleanLiteral) -> ir.Expr:
        return ir.Literal(T.BOOLEAN, e.value)

    def _p_nullliteral(self, e: A.NullLiteral) -> ir.Expr:
        return ir.Literal(T.UNKNOWN, None)

    def _p_typedliteral(self, e: A.TypedLiteral) -> ir.Expr:
        if e.type_name == "date":
            return ir.Literal(T.DATE, _days(e.value))
        if e.type_name == "decimal":
            return plan_literal_number(e.value)
        if e.type_name == "timestamp":
            return ir.Literal(T.TIMESTAMP, _ts_micros(e.value))
        if e.type_name == "time":
            return ir.Literal(T.TIME, _time_micros(e.value))
        raise SemanticError(f"unsupported literal type {e.type_name}")

    def _p_intervalliteral(self, e: A.IntervalLiteral) -> ir.Expr:
        dtype, v = _interval_value(e)
        return ir.Literal(dtype, v)

    # -- operators

    def _p_unaryop(self, e: A.UnaryOp) -> ir.Expr:
        v = self.plan(e.operand)
        if e.op == "+":
            return v
        if isinstance(v, ir.Literal) and v.value is not None \
                and not isinstance(v.dtype, T.VarcharType):
            return ir.Literal(v.dtype, -v.value)
        return ir.Call(v.dtype, "negate", (v,))

    def _p_binaryop(self, e: A.BinaryOp) -> ir.Expr:
        if e.op in _COMPARISONS:
            a, b = self.plan(e.left), self.plan(e.right)
            return ir.Call(T.BOOLEAN, _COMPARISONS[e.op], (a, b))
        # date/timestamp +- interval
        if e.op in ("+", "-"):
            il = isinstance(e.left, A.IntervalLiteral)
            ri = isinstance(e.right, A.IntervalLiteral)
            if il or ri:
                iv = e.left if il else e.right
                other = e.right if il else e.left
                itype, ival = _interval_value(iv)
                if e.op == "-":
                    if il:
                        raise SemanticError(
                            "interval - datetime is not defined")
                    ival = -ival
                o = self.plan(other)
                if isinstance(o.dtype, T.TimestampType):
                    if itype is T.INTERVAL_DAY_TIME:
                        if isinstance(o, ir.Literal) and o.value is not None:
                            return ir.Literal(T.TIMESTAMP, o.value + ival)
                        return ir.Call(
                            T.TIMESTAMP, "add",
                            (o, ir.Literal(T.BIGINT, ival)))
                    return ir.Call(
                        T.TIMESTAMP, "ts_add_months",
                        (o, ir.Literal(T.BIGINT, ival)))
                if not isinstance(o.dtype, T.DateType):
                    raise SemanticError(
                        "interval arithmetic needs a date or timestamp")
                if itype is T.INTERVAL_YEAR_MONTH:
                    months, days = ival, 0
                else:
                    if ival % T.US_PER_DAY:
                        # sub-day interval promotes the date to timestamp
                        if isinstance(o, ir.Literal) \
                                and o.value is not None:
                            return ir.Literal(
                                T.TIMESTAMP,
                                o.value * T.US_PER_DAY + ival)
                        return ir.Call(T.TIMESTAMP, "add",
                                       (ir.Cast(T.TIMESTAMP, o),
                                        ir.Literal(T.BIGINT, ival)))
                    months, days = 0, ival // T.US_PER_DAY
                if isinstance(o, ir.Literal):
                    return ir.Literal(
                        T.DATE, _shift_date_days(o.value, months, days))
                if months == 0:
                    return ir.Call(T.DATE, "add",
                                   (o, ir.Literal(T.BIGINT, days)))
                return ir.Call(T.DATE, "add_months",
                               (o, ir.Literal(T.BIGINT, months),
                                ir.Literal(T.BIGINT, days)))
        a, b = self.plan(e.left), self.plan(e.right)
        if e.op == "||" and (isinstance(a.dtype, T.ArrayType)
                             or isinstance(b.dtype, T.ArrayType)):
            # array || element / element || array wraps the scalar side
            # (reference ConcatFunction array forms)
            if not isinstance(a.dtype, T.ArrayType):
                a = ir.Call(T.ArrayType(a.dtype), "array_ctor", (a,))
            if not isinstance(b.dtype, T.ArrayType):
                b = ir.Call(T.ArrayType(b.dtype), "array_ctor", (b,))
            return ir.Call(a.dtype, "concat", (a, b))
        out = arith_result_type(e.op, a.dtype, b.dtype)
        return ir.Call(out, _ARITH[e.op], (a, b))

    def _p_logicalop(self, e: A.LogicalOp) -> ir.Expr:
        return ir.Call(T.BOOLEAN, e.op,
                       tuple(self.plan(t) for t in e.terms))

    def _p_notop(self, e: A.NotOp) -> ir.Expr:
        return ir.Call(T.BOOLEAN, "not", (self.plan(e.operand),))

    def _p_isnullpredicate(self, e: A.IsNullPredicate) -> ir.Expr:
        return ir.IsNull(T.BOOLEAN, self.plan(e.operand), e.negated)

    def _p_betweenpredicate(self, e: A.BetweenPredicate) -> ir.Expr:
        out = ir.Call(T.BOOLEAN, "between",
                      (self.plan(e.operand), self.plan(e.low),
                       self.plan(e.high)))
        if e.negated:
            return ir.Call(T.BOOLEAN, "not", (out,))
        return out

    def _p_inlistpredicate(self, e: A.InListPredicate) -> ir.Expr:
        v = self.plan(e.operand)
        vals = [self.plan(x) for x in e.values]
        if all(isinstance(x, ir.Literal) for x in vals):
            out: ir.Expr = ir.InList(T.BOOLEAN, v, tuple(vals))
        else:
            out = ir.Call(T.BOOLEAN, "or", tuple(
                ir.Call(T.BOOLEAN, "eq", (v, x)) for x in vals))
        if e.negated:
            return ir.Call(T.BOOLEAN, "not", (out,))
        return out

    def _p_likepredicate(self, e: A.LikePredicate) -> ir.Expr:
        args = [self.plan(e.operand), self.plan(e.pattern)]
        if e.escape is not None:
            args.append(self.plan(e.escape))
        out = ir.Call(T.BOOLEAN, "like", tuple(args))
        if e.negated:
            return ir.Call(T.BOOLEAN, "not", (out,))
        return out

    def _p_castexpression(self, e: A.CastExpression) -> ir.Expr:
        return ir.Cast(parse_type_name(e.type_name), self.plan(e.operand))

    def _p_caseexpression(self, e: A.CaseExpression) -> ir.Expr:
        conds = tuple(self.plan(c) for c, _ in e.whens)
        results = [self.plan(r) for _, r in e.whens]
        default = (self.plan(e.default) if e.default is not None
                   else ir.Literal(T.UNKNOWN, None))
        out_t = default.dtype
        for r in results:
            out_t = T.common_super_type(out_t, r.dtype)
        if isinstance(out_t, T.UnknownType):
            out_t = T.BIGINT
        default = ir.Literal(out_t, None) if isinstance(
            default.dtype, T.UnknownType) else default
        return ir.CaseWhen(out_t, conds, tuple(results), default)

    _EXTRACT_FIELDS = {
        "year": "year", "month": "month", "day": "day",
        "quarter": "quarter", "week": "week",
        "day_of_week": "day_of_week", "dow": "day_of_week",
        "day_of_year": "day_of_year", "doy": "day_of_year",
        "hour": "hour", "minute": "minute", "second": "second",
    }

    def _plan_higher_order(self, name: str,
                           e: A.FunctionCall) -> ir.Expr | None:
        """Array functions with special typing / lambda arguments
        (reference operator/scalar/ArrayTransformFunction.java,
        ArrayFilterFunction, ReduceFunction + array function family)."""
        if name not in ("transform", "filter", "reduce", "any_match",
                        "all_match", "none_match", "cardinality",
                        "element_at", "array_position", "array_max",
                        "array_min", "array_sum", "array_distinct",
                        "array_sort", "sequence", "split", "map",
                        "map_keys", "map_values", "repeat"):
            return None
        if name in ("transform", "filter", "any_match", "all_match",
                    "none_match"):
            arr = self.plan(e.args[0])
            if not isinstance(arr.dtype, T.ArrayType):
                raise SemanticError(f"{name}() expects an array")
            lam_ast = e.args[1]
            if not isinstance(lam_ast, A.Lambda):
                raise SemanticError(f"{name}() expects a lambda")
            lam = self._plan_lambda(lam_ast, [arr.dtype.element])
            if name == "transform":
                out_t: T.DataType = T.ArrayType(lam.dtype)
            elif name == "filter":
                out_t = arr.dtype
            else:
                out_t = T.BOOLEAN
            return ir.Call(out_t, name, (arr, lam))
        if name == "reduce":
            arr = self.plan(e.args[0])
            init = self.plan(e.args[1])
            if not isinstance(arr.dtype, T.ArrayType):
                raise SemanticError("reduce() expects an array")
            lam = self._plan_lambda(
                e.args[2], [init.dtype, arr.dtype.element])
            args: tuple = (arr, init, lam)
            out_t = lam.dtype
            if len(e.args) > 3:
                out_lam = self._plan_lambda(e.args[3], [lam.dtype])
                args = args + (out_lam,)
                out_t = out_lam.dtype
            return ir.Call(out_t, "reduce", args)
        args = tuple(self.plan(a) for a in e.args)
        if name == "cardinality":
            return ir.Call(T.BIGINT, "cardinality", args)
        if name == "element_at":
            v = args[0]
            if isinstance(v.dtype, T.ArrayType):
                return ir.Call(v.dtype.element, "element_at", args)
            if isinstance(v.dtype, T.MapType):
                return ir.Call(v.dtype.value, "element_at", args)
            raise SemanticError("element_at expects an array or map")
        if name == "array_position":
            return ir.Call(T.BIGINT, "array_position", args)
        if name in ("array_max", "array_min"):
            return ir.Call(args[0].dtype.element, name, args)
        if name == "array_sum":
            et = args[0].dtype.element
            out_t = (T.DOUBLE if isinstance(et, T.DoubleType)
                     else et if isinstance(et, T.DecimalType)
                     else T.BIGINT)
            return ir.Call(out_t, "array_sum", args)
        if name == "array_distinct":
            return ir.Call(args[0].dtype, "array_distinct", args)
        if name == "array_sort":
            return ir.Call(args[0].dtype, "array_sort_fn", args)
        if name == "sequence":
            return ir.Call(T.ArrayType(T.BIGINT), "sequence", args)
        if name == "split":
            return ir.Call(T.ArrayType(T.VARCHAR), "split", args)
        if name == "map":
            ka, va = args
            if not (isinstance(ka.dtype, T.ArrayType)
                    and isinstance(va.dtype, T.ArrayType)):
                raise SemanticError("map() expects two arrays")
            return ir.Call(T.MapType(ka.dtype.element,
                                     va.dtype.element),
                           "map_ctor", args)
        if name == "map_keys":
            return ir.Call(T.ArrayType(args[0].dtype.key),
                           "map_keys", args)
        if name == "map_values":
            return ir.Call(T.ArrayType(args[0].dtype.value),
                           "map_values", args)
        return None

    def _p_arrayconstructor(self, e: A.ArrayConstructor) -> ir.Expr:
        if not e.items:
            return ir.Call(T.ArrayType(T.BIGINT), "array_ctor", ())
        items = [self.plan(i) for i in e.items]
        et: T.DataType = T.UNKNOWN
        for it in items:
            et = T.common_super_type(et, it.dtype)
        if isinstance(et, T.UnknownType):
            et = T.BIGINT
        items = [it if it.dtype == et else ir.Cast(et, it)
                 for it in items]
        return ir.Call(T.ArrayType(et), "array_ctor", tuple(items))

    def _p_subscript(self, e: A.Subscript) -> ir.Expr:
        v = self.plan(e.operand)
        i = self.plan(e.index)
        if isinstance(v.dtype, T.ArrayType):
            return ir.Call(v.dtype.element, "element_at", (v, i))
        if isinstance(v.dtype, T.MapType):
            return ir.Call(v.dtype.value, "element_at", (v, i))
        raise SemanticError(
            f"cannot subscript a value of type {v.dtype}")

    def _p_lambda(self, e: A.Lambda) -> ir.Expr:
        raise SemanticError(
            "lambda expressions are only valid as higher-order "
            "function arguments")

    _LAM_COUNTER = [0]

    def _plan_lambda(self, lam: A.Lambda,
                     param_types: list[T.DataType]) -> ir.Lambda:
        """Plan a lambda body with params bound as fresh symbols."""
        if len(lam.params) != len(param_types):
            raise SemanticError(
                f"lambda expects {len(param_types)} parameters")
        self._LAM_COUNTER[0] += 1
        n = self._LAM_COUNTER[0]
        syms = [f"$lam{n}_{p}" for p in lam.params]
        fields = [Field(p, None, s, t) for p, s, t in
                  zip(lam.params, syms, param_types)]
        ctx2 = dataclasses.replace(
            self.ctx, scope=Scope(list(self.ctx.scope.fields) + fields))
        body = ExprPlanner(ctx2).plan(lam.body)
        return ir.Lambda(body.dtype, tuple(syms), body)

    def _p_extract(self, e: A.Extract) -> ir.Expr:
        fn = self._EXTRACT_FIELDS.get(e.field)
        if fn is None:
            raise SemanticError(f"extract({e.field}) unsupported")
        return ir.Call(T.BIGINT, fn, (self.plan(e.operand),))

    def _p_functioncall(self, e: A.FunctionCall) -> ir.Expr:
        name = e.name
        if name in AGG_FUNCTIONS or name == "grouping":
            if self.ctx.agg_syms is None:
                raise SemanticError(
                    f"aggregate {name}() not allowed in this context")
            entry = self.ctx.agg_syms.get(e)
            if entry is None:
                raise SemanticError(
                    f"aggregate {name}() not collected for this block")
            sym, dtype = entry
            if sym is None:  # grouping() under plain GROUP BY
                return ir.Literal(dtype, 0)
            return ir.ColumnRef(dtype, sym)
        if e.agg_order_by:
            raise SemanticError(
                f"ORDER BY inside {name}() is not supported")
        if name in ("substr", "substring"):
            name = "substring"
        hof = self._plan_higher_order(name, e)
        if hof is not None:
            return hof
        args = tuple(self.plan(a) for a in e.args)
        if name in ("year", "month", "day", "hour", "minute", "second",
                    "millisecond"):
            return ir.Call(T.BIGINT, name, args)
        if name == "date_trunc":
            if not (isinstance(args[0], ir.Literal)
                    and isinstance(args[0].dtype, T.VarcharType)):
                raise SemanticError("date_trunc unit must be a literal")
            return ir.Call(args[1].dtype, "date_trunc", args)
        if name == "date_add":
            if not (isinstance(args[0], ir.Literal)
                    and isinstance(args[0].dtype, T.VarcharType)):
                raise SemanticError("date_add unit must be a literal")
            return ir.Call(args[2].dtype, "date_add", args)
        if name == "date_diff":
            return ir.Call(T.BIGINT, "date_diff", args)
        if name == "from_unixtime":
            return ir.Call(T.TIMESTAMP, "from_unixtime", args)
        if name == "to_unixtime":
            return ir.Call(T.DOUBLE, "to_unixtime", args)
        if name == "date_format":
            return ir.Call(T.VARCHAR, "date_format", args)
        if name in ("now", "current_timestamp", "localtimestamp"):
            return ir.Literal(T.TIMESTAMP, _ts_micros(
                np.datetime_as_string(np.datetime64("now", "us"))))
        if name == "current_date":
            return ir.Literal(T.DATE, int(
                (np.datetime64("now", "D")
                 - np.datetime64("1970-01-01")).astype(int)))
        if name == "coalesce":
            out_t = args[0].dtype
            for a in args[1:]:
                out_t = T.common_super_type(out_t, a.dtype)
            return ir.Call(out_t, "coalesce", args)
        if name in ("lower", "upper", "substring", "concat", "trim",
                    "ltrim", "rtrim", "replace", "reverse"):
            return ir.Call(T.VARCHAR, name, args)
        if name in ("length", "strpos", "quarter", "day_of_week",
                    "day_of_year", "week", "week_of_year", "dow", "doy"):
            name = {"week_of_year": "week", "dow": "day_of_week",
                    "doy": "day_of_year"}.get(name, name)
            return ir.Call(T.BIGINT, name, args)
        if name in ("starts_with", "regexp_like", "contains"):
            return ir.Call(T.BOOLEAN, name, args)
        if name in ("regexp_replace", "regexp_extract", "lpad", "rpad",
                    "split_part"):
            return ir.Call(T.VARCHAR, name, args)
        if name in ("json_extract_scalar", "json_extract", "json_parse",
                    "json_format"):
            return ir.Call(T.VARCHAR, name, args)
        if name in ("json_array_length", "json_size"):
            return ir.Call(T.BIGINT, name, args)
        if name == "abs":
            return ir.Call(args[0].dtype, name, args)
        if name == "sign":
            # sign of a decimal is a plain integer +-1/0, not a scaled
            # value in the argument's decimal domain
            out_t = (T.BIGINT if isinstance(args[0].dtype, T.DecimalType)
                     else args[0].dtype)
            return ir.Call(out_t, name, args)
        if name in ("mod",):
            out_t = T.common_super_type(args[0].dtype, args[1].dtype)
            return ir.Call(out_t, "mod", args)
        if name in ("greatest", "least"):
            out_t = args[0].dtype
            for a in args[1:]:
                out_t = T.common_super_type(out_t, a.dtype)
            return ir.Call(out_t, name, args)
        if name == "nullif":
            return ir.Call(args[0].dtype, name, args)
        if name == "round":
            a = args[0]
            if isinstance(a.dtype, T.DecimalType):
                digits = 0
                if len(args) > 1 and isinstance(args[1], ir.Literal):
                    digits = int(args[1].value)
                # LONG decimals keep their precision class (reference
                # round(decimal(p,s), d) -> decimal(min(38, p+1), s');
                # short inputs keep the historical 18 so results stay
                # single-limb)
                prec = (min(38, a.dtype.precision + 1)
                        if a.dtype.is_long else 18)
                out = T.DecimalType(prec,
                                    min(a.dtype.scale, max(digits, 0)))
                return ir.Call(out, "round", args)
            return ir.Call(a.dtype, "round", args)
        if name in ("sqrt", "cbrt", "floor", "ceil", "ceiling", "power",
                    "pow", "exp", "ln", "log10", "log2", "truncate",
                    "sin", "cos", "tan", "asin", "acos", "atan",
                    "atan2", "sinh", "cosh", "tanh", "degrees",
                    "radians", "log", "exp2"):
            return ir.Call(T.DOUBLE, name, args)
        if name in ("pi", "e"):
            import math
            return ir.Literal(T.DOUBLE,
                              math.pi if name == "pi" else math.e)
        if name in ("infinity", "nan"):
            return ir.Literal(T.DOUBLE,
                              float("inf") if name == "infinity"
                              else float("nan"))
        if name in ("is_nan", "is_finite", "is_infinite"):
            return ir.Call(T.BOOLEAN, name, args)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_not", "bitwise_left_shift",
                    "bitwise_right_shift", "bit_count"):
            return ir.Call(T.BIGINT, name, args)
        if name == "width_bucket":
            return ir.Call(T.BIGINT, "width_bucket", args)
        if name in ("codepoint", "levenshtein_distance",
                    "hamming_distance"):
            return ir.Call(T.BIGINT, name, args)
        if name in ("chr", "translate", "repeat_str", "normalize",
                    "url_extract_protocol", "url_extract_host",
                    "url_extract_path", "url_extract_query",
                    "url_extract_fragment", "url_extract_parameter",
                    "url_encode", "url_decode", "to_hex", "from_hex",
                    "md5", "sha256", "to_base64", "from_base64"):
            return ir.Call(T.VARCHAR, name, args)
        if name == "url_extract_port":
            return ir.Call(T.BIGINT, name, args)
        if name == "if":
            if len(args) not in (2, 3):
                raise SemanticError("if() takes 2 or 3 arguments")
            out_t = args[1].dtype
            if len(args) > 2:
                out_t = T.common_super_type(out_t, args[2].dtype)
            default = (args[2] if len(args) > 2
                       else ir.Literal(out_t, None))
            return ir.CaseWhen(out_t, (args[0],), (args[1],), default)
        if name == "typeof":
            return ir.Literal(T.VARCHAR, str(args[0].dtype))
        raise SemanticError(f"unknown function {name}")

    def _p_scalarsubquery(self, e: A.ScalarSubquery) -> ir.Expr:
        raise SemanticError(
            "scalar subquery in unsupported position (not planned)")

    def _p_existspredicate(self, e: A.ExistsPredicate) -> ir.Expr:
        raise SemanticError("EXISTS in unsupported position")

    def _p_insubquery(self, e: A.InSubquery) -> ir.Expr:
        raise SemanticError("IN (subquery) in unsupported position")


# ---------------------------------------------------------------------------
# helpers on AST predicates


def split_conjuncts(e: A.Expression | None) -> list[A.Expression]:
    if e is None:
        return []
    if isinstance(e, A.LogicalOp) and e.op == "and":
        out: list[A.Expression] = []
        for t in e.terms:
            out.extend(split_conjuncts(t))
        return out
    factored = factor_or(e)
    if factored is not e:
        return split_conjuncts(factored)
    return [e]


def factor_or(e: A.Expression) -> A.Expression:
    """(a AND x) OR (a AND y) -> a AND (x OR y): pull conjuncts common to
    every OR branch out of the OR (finds the join edges hidden inside
    TPC-H Q19's OR-of-conjunction predicate)."""
    if not (isinstance(e, A.LogicalOp) and e.op == "or"):
        return e
    branch_conjs = [split_conjuncts(b) for b in e.terms]
    common = [c for c in branch_conjs[0]
              if all(c in bc for bc in branch_conjs[1:])]
    if not common:
        return e
    residuals = []
    for bc in branch_conjs:
        rest = [c for c in bc if c not in common]
        if not rest:
            return e  # one branch fully covered: OR is implied by common
        residuals.append(rest[0] if len(rest) == 1
                         else A.LogicalOp("and", tuple(rest)))
    return A.LogicalOp(
        "and", tuple(common) + (A.LogicalOp("or", tuple(residuals)),))


def _collect_calls(e: A.Expression | None, pred) -> list[A.FunctionCall]:
    """Collect FunctionCall nodes matching ``pred`` without descending
    into matches (their arguments belong to the inner evaluation)."""
    out: list[A.FunctionCall] = []

    def walk(x):
        if isinstance(x, A.FunctionCall) and pred(x):
            if x not in out:
                out.append(x)
            return
        if isinstance(x, A.Query):
            # a subquery is its own aggregation block: its aggregates
            # must NOT hoist into the enclosing block
            return
        # descend through ANY AST dataclass (window specs and sort
        # items carry expressions too: q70's rank() orders by a sum()
        # that must be collected as an aggregate of the block)
        for f in dataclasses.fields(x) if dataclasses.is_dataclass(x) else ():
            v = getattr(x, f.name)
            items = v if isinstance(v, (tuple, list)) else (v,)
            for item in items:
                if dataclasses.is_dataclass(item) \
                        and not isinstance(item, type):
                    walk(item)
                elif isinstance(item, tuple):
                    for sub in item:
                        if dataclasses.is_dataclass(sub) \
                                and not isinstance(sub, type):
                            walk(sub)
    if e is not None:
        walk(e)
    return out


def _substitute_order_aliases(e: A.Expression, spec: A.QuerySpec,
                              from_scope) -> A.Expression:
    """Replace output-alias references inside an ORDER BY expression
    with the aliased select expression (names already resolvable in
    the FROM scope win; aggregate arguments are never touched)."""
    from presto_tpu_torch.sql.grouping import rewrite_ast
    aliases = {i.alias: i.expression for i in spec.select_items
               if i.alias is not None}
    if not aliases:
        return e

    def sub(node):
        if (isinstance(node, A.Identifier) and node.name in aliases
                and from_scope.try_resolve((node.name,)) is None):
            return aliases[node.name]
        return None

    def skip(node):
        return (isinstance(node, A.FunctionCall)
                and node.name in AGG_FUNCTIONS and node.window is None)

    return rewrite_ast(e, sub, skip)


def _find_calls_named(e, name: str) -> list:
    """All FunctionCall nodes with the given name (no window)."""
    return _collect_calls(
        e, lambda x: x.name == name and x.window is None)


def find_agg_calls(e: A.Expression | None) -> list[A.FunctionCall]:
    return _collect_calls(
        e, lambda x: x.name in AGG_FUNCTIONS and x.window is None)


WINDOW_FNS = {"rank", "dense_rank", "row_number", "lag", "lead",
              "first_value", "last_value", "nth_value", "ntile",
              "percent_rank", "cume_dist",
              "sum", "count", "avg", "min", "max"}


def find_window_calls(e: A.Expression | None) -> list[A.FunctionCall]:
    return _collect_calls(e, lambda x: x.window is not None)


def find_subquery_nodes(e: A.Expression) -> list[A.Expression]:
    out: list[A.Expression] = []

    def walk(x):
        if isinstance(x, (A.ScalarSubquery, A.InSubquery,
                          A.ExistsPredicate)):
            out.append(x)
            return
        if dataclasses.is_dataclass(x) and not isinstance(x, A.Query):
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, A.Node):
                    walk(v)
                elif isinstance(v, tuple):
                    for item in v:
                        if isinstance(item, A.Node):
                            walk(item)
                        elif isinstance(item, tuple):
                            for sub in item:
                                if isinstance(sub, A.Node):
                                    walk(sub)
    walk(e)
    return out


def rewrite_subtrees(e: ir.Expr, mapping: dict[ir.Expr, ir.Expr]) -> ir.Expr:
    if e in mapping:
        return mapping[e]
    if isinstance(e, ir.Call):
        return ir.Call(e.dtype, e.fn, tuple(
            rewrite_subtrees(a, mapping) for a in e.args))
    if isinstance(e, ir.Cast):
        return ir.Cast(e.dtype, rewrite_subtrees(e.arg, mapping))
    if isinstance(e, ir.CaseWhen):
        return ir.CaseWhen(
            e.dtype,
            tuple(rewrite_subtrees(c, mapping) for c in e.conditions),
            tuple(rewrite_subtrees(r, mapping) for r in e.results),
            None if e.default is None
            else rewrite_subtrees(e.default, mapping))
    if isinstance(e, ir.InList):
        return ir.InList(e.dtype, rewrite_subtrees(e.arg, mapping),
                         e.values)
    if isinstance(e, ir.IsNull):
        return ir.IsNull(e.dtype, rewrite_subtrees(e.arg, mapping),
                         e.negated)
    return e


from presto_tpu_torch.ops.sizes import next_pow2 as _next_pow2  # noqa: E402
from presto_tpu_torch.plan.stats import selectivity as _selectivity  # noqa: E402


def _expr_name(e: A.Expression) -> str:
    if isinstance(e, A.Identifier):
        return e.name
    if isinstance(e, A.Dereference):
        return e.parts[-1]
    if isinstance(e, A.FunctionCall):
        return e.name
    return "expr"


# ---------------------------------------------------------------------------
# relation plans


@dataclasses.dataclass
class RelationPlan:
    node: N.PlanNode
    scope: Scope
    est: int  # static cardinality estimate for join ordering
    unique: list[frozenset[str]] = dataclasses.field(default_factory=list)
    # cumulative filter selectivity applied to this relation: a unique
    # (PK) build side keeps only this fraction of FK probe rows
    # (cost/JoinStatsRule.java containment analog)
    sel: float = 1.0


@dataclasses.dataclass
class QState:
    """Mutable per-query-block planning state."""

    node: N.PlanNode
    scope: Scope
    est: int
    unique: list[frozenset[str]]
    corr_pairs: list[tuple[str, str, T.DataType]] = dataclasses.field(
        default_factory=list)  # (outer_symbol, inner_symbol, dtype)
    # correlated non-equality predicates (planned IR over outer+inner
    # symbols); handled by the expanding-join EXISTS path
    residual_corr: list[ir.Expr] = dataclasses.field(default_factory=list)

    def add_projection(self, expr: ir.Expr, base: str,
                       planner: "LogicalPlanner") -> str:
        """Ensure ``expr`` is available as a symbol, projecting if needed."""
        if isinstance(expr, ir.ColumnRef):
            return expr.name
        sym = planner.symbols.fresh(base)
        assigns = {s: ir.ColumnRef(t, s)
                   for s, t in self.node.output_types().items()}
        assigns[sym] = expr
        self.node = N.Project(self.node, assigns)
        self.scope = Scope(self.scope.fields
                           + [Field(None, None, sym, expr.dtype)])
        return sym


# ---------------------------------------------------------------------------
# the planner


class LogicalPlanner:
    """Plans one statement. Reference: sql/planner/LogicalPlanner.java:131."""

    def __init__(self, engine, analysis=None):
        self.engine = engine
        self.analysis = analysis
        self.symbols = SymbolAllocator()
        # symbol -> distinct-value estimate from connector stats; symbols
        # are globally unique per planner, so one map serves the whole
        # plan (analog of the reference's SymbolStatsEstimate in cost/)
        self.ndv: dict[str, int] = {}
        # symbol -> (lo, hi) physical value range for range-predicate
        # selectivity (cost/FilterStatsCalculator.java analog)
        self.ranges: dict[str, tuple[float, float]] = {}

    # -- entry --------------------------------------------------------------

    def plan(self, stmt: A.Statement) -> N.PlanNode:
        if isinstance(stmt, A.ExplainStatement):
            stmt = stmt.statement
        if not isinstance(stmt, A.QueryStatement):
            raise SemanticError(
                f"unsupported statement {type(stmt).__name__}")
        rp, names = self.plan_root_query(stmt.query, {}, None)
        symbols = [f.symbol for f in rp.scope.fields]
        return N.Output(rp.node, names, symbols)

    def plan_root_query(self, q: A.Query, ctes: dict, outer: Scope | None):
        rp = self.plan_query(q, ctes, outer)
        names = []
        used = set()
        for f in rp.scope.fields:
            name = f.name or "_col"
            if name in used:
                i = 1
                while f"{name}_{i}" in used:
                    i += 1
                name = f"{name}_{i}"
            used.add(name)
            names.append(name)
        return rp, names

    # -- queries ------------------------------------------------------------

    def plan_query(self, q: A.Query, ctes: dict,
                   outer: Scope | None) -> RelationPlan:
        ctes = dict(ctes)
        for w in q.with_queries:
            ctes[w.name] = w
        body = q.body
        if isinstance(body, A.QuerySpec):
            return self.plan_query_spec(
                body, q.order_by, q.limit, q.offset, ctes, outer)
        # set operation / plain subquery body: order-by over output scope
        rp = self.plan_set_op(body, ctes, outer)
        if q.order_by:
            orderings = []
            for item in q.order_by:
                sym = self._resolve_order_item(item, rp.scope, None)
                orderings.append(N.Ordering(sym, item.ascending,
                                            item.nulls_first))
            rp = RelationPlan(N.Sort(rp.node, orderings), rp.scope,
                              rp.est, rp.unique)
        if q.limit is not None or q.offset:
            cnt = q.limit if q.limit is not None else 1 << 62
            rp = RelationPlan(N.Limit(rp.node, cnt, q.offset), rp.scope,
                              min(rp.est, cnt), rp.unique)
        return rp

    def _resolve_order_item(self, item: A.SortItem, out_scope: Scope,
                            ctx: ExprCtx | None) -> str:
        e = item.expression
        if isinstance(e, A.NumericLiteral):
            idx = int(e.text) - 1
            return out_scope.fields[idx].symbol
        if isinstance(e, A.Identifier):
            f = out_scope.try_resolve((e.name,))
            if f is not None:
                return f.symbol
        if ctx is None:
            raise SemanticError("ORDER BY item cannot be resolved")
        planned = ExprPlanner(ctx).plan(e)
        if isinstance(planned, ir.ColumnRef):
            return planned.name
        raise SemanticError("complex ORDER BY item needs hidden projection")

    def plan_set_op(self, body: A.Relation, ctes: dict,
                    outer: Scope | None) -> RelationPlan:
        if isinstance(body, A.SubqueryRelation):
            return self.plan_query(body.query, ctes, outer)
        if isinstance(body, A.QuerySpec):
            return self.plan_query_spec(body, (), None, 0, ctes, outer)
        if not isinstance(body, A.SetOperation):
            raise SemanticError(
                f"unsupported query body {type(body).__name__}")
        left = self.plan_set_op(body.left, ctes, outer)
        right = self.plan_set_op(body.right, ctes, outer)
        if body.op != "union":
            return self._plan_intersect_except(body, left, right)
        if len(left.scope.fields) != len(right.scope.fields):
            raise SemanticError("UNION inputs have different arity")
        symbols, types, fields = [], {}, []
        mappings: list[dict[str, str]] = [{}, {}]
        for lf, rf in zip(left.scope.fields, right.scope.fields):
            dtype = T.common_super_type(lf.dtype, rf.dtype)
            sym = self.symbols.fresh(lf.name or "col")
            symbols.append(sym)
            types[sym] = dtype
            mappings[0][sym] = lf.symbol
            mappings[1][sym] = rf.symbol
            fields.append(Field(lf.name, None, sym, dtype))
        node = N.Union([left.node, right.node], symbols, types, mappings)
        rp = RelationPlan(node, Scope(fields), left.est + right.est, [])
        if body.distinct:
            rp = RelationPlan(
                N.Distinct(rp.node, _next_pow2(2 * rp.est)), rp.scope,
                rp.est, [frozenset(symbols)])
        return rp

    def _plan_intersect_except(self, body: A.SetOperation,
                               left: RelationPlan,
                               right: RelationPlan) -> RelationPlan:
        """INTERSECT/EXCEPT via distinct + semijoin (reference
        ImplementIntersectAsUnion-style rewrite, adapted)."""
        if len(left.scope.fields) != len(right.scope.fields):
            raise SemanticError("set operation inputs have different arity")
        lsyms = [f.symbol for f in left.scope.fields]
        rsyms = [f.symbol for f in right.scope.fields]
        mark = self.symbols.fresh("setop_mark")
        node = N.SemiJoin(left.node, right.node, lsyms, rsyms, mark,
                          capacity=_next_pow2(2 * right.est))
        pred: ir.Expr = ir.ColumnRef(T.BOOLEAN, mark)
        if body.op == "except":
            pred = ir.Call(T.BOOLEAN, "not", (pred,))
        filt = N.Filter(node, pred)
        distinct = N.Distinct(filt, _next_pow2(2 * left.est))
        return RelationPlan(distinct, left.scope, left.est,
                            [frozenset(lsyms)])

    # -- relations ----------------------------------------------------------

    def plan_relation(self, rel: A.Relation, ctes: dict,
                      outer: Scope | None) -> RelationPlan:
        if isinstance(rel, A.TableRef):
            return self.plan_table_ref(rel, ctes, outer)
        if isinstance(rel, A.AliasedRelation):
            inner = self.plan_relation(rel.relation, ctes, outer)
            fields = []
            for i, f in enumerate(inner.scope.fields):
                name = (rel.column_aliases[i] if i < len(rel.column_aliases)
                        else f.name)
                fields.append(Field(name, rel.alias, f.symbol, f.dtype))
            return RelationPlan(inner.node, Scope(fields), inner.est,
                                inner.unique)
        if isinstance(rel, A.SubqueryRelation):
            return self.plan_query(rel.query, ctes, outer)
        if isinstance(rel, A.JoinRelation):
            if rel.join_type in ("left", "right", "full"):
                return self.plan_outer_join(rel, ctes, outer)
            # inner/cross/implicit outside a query-spec context: build a
            # one-off spec-less join
            return self._plan_inner_join_tree(rel, ctes, outer)
        if isinstance(rel, A.ValuesRelation):
            return self.plan_values(rel)
        if isinstance(rel, A.MatchRecognizeRelation):
            return self.plan_match_recognize(rel, ctes, outer)
        raise SemanticError(f"unsupported relation {type(rel).__name__}")

    def plan_match_recognize(self, rel: A.MatchRecognizeRelation,
                             ctes: dict, outer: Scope | None
                             ) -> RelationPlan:
        """MATCH_RECOGNIZE (reference sql/analyzer/
        PatternRecognitionAnalyzer + plan/PatternRecognitionNode).
        Supported subset: ONE ROW PER MATCH, AFTER MATCH SKIP PAST LAST
        ROW, DEFINE over current-row columns and PREV(col [, n]),
        measures FIRST(x)/LAST(x)/plain (=LAST)/MATCH_NUMBER()/
        CLASSIFIER()."""
        inner = self.plan_relation(rel.input, ctes, outer)
        ctx = ExprCtx(inner.scope, self)

        def plain_sym(e: A.Expression, what: str) -> str:
            planned = ExprPlanner(ctx).plan(e)
            if not isinstance(planned, ir.ColumnRef):
                raise SemanticError(
                    f"MATCH_RECOGNIZE {what} must be a column")
            return planned.name

        part_syms = [plain_sym(e, "PARTITION BY")
                     for e in rel.partition_by]
        orderings = []
        for item in rel.order_by:
            orderings.append(N.Ordering(
                plain_sym(item.expression, "ORDER BY"),
                item.ascending, item.nulls_first))

        types = inner.node.output_types()

        def rewrite_prev(e: A.Expression) -> A.Expression:
            """PREV(col [, n]) -> column reference {sym}$prev{n}."""
            if isinstance(e, A.FunctionCall) and e.name == "prev":
                col = e.args[0]
                n = 1
                if len(e.args) > 1:
                    if not isinstance(e.args[1], A.NumericLiteral):
                        raise SemanticError("PREV offset must be a "
                                            "literal")
                    n = int(e.args[1].text)
                sym = plain_sym(col, "PREV argument")
                return A.Identifier(f"{sym}$prev{n}")
            if dataclasses.is_dataclass(e):
                changed = {}
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, A.Expression):
                        changed[f.name] = rewrite_prev(v)
                    elif isinstance(v, tuple) and any(
                            isinstance(x, A.Expression) for x in v):
                        changed[f.name] = tuple(
                            rewrite_prev(x)
                            if isinstance(x, A.Expression) else x
                            for x in v)
                if changed:
                    return dataclasses.replace(e, **changed)
            return e

        # prev-columns extend the scope with the base column's type
        prev_fields = list(inner.scope.fields)
        import re as _re
        defines: dict[str, ir.Expr] = {}
        for var, cond in rel.defines:
            rewritten = rewrite_prev(cond)
            for m in _re.finditer(r"([A-Za-z_0-9]+)\$prev(\d+)",
                                  repr(rewritten)):
                base, _n = m.group(1), m.group(2)
                full = m.group(0)
                if base in types and not any(
                        f.symbol == full for f in prev_fields):
                    prev_fields.append(
                        Field(full, None, full, types[base]))
            dctx = ExprCtx(Scope(prev_fields), self)
            planned = ExprPlanner(dctx).plan(rewritten)
            defines[var.lower()] = planned

        measures: list[tuple] = []
        out_fields = [Field(f.name, f.qualifier, f.symbol, f.dtype)
                      for f in inner.scope.fields
                      if f.symbol in part_syms]
        for m in rel.measures:
            e = m.expression
            kind = "last"
            arg: A.Expression | None = e
            if isinstance(e, A.FunctionCall):
                if e.name in ("first", "last"):
                    kind = e.name
                    arg = e.args[0]
                elif e.name == "match_number":
                    kind, arg = "match_number", None
                elif e.name == "classifier":
                    kind, arg = "classifier", None
            if arg is not None:
                planned = ExprPlanner(ctx).plan(arg)
                dtype = planned.dtype
            else:
                planned = None
                dtype = (T.BIGINT if kind == "match_number"
                         else T.VARCHAR)
            sym = self.symbols.fresh(m.name)
            measures.append((sym, kind, planned, dtype))
            out_fields.append(Field(m.name, None, sym, dtype))

        node = N.MatchRecognize(inner.node, part_syms, orderings,
                                rel.pattern, defines, measures)
        ndv = 1
        for s in part_syms:
            ndv *= max(self.ndv.get(s, 32), 1)
        est = max(min(inner.est, ndv * 8), 1)
        return RelationPlan(node, Scope(out_fields), est, [])

    def plan_table_ref(self, rel: A.TableRef, ctes: dict,
                       outer: Scope | None) -> RelationPlan:
        parts = rel.parts
        if len(parts) == 1 and parts[0] in ctes:
            w: A.WithQuery = ctes[parts[0]]
            sub_ctes = {k: v for k, v in ctes.items() if k != parts[0]}
            inner = self.plan_query(w.query, sub_ctes, outer)
            fields = []
            for i, f in enumerate(inner.scope.fields):
                name = (w.column_aliases[i] if i < len(w.column_aliases)
                        else f.name)
                fields.append(Field(name, parts[0], f.symbol, f.dtype))
            return RelationPlan(inner.node, Scope(fields), inner.est,
                                inner.unique)
        if len(parts) == 1:
            catalog = self.engine.session.catalog
            table = parts[0]
        else:
            catalog, table = parts[0], parts[-1]
        conn = self.engine.catalogs.get(catalog)
        if conn is None:
            raise SemanticError(f"catalog '{catalog}' does not exist")
        if table not in conn.table_names():
            raise SemanticError(f"table '{catalog}.{table}' does not exist")
        schema = conn.table_schema(table)
        assignments, types, fields = {}, {}, []
        colsyms = {}
        for col, dtype in schema.items():
            sym = self.symbols.fresh(col)
            assignments[sym] = col
            types[sym] = dtype
            colsyms[col] = sym
            fields.append(Field(col, table, sym, dtype))
        self.engine.access_control.check_can_select(
            self.engine.session.user, catalog, table)
        node = N.TableScan(catalog, table, assignments, types)
        unique = [frozenset(colsyms[c] for c in key)
                  for key in conn.unique_keys(table)]
        est = conn.row_count_estimate(table)
        for col, nd in conn.ndv_estimates(table).items():
            if col in colsyms:
                self.ndv[colsyms[col]] = nd
        for col, rng in conn.column_range_estimates(table).items():
            if col in colsyms:
                self.ranges[colsyms[col]] = rng
        return RelationPlan(node, Scope(fields), est, unique)

    def plan_values(self, rel: A.ValuesRelation) -> RelationPlan:
        rows_ir = []
        for row in rel.rows:
            planned = []
            for e in row:
                v = ExprPlanner(ExprCtx(Scope([]), self)).plan(e)
                if not isinstance(v, ir.Literal):
                    raise SemanticError("VALUES rows must be literals")
                planned.append(v)
            rows_ir.append(planned)
        ncols = len(rows_ir[0])
        types_per_col = []
        for i in range(ncols):
            t: T.DataType = T.UNKNOWN
            for row in rows_ir:
                t = T.common_super_type(t, row[i].dtype)
            if isinstance(t, T.UnknownType):
                t = T.BIGINT
            types_per_col.append(t)
        symbols, types, fields = [], {}, []
        for i, t in enumerate(types_per_col):
            sym = self.symbols.fresh(f"col{i}")
            symbols.append(sym)
            types[sym] = t
            fields.append(Field(f"_col{i}", None, sym, t))
        rows = []
        for row in rows_ir:
            vals = []
            for i, v in enumerate(row):
                t = types_per_col[i]
                val = v.value
                if (isinstance(t, T.DecimalType)
                        and isinstance(v.dtype, T.DecimalType)
                        and v.value is not None):
                    val = v.value * 10 ** (t.scale - v.dtype.scale)
                elif (isinstance(t, T.DecimalType)
                      and not isinstance(v.dtype, T.DecimalType)
                      and v.value is not None):
                    val = int(v.value) * 10 ** t.scale
                vals.append(val)
            rows.append(vals)
        node = N.Values(symbols, types, rows)
        return RelationPlan(node, Scope(fields), len(rows), [])

    def plan_outer_join(self, rel: A.JoinRelation, ctes: dict,
                        outer: Scope | None) -> RelationPlan:
        left = self._plan_join_operand(rel.left, ctes, outer)
        right = self._plan_join_operand(rel.right, ctes, outer)
        # RIGHT join: probe the right side, build the left; the declared
        # field order (left columns first) is preserved either way
        if rel.join_type == "right":
            probe, build = right, left
        else:
            probe, build = left, right
        combined = left.scope.concat(right.scope)
        conjuncts = split_conjuncts(rel.on) if rel.on is not None else []
        psyms = {f.symbol for f in probe.scope.fields}
        bsyms = {f.symbol for f in build.scope.fields}
        criteria: list[tuple[str, str]] = []
        residual: list[ir.Expr] = []
        build_node = build.node
        for c in rel.using:
            lf = left.scope.try_resolve((c,))
            rf = right.scope.try_resolve((c,))
            if lf is None or rf is None:
                raise SemanticError(f"USING column {c} not found")
            pf, bf = (lf, rf) if rel.join_type != "right" else (rf, lf)
            criteria.append((pf.symbol, bf.symbol))
        for c in conjuncts:
            planned = ExprPlanner(ExprCtx(combined, self, outer)).plan(c)
            refs = ir.referenced_columns([planned])
            if (isinstance(planned, ir.Call) and planned.fn == "eq"
                    and len(planned.args) == 2):
                a, b = planned.args
                ra = ir.referenced_columns([a])
                rb = ir.referenced_columns([b])
                if ra <= psyms and rb <= bsyms:
                    pass
                elif rb <= psyms and ra <= bsyms:
                    a, b = b, a
                else:
                    a = None
                if a is not None and isinstance(a, ir.ColumnRef) \
                        and isinstance(b, ir.ColumnRef):
                    criteria.append((a.name, b.name))
                    continue
            if refs <= bsyms and rel.join_type != "full":
                # build-side-only ON conjunct: filter the build input
                # (legal for one-sided outer joins: it only affects
                # which build rows can match; for FULL the filtered
                # build rows must still emit unmatched, so it stays a
                # residual)
                build_node = N.Filter(build_node, planned)
                continue
            residual.append(planned)
        if not criteria:
            raise SemanticError("outer join requires an equi condition")
        filt = None
        if residual:
            filt = residual[0] if len(residual) == 1 else ir.Call(
                T.BOOLEAN, "and", tuple(residual))
        build_syms = frozenset(b for _, b in criteria)
        build_unique = any(k <= build_syms for k in build.unique)
        if rel.join_type == "full":
            jt = N.JoinType.FULL
        elif rel.join_type == "inner":
            jt = N.JoinType.INNER
        else:
            jt = N.JoinType.LEFT
        node = N.Join(probe.node, build_node, jt, criteria,
                      filt, build_unique,
                      build_rows=build.est,
                      capacity=_next_pow2(2 * build.est),
                      output_capacity=None
                      if build_unique and jt != N.JoinType.FULL
                      else _next_pow2(2 * (probe.est + build.est)))
        est = probe.est if build_unique else probe.est + build.est
        if jt == N.JoinType.FULL:
            est = probe.est + build.est
        return RelationPlan(node, combined, est, probe.unique)

    def _plan_join_operand(self, rel: A.Relation, ctes, outer
                           ) -> RelationPlan:
        """Plan one side of an outer join. An inner-join tree operand
        (`a join b on ... left join c on ...` is left-associative, so
        the left operand is the whole preceding chain) must keep its
        table qualifiers visible — going through _plan_inner_join_tree's
        SELECT * wrapper would erase them, breaking later references
        like d1.d_week_seq (TPC-DS Q72)."""
        if isinstance(rel, A.JoinRelation) and rel.join_type in (
                "implicit", "cross", "inner") and not rel.using:
            spec = A.QuerySpec((A.SelectItem(A.Star()),), False, rel)
            qs = self._plan_from_where(spec, ctes, outer, False)
            return RelationPlan(qs.node, qs.scope, qs.est, qs.unique)
        return self.plan_relation(rel, ctes, outer)

    def _plan_inner_join_tree(self, rel: A.JoinRelation, ctes, outer):
        spec = A.QuerySpec((A.SelectItem(A.Star()),), False, rel)
        return self.plan_query_spec(spec, (), None, 0, ctes, outer)

    # -- the query-spec pipeline --------------------------------------------

    def plan_query_spec(self, spec: A.QuerySpec,
                        order_by: tuple[A.SortItem, ...],
                        limit: int | None, offset: int,
                        ctes: dict, outer: Scope | None,
                        decorrelate: bool = False) -> RelationPlan:
        qs = self._plan_from_where(spec, ctes, outer, decorrelate)
        from_scope = Scope(list(qs.scope.fields))  # for star expansion

        # ---- aggregation analysis ----
        select_exprs = [i.expression for i in spec.select_items
                        if not isinstance(i.expression, A.Star)]
        order_exprs = [i.expression for i in order_by]
        agg_calls: list[A.FunctionCall] = []
        grouping_calls: list[A.FunctionCall] = []
        for e in select_exprs + ([spec.having] if spec.having else []) \
                + order_exprs:
            for c in find_agg_calls(e):
                if c not in agg_calls:
                    agg_calls.append(c)
            for c in _find_calls_named(e, "grouping"):
                if c not in grouping_calls:
                    grouping_calls.append(c)
        group_exprs = self._resolve_group_by(spec)
        has_agg = bool(agg_calls) or bool(group_exprs)

        ctx = ExprCtx(qs.scope, self, outer)
        group_map: dict[ir.Expr, str] = {}
        if has_agg:
            ctx = self._plan_aggregation(qs, spec, group_exprs, agg_calls,
                                         ctes, outer, decorrelate,
                                         group_map, grouping_calls)
        elif grouping_calls:
            raise SemanticError("grouping() requires GROUP BY")

        # ---- HAVING ----
        if spec.having is not None:
            for c in split_conjuncts(spec.having):
                self._apply_conjunct(qs, c, ctx, ctes, group_map)

        # ---- window functions (evaluate after aggregation/having) ----
        window_calls: list[A.FunctionCall] = []
        for e in select_exprs + order_exprs:
            for w in find_window_calls(e):
                if w not in window_calls:
                    window_calls.append(w)
        if window_calls:
            self._plan_windows(qs, window_calls, ctx, ctes, group_map)

        # ---- SELECT projections ----
        assignments: dict[str, ir.Expr] = {}
        fields: list[Field] = []
        used_syms: set[str] = set()
        for item in spec.select_items:
            if isinstance(item.expression, A.Star):
                q = item.expression.qualifier
                for f in from_scope.fields:
                    if q is not None and f.qualifier != q:
                        continue
                    sym = f.symbol
                    if sym in used_syms:
                        sym = self.symbols.fresh(f.name or "col")
                        assignments[sym] = ir.ColumnRef(f.dtype, f.symbol)
                    else:
                        assignments[sym] = ir.ColumnRef(f.dtype, f.symbol)
                    used_syms.add(sym)
                    fields.append(Field(f.name, None, sym, f.dtype))
                continue
            planned = self._plan_scalar_expr(qs, item.expression, ctx,
                                             ctes, group_map)
            name = item.alias or _expr_name(item.expression)
            if isinstance(planned, ir.ColumnRef) \
                    and planned.name not in used_syms:
                sym = planned.name
            else:
                sym = self.symbols.fresh(name)
            assignments[sym] = planned
            used_syms.add(sym)
            fields.append(Field(name, None, sym, planned.dtype))

        out_scope = Scope(fields)

        # decorrelated subqueries must also output their correlation syms
        hidden: dict[str, ir.Expr] = {}
        if decorrelate:
            types = qs.node.output_types()
            for (_, inner_sym, dt) in qs.corr_pairs:
                if inner_sym not in assignments:
                    hidden[inner_sym] = ir.ColumnRef(dt, inner_sym)
            del types

        # ---- ORDER BY ----
        orderings: list[N.Ordering] = []
        for item in order_by:
            e = item.expression
            sym = None
            if isinstance(e, A.NumericLiteral):
                sym = fields[int(e.text) - 1].symbol
            elif isinstance(e, A.Identifier):
                f = out_scope.try_resolve((e.name,))
                if f is not None:
                    sym = f.symbol
            if sym is None:
                # ORDER BY expressions may reference output aliases
                # (q36's `case when lochierarchy = 0 ...`): substitute
                # the aliased select expression for names that do not
                # resolve in the FROM scope (reference StatementAnalyzer
                # resolves the output scope first)
                e = _substitute_order_aliases(e, spec, qs.scope)
                planned = self._plan_scalar_expr(qs, e, ctx, ctes,
                                                 group_map)
                if isinstance(planned, ir.ColumnRef):
                    sym = planned.name
                    if sym not in assignments:
                        hidden[sym] = planned
                else:
                    sym = self.symbols.fresh("orderkey")
                    hidden[sym] = planned
            orderings.append(N.Ordering(sym, item.ascending,
                                        item.nulls_first))

        if spec.distinct and hidden:
            raise SemanticError(
                "ORDER BY with DISTINCT must use selected columns")

        node = N.Project(qs.node, {**assignments, **hidden})
        est = qs.est
        unique = [u for u in qs.unique if u <= set(assignments)]

        if spec.distinct:
            est_d = min(est, _next_pow2(2 * est))
            node = N.Distinct(node, _next_pow2(2 * est))
            unique = [frozenset(assignments)]
            est = est_d
        if orderings:
            node = N.Sort(node, orderings)
        if limit is not None or offset:
            cnt = limit if limit is not None else 1 << 62
            node = N.Limit(node, cnt, offset)
            est = min(est, cnt)
        # trim hidden order-by symbols (correlation syms stay: the
        # decorrelated join needs them in the subquery output)
        if hidden and not decorrelate:
            node = N.Project(node, {s: ir.ColumnRef(e.dtype, s)
                                    for s, e in assignments.items()})
        rp = RelationPlan(node, out_scope, est, unique)
        if decorrelate:
            rp.corr_pairs = qs.corr_pairs  # type: ignore[attr-defined]
        return rp

    # -- FROM + WHERE with join-graph construction --------------------------

    def _plan_from_where(self, spec: A.QuerySpec, ctes, outer,
                         decorrelate: bool) -> QState:
        legs: list[RelationPlan] = []
        on_conjuncts: list[A.Expression] = []
        # UNNEST legs are LATERAL (their array expressions may reference
        # earlier legs): collected here and applied after the join graph
        unnest_legs: list[tuple] = []  # (A.Unnest, alias, col_aliases)

        def flatten(rel: A.Relation):
            if isinstance(rel, A.JoinRelation) and rel.join_type in (
                    "implicit", "cross", "inner") and not rel.using:
                flatten(rel.left)
                flatten(rel.right)
                if rel.on is not None:
                    on_conjuncts.extend(split_conjuncts(rel.on))
                return
            if isinstance(rel, A.JoinRelation) and rel.using:
                legs.append(self.plan_outer_join(rel, ctes, outer))
                return
            un, alias, cols = _unwrap_unnest(rel)
            if un is not None:
                unnest_legs.append((un, alias, cols))
                return
            legs.append(self.plan_relation(rel, ctes, outer))

        if spec.from_relation is None:
            node = N.Values(["dual"], {"dual": T.BIGINT}, [[1]])
            qs = QState(node, Scope([]), 1, [])
            for c in split_conjuncts(spec.where):
                ctx = ExprCtx(qs.scope, self, outer)
                planned = ExprPlanner(ctx).plan(c)
                qs.node = N.Filter(qs.node, planned)
            return qs

        flatten(spec.from_relation)
        if not legs and unnest_legs:
            # FROM UNNEST(...) alone: expand over a one-row dual
            legs.append(RelationPlan(
                N.Values(["dual"], {"dual": T.BIGINT}, [[1]]),
                Scope([]), 1, [frozenset()]))
        combined = Scope([f for leg in legs for f in leg.scope.fields])
        sym_to_leg = {}
        for i, leg in enumerate(legs):
            for f in leg.scope.fields:
                sym_to_leg[f.symbol] = i

        conjuncts = on_conjuncts + split_conjuncts(spec.where)
        edges: list[tuple[int, int, str, str]] = []  # legA, legB, symA, symB
        post: list[ir.Expr] = []
        deferred: list[A.Expression] = []
        corr_pairs: list[tuple[str, str, T.DataType]] = []
        corr_residual: list[ir.Expr] = []

        late_unnest: list[A.Expression] = []
        for c in conjuncts:
            if find_subquery_nodes(c):
                deferred.append(c)
                continue
            ctx = ExprCtx(combined, self, outer if decorrelate else None)
            try:
                planned = ExprPlanner(ctx).plan(c)
            except SemanticError:
                if unnest_legs:
                    # references UNNEST output columns: plan after the
                    # unnest legs apply
                    late_unnest.append(c)
                    continue
                raise
            if ctx.correlated:
                outer_syms = {f.symbol for f in ctx.correlated}
                pair = self._extract_corr_pair(planned, outer_syms)
                if pair is None:
                    # non-equality correlation: kept for the
                    # expanding-join EXISTS path (TPC-H Q21 shape)
                    corr_residual.append(planned)
                    continue
                inner_expr, outer_sym = pair
                # materialise inner side as a symbol on its leg
                refs = ir.referenced_columns([inner_expr])
                leg_ids = {sym_to_leg[r] for r in refs}
                if len(leg_ids) != 1:
                    raise SemanticError(
                        "correlated predicate spans multiple relations")
                li = leg_ids.pop()
                if isinstance(inner_expr, ir.ColumnRef):
                    inner_sym = inner_expr.name
                else:
                    inner_sym = self.symbols.fresh("corr")
                    leg = legs[li]
                    assigns = {s: ir.ColumnRef(t, s) for s, t in
                               leg.node.output_types().items()}
                    assigns[inner_sym] = inner_expr
                    legs[li] = RelationPlan(
                        N.Project(leg.node, assigns), leg.scope, leg.est,
                        leg.unique)
                    sym_to_leg[inner_sym] = li
                corr_pairs.append((outer_sym, inner_sym, inner_expr.dtype))
                continue
            refs = ir.referenced_columns([planned])
            leg_ids = {sym_to_leg[r] for r in refs if r in sym_to_leg}
            if len(leg_ids) <= 1:
                li = leg_ids.pop() if leg_ids else 0
                leg = legs[li]
                s = _selectivity(planned, self.ndv, self.ranges)
                # constant-equality narrows unique keys (q11's
                # year_total legs join on customer_id alone after the
                # year/sale_type filters — without this the self-joins
                # plan as expanding with compounding output capacities)
                uniq = narrow_unique_by_consts(leg.unique, planned)
                legs[li] = RelationPlan(N.Filter(leg.node, planned),
                                        leg.scope,
                                        max(int(leg.est * s), 1),
                                        uniq, leg.sel * s)
                continue
            if (len(leg_ids) == 2 and isinstance(planned, ir.Call)
                    and planned.fn == "eq"):
                a, b = planned.args
                ra = ir.referenced_columns([a])
                rb = ir.referenced_columns([b])
                la = {sym_to_leg[r] for r in ra}
                lb = {sym_to_leg[r] for r in rb}
                if len(la) == 1 and len(lb) == 1 and la != lb:
                    sa = self._leg_symbol(legs, sym_to_leg, a)
                    sb = self._leg_symbol(legs, sym_to_leg, b)
                    edges.append((la.pop(), lb.pop(), sa, sb))
                    continue
            post.append(planned)

        qs = self._order_joins(legs, edges, combined)
        qs.corr_pairs = corr_pairs
        qs.residual_corr = corr_residual
        for un, alias, col_aliases in unnest_legs:
            self._apply_unnest(qs, un, alias, col_aliases, outer
                               if decorrelate else None)
        for c in late_unnest:
            ctx = ExprCtx(qs.scope, self, outer if decorrelate else None)
            post.append(ExprPlanner(ctx).plan(c))
        for p in post:
            qs.node = N.Filter(qs.node, p)
        for c in deferred:
            ctx = ExprCtx(qs.scope, self, outer if decorrelate else None)
            self._apply_conjunct(qs, c, ctx, ctes, {})
        return qs

    def _leg_symbol(self, legs, sym_to_leg, e: ir.Expr) -> str:
        if isinstance(e, ir.ColumnRef):
            return e.name
        refs = ir.referenced_columns([e])
        li = sym_to_leg[next(iter(refs))]
        sym = self.symbols.fresh("joinkey")
        leg = legs[li]
        assigns = {s: ir.ColumnRef(t, s)
                   for s, t in leg.node.output_types().items()}
        assigns[sym] = e
        legs[li] = RelationPlan(N.Project(leg.node, assigns), leg.scope,
                                leg.est, leg.unique)
        sym_to_leg[sym] = li
        return sym

    def _extract_corr_pair(self, planned: ir.Expr, outer_syms: set[str]):
        if not (isinstance(planned, ir.Call) and planned.fn == "eq"):
            return None
        a, b = planned.args
        ra = ir.referenced_columns([a])
        rb = ir.referenced_columns([b])
        if ra <= outer_syms and isinstance(a, ir.ColumnRef) \
                and not (rb & outer_syms):
            return b, a.name
        if rb <= outer_syms and isinstance(b, ir.ColumnRef) \
                and not (ra & outer_syms):
            return a, b.name
        return None

    def _order_joins(self, legs: list[RelationPlan],
                     edges: list[tuple[int, int, str, str]],
                     combined: Scope) -> QState:
        """Greedy join-graph walk: start at the largest leg (the fact
        table), repeatedly hash-join a connected leg as the build side
        (reference ReorderJoins/EliminateCrossJoins, simplified to the
        star/snowflake shapes of TPC-H/DS)."""
        if len(legs) == 1:
            leg = legs[0]
            return QState(leg.node, combined, leg.est, list(leg.unique))
        remaining = set(range(len(legs)))
        cur = max(remaining, key=lambda i: legs[i].est)
        remaining.discard(cur)
        node = legs[cur].node
        est = legs[cur].est
        unique = list(legs[cur].unique)
        in_set = {cur}
        joined_syms = {f.symbol for f in legs[cur].scope.fields} \
            | set(legs[cur].node.output_types())

        while remaining:
            # candidate legs connected by at least one edge
            cands = {}
            for (la, lb, sa, sb) in edges:
                if la in in_set and lb in remaining:
                    cands.setdefault(lb, []).append((sa, sb))
                elif lb in in_set and la in remaining:
                    cands.setdefault(la, []).append((sb, sa))
            if not cands:
                # no edge: cross join. Single-row right sides broadcast
                # (scalar path); the general case is a nested-loop
                # product over compacted sides, bounded at plan time
                # (reference NestedLoopJoinOperator precedent)
                j = min(remaining, key=lambda i: legs[i].est)
                if legs[j].est <= 1:
                    node = N.CrossJoin(node, legs[j].node, scalar=True)
                else:
                    if est * legs[j].est > (1 << 26):
                        raise SemanticError(
                            "cross join product estimated at "
                            f"{est * legs[j].est} rows exceeds the "
                            "nested-loop limit (add a join predicate)")
                    from presto_tpu_torch import warnings as W
                    W.warn(W.PERFORMANCE_WARNING,
                           "query contains a cross join without a "
                           "join predicate (nested-loop product)")
                    node = N.CrossJoin(node, legs[j].node, scalar=False,
                                       left_rows=est,
                                       right_rows=legs[j].est)
                    est = max(est * legs[j].est, 1)
                    unique = []
                in_set.add(j)
                remaining.discard(j)
                joined_syms |= set(legs[j].node.output_types())
                continue
            # cost-based choice: estimated OUTPUT rows, not build size.
            # A small build side joined on a low-ndv key (Q5's
            # customer on c_nationkey = s_nationkey) is a many-to-many
            # explosion; the reference's ReorderJoins costs candidate
            # orders through JoinStatsRule the same way.
            def out_est(i: int) -> int:
                b = legs[i]
                syms = frozenset(bs for _, bs in cands[i])
                if any(k <= syms for k in b.unique):
                    return max(int(est * b.sel), 1)
                ndv = 1
                for _, bs in cands[i]:
                    ndv *= max(self.ndv.get(bs, 32), 1)
                ndv = min(ndv, max(b.est, 1))
                return max(int(est * b.est / ndv), 1)

            j = min(cands, key=lambda i: (out_est(i), legs[i].est))
            criteria = cands[j]
            build = legs[j]
            build_syms = frozenset(b for _, b in criteria)
            build_unique = any(k <= build_syms for k in build.unique)
            est_out = out_est(j)
            # the capacity HINT stays conservative: an undersized first
            # guess is fixed by one RETRY_GROWTH recompile, an oversized
            # one allocates est_out-rows of HBM up front (q72's default
            # ndv once produced a 2^29-row hint)
            out_cap = min(2 * max(est_out, est), 8 * max(est, build.est))
            node = N.Join(node, build.node, N.JoinType.INNER, criteria,
                          None, build_unique,
                          build_rows=build.est,
                          capacity=_next_pow2(2 * build.est),
                          output_capacity=None if build_unique else
                          _next_pow2(max(out_cap, 2)))
            if build_unique:
                # FK->PK join: a filtered PK side keeps only its
                # selectivity fraction of probe rows (containment,
                # cost/JoinStatsRule.java analog)
                est = est_out
            else:
                est = max(est_out, 2)
                # each output row is a distinct (probe row, build row)
                # pair: probe key + a unique key of the BUILD side (the
                # join keys themselves are NOT unique here)
                unique = [u | bk for u in unique for bk in build.unique]
            in_set.add(j)
            remaining.discard(j)
            joined_syms |= set(build.node.output_types())
        return QState(node, combined, est, unique)

    # -- aggregation --------------------------------------------------------

    def _resolve_group_by(self, spec: A.QuerySpec) -> list[A.Expression]:
        """Plain grouping expressions (ordinals resolved). Multi-set
        grouping (ROLLUP/CUBE/GROUPING SETS) resolves via
        _resolve_grouping_sets."""
        out = []
        for g in spec.group_by:
            for e in (g.expressions if g.kind != "sets"
                      else [x for s in g.expressions for x in s]):
                e = self._resolve_ordinal(e, spec)
                if e not in out:
                    out.append(e)
        return out

    def _resolve_ordinal(self, e: A.Expression,
                         spec: A.QuerySpec) -> A.Expression:
        from presto_tpu_torch.sql.grouping import resolve_ordinal
        return resolve_ordinal(e, spec)

    def _resolve_grouping_sets(
            self, spec: A.QuerySpec) -> list[list[A.Expression]] | None:
        """None for plain GROUP BY; else the expanded list of grouping
        sets — shared with the sqlite oracle dialect so engine and
        oracle cannot disagree (sql/grouping.py)."""
        from presto_tpu_torch.sql.grouping import expand_grouping_sets
        return expand_grouping_sets(spec)
    def _plan_aggregation(self, qs: QState, spec: A.QuerySpec,
                          group_exprs: list[A.Expression],
                          agg_calls: list[A.FunctionCall],
                          ctes, outer, decorrelate,
                          group_map: dict[ir.Expr, str],
                          grouping_calls: list[A.FunctionCall] = ()
                          ) -> ExprCtx:
        pre_ctx = ExprCtx(qs.scope, self, outer)
        planner = ExprPlanner(pre_ctx)

        group_syms: list[str] = []
        ast_to_sym: dict[A.Expression, str] = {}
        for e in group_exprs:
            g_ir = planner.plan(e)
            sym = qs.add_projection(g_ir, _expr_name(e), self)
            group_map[g_ir] = sym
            ast_to_sym[e] = sym
            group_syms.append(sym)

        # decorrelation: correlation symbols join the grouping keys
        if decorrelate:
            for (_, inner_sym, _dt) in qs.corr_pairs:
                if inner_sym not in group_syms:
                    group_syms.append(inner_sym)

        aggs: dict[str, AggCall] = {}
        agg_syms: dict[A.FunctionCall, tuple[str, T.DataType]] = {}

        def _is_distinct(c: A.FunctionCall) -> bool:
            # varlen DISTINCT (array_agg(distinct x)) dedups host-side
            # in exec/varlen.py, not via MarkDistinct
            return c.distinct and c.name not in AGG.VARLEN_FNS

        distinct_calls = [c for c in agg_calls if _is_distinct(c)]
        for call in agg_calls:
            fn = call.name
            arg2_ir = None
            param = None
            if call.is_star or (fn == "count" and not call.args):
                fn = "count_star"
                arg_ir = None
                arg_t = None
            elif fn in AGG.BY_FNS or fn in AGG.COVAR_FNS:
                # two-argument aggregates: min_by/max_by(x, y) and the
                # covariance family fn(y, x)
                if len(call.args) != 2:
                    raise SemanticError(
                        f"aggregate {fn} takes two arguments")
                arg_ir = planner.plan(call.args[0])
                arg2_ir = planner.plan(call.args[1])
                arg_t = arg_ir.dtype
            elif fn == "approx_percentile":
                if len(call.args) != 2:
                    raise SemanticError(
                        "approx_percentile takes (value, percentile)")
                arg_ir = planner.plan(call.args[0])
                p_ir = planner.plan(call.args[1])
                if not isinstance(p_ir, ir.Literal):
                    raise SemanticError(
                        "approx_percentile percentile must be a literal")
                param = float(p_ir.value)
                if isinstance(p_ir.dtype, T.DecimalType):
                    param /= p_ir.dtype.unscale_factor
                if not 0.0 <= param <= 1.0:
                    raise SemanticError(
                        "percentile must be between 0 and 1")
                arg_t = arg_ir.dtype
            elif fn == "map_agg":
                if len(call.args) != 2:
                    raise SemanticError("map_agg takes (key, value)")
                arg_ir = planner.plan(call.args[0])
                arg2_ir = planner.plan(call.args[1])
                arg_t = arg_ir.dtype
            elif fn == "listagg":
                if not 1 <= len(call.args) <= 2:
                    raise SemanticError(
                        "listagg takes (value[, separator])")
                arg_ir = planner.plan(call.args[0])
                arg_t = arg_ir.dtype
            else:
                if len(call.args) != 1:
                    raise SemanticError(
                        f"aggregate {fn} takes one argument")
                arg_ir = planner.plan(call.args[0])
                arg_t = arg_ir.dtype
            if call.agg_order_by and fn not in AGG.VARLEN_FNS:
                raise SemanticError(
                    f"ORDER BY inside {fn}() is not supported (only "
                    "array_agg/listagg order within the group)")
            sep = None
            order_sym = None
            order_desc = False
            if fn in AGG.VARLEN_FNS:
                if fn == "listagg":
                    sep = ","
                    if len(call.args) == 2:
                        s_ir = planner.plan(call.args[1])
                        if not isinstance(s_ir, ir.Literal):
                            raise SemanticError(
                                "listagg separator must be a literal")
                        sep = str(s_ir.value)
                if call.agg_order_by:
                    if len(call.agg_order_by) != 1:
                        raise SemanticError(
                            "aggregate ORDER BY supports one key")
                    item = call.agg_order_by[0]
                    o_ir = planner.plan(item.expression)
                    order_sym = qs.add_projection(o_ir, "aggorder", self)
                    order_desc = not item.ascending
            if fn == "map_agg":
                out_t = T.MapType(arg_t, arg2_ir.dtype)
            else:
                out_t = AGG.output_type(fn, arg_t)
            mask_sym = None
            if call.filter is not None:
                # FILTER (WHERE p): fold under a boolean mask column
                # (reference Aggregation.mask / FilterAggregations)
                if call.distinct:
                    raise SemanticError(
                        "DISTINCT aggregate with FILTER is unsupported")
                f_ir = planner.plan(call.filter)
                if not isinstance(f_ir.dtype, T.BooleanType):
                    raise SemanticError("FILTER predicate must be boolean")
                mask_sym = qs.add_projection(f_ir, "aggfilter", self)
            sym = self.symbols.fresh(fn)
            aggs[sym] = AggCall(fn, arg_ir, out_t, call.distinct,
                                mask=mask_sym,
                                arg2=arg2_ir, param=param, sep=sep,
                                order_sym=order_sym,
                                order_desc=order_desc)
            agg_syms[call] = (sym, out_t)

        gsets = self._resolve_grouping_sets(spec)
        if gsets is not None:
            if distinct_calls:
                raise SemanticError(
                    "DISTINCT aggregates with grouping sets unsupported")
            # grouping(a, b, ...) is a per-branch CONSTANT: bit i set
            # when argument i is rolled away in that grouping set
            # (reference GroupingOperationRewriter)
            gmeta = []
            for call in grouping_calls:
                sym = self.symbols.fresh("grouping")
                args = [self._resolve_ordinal(a, spec)
                        for a in call.args]
                for a in args:
                    if a not in ast_to_sym:
                        raise SemanticError(
                            "grouping() argument must be a grouping "
                            "expression")
                gmeta.append((sym, args))
                agg_syms[call] = (sym, T.BIGINT)
            self._plan_grouping_sets(qs, gsets, ast_to_sym, group_syms,
                                     aggs, gmeta)
            gtypes = qs.node.output_types()
            return ExprCtx(qs.scope, self, outer, agg_syms=agg_syms,
                           group_ast={ast: (s, gtypes[s])
                                      for ast, s in ast_to_sym.items()})
        for call in grouping_calls:
            # plain GROUP BY: nothing is rolled away, grouping() == 0
            # (sym None -> the expression planner emits a 0 literal)
            agg_syms[call] = (None, T.BIGINT)

        if distinct_calls and (len(agg_calls) != len(distinct_calls)
                               or len(distinct_calls) > 1):
            # Mixed or multiple DISTINCT aggregates: mark the first row
            # of every (group keys, argument) tuple and fold the
            # DISTINCT calls under that mask, sharing one Aggregate with
            # the plain calls (reference MarkDistinctNode planning in
            # sql/planner/QueryPlanner + MarkDistinctOperator.java).
            mark_for_arg: dict[str, str] = {}
            for call in agg_calls:
                if not _is_distinct(call):
                    continue
                sym, out_t = agg_syms[call]
                acall = aggs[sym]
                arg_sym = qs.add_projection(acall.arg, "distinct_arg",
                                            self)
                if arg_sym not in mark_for_arg:
                    mark = self.symbols.fresh("mark")
                    qs.node = N.MarkDistinct(
                        qs.node, list(group_syms) + [arg_sym], mark,
                        _next_pow2(2 * min(qs.est, 1 << 22)))
                    mark_for_arg[arg_sym] = mark
                aggs[sym] = AggCall(
                    acall.fn,
                    ir.ColumnRef(acall.arg.dtype, arg_sym), out_t,
                    False, mask=mark_for_arg[arg_sym])
            agg_node = N.Aggregate(
                qs.node, group_syms, aggs, N.AggStep.SINGLE,
                capacity=self._group_capacity(qs.est, group_syms))
        elif distinct_calls:
            call = distinct_calls[0]
            sym, out_t = agg_syms[call]
            acall = aggs[sym]
            # project (group keys, arg) -> distinct -> aggregate
            arg_sym = qs.add_projection(acall.arg, "distinct_arg", self) \
                if acall.arg is not None else None
            keep = list(group_syms) + ([arg_sym] if arg_sym else [])
            types = qs.node.output_types()
            proj = N.Project(qs.node, {s: ir.ColumnRef(types[s], s)
                                       for s in keep})
            dist = N.Distinct(proj, _next_pow2(2 * min(qs.est, 1 << 22)))
            fn2 = "count" if acall.fn == "count" else acall.fn
            arg2 = (ir.ColumnRef(types[arg_sym], arg_sym)
                    if arg_sym else None)
            agg_node = N.Aggregate(
                dist, group_syms, {sym: AggCall(fn2, arg2, out_t)},
                N.AggStep.SINGLE,
                capacity=self._group_capacity(qs.est, group_syms))
        else:
            agg_node = N.Aggregate(
                qs.node, group_syms, aggs, N.AggStep.SINGLE,
                capacity=self._group_capacity(qs.est, group_syms))

        types = agg_node.output_types()
        fields = []
        by_symbol = {f.symbol: f for f in qs.scope.fields}
        for s in agg_node.output_symbols:
            base = by_symbol.get(s)
            fields.append(Field(
                base.name if base else None,
                base.qualifier if base else None, s, types[s]))
        qs.node = agg_node
        qs.scope = Scope(fields)
        qs.est = agg_node.capacity or qs.est
        qs.unique = [frozenset(group_syms)] if group_syms else []
        return ExprCtx(qs.scope, self, outer, agg_syms=agg_syms,
                       group_ast={ast: (s, types[s])
                                  for ast, s in ast_to_sym.items()})

    def _plan_grouping_sets(self, qs: QState,
                            gsets: list[list[A.Expression]],
                            ast_to_sym: dict[A.Expression, str],
                            group_syms: list[str],
                            aggs: dict[str, AggCall],
                            gmeta: list[tuple] = ()) -> None:
        """ROLLUP/CUBE/GROUPING SETS as a UNION ALL of one aggregation
        per set, with ungrouped keys projected as typed NULLs (reference
        AggregationNode carries groupingSets natively,
        plan/AggregationNode.java; the union form is its expansion)."""
        source = qs.node
        types = source.output_types()
        branches: list[N.PlanNode] = []
        mappings: list[dict[str, str]] = []
        out_syms = list(group_syms) + list(aggs) \
            + [sym for sym, _ in gmeta]
        for s in gsets:
            keys_b = [ast_to_sym[e] for e in s]
            # keep decorrelation keys grouped in every branch
            for sym in group_syms:
                if sym not in ast_to_sym.values() and sym not in keys_b:
                    keys_b.append(sym)
            agg_node = N.Aggregate(
                source, keys_b, dict(aggs), N.AggStep.SINGLE,
                capacity=self._group_capacity(qs.est, keys_b))
            atypes = agg_node.output_types()
            assigns: dict[str, ir.Expr] = {}
            for sym in group_syms:
                if sym in keys_b:
                    assigns[sym] = ir.ColumnRef(atypes[sym], sym)
                else:
                    assigns[sym] = ir.Literal(types[sym], None)
            for a in aggs:
                assigns[a] = ir.ColumnRef(atypes[a], a)
            for gsym, gargs in gmeta:
                bits = 0
                for a in gargs:
                    bits = (bits << 1) | (0 if a in s else 1)
                assigns[gsym] = ir.Literal(T.BIGINT, bits)
            branches.append(N.Project(agg_node, assigns))
            mappings.append({sym: sym for sym in out_syms})
        gsym_set = {sym for sym, _ in gmeta}
        utypes = {s: (T.BIGINT if s in gsym_set
                      else types[s] if s in group_syms
                      else branches[0].output_types()[s])
                  for s in out_syms}
        union = N.Union(branches, out_syms, utypes, mappings)
        fields = []
        by_symbol = {f.symbol: f for f in qs.scope.fields}
        for s in out_syms:
            base = by_symbol.get(s)
            fields.append(Field(base.name if base else None,
                                base.qualifier if base else None, s,
                                utypes[s]))
        qs.node = union
        qs.scope = Scope(fields)
        qs.est = sum(b.sources()[0].capacity or qs.est
                     for b in branches)
        qs.unique = []

    def _group_capacity(self, est_rows: int, group_syms: list[str]) -> int:
        """Hash-table capacity for a group-by: 2x the NDV-product estimate
        when connector stats cover every key (reference
        MultiChannelGroupByHash.java:74 expectedGroups), else a bounded
        row-driven default — either way the executor doubles + recompiles
        on kernel-reported overflow, so undersizing is safe."""
        if not group_syms:
            return 1
        prod = 1
        for s in group_syms:
            nd = self.ndv.get(s)
            if nd is None:
                return _next_pow2(2 * max(1024, min(est_rows, 1 << 21)))
            prod = min(prod * max(nd, 1), 1 << 40)
        return _next_pow2(max(2 * min(prod, est_rows, 1 << 21), 16))

    def _range_offset_value(self, bvalue, key_type: T.DataType):
        """Convert a RANGE frame offset literal to the sort key's
        PHYSICAL units (reference window/RangeFraming.java operates on
        the native block encoding the same way: decimals are scaled
        longs, dates are epoch days, timestamps epoch micros)."""
        if key_type is None:
            raise SemanticError(
                "RANGE frame offsets require exactly one sort key")
        if isinstance(bvalue, A.IntervalLiteral):
            itype, iv = _interval_value(bvalue)
            if isinstance(key_type, T.DateType):
                if isinstance(itype, T.IntervalDayTimeType):
                    if iv % 86_400_000_000:
                        raise SemanticError(
                            "RANGE offset for a DATE key must be a "
                            "whole number of days")
                    return iv // 86_400_000_000
                raise SemanticError(
                    "year-month RANGE offsets are not supported")
            if isinstance(key_type, (T.TimestampType, T.TimeType)):
                if isinstance(itype, T.IntervalDayTimeType):
                    return iv
                raise SemanticError(
                    "year-month RANGE offsets are not supported")
            raise SemanticError(
                "interval RANGE offset requires a temporal sort key")
        if isinstance(bvalue, A.NumericLiteral):
            text = bvalue.text
            if isinstance(key_type, (T.BigintType, T.IntegerType)):
                if not text.isdigit():
                    raise SemanticError(
                        "RANGE offset must be a non-negative integer "
                        "for an integer sort key")
                return int(text)
            if isinstance(key_type, T.DecimalType):
                if key_type.is_long:
                    raise SemanticError(
                        "RANGE offsets over long decimal (precision "
                        "> 18) sort keys are not supported")
                from decimal import Decimal
                d = Decimal(text).scaleb(key_type.scale)
                if d != d.to_integral_value():
                    raise SemanticError(
                        "RANGE offset has more decimal places than "
                        "the sort key's scale")
                return int(d)
            if isinstance(key_type, T.DoubleType):
                return float(text)
            raise SemanticError(
                f"RANGE offsets are not supported over "
                f"{key_type} sort keys")
        raise SemanticError("RANGE frame offsets must be literals")

    def _plan_frame(self, frame_ast: "A.WindowFrame",
                    key_type: T.DataType | None = None):
        """(frame tag, rows_frame, range_frame, groups_frame) of an
        explicit frame clause. ROWS/GROUPS frames become (preceding,
        following) offsets (reference window/RowsFraming.java,
        GroupsFraming.java); value-based RANGE offsets convert to the
        sort key's physical units (RangeFraming.java)."""
        unit = frame_ast.unit

        def bound_offset(btype, bvalue, is_start):
            if btype == "unbounded_preceding":
                return None if is_start else 0  # degenerate, clamped
            if btype == "unbounded_following":
                return None
            if btype == "current":
                return 0
            if unit == "range":
                k = self._range_offset_value(bvalue, key_type)
            else:
                if bvalue is None or not isinstance(
                        bvalue, A.NumericLiteral) \
                        or not bvalue.text.isdigit():
                    raise SemanticError(
                        "frame offsets must be non-negative integer "
                        "literals")
                k = int(bvalue.text)
            return k if btype == "preceding" else -k

        start_t, end_t = frame_ast.start_type, frame_ast.end_type
        if start_t == "unbounded_preceding" and end_t in ("current",
                                                          None):
            # the SQL default running frame (RANGE peers included;
            # ROWS/GROUPS distinguished in the executor)
            if unit == "rows":
                return "rows_unbounded_current", None, None, None
            # RANGE/GROUPS UNBOUNDED PRECEDING..CURRENT ROW both cover
            # partition start through the current peer group's end —
            # exactly the default running frame
            return None, None, None, None
        if unit == "range" \
                and start_t not in ("preceding", "following") \
                and end_t not in ("preceding", "following"):
            # offset-free RANGE bounds (UNBOUNDED/CURRENT ROW) are
            # peer-group positional, identical to the GROUPS frame with
            # 0 standing for CURRENT ROW — no sort-key arithmetic, so
            # multi-key windows are fine (reference RangeFraming
            # special-cases these the same way)
            p = None if start_t == "unbounded_preceding" else 0
            f = None if end_t == "unbounded_following" else 0
            return None, None, None, (p, f)
        # (preceding, following): the frame covers sorted positions /
        # key values / peer groups in [cur - preceding, cur +
        # following], so a start bound negates "following" and an end
        # bound negates "preceding"
        p = bound_offset(start_t, frame_ast.start_value, True)
        if end_t is None:
            f = 0  # 'k PRECEDING' alone means k PRECEDING..CURRENT
        else:
            f = bound_offset(end_t, frame_ast.end_value, False)
            if f is not None:
                f = -f
        if unit == "rows":
            return None, (p, f), None, None
        if unit == "range":
            return None, None, (p, f), None
        return None, None, None, (p, f)

    def _plan_windows(self, qs: QState,
                      calls: list[A.FunctionCall], ctx: ExprCtx,
                      ctes, group_map: dict[ir.Expr, str]) -> None:
        """Plan window functions: calls sharing a (partition, order) spec
        land on one Window node (reference WindowNode merging in
        LogicalPlanner/QueryPlanner.planWindowFunctions)."""
        by_spec: dict[tuple, list[A.FunctionCall]] = {}
        for call in calls:
            spec_key = (call.window.partition_by, call.window.order_by,
                        call.window.frame)
            by_spec.setdefault(spec_key, []).append(call)
        for (_, _, frame_ast), group in by_spec.items():
            w = group[0].window
            part_syms = []
            for pe in w.partition_by:
                p_ir = self._plan_scalar_expr(qs, pe, ctx, ctes, group_map)
                part_syms.append(qs.add_projection(p_ir, "wpart", self))
            orderings = []
            ctx_types = []
            for item in w.order_by:
                o_ir = self._plan_scalar_expr(qs, item.expression, ctx,
                                              ctes, group_map)
                sym = qs.add_projection(o_ir, "worder", self)
                orderings.append(N.Ordering(sym, item.ascending,
                                            item.nulls_first))
                ctx_types.append(o_ir.dtype)
            frame = None
            rows_frame = None
            range_frame = None
            groups_frame = None
            if not w.order_by:
                if frame_ast is not None:
                    raise SemanticError(
                        "window frame requires ORDER BY")
                frame = "full_partition"
            elif frame_ast is not None:
                key_type = (ctx_types[0] if len(orderings) == 1
                            else None)
                frame, rows_frame, range_frame, groups_frame = \
                    self._plan_frame(frame_ast, key_type)
            functions: dict[str, N.WindowCall] = {}
            for call in group:
                fn = call.name
                if fn not in WINDOW_FNS:
                    raise SemanticError(f"unknown window function {fn}")
                if call.distinct:
                    raise SemanticError(
                        "DISTINCT window aggregates are not supported")
                args = tuple(
                    self._plan_scalar_expr(qs, a, ctx, ctes, group_map)
                    for a in call.args)
                if fn in ("lag", "lead") and len(args) > 1 \
                        and not isinstance(args[1], ir.Literal):
                    raise SemanticError(
                        f"{fn} offset must be a literal")
                if fn in ("rank", "dense_rank", "row_number", "count",
                          "ntile"):
                    dtype: T.DataType = T.BIGINT
                elif fn == "sum":
                    dtype = AGG.output_type("sum", args[0].dtype)
                elif fn in ("avg", "percent_rank", "cume_dist"):
                    dtype = T.DOUBLE
                else:
                    dtype = args[0].dtype
                if fn in ("ntile", "nth_value"):
                    pos = 0 if fn == "ntile" else 1
                    if len(args) <= pos or not isinstance(
                            args[pos], ir.Literal):
                        raise SemanticError(
                            f"{fn} bucket/offset must be a literal")
                    v = args[pos].value
                    if not isinstance(v, int) or v <= 0:
                        raise SemanticError(
                            f"{fn} bucket/offset must be a positive "
                            "integer")
                sym = self.symbols.fresh(fn)
                functions[sym] = N.WindowCall(fn, args, dtype, frame,
                                              rows_frame, range_frame,
                                              groups_frame)
                ctx.subquery_syms[call] = ir.ColumnRef(dtype, sym)
            qs.node = N.Window(qs.node, part_syms, orderings, functions)
            qs.scope = Scope(qs.scope.fields + [
                Field(None, None, s, c.dtype)
                for s, c in functions.items()])

    # -- scalar expressions with embedded subqueries ------------------------

    def _plan_scalar_expr(self, qs: QState, e: A.Expression, ctx: ExprCtx,
                          ctes, group_map: dict[ir.Expr, str]) -> ir.Expr:
        for sub in find_subquery_nodes(e):
            if isinstance(sub, A.ScalarSubquery):
                if sub not in ctx.subquery_syms:
                    ctx.subquery_syms[sub] = self._apply_scalar_subquery(
                        qs, sub.query, ctx, ctes)
            else:
                raise SemanticError(
                    "IN/EXISTS subquery outside WHERE/HAVING unsupported")
        ctx = dataclasses.replace(ctx, scope=qs.scope)
        planned = ExprPlanner(ctx).plan(e)
        if group_map:
            planned = rewrite_subtrees(planned, {
                g: ir.ColumnRef(qs.node.output_types()[s], s)
                for g, s in group_map.items()})
        return planned

    # -- predicate application (WHERE/HAVING conjuncts) ---------------------

    def _apply_unnest(self, qs: QState, un: "A.Unnest",
                      alias: str | None, col_aliases: tuple,
                      outer: Scope | None) -> None:
        """LATERAL UNNEST over the joined-so-far relation (reference
        plan/UnnestNode.java planning in RelationPlanner.visitUnnest):
        each array expression projects to a symbol, the Unnest node
        expands rows, output fields take the alias's column names."""
        ctx = ExprCtx(qs.scope, self, outer)
        arr_syms: list[str] = []
        out_syms: list[str] = []
        out_types: dict[str, T.DataType] = {}
        names: list[str] = []
        for expr_ast in un.expressions:
            planned = ExprPlanner(ctx).plan(expr_ast)
            if isinstance(planned.dtype, T.MapType):
                # UNNEST(map) yields (key, value) columns
                ksym = qs.add_projection(
                    ir.Call(T.ArrayType(planned.dtype.key),
                            "map_keys", (planned,)), "unnest_k", self)
                vsym = qs.add_projection(
                    ir.Call(T.ArrayType(planned.dtype.value),
                            "map_values", (planned,)),
                    "unnest_v", self)
                for s, t in ((ksym, planned.dtype.key),
                             (vsym, planned.dtype.value)):
                    arr_syms.append(s)
                    o = self.symbols.fresh("unnest")
                    out_syms.append(o)
                    out_types[o] = t
                    names.append(None)
                continue
            if not isinstance(planned.dtype, T.ArrayType):
                raise SemanticError("UNNEST expects array or map "
                                    f"values, got {planned.dtype}")
            sym = qs.add_projection(planned, "unnest_in", self)
            arr_syms.append(sym)
            o = self.symbols.fresh("unnest")
            out_syms.append(o)
            out_types[o] = planned.dtype.element
            names.append(None)
        ord_sym = (self.symbols.fresh("ordinality")
                   if un.with_ordinality else None)
        qs.node = N.Unnest(qs.node, arr_syms, out_syms, out_types,
                           ord_sym)
        fields = list(qs.scope.fields)
        for i, (o, nm) in enumerate(zip(out_syms, names)):
            name = (col_aliases[i] if i < len(col_aliases)
                    else nm or f"col{i + 1}")
            fields.append(Field(name, alias, o, out_types[o]))
        if ord_sym:
            name = (col_aliases[len(out_syms)]
                    if len(col_aliases) > len(out_syms)
                    else "ordinality")
            fields.append(Field(name, alias, ord_sym, T.BIGINT))
        qs.scope = Scope(fields)
        qs.est = max(qs.est * 4, qs.est)
        qs.unique = []

    def _apply_conjunct(self, qs: QState, c: A.Expression, ctx: ExprCtx,
                        ctes, group_map: dict[ir.Expr, str]) -> None:
        negated = False
        inner = c
        while isinstance(inner, A.NotOp):
            negated = not negated
            inner = inner.operand
        if isinstance(inner, A.InSubquery):
            self._filter_pred(qs, self._mark_in_subquery(
                qs, inner, negated != inner.negated, ctx, ctes))
            return
        if isinstance(inner, A.ExistsPredicate):
            self._apply_exists(qs, inner, negated != inner.negated, ctx,
                               ctes)
            return
        if isinstance(inner, A.LogicalOp) and inner.op == "or" \
                and any(find_subquery_nodes(t) for t in inner.terms):
            # OR over subquery predicates (q10/q35's
            # `exists(ws) or exists(cs)`): plan each subquery term as a
            # MARK (semijoin output boolean) and filter on the OR of
            # the marks — the reference plans every subquery as an
            # ApplyNode mark for the same reason
            preds = tuple(self._term_predicate(qs, t, ctx, ctes,
                                               group_map)
                          for t in inner.terms)
            pred: ir.Expr = ir.Call(T.BOOLEAN, "or", preds)
            if negated:
                pred = ir.Call(T.BOOLEAN, "not", (pred,))
            qs.node = N.Filter(qs.node, pred)
            return
        planned = self._plan_scalar_expr(qs, c, ctx, ctes, group_map)
        qs.node = N.Filter(qs.node, planned)

    def _filter_pred(self, qs: QState, pred: ir.Expr) -> None:
        qs.node = N.Filter(qs.node, pred)

    def _term_predicate(self, qs: QState, t: A.Expression, ctx, ctes,
                        group_map) -> ir.Expr:
        """One OR-term as a boolean IR predicate, planning embedded
        IN/EXISTS subqueries as marks on ``qs``."""
        negated = False
        inner = t
        while isinstance(inner, A.NotOp):
            negated = not negated
            inner = inner.operand
        if isinstance(inner, A.InSubquery):
            return self._mark_in_subquery(
                qs, inner, negated != inner.negated, ctx, ctes)
        if isinstance(inner, A.ExistsPredicate):
            pred = self._mark_exists(
                qs, inner, negated != inner.negated, ctx, ctes)
            if pred is None:
                raise SemanticError(
                    "EXISTS with non-equality correlation is not "
                    "supported inside OR")
            return pred
        return self._plan_scalar_expr(qs, t, ctx, ctes, group_map)

    def _mark_in_subquery(self, qs: QState, e: A.InSubquery,
                          negated: bool, ctx: ExprCtx, ctes) -> ir.Expr:
        operand_ir = self._plan_scalar_expr(qs, e.operand, ctx, ctes, {})
        operand_sym = qs.add_projection(operand_ir, "in_key", self)
        sub = self.plan_query(e.query, ctes, qs.scope)
        corr = getattr(sub, "corr_pairs", [])
        if len(sub.scope.fields) < 1:
            raise SemanticError("IN subquery must output one column")
        value_sym = sub.scope.fields[0].symbol
        src_keys = [operand_sym] + [o for (o, _i, _t) in corr]
        flt_keys = [value_sym] + [i for (_o, i, _t) in corr]
        mark = self.symbols.fresh("semi")
        # NOT IN needs SQL three-valued semantics: a NULL operand or a
        # NULL in the subquery values makes the mark NULL (row dropped
        # by the filter), not FALSE (reference SemiJoinNode semantics)
        qs.node = N.SemiJoin(qs.node, sub.node, src_keys, flt_keys, mark,
                             negated, capacity=_next_pow2(2 * sub.est),
                             null_aware=negated)
        pred: ir.Expr = ir.ColumnRef(T.BOOLEAN, mark)
        if negated:
            pred = ir.Call(T.BOOLEAN, "not", (pred,))
        return pred

    def _mark_exists(self, qs: QState, e: A.ExistsPredicate,
                     negated: bool, ctx: ExprCtx, ctes
                     ) -> ir.Expr | None:
        """EXISTS as a boolean mark predicate, or None when only the
        residual (expanding-join) path can plan it."""
        body = e.query.body
        if not isinstance(body, A.QuerySpec):
            raise SemanticError("EXISTS body must be a SELECT")
        sub_qs = self._plan_from_where(body, ctes, qs.scope, True)
        if sub_qs.residual_corr:
            return None
        return self._mark_exists_planned(qs, sub_qs, negated)

    def _apply_exists(self, qs: QState, e: A.ExistsPredicate,
                      negated: bool, ctx: ExprCtx, ctes) -> None:
        body = e.query.body
        if not isinstance(body, A.QuerySpec):
            raise SemanticError("EXISTS body must be a SELECT")
        sub_qs = self._plan_from_where(body, ctes, qs.scope, True)
        if sub_qs.residual_corr:
            self._apply_exists_residual(qs, sub_qs, negated)
            return
        pred = self._mark_exists_planned(qs, sub_qs, negated)
        qs.node = N.Filter(qs.node, pred)

    def _mark_exists_planned(self, qs: QState, sub_qs: QState,
                             negated: bool) -> ir.Expr:
        corr = sub_qs.corr_pairs
        if not corr:
            cnt = self.symbols.fresh("count")
            agg = N.Aggregate(sub_qs.node, [], {
                cnt: AggCall("count_star", None, T.BIGINT)},
                N.AggStep.SINGLE, capacity=1)
            qs.node = N.CrossJoin(qs.node, agg, scalar=True)
            pred: ir.Expr = ir.Call(
                T.BOOLEAN, "gt", (ir.ColumnRef(T.BIGINT, cnt),
                                  ir.Literal(T.BIGINT, 0)))
            if negated:
                pred = ir.Call(T.BOOLEAN, "not", (pred,))
            return pred
        types = sub_qs.node.output_types()
        inner_syms = [i for (_o, i, _t) in corr]
        proj = N.Project(sub_qs.node, {
            s: ir.ColumnRef(types[s], s) for s in inner_syms})
        mark = self.symbols.fresh("exists")
        qs.node = N.SemiJoin(
            qs.node, proj, [o for (o, _i, _t) in corr], inner_syms, mark,
            negated, capacity=_next_pow2(2 * min(sub_qs.est, 1 << 22)))
        pred = ir.ColumnRef(T.BOOLEAN, mark)
        if negated:
            pred = ir.Call(T.BOOLEAN, "not", (pred,))
        return pred

    def _apply_exists_residual(self, qs: QState, sub_qs: QState,
                               negated: bool) -> None:
        """EXISTS with non-equality correlated predicates (Q21 shape):
        expand-join the outer plan to the inner on the equality pairs with
        the residual as join filter, keep the outer rows' unique key,
        dedupe, and semijoin the outer plan against the surviving keys
        (general decorrelation via many-to-many join + existence mark —
        the reference reaches the same shape via TransformCorrelated*
        rules producing a correlated join then a mark distinct)."""
        key = None
        out_syms = set(qs.node.output_types())
        for k in qs.unique:
            if k <= out_syms:
                key = sorted(k)
                break
        if key is None:
            # no declared unique key: synthesize a row index (the
            # reference's TransformCorrelated* rules lean on row-id
            # semantics of the ApplyNode the same way). q16/q94 probe
            # catalog/web_sales, whose order_number alone is not unique.
            rid = self.symbols.fresh("rowid")
            types0 = qs.node.output_types()
            any_sym = next(iter(types0))
            assigns = {s: ir.ColumnRef(t, s)
                       for s, t in types0.items()}
            assigns[rid] = ir.Call(
                T.BIGINT, "row_index",
                (ir.ColumnRef(types0[any_sym], any_sym),))
            qs.node = N.Project(qs.node, assigns)
            qs.unique = [frozenset([rid])] + list(qs.unique)
            key = [rid]
        criteria = [(o, i) for (o, i, _t) in sub_qs.corr_pairs]
        residual = (sub_qs.residual_corr[0]
                    if len(sub_qs.residual_corr) == 1
                    else ir.Call(T.BOOLEAN, "and",
                                 tuple(sub_qs.residual_corr)))
        expand = N.Join(qs.node, sub_qs.node, N.JoinType.INNER, criteria,
                        residual, build_unique=False,
                        build_rows=sub_qs.est,
                        capacity=_next_pow2(2 * min(sub_qs.est, 1 << 22)))
        types = qs.node.output_types()
        keys_proj = N.Project(expand, {
            s: ir.ColumnRef(types[s], s) for s in key})
        dist = N.Distinct(keys_proj, _next_pow2(2 * min(qs.est, 1 << 22)))
        mark = self.symbols.fresh("exists")
        qs.node = N.SemiJoin(qs.node, dist, key, key, mark, negated,
                             capacity=_next_pow2(2 * min(qs.est, 1 << 22)))
        pred: ir.Expr = ir.ColumnRef(T.BOOLEAN, mark)
        if negated:
            pred = ir.Call(T.BOOLEAN, "not", (pred,))
        qs.node = N.Filter(qs.node, pred)

    def _apply_scalar_subquery(self, qs: QState, q: A.Query,
                               ctx: ExprCtx, ctes) -> ir.Expr:
        body = q.body
        correlated = False
        if isinstance(body, A.QuerySpec):
            # probe for correlation by checking the WHERE references
            probe_qs = None
            try:
                sub = self.plan_query(q, ctes, None)
            except SemanticError:
                correlated = True
                sub = None
            del probe_qs
        else:
            sub = self.plan_query(q, ctes, None)
        if not correlated and sub is not None:
            if len(sub.scope.fields) != 1:
                raise SemanticError(
                    "scalar subquery must return one column")
            f = sub.scope.fields[0]
            qs.node = N.CrossJoin(qs.node, sub.node, scalar=True)
            qs.scope = Scope(qs.scope.fields
                             + [Field(None, None, f.symbol, f.dtype)])
            return ir.ColumnRef(f.dtype, f.symbol)
        # correlated scalar aggregate: decorrelate to group-by + left join
        rp = self.plan_query_spec(body, (), None, 0, ctes, qs.scope,
                                  decorrelate=True)
        corr = getattr(rp, "corr_pairs", [])
        if not corr:
            raise SemanticError("could not plan correlated scalar subquery")
        if len(rp.scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        value_f = rp.scope.fields[0]
        # the decorrelated plan keeps correlation syms hidden in its
        # output projection; join on them
        criteria = [(o, i) for (o, i, _t) in corr]
        qs.node = N.Join(qs.node, rp.node, N.JoinType.LEFT, criteria,
                         None, True, build_rows=rp.est,
                         capacity=_next_pow2(2 * min(rp.est, 1 << 22)))
        qs.scope = Scope(qs.scope.fields
                         + [Field(None, None, value_f.symbol,
                                  value_f.dtype)])
        return ir.ColumnRef(value_f.dtype, value_f.symbol)
