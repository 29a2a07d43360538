"""Filter selectivity estimation over planned IR.

The load-bearing slice of the reference's stats/cost subsystem
(cost/FilterStatsCalculator.java, cost/StatsCalculator.java): predicate
conjuncts on a relation scale its cardinality estimate before join
ordering, hash-table capacity sizing, and broadcast-vs-partitioned
decisions. Estimates use per-symbol NDV and value ranges from connector
stats; anything unrecognized falls back to Trino's unknown-filter
coefficient.

Capacities derived from these estimates are rounded to power-of-two
buckets by the callers (ops/hash.next_pow2), so similar inputs compile
identical programs — the compiled-program cache (exec/executor.py)
depends on estimates being coarse, not exact.
"""

from __future__ import annotations

from presto_tpu_torch.expr import ir

# reference cost/FilterStatsCalculator.java UNKNOWN_FILTER_COEFFICIENT
UNKNOWN_FILTER_COEFFICIENT = 0.9


def selectivity(expr: ir.Expr, ndv: dict[str, int],
                ranges: dict[str, tuple[float, float]]) -> float:
    """Estimated fraction of rows satisfying ``expr`` (0 < f <= 1)."""
    return max(min(_sel(expr, ndv, ranges), 1.0), 1e-9)


def _literal_number(e: ir.Expr, col: ir.ColumnRef | None = None):
    """Numeric literal value in the COLUMN's physical units. Connector
    ranges are physical (decimals are scaled integers), while a
    literal's value is scaled to the LITERAL's own type — ``30``
    against a decimal(12,2) column must interpolate as 3000, not 30
    (the l_quantity < 30 est-1-row divergence PR 8's ledger exposed:
    the un-scaled literal fell below the range's low bound and the
    fraction clamped to a near-zero floor, a 17000x miss)."""
    if not (isinstance(e, ir.Literal)
            and isinstance(e.value, (int, float))
            and not isinstance(e.value, bool)):
        return None
    v = float(e.value)
    col_scale = getattr(col.dtype, "scale", None) if col is not None \
        else None
    if col_scale:
        lit_scale = getattr(e.dtype, "scale", 0) or 0
        v *= 10.0 ** (col_scale - lit_scale)
    return v


def _col_and_lit(args):
    a, b = args
    if isinstance(a, ir.ColumnRef):
        lit = _literal_number(b, a)
        if lit is not None:
            return a, lit, False
    if isinstance(b, ir.ColumnRef):
        lit = _literal_number(a, b)
        if lit is not None:
            return b, lit, True
    return None, None, False


def _range_fraction(col: str, lit: float, op: str,
                    ranges: dict[str, tuple[float, float]]):
    r = ranges.get(col)
    if r is None:
        return None
    lo, hi = float(r[0]), float(r[1])
    if hi <= lo:
        return None
    span = hi - lo
    if op in ("lt", "lte"):
        return (lit - lo) / span
    return (hi - lit) / span  # gt / gte


def selectivity_informed(expr: ir.Expr, ndv: dict,
                         ranges: dict) -> bool:
    """Did the static rule estimate ``expr`` from real, LITERAL-AWARE
    statistics (NDV quotients, range interpolation)? Gates the
    divergence-ledger feedback (cost/stats.py): the ledger pools one
    average over every literal variant of a shape, so overriding a
    value-aware interpolation with the literal-blind pooled mean would
    un-fix exactly the estimates the range rule gets right."""
    def informed(e) -> bool:
        if not isinstance(e, ir.Call):
            return False
        fn = e.fn
        if fn in ("and", "or"):
            return any(informed(a) for a in e.args)
        if fn == "not":
            return informed(e.args[0])
        if fn in ("eq", "neq") and len(e.args) == 2:
            col, lit, _sw = _col_and_lit(e.args)
            return col is not None and bool(ndv.get(col.name))
        if fn in ("lt", "lte", "gt", "gte") and len(e.args) == 2:
            col, lit, _sw = _col_and_lit(e.args)
            return col is not None and col.name in ranges
        if fn == "between" and len(e.args) == 3:
            col = e.args[0]
            return isinstance(col, ir.ColumnRef) and col.name in ranges
        if fn == "in" and len(e.args) >= 2:
            col = e.args[0]
            return (isinstance(col, ir.ColumnRef)
                    and bool(ndv.get(col.name)))
        # like/is_null/unknown functions: fixed priors, no literal
        # sensitivity — measured reality may replace them
        return False

    return informed(expr)


def _sel(expr: ir.Expr, ndv, ranges) -> float:
    if not isinstance(expr, ir.Call):
        return UNKNOWN_FILTER_COEFFICIENT
    fn = expr.fn
    if fn == "and":
        out = 1.0
        for a in expr.args:
            out *= _sel(a, ndv, ranges)
        return out
    if fn == "or":
        out = 0.0
        for a in expr.args:
            s = _sel(a, ndv, ranges)
            out = out + s - out * s  # independence union
        return out
    if fn == "not":
        return 1.0 - _sel(expr.args[0], ndv, ranges)
    if fn == "eq" and len(expr.args) == 2:
        col, lit, _sw = _col_and_lit(expr.args)
        if col is not None:
            nd = ndv.get(col.name)
            if nd:
                return 1.0 / nd
        return UNKNOWN_FILTER_COEFFICIENT * 0.5
    if fn == "neq" and len(expr.args) == 2:
        col, lit, _sw = _col_and_lit(expr.args)
        if col is not None:
            nd = ndv.get(col.name)
            if nd:
                return 1.0 - 1.0 / nd
        return UNKNOWN_FILTER_COEFFICIENT
    if fn in ("lt", "lte", "gt", "gte") and len(expr.args) == 2:
        col, lit, swapped = _col_and_lit(expr.args)
        if col is not None:
            op = fn
            if swapped:  # lit < col  ==  col > lit
                op = {"lt": "gt", "lte": "gte",
                      "gt": "lt", "gte": "lte"}[fn]
            f = _range_fraction(col.name, lit, op, ranges)
            if f is not None:
                return max(min(f, 1.0), 0.0)
        return UNKNOWN_FILTER_COEFFICIENT * 0.5
    if fn == "between" and len(expr.args) == 3:
        col = expr.args[0]
        if not isinstance(col, ir.ColumnRef):
            return 0.25
        lo = _literal_number(expr.args[1], col)
        hi = _literal_number(expr.args[2], col)
        if isinstance(col, ir.ColumnRef) and lo is not None \
                and hi is not None:
            f_lo = _range_fraction(col.name, lo, "gte", ranges)
            f_hi = _range_fraction(col.name, hi, "lte", ranges)
            if f_lo is not None and f_hi is not None:
                return max(min(f_lo + f_hi - 1.0, 1.0), 0.0)
        return 0.25
    if fn == "in" and len(expr.args) >= 2:
        col = expr.args[0]
        if isinstance(col, ir.ColumnRef):
            nd = ndv.get(col.name)
            if nd:
                return min(float(len(expr.args) - 1) / nd, 1.0)
        return 0.25
    if fn == "like":
        return 0.25
    if fn == "is_null":
        return 0.1
    if fn == "is_not_null":
        return 0.9
    return UNKNOWN_FILTER_COEFFICIENT
