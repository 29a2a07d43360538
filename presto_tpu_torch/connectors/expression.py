"""Connector expression pushdown IR (reference
spi/expression/ConnectorExpression.java + ConnectorMetadata.applyFilter).

A deliberately small, connector-facing predicate language: per-column
comparisons against constants, conjunctions of them. The optimizer
offers a scan's filter conjuncts in this form; a connector may use them
to SKIP DATA IT CAN PROVE IRRELEVANT (parquet row-group min/max
pruning, partition elimination). Skipping is a superset guarantee — the
engine keeps the full filter above the scan, so connectors never need
to evaluate predicates exactly, only conservatively.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ColumnExpr:
    """A reference to the connector's column (source column NAME, not
    the plan symbol)."""

    column: str


@dataclasses.dataclass(frozen=True)
class ConstantExpr:
    """A literal in the column's PHYSICAL domain (dates as epoch days,
    decimals as scaled ints)."""

    value: object


@dataclasses.dataclass(frozen=True)
class ComparisonExpr:
    """column <op> constant, op in =, <>, <, <=, >, >=."""

    op: str
    column: ColumnExpr
    constant: ConstantExpr


def scan_conjuncts(predicate, assignments: dict[str, str]):
    """Extract pushable ComparisonExprs from a Filter predicate over a
    scan. ``assignments`` maps plan symbols -> connector column names.
    Unrecognized conjuncts are simply not offered (the full filter
    still runs above the scan)."""
    from presto_tpu_torch.expr import ir

    out: list[ComparisonExpr] = []

    def walk(e):
        if isinstance(e, ir.Call) and e.fn == "and":
            for a in e.args:
                walk(a)
            return
        if isinstance(e, ir.Call) and e.fn in (
                "eq", "neq", "lt", "lte", "gt", "gte"):
            a, b = e.args
            if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Literal):
                a, b = b, a
                flip = {"lt": "gt", "lte": "gte",
                        "gt": "lt", "gte": "lte"}
                fn = flip.get(e.fn, e.fn)
            elif isinstance(a, ir.ColumnRef) and isinstance(
                    b, ir.Literal):
                fn = e.fn
            else:
                return
            col = assignments.get(a.name)
            if col is None or b.value is None:
                return
            if not isinstance(b.value, (int, float)):
                return
            op = {"eq": "=", "neq": "<>", "lt": "<", "lte": "<=",
                  "gt": ">", "gte": ">="}[fn]
            out.append(ComparisonExpr(op, ColumnExpr(col),
                                      ConstantExpr(b.value)))

    walk(predicate)
    return out
