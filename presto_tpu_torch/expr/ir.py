"""Typed row-expression IR.

Every node carries its SQL result type. The analyzer builds these from AST
expressions; the planner rewrites them; the compiler lowers them to JAX.
Analog of sql/relational/RowExpression.java + SpecialForm.java in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from presto_tpu_torch import types as T


@dataclasses.dataclass(frozen=True)
class Expr:
    dtype: T.DataType


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    """Reference to an input column by symbol name."""

    name: str = ""

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    """A constant. For VARCHAR the value is the raw Python string; it is
    resolved against column dictionaries at compile (trace) time. For
    DECIMAL the value is the *scaled* integer. For DATE, epoch days.
    value=None means typed NULL."""

    value: Any = None

    def __str__(self) -> str:
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Parameter(Expr):
    """A hoisted literal (templates/analysis.py): position ``index`` of
    the plan template's runtime parameter vector. Enters the traced
    program as a device scalar argument, so literal variants of one
    query shape share a compiled executable. Only ever present in
    plans produced by templates.parameterize — the planner/optimizer
    never emit it."""

    index: int = 0

    def __str__(self) -> str:
        return f"?{self.index}"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Scalar function call, including operators (add, eq, and, or, like...).
    Function semantics live in expr/functions.py."""

    fn: str = ""
    args: tuple[Expr, ...] = ()

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class Lambda(Expr):
    """Lambda argument of a higher-order array function. ``params``
    name the element variables; the body references them as ColumnRefs
    with those names (compile binds them to per-element 2D values).
    ``dtype`` is the body's result type."""

    params: tuple[str, ...] = ()
    body: Expr = None  # type: ignore[assignment]

    def __str__(self) -> str:
        return f"({', '.join(self.params)}) -> {self.body}"


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    arg: Expr = None  # type: ignore[assignment]

    def __str__(self) -> str:
        return f"cast({self.arg} as {self.dtype})"


@dataclasses.dataclass(frozen=True)
class CaseWhen(Expr):
    """Searched CASE: WHEN cond THEN value ... ELSE default.
    conditions[i] pairs with results[i]; default may be a typed-NULL
    Literal."""

    conditions: tuple[Expr, ...] = ()
    results: tuple[Expr, ...] = ()
    default: Expr = None  # type: ignore[assignment]

    def __str__(self) -> str:
        parts = " ".join(
            f"when {c} then {r}" for c, r in zip(self.conditions, self.results))
        return f"case {parts} else {self.default} end"


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    """value IN (literals...). Non-literal IN lists lower to OR chains in
    the planner; IN subqueries become semijoins before reaching here."""

    arg: Expr = None  # type: ignore[assignment]
    values: tuple[Literal, ...] = ()

    def __str__(self) -> str:
        return f"{self.arg} in ({', '.join(map(str, self.values))})"


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    arg: Expr = None  # type: ignore[assignment]
    negated: bool = False

    def __str__(self) -> str:
        return f"{self.arg} is {'not ' if self.negated else ''}null"


def walk(expr: Expr):
    """Yield expr and all descendants."""
    yield expr
    if isinstance(expr, Call):
        for a in expr.args:
            yield from walk(a)
    elif isinstance(expr, Cast):
        yield from walk(expr.arg)
    elif isinstance(expr, CaseWhen):
        for c in expr.conditions:
            yield from walk(c)
        for r in expr.results:
            yield from walk(r)
        if expr.default is not None:
            yield from walk(expr.default)
    elif isinstance(expr, InList):
        yield from walk(expr.arg)
        for v in expr.values:
            yield from walk(v)
    elif isinstance(expr, IsNull):
        yield from walk(expr.arg)
    elif isinstance(expr, Lambda):
        yield from walk(expr.body)


def referenced_columns(exprs: Sequence[Expr]) -> set[str]:
    """FREE column references (lambda parameters are bound names)."""
    out: set[str] = set()

    def visit(e: Expr, bound: frozenset) -> None:
        if isinstance(e, ColumnRef):
            if e.name not in bound:
                out.add(e.name)
            return
        if isinstance(e, Lambda):
            visit(e.body, bound | frozenset(e.params))
            return
        if isinstance(e, Call):
            for a in e.args:
                visit(a, bound)
        elif isinstance(e, Cast):
            visit(e.arg, bound)
        elif isinstance(e, CaseWhen):
            for c in e.conditions:
                visit(c, bound)
            for r in e.results:
                visit(r, bound)
            if e.default is not None:
                visit(e.default, bound)
        elif isinstance(e, InList):
            visit(e.arg, bound)
            for v in e.values:
                visit(v, bound)
        elif isinstance(e, IsNull):
            visit(e.arg, bound)

    for e in exprs:
        visit(e, frozenset())
    return out


def rewrite_refs(expr: Expr, mapping: dict[str, Expr]) -> Expr:
    """Substitute ColumnRefs by name (used by pushdown/inlining rules)."""
    if isinstance(expr, ColumnRef):
        return mapping.get(expr.name, expr)
    if isinstance(expr, Call):
        return Call(expr.dtype, expr.fn,
                    tuple(rewrite_refs(a, mapping) for a in expr.args))
    if isinstance(expr, Cast):
        return Cast(expr.dtype, rewrite_refs(expr.arg, mapping))
    if isinstance(expr, CaseWhen):
        return CaseWhen(
            expr.dtype,
            tuple(rewrite_refs(c, mapping) for c in expr.conditions),
            tuple(rewrite_refs(r, mapping) for r in expr.results),
            None if expr.default is None else rewrite_refs(expr.default, mapping),
        )
    if isinstance(expr, InList):
        return InList(expr.dtype, rewrite_refs(expr.arg, mapping), expr.values)
    if isinstance(expr, IsNull):
        return IsNull(expr.dtype, rewrite_refs(expr.arg, mapping), expr.negated)
    if isinstance(expr, Lambda):
        inner = {k: v for k, v in mapping.items()
                 if k not in expr.params}
        return Lambda(expr.dtype, expr.params,
                      rewrite_refs(expr.body, inner))
    return expr
