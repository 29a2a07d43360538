"""Grouping-set expansion shared by the planner and the sqlite oracle
dialect (one algorithm, so the engine and its test oracle cannot
disagree). Mirrors the reference's analyzer expansion
(sql/analyzer/StatementAnalyzer.analyzeGroupBy: cross product of
element-wise sets)."""

from __future__ import annotations

import itertools

from presto_tpu_torch.sql import ast as A


def resolve_ordinal(e: A.Expression, spec: A.QuerySpec) -> A.Expression:
    if isinstance(e, A.NumericLiteral):
        return spec.select_items[int(e.text) - 1].expression
    return e


def expand_grouping_sets(spec: A.QuerySpec) -> list[list] | None:
    """None for plain GROUP BY; else the expanded list of grouping sets
    (each a list of AST expressions, ordinals resolved)."""
    if all(g.kind == "simple" for g in spec.group_by):
        return None
    per_element: list[list[list[A.Expression]]] = []
    for g in spec.group_by:
        exprs = [resolve_ordinal(e, spec)
                 for e in (g.expressions if g.kind != "sets" else [])]
        if g.kind == "simple":
            per_element.append([exprs])
        elif g.kind == "rollup":
            per_element.append(
                [exprs[:k] for k in range(len(exprs), -1, -1)])
        elif g.kind == "cube":
            sets = []
            for mask in range(1 << len(exprs)):
                sets.append([e for i, e in enumerate(exprs)
                             if mask >> i & 1])
            per_element.append(sets)
        else:  # explicit GROUPING SETS
            per_element.append(
                [[resolve_ordinal(x, spec) for x in s]
                 for s in g.expressions])
    out: list[list] = []
    for combo in itertools.product(*per_element):
        merged: list = []
        for part in combo:
            for e in part:
                if e not in merged:
                    merged.append(e)
        out.append(merged)
    return out


def rewrite_ast(e, fn, skip=None):
    """Pre-order AST rewrite: fn(node) -> replacement or None to
    recurse; ``skip(node)`` True stops descent into that subtree
    (callers skip aggregate calls so per-branch substitutions never
    touch aggregate inputs)."""
    import dataclasses as _dc
    if not _dc.is_dataclass(e) or isinstance(e, type):
        return e
    repl = fn(e)
    if repl is not None:
        return repl
    if skip is not None and skip(e):
        return e

    def walk_val(v):
        if isinstance(v, tuple):
            return tuple(walk_val(x) for x in v)
        if _dc.is_dataclass(v) and not isinstance(v, type):
            return rewrite_ast(v, fn, skip)
        return v

    changes = {}
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        nv = walk_val(v)
        if nv != v:
            changes[f.name] = nv
    return _dc.replace(e, **changes) if changes else e
