"""Iterative rule-based optimizer.

The analog of the reference's IterativeOptimizer + rule set
(sql/planner/iterative/IterativeOptimizer.java:57,
sql/planner/iterative/rule/*): each Rule pattern-matches one node kind
and returns a replacement subtree or None. The driver applies rules
bottom-up until a full pass changes nothing (fixpoint), with a pass
budget as the lookup-loop guard. No memo structure: plans here are
hundreds of nodes at most and rewrites are cheap dataclass rebuilds —
the memo would cost more than it saves at this scale (the reference
needs one because its exploration is cost-based over alternatives; this
engine's join ordering happens in the planner, plan/planner.py).

Load-bearing rules:
- SimplifyExpressions: constant folding + boolean identities inside
  every expression-bearing node (reference rule/SimplifyExpressions).
- MergeFilters / RemoveTrivialFilter: Filter(Filter) fusion, TRUE
  elimination, FALSE to an empty Values (PruneFilterEmpty analogs).
- PushFilterThroughProject: reorder so filters sit on scans where the
  streaming/pushdown machinery can see them
  (rule/PushPredicateIntoTableScan family).
- MergeProjects: composes adjacent projections by substitution
  (rule/InlineProjections).
- MergeLimits, SortLimitToTopN: Limit(Limit) and Limit(Sort) -> TopN
  (rule/MergeLimits, CreatePartialTopN precursor).
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.plan import nodes as N

MAX_PASSES = 10

_TRUE = ir.Literal(T.BOOLEAN, True)
_FALSE = ir.Literal(T.BOOLEAN, False)


# --- expression simplification ---------------------------------------------

_FOLDABLE_NUMERIC = {
    "add": lambda a, b: a + b,
    "subtract": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
}
_FOLDABLE_CMP = {
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
}


def _is_lit(e: ir.Expr, value=...) -> bool:
    if not isinstance(e, ir.Literal):
        return False
    return value is ... or e.value == value


def simplify_expr(e: ir.Expr) -> ir.Expr:
    """Bottom-up constant folding with SQL three-valued logic kept
    intact: only non-NULL literals fold; NULL-propagating identities
    are left alone unless the result is row-independent."""
    if isinstance(e, ir.Call):
        args = tuple(simplify_expr(a) for a in e.args)
        e = dataclasses.replace(e, args=args)
        fn = e.fn
        if fn == "and":
            kept = []
            for a in args:
                if _is_lit(a, True):
                    continue  # TRUE AND x = x
                if _is_lit(a, False):
                    return _FALSE  # FALSE AND anything = FALSE
                kept.append(a)
            if not kept:
                return _TRUE
            if len(kept) == 1:
                return kept[0]
            return dataclasses.replace(e, args=tuple(kept))
        if fn == "or":
            kept = []
            for a in args:
                if _is_lit(a, False):
                    continue
                if _is_lit(a, True):
                    return _TRUE
                kept.append(a)
            if not kept:
                return _FALSE
            if len(kept) == 1:
                return kept[0]
            return dataclasses.replace(e, args=tuple(kept))
        if fn == "not":
            (a,) = args
            if _is_lit(a, True):
                return _FALSE
            if _is_lit(a, False):
                return _TRUE
            if isinstance(a, ir.Call) and a.fn == "not":
                return a.args[0]
            return e
        if (len(args) == 2 and all(isinstance(a, ir.Literal) for a in args)
                and all(a.value is not None for a in args)):
            a, b = args
            plain = (T.BigintType, T.IntegerType, T.DoubleType,
                     T.BooleanType, T.DateType, T.TimestampType)
            both_str = (isinstance(a.dtype, T.VarcharType)
                        and isinstance(b.dtype, T.VarcharType))
            if both_str and fn in ("eq", "neq"):
                # union-branch discriminators (q11's sale_type = 's')
                # fold so PruneFalseUnionBranch can fire
                return ir.Literal(
                    T.BOOLEAN,
                    bool(_FOLDABLE_CMP[fn](str(a.value), str(b.value))))
            if isinstance(a.dtype, plain) and isinstance(b.dtype, plain):
                if fn in _FOLDABLE_CMP:
                    return ir.Literal(
                        T.BOOLEAN,
                        bool(_FOLDABLE_CMP[fn](a.value, b.value)))
                if fn in _FOLDABLE_NUMERIC and not isinstance(
                        e.dtype, T.DecimalType):
                    try:
                        v = _FOLDABLE_NUMERIC[fn](a.value, b.value)
                    except Exception:
                        return e
                    return ir.Literal(e.dtype, v)
        return e
    if isinstance(e, ir.CaseWhen):
        conds = tuple(simplify_expr(c) for c in e.conditions)
        results = tuple(simplify_expr(r) for r in e.results)
        default = simplify_expr(e.default) if e.default is not None else None
        # drop always-false arms; short-circuit a leading always-true arm
        kept = [(c, r) for c, r in zip(conds, results)
                if not _is_lit(c, False)]
        if kept and _is_lit(kept[0][0], True):
            return kept[0][1]
        if not kept:
            return default if default is not None else ir.Literal(
                e.dtype, None)
        return dataclasses.replace(
            e, conditions=tuple(c for c, _ in kept),
            results=tuple(r for _, r in kept), default=default)
    if isinstance(e, ir.Cast):
        return dataclasses.replace(e, arg=simplify_expr(e.arg))
    if isinstance(e, ir.InList):
        return dataclasses.replace(e, arg=simplify_expr(e.arg))
    if isinstance(e, ir.IsNull):
        arg = simplify_expr(e.arg)
        if isinstance(arg, ir.Literal):
            return ir.Literal(T.BOOLEAN,
                              (arg.value is None) != e.negated)
        return dataclasses.replace(e, arg=arg)
    return e


# --- rules -----------------------------------------------------------------


class Rule:
    """One pattern -> rewrite. apply() returns the replacement node or
    None when the pattern does not match (reference iterative/Rule)."""

    def apply(self, node: N.PlanNode) -> N.PlanNode | None:
        raise NotImplementedError


class SimplifyExpressions(Rule):
    def apply(self, node):
        if isinstance(node, N.Filter):
            p = simplify_expr(node.predicate)
            if p is not node.predicate and p != node.predicate:
                return dataclasses.replace(node, predicate=p)
        elif isinstance(node, N.Project):
            assigns = {s: simplify_expr(e)
                       for s, e in node.assignments.items()}
            if assigns != node.assignments:
                return dataclasses.replace(node, assignments=assigns)
        return None


class RemoveTrivialFilter(Rule):
    def apply(self, node):
        if not isinstance(node, N.Filter):
            return None
        if _is_lit(node.predicate, True):
            return node.source
        # FALSE/NULL predicates are left in place: relations keep a
        # static shape >= 1 row in this engine (see plan/planner.py's
        # Values handling), so an empty Values node is not a valid
        # replacement; the filter is a cheap masked no-op anyway
        return None


class MergeFilters(Rule):
    def apply(self, node):
        if isinstance(node, N.Filter) and isinstance(node.source, N.Filter):
            inner = node.source
            pred = ir.Call(T.BOOLEAN, "and",
                           (inner.predicate, node.predicate))
            return N.Filter(inner.source, pred)
        return None


class PushFilterThroughProject(Rule):
    """Filter(Project) -> Project(Filter) with references substituted,
    so predicates travel toward scans (dynamic filtering and the
    streaming detector both look for scan-adjacent filters)."""

    def apply(self, node):
        if not (isinstance(node, N.Filter)
                and isinstance(node.source, N.Project)):
            return None
        proj = node.source
        pred = ir.rewrite_refs(node.predicate, proj.assignments)
        return dataclasses.replace(
            proj, source=N.Filter(proj.source, pred))


class MergeProjects(Rule):
    """Project(Project) -> one Project by substitution, when every
    outer reference expands something used at most once (no work
    duplication — the reference's InlineProjections makes the same
    single-use check)."""

    def apply(self, node):
        if not (isinstance(node, N.Project)
                and isinstance(node.source, N.Project)):
            return None
        inner = node.source
        # occurrence count, not per-expression set membership: k + k
        # uses k twice and must block inlining of a non-trivial k
        uses: dict[str, int] = {}
        for e in node.assignments.values():
            for sub in ir.walk(e):
                if isinstance(sub, ir.ColumnRef):
                    uses[sub.name] = uses.get(sub.name, 0) + 1
        for s, e in inner.assignments.items():
            if uses.get(s, 0) > 1 and not isinstance(
                    e, (ir.ColumnRef, ir.Literal)):
                return None
        assigns = {s: ir.rewrite_refs(e, inner.assignments)
                   for s, e in node.assignments.items()}
        return N.Project(inner.source, assigns)


class PushFilterThroughUnion(Rule):
    """Filter(Union) -> Union of per-branch filters with references
    remapped (reference rule/PushPredicateThroughUnion /
    ImplementFilteredAggregations family). Together with constant
    folding this statically prunes branches: q11-class CTE legs filter
    a per-branch literal discriminator (sale_type = 's'), so one
    branch's predicate folds to FALSE."""

    def apply(self, node):
        if not (isinstance(node, N.Filter)
                and isinstance(node.source, N.Union)):
            return None
        u = node.source
        new_inputs = []
        for inp, mapping in zip(u.inputs, u.mappings):
            in_types = inp.output_types()
            subst = {out: ir.ColumnRef(in_types[m], m)
                     for out, m in mapping.items()}
            pred = ir.rewrite_refs(node.predicate, subst)
            new_inputs.append(N.Filter(inp, pred))
        return dataclasses.replace(u, inputs=new_inputs)


def _statically_false(node: N.PlanNode) -> bool:
    """Is this subtree provably empty? (a Filter whose predicate folded
    to FALSE or NULL)."""
    if isinstance(node, N.Filter):
        p = node.predicate
        if isinstance(p, ir.Literal) and (p.value is False
                                          or p.value is None):
            return True
        return _statically_false(node.source)
    if isinstance(node, N.Project):
        return _statically_false(node.source)
    return False


class PruneFalseUnionBranch(Rule):
    """Drop union branches that are provably empty; a single surviving
    branch replaces the Union with a renaming Project (reference
    rule/RemoveEmptyUnionBranches)."""

    def apply(self, node):
        if not isinstance(node, N.Union) or len(node.inputs) < 2:
            return None
        keep = [(inp, m) for inp, m in zip(node.inputs, node.mappings)
                if not _statically_false(inp)]
        if len(keep) == len(node.inputs):
            return None
        if not keep:
            keep = [(node.inputs[0], node.mappings[0])]
        if len(keep) == 1:
            inp, mapping = keep[0]
            in_types = inp.output_types()
            return N.Project(inp, {
                out: ir.ColumnRef(in_types[m], m)
                for out, m in mapping.items()})
        return dataclasses.replace(
            node, inputs=[i for i, _ in keep],
            mappings=[m for _, m in keep])


class MergeLimits(Rule):
    def apply(self, node):
        if (isinstance(node, N.Limit) and isinstance(node.source, N.Limit)
                and node.offset == 0 and node.source.offset == 0):
            return N.Limit(node.source.source,
                           min(node.count, node.source.count), 0)
        return None


class SortLimitToTopN(Rule):
    def apply(self, node):
        if (isinstance(node, N.Limit) and node.offset == 0
                and isinstance(node.source, N.Sort)):
            return N.TopN(node.source.source, node.count,
                          node.source.orderings)
        return None


DEFAULT_RULES: tuple[Rule, ...] = (
    SimplifyExpressions(),
    RemoveTrivialFilter(),
    MergeFilters(),
    PushFilterThroughProject(),
    PushFilterThroughUnion(),
    PruneFalseUnionBranch(),
    MergeProjects(),
    MergeLimits(),
    SortLimitToTopN(),
)


def _rebuild(node: N.PlanNode, kids: list[N.PlanNode]) -> N.PlanNode:
    if not kids:
        return node
    if isinstance(node, (N.Join, N.CrossJoin)):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, N.SemiJoin):
        return dataclasses.replace(node, source=kids[0],
                                   filter_source=kids[1])
    if isinstance(node, N.Union):
        return dataclasses.replace(node, inputs=kids)
    return dataclasses.replace(node, source=kids[0])


def apply_rules(plan: N.PlanNode,
                rules: tuple[Rule, ...] = DEFAULT_RULES) -> N.PlanNode:
    """Bottom-up rewrite to fixpoint with a pass budget."""
    for _ in range(MAX_PASSES):
        changed = False

        def walk(node: N.PlanNode) -> N.PlanNode:
            nonlocal changed
            kids = [walk(k) for k in node.sources()]
            if kids and any(k is not o for k, o in
                            zip(kids, node.sources())):
                node = _rebuild(node, kids)
            for rule in rules:
                repl = rule.apply(node)
                if repl is not None:
                    changed = True
                    node = repl
            return node

        plan = walk(plan)
        if not changed:
            break
    return plan
