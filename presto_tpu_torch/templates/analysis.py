"""Parameterizability analysis: which literals of an optimized plan
hoist into a plan template's parameter vector. The port of
``presto_tpu/templates/analysis.py``, its hoisting rules unchanged.

The line is drawn per literal occurrence:

* **Hoistable**: comparison and arithmetic operands whose value flows
  straight into tensor ops, so the operators run the same way for
  every value. Numeric, date, timestamp and decimal literals under
  :data:`HOISTABLE_CALL_FNS`, plus VARCHAR literals in eq/neq
  comparisons against a column. Each becomes an ``ir.Parameter`` leaf.

* **Structural**: everything else stays in the plan: literals the
  compiler reads on the host (LIKE and regexp patterns, substring
  bounds, date_trunc units: any scalar that reads ``e.args``),
  LIMIT/TopN counts (plan-node ints), IN-list values, CASE, CAST and
  lambda internals, NULL literals, and decimal *types*.

In eager PyTorch a template is a cache key, not a traced argument:
the program cache and the capacity memory key on the template's
fingerprint, so a literal variant of a query finds the capacities an
earlier variant learned. ``expr/compile.py`` compiles a Parameter
exactly as the literal it replaced, its value read on the host from
the active binding (``templates/runtime.py``).

The rewrite runs on the final optimized plan, walking only the
expression positions the ExprCompiler compiles: Filter predicates,
Project assignments and Join filters. Parameter indices follow the
walk order, so the same SQL shape always yields the same (template
fingerprint, parameter vector) pairing.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.plan import nodes as N

# Scalar fns whose compiled argument values fully determine the result:
# a literal argument of these hoists. Everything else is structural.
# tests/test_torch_templates.py guards this set against expr/compile.py:
# a listed fn must never read ``e.args`` (the IR).
HOISTABLE_CALL_FNS = frozenset({
    "eq", "neq", "lt", "lte", "gt", "gte", "between",
    "add", "subtract", "multiply", "divide", "modulus", "negate",
})

# VARCHAR literals only hoist under these fns: the engine's string
# substrate is dictionary codes, and only equality against a column
# resolves a code through _align_strings (ordering comparisons
# host-evaluate predicates over the dictionary — structural).
STRING_HOISTABLE_FNS = frozenset({"eq", "neq"})

# value dtypes whose physical encoding is value-shape-free
_HOISTABLE_VALUE_TYPES = (
    T.BigintType, T.IntegerType, T.DoubleType, T.DateType,
    T.TimestampType, T.TimeType, T.DecimalType,
)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One hoisted literal: its declared type and this query's value
    (the value rides OUTSIDE the template fingerprint)."""

    dtype: T.DataType
    value: object


@dataclasses.dataclass
class Template:
    """A parameterized plan + this query's ordered parameter vector."""

    plan: N.PlanNode
    params: list[ParamSpec]

    def fingerprint(self) -> str:
        from presto_tpu_torch.plan.fingerprint import plan_fingerprint
        return plan_fingerprint(self.plan)

    def example_args(self) -> list:
        """The physical value of each parameter with no dictionary
        bound (a VARCHAR parameter's code is -1): the shapes and dtypes
        every binding of this template has."""
        from presto_tpu_torch.templates.runtime import bind_values
        return bind_values(self.params, {})

    def bind(self, bindings: dict | None) -> list:
        """The physical encoding of each parameter, string codes
        resolved through ``bindings`` (parameter index -> the
        dictionary of the column it is compared against)."""
        from presto_tpu_torch.templates.runtime import bind_values
        return bind_values(self.params, bindings)


def _hoistable(lit: ir.Literal, call: ir.Call) -> bool:
    if lit.value is None:
        return False  # typed NULL: validity shape is structural
    if isinstance(lit.dtype, T.VarcharType):
        if call.fn not in STRING_HOISTABLE_FNS:
            return False
        # a code parameter needs a real column side to bind against
        return any(not isinstance(a, (ir.Literal, ir.Parameter))
                   for a in call.args)
    if not isinstance(lit.dtype, _HOISTABLE_VALUE_TYPES):
        return False
    return call.fn in HOISTABLE_CALL_FNS


class _Rewriter:
    def __init__(self):
        self.params: list[ParamSpec] = []

    # -- expressions --------------------------------------------------------

    def expr(self, e: ir.Expr, call: ir.Call | None = None) -> ir.Expr:
        """Rewrite one expression; ``call`` is the immediate enclosing
        Call when it admits hoisting, else None."""
        if isinstance(e, ir.Literal):
            if call is not None and _hoistable(e, call):
                self.params.append(ParamSpec(e.dtype, e.value))
                return ir.Parameter(e.dtype, len(self.params) - 1)
            return e
        if isinstance(e, ir.Call):
            ctx = e if e.fn in HOISTABLE_CALL_FNS else None
            args = tuple(self.expr(a, ctx) for a in e.args)
            if args == e.args:
                return e
            return ir.Call(e.dtype, e.fn, args)
        if isinstance(e, ir.Cast):
            arg = self.expr(e.arg)
            return e if arg is e.arg else ir.Cast(e.dtype, arg)
        if isinstance(e, ir.CaseWhen):
            conds = tuple(self.expr(c) for c in e.conditions)
            results = tuple(self.expr(r) for r in e.results)
            default = (None if e.default is None
                       else self.expr(e.default))
            if (conds == e.conditions and results == e.results
                    and default is e.default):
                return e
            return ir.CaseWhen(e.dtype, conds, results, default)
        if isinstance(e, ir.InList):
            arg = self.expr(e.arg)  # values stay baked (shape the trace)
            return e if arg is e.arg else ir.InList(e.dtype, arg,
                                                    e.values)
        if isinstance(e, ir.IsNull):
            arg = self.expr(e.arg)
            return e if arg is e.arg else ir.IsNull(e.dtype, arg,
                                                    e.negated)
        # Lambda bodies (and any future Expr kind) stay untouched:
        # higher-order kernels re-enter compilation host-side
        return e

    # -- plan ---------------------------------------------------------------

    def node(self, node: N.PlanNode) -> N.PlanNode:
        updates: dict = {}
        if isinstance(node, N.Filter):
            pred = self.expr(node.predicate)
            if pred is not node.predicate:
                updates["predicate"] = pred
        elif isinstance(node, N.Project):
            assigns = {s: self.expr(e)
                       for s, e in node.assignments.items()}
            if any(assigns[s] is not node.assignments[s]
                   for s in assigns):
                updates["assignments"] = assigns
        elif isinstance(node, N.Join) and node.filter is not None:
            filt = self.expr(node.filter)
            if filt is not node.filter:
                updates["filter"] = filt
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, N.PlanNode):
                nv = self.node(v)
                if nv is not v:
                    updates[f.name] = nv
            elif isinstance(v, list) and v and isinstance(v[0],
                                                          N.PlanNode):
                nl = [self.node(x) for x in v]
                if any(a is not b for a, b in zip(nl, v)):
                    updates[f.name] = nl
        return dataclasses.replace(node, **updates) if updates else node


def _has_match_recognize(node: N.PlanNode) -> bool:
    if isinstance(node, N.MatchRecognize):
        return True
    return any(_has_match_recognize(s) for s in node.sources())


def parameterize(plan: N.PlanNode) -> Template | None:
    """Hoist every hoistable literal of ``plan`` into an ordered
    parameter vector. Returns None when nothing hoists (the plan keys
    the program cache as-is) or when the plan contains host-evaluated
    regions (MATCH_RECOGNIZE defines run outside the trace)."""
    if _has_match_recognize(plan):
        return None
    rw = _Rewriter()
    tplan = rw.node(plan)
    if not rw.params:
        return None
    return Template(tplan, rw.params)
