"""Post-optimization plan invariant validation.

Analog of the reference's PlanSanityChecker pipeline
(sql/planner/sanity/PlanSanityChecker.java, TypeValidator.java,
ValidateDependenciesChecker): every optimized plan is walked before
execution and structural invariants are enforced, so planner/optimizer
bugs surface as PlanSanityError at plan time instead of as trace-time
KeyErrors or silently wrong kernels.

The lint's dispatch-exhaustiveness rule (lint/dispatch.py) checks that
every PlanNode subclass either has a node-specific invariant here or is
listed in DISPATCH_EXEMPT with a reason, so a new node type cannot
silently skip validation.
"""

from __future__ import annotations

from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr import aggmeta as A
from presto_tpu_torch.plan import nodes as N

# node types with no node-specific invariant beyond the generic
# output_symbols/output_types checks every node gets
DISPATCH_EXEMPT = {
    "CrossJoin": "no symbol-referencing fields; the generic "
    "output_types/output_symbols coverage check is the whole contract",
    "Distinct": "pass-through schema with no key list of its own; "
    "the generic output coverage check is the whole contract",
}


class PlanSanityError(RuntimeError):
    pass


def _refs(*exprs) -> set[str]:
    return ir.referenced_columns([e for e in exprs if e is not None])


def validate_plan(plan: N.PlanNode) -> None:
    """Raise PlanSanityError on the first violated invariant."""

    def fail(node, msg):
        raise PlanSanityError(f"{type(node).__name__}: {msg}")

    # -- tree-level: no aliased node objects --------------------------------
    # The same node object appearing twice (a DAG, not a tree) breaks
    # every identity-keyed mechanism: preorder capacity keys
    # (exec/executor.py preorder_index), _replace_node splicing, and
    # EXPLAIN annotations keyed by id(node).
    seen_ids: dict[int, N.PlanNode] = {}

    def check_unique(node: N.PlanNode) -> None:
        if id(node) in seen_ids:
            fail(node, "node object appears twice in the plan tree "
                       "(aliased subtree; planner must copy instead)")
        seen_ids[id(node)] = node
        for s in node.sources():
            check_unique(s)

    check_unique(plan)

    def visit(node: N.PlanNode) -> dict:
        child_types = [visit(s) for s in node.sources()]

        def need(syms, available, what):
            missing = set(syms) - set(available)
            if missing:
                fail(node, f"{what} references unknown columns "
                           f"{sorted(missing)}")

        if isinstance(node, N.TableScan):
            if set(node.assignments) != set(node.types):
                fail(node, "assignment symbols and type map disagree")
        elif isinstance(node, N.Values):
            for i, row in enumerate(node.rows):
                if len(row) != len(node.symbols):
                    fail(node, f"row {i} has {len(row)} values for "
                               f"{len(node.symbols)} symbols")
        elif isinstance(node, N.Filter):
            need(_refs(node.predicate), child_types[0], "predicate")
        elif isinstance(node, N.Project):
            for sym, e in node.assignments.items():
                need(_refs(e), child_types[0], f"assignment {sym}")
        elif isinstance(node, N.Aggregate):
            need(node.group_keys, child_types[0], "group keys")
            for sym, call in node.aggs.items():
                if node.step == N.AggStep.FINAL:
                    # FINAL consumes the PARTIAL step's state columns;
                    # a FINAL spliced over a non-partial input would
                    # silently aggregate garbage
                    missing = [f"{sym}${f}" for f in
                               A.state_fields(call)
                               if f"{sym}${f}" not in child_types[0]]
                    if missing:
                        fail(node, f"FINAL aggregate {sym} is missing "
                                   f"partial state columns {missing} "
                                   "from its input")
                else:
                    need(_refs(call.arg), child_types[0],
                         f"aggregate {sym}")
                    need(_refs(call.arg2), child_types[0],
                         f"aggregate {sym} second argument")
                    if call.mask is not None:
                        need([call.mask], child_types[0],
                             f"aggregate mask of {sym}")
        elif isinstance(node, N.Join):
            lt, rt = child_types
            need([a for a, _ in node.criteria], lt, "probe keys")
            need([b for _, b in node.criteria], rt, "build keys")
            need(_refs(node.filter), {**lt, **rt}, "join filter")
            if not node.criteria and node.filter is None:
                fail(node, "equi-join with no criteria")
        elif isinstance(node, N.MultiJoin):
            if len(node.builds) != len(node.criteria):
                fail(node, f"{len(node.builds)} builds but "
                           f"{len(node.criteria)} criteria lists")
            if not node.builds:
                fail(node, "multi-way join with no builds")
            # probe keys resolve against the spine plus every EARLIER
            # build (the sequential probe walk's visibility rule)
            avail = dict(child_types[0])
            for i, crit in enumerate(node.criteria):
                if not crit:
                    fail(node, f"build {i} has no equi criteria")
                need([pk for pk, _ in crit], avail,
                     f"build {i} probe keys")
                need([bk for _, bk in crit], child_types[i + 1],
                     f"build {i} build keys")
                avail.update(child_types[i + 1])
        elif isinstance(node, N.SemiJoin):
            need(node.source_keys, child_types[0], "source keys")
            need(node.filter_keys, child_types[1], "filter keys")
        elif isinstance(node, N.MarkDistinct):
            need(node.keys, child_types[0], "mark keys")
        elif isinstance(node, (N.Sort, N.TopN)):
            need([o.symbol for o in node.orderings], child_types[0],
                 "orderings")
        elif isinstance(node, N.Limit):
            if node.count < 0 or node.offset < 0:
                fail(node, f"negative count/offset "
                           f"({node.count}, {node.offset})")
        elif isinstance(node, N.Window):
            need(node.partition_by, child_types[0], "partition keys")
            need([o.symbol for o in node.orderings], child_types[0],
                 "window orderings")
            for sym, call in node.functions.items():
                need(_refs(*call.args), child_types[0],
                     f"window function {sym}")
        elif isinstance(node, N.MatchRecognize):
            need(node.partition_by, child_types[0], "partition keys")
            need([o.symbol for o in node.orderings], child_types[0],
                 "pattern orderings")
        elif isinstance(node, N.Unnest):
            need(node.array_syms, child_types[0], "unnest arrays")
            if len(node.out_syms) != len(node.array_syms):
                fail(node, f"{len(node.array_syms)} arrays but "
                           f"{len(node.out_syms)} output symbols")
        elif isinstance(node, N.Exchange):
            need(node.partition_keys, child_types[0], "partition keys")
        elif isinstance(node, N.Union):
            for m, inp_types in zip(node.mappings, child_types):
                for out_sym, in_sym in m.items():
                    if in_sym not in inp_types:
                        fail(node, f"union maps {out_sym} from unknown "
                                   f"column {in_sym}")
        elif isinstance(node, N.Output):
            need(node.symbols, child_types[0], "output columns")
            if len(node.names) != len(node.symbols):
                fail(node, "output name/symbol arity mismatch")

        try:
            types = node.output_types()
        except Exception as exc:  # malformed node
            fail(node, f"output_types failed: {exc}")
        out_syms = list(node.output_symbols)
        if set(out_syms) - set(types):
            fail(node, "output_symbols not covered by output_types")
        return types

    visit(plan)

    # -- PARTIAL/FINAL pairing across exchanges -----------------------------
    # Only meaningful for complete statements (root = Output): worker
    # fragments legitimately END at a PARTIAL aggregate whose states the
    # coordinator finishes. In a full plan, partial states escaping to
    # the client means a fragmenter bug.
    if isinstance(plan, N.Output):
        def check_partials(node: N.PlanNode, under_final: bool) -> None:
            if isinstance(node, N.Aggregate):
                if node.step == N.AggStep.PARTIAL and not under_final:
                    fail(node, "PARTIAL aggregate without a FINAL "
                               "aggregate above it: partial state "
                               "columns would escape to the output")
                if node.step == N.AggStep.FINAL:
                    under_final = True
                elif node.step == N.AggStep.SINGLE:
                    # a SINGLE step re-grounds the subtree: a partial
                    # below it still has nobody merging its states
                    under_final = False
            for s in node.sources():
                check_partials(s, under_final)

        check_partials(plan, False)
