"""Logical plan optimizer passes.

The reference runs ~90 optimizer passes (sql/planner/PlanOptimizers.java)
over an iterative rule engine. The load-bearing rewrites for this engine's
plans happen partly at plan time (join-graph ordering, predicate
placement, decorrelation — see plan/planner.py); the passes here run on
the finished plan:

- prune_columns: projection pushdown all the way into table scans
  (reference PruneUnreferencedOutputs + PushProjectionIntoTableScan) —
  critical on TPU since every scanned column is an HBM-resident array.
- inline_trivial_projects: collapse identity Project nodes
  (reference RemoveRedundantIdentityProjections).
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.expr import ir
from presto_tpu_torch.plan import nodes as N


def optimize(plan: N.PlanNode, engine,
             enable_latemat: bool | None = None) -> N.PlanNode:
    from presto_tpu_torch.cost.reorder import reorder_joins
    from presto_tpu_torch.plan.dense import annotate_dense
    from presto_tpu_torch.plan.latemat import late_materialize
    from presto_tpu_torch.plan.rules import apply_rules
    plan = apply_rules(plan)
    plan = prune_columns(plan)
    plan = inline_trivial_projects(plan)
    # cost-based join reordering over the pruned shapes (session
    # optimizer_join_reordering_strategy; cost/reorder.py) — before
    # scan-filter pushdown so connector stats still see plain table
    # names, and before dense/latemat so their annotations apply to
    # the final join order
    plan = reorder_joins(plan, engine)
    # star-schema fusion over the reordered spine (session
    # multiway_join; AUTOMATIC reordering only — NONE means "leave
    # plans exactly as planned" and ELIMINATE_CROSS_JOINS promises the
    # planner's binary shape)
    plan = collapse_multiway(plan, engine)
    # physical-choice annotation needs final plan shapes; late
    # materialization needs its fd_keys annotations, then re-prunes (the
    # narrowed aggregate source drops dependent columns) and
    # re-annotates (its new re-join gets a dense hint)
    plan = push_scan_filters(plan, engine)
    plan = annotate_dense(plan, engine)
    enabled = enable_latemat
    if enabled is None:
        session = getattr(engine, "session", None)
        enabled = (bool(session.get("enable_late_materialization"))
                   if session is not None else True)
    lm = late_materialize(plan, engine) if enabled else plan
    if lm is not plan:
        plan = prune_columns(lm)
        plan = inline_trivial_projects(plan)
        plan = annotate_dense(plan, engine)
    return plan


# ---------------------------------------------------------------------------

# fewest collapsible joins before fusion pays: 2-join chains (Q3-class)
# already fit one compiled program (exec/executor.MAX_JOINS_PER_PROGRAM)
# and keep the battle-tested binary path
MIN_MULTIWAY_CHAIN = 3


def _collapsible(node: N.PlanNode) -> bool:
    """A chain link the multi-way fusion may absorb: INNER, equi-only,
    unique-build, residual-free — exactly the shape whose cascade the
    fused sequential probe walk reproduces row for row."""
    return (isinstance(node, N.Join)
            and node.join_type == N.JoinType.INNER
            and bool(node.criteria) and node.filter is None
            and node.build_unique)


def collapse_multiway(plan: N.PlanNode, engine) -> N.PlanNode:
    """Collapse left-deep chains of >= MIN_MULTIWAY_CHAIN INNER
    unique-build equi-joins sharing one probe spine (the star-schema
    shape cost/reorder.py emits for Q5/Q9) into a single
    :class:`~presto_tpu_torch.plan.nodes.MultiJoin` — the TrieJax-style
    fused multi-way operator. Gated on session ``multiway_join`` and
    AUTOMATIC join reordering; annotations (pow2 build_rows, explicit
    distributions, skew refinements) carry over per build so the
    distributed lowering makes the same choices the cascade would."""
    session = getattr(engine, "session", None)
    if session is None:
        return plan
    try:
        enabled = bool(session.get("multiway_join"))
        strategy = str(session.get("optimizer_join_reordering_strategy")
                       or "AUTOMATIC").upper()
    except KeyError:
        return plan
    if not enabled or strategy != "AUTOMATIC":
        return plan

    def visit(node: N.PlanNode) -> N.PlanNode:
        if not _collapsible(node):
            return node
        # bottom-up walk: the first MIN_MULTIWAY_CHAIN links fuse from
        # scratch; every collapsible link above then absorbs into the
        # already-fused MultiJoin on its probe side
        if isinstance(node.left, N.MultiJoin):
            mj = node.left
            return dataclasses.replace(
                mj,
                builds=mj.builds + [node.right],
                criteria=mj.criteria + [list(node.criteria)],
                build_rows=mj.build_rows + [node.build_rows],
                distributions=mj.distributions + [_leg_dist(node)])
        chain: list[N.Join] = []
        cur: N.PlanNode = node
        while _collapsible(cur):
            chain.append(cur)
            cur = cur.left
        if len(chain) < MIN_MULTIWAY_CHAIN:
            return node
        chain.reverse()  # bottom-up: chain[0].left is the spine
        return N.MultiJoin(
            spine=cur,
            builds=[j.right for j in chain],
            criteria=[list(j.criteria) for j in chain],
            build_rows=[j.build_rows for j in chain],
            distributions=[_leg_dist(j) for j in chain])

    return N.rewrite_bottom_up(plan, visit)


def _leg_dist(j: N.Join) -> str:
    """A fused leg's distribution: the MultiJoin lowering has no
    hybrid/salt machinery (the spine repartitions at most once, up
    front), so a skew-refined "hybrid" leg honestly becomes
    "partitioned" — EXPLAIN must not claim a hot-key path that will
    not run."""
    return "partitioned" if j.distribution == "hybrid" \
        else j.distribution


def unfuse_multijoin(plan: N.PlanNode) -> N.PlanNode:
    """Inverse of :func:`collapse_multiway`: expand every MultiJoin
    back into its left-deep cascade of binary INNER unique-build
    joins. The memory-pressure spill driver (exec/spill.py) partitions
    a root-chain ``Join`` by its keys — under an enforced memory
    budget that machinery outranks fusion, so over-budget fused plans
    de-fuse and spill instead of failing."""

    def visit(node: N.PlanNode) -> N.PlanNode:
        if not isinstance(node, N.MultiJoin):
            return node
        cur: N.PlanNode = node.spine
        for i, (build, crit) in enumerate(zip(node.builds,
                                              node.criteria)):
            cur = N.Join(
                cur, build, N.JoinType.INNER, list(crit), None, True,
                distribution=(node.distributions[i]
                              if i < len(node.distributions)
                              else "automatic"),
                build_rows=(node.build_rows[i]
                            if i < len(node.build_rows) else None))
        return cur

    return N.rewrite_bottom_up(plan, visit)


def substitute_materialized(plan: N.PlanNode,
                            replacements: dict[int, N.PlanNode]
                            ) -> N.PlanNode:
    """Remainder construction for mid-query re-planning
    (parallel/adaptive.py): rebuild ``plan`` with each node in
    ``replacements`` (keyed by ``id(node)``) swapped for its
    replacement — an ``__exchange__`` carrier scan standing in for an
    already-materialized stage output. Top-down and identity-keyed:
    the OUTERMOST completed subtree wins, so a stage nested inside
    another completed stage's subtree never double-substitutes."""

    def visit(node: N.PlanNode) -> N.PlanNode:
        hit = replacements.get(id(node))
        if hit is not None:
            return hit
        updates = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, N.PlanNode):
                nv = visit(v)
                if nv is not v:
                    updates[f.name] = nv
            elif isinstance(v, list) and v \
                    and isinstance(v[0], N.PlanNode):
                nv = [visit(x) for x in v]
                if any(a is not b for a, b in zip(nv, v)):
                    updates[f.name] = nv
        return dataclasses.replace(node, **updates) if updates else node

    return visit(plan)


def adapt_remainder(plan: N.PlanNode,
                    replacements: dict[int, N.PlanNode],
                    engine) -> N.PlanNode:
    """Sub-plan re-optimization for the within-query feedback loop:
    substitute already-materialized stage outputs as carrier-scan
    leaves, then give the multi-way fusion decision a second chance —
    every MultiJoin in the remainder expands back into its binary
    cascade (so the re-annotation pass, cost/adapt.reannotate, can
    re-decide each leg's distribution from ACTUALS) and
    :func:`collapse_multiway` re-fuses exactly the chains that still
    qualify. A spine estimate that was wrong therefore de-fuses (one
    leg now rides the partitioned cut) or re-fuses (all legs turned
    out broadcast-sized) mid-flight, with annotations carrying over
    per leg either way."""
    plan = substitute_materialized(plan, replacements)
    return unfuse_multijoin(plan)


def refuse_multiway(plan: N.PlanNode, engine) -> N.PlanNode:
    """The re-fusion half of :func:`adapt_remainder`, applied AFTER
    the remainder's annotations have been re-derived from actuals
    (cost/adapt.reannotate) so the fused legs carry corrected
    build_rows/distributions."""
    return collapse_multiway(plan, engine)


def _expr_refs(*exprs) -> set[str]:
    out: set[str] = set()
    for e in exprs:
        if e is not None:
            out |= ir.referenced_columns([e])
    return out


def prune_columns(node: N.PlanNode,
                  needed: set[str] | None = None) -> N.PlanNode:
    """Rebuild the plan keeping only symbols consumed above each node."""
    if isinstance(node, N.Output):
        src = prune_columns(node.source, set(node.symbols))
        return N.Output(src, node.names, node.symbols)

    assert needed is not None

    if isinstance(node, N.TableScan):
        assigns = {s: c for s, c in node.assignments.items() if s in needed}
        if not assigns:  # keep one column to preserve cardinality
            first = next(iter(node.assignments))
            assigns = {first: node.assignments[first]}
        types = {s: node.types[s] for s in assigns}
        return N.TableScan(node.catalog, node.table, assigns, types)

    if isinstance(node, N.Values):
        keep_idx = [i for i, s in enumerate(node.symbols)
                    if s in needed] or [0]
        symbols = [node.symbols[i] for i in keep_idx]
        types = {s: node.types[s] for s in symbols}
        rows = [[row[i] for i in keep_idx] for row in node.rows]
        return N.Values(symbols, types, rows)

    if isinstance(node, N.Filter):
        src = prune_columns(node.source,
                            needed | _expr_refs(node.predicate))
        return N.Filter(src, node.predicate)

    if isinstance(node, N.Project):
        assigns = {s: e for s, e in node.assignments.items() if s in needed}
        if not assigns:
            first = next(iter(node.assignments))
            assigns = {first: node.assignments[first]}
        src = prune_columns(node.source, _expr_refs(*assigns.values()))
        return N.Project(src, assigns)

    if isinstance(node, N.Aggregate):
        aggs = {s: c for s, c in node.aggs.items()
                if node.step == N.AggStep.PARTIAL or s in needed}
        child = set(node.group_keys) | _expr_refs(
            *[c.arg for c in aggs.values() if c.arg is not None],
            *[c.arg2 for c in aggs.values() if c.arg2 is not None])
        child |= {c.mask for c in aggs.values() if c.mask is not None}
        # varlen aggregates order within the group by a source column
        child |= {c.order_sym for c in aggs.values()
                  if getattr(c, "order_sym", None) is not None}
        if node.step == N.AggStep.FINAL:
            from presto_tpu_torch.expr import aggmeta as AGG
            for s, c in aggs.items():
                child |= {f"{s}${f}" for f in AGG.state_fields(c)}
        src = prune_columns(node.source, child)
        return dataclasses.replace(node, source=src, aggs=aggs)

    if isinstance(node, N.Join):
        crit_l = {a for a, _ in node.criteria}
        crit_r = {b for _, b in node.criteria}
        refs = _expr_refs(node.filter)
        lsyms = set(node.left.output_types())
        left = prune_columns(node.left,
                             (needed | crit_l | refs) & lsyms | crit_l)
        rsyms = set(node.right.output_types())
        right = prune_columns(node.right,
                              (needed | crit_r | refs) & rsyms | crit_r)
        return dataclasses.replace(node, left=left, right=right)

    if isinstance(node, N.MultiJoin):
        # a probe key belongs to the spine or to the EARLIER build that
        # produced it; each build additionally keeps its own build keys
        owner: dict[str, int] = {}
        for s in node.spine.output_types():
            owner[s] = 0
        for i, b in enumerate(node.builds):
            for s in b.output_types():
                owner[s] = i + 1
        extra: list[set] = [set() for _ in range(len(node.builds) + 1)]
        for i, crit in enumerate(node.criteria):
            for pk, bk in crit:
                extra[owner[pk]].add(pk)
                extra[i + 1].add(bk)
        spine = prune_columns(
            node.spine,
            (needed & set(node.spine.output_types())) | extra[0])
        builds = [
            prune_columns(b, (needed & set(b.output_types()))
                          | extra[i + 1])
            for i, b in enumerate(node.builds)]
        return dataclasses.replace(node, spine=spine, builds=builds)

    if isinstance(node, N.SemiJoin):
        src = prune_columns(node.source,
                            needed | set(node.source_keys))
        flt = prune_columns(node.filter_source, set(node.filter_keys))
        return dataclasses.replace(node, source=src, filter_source=flt)

    if isinstance(node, N.CrossJoin):
        lsyms = set(node.left.output_types())
        rsyms = set(node.right.output_types())
        left = prune_columns(node.left, needed & lsyms)
        right = prune_columns(node.right, needed & rsyms)
        return dataclasses.replace(node, left=left, right=right)

    if isinstance(node, N.Window):
        funcs = {s: c for s, c in node.functions.items() if s in needed}
        child = (needed - set(funcs)) | set(node.partition_by) \
            | {o.symbol for o in node.orderings} \
            | _expr_refs(*[a for c in funcs.values() for a in c.args])
        child &= set(node.source.output_types())
        src = prune_columns(node.source, child)
        return dataclasses.replace(node, source=src, functions=funcs)

    if isinstance(node, (N.Sort, N.TopN)):
        child = needed | {o.symbol for o in node.orderings}
        src = prune_columns(node.source, child)
        return dataclasses.replace(node, source=src)

    if isinstance(node, N.Limit):
        return dataclasses.replace(
            node, source=prune_columns(node.source, needed))

    if isinstance(node, N.Distinct):
        # distinct semantics depend on every input column
        src = prune_columns(node.source,
                            set(node.source.output_types()))
        return dataclasses.replace(node, source=src)

    if isinstance(node, N.MarkDistinct):
        src = prune_columns(
            node.source, (needed - {node.mark_symbol}) | set(node.keys))
        return dataclasses.replace(node, source=src)

    if isinstance(node, N.Union):
        keep = [s for s in node.symbols if s in needed] or node.symbols[:1]
        inputs = []
        mappings = []
        for inp, m in zip(node.inputs, node.mappings):
            sub_needed = {m[s] for s in keep}
            inputs.append(prune_columns(inp, sub_needed))
            mappings.append({s: m[s] for s in keep})
        return N.Union(inputs, keep, {s: node.types[s] for s in keep},
                       mappings)

    if isinstance(node, N.Exchange):
        src = prune_columns(node.source,
                            needed | set(node.partition_keys))
        return dataclasses.replace(node, source=src)

    if isinstance(node, N.Unnest):
        child = (needed - set(node.out_syms)
                 - ({node.ordinality_sym} if node.ordinality_sym
                    else set())) | set(node.array_syms)
        child &= set(node.source.output_types())
        src = prune_columns(node.source, child)
        return dataclasses.replace(node, source=src)

    if isinstance(node, N.MatchRecognize):
        sub = set(node.partition_by)
        sub |= {o.symbol for o in node.orderings}
        exprs = list(node.defines.values()) + [
            e for _s, _k, e, _t in node.measures if e is not None]
        # $prev columns are synthesized at execution from their base
        for ref in _expr_refs(*exprs):
            sub.add(ref.rsplit("$prev", 1)[0] if "$prev" in ref
                    else ref)
        src = prune_columns(node.source, sub)
        return dataclasses.replace(node, source=src)

    raise NotImplementedError(f"prune_columns: {type(node).__name__}")


def inline_trivial_projects(node: N.PlanNode) -> N.PlanNode:
    """Remove Project nodes that are identity mappings."""
    rebuilt = node
    kids = node.sources()
    if kids:
        new_kids = [inline_trivial_projects(k) for k in kids]
        if isinstance(node, N.Output):
            rebuilt = dataclasses.replace(node, source=new_kids[0])
        elif isinstance(node, (N.Filter, N.Project, N.Aggregate, N.Sort,
                               N.TopN, N.Limit, N.Distinct, N.Exchange,
                               N.Window, N.MarkDistinct, N.Unnest)):
            rebuilt = dataclasses.replace(node, source=new_kids[0])
        elif isinstance(node, (N.Join, N.CrossJoin)):
            rebuilt = dataclasses.replace(node, left=new_kids[0],
                                          right=new_kids[1])
        elif isinstance(node, N.MultiJoin):
            rebuilt = dataclasses.replace(node, spine=new_kids[0],
                                          builds=new_kids[1:])
        elif isinstance(node, N.SemiJoin):
            rebuilt = dataclasses.replace(node, source=new_kids[0],
                                          filter_source=new_kids[1])
        elif isinstance(node, N.Union):
            rebuilt = dataclasses.replace(node, inputs=new_kids)
    if isinstance(rebuilt, N.Project):
        src_syms = rebuilt.source.output_symbols
        identity = all(
            isinstance(e, ir.ColumnRef) and e.name == s
            for s, e in rebuilt.assignments.items())
        if identity and list(rebuilt.assignments) == list(src_syms):
            return rebuilt.source
    return rebuilt


def push_scan_filters(plan: N.PlanNode, engine) -> N.PlanNode:
    """Offer each scan-adjacent filter's conjuncts to the connector
    (reference PushPredicateIntoTableScan over
    ConnectorMetadata.applyFilter): a connector that can prove data
    irrelevant returns a decorated table name selecting the constrained
    scan (parquet row-group pruning). The filter stays in the plan —
    pushdown is a superset guarantee, not exact evaluation."""
    from presto_tpu_torch.connectors.expression import scan_conjuncts

    def visit(node: N.PlanNode) -> N.PlanNode:
        if not (isinstance(node, N.Filter)
                and isinstance(node.source, N.TableScan)):
            return node
        scan = node.source
        conn = engine.catalogs.get(scan.catalog)
        if conn is None:
            return node
        conjuncts = scan_conjuncts(node.predicate, scan.assignments)
        if not conjuncts:
            return node
        try:
            token = conn.apply_filter(scan.table, conjuncts)
        except Exception:
            return node
        if token is None or token == scan.table:
            return node
        return dataclasses.replace(
            node, source=N.TableScan(scan.catalog, token,
                                     scan.assignments, scan.types))

    return N.rewrite_bottom_up(plan, visit)
