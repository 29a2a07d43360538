"""Plan rendering for EXPLAIN.

Analog of the reference's sql/planner/planprinter/PlanPrinter.java text
output (indented operator tree with per-node details).
"""

from __future__ import annotations

from presto_tpu_torch.plan import nodes as N


def format_plan(node: N.PlanNode, indent: int = 0,
                annotations: dict[int, str] | None = None,
                estimates: dict[int, str] | None = None) -> str:
    """Indented operator tree. ``annotations`` appends bracketed
    per-node details on the node line (EXPLAIN ANALYZE row counts);
    ``estimates`` adds an indented per-node detail line (EXPLAIN's
    'Estimates: {rows, bytes, cpu/memory/network}', reference
    planprinter/PlanPrinter.formatEstimates — build the map with
    cost.explain_estimates)."""
    pad = " " * (4 * indent)
    line = pad + _describe(node)
    if annotations and id(node) in annotations:
        line += f"  [{annotations[id(node)]}]"
    parts = [line]
    if estimates and id(node) in estimates:
        parts.append(pad + "    " + estimates[id(node)])
    for s in node.sources():
        parts.append(format_plan(s, indent + 1, annotations, estimates))
    return "\n".join(parts)


def _describe(node: N.PlanNode) -> str:
    t = type(node).__name__
    if isinstance(node, N.TableScan):
        cols = ", ".join(f"{s}:={c}" for s, c in node.assignments.items())
        return f"TableScan[{node.catalog}.{node.table}] => [{cols}]"
    if isinstance(node, N.Values):
        return f"Values[{len(node.rows)} rows] => {node.symbols}"
    if isinstance(node, N.Filter):
        return f"Filter[{node.predicate}]"
    if isinstance(node, N.Project):
        items = ", ".join(f"{s} := {e}"
                          for s, e in node.assignments.items())
        return f"Project[{items}]"
    if isinstance(node, N.Aggregate):
        aggs = ", ".join(f"{s} := {c}" for s, c in node.aggs.items())
        return (f"Aggregate[{node.step.value}]"
                f"(keys={node.group_keys}, cap={node.capacity}) [{aggs}]")
    if isinstance(node, N.Join):
        crit = ", ".join(f"{a} = {b}" for a, b in node.criteria)
        extra = f", filter={node.filter}" if node.filter is not None else ""
        uniq = "unique" if node.build_unique else "expanding"
        return (f"Join[{node.join_type.value}, {uniq}, "
                f"{_distribution(node.distribution, node.hot_keys, node.salt_factor)}]"
                f"({crit}{extra})")
    if isinstance(node, N.MultiJoin):
        legs = "; ".join(
            ", ".join(f"{a} = {b}" for a, b in crit)
            + f" [{_distribution(d, None, None)}]"
            for crit, d in zip(node.criteria, node.distributions))
        return (f"MultiJoin[inner, {len(node.builds)}-way]"
                f"({legs})")
    if isinstance(node, N.SemiJoin):
        keys = ", ".join(f"{a} = {b}" for a, b in
                         zip(node.source_keys, node.filter_keys))
        neg = "anti " if node.negated else ""
        return f"SemiJoin[{neg}{keys}] => {node.output}"
    if isinstance(node, N.CrossJoin):
        return f"CrossJoin[{'scalar' if node.scalar else 'expanding'}]"
    if isinstance(node, N.Window):
        fns = ", ".join(f"{s} := {c.fn}" for s, c in node.functions.items())
        return (f"Window[partition={node.partition_by}, "
                f"order={_orderings(node.orderings)}] [{fns}]")
    if isinstance(node, N.Sort):
        return f"Sort[{_orderings(node.orderings)}]"
    if isinstance(node, N.TopN):
        return f"TopN[{node.count}; {_orderings(node.orderings)}]"
    if isinstance(node, N.Limit):
        off = f" offset {node.offset}" if node.offset else ""
        return f"Limit[{node.count}{off}]"
    if isinstance(node, N.Distinct):
        return f"Distinct[cap={node.capacity}]"
    if isinstance(node, N.MarkDistinct):
        return (f"MarkDistinct[{node.mark_symbol} := "
                f"first({', '.join(node.keys)})]")
    if isinstance(node, N.Union):
        return f"Union[{len(node.inputs)} inputs] => {node.symbols}"
    if isinstance(node, N.Unnest):
        ords = (f", ordinality={node.ordinality_sym}"
                if node.ordinality_sym else "")
        pairs = ", ".join(f"{o} := {a}" for a, o in
                          zip(node.array_syms, node.out_syms))
        return f"Unnest[{pairs}{ords}]"
    if isinstance(node, N.MatchRecognize):
        meas = ", ".join(m[0] for m in node.measures)
        return (f"MatchRecognize[partition={node.partition_by}, "
                f"order={_orderings(node.orderings)}, "
                f"defines={sorted(node.defines)}] => [{meas}]")
    if isinstance(node, N.Exchange):
        return f"Exchange[{node.kind.value}]({node.partition_keys})"
    if isinstance(node, N.Output):
        cols = ", ".join(f"{n}:={s}"
                         for n, s in zip(node.names, node.symbols))
        return f"Output[{cols}]"
    return t


def _distribution(dist: str, hot_keys, salt) -> str:
    """Render a join's distribution; the skew-aware refinements spell
    their parameters out ("hybrid[hot=256, salt=4]") so EXPLAIN shows
    what the runtime will actually do (cost/skew.py annotations)."""
    if dist == "hybrid" or (salt or 1) > 1:
        return (f"hybrid[hot={hot_keys or 0}, salt={salt or 1}]"
                if dist == "hybrid"
                else f"{dist}[salt={salt}]")
    return dist


def _orderings(orderings) -> str:
    return ", ".join(
        f"{o.symbol} {'asc' if o.ascending else 'desc'}" for o in orderings)
