"""Dense-key annotation pass: mark joins/semijoins whose build keys are
bounded-range integers so the executor can use direct-address tables
(one scatter + one gather) instead of sort-merge probes.

TPC-H/TPC-DS surrogate keys are dense 1..n integers (the reference ships
the same fact as connector column statistics,
plugin/trino-tpch/src/main/resources/tpch/statistics + the *_sk columns
of TPC-DS), and TPU sorts cost ~6ns/row/pass while a direct-address
probe is a single gather — the pass exists because the physical choice
needs value-range facts the trace-time executor cannot see.

Runs AFTER the optimizer pipeline (plan shapes are final). Ranges are
conservative over-approximations propagated from connector
column_range_estimates through position-preserving operators.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
# span-width eligibility is a cost-model decision (HBM for the
# direct-address table vs probe savings); the thresholds live with the
# other physical-choice gates in cost/model.py
from presto_tpu_torch.cost.model import (MAX_SPAN, MAX_SPAN_FACTOR,  # noqa: F401
                                   dense_span_eligible as _eligible_span)
from presto_tpu_torch.plan import nodes as N


def _scan_ranges(node: N.TableScan, engine) -> dict[str, tuple]:
    conn = engine.catalogs.get(node.catalog)
    if conn is None:
        return {}
    try:
        ranges = conn.column_range_estimates(node.table)
    except (AttributeError, KeyError):
        return {}
    out = {}
    for sym, col in node.assignments.items():
        r = ranges.get(col)
        if r is not None:
            out[sym] = (int(r[0]), int(r[1]))
    return out


def symbol_ranges(node: N.PlanNode, engine) -> dict[str, tuple]:
    """(lo, hi) bounds per output symbol, where derivable. Conservative:
    a symbol missing from the map has unknown range."""
    if isinstance(node, N.TableScan):
        return _scan_ranges(node, engine)
    if isinstance(node, N.Filter):
        return symbol_ranges(node.source, engine)
    if isinstance(node, N.Project):
        src = symbol_ranges(node.source, engine)
        out = {}
        from presto_tpu_torch.expr import ir
        for sym, expr in node.assignments.items():
            if isinstance(expr, ir.ColumnRef) and expr.name in src:
                out[sym] = src[expr.name]
        return out
    if isinstance(node, (N.Join, N.CrossJoin)):
        out = symbol_ranges(node.left, engine)
        out.update(symbol_ranges(node.right, engine))
        return out
    if isinstance(node, N.MultiJoin):
        out = symbol_ranges(node.spine, engine)
        for b in node.builds:
            out.update(symbol_ranges(b, engine))
        return out
    if isinstance(node, N.SemiJoin):
        return symbol_ranges(node.source, engine)
    if isinstance(node, (N.Sort, N.TopN, N.Limit, N.Distinct,
                         N.MarkDistinct, N.Exchange, N.Window)):
        return symbol_ranges(node.sources()[0], engine)
    if isinstance(node, N.Aggregate):
        src = symbol_ranges(node.source, engine)
        return {k: src[k] for k in node.group_keys if k in src}
    return {}


def unique_key_sets(node: N.PlanNode, engine) -> list[frozenset]:
    """Symbol sets that are unique keys of the node's output, derived
    structurally (the planner's RelationPlan.unique analog, recomputed
    over the optimized plan)."""
    if isinstance(node, N.TableScan):
        conn = engine.catalogs.get(node.catalog)
        if conn is None:
            return []
        try:
            keys = conn.unique_keys(node.table)
        except (AttributeError, KeyError, NotImplementedError):
            return []
        by_col = {c: s for s, c in node.assignments.items()}
        out = []
        for key in keys:
            if all(c in by_col for c in key):
                out.append(frozenset(by_col[c] for c in key))
        return out
    if isinstance(node, N.Filter):
        from presto_tpu_torch.plan.planner import narrow_unique_by_consts
        return narrow_unique_by_consts(
            unique_key_sets(node.source, engine), node.predicate)
    if isinstance(node, N.Project):
        from presto_tpu_torch.expr import ir
        src = unique_key_sets(node.source, engine)
        fwd = {}
        for sym, expr in node.assignments.items():
            if isinstance(expr, ir.ColumnRef):
                fwd.setdefault(expr.name, sym)
        out = []
        for key in src:
            if all(s in fwd for s in key):
                out.append(frozenset(fwd[s] for s in key))
        return out
    if isinstance(node, N.Join):
        if node.join_type in (N.JoinType.INNER, N.JoinType.LEFT) \
                and node.build_unique:
            # each probe row matches <= 1 build row: probe keys survive
            return unique_key_sets(node.left, engine)
        return []
    if isinstance(node, N.MultiJoin):
        # all builds are unique by construction: spine keys survive
        return unique_key_sets(node.spine, engine)
    if isinstance(node, N.SemiJoin):
        return unique_key_sets(node.source, engine)
    if isinstance(node, N.Aggregate) and node.group_keys:
        # FD-reduced: group keys determined by kept keys don't widen
        # the unique set (q11's year_total is unique on (customer_id,
        # year), not the 8-key grouping list)
        fds = fd_singles(node.source, engine)
        keys = (reduce_group_keys(node.group_keys, fds) if fds
                else node.group_keys)
        return [frozenset(keys)]
    if isinstance(node, N.Distinct):
        return [frozenset(node.source.output_symbols)]
    if isinstance(node, (N.Sort, N.TopN, N.Limit, N.MarkDistinct,
                         N.Exchange)):
        return unique_key_sets(node.sources()[0], engine)
    return []


def fd_singles(node: N.PlanNode, engine) -> dict[str, set]:
    """Single-symbol functional dependencies of a plan's output:
    determinant symbol -> symbols it determines. Sources: unique-build
    joins with one criterion (the probe key determines every build
    column) and single-column unique scan keys (a PK determines its
    table's columns)."""
    if isinstance(node, N.TableScan):
        conn = engine.catalogs.get(node.catalog)
        if conn is None:
            return {}
        try:
            keys = conn.unique_keys(node.table)
        except (AttributeError, KeyError, NotImplementedError):
            return {}
        by_col = {c: s for s, c in node.assignments.items()}
        out: dict[str, set] = {}
        for key in keys:
            if len(key) == 1 and key[0] in by_col:
                out[by_col[key[0]]] = set(node.assignments) \
                    - {by_col[key[0]]}
        return out
    if isinstance(node, (N.Filter, N.Sort, N.TopN, N.Limit,
                         N.Exchange, N.MarkDistinct, N.Window)):
        return fd_singles(node.sources()[0], engine)
    if isinstance(node, N.Project):
        from presto_tpu_torch.expr import ir
        src = fd_singles(node.source, engine)
        fwd: dict[str, list] = {}
        for sym, expr in node.assignments.items():
            if isinstance(expr, ir.ColumnRef):
                fwd.setdefault(expr.name, []).append(sym)
        out = {}
        for det, deps in src.items():
            for dsym in fwd.get(det, []):
                out[dsym] = {s for d in deps for s in fwd.get(d, [])}
        return out
    if isinstance(node, N.SemiJoin):
        out = fd_singles(node.source, engine)
        return out
    if isinstance(node, N.Join):
        # FDs are row-level properties (equal determinant => equal
        # dependents), so BOTH sides' FDs survive any join — each
        # output row carries one base row per side
        out = fd_singles(node.left, engine)
        right_fd = fd_singles(node.right, engine)
        for det, deps in right_fd.items():
            out.setdefault(det, set()).update(deps)
        if node.join_type in (N.JoinType.INNER, N.JoinType.LEFT) \
                and node.build_unique and len(node.criteria) == 1:
            lk, rk = node.criteria[0]
            rsyms = set(node.right.output_symbols)
            deps = out.setdefault(lk, set())
            deps |= rsyms
            # transitively: whatever rk determined, lk now determines
            deps |= right_fd.get(rk, set())
        return out
    if isinstance(node, N.MultiJoin):
        # the fused chain carries the same FDs as the cascade it
        # replaced: every build is unique, so each single-criterion
        # probe key determines its build's columns
        out = fd_singles(node.spine, engine)
        for build, crit in zip(node.builds, node.criteria):
            bfd = fd_singles(build, engine)
            for det, deps in bfd.items():
                out.setdefault(det, set()).update(deps)
            if len(crit) == 1:
                lk, rk = crit[0]
                deps = out.setdefault(lk, set())
                deps |= set(build.output_symbols)
                deps |= bfd.get(rk, set())
        return out
    return {}


def reduce_group_keys(keys: list[str], fds: dict[str, set]) -> list:
    """Minimal ordered subset of ``keys`` whose FD closure covers all
    of them (greedy; exact enough for star-schema shapes)."""
    kept: list[str] = []
    covered: set = set()
    for k in keys:
        if k in covered:
            continue
        kept.append(k)
        # closure expansion from the newly kept key
        frontier = [k]
        while frontier:
            cur = frontier.pop()
            for dep in fds.get(cur, ()):  # noqa: B023
                if dep not in covered:
                    covered.add(dep)
                    frontier.append(dep)
    return kept


def _int_typed(types: dict, sym: str) -> bool:
    t = types.get(sym)
    return isinstance(t, (T.BigintType, T.IntegerType, T.DateType))


def annotate_dense(plan: N.PlanNode, engine) -> N.PlanNode:
    """Attach dense_key hints to Join/SemiJoin nodes (bottom-up)."""

    def visit(node: N.PlanNode) -> N.PlanNode:
        if isinstance(node, N.Join) and node.criteria \
                and not node.build_unique \
                and node.join_type in (N.JoinType.INNER,
                                       N.JoinType.LEFT):
            # post-optimization uniqueness upgrade: the planner's
            # uniqueness inference predates rule rewrites (union branch
            # pruning, constant-eq narrowing), so structurally-provable
            # unique builds planned as expanding get flipped to the
            # probe-preserved path here (q4/q11/q74 year_total
            # self-joins)
            bsyms = frozenset(rk for _, rk in node.criteria)
            if any(u <= bsyms
                   for u in unique_key_sets(node.right, engine)):
                node = dataclasses.replace(node, build_unique=True,
                                           output_capacity=None)
        if isinstance(node, N.Join) and node.criteria \
                and node.join_type != N.JoinType.FULL \
                and node.build_unique and node.dense_key is None:
            ranges = symbol_ranges(node.right, engine)
            types = node.right.output_types()
            uniques = None
            for i, (_lk, rk) in enumerate(node.criteria):
                if rk not in ranges or not _int_typed(types, rk):
                    continue
                if not _eligible_span(ranges[rk], node.build_rows):
                    continue
                if len(node.criteria) > 1:
                    if uniques is None:
                        uniques = unique_key_sets(node.right, engine)
                    if frozenset([rk]) not in uniques:
                        continue
                lo, hi = ranges[rk]
                node = dataclasses.replace(
                    node, dense_key=(i, lo, hi))
                break
        elif isinstance(node, N.Aggregate) \
                and len(node.group_keys) > 1 and node.fd_keys is None:
            fds = fd_singles(node.source, engine)
            if fds:
                reduced = reduce_group_keys(node.group_keys, fds)
                if len(reduced) < len(node.group_keys):
                    node = dataclasses.replace(node, fd_keys=reduced)
        elif isinstance(node, N.SemiJoin) \
                and len(node.filter_keys) == 1 \
                and node.dense_key is None:
            # membership bitmap: uniqueness not required
            ranges = symbol_ranges(node.filter_source, engine)
            types = node.filter_source.output_types()
            rk = node.filter_keys[0]
            if rk in ranges and _int_typed(types, rk) \
                    and _eligible_span(ranges[rk], None):
                lo, hi = ranges[rk]
                node = dataclasses.replace(node, dense_key=(lo, hi))
        return node

    return N.rewrite_bottom_up(plan, visit)
