"""Remainder re-costing from mid-query actuals.

The cost-model half of adaptive re-planning (parallel/adaptive.py):
once the TASK-mode stage walk has materialized part of a plan, the
remainder's leaves include ``__exchange__`` carrier scans standing in
for completed stages — relations whose row counts are no longer
estimates but MEASURED. :class:`OverlayStats` is a StatsCalculator
whose table-scan rule answers those carriers from the observed counts
(with the producing subtree's cumulative filter selectivity preserved,
so the unique-build containment rule keeps working through a carrier
dimension), and :func:`reannotate` re-runs the physical-choice
annotations the ReorderJoins pass originally wrote — ``build_rows``,
``capacity``/``output_capacity``, broadcast-vs-partitioned
``distribution``, skew ``hot_keys``/``salt_factor``, aggregate
capacity hints — over the remainder with actuals substituted.

Stability contract (same as the divergence-ledger feedback in
cost/stats.py): every rewritten annotation is power-of-two bucketed
and only rewritten when the correction is MATERIAL (>= the
StatsCalculator FEEDBACK_BAND, 4x), so a replan whose estimates were
roughly right leaves the plan — and therefore the template/program
cache keys — untouched, and a corrected shape costs at most one
compile before templating normally.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.cost.model import (DEFAULT_MESH_SHARDS,
                                   decide_join_distribution)
from presto_tpu_torch.cost.skew import decide_skew
from presto_tpu_torch.cost.stats import PlanNodeStatsEstimate, StatsCalculator
from presto_tpu_torch.ops.hash import next_pow2
from presto_tpu_torch.plan import nodes as N


@dataclasses.dataclass(frozen=True)
class CarrierStats:
    """Observed statistics of one materialized exchange carrier: the
    stage's actual mesh-total output rows, and the cumulative filter
    selectivity of the subtree it materialized (actual rows over the
    base relation's estimated rows — the containment input unique-build
    joins against this carrier need)."""

    rows: int
    selectivity: float = 1.0


class OverlayStats(StatsCalculator):
    """StatsCalculator that answers ``__exchange__`` carrier scans
    from observed :class:`CarrierStats` instead of the unknown-catalog
    fallback; every other rule (joins, aggregates, the ledger
    feedback) is inherited unchanged."""

    def __init__(self, engine, carriers: dict[str, CarrierStats]):
        super().__init__(engine)
        self.carriers = dict(carriers)

    def _s_tablescan(self, node: N.TableScan) -> PlanNodeStatsEstimate:
        if node.catalog == "__exchange__":
            hit = self.carriers.get(node.table)
            if hit is not None:
                return PlanNodeStatsEstimate(
                    max(float(hit.rows), 1.0), {}, True,
                    min(max(hit.selectivity, 1e-9), 1.0))
        return super()._s_tablescan(node)


def _has_partitioned_carrier(node: N.PlanNode,
                             carriers: dict) -> bool:
    """True when ``node``'s subtree contains a carrier that was
    PRODUCED hash-partitioned: its consumption layout is fixed (each
    consumer owns its partition), so a join over it must stay
    partitioned — flipping to broadcast would need an 'all' read the
    producer's buffer reader accounting was never sized for."""
    if isinstance(node, N.TableScan):
        hit = carriers.get(node.table) \
            if node.catalog == "__exchange__" else None
        return hit is not None and hit.partition_keys is not None
    return any(_has_partitioned_carrier(s, carriers)
               for s in node.sources())


def _grounded(node: N.PlanNode, stats: StatsCalculator) -> bool:
    """Is ``node``'s row estimate bounded by rows that exist? So it is
    when no operator under it multiplies rows (a join that is not
    unique, a cross join, an unnest) and every leaf is a relation of
    known size: a catalog table, inline values, or a carrier whose rows
    were observed. The estimate of a chain of expanding joins compounds
    (2^30-2^44 rows for TPC-DS q57, q72 and q95 at scale 10); a
    grounded one is at most a leaf's rows or their sum."""
    if (isinstance(node, N.Join) and not node.build_unique) \
            or isinstance(node, (N.CrossJoin, N.Unnest)):
        return False
    srcs = node.sources()
    if not srcs:
        return stats.stats(node).confident
    return all(_grounded(s, stats) for s in srcs)


def reannotate(plan: N.PlanNode, engine, stats: OverlayStats,
               exchange_sources: dict | None = None,
               note=None) -> N.PlanNode:
    """Re-run the physical-choice annotations over a remainder plan
    with actuals substituted (the mid-flight twin of
    cost/reorder._Ctx._annotate_only). ``note(kind, node, est, actual,
    old, new)`` is called once per MATERIAL rewrite so the caller can
    audit decisions into ``system.adaptive_decisions``. Returns the
    (possibly identical) rewritten plan."""
    session = getattr(engine, "session", None)
    mode = "automatic"
    threshold = None
    hot_threshold = 0
    max_salt = 0
    if session is not None:
        mode = str(session.get("join_distribution_type")
                   or "automatic").lower()
        threshold = int(session.get("broadcast_join_threshold_rows"))
        hot_threshold = int(session.get("skew_hot_key_threshold") or 0)
        max_salt = int(session.get("join_salting") or 0)
    exchange_sources = exchange_sources or {}

    def tell(kind, node, est, actual, old, new):
        if note is not None:
            note(kind, node, est, actual, old, new)

    def revise_join(node: N.Join) -> N.Join:
        b_est = stats.stats(node.right)
        p_est = stats.stats(node.left)
        new_rows = next_pow2(max(int(b_est.row_count), 1))
        old_rows = node.build_rows
        out_rows = None
        if not node.build_unique:
            out_rows, _c = stats.equi_join_rows(
                p_est, b_est, node.criteria, node.build_unique)
        material = old_rows is None or StatsCalculator._material(
            float(old_rows), float(new_rows))
        if not material and out_rows is not None \
                and node.output_capacity is not None:
            # an expanding join's OUTPUT capacity also depends on the
            # probe side: a probe-only divergence must still re-bucket
            # it (each undersized rung is a recompile)
            material = StatsCalculator._material(
                float(node.output_capacity),
                float(next_pow2(max(2 * int(out_rows), 2))))
        if not material:
            return node
        old_dist = decide_join_distribution(
            node.distribution if node.distribution != "automatic"
            else None, mode, old_rows, threshold)
        if _has_partitioned_carrier(node.right, exchange_sources):
            # production layout dictates consumption: stay partitioned
            new_dist = "partitioned"
            hot_keys = salt = None
        else:
            new_dist = decide_join_distribution(None, mode, new_rows,
                                                threshold)
            hot_keys = salt = None
            if new_dist == "partitioned" and mode == "automatic" \
                    and node.join_type == N.JoinType.INNER:
                d = decide_skew(p_est, b_est, node.criteria,
                                node.build_unique,
                                join_type_inner=True,
                                nshards=DEFAULT_MESH_SHARDS,
                                hot_threshold=hot_threshold,
                                max_salt=max_salt)
                if d.active:
                    new_dist = "hybrid" if d.hybrid else new_dist
                    hot_keys = d.hot_keys
                    salt = (d.salt_factor if d.salt_factor > 1
                            else None)
        out_cap = node.output_capacity
        observed = node.output_observed
        if out_rows is not None:
            cap = min(2 * max(int(out_rows), int(p_est.row_count)),
                      8 * max(int(p_est.row_count),
                              int(b_est.row_count)))
            out_cap = next_pow2(max(cap, 2))
            # the interpreter takes the capacity as it is only where
            # the bound above rests on rows that exist: over a chain of
            # expanding joins it stays a static hint, cut at the first
            # rung
            observed = _grounded(node.left, stats) and \
                _grounded(node.right, stats)
        tell("join-capacity", node, old_rows or -1, new_rows,
             str(node.capacity), str(next_pow2(2 * new_rows)))
        if new_dist != old_dist:
            tell("join-distribution", node, old_rows or -1, new_rows,
                 old_dist, new_dist)
        return dataclasses.replace(
            node, build_rows=new_rows,
            capacity=next_pow2(2 * max(int(b_est.row_count), 1)),
            output_capacity=out_cap, output_observed=observed,
            distribution=new_dist, hot_keys=hot_keys, salt_factor=salt)

    def revise_multijoin(node: N.MultiJoin) -> N.MultiJoin:
        rows_list = list(node.build_rows)
        dists = list(node.distributions)
        changed = False
        for i, build in enumerate(node.builds):
            b_est = stats.stats(build)
            new_rows = next_pow2(max(int(b_est.row_count), 1))
            old_rows = rows_list[i] if i < len(rows_list) else None
            if old_rows is not None and not StatsCalculator._material(
                    float(old_rows), float(new_rows)):
                continue
            old_dist = decide_join_distribution(
                (dists[i] if i < len(dists) else None) or None,
                mode, old_rows, threshold)
            new_dist = decide_join_distribution(None, mode, new_rows,
                                                threshold)
            while len(rows_list) <= i:
                rows_list.append(None)
            while len(dists) <= i:
                dists.append("automatic")
            rows_list[i] = new_rows
            dists[i] = new_dist
            changed = True
            tell("multijoin-leg", node, old_rows or -1, new_rows,
                 old_dist, new_dist)
        if not changed:
            return node
        return dataclasses.replace(node, build_rows=rows_list,
                                   distributions=dists)

    def revise_aggregate(node: N.Aggregate) -> N.Aggregate:
        if not node.group_keys or node.capacity is None:
            # no hint: the runtime derives a safe input-sized default
            return node
        groups = max(int(stats.stats(node).row_count), 1)
        new_cap = next_pow2(2 * groups)
        if not StatsCalculator._material(float(node.capacity),
                                         float(new_cap)):
            return node
        tell("aggregate-capacity", node, node.capacity // 2, groups,
             str(node.capacity), str(new_cap))
        return dataclasses.replace(node, capacity=new_cap)

    def visit(node: N.PlanNode) -> N.PlanNode:
        if isinstance(node, N.Join) and node.criteria \
                and node.filter is None:
            return revise_join(node)
        if isinstance(node, N.MultiJoin):
            return revise_multijoin(node)
        if isinstance(node, N.Aggregate):
            return revise_aggregate(node)
        return node

    return N.rewrite_bottom_up(plan, visit)
