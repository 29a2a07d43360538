"""Mid-query adaptive re-planning for the TASK-mode stage walk.

Closes the WITHIN-query half of the feedback loop (the divergence
ledger of obs/qstats closes the between-queries half): the synchronous stage walk of
``parallel/coordinator._execute_general_ft`` knows every stage's
actual output row count the moment its tasks return, and the
not-yet-dispatched remainder of the stage DAG is still just a plan.
After each stage completes, the :class:`AdaptiveController` compares
its actual rows against the fragment-time estimate; when the
divergence is MATERIAL (the same >= 4x pow2-quantized gate the
ledger-feedback rules use, cost/stats.StatsCalculator.FEEDBACK_BAND),
it re-plans the remainder:

1. **Remainder construction** — every completed stage's plan subtree
   is substituted with an ``__exchange__`` carrier scan named after
   the stage (plan/optimizer.substitute_materialized), so the already
   -materialized outputs become leaves with OBSERVED statistics.
2. **Re-costing** — cost/adapt.OverlayStats answers those carriers
   from actual row counts, and cost/adapt.reannotate re-derives the
   physical annotations (build_rows, capacities, broadcast vs
   partitioned, skew salting) with the material-only/pow2 stability
   contract; MultiJoins de-fuse for the re-decision and re-fuse when
   their legs still qualify (plan/optimizer.adapt_remainder /
   refuse_multiway).
3. **Re-fragmentation** — parallel/fragmenter.fragment_plan_general
   re-stages the remainder with the carriers as exchange sources:
   completed partitioned stages are reused verbatim as cut sides,
   per-worker stores are referenced broadcast or read "own", and the
   freshly minted stages (name-prefixed ``rN...``) replace the
   pending tail of the walk.

Every decision is audited in ``system.adaptive_decisions``
(obs/qstats.ADAPTIVE) with est-vs-actual rows and old -> new
strategy, counted in ``presto_tpu_adaptive_replans_total``, and
surfaced as ``[replanned: old->new]`` annotations on the coordinator's
EXPLAIN-ANALYZE-style plan rendering
(:meth:`AdaptiveController.annotated_plan`).
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.cost.adapt import CarrierStats, OverlayStats, reannotate
from presto_tpu_torch.cost.stats import StatsCalculator
from presto_tpu_torch.obs.jsonlog import LOG
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.obs.qstats import ADAPTIVE
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.parallel.fragmenter import (ExchangeSource, GStage,
                                            GeneralFragmentedPlan,
                                            fragment_plan_general)

_REPLANS = REGISTRY.counter(
    "presto_tpu_adaptive_replans_total",
    "mid-query remainder re-plans in the TASK-mode stage walk "
    "(parallel/adaptive.py), by trigger kind")

# re-plans per query are bounded: each one is cheap (host-side plan
# work), but a pathological estimate oscillation must not turn the
# stage walk into a planning loop
MAX_REPLANS = 4


@dataclasses.dataclass
class _Completed:
    """Book-keeping for one finished stage."""

    stage: GStage
    actual_rows: int
    est_rows: int
    selectivity: float


class AdaptiveController:
    """Per-query owner of mid-flight re-planning. Owned and called by
    exactly one dispatching thread (the stage walk is synchronous), so
    it keeps no locks; the shared decision log (obs/qstats.ADAPTIVE)
    is thread-safe on its own."""

    def __init__(self, engine, plan: N.PlanNode,
                 g: GeneralFragmentedPlan, query_id: str,
                 nworkers: int):
        self.engine = engine
        self.query_id = query_id
        self.nworkers = nworkers
        session = engine.session
        self.mode = str(session.get("join_distribution_type")
                        or "automatic").lower()
        self.threshold = int(
            session.get("broadcast_join_threshold_rows"))
        # the CURRENT plan the pending fragments were cut from: starts
        # as the original optimized plan, becomes the remainder after
        # each revision (completed-subtree identity keys track it)
        self.plan = plan
        self.original_plan = plan
        self.completed: dict[str, _Completed] = {}
        self.replans = 0
        self.decisions: list[dict] = []
        # id(original plan node) -> annotation text for the
        # [replanned: ...] EXPLAIN rendering; keyed by a structural
        # signature because revisions work on remainder COPIES
        self._annotations: dict[int, str] = {}
        self._sig_to_orig: dict[tuple, int] = {}
        self._index_plan(plan)
        self.estimates: dict[str, int] = {}
        self._estimate_stages(g.stages)

    # -- estimates -----------------------------------------------------------

    def _carrier_stats_for(self, st: GStage) -> dict[str, CarrierStats]:
        out: dict[str, CarrierStats] = {}
        for tname, (producer, _mode) in st.sources.items():
            hit = self.completed.get(producer)
            if hit is not None:
                out[tname] = CarrierStats(hit.actual_rows,
                                          hit.selectivity)
            elif producer in self.estimates:
                out[tname] = CarrierStats(self.estimates[producer])
        return out

    def _estimate_stages(self, stages) -> None:
        """Fragment-output row estimates in dependency order, each
        stage's exchange inputs answered from upstream estimates (or
        actuals once a producer completed)."""
        for st in stages:
            if st.name in self.estimates:
                continue
            try:
                calc = OverlayStats(self.engine,
                                    self._carrier_stats_for(st))
                self.estimates[st.name] = max(
                    int(calc.stats(st.fragment).row_count), 1)
            except Exception:  # noqa: BLE001 - estimates are optional
                self.estimates[st.name] = -1

    def _index_plan(self, plan: N.PlanNode) -> None:
        """Structural signatures of the ORIGINAL plan's physical-choice
        nodes, so decisions made on remainder copies can annotate the
        original tree for EXPLAIN."""

        def visit(node):
            sig = _node_signature(node)
            if sig is not None:
                self._sig_to_orig.setdefault(sig, id(node))
            for s in node.sources():
                visit(s)

        visit(plan)

    # -- per-stage observation ----------------------------------------------

    @staticmethod
    def actual_rows(outs: list) -> int:
        """Mesh-total output rows of one completed buffered stage (the
        task POST responses carry per-partition buffer row counts)."""
        total = 0
        for out in outs:
            if isinstance(out, dict):
                total += sum(int(r) for r in (out.get("rows") or []))
        return total

    def observe(self, st: GStage, outs: list,
                pending: list[GStage]
                ) -> GeneralFragmentedPlan | None:
        """Fold one finished stage's actuals in; returns a revised
        remainder staging to SWAP IN for ``pending``, or None to keep
        walking the current graph."""
        actual = self.actual_rows(outs)
        est = self.estimates.get(st.name, -1)
        sel = self._stage_selectivity(st, actual)
        self.completed[st.name] = _Completed(st, actual, est, sel)
        if not pending or self.replans >= MAX_REPLANS:
            return None
        if est < 0 or not StatsCalculator._material(float(est),
                                                    float(actual)):
            return None
        try:
            revised = self._replan(st, est, actual, pending)
        except Exception as e:  # noqa: BLE001 - replanning is optional
            LOG.log("adaptive_replan_failed", query_id=self.query_id,
                    stage=st.name, error=f"{type(e).__name__}: {e}")
            return None
        return revised

    def _stage_selectivity(self, st: GStage, actual: int) -> float:
        """Observed cumulative selectivity of the materialized subtree:
        actual rows over the subtree's base-relation estimate — the
        containment input unique-build joins against this carrier
        need (cost/stats.equi_join_rows)."""
        if st.subtree is None:
            return 1.0
        try:
            base = OverlayStats(self.engine,
                                self._carrier_stats_for(st))
            scans = _base_scan_rows(st.fragment, base)
            if scans <= 0:
                return 1.0
            return min(max(actual / scans, 1e-9), 1.0)
        except Exception:  # noqa: BLE001 - selectivity is a refinement
            return 1.0

    # -- the replan ----------------------------------------------------------

    def _replan(self, trigger: GStage, est: int, actual: int,
                pending: list[GStage]
                ) -> GeneralFragmentedPlan | None:
        from presto_tpu_torch.plan.optimizer import (adapt_remainder,
                                               refuse_multiway)

        replacements: dict[int, N.PlanNode] = {}
        sources: dict[str, ExchangeSource] = {}
        carrier_stats: dict[str, CarrierStats] = {}
        for name, done in self.completed.items():
            sub = done.stage.subtree
            if sub is None:
                continue
            carrier = N.TableScan(
                "__exchange__", name,
                {s: s for s in sub.output_types()},
                dict(sub.output_types()))
            replacements[id(sub)] = carrier
            keys = (tuple(done.stage.partition_keys)
                    if done.stage.partition_keys is not None else None)
            sources[name] = ExchangeSource(name, keys)
            carrier_stats[name] = CarrierStats(done.actual_rows,
                                               done.selectivity)
        if not replacements:
            return None

        remainder = adapt_remainder(self.plan, replacements,
                                    self.engine)
        stats = OverlayStats(self.engine, carrier_stats)
        # decisions BUFFER until the revised staging is known-good: a
        # rolled-back replan must leave no audit rows or [replanned:]
        # markers claiming strategy flips that never took effect
        buffered: list[tuple] = []
        remainder = reannotate(
            remainder, self.engine, stats, exchange_sources=sources,
            note=lambda *args: buffered.append(args))
        remainder = refuse_multiway(remainder, self.engine)
        if not buffered:
            # nothing material changed in the remainder's annotations:
            # keep the pending stages (and their cache-keyed shapes)
            return None
        self.replans += 1
        revised = fragment_plan_general(
            remainder, mode=self.mode,
            broadcast_threshold=self.threshold,
            exchange_sources=sources,
            name_prefix=f"r{self.replans}")
        if revised is None:
            # remainder shape no longer stages (should not happen for
            # shapes the original fragmenter accepted): keep walking
            # the old graph rather than failing the query
            self.replans -= 1
            return None
        for args in buffered:
            self._commit_decision(trigger, *args)
        _REPLANS.inc(kind="stage-divergence")
        ADAPTIVE.note(self.query_id, trigger.name, "replan",
                      detail=f"stage {trigger.name} output diverged",
                      est_rows=est, actual_rows=actual)
        LOG.log("adaptive_replan", query_id=self.query_id,
                stage=trigger.name, est_rows=est, actual_rows=actual,
                pending_before=len(pending),
                pending_after=len(revised.stages))
        self.plan = remainder
        self._estimate_stages(revised.stages)
        return revised

    def _commit_decision(self, trigger: GStage, kind, node, est,
                         actual, old, new) -> None:
        """Publish one re-annotation decision to the audit surfaces —
        called only once the revised staging is committed."""
        desc = _describe_node(node)
        self.decisions.append({
            "kind": kind, "node": desc, "est": int(est),
            "actual": int(actual), "old": str(old),
            "new": str(new), "stage": trigger.name})
        ADAPTIVE.note(self.query_id, trigger.name, kind,
                      node_type=type(node).__name__, detail=desc,
                      est_rows=est, actual_rows=actual,
                      old_strategy=str(old), new_strategy=str(new))
        if kind in ("join-distribution", "multijoin-leg") \
                and str(old) != str(new):
            sig = _node_signature(node)
            orig = self._sig_to_orig.get(sig) if sig else None
            if orig is not None:
                self._annotations[orig] = f"replanned: {old}->{new}"

    # -- surfaces -------------------------------------------------------------

    def annotated_plan(self) -> str:
        """The original optimized plan rendered with
        ``[replanned: old->new]`` markers on every node whose
        distribution strategy changed mid-flight — the EXPLAIN
        ANALYZE-style audit view (coordinator.last_adaptive_explain)."""
        from presto_tpu_torch.plan.printer import format_plan
        return format_plan(self.original_plan,
                           annotations=dict(self._annotations))

    def summary(self) -> dict:
        return {"replans": self.replans,
                "decisions": list(self.decisions)}

    def revised_final_agg(self, agg, partial_rows: int):
        """Capacity re-bucket for the COORDINATOR-side FINAL aggregate
        (the _finish_with_partials splice): the gathered partial-state
        row count bounds the final group count, so the hint can be
        corrected just before the final program compiles — the exec/
        seam that turns the corrected shape into at most one compile
        (prepare_plan's capacity hints feed the pow2 cache key)."""
        if agg is None or not getattr(agg, "group_keys", None):
            return agg
        total = int(partial_rows)
        if total <= 0 or agg.capacity is None:
            return agg
        from presto_tpu_torch.ops.hash import next_pow2
        new_cap = next_pow2(2 * max(total, 16))
        if not StatsCalculator._material(float(agg.capacity),
                                         float(new_cap)):
            return agg
        ADAPTIVE.note(self.query_id, "coordinator",
                      "final-agg-capacity",
                      node_type="Aggregate",
                      est_rows=agg.capacity // 2, actual_rows=total,
                      old_strategy=str(agg.capacity),
                      new_strategy=str(new_cap))
        return dataclasses.replace(agg, capacity=new_cap)


def _base_scan_rows(fragment: N.PlanNode, stats) -> float:
    """Summed estimated rows of the fragment's leaf relations (base
    scans and carrier inputs) — the denominator of a materialized
    subtree's observed cumulative selectivity."""
    total = 0.0

    def visit(node):
        nonlocal total
        if isinstance(node, N.TableScan):
            try:
                total += float(stats.stats(node).row_count)
            except Exception:  # noqa: BLE001 - stats are best-effort
                pass
            return
        for s in node.sources():
            visit(s)

    visit(fragment)
    return total


def _node_signature(node: N.PlanNode) -> tuple | None:
    """Structural identity of a physical-choice node that survives the
    functional rewrites between the original plan and its remainder
    copies (criteria spellings are stable across both)."""
    if isinstance(node, N.Join) and node.criteria:
        return ("join", node.join_type.value,
                tuple(tuple(c) for c in node.criteria))
    if isinstance(node, N.MultiJoin):
        return ("multijoin",
                tuple(tuple(tuple(c) for c in crit)
                      for crit in node.criteria))
    if isinstance(node, N.Aggregate):
        return ("agg", node.step.value, tuple(node.group_keys),
                tuple(node.aggs))
    return None


def _describe_node(node: N.PlanNode) -> str:
    if isinstance(node, N.Join):
        crit = ", ".join(f"{a}={b}" for a, b in node.criteria)
        return f"Join({crit})"
    if isinstance(node, N.MultiJoin):
        return f"MultiJoin[{len(node.builds)}-way]"
    if isinstance(node, N.Aggregate):
        return f"Aggregate(keys={node.group_keys})"
    return type(node).__name__
