"""Cost-based join reordering (reference
sql/planner/iterative/rule/ReorderJoins.java +
DetermineJoinDistributionType).

The logical planner orders join graphs greedily at plan time
(plan/planner.py _order_joins) using leg-local estimates. This pass
re-enumerates every maximal INNER equi-join region of the OPTIMIZED
plan with full plan-wide statistics (cost/stats.py):

- regions of up to :data:`MAX_DP_RELATIONS` relations run an exact
  left-deep dynamic program over the equi-join graph (the engine's
  executors and fragmenter are built around probe spines, so bushy
  shapes are deliberately out of the search space);
- larger regions fall back to a greedy walk driven by the same cost
  function.

Decisions are WRITTEN INTO the Join nodes — ``build_rows`` (power-of-
two-bucketed so the compiled-program cache keeps hitting),
``capacity``/``output_capacity`` hints, ``build_unique`` (recomputed
structurally via plan/dense.unique_key_sets), and under AUTOMATIC
session mode the explicit broadcast-vs-partitioned ``distribution``
from the cost model — so the fragmenter, the runtime distribution
choice, and power-of-two hash-table sizing all consume one set of
estimates.

Session control (``optimizer_join_reordering_strategy``):

- ``AUTOMATIC``  — full cost-based reordering (default);
- ``ELIMINATE_CROSS_JOINS`` — keep the planner's order (its join-graph
  walk already never introduces a cross join where an equi edge
  exists) but refresh estimate annotations from plan-wide stats;
- ``NONE`` — leave plans exactly as planned.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.cost.model import (CostCalculator, DEFAULT_MESH_SHARDS,
                                   decide_join_distribution)
from presto_tpu_torch.cost.skew import decide_skew
from presto_tpu_torch.cost.stats import StatsCalculator
from presto_tpu_torch.ops.sizes import next_pow2
from presto_tpu_torch.plan import nodes as N

# DP enumeration bound: 2^8 subset states; beyond this the greedy walk
# takes over (reference ReorderJoins JOIN_REORDERING_MAX_JOINS analog)
MAX_DP_RELATIONS = 8


def reorder_joins(plan: N.PlanNode, engine) -> N.PlanNode:
    """Entry point, wired into plan/optimizer.optimize."""
    session = getattr(engine, "session", None)
    strategy = "AUTOMATIC"
    if session is not None:
        raw = session.get("optimizer_join_reordering_strategy")
        strategy = str(raw or "AUTOMATIC").upper()
    if strategy == "NONE":
        return plan
    ctx = _Ctx(engine, strategy)
    return ctx.walk(plan)


def _is_region_join(node: N.PlanNode) -> bool:
    """Joins the flattener may absorb: INNER equi joins without residual
    filters (a residual references both sides; keeping it on its
    original join preserves placement exactly)."""
    return (isinstance(node, N.Join)
            and node.join_type == N.JoinType.INNER
            and node.criteria and node.filter is None)


class _Ctx:
    def __init__(self, engine, strategy: str):
        self.engine = engine
        self.strategy = strategy
        self.stats = StatsCalculator(engine)
        session = getattr(engine, "session", None)
        self.mode = "automatic"
        self.threshold = None
        self.hot_threshold = 0
        self.max_salt = 0
        if session is not None:
            self.mode = str(session.get(
                "join_distribution_type") or "automatic").lower()
            self.threshold = int(session.get(
                "broadcast_join_threshold_rows"))
            self.hot_threshold = int(session.get(
                "skew_hot_key_threshold") or 0)
            self.max_salt = int(session.get("join_salting") or 0)
        self.cost = CostCalculator(
            broadcast_threshold=self.threshold)

    def _skewed(self, dist: str, probe_est, build_est, criteria,
                build_unique: bool) -> tuple[str, int | None, int | None]:
        """Refine a plan-time "partitioned" choice with the skew
        decision (cost/skew.py): returns (distribution, hot_keys,
        salt_factor) to write into the Join node."""
        if dist != "partitioned":
            return dist, None, None
        d = decide_skew(probe_est, build_est, criteria, build_unique,
                        join_type_inner=True,
                        nshards=DEFAULT_MESH_SHARDS,
                        hot_threshold=self.hot_threshold,
                        max_salt=self.max_salt)
        if not d.active:
            return dist, None, None
        return (("hybrid" if d.hybrid else dist), d.hot_keys,
                (d.salt_factor if d.salt_factor > 1 else None))

    # -- tree walk ----------------------------------------------------------

    def walk(self, node: N.PlanNode) -> N.PlanNode:
        if _is_region_join(node):
            return self._reorder_region(node)
        updates = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, N.PlanNode):
                nv = self.walk(v)
                if nv is not v:
                    updates[f.name] = nv
            elif isinstance(v, list) and v \
                    and isinstance(v[0], N.PlanNode):
                nv = [self.walk(x) for x in v]
                if any(a is not b for a, b in zip(nv, v)):
                    updates[f.name] = nv
        return dataclasses.replace(node, **updates) if updates else node

    def _flatten(self, node: N.PlanNode, rels: list,
                 edges: list) -> None:
        """Collect a region's leaf relations and equi edges
        (reference MultiJoinNode.toMultiJoinNode)."""
        if _is_region_join(node):
            self._flatten(node.left, rels, edges)
            self._flatten(node.right, rels, edges)
            edges.extend(node.criteria)
        else:
            rels.append(self.walk(node))

    def _reorder_region(self, root: N.Join) -> N.PlanNode:
        if self.strategy == "ELIMINATE_CROSS_JOINS":
            # the planner's join-graph walk already avoids cross joins
            # wherever an equi edge exists; just refresh annotations
            return self._annotate_only(root)

        rels: list[N.PlanNode] = []
        raw_edges: list[tuple[str, str]] = []
        self._flatten(root, rels, raw_edges)

        # symbol -> relation index
        sym_rel: dict[str, int] = {}
        for i, r in enumerate(rels):
            for s in r.output_types():
                sym_rel[s] = i
        edges = []  # (rel_a, rel_b, sym_a, sym_b)
        for a, b in raw_edges:
            if a not in sym_rel or b not in sym_rel:
                return self._annotate_only(root)
            edges.append((sym_rel[a], sym_rel[b], a, b))

        if len(rels) <= MAX_DP_RELATIONS:
            built = self._dp(rels, edges)
        else:
            built = self._greedy(rels, edges)
        if built is None:  # disconnected graph: keep planner's shape
            return self._annotate_only(root)
        return built

    # -- candidate join construction ----------------------------------------

    def _unique_sets(self, node: N.PlanNode):
        from presto_tpu_torch.plan.dense import unique_key_sets
        return unique_key_sets(node, self.engine)

    def _make_join(self, probe: N.PlanNode, build: N.PlanNode,
                   criteria: list[tuple[str, str]]) -> N.Join:
        """Construct one candidate join with cost-model annotations
        (capacities power-of-two, build_rows pow2-bucketed, explicit
        distribution under AUTOMATIC session mode)."""
        bsyms = frozenset(b for _, b in criteria)
        build_unique = any(k <= bsyms for k in self._unique_sets(build))
        p_est = self.stats.stats(probe)
        b_est = self.stats.stats(build)
        out_rows, _conf = self.stats.equi_join_rows(
            p_est, b_est, criteria, build_unique)
        build_rows = next_pow2(max(int(b_est.row_count), 1))
        dist = "automatic"
        hot_keys = salt = None
        if self.mode == "automatic":
            dist = decide_join_distribution(
                None, self.mode, build_rows, self.threshold)
            dist, hot_keys, salt = self._skewed(
                dist, p_est, b_est, criteria, build_unique)
        out_cap = None
        if not build_unique:
            # conservative hint, same bound as the planner: an
            # undersized guess costs one RETRY_GROWTH recompile, an
            # oversized one allocates HBM up front
            cap = min(2 * max(int(out_rows), int(p_est.row_count)),
                      8 * max(int(p_est.row_count),
                              int(b_est.row_count)))
            out_cap = next_pow2(max(cap, 2))
        return N.Join(
            probe, build, N.JoinType.INNER, list(criteria), None,
            build_unique, distribution=dist, build_rows=build_rows,
            hot_keys=hot_keys, salt_factor=salt,
            capacity=next_pow2(2 * max(int(b_est.row_count), 1)),
            output_capacity=out_cap)

    def _join_and_cost(self, probe_node, probe_cost: float,
                       build_node, build_cost: float,
                       criteria) -> tuple[N.Join, float]:
        join = self._make_join(probe_node, build_node, criteria)
        est = self.stats.stats(join)
        # price the distribution that will actually run: a forced
        # session mode overrides the node annotation (which stays
        # "automatic" so runtime forcing keeps working)
        eff_dist = decide_join_distribution(
            join.distribution if join.distribution != "automatic"
            else None, self.mode, join.build_rows, self.threshold)
        local = self.cost.join_cost(
            self.stats.stats(probe_node), self.stats.stats(build_node),
            est.row_count, build_node.output_types(),
            probe_node.output_types(), eff_dist)
        return join, probe_cost + build_cost + local.scalar()

    # -- enumeration ---------------------------------------------------------

    def _dp(self, rels: list[N.PlanNode],
            edges: list) -> N.PlanNode | None:
        """Exact left-deep DP over connected subsets: best[mask] is the
        cheapest probe spine covering ``mask``, extended one build
        relation at a time (Selinger-style, reference ReorderJoins'
        memoized createJoinAccordingToPartitioning specialized to
        left-deep shapes)."""
        n = len(rels)
        leaf_cost = [self.cost.cost(r, self.stats).scalar()
                     for r in rels]
        best: dict[int, tuple[float, N.PlanNode]] = {
            1 << i: (leaf_cost[i], rels[i]) for i in range(n)}
        for mask in range(1, 1 << n):
            if mask not in best:
                continue
            # best[mask] exists: try attaching every connected build rel
            cur_cost, cur_node = best[mask]
            for j in range(n):
                if mask & (1 << j):
                    continue
                criteria = _connecting(edges, mask, j)
                if not criteria:
                    continue
                join, total = self._join_and_cost(
                    cur_node, cur_cost, rels[j], leaf_cost[j], criteria)
                key = mask | (1 << j)
                if key not in best or total < best[key][0]:
                    best[key] = (total, join)
        full = (1 << n) - 1
        hit = best.get(full)
        return hit[1] if hit is not None else None

    def _greedy(self, rels: list[N.PlanNode],
                edges: list) -> N.PlanNode | None:
        """Greedy fallback above the DP bound: start from the largest
        relation (the fact table) and repeatedly attach the cheapest
        connected build side — the planner's walk, re-driven by
        plan-wide stats."""
        n = len(rels)
        leaf_cost = [self.cost.cost(r, self.stats).scalar()
                     for r in rels]
        start = max(range(n),
                    key=lambda i: self.stats.stats(rels[i]).row_count)
        mask = 1 << start
        node, total = rels[start], leaf_cost[start]
        while mask != (1 << n) - 1:
            cand = None
            for j in range(n):
                if mask & (1 << j):
                    continue
                criteria = _connecting(edges, mask, j)
                if not criteria:
                    continue
                join, cost = self._join_and_cost(
                    node, total, rels[j], leaf_cost[j], criteria)
                if cand is None or cost < cand[0]:
                    cand = (cost, join, j)
            if cand is None:
                return None  # disconnected
            total, node, j = cand
            mask |= 1 << j
        return node

    # -- annotation-only refresh --------------------------------------------

    def _annotate_only(self, node: N.PlanNode) -> N.PlanNode:
        """Keep the tree shape; refresh Join estimate annotations from
        plan-wide stats (ELIMINATE_CROSS_JOINS and bail-out paths)."""
        if not _is_region_join(node):
            return self.walk(node)
        left = self._annotate_only(node.left)
        right = self._annotate_only(node.right)
        out = dataclasses.replace(node, left=left, right=right)
        b_est = self.stats.stats(right)
        build_rows = next_pow2(max(int(b_est.row_count), 1))
        dist = out.distribution
        hot_keys, salt = out.hot_keys, out.salt_factor
        if dist == "automatic" and self.mode == "automatic":
            dist = decide_join_distribution(
                None, self.mode, build_rows, self.threshold)
            dist, hot_keys, salt = self._skewed(
                dist, self.stats.stats(left), b_est,
                node.criteria, node.build_unique)
        return dataclasses.replace(
            out, build_rows=build_rows,
            capacity=next_pow2(2 * max(int(b_est.row_count), 1)),
            distribution=dist, hot_keys=hot_keys, salt_factor=salt)


def _connecting(edges: list, mask: int, j: int
                ) -> list[tuple[str, str]]:
    """Criteria (probe_sym, build_sym) of edges between subset ``mask``
    and relation ``j``."""
    out = []
    for (a, b, sa, sb) in edges:
        if a == j and (mask >> b) & 1:
            out.append((sb, sa))
        elif b == j and (mask >> a) & 1:
            out.append((sa, sb))
    return out
