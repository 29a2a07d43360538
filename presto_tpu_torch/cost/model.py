"""Mesh-aware cost model.

The analog of the reference's cost/CostCalculatorUsingExchanges +
TaskCountEstimator: prices CPU, memory, and NETWORK per plan node,
where network models the TPU mesh reality of parallel/executor.py
rather than generic bytes:

- a BROADCAST join is an ``all_gather`` of the build shard — every
  device receives the full build side, so ``build_bytes * (n - 1)``
  bytes cross ICI links;
- a PARTITIONED join is an ``all_to_all`` of BOTH sides — each row
  moves to its hash-owner shard with probability ``(n - 1) / n``, so
  ``(probe_bytes + build_bytes) * (n - 1) / n`` bytes cross ICI.

This module is also the SINGLE home of the engine's physical-choice
thresholds: the broadcast-vs-partitioned decision
(:func:`decide_join_distribution`, consumed by parallel/executor.py,
parallel/fragmenter.py and cost/reorder.py — the three sites can no
longer disagree about a join's distribution) and the dense-key span
eligibility (:func:`dense_span_eligible`, consumed by plan/dense.py).
"""

from __future__ import annotations

import dataclasses
import math

from presto_tpu_torch.plan import nodes as N

# builds at or under this estimated row count broadcast instead of
# repartitioning both sides when no session threshold is supplied
# (matches the broadcast_join_threshold_rows session default; reference
# DetermineJoinDistributionType AUTOMATIC cutoff)
DEFAULT_BROADCAST_ROWS = 1 << 20

# mesh size assumed when pricing plans before a mesh exists (EXPLAIN,
# plan-time reordering); the driver's standard test mesh
DEFAULT_MESH_SHARDS = 8

# widest direct-address table the executor will allocate (slots), and
# the widest relative to the build side — a 16M-slot table for a
# 100-row build wastes HBM for no probe savings (moved here from
# plan/dense.py so span eligibility is a cost-model decision)
MAX_SPAN = 1 << 24
MAX_SPAN_FACTOR = 16

# relative weight of one hash-table-resident byte vs one CPU row-op in
# the scalar cost used for join enumeration (reference
# CostComparator's cpu/memory/network weights)
MEMORY_WEIGHT = 1.0
NETWORK_WEIGHT = 2.0


def decide_join_distribution(node_distribution: str | None,
                             mode: str | None,
                             build_rows: int | None,
                             threshold: int | None = None) -> str:
    """THE broadcast-vs-partitioned decision (reference
    DetermineJoinDistributionType): an explicit per-node distribution
    wins, then a forced session mode, then the AUTOMATIC row-count
    threshold (unknown build size broadcasts, matching the historical
    behavior of both the fragmenter and the runtime executor).
    "hybrid" (skew-aware hot-key broadcast + cold-tail partition,
    cost/skew.py) is a per-node refinement of "partitioned": callers
    without a hybrid path treat it as partitioned."""
    if node_distribution in ("broadcast", "partitioned", "hybrid"):
        return node_distribution
    m = (mode or "automatic").lower()
    if m == "broadcast":
        return "broadcast"
    if m == "partitioned":
        return "partitioned"
    if threshold is None:
        threshold = DEFAULT_BROADCAST_ROWS
    if build_rows is not None and build_rows > threshold:
        return "partitioned"
    return "broadcast"


def dense_span_eligible(rng: tuple, build_rows: int | None) -> bool:
    """May a (lo, hi) build-key range use a direct-address table?
    Memory-cost gate shared by plan/dense.py's join and semi-join
    annotations."""
    lo, hi = rng
    span = hi - lo + 1
    if span <= 0 or span > MAX_SPAN:
        return False
    if build_rows and span > max(MAX_SPAN_FACTOR * build_rows, 4096):
        return False
    return True


def broadcast_net_bytes(build_bytes: float, nshards: int) -> float:
    """ICI bytes of replicating the build side: all_gather of each
    device's shard to every peer."""
    return build_bytes * max(nshards - 1, 0)


def partitioned_net_bytes(probe_bytes: float, build_bytes: float,
                          nshards: int) -> float:
    """ICI bytes of hash-repartitioning both sides: all_to_all moves a
    row off-shard with probability (n-1)/n."""
    if nshards <= 1:
        return 0.0
    return (probe_bytes + build_bytes) * (nshards - 1) / nshards


@dataclasses.dataclass(frozen=True)
class PlanCostEstimate:
    """Per-node cost components (reference cost/PlanCostEstimate.java):
    cpu in row-operations, memory in resident bytes, network in ICI
    bytes."""

    cpu: float = 0.0
    memory: float = 0.0
    network: float = 0.0

    def plus(self, other: "PlanCostEstimate") -> "PlanCostEstimate":
        return PlanCostEstimate(self.cpu + other.cpu,
                                self.memory + other.memory,
                                self.network + other.network)

    def scalar(self) -> float:
        """Single comparable magnitude for plan enumeration."""
        return (self.cpu + MEMORY_WEIGHT * self.memory
                + NETWORK_WEIGHT * self.network)


ZERO_COST = PlanCostEstimate()


class CostCalculator:
    """Local (non-cumulative) cost of each plan node, given a
    StatsCalculator for its inputs. ``nshards`` is the mesh size the
    network model assumes; plan-time consumers use the default."""

    def __init__(self, nshards: int = DEFAULT_MESH_SHARDS,
                 broadcast_threshold: int | None = None):
        self.nshards = max(int(nshards), 1)
        self.broadcast_threshold = broadcast_threshold

    def join_cost(self, probe, build, out_rows: float,
                  build_types, probe_types,
                  distribution: str = "automatic") -> PlanCostEstimate:
        """Price one hash join from its side estimates: probe+build+
        output row-ops, the build hash table resident in HBM, and the
        distribution's ICI traffic."""
        build_bytes = build.output_bytes(build_types)
        probe_bytes = probe.output_bytes(probe_types)
        dist = decide_join_distribution(
            distribution if distribution != "automatic" else None,
            None, int(build.row_count), self.broadcast_threshold)
        if dist == "broadcast":
            net = broadcast_net_bytes(build_bytes, self.nshards)
            mem = build_bytes  # full build table on every device
        else:
            net = partitioned_net_bytes(probe_bytes, build_bytes,
                                        self.nshards)
            mem = build_bytes / self.nshards
        cpu = probe.row_count + 2.0 * build.row_count + out_rows
        return PlanCostEstimate(cpu, mem, net)

    def cost(self, node: N.PlanNode, stats) -> PlanCostEstimate:
        """Local cost of ``node``; ``stats`` is a StatsCalculator."""
        est = stats.stats(node)
        if isinstance(node, N.TableScan):
            return PlanCostEstimate(
                est.row_count, est.output_bytes(node.output_types()), 0)
        if isinstance(node, N.Join):
            probe = stats.stats(node.left)
            build = stats.stats(node.right)
            return self.join_cost(probe, build, est.row_count,
                                  node.right.output_types(),
                                  node.left.output_types(),
                                  node.distribution)
        if isinstance(node, N.MultiJoin):
            # fused star chain: each build priced like the binary join
            # it replaced (its own distribution), the probe estimate
            # FOLDING forward through each leg's unique-build
            # containment — an early selective dimension shrinks every
            # later leg's priced probe, exactly as the cascade's
            # per-join stats would
            total = PlanCostEstimate(est.row_count, 0, 0)
            cur = stats.stats(node.spine)
            for i, build in enumerate(node.builds):
                b = stats.stats(build)
                dist = (node.distributions[i]
                        if i < len(node.distributions) else "automatic")
                out_rows = max(
                    cur.row_count * min(b.selectivity, 1.0), 1.0)
                total = total.plus(self.join_cost(
                    cur, b, out_rows, build.output_types(),
                    node.spine.output_types(), dist))
                cur = dataclasses.replace(cur, row_count=out_rows)
            return total
        if isinstance(node, N.SemiJoin):
            src = stats.stats(node.source)
            filt = stats.stats(node.filter_source)
            fbytes = filt.output_bytes(
                node.filter_source.output_types())
            # filter side replicates (parallel executor semantics)
            return PlanCostEstimate(
                src.row_count + filt.row_count, fbytes,
                broadcast_net_bytes(fbytes, self.nshards))
        if isinstance(node, N.CrossJoin):
            left = stats.stats(node.left)
            right = stats.stats(node.right)
            rbytes = right.output_bytes(node.right.output_types())
            return PlanCostEstimate(
                est.row_count, rbytes,
                broadcast_net_bytes(rbytes, self.nshards))
        if isinstance(node, (N.Aggregate, N.Distinct, N.MarkDistinct)):
            src = stats.stats(node.sources()[0])
            out_bytes = est.output_bytes(node.output_types())
            # partial states gather (or repartition) across the mesh
            return PlanCostEstimate(
                src.row_count, out_bytes,
                broadcast_net_bytes(out_bytes, self.nshards))
        if isinstance(node, N.Exchange):
            src = stats.stats(node.source)
            bytes_ = src.output_bytes(node.output_types())
            if node.kind == N.ExchangeType.REPLICATE:
                net = broadcast_net_bytes(bytes_, self.nshards)
            else:  # gather / repartition move each row once
                net = partitioned_net_bytes(bytes_, 0.0, self.nshards)
            return PlanCostEstimate(src.row_count, 0, net)
        if isinstance(node, (N.Sort, N.TopN, N.Window,
                             N.MatchRecognize)):
            src = stats.stats(node.sources()[0])
            n = max(src.row_count, 2.0)
            return PlanCostEstimate(n * math.log2(n), 0, 0)
        # row-at-a-time operators: Filter/Project/Limit/Union/Unnest/
        # Values/Output and anything future
        srcs = node.sources()
        cpu = sum(stats.stats(s).row_count for s in srcs) \
            if srcs else est.row_count
        return PlanCostEstimate(cpu, 0, 0)
