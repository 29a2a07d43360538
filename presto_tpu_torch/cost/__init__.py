"""Cost-based optimizer subsystem.

The engine's analog of the reference's ``io.trino.cost`` package:

- :mod:`presto_tpu_torch.cost.stats` — StatsCalculator, per-PlanNode
  bottom-up propagation of PlanNodeStatsEstimate (rows, per-symbol
  NDV/range/null fraction, bytes) seeded from the connector TableStats
  SPI;
- :mod:`presto_tpu_torch.cost.model` — CostCalculator pricing CPU, memory
  and mesh-aware ICI network per node, plus the single
  broadcast-vs-partitioned decision and dense-span gate every physical
  chooser consults;
- :mod:`presto_tpu_torch.cost.reorder` — the ReorderJoins optimizer rule (DP
  up to 8 relations, greedy above), wired into plan/optimizer.py
  behind ``optimizer_join_reordering_strategy``;
- :mod:`presto_tpu_torch.cost.skew` — the heavy-hitter/salting decision
  refining "partitioned" into "hybrid" joins (hot build keys
  broadcast, cold tail hash-partitioned) from ledger-seeded NDV
  statistics.
"""

from __future__ import annotations

from presto_tpu_torch.cost.model import (CostCalculator, PlanCostEstimate,
                                   decide_join_distribution,
                                   dense_span_eligible)
from presto_tpu_torch.cost.reorder import reorder_joins
from presto_tpu_torch.cost.skew import SkewDecision, decide_skew
from presto_tpu_torch.cost.stats import (PlanNodeStatsEstimate, StatsCalculator,
                                   SymbolStats)

__all__ = [
    "CostCalculator", "PlanCostEstimate", "PlanNodeStatsEstimate",
    "SkewDecision", "StatsCalculator", "SymbolStats",
    "decide_join_distribution", "decide_skew", "dense_span_eligible",
    "explain_estimates", "reorder_joins", "row_estimates",
]


def _fmt(v: float) -> str:
    """Compact magnitude for EXPLAIN (62.5k, 1.2M)."""
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if v >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def explain_estimates(plan, engine) -> dict[int, str]:
    """id(node) -> 'Estimates: {...}' detail line for EXPLAIN output
    (reference planprinter/PlanPrinter.formatEstimates). Never raises:
    a node whose stats blow up is simply left unannotated."""
    stats = StatsCalculator(engine)
    cost = CostCalculator()
    out: dict[int, str] = {}

    def visit(node) -> None:
        try:
            est = stats.stats(node)
            c = cost.cost(node, stats)
            mark = "" if est.confident else "?"
            out[id(node)] = (
                f"Estimates: {{rows: {int(est.row_count)}{mark} "
                f"({_fmt(est.output_bytes(node.output_types()))}B), "
                f"cpu: {_fmt(c.cpu)}, memory: {_fmt(c.memory)}B, "
                f"network: {_fmt(c.network)}B}}")
        except Exception:
            pass
        for s in node.sources():
            visit(s)

    visit(plan)
    return out


def row_estimates(plan, engine) -> dict[int, int]:
    """id(node) -> estimated output rows, for EXPLAIN ANALYZE's
    estimated-vs-actual annotations."""
    stats = StatsCalculator(engine)
    out: dict[int, int] = {}

    def visit(node) -> None:
        try:
            out[id(node)] = int(stats.stats(node).row_count)
        except Exception:
            pass
        for s in node.sources():
            visit(s)

    visit(plan)
    return out
