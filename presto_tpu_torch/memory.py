"""Plan-time device-memory accounting: the port of
``presto_tpu/memory.py`` (its estimate, not its runtime pool).

Every operator's output is a fixed-capacity masked table, so walking
the plan and summing capacity x row width bounds a program's working
set before it runs. The estimate is host arithmetic over plan types and
connector row counts: on the same plan it equals the reference's byte
for byte.

The session's ``query_max_memory_bytes`` is enforced by
``exec/spill.try_execute_spilled``: an over-budget plan fails with
MemoryLimitExceeded (``spill_enabled=false``) or runs its dominant join
or grouped aggregate host-partitioned. ``MemoryPool`` and
``MemoryKilledError`` belong to the serving tier and are not ported
yet.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.plan import nodes as N


class MemoryLimitExceeded(RuntimeError):
    """Reference ExceededMemoryLimitException analog."""


def _row_bytes(types: dict[str, T.DataType]) -> int:
    # +1 byte per column approximates the validity sibling array;
    # LONG decimals are two int64 limbs per value
    return sum(
        t.physical_dtype.itemsize
        * (2 if isinstance(t, T.DecimalType) and t.is_long else 1) + 1
        for t in types.values())


@dataclasses.dataclass
class NodeMemory:
    node: N.PlanNode
    rows: int          # estimated output rows (static capacity)
    resident: int      # bytes this node's outputs + tables hold


def estimate_plan_memory(plan: N.PlanNode, engine
                         ) -> tuple[int, list[NodeMemory]]:
    """(total peak bytes, per-node breakdown) for a logical plan.

    The model charges every node its output arrays (capacity x row
    width) plus hash-table state where applicable — an upper bound for
    the fused XLA program, which holds at most all intermediates at
    once and typically fewer after fusion.
    """
    per_node: list[NodeMemory] = []

    def rows_of(node: N.PlanNode) -> int:
        return next(m.rows for m in per_node if m.node is node)

    def visit(node: N.PlanNode) -> int:
        for s in node.sources():
            visit(s)
        width = _row_bytes(node.output_types())
        if isinstance(node, N.TableScan):
            rows = engine.catalogs[node.catalog].row_count_estimate(
                node.table)
            resident = rows * width
        elif isinstance(node, (N.Filter, N.Project)):
            # masked in place: charge the new columns only
            rows = rows_of(node.source)
            if isinstance(node, N.Project):
                resident = rows * width
            else:
                resident = rows  # live-mask bytes
        elif isinstance(node, N.Aggregate):
            rows = node.capacity or 1024
            resident = rows * width + rows * 8  # slot hash table
        elif isinstance(node, (N.Distinct, N.MarkDistinct)):
            rows = rows_of(node.source)
            cap = node.capacity or rows
            resident = rows * width + cap * 8
        elif isinstance(node, N.Join):
            build = rows_of(node.right)
            cap = node.capacity or 2 * build
            if node.build_unique:
                rows = rows_of(node.left)
            else:
                rows = node.output_capacity or (rows_of(node.left) + build)
            # table: hash + row-id per slot; output: full width
            resident = cap * 16 + rows * width
        elif isinstance(node, N.MultiJoin):
            # probe-preserving fused chain: output at spine width, one
            # sorted build side resident per leg (hash + index per row)
            rows = rows_of(node.spine)
            resident = rows * width + sum(
                rows_of(b) * 16 for b in node.builds)
        elif isinstance(node, N.SemiJoin):
            rows = rows_of(node.source)
            cap = node.capacity or 2 * rows_of(node.filter_source)
            resident = cap * 16 + rows
        elif isinstance(node, N.CrossJoin):
            rows = rows_of(node.left)
            resident = rows * width
        elif isinstance(node, (N.Sort, N.Window)):
            rows = rows_of(node.source)
            resident = rows * width  # permuted copy
        elif isinstance(node, (N.TopN, N.Limit, N.Exchange, N.Output)):
            rows = rows_of(node.source)
            resident = rows * width if isinstance(node, N.TopN) else 0
        elif isinstance(node, N.Union):
            rows = sum(rows_of(s) for s in node.inputs)
            resident = rows * width
        elif isinstance(node, N.Values):
            rows = len(node.rows)
            resident = rows * width
        else:
            rows = max((rows_of(s) for s in node.sources()), default=1)
            resident = rows * width
        per_node.append(NodeMemory(node, max(rows, 1), resident))
        return rows

    visit(plan)
    return sum(m.resident for m in per_node), per_node


def largest_join(per_node: list[NodeMemory]) -> N.Join | None:
    """The Join with the biggest estimated build side, if any."""
    best, best_rows = None, -1
    by_node = {id(m.node): m for m in per_node}
    for m in per_node:
        if isinstance(m.node, N.Join):
            build = by_node[id(m.node.right)].rows
            if build > best_rows:
                best, best_rows = m.node, build
    return best
