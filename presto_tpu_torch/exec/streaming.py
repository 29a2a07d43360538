"""Block-streamed scan execution: the port of
``presto_tpu/exec/streaming.py``.

When a plan is one big scan feeding (through filters and projections)
one aggregation, the scan runs in blocks of ``scan_block_rows`` rows,
each through one PARTIAL aggregate program; the partial states (bounded
by the group count, not the table size) are concatenated on the device,
and the rest of the plan runs over them with a FINAL aggregate. A table
whose columns the engine does not hold goes up to the device one block
at a time, so a table larger than the card streams through it; columns
the engine already holds are sliced on the device.

Shape requirements (else another path runs): exactly one TableScan;
only Filter/Project between it and a SINGLE-step aggregate without
DISTINCT; anything above the aggregate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.plan import nodes as N


def _chain_to_scan(node: N.PlanNode) -> N.TableScan | None:
    """The TableScan under ``node`` if the path is all Filter/Project."""
    while isinstance(node, (N.Filter, N.Project)):
        node = node.source
    return node if isinstance(node, N.TableScan) else None


def _count_scans(plan: N.PlanNode) -> int:
    n = 1 if isinstance(plan, N.TableScan) else 0
    return n + sum(_count_scans(s) for s in plan.sources())


def _find_streamable(plan: N.PlanNode):
    """(aggregate, scan) when the plan is streamable, else None."""
    if _count_scans(plan) != 1:
        return None
    node = plan
    while not isinstance(node, N.Aggregate):
        srcs = node.sources()
        if len(srcs) != 1:
            return None
        node = srcs[0]
    if node.step != N.AggStep.SINGLE:
        return None
    if any(call.distinct for call in node.aggs.values()):
        return None
    scan = _chain_to_scan(node.source)
    if scan is None:
        return None
    return node, scan


def _replace_node(plan: N.PlanNode, target: N.PlanNode,
                  repl: N.PlanNode) -> N.PlanNode:
    if plan is target:
        return repl
    updates = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, N.PlanNode):
            updates[f.name] = _replace_node(v, target, repl)
        elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
            updates[f.name] = [_replace_node(x, target, repl) for x in v]
    return dataclasses.replace(plan, **updates) if updates else plan


def _block_input(engine, node: N.TableScan, tbl, lo: int, hi: int):
    """Rows [lo, hi) of the scanned table on the device: a slice of a
    column the engine holds, else an upload of the block alone."""
    from presto_tpu_torch.exec.executor import _scan_input

    def rows(a):
        dev = engine.resident(a)
        if dev is not None:
            return dev[lo:hi]
        return HS.upload(np.asarray(a)[lo:hi], engine.device, "scan-block")

    return _scan_input(engine, node, tbl, rows, hi - lo)


def try_execute_streamed(engine, plan: N.PlanNode):
    """Execute ``plan`` block-streamed, or return None if inapplicable."""
    from presto_tpu_torch.exec import operators as OP
    from presto_tpu_torch.exec.cancel import checkpoint
    from presto_tpu_torch.exec.executor import (
        ScanInput, carrier_arrays, prepare_plan, run_plan)

    block = int(engine.session.get("scan_block_rows") or 0)
    if block <= 0:
        return None
    found = _find_streamable(plan)
    if found is None:
        return None
    agg, scan_node = found
    tbl = engine.catalogs[scan_node.catalog].table(scan_node.table)
    if tbl.nrows <= block:
        return None

    # -- phase 1: one PARTIAL program per block; capacities grown on one
    # block's ladder carry to the next
    partial = dataclasses.replace(agg, step=N.AggStep.PARTIAL)
    nblocks = -(-tbl.nrows // block)
    capacities: dict[tuple, int] = {}
    parts = []
    for i in range(nblocks):
        checkpoint()
        scan = _block_input(engine, scan_node, tbl, i * block,
                            min((i + 1) * block, tbl.nrows))
        parts.append(prepare_plan(
            engine, partial, {id(scan_node): scan}, capacities,
            site="streaming-ok-ladder", collect_rows=False).out)

    # -- phase 2: the rest of the plan over the concatenated partials,
    # which stay on the device
    merged = OP.concat_dtables(parts)
    types = {sym: v.dtype for sym, v in merged.cols.items()}
    carrier = N.TableScan("__stream__", "__partials__",
                          {sym: sym for sym in merged.cols}, types)
    arrays = carrier_arrays(merged.cols)
    # every block's key dictionaries are the scan's (or one transform
    # of them), so the first block's stand for all
    dicts = {sym: v.dictionary for sym, v in merged.cols.items()}
    final_agg = dataclasses.replace(agg, source=carrier,
                                    step=N.AggStep.FINAL)
    engine.last_streamed_blocks = nblocks
    return run_plan(engine, _replace_node(plan, agg, final_agg),
                    {id(carrier): ScanInput(carrier, arrays, dicts, types,
                                            merged.n, merged.live)})
