"""EXPLAIN ANALYZE on one device: the port of
``presto_tpu/exec/profile.py`` (``explain_analyze_distributed`` comes
with the distributed tier).

The plan runs as ``execute_plan`` would segment it; every program
already brings back the live rows out of each of its nodes with its ok
flags (``engine.last_run.node_rows``), so the profile annotates each
node with its actual rows beside the planner's estimate, and adds no
host sync of its own. Each segment reports its host time up to its
counted live-rows fetch (``device_outputs``), its live rows and its
carrier's width; the final program its time up to its result fetch
and its interpreter passes.
"""

from __future__ import annotations

import time

from presto_tpu_torch.cost import row_estimates
from presto_tpu_torch.plan import nodes as N
from presto_tpu_torch.plan.printer import format_plan


def _rows_by_node_id(engine, plan: N.PlanNode, index: int
                     ) -> dict[int, int]:
    """Actual rows by id(node) of ``plan``'s objects, from the node
    rows that program ``index`` of ``engine.last_run`` brought back
    (keyed by stable preorder position)."""
    from presto_tpu_torch.exec.executor import preorder_index
    inv = {pos: nid for nid, pos in preorder_index(plan).items()}
    return {inv[pos]: rows
            for (i, pos), rows in engine.last_run.node_rows.items()
            if i == index and pos in inv}


def _profiled_runner(engine, mat, scans, cnode) -> tuple:
    """A segment runner that also returns the segment's actual rows
    by node id."""
    from presto_tpu_torch.exec.executor import run_plan_device
    carrier = run_plan_device(engine, mat, scans, cnode)
    index = len(engine.last_run.programs) - 1
    return carrier, _rows_by_node_id(engine, mat, index)


def _annotate(mat: N.PlanNode, node_rows: dict | None, engine
              ) -> dict[int, str]:
    """Per-node 'rows: actual (est N)' annotations for one program."""
    if not node_rows:
        return {}
    estimated = row_estimates(mat, engine)
    return {nid: (f"rows: {actual}" if estimated.get(nid) is None
                  else f"rows: {actual} (est {estimated[nid]})")
            for nid, actual in node_rows.items()}


def explain_analyze(engine, plan: N.PlanNode) -> str:
    """Run ``plan`` segment by segment and print each segment's plan
    and the final program's, every node annotated with its actual
    rows. ``engine.last_run`` holds the run's programs afterwards."""
    from presto_tpu_torch.exec import executor as EX

    engine.last_run = EX.QueryRun()
    engine.last_kernel_notes = {}
    engine.last_streamed_blocks = 0
    seg_lines: list[str] = []
    total_t0 = time.perf_counter()

    def observe(seg, mat, carrier, wall_s, node_rows):
        # the rows out of the segment's root are its carrier's live rows
        live = node_rows[id(mat)]
        seg_lines.append(
            f"Segment {seg} ({wall_s * 1e3:.1f} ms, "
            f"{live} live rows -> s{seg}[{carrier.nrows}])\n"
            + format_plan(mat, annotations=_annotate(mat, node_rows,
                                                     engine)))

    plan, carriers = EX._segment_carriers(engine, plan, observer=observe,
                                          runner=_profiled_runner)
    final = _explain_one_program(engine, plan, EX.collect_scans(
        plan, engine, carriers))
    if not seg_lines:
        return final
    total = (time.perf_counter() - total_t0) * 1e3
    return (f"Query plan: {len(seg_lines)} materialized segment(s) + "
            f"final program, total {total:.1f} ms\n"
            + "\n".join(seg_lines)
            + "\nFinal " + final)


def _explain_one_program(engine, plan: N.PlanNode, scans) -> str:
    from presto_tpu_torch.exec.executor import run_plan
    t0 = time.perf_counter()
    run_plan(engine, plan, scans)
    run_s = time.perf_counter() - t0
    index = len(engine.last_run.programs) - 1
    rows = _rows_by_node_id(engine, plan, index)
    passes = engine.last_run.passes[index]
    header = (f"Query plan (execute {run_s * 1e3:.1f} ms, "
              f"{passes} pass{'es' if passes > 1 else ''})\n")
    return header + format_plan(plan, annotations=_annotate(plan, rows,
                                                            engine))
