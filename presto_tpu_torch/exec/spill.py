"""Host-partitioned spill under a memory budget, and grouped execution:
the port of ``presto_tpu/exec/spill.py``.

When the plan-time estimate (``memory.estimate_plan_memory``) exceeds
the session's ``query_max_memory_bytes``, the dominant join's build
AND probe inputs are materialized to host RAM (the spill medium),
hash-partitioned by the join keys on the host, and the join runs
partition by partition on the device, so the card holds one
partition's tables at a time. A plan whose root chain has no join but
a grouped aggregate partitions the aggregate's input by its group keys
instead. The rest of the plan then runs over the concatenated output.
Grouped execution (session ``grouped_execution``) runs a join of two
tables bucketed on its keys the same way, bucket by bucket.

The host side is the reference's numpy (``_value_hash``,
``_slice_table``, ``_concat_tables``); the sides run through
``executor.execute_part``, so their programs add to the query's
``engine.last_run``. Every partition goes up through
``hostsync.upload`` as a padded host-table carrier
(``exec/hostcarrier.carrier_scan``), and all partitions share one
capacity ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.exec.hostcarrier import carrier_scan, compact_table
from presto_tpu_torch.memory import (MemoryLimitExceeded,
                                     estimate_plan_memory)
from presto_tpu_torch.ops.sizes import next_pow2
from presto_tpu_torch.plan import nodes as N

MAX_PARTITIONS = 64


def _value_hash(tbl: Table, keys: list[str],
                null_canonical: bool = False) -> tuple:
    """(uint64 hash per row, all-keys-valid mask): value-based (strings
    hash their dictionary text), so probe and build partition alike
    whatever their dictionaries. ``null_canonical`` gives NULL values
    one sentinel, so group-equal key tuples (both NULL) hash equal, as
    the aggregation spill needs (joins drop NULL keys instead)."""
    from presto_tpu_torch.ops.hash import hash_string_dictionary

    n = tbl.nrows
    h = np.full(n, 0x243F6A8885A308D3, np.uint64)
    valid = np.ones(n, bool)
    for k in keys:
        c = tbl.columns[k]
        if c.dictionary is not None:
            lut = hash_string_dictionary(c.dictionary)
            if len(lut) == 0:
                v = np.zeros(n, np.int64)
            else:
                codes = np.clip(np.asarray(c.data).astype(np.int64),
                                0, len(lut) - 1)
                v = lut[codes].astype(np.int64)
        else:
            v = np.asarray(c.data).astype(np.int64)
        if null_canonical and c.valid is not None:
            v = np.where(np.asarray(c.valid), v, np.int64(0x5BD1E995))
        x = v.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        h = (h ^ x) * np.uint64(0x100000001B3)
        if c.valid is not None:
            valid &= np.asarray(c.valid)
    return h, valid


def _slice_table(tbl: Table, idx: np.ndarray) -> Table:
    cols = {s: Column(c.dtype, np.asarray(c.data)[idx],
                      None if c.valid is None else np.asarray(c.valid)[idx],
                      c.dictionary)
            for s, c in tbl.columns.items()}
    return Table(cols, len(idx), None)


def _concat_tables(parts: list[Table]) -> Table:
    cols: dict[str, Column] = {}
    live = np.concatenate([
        np.asarray(p.mask) if p.mask is not None
        else np.ones(p.nrows, bool) for p in parts])
    for s in parts[0].columns:
        cs = [p.columns[s] for p in parts]
        data = np.concatenate([np.asarray(c.data) for c in cs])
        if any(c.valid is not None for c in cs):
            valid = np.concatenate([
                np.asarray(c.valid) if c.valid is not None
                else np.ones(p.nrows, bool)
                for c, p in zip(cs, parts)])
        else:
            valid = None
        cols[s] = Column(cs[0].dtype, data, valid, cs[0].dictionary)
    return Table(cols, len(live), live)


def _empty_table(types: dict[str, T.DataType]) -> Table:
    """No rows of ``types``: a VARCHAR column keeps a dictionary."""
    return Table(
        {s: Column(t, np.empty(0, t.physical_dtype), None,
                   np.empty(0, object)
                   if isinstance(t, T.VarcharType) else None)
         for s, t in types.items()}, 0, None)


def _materialize(engine, plan: N.PlanNode) -> Table:
    """The live rows of a subplan on the host. It runs as a part of the
    query (``execute_part``), with ``engine._in_spill`` set: its own
    scans go to the host, which is the spill medium, so a subplan with
    nothing to spill does not fail the budget."""
    from presto_tpu_torch.exec.executor import execute_part
    before = engine._in_spill
    engine._in_spill = True
    try:
        return compact_table(execute_part(engine, plan))
    finally:
        engine._in_spill = before


def _partitions(total: int, budget: int) -> int:
    nparts = max(2, next_pow2(-(-total // budget)))
    if nparts > MAX_PARTITIONS:
        raise MemoryLimitExceeded(
            f"query estimated {total} bytes cannot be bounded by "
            f"query_max_memory_bytes={budget} within {MAX_PARTITIONS} "
            "spill partitions")
    return nparts


def _run_partitions(engine, root: N.PlanNode, part_inputs: list
                    ) -> list[Table]:
    """Run ``root``, a fragment over carrier scans, once per partition
    (the reference's ``_run_partitions`` and ``_run_partition_plans``):
    ``part_inputs`` holds one ScanInput per carrier scan of ``root``
    for each partition. All partitions share one capacity ladder: a
    capacity that overflows in one partition grows for the rest. Node
    rows are not collected (per-node totals of one fragment replayed
    over many partitions would misattribute)."""
    from presto_tpu_torch.exec.cancel import checkpoint
    from presto_tpu_torch.exec import executor as EX
    capacities: dict[tuple, int] = {}
    outs = []
    for inputs in part_inputs:
        checkpoint()
        scans = {id(inp.node): inp for inp in inputs}
        # each partition's inputs and outputs are reserved in the
        # engine's memory pool while it runs
        with EX.pool_tag(engine, "spill-") as tag:
            EX.reserve(engine, tag, EX.input_tensors(scans))
            prog = EX.prepare_plan(engine, root, scans, capacities,
                                   site="spill-ok-ladder",
                                   collect_rows=False)
            EX.reserve(engine, tag, EX.output_tensors(prog.out))
            outs.append(EX.fetch_table(engine, root, prog,
                                       "spill-demux"))
    return outs


def _resume(engine, plan: N.PlanNode, node: N.PlanNode, name: str,
            merged: Table) -> Table:
    """The rest of ``plan`` over ``merged``, the rows that ``node``
    produced partition by partition, served as a carrier scan."""
    from presto_tpu_torch.exec.executor import collect_scans, run_plan
    from presto_tpu_torch.exec.streaming import _replace_node
    cnode, cinput = carrier_scan(engine, name, merged,
                                 site="spill-partition")
    rest = _replace_node(plan, node, cnode)
    return run_plan(engine, rest,
                    collect_scans(rest, engine, {cnode.table: cinput}))


def _spill_aggregate(engine, plan: N.PlanNode, agg: N.Aggregate,
                     total: int, budget: int) -> Table:
    """Aggregation spill: hash-partition the aggregate's input rows by
    its GROUP KEYS on the host and aggregate partition by partition.
    Groups cannot span partitions, so the per-partition SINGLE
    aggregates concatenate to the exact global result."""
    input_tbl = _materialize(engine, agg.source)
    nparts = _partitions(total, budget)
    h, _valid = _value_hash(input_tbl, agg.group_keys, null_canonical=True)
    part = (h % np.uint64(nparts)).astype(np.int64)
    counts = np.bincount(part, minlength=nparts)
    # every partition padded to one pow2 width, dead rows masked (the
    # reference's shapes; the rows do not depend on it)
    pmax = next_pow2(max(int(counts.max()), 1))
    pcap = next_pow2(max(2 * min(pmax, agg.capacity or pmax), 16))
    part_inputs, ap = [], None
    for p in range(nparts):
        if counts[p] == 0:
            continue
        tp = _slice_table(input_tbl, np.nonzero(part == p)[0])
        cnode, cinput = carrier_scan(engine, "agg_part", tp, pad_to=pmax,
                                     site="spill-partition")
        if ap is None:
            ap = dataclasses.replace(agg, source=cnode, capacity=pcap)
        part_inputs.append((dataclasses.replace(cinput, node=ap.source),))
    outs = _run_partitions(engine, ap, part_inputs) if part_inputs else []
    merged = (_concat_tables(outs) if outs
              else _empty_table(dict(agg.output_types())))
    engine.last_spill = {"partitions": nparts, "kind": "aggregate",
                         "input_rows": input_tbl.nrows,
                         "estimated_bytes": total, "budget": budget}
    return _resume(engine, plan, agg, "__aggregated__", merged)


def try_execute_spilled(engine, plan: N.PlanNode):
    """Execute with host-partitioned spill, or return None when the
    budget (``query_max_memory_bytes``) is unset or the plan fits.

    Over budget, the first join on the plan's root chain spills (its
    sides run through ``execute_part``, which checks them again, so
    nested joins cascade); failing a join, the first SINGLE grouped
    aggregate spills by its group keys; a plan with neither fails with
    MemoryLimitExceeded, except inside a spill driver's own subplans,
    whose results go to the host by design."""
    budget = int(engine.session.get("query_max_memory_bytes") or 0)
    if budget <= 0:
        return None
    total, _per_node = estimate_plan_memory(plan, engine)
    if total <= budget:
        return None
    if not engine.session.get("spill_enabled"):
        raise MemoryLimitExceeded(
            f"query estimated {total} bytes exceeds "
            f"query_max_memory_bytes={budget} and spill is disabled")
    # the spill partitions root-chain Join nodes by their keys; under
    # memory pressure that outranks multi-way fusion
    from presto_tpu_torch.plan.optimizer import unfuse_multijoin
    plan = unfuse_multijoin(plan)
    node, grouped_agg = plan, None
    while not (isinstance(node, N.Join) and node.criteria):
        if isinstance(node, N.Aggregate) and node.group_keys \
                and node.step == N.AggStep.SINGLE and grouped_agg is None:
            grouped_agg = node
        srcs = node.sources()
        if len(srcs) != 1:
            if grouped_agg is not None:
                return _spill_aggregate(engine, plan, grouped_agg, total,
                                        budget)
            if engine._in_spill:
                return None  # a spill driver's subplan: already on host
            raise MemoryLimitExceeded(
                f"query estimated {total} bytes exceeds "
                f"query_max_memory_bytes={budget} and this plan shape "
                "has no spillable join on its root chain")
        node = srcs[0]
    nparts = _partitions(total, budget)
    merged, build_rows = _partitioned_join_exec(engine, node, nparts)
    engine.last_spill = {"partitions": nparts, "build_rows": build_rows,
                         "estimated_bytes": total, "budget": budget}
    return _resume(engine, plan, node, "__joined__", merged)


def _partitioned_join_exec(engine, join: N.Join, nparts: int) -> tuple:
    """Materialize both join sides to the host, hash-partition them by
    the join keys and run the join partition by partition: (the joined
    rows, the build side's rows). Shared by the spill and grouped
    execution; only what decides ``nparts`` differs."""
    build_tbl = _materialize(engine, join.right)
    probe_tbl = _materialize(engine, join.left)
    ph, pvalid = _value_hash(probe_tbl, [lk for lk, _ in join.criteria])
    bh, bvalid = _value_hash(build_tbl, [rk for _, rk in join.criteria])
    ppart = (ph % np.uint64(nparts)).astype(np.int64)
    bpart = (bh % np.uint64(nparts)).astype(np.int64)
    # NULL-key rows never match: drop them from the build always, and
    # from the probe unless the join is outer (those rows still emit)
    if join.join_type != N.JoinType.LEFT:
        ppart[~pvalid] = -1
    bpart[~bvalid] = -1
    pcounts = np.bincount(ppart[ppart >= 0], minlength=nparts)
    # every partition padded to one pow2 width per side (the reference's
    # shapes and hints; the rows do not depend on it)
    pmax = next_pow2(max(int(pcounts.max()), 1))
    bmax = next_pow2(max(int(np.bincount(
        bpart[bpart >= 0], minlength=nparts).max()), 1))
    part_inputs, jp = [], None
    for p in range(nparts):
        if pcounts[p] == 0:
            continue
        pnode, pinput = carrier_scan(
            engine, "probe_part", _slice_table(
                probe_tbl, np.nonzero(ppart == p)[0]),
            pad_to=pmax, site="spill-partition")
        bnode, binput = carrier_scan(
            engine, "build_part", _slice_table(
                build_tbl, np.nonzero(bpart == p)[0]),
            pad_to=bmax, site="spill-partition")
        if jp is None:
            jp = dataclasses.replace(
                join, left=pnode, right=bnode, build_rows=bmax,
                capacity=next_pow2(2 * bmax),
                output_capacity=None if join.build_unique
                else next_pow2(2 * (pmax + bmax)))
        part_inputs.append((dataclasses.replace(pinput, node=jp.left),
                            dataclasses.replace(binput, node=jp.right)))
    outs = _run_partitions(engine, jp, part_inputs) if part_inputs else []
    merged = (_concat_tables(outs) if outs
              else _empty_table(dict(join.output_types())))
    return merged, build_tbl.nrows


# -- grouped execution (lifespans) ------------------------------------------


def partitioning_symbols(connector, node: N.TableScan
                         ) -> tuple[str, ...] | None:
    """The connector's declared partitioning of a scanned table as the
    scan's symbols, or None when undeclared or not fully scanned."""
    declared = connector.partitioning(node.table)
    if not declared:
        return None
    by_col = {c: s for s, c in node.assignments.items()}
    if not all(c in by_col for c in declared):
        return None
    return tuple(by_col[c] for c in declared)


def _bucketed_keys(engine, node: N.PlanNode):
    """Connector-declared partitioning symbols of a Filter*/TableScan
    subtree, or None."""
    while isinstance(node, N.Filter):
        node = node.source
    if not isinstance(node, N.TableScan):
        return None
    conn = engine.catalogs.get(node.catalog)
    if conn is None:
        return None
    return partitioning_symbols(conn, node)


def try_execute_grouped(engine, plan: N.PlanNode):
    """Grouped execution over co-bucketed tables (session
    ``grouped_execution``): when both sides of the first join on the
    root chain scan tables whose connector-defined partitioning IS the
    join key, run the join bucket by bucket, so the card holds one
    bucket's working set. None when it does not apply."""
    if not engine.session.get("grouped_execution"):
        return None
    node = plan
    while not (isinstance(node, N.Join) and node.criteria):
        srcs = node.sources()
        if len(srcs) != 1:
            return None
        node = srcs[0]
    lkeys = tuple(lk for lk, _ in node.criteria)
    rkeys = tuple(rk for _, rk in node.criteria)
    if (_bucketed_keys(engine, node.left) != lkeys
            or _bucketed_keys(engine, node.right) != rkeys):
        return None
    nparts = max(1, int(engine.session.get("grouped_execution_partitions")))
    merged, build_rows = _partitioned_join_exec(engine, node, nparts)
    engine.last_grouped = {"partitions": nparts, "build_rows": build_rows,
                           "keys": list(lkeys)}
    return _resume(engine, plan, node, "__joined__", merged)
