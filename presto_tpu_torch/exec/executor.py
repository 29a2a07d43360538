"""Plan executor: logical plan -> eager tensor operators -> host Table.

The port of ``presto_tpu/exec/executor.py``. The reference traces each
program into one XLA computation; here the ``PlanInterpreter`` walks a
program's plan and runs each operator eagerly on the engine's device.

``execute_plan`` takes the reference's default route, in its order:

0. Around a MATCH_RECOGNIZE node (its input on the device, the pattern
   automaton on the host, ``exec/match_recognize.py``) or a
   variable-length aggregate (``exec/varlen.py``), the rest of the
   plan runs over the host result as a host-table carrier
   (``exec/hostcarrier.py``).
1. Block streaming (``exec/streaming.py``): one scan of more than
   ``scan_block_rows`` rows under a SINGLE aggregate runs as one
   PARTIAL program per block, then a FINAL program over the partials.
2. Segmented execution: a plan with more than ``MAX_JOINS_PER_PROGRAM``
   joins, or a grouped aggregate above a join over at least
   ``AGG_SPLIT_MIN_ROWS`` scan rows, runs as a sequence of programs.
   Each segment materializes a subtree as a device-resident carrier
   scan, pruned to the columns used above it and compacted to
   pow2(live rows) when that at least halves it.
3. The whole plan as one program.

Hash-table capacities follow the reference: planner hints (pow2) or a
2x-input default; every operator that can overflow returns a 0-d
``ok`` tensor. Each program runs its own capacity retry ladder: the ok
flags and the live rows out of every plan node come back in ONE host
sync after a pass, and on overflow every failed capacity grows
RETRY_GROWTH x and the program (not the query) runs again.

Dynamic filtering (session ``enable_dynamic_filtering``): a one-hash
bloom of each inner join's build keys kills probe rows at the first
node of the probe subtree that outputs the key.

A carrier ships each symbol's data with its companions: ``$valid``,
and an ARRAY's ``$len`` and ``$emask`` (``carrier_arrays``).

Under a memory budget (session ``query_max_memory_bytes``) a plan
whose estimate exceeds it runs its dominant join or grouped aggregate
host-partitioned, and with ``grouped_execution`` a join of co-bucketed
tables runs bucket by bucket (``exec/spill.py``); both come after
streaming and before segmentation, as in the reference.

Repeat queries: each program's successful capacity vector is
remembered under its cache key (``engine._caps_memory``), so the next
run of the same program, or of a literal variant of it when
``plan_templates`` is on, starts from it instead of climbing the
ladder again; the program cache (``exec/progcache.py``) holds each
program's meta under the same key. A cancellation token or the
``query_max_run_time`` deadline is checked at every rung, streamed
block, segment and spill partition (``exec/cancel.py``).

A fresh engine, process or worker starts from what another learned
when ``PRESTO_TPU_PROGRAM_CACHE_DIR`` names a shared persistent store:
each program's capacity vector and device cost (exec/progcache.py).

Left out (ROADMAP): the reference's serialized executables (eager
PyTorch has none), the template carrier-width floor (carriers keep
the reference's exact rule, ``cap_floor=None``), the parallel segment
pool (segments run in order on one stream), and every plan node
outside TableScan, Values, Filter, Project, Aggregate, Join,
MultiJoin, SemiJoin, CrossJoin, Union, Window, MarkDistinct,
Distinct, Unnest, MatchRecognize, Sort, TopN, Limit, Exchange and
Output (each raises NotImplementedError).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
import uuid

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table, lists_from_padded
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr import aggmeta as A
from presto_tpu_torch.expr.compile import Val, is_long_dec
from presto_tpu_torch.obs.trace import TRACER
from presto_tpu_torch.ops import hash as H
from presto_tpu_torch.ops.hash import HashChainOverflow, grow_overflowed
from presto_tpu_torch.ops.sizes import next_pow2
from presto_tpu_torch.plan import nodes as N

# dispatch-exhaustiveness opt-outs (lint/dispatch.py): node types the
# PlanInterpreter deliberately has no _r_ handler for
DISPATCH_EXEMPT = {
    "MatchRecognize": "execute_plan splits the plan at the "
    "MatchRecognize node before interpretation (host-side NFA, see "
    "_execute_with_match_recognize); a node reaching the interpreter "
    "fails loudly in run()",
}

RETRY_GROWTH = 4  # overshoot on overflow to bound re-runs at ~1
MAX_ATTEMPTS = 6
# the first group capacity of an aggregate with a sketch (about 9 MB of
# registers and reservoir cells; the ladder reaches 2^19 slots)
SKETCH_FIRST_RUNG = 512

# The reference cuts plans with more joins than this into segments
# because XLA compile time grows superlinearly with program size. Eager
# torch compiles nothing, but the cut stays: it decides where carriers
# are compacted and which program a failed capacity re-runs.
MAX_JOINS_PER_PROGRAM = 2
# minimum estimated scan rows under an aggregate before its input gets
# its own compaction boundary
AGG_SPLIT_MIN_ROWS = 1 << 21
SEGMENT_CATALOG = "__segment__"
# the companion arrays a carrier ships beside a symbol's data: its NULL
# mask, and an ARRAY's lengths and element mask
COMPANIONS = ("valid", "len", "emask")


@dataclasses.dataclass
class ScanInput:
    """Device tensors + metadata for one TableScan."""

    node: N.TableScan
    arrays: dict[str, torch.Tensor]  # symbol (and symbol$valid) -> data
    dictionaries: dict[str, np.ndarray | None]
    types: dict[str, T.DataType]
    nrows: int
    live: torch.Tensor | None = None
    # set by the distributed path (parallel/executor.py): the
    # connector-declared partitioning as this scan's symbols, whether
    # its rows were placed on the shards by that key's hash (not in
    # blocks), and the connector's host table, whose partitioning
    # columns the placement reads
    part_cols: tuple[str, ...] | None = None
    bucketed: bool = False
    host_table: object = None


@dataclasses.dataclass
class QueryRun:
    """What the engine's last query ran, over all its programs
    (streamed blocks, segments, the final plan) in the order they ran."""

    programs: list = dataclasses.field(default_factory=list)
    # interpreter passes of each program: 1 + its capacity rungs
    passes: list[int] = dataclasses.field(default_factory=list)
    # (program, preorder position) -> live rows out of that node
    node_rows: dict[tuple[int, int], int] = dataclasses.field(
        default_factory=dict)
    # the subtrees materialized as carriers, wave by wave
    segments: list[list[N.PlanNode]] = dataclasses.field(
        default_factory=list)
    # per program: did its first pass start from remembered capacities
    # (the capacity memory, keyed like the program cache)?
    from_memory: list[bool] = dataclasses.field(default_factory=list)
    # per program: its device cost (obs/devprof.harvest), counted on its
    # first pass in the process or known since (devprof.known_cost);
    # None outside the cache
    costs: list = dataclasses.field(default_factory=list)
    # the route execute_part took for the whole plan: whole, segmented,
    # streamed, spilled, grouped, varlen or match_recognize
    route: str | None = None

    @property
    def rungs(self) -> int:
        return sum(self.passes) - len(self.passes)


def scan_live_rows(engine, table: str) -> list[int]:
    """Live rows out of every scan of ``table`` in the engine's last
    query (after dynamic filtering), in program order."""
    run = engine.last_run
    return [run.node_rows[(i, pos)]
            for i, plan in enumerate(run.programs)
            for pos, node in enumerate(_preorder(plan))
            if isinstance(node, N.TableScan) and node.table == table
            and (i, pos) in run.node_rows]


def _scan_input(engine, node: N.TableScan, tbl, to_device, nrows: int
                ) -> ScanInput:
    """The scanned columns of connector table ``tbl``, each put on the
    device by ``to_device`` (host array -> tensor of ``nrows`` rows).
    An ARRAY column of host lists goes up in the padded 2-D layout
    (``Engine.host_lists``) with its ``$len`` and ``$emask``
    companions."""
    arrays, dicts, types = {}, {}, {}
    for sym, colname in node.assignments.items():
        col = tbl.columns[colname]
        if isinstance(col.dtype, T.ArrayType):
            d2, lens, emask, dictionary = engine.host_lists(
                col.dtype.element, col.data)
            arrays[sym] = to_device(d2)
            arrays[f"{sym}$len"] = to_device(lens)
            arrays[f"{sym}$emask"] = to_device(emask)
            dicts[sym] = dictionary
        else:
            arrays[sym] = to_device(col.data)
            dicts[sym] = col.dictionary
        if col.valid is not None:
            arrays[f"{sym}$valid"] = to_device(col.valid)
        types[sym] = col.dtype
    live = None if tbl.mask is None else to_device(tbl.mask)
    return ScanInput(node, arrays, dicts, types, nrows, live)


def collect_scans(plan: N.PlanNode, engine,
                  carriers: dict[str, ScanInput] | None = None
                  ) -> dict[int, ScanInput]:
    """id(TableScan) -> its input: a connector table's columns, or a
    segment carrier of ``carriers`` found by its unique table name, so
    that a scan node rebuilt by column pruning still finds it (the
    reference's _collect_with_carriers). A table's columns go to the
    device once per (table, column) and stay cached by the engine."""
    # a loop, not a recursive closure: a closure that calls itself is a
    # reference cycle, and ``out``'s device tensors would outlive the
    # query until the cycle collector ran
    out: dict[int, ScanInput] = {}
    for node in _preorder(plan):
        if not isinstance(node, N.TableScan):
            continue
        if node.catalog == SEGMENT_CATALOG:
            out[id(node)] = _rebind_carrier(carriers[node.table], node)
        else:
            tbl = engine.catalogs[node.catalog].table(node.table)
            out[id(node)] = _scan_input(engine, node, tbl,
                                        engine.device_array, tbl.nrows)
            out[id(node)].host_table = tbl
    return out


def _rebind_carrier(si: ScanInput, node: N.TableScan) -> ScanInput:
    """A carrier re-pointed at a rebuilt (possibly column-narrowed)
    copy of its scan node, arrays restricted to the surviving symbols
    and their $valid companions."""
    if node is si.node and set(node.assignments) == set(si.types):
        return si
    keep = set(node.assignments)

    def base(k: str) -> str:
        # partial-aggregate state symbols contain '$' too ("rev$sum"):
        # only a companion suffix strips
        b, sep, suffix = k.rpartition("$")
        return b if sep and suffix in COMPANIONS else k

    return dataclasses.replace(
        si, node=node,
        arrays={k: v for k, v in si.arrays.items() if base(k) in keep},
        dictionaries={s: si.dictionaries.get(s) for s in keep},
        types={s: si.types[s] for s in keep})


def _df_hash(v: Val) -> torch.Tensor:
    """Content hash of a key column for dynamic-filter blooms (int64 bit
    patterns of the reference's uint64 hashes)."""
    if v.is_string:
        return H.hash_string_column(v.data, v.dictionary, v.valid)
    return H.hash_int_column(v.data, v.valid)


def bloom_bits(build: DTable, rk: str, max_bits: int) -> torch.Tensor:
    """A one-hash bloom (bool [m], m a power of two) of the live,
    non-NULL values of ``build``'s key ``rk``: m is four times the
    build's rows, at least 64 and at most ``max_bits``."""
    live = build.live_mask()
    m = next_pow2(min(4 * max(build.n, 16), max_bits))
    v = build.cols[rk]
    w = live if v.valid is None else (live & v.valid)
    # dead and NULL keys land in slot m, which is dropped
    slots = (_df_hash(v) & (m - 1)).masked_fill(~w, m)
    bits = torch.zeros(m + 1, dtype=torch.bool, device=build.device)
    return bits.index_fill(0, slots, True)[:m]


def apply_blooms(dt: DTable, blooms: dict[str, torch.Tensor]) -> DTable:
    """``dt`` with the rows whose key misses a bloom of ``blooms``
    (symbol -> bits) marked dead."""
    keep = None
    for sym, bits in blooms.items():
        v = dt.cols[sym]
        # the reference's h % m for a pow2 m; the mask bounds the
        # gather's index to [0, m)
        k = bits.index_select(0, _df_hash(v) & (bits.shape[0] - 1))
        if v.valid is not None:
            k = k & v.valid  # NULL keys never match an inner join
        keep = k if keep is None else (keep & k)
    if keep is None:
        return dt
    live = keep if dt.live is None else (dt.live & keep)
    return DTable(dt.cols, live, dt.n, dt.device)


def _preorder(node: N.PlanNode):
    yield node
    for s in node.sources():
        yield from _preorder(s)


def preorder_index(plan: N.PlanNode) -> dict[int, int]:
    """id(node) -> stable preorder position (capacity-override keys)."""
    return {id(node): i for i, node in enumerate(_preorder(plan))}


class PlanInterpreter:
    """Walks the plan, running each operator on ``device``."""

    def __init__(self, scans: dict[int, ScanInput],
                 capacities: dict[tuple, int], session, device,
                 node_order: dict[int, int] | None = None):
        self.scans = scans
        self.capacities = capacities  # (node pos, kind) -> forced capacity
        self.session = session
        self.device = torch.device(device)
        self.node_order = node_order or {}
        self.ok_flags: list = []
        self.ok_keys: list[tuple] = []
        self.used_capacity: dict[tuple, int] = {}
        # stable preorder position -> ["cuda:join_lookup", ...] noted
        # by the kernel entries while this node ran
        self.kernel_used: dict[object, list[str]] = {}
        # live rows out of every node: (preorder position, 0-d count)
        self.collect_rows = True
        self.row_counts: list[tuple[object, torch.Tensor]] = []
        # dynamic filtering: probe-key symbol -> bloom bits of the build
        # side's keys, applied once, at the first node that outputs it
        self.dyn_filters: dict[str, torch.Tensor] = {}
        self._df_applied: set[str] = set()

    def run(self, node: N.PlanNode) -> DTable:
        from presto_tpu_torch import kernels as K
        m = getattr(self, "_r_" + type(node).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(
                f"plan node {type(node).__name__} is not ported to "
                "presto_tpu_torch yet")
        with K.collect() as used, TRACER.span(type(node).__name__):
            dt = m(node)
        key = self.node_order.get(id(node), id(node))
        if used:
            self.kernel_used[key] = list(used)
        if self.dyn_filters:
            dt = self._apply_dyn_filters(dt)
        if self.collect_rows:
            self.row_counts.append((key, torch.sum(
                dt.live_mask().to(torch.int64))))
        return dt

    def _apply_dyn_filters(self, dt: DTable) -> DTable:
        blooms = {sym: bits for sym, bits in self.dyn_filters.items()
                  if sym in dt.cols and sym not in self._df_applied}
        self._df_applied.update(blooms)
        return apply_blooms(dt, blooms)

    def _collect_dyn_filters(self, criteria: list[tuple[str, str]],
                             build: DTable, max_bits: int = 1 << 22):
        """Register a one-hash bloom of the build side's keys for each
        equi-key before the probe subtree runs. A false positive only
        costs pruning (the join re-verifies); a false negative cannot
        happen."""
        for lk, rk in criteria:
            self.dyn_filters[lk] = bloom_bits(build, rk, max_bits)

    def _node_key(self, node, kind: str) -> tuple:
        return (self.node_order.get(id(node), id(node)), kind)

    def _capacity(self, node, default: int, kind: str = "table",
                  override: int | None = None,
                  most: int | None = None) -> int:
        """Host retry override > session override > planner hint >
        default, normalized to pow2. A static planner hint is cut to
        ``most``: the largest capacity the node's inputs can need (a
        hash or group table twice its input rows), or for an expanding
        join's output its first rung, twice its inputs' rows. The
        planner's estimates compound over chained joins (output hints
        of 2^30 to 2^44 rows and a 2^42-slot table for TPC-DS q57, q72
        and q95 at scale 10); a capacity that proves too small grows on
        the retry ladder. An output capacity that cost/adapt.revise_join
        re-costed over inputs of known size (``Join.output_observed``)
        is taken as it is: its bound, 8x the larger input, rests on
        rows that exist."""
        cap = self.capacities.get(self._node_key(node, kind))
        if cap is None:
            if override:
                cap = next_pow2(override)
            elif kind in ("table", "out"):
                hint = getattr(node, "capacity" if kind == "table"
                               else "output_capacity", None)
                cap = next_pow2(hint) if hint else default
                observed = kind == "out" and getattr(
                    node, "output_observed", False)
                if most is not None and not observed:
                    cap = min(cap, most)
            else:
                cap = default
        self.used_capacity[self._node_key(node, kind)] = cap
        return cap

    def _note_ok(self, node, ok, kind: str = "table"):
        self.ok_flags.append(ok)
        self.ok_keys.append(self._node_key(node, kind))

    def _r_tablescan(self, node: N.TableScan) -> DTable:
        scan = self.scans[id(node)]
        cols = {sym: Val(scan.types[sym], scan.arrays[sym],
                         scan.arrays.get(f"{sym}$valid"),
                         scan.dictionaries[sym],
                         scan.arrays.get(f"{sym}$len"),
                         scan.arrays.get(f"{sym}$emask"))
                for sym in node.assignments}
        return DTable(cols, scan.live, scan.nrows, self.device)

    def _r_values(self, node: N.Values) -> DTable:
        """Inline rows, put on the device through ``hostsync.upload``."""
        from presto_tpu_torch.block import dictionary_encode
        cols = {}
        for i, sym in enumerate(node.symbols):
            dtype = node.types[sym]
            vals = [r[i] for r in node.rows]
            if isinstance(dtype, T.VarcharType):
                codes, d = dictionary_encode(np.array(vals, object))
                cols[sym] = Val(dtype, HS.upload(codes, self.device,
                                                 "values"), None, d)
            else:
                cols[sym] = Val(dtype, HS.upload(
                    np.asarray(vals, dtype=dtype.physical_dtype),
                    self.device, "values"))
        return DTable(cols, None, len(node.rows), self.device)

    def _r_filter(self, node: N.Filter) -> DTable:
        return OP.apply_filter(self.run(node.source), node.predicate)

    def _r_project(self, node: N.Project) -> DTable:
        return OP.apply_project(self.run(node.source), node.assignments)

    def _r_aggregate(self, node: N.Aggregate) -> DTable:
        src = self.run(node.source)
        if not node.group_keys:
            cap = 1
        else:
            most = next_pow2(2 * src.n)
            if any(c.fn in A.SKETCH_FNS for c in node.aggs.values()):
                # a sketch holds kilobytes a slot (HLL registers, the
                # percentile reservoir): its first rung is small, and
                # the ladder grows it only when the groups overflow
                most = min(most, SKETCH_FIRST_RUNG)
            cap = self._capacity(
                node, next_pow2(min(2 * src.n, 1 << 22)),
                override=int(self.session.get("groupby_table_size") or 0),
                most=most)
        out, ok = OP.apply_aggregate(src, node, cap)
        if node.group_keys:
            self._note_ok(node, ok)
        return out

    def _r_join(self, node: N.Join) -> DTable:
        # build side first, so its keys can prune the probe subtree
        right = self.run(node.right)
        if (node.join_type == N.JoinType.INNER
                and self.session.get("enable_dynamic_filtering")):
            self._collect_dyn_filters(node.criteria, right)
        left = self.run(node.left)
        cap = self._capacity(node, next_pow2(2 * right.n),
                             most=next_pow2(2 * right.n))
        if node.build_unique and node.join_type != N.JoinType.FULL:
            out, ok = OP.apply_join(left, right, node, cap)
            self._note_ok(node, ok)
            return out
        out_default = next_pow2(2 * (left.n + right.n))
        out_cap = self._capacity(node, out_default, "out", most=out_default)
        out, o_ok = OP.apply_expand_join(left, right, node, out_cap)
        self._note_ok(node, o_ok, "out")
        return out

    def _r_multijoin(self, node: N.MultiJoin) -> DTable:
        # every build registers its keys, so the spine scan prunes
        # against all of them at once
        builds = []
        for bnode, crit in zip(node.builds, node.criteria):
            builds.append(self.run(bnode))
            if self.session.get("enable_dynamic_filtering"):
                self._collect_dyn_filters(crit, builds[-1])
        spine = self.run(node.spine)
        default = next_pow2(
            2 * max(max((b.n for b in builds), default=1), 1))
        cap = self._capacity(node, default, most=default)
        out, ok = OP.apply_multi_join(spine, builds, node,
                                      growth=max(1, cap // default))
        self._note_ok(node, ok)
        return out

    def _r_semijoin(self, node: N.SemiJoin) -> DTable:
        src = self.run(node.source)
        filt = self.run(node.filter_source)
        cap = self._capacity(node, next_pow2(2 * filt.n),
                             most=next_pow2(2 * filt.n))
        out, ok = OP.apply_semijoin(src, filt, node, cap)
        self._note_ok(node, ok)
        return out

    def _r_crossjoin(self, node: N.CrossJoin) -> DTable:
        left = self.run(node.left)
        right = self.run(node.right)
        if node.scalar:
            return OP.apply_cross_scalar(left, right)
        return self._cross_general(node, left, right)

    def _cross_general(self, node: N.CrossJoin, left: DTable,
                       right: DTable) -> DTable:
        """Nested-loop cross join: compact each side to its estimated
        live size (a ``left``/``right`` capacity rung with overflow
        retry), then take the static product."""
        lcap = self._capacity(
            node, next_pow2(min(left.n, 2 * (node.left_rows or left.n))),
            "left")
        rcap = self._capacity(
            node, next_pow2(min(right.n,
                                2 * (node.right_rows or right.n))),
            "right")
        if lcap < left.n:
            left, lok = OP.compact_dtable(left, lcap)
            self._note_ok(node, lok, "left")
        if rcap < right.n:
            right, rok = OP.compact_dtable(right, rcap)
            self._note_ok(node, rok, "right")
        return OP.apply_cross_general(left, right)

    def _r_union(self, node: N.Union) -> DTable:
        return OP.apply_union([self.run(s) for s in node.inputs], node)

    def _r_unnest(self, node: N.Unnest) -> DTable:
        return OP.apply_unnest(self.run(node.source), node)

    def _r_window(self, node: N.Window) -> DTable:
        return OP.apply_window(self.run(node.source), node)

    def _r_markdistinct(self, node: N.MarkDistinct) -> DTable:
        return OP.apply_mark_distinct(self.run(node.source), node)

    def _r_distinct(self, node: N.Distinct) -> DTable:
        src = self.run(node.source)
        cap = self._capacity(node, next_pow2(min(2 * src.n, 1 << 22)),
                             most=next_pow2(2 * src.n))
        out, ok = OP.apply_distinct(src, cap)
        self._note_ok(node, ok)
        return out

    def _r_sort(self, node: N.Sort) -> DTable:
        return OP.apply_sort(self.run(node.source), node.orderings)

    def _r_topn(self, node: N.TopN) -> DTable:
        return OP.apply_topn(self.run(node.source), node.count,
                             node.orderings)

    def _r_limit(self, node: N.Limit) -> DTable:
        return OP.apply_limit(self.run(node.source), node.count,
                              node.offset)

    def _r_exchange(self, node: N.Exchange) -> DTable:
        # one device: exchanges are no-ops
        return self.run(node.source)

    def _r_output(self, node: N.Output) -> DTable:
        src = self.run(node.source)
        return DTable({s: src.cols[s] for s in node.symbols}, src.live,
                      src.n, src.device)


def start_run(engine) -> None:
    """Begin a query's record on the engine: ``engine.last_run`` and the
    kernel notes collect the programs run from here on."""
    engine.last_run = QueryRun()
    engine.last_kernel_notes = {}
    engine.last_streamed_blocks = 0


def execute_plan(engine, plan: N.PlanNode) -> Table:
    """Run a logical plan on the engine's device. ``engine.last_run``
    collects the programs of every part of it."""
    start_run(engine)
    return execute_part(engine, plan)


def execute_part(engine, plan: N.PlanNode) -> Table:
    """Run a plan or a part of one, in the reference's order: around a
    MATCH_RECOGNIZE (its input on the device, the automaton on the
    host), around a variable-length aggregate (host-finalized), else
    block-streamed when its one scan exceeds the session block size and
    its shape allows, else host-partitioned when its estimate exceeds
    the memory budget, else bucket by bucket under grouped execution,
    else segmented when it has a split, else whole. The route taken for
    the outermost part is ``engine.last_run.route``."""
    route, out = _route(engine, plan)
    engine.last_run.route = route
    return out


def _route(engine, plan: N.PlanNode) -> tuple[str, Table]:
    """(the route execute_part takes, the plan's result)."""
    from presto_tpu_torch.exec.spill import (try_execute_grouped,
                                             try_execute_spilled)
    from presto_tpu_torch.exec.streaming import try_execute_streamed
    from presto_tpu_torch.exec.varlen import (execute_with_varlen,
                                              find_varlen_aggregate)
    mr = _find_match_recognize(plan)
    if mr is not None:
        return "match_recognize", _execute_with_match_recognize(
            engine, plan, mr)
    vl = find_varlen_aggregate(plan)
    if vl is not None:
        return "varlen", execute_with_varlen(engine, plan, vl)
    # streaming first: a block-streamed scan bounds its own working set,
    # so the memory budget must not veto it
    for route, attempt in (("streamed", try_execute_streamed),
                           ("spilled", try_execute_spilled),
                           ("grouped", try_execute_grouped)):
        done = attempt(engine, plan)
        if done is not None:
            return route, done
    if _find_split(plan, engine) is not None:
        return "segmented", _execute_segmented(engine, plan)
    return "whole", run_plan(engine, plan, collect_scans(plan, engine))


@dataclasses.dataclass
class Program:
    """One program run to the end of its capacity ladder."""

    out: DTable  # on the device
    index: int  # position in engine.last_run.programs
    row_keys: list
    # the per-node live rows of the last pass: host values when they
    # came back with the ok flags, else a device tensor (or None) for
    # the caller's next hostsync.fetch
    counts: object
    # for the query-stats recorder (obs/qstats.record_program): the
    # plan as the query wrote it (before templating), its kernel notes
    # by node position, when the program started, and whether its
    # first pass found the program cache's entry (and a template's)
    plan: N.PlanNode | None = None
    kernels: dict = dataclasses.field(default_factory=dict)
    t0: float = 0.0
    cache_hit: bool = False
    template: bool = False
    # the kernel backend the program ran on: its carrier compacts on
    # the same one
    backend: str = "torch"
    # the program's device cost (obs/devprof.harvest), counted on its
    # first pass in the process and known since (devprof.known_cost);
    # None outside the cache
    cost: dict | None = None

    def note_rows(self, engine, counts) -> None:
        """Keep the node rows that came back with the result (host
        values, or None) and fold the program into the ambient
        query-stats recorder: no further transfer."""
        from presto_tpu_torch.obs import qstats as QS
        if counts is not None:
            engine.last_run.node_rows.update(
                {(self.index, k): int(c)
                 for k, c in zip(self.row_keys, counts)})
        if self.plan is not None:
            QS.record_program(
                engine, self.plan,
                {"count_nodes": self.row_keys, "kernels": self.kernels,
                 "cost": self.cost},
                counts, 0.0, time.perf_counter() - self.t0,
                self.cache_hit, self.template,
                self.template and self.cache_hit)


def _cache_key(engine, plan: N.PlanNode, scans: dict[int, ScanInput],
               backend: str) -> tuple:
    """Program-cache key without its capacities (the reference's
    ``_cache_key``): the plan's fingerprint, the scan shapes (row
    counts as pow2 buckets under ``template_shape_bucketing``), the
    scanned dictionaries' contents, the session properties the
    interpreter reads, and the platform (torch, device, kernel
    backend)."""
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.plan.fingerprint import plan_fingerprint
    inputs = list(scans.values())
    return (plan_fingerprint(plan),
            TPL.scan_shape_key(inputs, TPL.shape_bucketing(engine.session)),
            PC.scan_dictionary_key(inputs),
            PC.trace_session_key(engine.session),
            PC.platform_fingerprint(str(engine.device), backend))


def prepare_plan(engine, plan: N.PlanNode, scans: dict[int, ScanInput],
                 capacities: dict[tuple, int] | None = None,
                 site: str = "ok-ladder",
                 collect_rows: bool = True) -> Program:
    """One interpreter pass per capacity rung over ``scans``; a pass's
    ok flags and node row counts come back in one host sync (a program
    without ok flags takes none). Kernel notes, passes and rows add up
    on ``engine.last_run`` across the programs of a query.

    Without ``capacities`` the program takes part in the program cache
    and the capacity memory, as the reference's ``prepare_plan`` does:
    its first pass starts from the capacity vector remembered under
    its cache key, and its successful vector is remembered after the
    last. With ``plan_templates`` on, the key is the fingerprint of the
    plan's template (templates/), whose plan runs with this query's
    literal values bound, so a literal variant starts from what an
    earlier variant learned. ``capacities`` given carries grown
    capacities in and out instead, shared across the programs of one
    ladder (streamed blocks, spill partitions), outside the cache.

    A cached program's first pass runs under ``obs/devprof.harvest``
    unless its cost is known: to the process (``devprof.known_cost``,
    under its key without the kernel backend) or from its cache entry.
    The cost goes there, and every later run of the program carries it
    (``Program.cost``).

    With the persistent store (``PRESTO_TPU_PROGRAM_CACHE_DIR``,
    exec/progcache.py) a program the engine does not remember starts
    from the capacity vector stored for it, and its entry brings its
    cost: a fresh engine, process or worker climbs no rung and counts
    nothing. ``run.from_memory`` names the engine's own memory only;
    the store's hits are counted in
    ``presto_tpu_program_cache_hits_total{tier="disk"}``.

    With ``PRESTO_TPU_LOG_COMPILES`` set, each pass of a cached program
    prints one stderr line (:func:`log_pass`).

    Inside an open trace the call is a ``program`` span (its
    ``cache_hit`` and ``passes``) and each interpreter pass a ``pass``
    span, whose plan nodes are spans named by their node type."""
    with TRACER.span("program") as sp:
        prog = _climb(engine, plan, scans, capacities, site, collect_rows)
        if sp is not None:
            sp.attrs.update(cache_hit=prog.cache_hit,
                            passes=engine.last_run.passes[prog.index])
    return prog


def _climb(engine, plan: N.PlanNode, scans: dict[int, ScanInput],
           capacities: dict[tuple, int] | None, site: str,
           collect_rows: bool) -> Program:
    """prepare_plan's capacity ladder."""
    from presto_tpu_torch import kernels as K
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.exec.cancel import checkpoint
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.templates import runtime as TR
    backend = K.resolve(engine.session, engine.device)
    t0 = time.perf_counter()
    run = engine.last_run
    index = len(run.programs)
    run.programs.append(plan)
    run.passes.append(0)
    cached = capacities is None
    tpl, entry = None, None
    if cached:
        if TPL.enabled(engine.session):
            tpl = TPL.parameterize(plan)
        cache = engine._program_cache
        cache.configure(engine.session)
        fpr = PC.platform_fingerprint(str(engine.device), backend)
        base_key = _cache_key(engine, plan if tpl is None else tpl.plan,
                              scans, backend)
        known = engine._caps_memory.get(base_key)
        run.from_memory.append(known is not None)
        if known is None:  # {} is a real answer: no override needed
            known = cache.load_caps(base_key, fpr)
        capacities = dict(known)
    else:
        run.from_memory.append(False)
    runs, values = ((plan, []) if tpl is None
                    else (tpl.plan, [p.value for p in tpl.params]))
    order = preorder_index(runs)
    cost = None
    for attempt in range(MAX_ATTEMPTS):
        checkpoint()
        run.passes[index] += 1
        t_pass = time.perf_counter()
        counting = False
        if cached:
            key = (base_key, PC.bucket_capacities(capacities))
            entry = cache.lookup(key, fpr)
            if tpl is not None and attempt == 0:
                TPL.note_lookup(hit=entry is not None,
                                params=len(tpl.params))
            if attempt == 0:
                cost = first_cost(base_key, entry)
                counting = cost is None
        interp = PlanInterpreter(scans, capacities, engine.session,
                                 engine.device, order)
        interp.collect_rows = collect_rows
        with K.use_backend(backend), TR.active(values), (
                devprof.harvest() if counting
                else contextlib.nullcontext()) as counted, \
                TRACER.span("pass"):
            out = interp.run(runs)
        if counting:
            cost = counted.summary()
        counts = (torch.stack([c for _k, c in interp.row_counts])
                  if interp.row_counts else None)
        if not interp.ok_flags:
            if cached:
                log_pass(t_pass, capacities, runs)
            break
        oks = torch.stack([o.reshape(()) for o in interp.ok_flags])
        oks_np, counts = HS.fetch((oks, counts), site=site)
        if cached:
            log_pass(t_pass, capacities, runs)
        if oks_np.all():
            break
        if entry is not None:
            # remembered for smaller data of the same shape
            cache.discard(key, fpr)
        grow_overflowed(capacities, interp.ok_keys, oks_np,
                        interp.used_capacity, RETRY_GROWTH)
    else:
        raise HashChainOverflow("hash table capacity retry limit exceeded")
    if cached:
        if entry is None:
            cache.insert(key, program_meta(out.cols, interp, cost), fpr)
        if capacities != known:
            cache.store_caps(base_key, capacities, fpr)
        engine._caps_memory[base_key] = dict(capacities)
        devprof.remember_cost(PC.backend_free(base_key), cost)
    engine.last_kernel_notes.update(
        {(index, pos): tags for pos, tags in interp.kernel_used.items()})
    engine.last_backend = backend
    run.costs.append(cost)
    return Program(out, index, [k for k, _c in interp.row_counts], counts,
                   plan, dict(interp.kernel_used), t0, entry is not None,
                   tpl is not None, backend, cost)


def first_cost(base_key, entry: dict | None) -> dict | None:
    """The device cost of a cached program at its first pass: the one
    the process counted, else the one its cache entry brought (a fresh
    process reading the persistent store), which the process then
    keeps; None when the pass must count it."""
    from presto_tpu_torch.exec import progcache as PC
    from presto_tpu_torch.obs import devprof
    key = PC.backend_free(base_key)
    cost = devprof.known_cost(key)
    if cost is None and entry is not None:
        cost = entry.get("cost")
        devprof.remember_cost(key, cost)
    return cost


def program_meta(cols: dict, interp, cost: dict | None) -> dict:
    """A program-cache entry: the output layout (``cols``, the output
    columns of the pass that succeeded), its ok-flag and capacity keys,
    its kernel notes and the program's device cost."""
    return {"out": [(sym, v.dtype, v.valid is not None)
                    for sym, v in cols.items()],
            "ok_keys": list(interp.ok_keys),
            "used_capacity": dict(interp.used_capacity),
            "kernels": dict(interp.kernel_used),
            "cost": cost}


def log_pass(t0: float, capacities: dict, plan: N.PlanNode) -> None:
    """One stderr line for the interpreter pass of a cached program
    that began at ``t0`` (its seconds up to its ok flags' fetch, its
    capacities, its root node) when ``PRESTO_TPU_LOG_COMPILES`` is set:
    the reference prints each compile so; here the ladder's rungs
    show."""
    if os.environ.get("PRESTO_TPU_LOG_COMPILES"):
        print(f"[pass] {time.perf_counter() - t0:.3f}s "
              f"caps={dict(capacities)} root={type(plan).__name__}",
              file=sys.stderr)


def _pool_wait(engine) -> tuple[float, float]:
    """(block_s, kill_after_s) of a memory-pool reservation: how long
    one over capacity blocks for concurrent queries to free bytes, and
    when sustained exhaustion triggers the low-memory killer
    (memory.MemoryPool.reserve)."""
    sess = engine.session
    return (float(sess.get("memory_reserve_timeout_s") or 0.0),
            float(sess.get("low_memory_killer_delay_s") or 0.0))


@contextlib.contextmanager
def pool_tag(engine, prefix: str = ""):
    """A fresh tag of the engine's memory pool, freed on exit."""
    tag = prefix + uuid.uuid4().hex[:12]
    try:
        yield tag
    finally:
        engine.memory_pool.free(tag)


def reserve(engine, tag: str, tensors) -> None:
    """Reserve the bytes of ``tensors`` under ``tag`` in the engine's
    memory pool, the query's cancel token as the owner a low-memory
    kill reaches."""
    from presto_tpu_torch.exec import cancel as C
    block_s, kill_s = _pool_wait(engine)
    # freed by the CALLER's finally: every caller reserves inside
    # ``with pool_tag(engine) as tag``, whose finally frees the tag
    engine.memory_pool.reserve(  # lint: disable=pool-discipline
        tag, sum(int(t.nbytes) for t in tensors if t is not None),
        block_s=block_s, kill_after_s=kill_s, owner=C.current())


def input_tensors(scans: dict[int, ScanInput]) -> list:
    """A program's scanned input tensors; a segment carrier is left
    out: its pipeline reserved it when it was made."""
    return [a for si in scans.values()
            if si.node.catalog != SEGMENT_CATALOG
            for a in si.arrays.values()]


def output_tensors(dt: DTable) -> list:
    return [a for v in dt.cols.values() for a in (v.data, v.valid)]


def run_plan(engine, plan: N.PlanNode,
             scans: dict[int, ScanInput]) -> Table:
    """Run a program and fetch its result columns (with its node rows)
    in one more host sync. The bytes of its inputs, then of its
    outputs, are reserved in the engine's memory pool while it runs."""
    with pool_tag(engine) as tag:
        reserve(engine, tag, input_tensors(scans))
        prog = prepare_plan(engine, plan, scans)
        reserve(engine, tag, output_tensors(prog.out))
        return fetch_table(engine, plan, prog, "result-demux")


def fetch_table(engine, plan: N.PlanNode, prog: Program,
                site: str) -> Table:
    """A program's output as a host Table, its columns, live mask and
    node rows in one host sync against ``site``."""
    out = prog.out
    # an ARRAY ships its lengths and element mask after (data, valid)
    res = [[v.data, v.valid] + ([v.lengths, v.elem_mask()] if v.is_array
                                else [])
           for v in out.cols.values()]
    live_np, res_np, counts = HS.fetch(
        (out.live_mask(), res, prog.counts), site=site)
    prog.note_rows(engine, counts)
    return host_table(plan, out.cols, live_np, res_np)


def host_table(plan: N.PlanNode, out: dict, live_np, res_np) -> Table:
    """A host Table from a program's fetched output: ``out`` its
    columns (Vals: types and dictionaries), ``res_np`` each column's
    fetched [data, valid] (an ARRAY's lengths and element mask after),
    ``live_np`` its live mask."""
    cols: dict[str, Column] = {}
    live_rows = np.flatnonzero(live_np)
    for (sym, v), parts in zip(out.items(), res_np):
        if v.is_array:
            # host lists for the live rows only (an aggregate's output
            # has its capacity's rows)
            data, valid, lengths, emask = (
                None if a is None else np.broadcast_to(
                    a, (len(live_np),) + a.shape[1:])[live_rows]
                for a in parts)
            lists = np.empty(len(live_np), object)
            lists[live_rows] = lists_from_padded(
                v.dtype.element, data, lengths, emask, v.dictionary)
            cols[sym] = Column(v.dtype, lists, None if valid is None else
                               np.broadcast_to(parts[1], live_np.shape),
                               None)
            continue
        cols[sym] = Column(v.dtype, parts[0], parts[1], v.dictionary)
    return Table(_rename_outputs(plan, cols), len(live_np), live_np)


def device_outputs(dt: DTable, counts=None) -> tuple:
    """A program's output in segment-carrier form: (arrays incl.
    $valid, dictionaries, types, n, live, counts). One counted fetch
    reads the live count (and ``counts``, a program's node rows still
    on the device). The outputs compact to pow2(live count), at least
    128 rows, when that at least halves the buffer, so later segments
    never churn through dead padding. A scalar column expands to its
    rows first."""
    cnt, counts = HS.fetch((torch.sum(dt.live_mask().to(torch.int64)),
                            counts), site="segment-width")
    cnt = int(cnt)
    cols = {sym: OP.broadcast_rows(v, dt.n) if v.is_array else Val(
                v.dtype, OP._rows(v.data, dt.n, is_long_dec(v.dtype)),
                None if v.valid is None else v.valid.expand(dt.n),
                v.dictionary)
            for sym, v in dt.cols.items()}
    live, n = dt.live, dt.n
    cap = max(128, next_pow2(max(cnt, 1)))
    if cap <= n // 2:
        # the compaction's ok flag is cnt <= cap, true by construction:
        # it is not fed to a ladder
        assert cnt <= cap
        compacted, _ok = OP.compact_dtable(DTable(cols, live, n, dt.device),
                                           cap)
        cols, live, n = compacted.cols, compacted.live, cap
    return (carrier_arrays(cols), {s: v.dictionary for s, v in cols.items()},
            {s: v.dtype for s, v in cols.items()}, n, live, counts)


def carrier_arrays(cols: dict[str, Val]) -> dict[str, torch.Tensor]:
    """Columns as a carrier's scan arrays: each symbol's data, its
    ``$valid`` mask, and an ARRAY's ``$len`` and ``$emask``."""
    arrays: dict[str, torch.Tensor] = {}
    for sym, v in cols.items():
        arrays[sym] = v.data
        if v.valid is not None:
            arrays[f"{sym}$valid"] = v.valid
        if v.is_array:
            arrays[f"{sym}$len"] = v.lengths
            if v.elem_valid is not None:
                arrays[f"{sym}$emask"] = v.elem_valid
    return arrays


def run_plan_device(engine, plan: N.PlanNode, scans: dict[int, ScanInput],
                    node: N.TableScan) -> ScanInput:
    """Run a segment's program and keep its output on the device as the
    carrier that ``node`` scans (see device_outputs). The compaction
    runs on the program's kernel backend, and its kernel notes go under
    (program, "carrier")."""
    from presto_tpu_torch import kernels as K
    prog = prepare_plan(engine, plan, scans)
    with K.use_backend(prog.backend), K.collect() as used:
        arrays, dicts, types, n, live, counts = device_outputs(
            prog.out, prog.counts)
    if used:
        engine.last_kernel_notes[(prog.index, "carrier")] = list(used)
    prog.note_rows(engine, counts)
    return ScanInput(node, arrays, dicts, types, n, live)


def _count_joins(node: N.PlanNode) -> int:
    # a MultiJoin counts its fan-in, and whole: _find_split never cuts
    # inside the fused operator
    own = (len(node.builds) if isinstance(node, N.MultiJoin)
           else int(isinstance(node, (N.Join, N.SemiJoin))))
    return own + sum(_count_joins(s) for s in node.sources())


def _find_split(node: N.PlanNode, engine=None):
    """A subtree with <= MAX_JOINS_PER_PROGRAM joins (at least one) to
    materialize first, or None when the plan runs as one program."""
    if _count_joins(node) <= MAX_JOINS_PER_PROGRAM:
        return _find_agg_input_split(node, engine)
    if isinstance(node, N.MultiJoin):
        # large inputs materialize the fused operator whole, so the
        # aggregate above runs at compacted live width; small plans run
        # it with everything above in one program
        if engine is None or _subtree_scan_rows(node, engine) \
                >= AGG_SPLIT_MIN_ROWS:
            return node
        return None
    best = max(node.sources(), key=_count_joins)
    c = _count_joins(best)
    if c > MAX_JOINS_PER_PROGRAM:
        return _find_split(best, engine)
    if c < 1:
        return None
    # a grouped aggregate inside the chosen subtree still wants its own
    # pre-compaction boundary (its group-by must not run at join width)
    inner = _find_agg_input_split(best, engine)
    return inner if inner is not None else best


def _subtree_scan_rows(node: N.PlanNode, engine) -> int:
    """Largest base-scan row estimate in a subtree. A carrier counts as
    large: it exists because an earlier split materialized a big
    intermediate."""
    if isinstance(node, N.TableScan):
        if node.catalog == SEGMENT_CATALOG:
            return 1 << 62
        conn = engine.catalogs.get(node.catalog)
        return 0 if conn is None else int(conn.row_count_estimate(
            node.table))
    return max((_subtree_scan_rows(s, engine) for s in node.sources()),
               default=0)


def _find_agg_input_split(node: N.PlanNode, engine=None):
    """Pre-aggregation compaction boundary: the input subtree of the
    lowest grouped Aggregate that sits above at least one join (over at
    least AGG_SPLIT_MIN_ROWS scan rows). Joins and selective filters
    leave most of a static-width buffer dead; as a segment, the input is
    compacted to pow2(live) before the group-by runs."""
    for s in node.sources():
        found = _find_agg_input_split(s, engine)
        if found is not None:
            return found
    if isinstance(node, N.Aggregate) and node.group_keys \
            and not isinstance(node.source, N.TableScan) \
            and _count_joins(node.source) >= 1 \
            and (engine is None or _subtree_scan_rows(
                node.source, engine) >= AGG_SPLIT_MIN_ROWS):
        return node.source
    return None


def _contains_carrier(node: N.PlanNode, names: set[str]) -> bool:
    """Does a subtree scan any of the named carriers?"""
    if isinstance(node, N.TableScan):
        return node.catalog == SEGMENT_CATALOG and node.table in names
    return any(_contains_carrier(s, names) for s in node.sources())


def _needed_above(plan: N.PlanNode, sub: N.PlanNode):
    """Symbols of ``sub``'s output that the rest of ``plan`` consumes,
    or None when that cannot be determined: splice a placeholder scan
    where ``sub`` stands, prune the outer plan, and read back which
    placeholder columns survived."""
    from presto_tpu_torch.exec.streaming import _replace_node
    from presto_tpu_torch.plan.optimizer import prune_columns

    tag = "__needed_probe__"
    probe = N.TableScan(tag, tag, {s: s for s in sub.output_symbols},
                        dict(sub.output_types()))
    shadow = _replace_node(plan, sub, probe)
    try:
        pruned = prune_columns(shadow, None if isinstance(
            shadow, N.Output) else set(shadow.output_symbols))
    except NotImplementedError:
        return None  # a node prune_columns does not know: keep all
    found = [n for n in _preorder(pruned)
             if isinstance(n, N.TableScan) and n.catalog == tag]
    if len(found) != 1:
        return None
    return set(found[0].assignments)


def _prune_subtree(sub: N.PlanNode, needed: set):
    """Narrow a subtree to be materialized to its ``needed`` output
    symbols (the unpruned subtree where pruning cannot). An identity
    Project caps it, because joins cannot drop their own pass-through
    columns."""
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.plan.optimizer import prune_columns
    types = dict(sub.output_types())
    cap = N.Project(sub, {s: ir.ColumnRef(types[s], s)
                          for s in sub.output_symbols if s in needed})
    try:
        pruned = prune_columns(cap, set(needed))
    except NotImplementedError:
        return sub
    if not needed <= set(pruned.output_symbols):
        return sub
    return pruned


def _plan_segments(plan: N.PlanNode, engine) -> tuple:
    """(the plan that remains, the segments: [[(subtree, carrier scan
    node), ...] per wave]). A wave holds the successive splits that read
    no carrier of the same wave; each split's subtree is narrowed to the
    columns used above it and replaced by a carrier scan. Finding the
    splits reads only the plan and the connectors' row estimates, so
    it runs ahead of the programs."""
    from presto_tpu_torch.exec.streaming import _replace_node
    waves: list[list[tuple]] = []
    seg = 0
    while True:
        wave: list[tuple] = []
        names: set[str] = set()
        probe = plan
        while True:
            sub = _find_split(probe, engine)
            if sub is None or _contains_carrier(sub, names):
                break
            needed = _needed_above(probe, sub)
            mat = sub
            if needed is not None and needed < set(sub.output_symbols):
                mat = _prune_subtree(sub, needed)
            name = f"s{seg}"
            seg += 1
            cnode = N.TableScan(SEGMENT_CATALOG, name,
                                {s: s for s in mat.output_symbols},
                                dict(mat.output_types()))
            # _replace_node rebuilds every interior node, so later
            # splits of the wave are found in ``probe``
            probe = _replace_node(probe, sub, cnode)
            wave.append((mat, cnode))
            names.add(name)
        if not wave:
            return plan, waves
        waves.append(wave)
        plan = probe


def _run_segment(engine, mat: N.PlanNode, scans: dict[int, ScanInput],
                 cnode: N.TableScan) -> tuple:
    """The default segment runner: (the carrier, no node rows)."""
    return run_plan_device(engine, mat, scans, cnode), None


def _segment_carriers(engine, plan: N.PlanNode, observer=None,
                      runner=None, tag: str | None = None) -> tuple:
    """Materialize the segments in order, each as a device-resident
    carrier. Returns (the plan that remains, carriers by name).

    ``runner(engine, mat, scans, cnode) -> (carrier, node rows or
    None)`` runs one segment (EXPLAIN ANALYZE passes a runner that
    returns the segment's rows by node); ``observer(seg, mat, carrier,
    wall_s, node_rows)`` fires after each, in segment order, with the
    host time from the segment's start to its counted live-rows fetch
    (``device_outputs``). With ``tag``, each carrier's bytes are
    reserved under it in the engine's memory pool as it is made, so an
    over-budget pipeline raises before further segments run; the
    caller frees the tag."""
    from presto_tpu_torch.exec.cancel import checkpoint
    run = runner or _run_segment
    rest, waves = _plan_segments(plan, engine)
    engine.last_run.segments = [[mat for mat, _c in w] for w in waves]
    carriers: dict[str, ScanInput] = {}
    seg = 0
    for wave in waves:
        for mat, cnode in wave:
            checkpoint()
            t0 = time.perf_counter()
            carrier, node_rows = run(
                engine, mat, collect_scans(mat, engine, carriers), cnode)
            if tag is not None:
                reserve(engine, tag, carrier.arrays.values())
            if observer is not None:
                observer(seg, mat, carrier, time.perf_counter() - t0,
                         node_rows)
            carriers[cnode.table] = carrier
            seg += 1
    return rest, carriers


def _execute_segmented(engine, plan: N.PlanNode) -> Table:
    """Run a plan as a sequence of segment programs whose outputs stay
    on the device and feed the next program as carrier scans."""
    with pool_tag(engine, "seg-") as tag:
        plan, carriers = _segment_carriers(engine, plan, tag=tag)
        return run_plan(engine, plan,
                        collect_scans(plan, engine, carriers))


def run_plan_live(engine, plan: N.PlanNode) -> torch.Tensor:
    """Run a plan on the device (segmenting it as ``execute_plan``
    would) and return only its final live mask, a device tensor: the
    result's rows are not fetched."""
    start_run(engine)
    with pool_tag(engine, "seg-") as tag:
        plan, carriers = _segment_carriers(engine, plan, tag=tag)
        return prepare_plan(engine, plan, collect_scans(
            plan, engine, carriers)).out.live_mask()


def _rename_outputs(plan: N.PlanNode,
                    cols: dict[str, Column]) -> dict[str, Column]:
    """Key result columns by their declared output names."""
    if isinstance(plan, N.Output):
        return {name: cols[sym]
                for name, sym in zip(plan.names, plan.symbols)}
    return cols


def _find_match_recognize(plan: N.PlanNode):
    if isinstance(plan, N.MatchRecognize):
        return plan
    for s in plan.sources():
        found = _find_match_recognize(s)
        if found is not None:
            return found
    return None


def _execute_with_match_recognize(engine, plan: N.PlanNode,
                                  mr: N.MatchRecognize) -> Table:
    """Split execution around a MatchRecognize node: its input subplan
    on the device, the pattern automaton on the host
    (exec/match_recognize.py: DEFINE predicates on the device, the NFA
    over their fetched masks), the matches back through a host-table
    carrier for the rest of the plan."""
    from presto_tpu_torch.exec.hostcarrier import carrier_scan
    from presto_tpu_torch.exec.match_recognize import evaluate
    from presto_tpu_torch.exec.streaming import _replace_node
    matched = evaluate(engine, execute_part(engine, mr.source), mr)
    node, scan = carrier_scan(engine, "__matches__", matched)
    rest = _replace_node(plan, mr, node)
    return run_plan(engine, rest, collect_scans(rest, engine,
                                                {node.table: scan}))
