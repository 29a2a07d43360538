"""Plan executor: logical plan -> eager tensor operators -> host Table.

The port of ``presto_tpu/exec/executor.py`` for the main path. The
reference traces the whole plan into one XLA program; here the
``PlanInterpreter`` walks the plan and runs each operator eagerly on
the engine's device, in one pass over the whole plan.

Hash-table capacities follow the reference: planner hints (pow2) or a
2x-input default; every operator that can overflow returns a 0-d
``ok`` tensor, the executor reads all of them in ONE host sync after
the pass, and on overflow grows every failed capacity RETRY_GROWTH x
and runs the plan again (the capacity retry ladder).

Left out so far (ROADMAP): the AOT program cache, plan templates,
block streaming, spill, grouped and segmented execution, dynamic
filtering, per-node row statistics, and every plan node outside
TableScan, Values, Filter, Project, Aggregate, Join, MultiJoin,
SemiJoin, CrossJoin, Union, Window, MarkDistinct, Distinct, Sort,
TopN, Limit, Exchange and Output (each raises NotImplementedError).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.exec import operators as OP
from presto_tpu_torch.exec.operators import DTable
from presto_tpu_torch.expr.compile import Val
from presto_tpu_torch.ops.hash import HashChainOverflow, grow_overflowed
from presto_tpu_torch.ops.sizes import next_pow2
from presto_tpu_torch.plan import nodes as N

RETRY_GROWTH = 4  # overshoot on overflow to bound re-runs at ~1
MAX_ATTEMPTS = 6


@dataclasses.dataclass
class ScanInput:
    """Device tensors + metadata for one TableScan."""

    node: N.TableScan
    arrays: dict[str, torch.Tensor]  # symbol (and symbol$valid) -> data
    dictionaries: dict[str, np.ndarray | None]
    types: dict[str, T.DataType]
    nrows: int
    live: torch.Tensor | None = None


def collect_scans(plan: N.PlanNode, engine) -> dict[int, ScanInput]:
    """id(TableScan) -> its columns on the engine's device (uploaded
    once per (table, column) and cached by the engine)."""
    out: dict[int, ScanInput] = {}

    def visit(node):
        if isinstance(node, N.TableScan):
            connector = engine.catalogs[node.catalog]
            tbl = connector.table(node.table)
            arrays, dicts, types = {}, {}, {}
            for sym, colname in node.assignments.items():
                col = tbl.columns[colname]
                if isinstance(col.dtype, T.ArrayType):
                    raise NotImplementedError(
                        "ARRAY columns are not ported to presto_tpu_torch "
                        "yet")
                arrays[sym] = engine.device_array(col.data)
                if col.valid is not None:
                    arrays[f"{sym}$valid"] = engine.device_array(col.valid)
                dicts[sym] = col.dictionary
                types[sym] = col.dtype
            live = (None if tbl.mask is None
                    else engine.device_array(tbl.mask))
            out[id(node)] = ScanInput(node, arrays, dicts, types,
                                      tbl.nrows, live)
        for s in node.sources():
            visit(s)

    visit(plan)
    return out


def preorder_index(plan: N.PlanNode) -> dict[int, int]:
    """id(node) -> stable preorder position (capacity-override keys)."""
    order: dict[int, int] = {}

    def visit(node):
        order[id(node)] = len(order)
        for s in node.sources():
            visit(s)

    visit(plan)
    return order


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

    def run(self, node: N.PlanNode) -> DTable:
        from presto_tpu_torch import kernels as K
        m = getattr(self, "_r_" + type(node).__name__.lower(), None)
        if m is None:
            raise NotImplementedError(
                f"plan node {type(node).__name__} is not ported to "
                "presto_tpu_torch yet")
        with K.collect() as used:
            dt = m(node)
        if used:
            self.kernel_used[
                self.node_order.get(id(node), id(node))] = list(used)
        return dt

    def _node_key(self, node, kind: str) -> tuple:
        return (self.node_order.get(id(node), id(node)), kind)

    def _capacity(self, node, default: int, kind: str = "table",
                  override: int | None = None,
                  most: int | None = None) -> int:
        """Host retry override > session override > planner hint >
        default, normalized to pow2. A planner hint is cut to ``most``:
        the largest capacity the node's inputs can need (a hash or group
        table twice its input rows), or for an expanding join's output
        its first rung, twice its inputs' rows. The planner's estimates
        compound over chained joins (output hints of 2^30 to 2^44 rows
        and a 2^42-slot table for TPC-DS q57, q72 and q95 at scale 10);
        a capacity that proves too small grows on the retry ladder."""
        cap = self.capacities.get(self._node_key(node, kind))
        if cap is None:
            if override:
                cap = next_pow2(override)
            elif kind in ("table", "out"):
                hint = getattr(node, "capacity" if kind == "table"
                               else "output_capacity", None)
                cap = next_pow2(hint) if hint else default
                if most is not None:
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
                         scan.dictionaries[sym])
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
            cap = self._capacity(
                node, next_pow2(min(2 * src.n, 1 << 22)),
                override=int(self.session.get("groupby_table_size") or 0),
                most=next_pow2(2 * src.n))
        out, ok = OP.apply_aggregate(src, node, cap)
        if node.group_keys:
            self._note_ok(node, ok)
        return out

    def _r_join(self, node: N.Join) -> DTable:
        right = self.run(node.right)
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
        builds = [self.run(b) for b in node.builds]
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


def execute_plan(engine, plan: N.PlanNode) -> Table:
    """Run a logical plan on the engine's device."""
    return run_plan(engine, plan, collect_scans(plan, engine))


def run_plan(engine, plan: N.PlanNode,
             scans: dict[int, ScanInput]) -> Table:
    """One interpreter pass per capacity rung; the ok flags of a pass
    come back in one host sync, and the result columns in one more."""
    from presto_tpu_torch import kernels as K
    backend = K.resolve(engine.session, engine.device)
    order = preorder_index(plan)
    capacities: dict[tuple, int] = {}
    for _attempt in range(MAX_ATTEMPTS):
        interp = PlanInterpreter(scans, capacities, engine.session,
                                 engine.device, order)
        with K.use_backend(backend):
            out = interp.run(plan)
        oks = (torch.stack([o.reshape(()) for o in interp.ok_flags])
               if interp.ok_flags else None)
        oks_np = (HS.fetch(oks, site="ok-ladder") if oks is not None
                  else np.ones(0, dtype=bool))
        if oks_np.all():
            break
        grow_overflowed(capacities, interp.ok_keys, oks_np,
                        interp.used_capacity, RETRY_GROWTH)
    else:
        raise HashChainOverflow("hash table capacity retry limit exceeded")
    engine.last_kernel_notes = dict(interp.kernel_used)
    engine.last_backend = backend

    res = []
    for v in out.cols.values():
        res.append(v.data)
        res.append(v.valid)
    live_np, res_np = HS.fetch((out.live_mask(), res), site="result-demux")
    cols: dict[str, Column] = {}
    for i, (sym, v) in enumerate(out.cols.items()):
        data, valid = res_np[2 * i], res_np[2 * i + 1]
        cols[sym] = Column(v.dtype, data, valid, v.dictionary)
    return Table(_rename_outputs(plan, cols), len(live_np), live_np)


def _rename_outputs(plan: N.PlanNode,
                    cols: dict[str, Column]) -> dict[str, Column]:
    """Key result columns by their declared output names."""
    if isinstance(plan, N.Output):
        return {name: cols[sym]
                for name, sym in zip(plan.names, plan.symbols)}
    return cols
