"""Physical operators over masked columnar tables — the port of
``presto_tpu/exec/operators.py`` for the main path.

Each function takes and returns a DTable (dict of symbol -> Val plus a
live mask) whose tensors lie on one device. Shapes are static as in
the reference: filters only update the live mask; aggregation and join
outputs have planner-chosen pow2 capacities, and a capacity that
proves too small comes back as a 0-d ``ok`` tensor that the executor's
retry ladder reads in one batched host sync. No operator reads a
tensor on the host (no ``.item()``, boolean-mask indexing or
``torch.nonzero``).

Operator parity map (reference core/trino-main/.../operator/):
- apply_filter/apply_project  <- FilterAndProjectOperator, PageProcessor
- apply_aggregate             <- HashAggregationOperator + GroupByHash
- apply_join                  <- HashBuilderOperator + LookupJoinOperator
- apply_multi_join            <- a chain of LookupJoinOperators
- apply_expand_join           <- LookupJoinOperator + PositionLinks chains
- apply_semijoin              <- HashSemiJoinOperator
- apply_cross_*               <- NestedLoopJoinOperator
- compact_dtable              <- page compaction
- apply_distinct              <- DistinctLimitOperator / MarkDistinct hash
- apply_sort/topn/limit       <- OrderByOperator, TopNOperator, LimitOperator
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from presto_tpu_torch import kernels as K
from presto_tpu_torch import types as T
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.expr import aggregates as A
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.compile import ExprCompiler, Val, cast_val
from presto_tpu_torch.kernels.multijoin import multijoin_torch, take
from presto_tpu_torch.ops import hash as H
from presto_tpu_torch.ops import segred
from presto_tpu_torch.plan import nodes as N


@dataclasses.dataclass
class DTable:
    cols: dict[str, Val]
    live: object | None  # bool [n] or None (all live)
    n: int
    device: torch.device

    def live_mask(self):
        if self.live is None:
            return torch.ones(self.n, dtype=torch.bool, device=self.device)
        return self.live


def _compiler(dt: DTable) -> ExprCompiler:
    return ExprCompiler(dt.cols, dt.device)


def apply_filter(dt: DTable, predicate: ir.Expr) -> DTable:
    v = _compiler(dt).compile(predicate)
    keep = v.data if v.valid is None else (v.data & v.valid)  # null -> false
    live = keep if dt.live is None else (dt.live & keep)
    if live.ndim == 0:
        live = live.expand(dt.n).contiguous()
    return DTable(dt.cols, live, dt.n, dt.device)


def apply_project(dt: DTable, assignments: dict[str, ir.Expr]) -> DTable:
    c = _compiler(dt)
    out = {}
    for sym, expr in assignments.items():
        v = c.compile(expr)
        data, valid = v.data, v.valid
        long = isinstance(v.dtype, T.DecimalType) and v.dtype.is_long
        if data.ndim == 0:  # broadcast scalar literal
            data = data.expand(dt.n)
        elif long and data.ndim == 1:  # scalar LONG decimal: [2] limbs
            data = data.expand(dt.n, 2)
        if valid is not None and valid.ndim == 0:
            valid = valid.expand(dt.n)
        out[sym] = Val(v.dtype, data, valid, v.dictionary)
    return DTable(out, dt.live, dt.n, dt.device)


def _row_hash(dt: DTable, keys: list[str]):
    hs = []
    for k in keys:
        v = dt.cols[k]
        if v.is_string:
            hs.append(H.hash_string_column(v.data, v.dictionary, v.valid))
        elif v.data.ndim == 2:
            # LONG decimal: both int64 limbs feed the row key
            hs.append(H.hash_int_column(v.data[:, 0], v.valid))
            hs.append(H.hash_int_column(v.data[:, 1], v.valid))
        else:
            hs.append(H.hash_int_column(v.data, v.valid))
    return H.combine_hashes(hs)


# Max code-product capacity for the direct dictionary-code group-by path.
_DIRECT_GROUP_MAX = 1 << 16


def _long_key_operands(v: Val):
    """LONG decimal grouping identity as two uint64 sort operands
    (int64 bit patterns): sign-flipped high limb, then the low limb;
    NULL rows collapse to zeros."""
    from presto_tpu_torch.ops import int128 as I
    khi, klo = I.sort_keys(v.data)
    if v.valid is not None:
        khi = torch.where(v.valid, khi, torch.zeros_like(khi))
        klo = torch.where(v.valid, klo, torch.zeros_like(klo))
    return khi, klo


def _unpack_long_key(khi, klo):
    from presto_tpu_torch.ops import int128 as I
    return I.pack(klo, khi ^ H.INT64_MIN)


def _group_key_operand(v: Val):
    """Normalize a group-key column for exact key-identity sorting:
    NULL rows collapse to one value, NaNs to one bit pattern, +-0.0
    unify."""
    data = v.data
    if data.dtype.is_floating_point:
        bits = torch.where(data == 0, torch.zeros_like(data), data)
        bits = bits.view(torch.int64 if data.dtype == torch.float64
                         else torch.int32)
        data = torch.where(torch.isnan(v.data), torch.full_like(bits, -1),
                           bits)
    if v.valid is not None:
        data = torch.where(v.valid, data, torch.zeros_like(data))
    return data


def _direct_group_ids(dt: DTable, keys: list[str]):
    """Low-cardinality fast path: every group key is a non-null
    dictionary-encoded column with a small code product, and the group
    id is the mixed-radix code product. Returns (gid int32 [n],
    capacity, sizes) or None."""
    sizes = []
    for k in keys:
        v = dt.cols[k]
        if not v.is_string or v.valid is not None or v.dictionary is None:
            return None
        sizes.append(max(len(v.dictionary), 1))
    capacity = 1
    for s in sizes:
        capacity *= s
        if capacity > _DIRECT_GROUP_MAX:
            return None
    gid = torch.zeros(dt.n, dtype=torch.int32, device=dt.device)
    for k, size in zip(keys, sizes):
        code = torch.clamp(dt.cols[k].data.to(torch.int32), 0, size - 1)
        gid = gid * size + code
    return gid, capacity, sizes


def _agg_call_inputs(c: ExprCompiler, dt: DTable, call, live):
    """Prepared (data, weight, data2, data_valid, arg_type) for one
    aggregate call over the rows of ``dt``."""
    if call.fn not in A.PORTED_FNS:
        raise NotImplementedError(
            f"aggregate {call.fn} is not ported to presto_tpu_torch yet")
    data2 = None
    if call.arg is not None:
        av = c.compile(call.arg)
        weight = live if av.valid is None else (live & av.valid)
        long = A.is_long_decimal(av.dtype)
        if long and call.fn in A.VAR_FNS:
            raise NotImplementedError(
                f"{call.fn} over long decimals (precision > 18) is not "
                "supported yet")
        data = A.prepare_arg(call.fn, av.data, av.dtype)
        if long and data.ndim == 1:  # scalar long-decimal literal
            data = data.expand(dt.n, 2)
        if long and data.ndim == 2:
            # int128 [n, 2] -> separate low/high limb columns
            data, data2 = data[:, 0], data[:, 1]
        if data.ndim == 0:
            data = data.expand(dt.n)
        arg_type = av.dtype
    else:
        weight = live
        data = torch.ones(dt.n, dtype=torch.int64, device=dt.device)
        arg_type = None
    if call.arg2 is not None:
        raise NotImplementedError(
            f"two-argument aggregate {call.fn} is not ported yet")
    if call.mask is not None:
        mv = dt.cols[call.mask]
        weight = weight & mv.data
        if mv.valid is not None:
            weight = weight & mv.valid
    return data, weight, data2, None, arg_type


def _state_outputs(out: dict, node, c, call, sym, states, arg_type):
    """PARTIAL steps emit state columns; others finalize."""
    if node.step == N.AggStep.PARTIAL:
        for f, arr in states.items():
            out[f"{sym}${f}"] = Val(A.state_type(call, f), arr, None, None)
        return
    fdata, fvalid = A.finalize(call.fn, states, call.dtype, arg_type,
                               param=call.param)
    out[sym] = Val(call.dtype, fdata, fvalid, _arg_dictionary(c, call.arg))


def _apply_aggregate_sorted(dt: DTable, node: N.Aggregate, capacity: int,
                            c: ExprCompiler, live) -> tuple:
    """Grouped aggregation via one hash sort + segmented scans + one
    compaction sort (the reference's sort-and-scan path). Output:
    [capacity] rows, ok=False when the group count exceeds capacity."""
    id_keys = (node.fd_keys if node.fd_keys
               and set(node.fd_keys) <= set(node.group_keys)
               else node.group_keys)
    rh = _row_hash(dt, id_keys)
    is_final = node.step == N.AggStep.FINAL

    payloads: list = []

    def _add(arr) -> int:
        payloads.append(arr)
        return len(payloads) - 1

    key_refs = []  # (sym, Val, data_idx, valid_idx)
    plain_keys = []  # float originals / FD-dependent keys ride outside
    for k in node.group_keys:
        v = dt.cols[k]
        if k not in id_keys:
            plain_keys.append((k, v, v.valid))
            continue
        if v.data.ndim == 2:  # LONG decimal key
            khi, klo = _long_key_operands(v)
            # uint64 operands sort by their unsigned order
            hi_idx = _add(H.unsigned_key(khi))
            lo_idx = _add(H.unsigned_key(klo))
            valid_idx = None if v.valid is None else _add(v.valid)
            key_refs.append((k, v, ("long", hi_idx, lo_idx), valid_idx))
            continue
        norm_idx = _add(_group_key_operand(v))
        valid_idx = None if v.valid is None else _add(v.valid)
        if v.data.dtype.is_floating_point:
            plain_keys.append((k, v, valid_idx))
        else:
            key_refs.append((k, v, norm_idx, valid_idx))
    num_key_payloads = len(payloads)
    for k, v, valid_ref in plain_keys:
        if isinstance(valid_ref, int) or valid_ref is None:
            valid_idx = valid_ref
        else:
            valid_idx = _add(valid_ref)
        if v.data.ndim == 2:
            khi, klo = _long_key_operands(v)
            key_refs.append((k, v, ("long", _add(H.unsigned_key(khi)),
                                    _add(H.unsigned_key(klo))), valid_idx))
            continue
        key_refs.append((k, v, _add(v.data), valid_idx))

    call_refs: dict[str, tuple] = {}
    for sym, call in node.aggs.items():
        if call.fn not in A.PORTED_FNS:
            raise NotImplementedError(
                f"aggregate {call.fn} is not ported to presto_tpu_torch yet")
        if is_final:
            sum_state = dt.cols.get(f"{sym}$sum")
            arg_type = sum_state.dtype if sum_state is not None else None
            idxs = {f: _add(dt.cols[f"{sym}${f}"].data)
                    for f in A.state_fields(call)}
            call_refs[sym] = ("merge", idxs, arg_type)
        else:
            data, weight, data2, _dv, arg_type = \
                _agg_call_inputs(c, dt, call, live)
            idxs = (_add(data), _add(weight),
                    None if data2 is None else _add(data2))
            call_refs[sym] = ("fold", idxs, arg_type)

    sg = H.SortedGroups(rh, live, payloads, num_key_payloads)
    ok = sg.ngroups <= capacity
    sp = sg.payloads

    compact_in: list = []

    def _adc(arr) -> int:
        compact_in.append(arr)
        return len(compact_in) - 1

    key_out = [(sym, v,
                ("long", _adc(sp[di[1]]), _adc(sp[di[2]]))
                if isinstance(di, tuple) else _adc(sp[di]),
                None if vi is None else _adc(sp[vi]))
               for sym, v, di, vi in key_refs]

    state_out: dict[str, dict] = {}
    arg_types: dict[str, object] = {}
    for sym, call in node.aggs.items():
        kind, refs, arg_type = call_refs[sym]
        arg_types[sym] = arg_type
        if kind == "fold":
            di, wi, d2i = refs
            st = A.scan_fold(call.fn, sp[di], sp[wi], sg,
                             data2=None if d2i is None else sp[d2i])
        else:
            st = A.scan_merge(call.fn, {f: sp[i] for f, i in refs.items()},
                              sg.live, sg)
        state_out[sym] = {f: _adc(arr) for f, arr in st.items()}

    compacted, occupied = sg.compact(compact_in, capacity)

    out: dict[str, Val] = {}
    for sym, v, di, vi in key_out:
        valid = None if vi is None else compacted[vi]
        if isinstance(di, tuple):  # LONG decimal limbs
            data = _unpack_long_key(compacted[di[1]] ^ H.INT64_MIN,
                                    compacted[di[2]] ^ H.INT64_MIN)
            out[sym] = Val(v.dtype, data, valid, v.dictionary)
            continue
        out[sym] = Val(v.dtype, compacted[di], valid, v.dictionary)

    for sym, call in node.aggs.items():
        states = {f: compacted[i] for f, i in state_out[sym].items()}
        _state_outputs(out, node, c, call, sym, states, arg_types[sym])

    return DTable(out, occupied, capacity, dt.device), ok


def apply_aggregate(dt: DTable, node: N.Aggregate, capacity: int) -> tuple:
    """Returns (DTable of [capacity] rows, ok 0-d bool)."""
    live = dt.live_mask()
    c = _compiler(dt)
    fd_reduced = (node.fd_keys
                  and set(node.fd_keys) < set(node.group_keys))
    direct = _direct_group_ids(dt, node.group_keys) \
        if node.group_keys and not fd_reduced else None
    true = torch.ones((), dtype=torch.bool, device=dt.device)

    if direct is not None:
        slots, capacity, sizes = direct
        occupancy = segred.segment_sum(
            live.to(torch.int32), slots, capacity) > 0
    elif node.group_keys:
        return _apply_aggregate_sorted(dt, node, capacity, c, live)
    else:
        # global aggregation: one group in slot 0
        slots = torch.zeros(dt.n, dtype=torch.int32, device=dt.device)
        occupancy = torch.ones(capacity, dtype=torch.bool, device=dt.device)

    out: dict[str, Val] = {}
    if direct is not None:
        out.update(_decode_direct_keys(dt, node.group_keys, sizes,
                                       capacity))

    is_final = node.step == N.AggStep.FINAL
    for sym, call in node.aggs.items():
        if is_final:
            if call.fn not in A.PORTED_FNS:
                raise NotImplementedError(
                    f"aggregate {call.fn} is not ported to "
                    "presto_tpu_torch yet")
            states = {f: dt.cols[f"{sym}${f}"].data
                      for f in A.state_fields(call)}
            states = A.merge(call.fn, states, slots, capacity, live)
            sum_state = dt.cols.get(f"{sym}$sum")
            arg_type = sum_state.dtype if sum_state is not None else None
        else:
            data, weight, data2, _dv, arg_type = \
                _agg_call_inputs(c, dt, call, live)
            states = A.fold(call.fn, data, weight, slots, capacity,
                            data2=data2, param=call.param)
        _state_outputs(out, node, c, call, sym, states, arg_type)

    return DTable(out, occupancy, capacity, dt.device), true


def _decode_direct_keys(dt: DTable, keys: list[str], sizes: list[int],
                        capacity: int) -> dict[str, Val]:
    """Key columns of the direct group-by path, decoded arithmetically
    from the slot index (inverse of the mixed-radix code product)."""
    gid_range = torch.arange(capacity, dtype=torch.int32, device=dt.device)
    rev: list = []
    for k, size in zip(reversed(keys), reversed(sizes)):
        rev.append((k, gid_range % size))
        gid_range = gid_range // size
    out: dict[str, Val] = {}
    for k, codes in reversed(rev):
        v = dt.cols[k]
        out[k] = Val(v.dtype, codes.to(v.data.dtype), None, v.dictionary)
    return out


def _arg_dictionary(c: ExprCompiler, arg):
    """min/max over a string column keep its dictionary."""
    if isinstance(arg, ir.ColumnRef):
        v = c.columns.get(arg.name)
        if v is not None and v.is_string:
            return v.dictionary
    return None


def _verify_keys(left: DTable, right: DTable,
                 criteria: list[tuple[str, str]], gather):
    """Value-compare matched non-string join keys (64-bit row-hash
    collision defence). String keys rely on content-based
    per-dictionary hashes."""
    eq = None
    for lk, rk in criteria:
        lv, rv = left.cols[lk], right.cols[rk]
        if lv.is_string or rv.is_string:
            continue
        e = lv.data == take(rv.data, gather)
        if e.ndim == 2:
            e = e.all(dim=1)
        eq = e if eq is None else (eq & e)
    return eq


def _and_key_valid(dt: DTable, keys: list[str], live):
    for k in keys:
        v = dt.cols[k]
        if v.valid is not None:
            live = live & v.valid
    return live


def _direct_probe(left: DTable, right: DTable, node: N.Join,
                  probe_live, build_live):
    """Direct-address probe for a dense unique build key: scatter build
    row indices into a span-sized table (largest row wins), gather at
    probe key offsets. Returns (build_row int32 [left.n], found)."""
    ci, lo, hi = node.dense_key
    span = hi - lo + 1
    lk, rk = node.criteria[ci]
    bkey = right.cols[rk].data.to(torch.int64)
    ok = build_live & (bkey >= lo) & (bkey <= hi)
    slot = torch.where(ok, bkey - lo, torch.full_like(bkey, span))
    table = torch.full((span + 1,), -1, dtype=torch.int32, device=left.device)
    rows = torch.arange(right.n, dtype=torch.int32, device=left.device)
    table = table.scatter_reduce(0, slot, rows, "amax", include_self=True)
    table = table[:span]
    pkey = left.cols[lk].data.to(torch.int64)
    in_range = (pkey >= lo) & (pkey <= hi)
    build_row = table[torch.clamp(pkey - lo, 0, span - 1)]
    found = probe_live & in_range & (build_row >= 0)
    return torch.where(found, build_row, torch.full_like(build_row, -1)), found


def apply_join(left: DTable, right: DTable, node: N.Join,
               capacity: int) -> tuple:
    """Hash join, probe side preserved (each probe row matches <= 1
    build row — FK->PK). Returns (DTable, ok)."""
    if node.join_type not in (N.JoinType.INNER, N.JoinType.LEFT):
        raise NotImplementedError(
            f"join type {node.join_type} is not ported to presto_tpu_torch "
            "yet")
    lkeys = [lk for lk, _ in node.criteria]
    rkeys = [rk for _, rk in node.criteria]
    # SQL joins never match NULL keys
    build_live = _and_key_valid(right, rkeys, right.live_mask())
    probe_live = _and_key_valid(left, lkeys, left.live_mask())
    hi_row = max(right.n - 1, 0)

    if node.dense_key is not None:
        build_row, found = _direct_probe(left, right, node,
                                         probe_live, build_live)
        ok = torch.ones((), dtype=torch.bool, device=left.device)
        gather = torch.clamp(build_row, 0, hi_row)
        ci = node.dense_key[0]
        rest = [c for i, c in enumerate(node.criteria) if i != ci]
        verify = _verify_keys(left, right, rest, gather) if rest else None
    else:
        # backend-dispatched lookup: the build + probe kernels on CUDA
        # (ok=False on chain overflow -> capacity retry ladder), the
        # sorted-merge lookup as the plain version (always ok)
        rh = _row_hash(right, rkeys)
        ph = _row_hash(left, lkeys)
        build_row, found, ok = K.dispatch("join_lookup")(
            rh, build_live.contiguous(), ph, probe_live.contiguous(),
            capacity)
        gather = torch.clamp(build_row, 0, hi_row)
        verify = _verify_keys(left, right, node.criteria, gather)
    if verify is not None:
        found = found & verify
    out = dict(left.cols)
    inner = node.join_type == N.JoinType.INNER
    for sym, v in right.cols.items():
        data = take(v.data, gather)
        gv = None if v.valid is None else take(v.valid, gather)
        # INNER: unmatched rows die via the live mask, so the found
        # mask is redundant as validity (keeps build-side dictionary
        # keys eligible for the direct group-by path downstream)
        valid = gv if inner else (found if gv is None else found & gv)
        out[sym] = Val(v.dtype, data, valid, v.dictionary)

    if node.filter is not None:
        fv = ExprCompiler(out, left.device).compile(node.filter)
        match_ok = fv.data if fv.valid is None else (fv.data & fv.valid)
        found = found & match_ok
        if not inner:
            for sym in right.cols:
                v = out[sym]
                out[sym] = Val(v.dtype, v.data, found if v.valid is None
                               else (found & v.valid), v.dictionary)

    if inner:
        live = probe_live & found
    else:
        # probe rows with NULL keys survive a LEFT join
        live = left.live_mask()
    return DTable(out, live, left.n, left.device), ok


def apply_multi_join(spine: DTable, builds: list[DTable],
                     node: "N.MultiJoin", growth: int = 1) -> tuple:
    """Fused multi-way INNER equi-join: one probe walk over the spine's
    static width (kernels/multijoin.py). Every build is unique (FK->PK)
    and residual-free by construction. ``growth`` scales every table
    capacity (the retry ladder's knob on chain overflow). A chain
    longer than the walk kernel's MJ_MAX_STEPS walks in pieces, each
    piece's output the next one's spine (a later step's key may name
    an earlier build's column). Returns (DTable, ok)."""
    from presto_tpu_torch.kernels.build import MJ_MAX_STEPS
    ok = None
    for i in range(0, len(builds), MJ_MAX_STEPS):
        spine, piece_ok = _walk(spine, builds[i:i + MJ_MAX_STEPS],
                                node.criteria[i:i + MJ_MAX_STEPS], growth)
        ok = piece_ok if ok is None else (ok & piece_ok)
    return spine, ok


def _walk(spine: DTable, builds: list[DTable], criteria,
          growth: int) -> tuple:
    args = (spine.cols, spine.live_mask(), spine.n,
            [(b.cols, b.live_mask(), b.n) for b in builds],
            criteria, growth)
    fused = K.dispatch("multijoin")(*args)
    if fused is None:  # not kernel-shaped: the plain walk
        fused = multijoin_torch(*args)
    gathers, live, ok = fused
    out = dict(spine.cols)
    for bdt, gather in zip(builds, gathers):
        for sym, v in bdt.cols.items():
            out[sym] = Val(v.dtype, take(v.data, gather),
                           None if v.valid is None else take(v.valid, gather),
                           v.dictionary)
    return DTable(out, live, spine.n, spine.device), ok


def apply_expand_join(left: DTable, right: DTable, node: N.Join,
                      out_capacity: int) -> tuple:
    """Expanding (many-to-many) INNER, LEFT or FULL hash join: every
    (probe, build) match becomes one output row, and under LEFT and
    FULL each probe row with no surviving match one row with NULL build
    columns, through the sorted lookup (sort_build_side + probe_runs +
    expand_matches — the reference has no Pallas kernel here). A
    residual filter applies to the matched pairs. FULL appends a
    build-sized tail holding the build rows no probe row matched, with
    NULL probe columns. Output has static capacity ``out_capacity``
    (plus the build side's under FULL); overflow is reported for the
    retry ladder. Returns (DTable, out_ok)."""
    if node.join_type not in (N.JoinType.INNER, N.JoinType.LEFT,
                              N.JoinType.FULL):
        raise NotImplementedError(
            f"expanding {node.join_type} joins are not ported to "
            "presto_tpu_torch yet")
    lkeys = [lk for lk, _ in node.criteria]
    rkeys = [rk for _, rk in node.criteria]
    build_live = _and_key_valid(right, rkeys, right.live_mask())
    probe_live = _and_key_valid(left, lkeys, left.live_mask())
    full_join = node.join_type == N.JoinType.FULL
    left_join = node.join_type == N.JoinType.LEFT or full_join
    # a LEFT join keeps probe rows with NULL keys: they match nothing
    probe_rows_live = left.live_mask() if left_join else probe_live
    rh = _row_hash(right, rkeys)
    _bsh, bsidx = H.sort_build_side(rh, build_live)
    ph = _row_hash(left, lkeys)
    lo, count, found = H.probe_runs(rh, build_live, ph, probe_live)
    probe_idx, build_row, out_live, ok = H.expand_matches(
        lo, count, bsidx, found & probe_live, probe_rows_live,
        out_capacity, left_join)
    matched = build_row >= 0
    gather = torch.clamp(build_row, 0, max(right.n - 1, 0))
    out: dict[str, Val] = {}
    for sym, v in left.cols.items():
        out[sym] = Val(v.dtype, take(v.data, probe_idx),
                       None if v.valid is None else take(v.valid, probe_idx),
                       v.dictionary)
    verify = None
    for lk, rk in node.criteria:
        lv, rv = left.cols[lk], right.cols[rk]
        if lv.is_string or rv.is_string:
            continue
        e = take(lv.data, probe_idx) == take(rv.data, gather)
        if e.ndim == 2:
            e = e.all(dim=1)
        verify = e if verify is None else (verify & e)
    if verify is not None and not left_join:
        out_live = out_live & (verify | ~matched)
    for sym, v in right.cols.items():
        gv = None if v.valid is None else take(v.valid, gather)
        if left_join:
            valid = matched if gv is None else (matched & gv)
        else:
            # inner expansion emits matched rows only: matched is
            # redundant with out_live (see apply_join)
            valid = gv
        out[sym] = Val(v.dtype, take(v.data, gather), valid, v.dictionary)

    keep = matched
    f_ok = None
    if node.filter is not None:
        fv = ExprCompiler(out, left.device).compile(node.filter)
        f_ok = fv.data if fv.valid is None else (fv.data & fv.valid)
        if not left_join:
            out_live = out_live & f_ok
    if left_join and (f_ok is not None or verify is not None):
        # a match failing the filter or the key value-verify is no
        # match: a probe row whose slots all fail still emits once,
        # unmatched (its first slot revives), and its other slots die
        keep = matched & out_live
        if f_ok is not None:
            keep = keep & f_ok
        if verify is not None:
            keep = keep & verify
        pidx = probe_idx.to(torch.int64)
        surv = torch.zeros(left.n, dtype=torch.int32, device=left.device)
        surv.scatter_reduce_(0, pidx, keep.to(torch.int32), "amax",
                             include_self=True)
        first = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=left.device),
                           probe_idx[1:] != probe_idx[:-1]])
        revert = (first & (take(surv, probe_idx) == 0)
                  & take(probe_rows_live, probe_idx) & out_live)
        out_live = keep | revert
        for sym, v in right.cols.items():
            valid = keep if v.valid is None \
                else (keep & take(v.valid, gather))
            out[sym] = Val(v.dtype, out[sym].data, valid, v.dictionary)
    joined = DTable(out, out_live, out_capacity, left.device)
    if full_join:
        joined = concat_dtables(
            [joined, _unmatched_build_rows(left, right, keep & out_live,
                                           build_row)])
    return joined, ok


def _unmatched_build_rows(left: DTable, right: DTable, kept, build_row):
    """FULL join's tail: the build rows no kept pair matched, with NULL
    probe columns (reference LookupOuterOperator's unvisited-positions
    pass)."""
    nb, dev = right.n, right.device
    matched = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    slot = torch.where(kept, torch.clamp(build_row.to(torch.int64), 0, nb),
                       torch.full_like(build_row, nb, dtype=torch.int64))
    matched.index_put_((slot,), torch.ones((), dtype=torch.bool,
                                           device=dev))
    zero = torch.zeros(nb, dtype=torch.int64, device=dev)
    cols = {sym: Val(v.dtype, take(v.data, zero),
                     torch.zeros(nb, dtype=torch.bool, device=dev),
                     v.dictionary)
            for sym, v in left.cols.items()}
    cols.update(right.cols)
    return DTable(cols, right.live_mask() & ~matched[:nb], nb, dev)


def concat_dtables(parts: list[DTable]) -> DTable:
    """Row-concatenate DTables with identical column sets (key order of
    the first). Validity materializes where any part carries one; a
    scalar column broadcasts to its part's rows."""
    first = parts[0]
    cols: dict[str, Val] = {}
    for sym, v0 in first.cols.items():
        vs = [p.cols[sym] for p in parts]
        long = isinstance(v0.dtype, T.DecimalType) and v0.dtype.is_long
        data = torch.cat([_rows(v.data, p.n, long) for v, p in zip(vs, parts)])
        valid = None
        if any(v.valid is not None for v in vs):
            valid = torch.cat([
                torch.ones(p.n, dtype=torch.bool, device=p.device)
                if v.valid is None else v.valid.expand(p.n)
                for v, p in zip(vs, parts)])
        cols[sym] = Val(v0.dtype, data, valid, v0.dictionary)
    live = torch.cat([p.live_mask() for p in parts])
    return DTable(cols, live, sum(p.n for p in parts), first.device)


def _rows(data, n: int, long: bool):
    """``data`` as ``n`` rows: a scalar (a [2] limb pair when ``long``)
    broadcasts."""
    if long:
        return data.expand(n, 2) if data.ndim == 1 else data
    return data.expand(n) if data.ndim == 0 else data


def apply_semijoin(dt: DTable, filt: DTable, node: N.SemiJoin,
                   capacity: int) -> tuple:
    """Adds the boolean membership column ``node.output``: a dense
    bitmap over the filter key's span when the planner marked it
    dense, else the ``join_lookup`` kernel entry (with a value check
    against 64-bit hash collisions). Under ``null_aware`` the mark is
    NULL, not FALSE, when unmatched and the probed value or the filter
    set holds a NULL (NOT IN's three-valued logic). Returns (DTable,
    ok)."""
    build_live = _and_key_valid(filt, node.filter_keys, filt.live_mask())
    probe_live = _and_key_valid(dt, node.source_keys, dt.live_mask())
    if node.dense_key is not None:
        # one scatter onto an extra slot that absorbs dead and
        # out-of-span rows, one gather
        lo, hi = node.dense_key
        span = hi - lo + 1
        bkey = filt.cols[node.filter_key].data.to(torch.int64)
        inside = build_live & (bkey >= lo) & (bkey <= hi)
        bits = torch.zeros(span + 1, dtype=torch.bool, device=dt.device)
        bits.index_put_((torch.where(inside, bkey - lo,
                                     torch.full_like(bkey, span)),),
                        torch.ones((), dtype=torch.bool, device=dt.device))
        pkey = dt.cols[node.source_key].data.to(torch.int64)
        in_range = (pkey >= lo) & (pkey <= hi)
        found = probe_live & in_range & bits[torch.clamp(pkey - lo, 0,
                                                         span - 1)]
        ok = torch.ones((), dtype=torch.bool, device=dt.device)
    else:
        fh = _row_hash(filt, node.filter_keys)
        sh = _row_hash(dt, node.source_keys)
        build_row, found, ok = K.dispatch("join_lookup")(
            fh, build_live.contiguous(), sh, probe_live.contiguous(),
            capacity)
        verify = _verify_keys(
            dt, filt, list(zip(node.source_keys, node.filter_keys)),
            torch.clamp(build_row, 0, max(filt.n - 1, 0)))
        if verify is not None:
            found = found & verify
    out = dict(dt.cols)
    mark_valid = None
    if node.null_aware:
        bk = filt.cols[node.filter_keys[0]]
        false = torch.zeros((), dtype=torch.bool, device=dt.device)
        build_has_null = (torch.any(filt.live_mask() & ~bk.valid)
                          if bk.valid is not None else false)
        pk = dt.cols[node.source_keys[0]]
        probe_null = (~pk.valid if pk.valid is not None
                      else torch.zeros(dt.n, dtype=torch.bool,
                                       device=dt.device))
        # x IN (empty set) is FALSE even for a NULL x
        set_empty = ~torch.any(filt.live_mask())
        mark_valid = found | set_empty | (~probe_null & ~build_has_null)
    out[node.output] = Val(T.BOOLEAN, found, mark_valid)
    return DTable(out, dt.live, dt.n, dt.device), ok


def compact_dtable(dt: DTable, capacity: int) -> tuple:
    """The live rows of ``dt`` at the front of a ``capacity``-row DTable,
    in order, through the ``compact`` kernel entry. Returns (DTable
    [capacity], ok); ok is False when the live rows overflow the
    capacity (the retry ladder grows it). The count and the flag stay
    on the device."""
    live = dt.live_mask()
    cnt = torch.sum(live.to(torch.int32))
    ok = cnt <= capacity
    arrays: dict = {}
    for sym, v in dt.cols.items():
        # a projected literal is a stride-0 view; the kernel reads rows
        arrays[f"{sym}!d"] = v.data.contiguous()
        if v.valid is not None:
            arrays[f"{sym}!v"] = v.valid.contiguous()
    out = K.dispatch("compact")(live.contiguous(), arrays, capacity)
    cols = {sym: Val(v.dtype, out[f"{sym}!d"], out.get(f"{sym}!v"),
                     v.dictionary)
            for sym, v in dt.cols.items()}
    live_out = torch.arange(capacity, device=dt.device) < cnt
    return DTable(cols, live_out, capacity, dt.device), ok


def apply_cross_general(left: DTable, right: DTable) -> DTable:
    """General nested-loop cross join: the full static product
    left.n x right.n. Callers compact both sides first, so the product
    is sized by live estimates, not input capacities."""
    nl, nr = left.n, right.n
    dev = left.device
    i = torch.arange(nl, dtype=torch.int64, device=dev).repeat_interleave(nr)
    j = torch.arange(nr, dtype=torch.int64, device=dev).repeat(nl)
    out: dict[str, Val] = {}
    for side, idx in ((left, i), (right, j)):
        for sym, v in side.cols.items():
            out[sym] = Val(v.dtype, take(v.data, idx),
                           None if v.valid is None else take(v.valid, idx),
                           v.dictionary)
    live = take(left.live_mask(), i) & take(right.live_mask(), j)
    return DTable(out, live, nl * nr, dev)


def apply_cross_scalar(left: DTable, right: DTable) -> DTable:
    """Cross join against a single-row relation (an uncorrelated scalar
    subquery): the scalar row's columns broadcast over the probe side.
    The live row's index is an argmax on the device (0 with no live
    row; validity then makes every value NULL)."""
    rlive = right.live_mask()
    idx = torch.argmax(rlive.to(torch.int32))
    any_live = torch.any(rlive)
    out = dict(left.cols)
    for sym, v in right.cols.items():
        data = v.data[idx]
        data = data.expand((left.n,) + tuple(data.shape))
        rv = any_live if v.valid is None else (any_live & v.valid[idx])
        out[sym] = Val(v.dtype, data, rv.expand(left.n), v.dictionary)
    return DTable(out, left.live, left.n, left.device)


def _unify_string_vals(vals: list[Val]) -> list[Val]:
    """Remap string Vals onto one shared sorted union dictionary."""
    dicts = [v.dictionary for v in vals]
    if all(d is dicts[0] for d in dicts):
        return vals
    union = np.unique(np.concatenate([d.astype("U") for d in dicts]))
    uobj = union.astype(object)
    out = []
    for v in vals:
        remap = HS.upload(np.searchsorted(union, v.dictionary.astype("U"))
                          .astype(np.int32), v.data.device, "dictionary-lut")
        codes = torch.clamp(v.data.to(torch.int64), 0,
                            max(len(v.dictionary) - 1, 0))
        out.append(Val(v.dtype, take(remap, codes), v.valid, uobj))
    return out


def apply_union(parts: list[DTable], node: N.Union) -> DTable:
    """UNION ALL: each input's symbols renamed per ``node.mappings`` and
    cast to the output types, string dictionaries merged, then the
    rows concatenated (static capacity = the sum of the inputs')."""
    renamed = [DTable({}, p.live, p.n, p.device) for p in parts]
    for sym in node.symbols:
        dtype = node.types[sym]
        vals = []
        for p, mapping in zip(parts, node.mappings):
            v = p.cols[mapping[sym]]
            vals.append(v if v.is_string else cast_val(v, dtype))
        if isinstance(dtype, T.VarcharType):
            vals = _unify_string_vals(vals)
        for r, v in zip(renamed, vals):
            r.cols[sym] = Val(dtype, v.data, v.valid,
                              v.dictionary if v.is_string else None)
    return concat_dtables(renamed)


def apply_mark_distinct(dt: DTable, node: N.MarkDistinct) -> DTable:
    """Adds ``node.mark_symbol``: true on the first live row of each
    distinct key tuple (reference MarkDistinctOperator), from one
    grouping sort whose run starts scatter back to row order."""
    live = dt.live_mask()
    rh = _row_hash(dt, node.keys)
    key_ops = []
    for k in node.keys:
        v = dt.cols[k]
        if v.data.ndim == 2:  # LONG decimal key
            key_ops.extend(_long_key_operands(v))
        else:
            key_ops.append(_group_key_operand(v))
        if v.valid is not None:
            key_ops.append(v.valid)
    sg = H.SortedGroups(rh, live, key_ops, len(key_ops))
    # the stable sort puts each run's smallest row index first
    mark = torch.zeros(dt.n, dtype=torch.bool, device=dt.device)
    mark.scatter_(0, torch.clamp(sg.sidx.to(torch.int64), 0, dt.n - 1),
                  sg.is_new)
    cols = dict(dt.cols)
    cols[node.mark_symbol] = Val(T.BOOLEAN, mark, None, None)
    return DTable(cols, dt.live, dt.n, dt.device)


def _nulls_last(o: N.Ordering) -> bool:
    if o.nulls_first is None:
        # Trino default: nulls last in ASC, first in DESC (null = largest)
        return o.ascending
    return not o.nulls_first


def _sort_keys(dt: DTable, orderings: list[N.Ordering]) -> list:
    """Per-row sort key tensors, each in torch-sortable form: ascending
    lexicographic order over the list == the requested ordering (dead
    rows last, null placement folded into class keys)."""
    live = dt.live_mask()
    keys = [(~live).to(torch.int32)]  # dead rows last
    for o in orderings:
        v = dt.cols[o.symbol]
        data = v.data
        if data.ndim == 2:
            # LONG decimal: int128 limbs -> two uint64 key levels,
            # compared unsigned; descending complements both levels
            from presto_tpu_torch.ops import int128 as I
            khi, klo = I.sort_keys(data)
            if not o.ascending:
                khi, klo = ~khi, ~klo
            if v.valid is not None:
                cls = torch.where(v.valid, 0, 2 if _nulls_last(o) else -2
                                  ).to(torch.int32)
                khi = torch.where(v.valid, khi, torch.zeros_like(khi))
                klo = torch.where(v.valid, klo, torch.zeros_like(klo))
                keys.append(cls)
            keys.append(H.unsigned_key(khi))
            keys.append(H.unsigned_key(klo))
            continue
        if data.dtype == torch.bool:
            data = data.to(torch.int32)
        is_float = data.dtype.is_floating_point
        if not o.ascending:
            # ints reverse via bitwise NOT (~x = -x-1): no INT_MIN wrap
            data = -data if is_float else ~data
        cls = None
        if is_float:
            nan = torch.isnan(data)
            cls = torch.where(nan, 1 if o.ascending else -1, 0
                              ).to(torch.int32)
            data = torch.where(nan, torch.zeros_like(data), data)
        if v.valid is not None:
            if cls is None:
                cls = torch.zeros(data.shape, dtype=torch.int32,
                                  device=data.device)
            cls = torch.where(v.valid, cls, 2 if _nulls_last(o) else -2
                              ).to(torch.int32)
            data = torch.where(v.valid, data, torch.zeros_like(data))
        if cls is not None:
            keys.append(cls)
        keys.append(data)
    return keys


def _gather_table(dt: DTable, perm) -> DTable:
    out = {}
    for sym, v in dt.cols.items():
        out[sym] = Val(v.dtype, v.data[perm],
                       None if v.valid is None else v.valid[perm],
                       v.dictionary)
    live = None if dt.live is None else dt.live[perm]
    return DTable(out, live, dt.n, dt.device)


def apply_sort(dt: DTable, orderings: list[N.Ordering]) -> DTable:
    return _gather_table(dt, H.lexsort(_sort_keys(dt, orderings)))


def apply_topn(dt: DTable, count: int, orderings: list[N.Ordering]) -> DTable:
    out = apply_sort(dt, orderings)
    live = out.live_mask() & (torch.arange(dt.n, device=dt.device) < count)
    return DTable(out.cols, live, dt.n, dt.device)


def apply_limit(dt: DTable, count: int, offset: int = 0) -> DTable:
    live = dt.live_mask()
    pos = torch.cumsum(live.to(torch.int64), 0)
    keep = (pos > offset) & (pos <= offset + count)
    return DTable(dt.cols, live & keep, dt.n, dt.device)


def apply_distinct(dt: DTable, capacity: int) -> tuple:
    """SELECT DISTINCT: a group-by on every column with no aggregates
    (the direct code-product path for small dictionary keys, else one
    hash sort keeping each group's first row). Returns (DTable
    [capacity], ok)."""
    live = dt.live_mask()
    keys = list(dt.cols)
    direct = _direct_group_ids(dt, keys)
    if direct is not None:
        slots, capacity, sizes = direct
        occupancy = segred.segment_sum(live.to(torch.int32), slots,
                                       capacity) > 0
        out = _decode_direct_keys(dt, keys, sizes, capacity)
        return (DTable(out, occupancy, capacity, dt.device),
                torch.ones((), dtype=torch.bool, device=dt.device))
    rh = _row_hash(dt, keys)
    payloads: list = []
    refs = []
    float_cols = []
    for sym, v in dt.cols.items():
        di = len(payloads)
        if v.data.ndim == 2:  # LONG decimal key
            khi, klo = _long_key_operands(v)
            payloads += [H.unsigned_key(khi), H.unsigned_key(klo)]
            vi = None
            if v.valid is not None:
                vi = len(payloads)
                payloads.append(v.valid)
            refs.append((sym, v, ("long", di, di + 1), vi))
            continue
        payloads.append(_group_key_operand(v))
        vi = None
        if v.valid is not None:
            vi = len(payloads)
            payloads.append(v.valid)
        if v.data.dtype.is_floating_point:
            float_cols.append((sym, v, vi))
        else:
            refs.append((sym, v, di, vi))
    num_key_payloads = len(payloads)
    for sym, v, vi in float_cols:
        refs.append((sym, v, len(payloads), vi))
        payloads.append(v.data)
    sg = H.SortedGroups(rh, live, payloads, num_key_payloads)
    ok = sg.ngroups <= capacity
    compacted, occupied = sg.compact_first(sg.payloads, capacity)
    out = {}
    for sym, v, di, vi in refs:
        valid = None if vi is None else compacted[vi]
        if isinstance(di, tuple):  # LONG decimal limbs
            data = _unpack_long_key(compacted[di[1]] ^ H.INT64_MIN,
                                    compacted[di[2]] ^ H.INT64_MIN)
        else:
            data = compacted[di]
        out[sym] = Val(v.dtype, data, valid, v.dictionary)
    return DTable(out, occupied, capacity, dt.device), ok


# --- window functions --------------------------------------------------------


def _first_false(n: int, dev) -> torch.Tensor:
    return torch.zeros(1 if n else 0, dtype=torch.bool, device=dev)


def _keys_equal_prev(vals: list[Val], perm) -> torch.Tensor:
    """bool [n]: row i's key tuple equals row i-1's, in the sorted order
    ``perm``, by exact value (not hash). Row 0 is always False."""
    n = perm.shape[0]
    dev = perm.device
    head = _first_false(n, dev)
    eq = torch.arange(n, device=dev) > 0
    for v in vals:
        d = v.data[perm]
        pair_eq = d[1:] == d[:-1]
        if pair_eq.ndim == 2:  # LONG decimal limbs: equal iff both are
            pair_eq = pair_eq.all(dim=1)
        same = torch.cat([head, pair_eq])
        if v.valid is not None:
            vv = v.valid[perm]
            both_null = torch.cat([head, ~vv[1:] & ~vv[:-1]])
            same_valid = torch.cat([head, vv[1:] == vv[:-1]])
            same = (same | both_null) & same_valid
        eq = eq & same
    return eq


def _run_starts(is_start):
    """Per row, the position of its run's first row (0 before the first
    run): the reference's running max over boundary positions, by a
    scatter (ops/hash._run_starts says why not ``torch.cummax``)."""
    return H._run_starts(is_start).to(torch.int64)


def _run_ends(is_end):
    """Per row, the position of its run's last row (``is_end`` marks
    last rows and holds at the end): the reference's reverse running
    min, as the run starts of the reversed rows."""
    n = is_end.shape[0]
    return (n - 1) - torch.flip(_run_starts(torch.flip(is_end, [0])), [0])


def apply_window(dt: DTable, node: N.Window) -> DTable:
    """Window functions: sort by (partition, order) keys, compute ranks
    and running or framed aggregates with scans over the sorted layout,
    scatter the results back to row order (reference WindowOperator +
    PagesIndex, reformulated as prefix scans and segment reductions)."""
    n, dev = dt.n, dt.device
    live = dt.live_mask()
    part_orderings = [N.Ordering(s) for s in node.partition_by]
    perm = H.lexsort(_sort_keys(dt, part_orderings + list(node.orderings)))
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    inv = torch.zeros(n, dtype=torch.int64, device=dev).scatter_(
        0, perm, idx)

    pvals = [dt.cols[s] for s in node.partition_by]
    ovals = [dt.cols[o.symbol] for o in node.orderings]
    slive = live[perm]
    same_part = (_keys_equal_prev(pvals, perm) & slive
                 & torch.cat([_first_false(n, dev), slive[:-1]]))
    same_peer = same_part & _keys_equal_prev(pvals + ovals, perm)

    # each row's partition and peer-group start and end positions (a
    # row ends its run where the next row starts one)
    last = torch.ones(1 if n else 0, dtype=torch.bool, device=dev)
    part_start = _run_starts(~same_part)
    peer_start = _run_starts(~same_peer)
    part_end = _run_ends(torch.cat([~same_part[1:], last]))
    peer_end = _run_ends(torch.cat([~same_peer[1:], last]))

    out = dict(dt.cols)
    c = ExprCompiler({s: Val(v.dtype, v.data[perm],
                             None if v.valid is None else v.valid[perm],
                             v.dictionary)
                      for s, v in dt.cols.items()}, dev)
    key_val = (c.columns.get(node.orderings[0].symbol)
               if len(node.orderings) == 1 else None)
    fctx = {"orderings": node.orderings, "same_peer": same_peer,
            "same_part": same_part, "peer_start": peer_start,
            "peer_end": peer_end, "key": key_val}
    for sym, call in node.functions.items():
        data, valid, dictionary = _window_fn(
            call, c, idx, part_start, peer_start, part_end, peer_end,
            same_part, slive, n, fctx)
        if data.ndim == 0:
            data = data.expand(n)
        out[sym] = Val(call.dtype, data[inv],
                       None if valid is None else valid[inv], dictionary)
    return DTable(out, dt.live, n, dev)


def _window_fn(call: N.WindowCall, c: ExprCompiler, idx, part_start,
               peer_start, part_end, peer_end, same_part, slive, n,
               fctx):
    """One window function over the sorted rows: (data, valid,
    dictionary) in sorted order."""
    fn = call.fn
    if fn == "row_number":
        return idx - part_start + 1, None, None
    if fn == "rank":
        return peer_start - part_start + 1, None, None
    if fn == "dense_rank":
        new_peer = torch.cat([torch.ones(1, dtype=torch.bool,
                                         device=idx.device),
                              peer_start[1:] != peer_start[:-1]])
        peer_ord = torch.cumsum(new_peer.to(torch.int64), 0)
        at_start = peer_ord[torch.clamp(part_start, 0, n - 1)]
        return peer_ord - at_start + 1, None, None
    if fn == "percent_rank":
        rank = (peer_start - part_start).to(torch.float64)
        rows = (part_end - part_start).to(torch.float64)
        return (torch.where(rows > 0, rank / torch.clamp(rows, min=1),
                            torch.zeros_like(rank)), None, None)
    if fn == "cume_dist":
        rows = (part_end - part_start + 1).to(torch.float64)
        return ((peer_end - part_start + 1).to(torch.float64) / rows,
                None, None)
    if fn == "ntile":
        buckets = int(call.args[0].value)
        pos = idx - part_start
        rows = part_end - part_start + 1
        q, r = rows // buckets, rows % buckets
        # the first r buckets get q + 1 rows
        big_span = (q + 1) * r
        bucket = torch.where(
            pos < big_span, pos // torch.clamp(q + 1, min=1),
            r + (pos - big_span) // torch.clamp(q, min=1))
        return torch.clamp(bucket, 0, buckets - 1) + 1, None, None
    if fn in ("first_value", "last_value", "nth_value"):
        v = c.compile(call.args[0])
        lo, hi = _frame_bounds(call, idx, part_start, part_end, peer_end,
                               fctx)
        if fn == "first_value":
            at = lo
        elif fn == "last_value":
            at = hi
        else:
            at = lo + (int(call.args[1].value) - 1)
        in_frame = (at >= lo) & (at <= hi) & (hi >= lo)
        src = torch.clamp(at, 0, n - 1)
        valid = in_frame if v.valid is None else (in_frame & v.valid[src])
        return v.data[src], valid, v.dictionary
    if fn in ("lag", "lead"):
        v = c.compile(call.args[0])
        offset = int(call.args[1].value) if len(call.args) > 1 else 1
        shift = -offset if fn == "lag" else offset
        src = torch.clamp(idx + shift, 0, n - 1)
        in_part = (part_start[src] == part_start) & (src == idx + shift)
        valid = in_part if v.valid is None else (in_part & v.valid[src])
        return v.data[src], valid, v.dictionary
    if fn in ("sum", "count", "avg", "min", "max"):
        return _window_agg(call, fn, c, idx, part_start, peer_end,
                           part_end, same_part, slive, n, fctx)
    raise NotImplementedError(f"window function {fn}")


def _window_agg(call, fn, c, idx, part_start, peer_end, part_end,
                same_part, slive, n, fctx):
    if call.args:
        v = c.compile(call.args[0])
        if v.data.ndim == 2:
            raise NotImplementedError(
                "window aggregates over long decimals (precision > 18) "
                "are not supported yet")
        w = slive if v.valid is None else (slive & v.valid)
        vals = v.data
    else:
        v = None
        w = slive
        vals = torch.ones(n, dtype=torch.int64, device=idx.device)
    restart = ~same_part  # a partition begins (row 0 included)
    if fn == "count":
        vals = torch.ones(n, dtype=torch.int64, device=idx.device)
    if not vals.dtype.is_floating_point and vals.dtype != torch.bool:
        vals = vals.to(torch.int64)
    dictionary = v.dictionary if v is not None else None

    if (call.range_frame is not None or call.groups_frame is not None
            or (call.rows_frame is not None
                and (call.rows_frame[0] is not None
                     or call.rows_frame[1] is not None))):
        return _frame_agg(call, fn, v, vals, w, idx, part_start,
                          part_end, restart, n, fctx)

    if call.rows_frame == (None, None) or call.frame == "full_partition":
        frame_at = part_end  # the whole partition
    elif call.frame == "rows_unbounded_current":
        frame_at = idx  # ROWS: ends at the current row, peers excluded
    else:
        # RANGE default: the running value at the END of the peer group
        frame_at = peer_end
    frame_at = torch.clamp(frame_at, 0, n - 1)

    def run_scan(masked, op):
        return _segmented_scan(masked, restart, op)[frame_at]

    cnt = run_scan(w.to(torch.int64), torch.add)
    if fn == "count":
        return cnt, None, None
    if fn in ("sum", "avg"):
        total = run_scan(torch.where(w, vals, torch.zeros_like(vals)),
                         torch.add)
        if fn == "avg":
            return _avg(total, cnt, v), cnt > 0, None
        return total, cnt > 0, None
    is_max = fn == "max"
    ident = segred.identity(vals.dtype, is_max)
    run = run_scan(torch.where(w, vals, torch.full_like(vals, ident)),
                   torch.maximum if is_max else torch.minimum)
    return run, cnt > 0, dictionary


def _avg(total, cnt, v):
    sf = total.to(torch.float64)
    if v is not None and isinstance(v.dtype, T.DecimalType):
        sf = sf / v.dtype.unscale_factor
    return sf / torch.clamp(cnt, min=1)


def _frame_bounds(call: N.WindowCall, idx, part_start, part_end,
                  peer_end, fctx):
    """Inclusive sorted-position frame [lo, hi] of a value function.
    With no explicit frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW =
    partition start .. peer-group end."""
    if call.range_frame is not None or call.groups_frame is not None:
        return _dynamic_frame_bounds(call, fctx, idx, part_start,
                                     part_end)
    if call.rows_frame is not None:
        return _rows_frame_bounds(call.rows_frame, idx, part_start,
                                  part_end)
    if call.frame == "full_partition":
        return part_start, part_end
    if call.frame == "rows_unbounded_current":
        return part_start, idx
    return part_start, peer_end


def _rows_frame_bounds(rows_frame, idx, part_start, part_end):
    p, f = rows_frame
    lo = part_start if p is None else torch.maximum(idx - p, part_start)
    hi = part_end if f is None else torch.minimum(idx + f, part_end)
    return lo, hi


def _bounded_bsearch(vals, targets, lo0, hi0, left: bool, n: int):
    """Per-row binary search: the insertion position of ``targets[i]``
    in ascending ``vals`` restricted to [lo0[i], hi0[i]) (log2(n)
    gather rounds; the partition-respecting searchsorted behind RANGE
    frames)."""
    lo, hi = lo0.to(torch.int64), hi0.to(torch.int64)
    for _ in range(max(int(n - 1).bit_length(), 1) + 1):
        mid = (lo + hi) >> 1
        v = vals[torch.clamp(mid, 0, n - 1)]
        go = (v < targets) if left else (v <= targets)
        active = lo < hi
        lo, hi = (torch.where(active & go, mid + 1, lo),
                  torch.where(active & ~go, mid, hi))
    return lo


def _dynamic_frame_bounds(call: N.WindowCall, fctx, idx, part_start,
                          part_end):
    """Inclusive [lo, hi] of a value-based RANGE or a GROUPS frame.

    GROUPS: peer groups carry a globally ascending dense id, so each
    bound is one searchsorted, clamped into the partition. RANGE: the
    sort key ascends within each partition's non-null span, so bounds
    come from a partition-bounded binary search over [key - preceding,
    key + following]; a null-key row frames over its peer group, and an
    UNBOUNDED side keeps the whole-partition bound."""
    n = idx.shape[0]
    peer_start, peer_end = fctx["peer_start"], fctx["peer_end"]
    if call.groups_frame is not None:
        p, f = call.groups_frame
        gg = torch.cumsum((~fctx["same_peer"]).to(torch.int64), 0)
        lo = part_start if p is None else torch.maximum(
            torch.searchsorted(gg, gg - p), part_start)
        hi = part_end if f is None else torch.minimum(
            torch.searchsorted(gg, gg + f, right=True) - 1, part_end)
        return lo, hi

    p, f = call.range_frame
    o = fctx["orderings"][0]
    kv = fctx["key"]
    if kv.data.dtype.is_floating_point:
        key = kv.data.to(torch.float64)
    else:
        key = kv.data.to(torch.int64)
    pv, fv = (0 if p is None else p), (0 if f is None else f)
    if not o.ascending:
        # descending keys negate into an ascending search
        key = -key
    isnull = None
    nn_start, nn_end = part_start, part_end
    if kv.valid is not None:
        isnull = ~kv.valid
        npref = _segmented_scan(isnull.to(torch.int64), ~fctx["same_part"],
                                torch.add)
        tot = npref[torch.clamp(part_end, 0, n - 1)]
        if _nulls_last(o):
            nn_end = part_end - tot
        else:
            nn_start = part_start + tot
    lo = part_start if p is None else torch.maximum(
        _bounded_bsearch(key, key - pv, nn_start, nn_end + 1, True, n),
        part_start)
    hi = part_end if f is None else torch.minimum(
        _bounded_bsearch(key, key + fv, nn_start, nn_end + 1, False, n) - 1,
        part_end)
    if isnull is not None:
        # a null-key row's offset frame is its peer group (all nulls)
        if p is not None:
            lo = torch.where(isnull, peer_start, lo)
        if f is not None:
            hi = torch.where(isnull, peer_end, hi)
    return lo, hi


def _sparse_minmax(masked, lo, hi, op, ident, n: int):
    """min/max over arbitrary inclusive [lo, hi] spans by a doubling
    sparse table: level k covers [i, i + 2^k), and a query is op of two
    overlapping level-k entries, k = floor(log2(width))."""
    if n > (1 << 23):
        raise NotImplementedError(
            "doubly-bounded RANGE/GROUPS min/max frames over >8M "
            "sorted rows")
    levels = [masked]
    t = masked
    k = 1
    while (1 << k) <= n:
        sh = 1 << (k - 1)
        t = op(t, torch.cat([t[sh:], torch.full((sh,), ident,
                                                 dtype=t.dtype,
                                                 device=t.device)]))
        levels.append(t)
        k += 1
    table = torch.stack(levels)
    width = torch.clamp(hi - lo + 1, min=1)
    kq = torch.clamp(torch.floor(torch.log2(width.to(torch.float64)))
                     .to(torch.int64), 0, len(levels) - 1)
    a = table[kq, torch.clamp(lo, 0, n - 1)]
    b = table[kq, torch.clamp(hi - (1 << kq) + 1, 0, n - 1)]
    return op(a, b)


def _frame_agg(call: N.WindowCall, fn: str, v, vals, w, idx,
               part_start, part_end, restart, n, fctx):
    """An aggregate over a general ROWS, RANGE or GROUPS frame.
    sum/count/avg difference two points of the segmented prefix scan;
    one-side-unbounded min/max take a (possibly reversed) running scan;
    doubly-bounded min/max take one shift-and-select pass per ROWS
    offset, or a sparse table for RANGE and GROUPS frames, whose width
    depends on the data."""
    if call.rows_frame is not None:
        p, f = call.rows_frame
        lo, hi = _rows_frame_bounds(call.rows_frame, idx, part_start,
                                    part_end)
        rows_static = True
    else:
        p, f = (call.range_frame if call.range_frame is not None
                else call.groups_frame)
        lo, hi = _dynamic_frame_bounds(call, fctx, idx, part_start,
                                       part_end)
        rows_static = False
    empty = hi < lo
    hi_c = torch.clamp(hi, 0, n - 1)
    lo_c = torch.clamp(lo, 0, n - 1)

    def span_sum(masked):
        s = _segmented_scan(masked, restart, torch.add)
        prev = torch.where(lo > part_start,
                           s[torch.clamp(lo_c - 1, 0, n - 1)],
                           torch.zeros_like(s))
        return torch.where(empty, torch.zeros_like(s), s[hi_c] - prev)

    cnt = span_sum(w.to(torch.int64))
    if fn == "count":
        return cnt, None, None
    if fn in ("sum", "avg"):
        total = span_sum(torch.where(w, vals, torch.zeros_like(vals)))
        if fn == "avg":
            return _avg(total, cnt, v), cnt > 0, None
        return total, cnt > 0, None

    is_max = fn == "max"
    ident = segred.identity(vals.dtype, is_max)
    op = torch.maximum if is_max else torch.minimum
    masked = torch.where(w, vals, torch.full_like(vals, ident))
    dictionary = v.dictionary if v is not None else None

    def result(res):
        return (torch.where(empty, torch.full_like(res, ident), res),
                cnt > 0, dictionary)

    if p is None:  # unbounded preceding: the running scan at hi
        return result(_segmented_scan(masked, restart, op)[hi_c])
    if f is None:  # unbounded following: the reverse scan at lo
        rrestart = torch.cat([restart[1:], torch.ones(
            1, dtype=torch.bool, device=restart.device)])
        return result(_rsegmented_scan(masked, rrestart, op)[lo_c])
    if not rows_static:
        return result(_sparse_minmax(masked, lo, hi, op, ident, n))
    # a bounded ROWS frame: one static shift-and-select per offset
    width = int(p) + int(f) + 1
    if width > 1024:
        raise NotImplementedError(
            f"ROWS frame of width {width} (bounded min/max frames "
            "support width <= 1024)")
    res = torch.full_like(masked, ident)
    for d in range(-int(p), int(f) + 1):
        if d < 0:
            shifted = torch.cat([torch.full((-d,), ident, dtype=masked.dtype,
                                            device=masked.device),
                                 masked[:d]])
        elif d > 0:
            shifted = torch.cat([masked[d:],
                                 torch.full((d,), ident, dtype=masked.dtype,
                                            device=masked.device)])
        else:
            shifted = masked
        pos = idx + d
        inside = (pos >= lo) & (pos <= hi)
        res = op(res, torch.where(inside, shifted,
                                  torch.full_like(shifted, ident)))
    return result(res)


def _rsegmented_scan(vals, restart_rev, op):
    """Reverse segmented inclusive scan (``restart_rev`` marks segment
    ENDS)."""
    return torch.flip(_segmented_scan(torch.flip(vals, [0]),
                                      torch.flip(restart_rev, [0]), op),
                      [0])


def _segmented_scan(vals, restart, op):
    """Inclusive scan that restarts wherever ``restart`` is True:
    integer sums as a prefix sum less the prefix before each segment
    (exact, wrapping like the reference's); float sums, max and min as
    a doubling scan gated by each row's segment start."""
    from presto_tpu_torch.ops import segscan as S
    runs = S.Runs(_run_starts(restart))
    if op is torch.add and not vals.dtype.is_floating_point:
        return S.seg_sum(vals, runs)
    return S.seg_scan(lambda a, b: (op(a[0], b[0]),), (vals,), runs)[0]
