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
- apply_unnest                <- UnnestOperator

An ARRAY column is 2-D like a LONG decimal's limbs, so every operator
tells the two apart by TYPE (``is_long_dec``, ``Val.is_array``), never
by rank; every row gather, compaction and concatenation carries an
array's ``lengths`` and ``elem_valid`` with its data (``take_val``,
``broadcast_rows``); an ARRAY group or DISTINCT key is its length and
every position (``_key_parts``).
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
from presto_tpu_torch.expr.compile import (ExprCompiler, Val, _align_strings,
                                           cast_val, is_long_dec)
from presto_tpu_torch.kernels.multijoin import take
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
        if v.is_array:
            # an array built from literals alone has one row
            out[sym] = broadcast_rows(v, dt.n)
            continue
        data, valid = v.data, v.valid
        if data.ndim == 0:  # broadcast scalar literal
            data = data.expand(dt.n)
        elif is_long_dec(v.dtype) and data.ndim == 1:  # [2] limbs
            data = data.expand(dt.n, 2)
        if valid is not None and valid.ndim == 0:
            valid = valid.expand(dt.n)
        out[sym] = Val(v.dtype, data, valid, v.dictionary)
    return DTable(out, dt.live, dt.n, dt.device)


def broadcast_rows(v: Val, n: int) -> Val:
    """An ARRAY Val of one row (or n) as n rows, companions included."""
    def rows(x):
        if x is None or (x.ndim and x.shape[0] == n):
            return x
        return x.reshape((1,) * (x.ndim == 0) + tuple(x.shape)).expand(
            (n,) + tuple(x.shape[1:] if x.ndim else ()))
    return Val(v.dtype, rows(v.data), rows(v.valid), v.dictionary,
               rows(v.lengths), rows(v.elem_valid),
               None if v.map_keys is None else broadcast_rows(v.map_keys, n))


def take_val(v: Val, idx) -> Val:
    """Rows ``idx`` of a Val (``take``: clamped by the callers), its
    ARRAY companions included."""
    return Val(v.dtype, take(v.data, idx),
               None if v.valid is None else take(v.valid, idx),
               v.dictionary,
               None if v.lengths is None else take(v.lengths, idx),
               None if v.elem_valid is None else take(v.elem_valid, idx),
               None if v.map_keys is None else take_val(v.map_keys, idx))


def _key_parts(v: Val) -> list:
    """A key column's exact identity as 1-D sort operands, told apart by
    its TYPE (a LONG decimal and an ARRAY are both 2-D): a LONG
    decimal's two limbs in unsigned order; an ARRAY's length, then each
    position's value (and its element mask where elements can be NULL),
    dead positions zero; any other column its normalized value. NULL
    rows collapse to zeros: callers carry the validity beside."""
    if is_long_dec(v.dtype):
        return [H.unsigned_key(k) for k in _long_key_operands(v)]
    if v.is_array:
        m = v.elem_mask()
        lengths = v.lengths.to(torch.int64)
        if v.valid is not None:
            m = m & v.valid[:, None]
            lengths = torch.where(v.valid, lengths, 0)
        parts = [lengths]
        for j in range(v.data.shape[1]):
            parts.append(_group_key_operand(
                Val(v.dtype.element, v.data[:, j], m[:, j])))
            if v.elem_valid is not None:
                parts.append(m[:, j])
        return parts
    return [_group_key_operand(v)]


def _array_payloads(v: Val) -> list:
    """An ARRAY key's values as they ride a grouping sort: data,
    lengths and the element mask (the key parts say which rows are
    one group; these rebuild the group's value)."""
    return [v.data, v.lengths, v.elem_mask()]


def _array_from(v: Val, data, lengths, emask, valid) -> Val:
    return Val(v.dtype, data, valid, v.dictionary, lengths.to(torch.int32),
               emask)


def _unsupported_array(v: Val, what: str) -> None:
    if v.is_array:
        raise NotImplementedError(f"{what} over an ARRAY value")


def _row_hash(dt: DTable, keys: list[str]):
    hs = []
    for k in keys:
        v = dt.cols[k]
        if v.is_string:
            hs.append(H.hash_string_column(v.data, v.dictionary, v.valid))
        elif is_long_dec(v.dtype):
            # LONG decimal: both int64 limbs feed the row key
            hs.append(H.hash_int_column(v.data[:, 0], v.valid))
            hs.append(H.hash_int_column(v.data[:, 1], v.valid))
        elif v.is_array:
            # an ARRAY's length and every position (string elements
            # as codes: one column shares one dictionary)
            hs.extend(H.hash_int_column(p, v.valid) for p in _key_parts(v))
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
    data_valid = None
    if call.arg is not None:
        av = c.compile(call.arg)
        # the variable-length aggregates take arrays (exec/varlen.py)
        _unsupported_array(av, f"aggregate {call.fn}")
        if call.fn == "checksum":
            # NULL rows count, as a fixed hash (below)
            weight = live
        elif call.fn in A.BY_FNS:
            # a NULL x is a legal result; NULL keys exclude rows (arg2)
            weight = live
            data_valid = av.valid
        else:
            weight = live if av.valid is None else (live & av.valid)
        long = A.is_long_decimal(av.dtype)
        data = A.prepare_arg(call.fn, av.data, av.dtype)
        if long and data.ndim == 1:  # scalar long-decimal literal
            data = data.expand(dt.n, 2)
        if long and data.ndim == 2:
            if call.fn not in ("sum", "avg", "min", "max", "arbitrary",
                               "count"):
                raise NotImplementedError(
                    f"{call.fn} over long decimals (precision > 18) is "
                    "not supported yet")
            # int128 [n, 2] -> separate low/high limb columns
            data, data2 = data[:, 0], data[:, 1]
        if call.fn == "checksum" and av.valid is not None:
            data = torch.where(av.valid, data,
                               torch.full_like(data, A.CHECKSUM_NULL))
        if data.ndim == 0:
            data = data.expand(dt.n)
        if data_valid is not None and data_valid.ndim == 0:
            data_valid = data_valid.expand(dt.n)
        arg_type = av.dtype
    else:
        weight = live
        data = torch.ones(dt.n, dtype=torch.int64, device=dt.device)
        arg_type = None
    if call.arg2 is not None:
        av2 = c.compile(call.arg2)
        if av2.valid is not None:
            weight = weight & av2.valid
        data2 = A.prepare_arg2(call.fn, av2.data, av2.dtype)
        if data2.ndim == 0:
            data2 = data2.expand(dt.n)
    if call.mask is not None:
        mv = dt.cols[call.mask]
        weight = weight & mv.data
        if mv.valid is not None:
            weight = weight & mv.valid
    if weight.ndim == 0:
        weight = weight.expand(dt.n)
    return data, weight, data2, data_valid, arg_type


def _state_outputs(out: dict, node, c, call, sym, states, arg_type,
                   dt: DTable):
    """PARTIAL steps emit state columns; others finalize. A value
    state keeps its string dictionary: min/max's argument's, min_by and
    max_by's key's (val) and value's (xval)."""
    if node.step == N.AggStep.PARTIAL:
        for f, arr in states.items():
            dtype = A.state_type(call, f)
            dictionary = None
            if f == "val" and call.arg is not None:
                dictionary = _arg_dictionary(
                    c, call.arg2 if call.fn in A.BY_FNS else call.arg,
                    dtype)
            elif f == "xval":
                dictionary = _arg_dictionary(c, call.arg, dtype)
            out[f"{sym}${f}"] = Val(dtype, arr, None, dictionary)
        return
    fdata, fvalid = A.finalize(call.fn, states, call.dtype, arg_type,
                               param=call.param)
    dictionary = None
    if node.step == N.AggStep.FINAL:
        state = dt.cols.get(f"{sym}$xval" if call.fn in A.BY_FNS
                            else f"{sym}$val")
        dictionary = None if state is None else state.dictionary
    if dictionary is None:
        dictionary = _arg_dictionary(c, call.arg, call.dtype)
    out[sym] = Val(call.dtype, fdata, fvalid, dictionary)


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
    array_keys = []  # (sym, Val, valid_idx): values ride outside
    for k in node.group_keys:
        v = dt.cols[k]
        if k not in id_keys:
            plain_keys.append((k, v, v.valid))
            continue
        if is_long_dec(v.dtype):  # LONG decimal key
            # uint64 operands sort by their unsigned order
            hi_idx, lo_idx = (_add(p) for p in _key_parts(v))
            valid_idx = None if v.valid is None else _add(v.valid)
            key_refs.append((k, v, ("long", hi_idx, lo_idx), valid_idx))
            continue
        if v.is_array:
            for p in _key_parts(v):
                _add(p)
            array_keys.append((k, v, None if v.valid is None
                               else _add(v.valid)))
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
        if is_long_dec(v.dtype):
            key_refs.append((k, v, ("long", *(_add(p) for p in
                                              _key_parts(v))), valid_idx))
            continue
        if v.is_array:
            key_refs.append((k, v, ("array", *(_add(p) for p in
                                               _array_payloads(v))),
                             valid_idx))
            continue
        key_refs.append((k, v, _add(v.data), valid_idx))
    for k, v, valid_idx in array_keys:
        key_refs.append((k, v, ("array", *(_add(p) for p in
                                           _array_payloads(v))), valid_idx))

    # each call folds by segmented scans over the sorted rows, or (the
    # sketches, whose [rows, width] states ride no sort) by segment ops
    # over the rows' group slots
    call_refs: dict[str, tuple] = {}
    for sym, call in node.aggs.items():
        if call.fn not in A.PORTED_FNS:
            raise NotImplementedError(
                f"aggregate {call.fn} is not ported to presto_tpu_torch yet")
        scan = call.fn in A.SCAN_FNS
        if is_final:
            sum_state = dt.cols.get(f"{sym}$sum")
            arg_type = sum_state.dtype if sum_state is not None else None
            idxs = ({f: _add(dt.cols[f"{sym}${f}"].data)
                     for f in A.state_fields(call)} if scan else None)
            call_refs[sym] = ("merge" if scan else "seg", idxs, arg_type)
        else:
            inputs = _agg_call_inputs(c, dt, call, live)
            arg_type = inputs[4]
            if scan:
                call_refs[sym] = ("fold", tuple(
                    None if x is None else _add(x) for x in inputs[:4]),
                    arg_type)
            else:
                call_refs[sym] = ("seg", inputs[:4], arg_type)

    sg = H.SortedGroups(rh, live, payloads, num_key_payloads)
    ok = sg.ngroups <= capacity
    sp = sg.payloads

    compact_in: list = []

    def _adc(arr) -> int:
        compact_in.append(arr)
        return len(compact_in) - 1

    key_out = [(sym, v,
                (di[0], *(_adc(sp[i]) for i in di[1:]))
                if isinstance(di, tuple) else _adc(sp[di]),
                None if vi is None else _adc(sp[vi]))
               for sym, v, di, vi in key_refs]

    state_out: dict[str, dict] = {}
    seg_states: dict[str, dict] = {}
    arg_types: dict[str, object] = {}
    slots = None
    for sym, call in node.aggs.items():
        kind, refs, arg_type = call_refs[sym]
        arg_types[sym] = arg_type
        if kind == "seg":
            if slots is None:
                slots = sg.slots()
            if is_final:
                seg_states[sym] = A.merge(
                    call.fn, {f: dt.cols[f"{sym}${f}"].data
                              for f in A.state_fields(call)},
                    slots, capacity, live)
            else:
                data, weight, data2, data_valid = refs
                seg_states[sym] = A.fold(
                    call.fn, data, weight, slots, capacity, data2=data2,
                    data_valid=data_valid, param=call.param)
            continue
        if kind == "fold":
            di, wi, d2i, dvi = refs
            st = A.scan_fold(call.fn, sp[di], sp[wi], sg,
                             data2=None if d2i is None else sp[d2i],
                             data_valid=None if dvi is None else sp[dvi],
                             param=call.param)
        else:
            st = A.scan_merge(call.fn, {f: sp[i] for f, i in refs.items()},
                              sg.live, sg)
        state_out[sym] = {f: _adc(arr) for f, arr in st.items()}

    compacted, occupied = sg.compact(compact_in, capacity)

    out: dict[str, Val] = {}
    for sym, v, di, vi in key_out:
        valid = None if vi is None else compacted[vi]
        out[sym] = _key_out(v, di, compacted, valid)

    for sym, call in node.aggs.items():
        states = seg_states.get(sym) or {
            f: compacted[i] for f, i in state_out[sym].items()}
        _state_outputs(out, node, c, call, sym, states, arg_types[sym],
                       dt)

    return DTable(out, occupied, capacity, dt.device), ok


def _key_out(v: Val, di, compacted: list, valid) -> Val:
    """A group key's output column from its compacted payloads: an int
    index, or ("long", hi, lo) limbs, or ("array", data, lengths,
    element mask)."""
    if not isinstance(di, tuple):
        return Val(v.dtype, compacted[di], valid, v.dictionary)
    if di[0] == "long":
        return Val(v.dtype, _unpack_long_key(
            compacted[di[1]] ^ H.INT64_MIN, compacted[di[2]] ^ H.INT64_MIN),
            valid, v.dictionary)
    return _array_from(v, *(compacted[i] for i in di[1:]), valid)


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
            data, weight, data2, data_valid, arg_type = \
                _agg_call_inputs(c, dt, call, live)
            states = A.fold(call.fn, data, weight, slots, capacity,
                            data2=data2, data_valid=data_valid,
                            param=call.param)
        _state_outputs(out, node, c, call, sym, states, arg_type, dt)

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


def _arg_dictionary(c: ExprCompiler, arg, out_type):
    """The dictionary of a string argument (min/max, min_by/max_by keep
    their value's): a column's, or, for a VARCHAR output, a string
    expression's, compiled again for it (the reference keeps a
    column's only, so min/max of a string expression come out as
    codes: ROADMAP R9)."""
    if isinstance(arg, ir.ColumnRef):
        v = c.columns.get(arg.name)
        if v is not None and v.is_string:
            return v.dictionary
        return None
    if (arg is not None and isinstance(arg.dtype, T.VarcharType)
            and isinstance(out_type, T.VarcharType)):
        return c.compile(arg).dictionary
    return None


def _verify_keys(left: DTable, right: DTable,
                 criteria: list[tuple[str, str]], gather):
    """Value-compare matched join keys (64-bit row-hash collision
    defence; a dense probe hashes no key, so every key but the dense
    one is checked here). String keys compare as codes in one code
    space (a probe string absent from the build dictionary matches
    nothing)."""
    eq = None
    for lk, rk in criteria:
        lv, rv = left.cols[lk], right.cols[rk]
        _unsupported_array(lv, "a join key")
        if lv.is_string or rv.is_string:
            lcodes, rcodes = _align_strings(lv, rv)
            e = lcodes == take(rcodes, gather)
        else:
            e = lv.data == take(rv.data, gather)
        if is_long_dec(lv.dtype) or is_long_dec(rv.dtype):
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
        g = take_val(v, gather)
        # INNER: unmatched rows die via the live mask, so the found
        # mask is redundant as validity (keeps build-side dictionary
        # keys eligible for the direct group-by path downstream)
        out[sym] = g if inner else dataclasses.replace(
            g, valid=found if g.valid is None else found & g.valid)

    if node.filter is not None:
        fv = ExprCompiler(out, left.device).compile(node.filter)
        match_ok = fv.data if fv.valid is None else (fv.data & fv.valid)
        found = found & match_ok
        if not inner:
            for sym in right.cols:
                v = out[sym]
                out[sym] = dataclasses.replace(
                    v, valid=found if v.valid is None else found & v.valid)

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
    from presto_tpu_torch.kernels import multijoin as MJ
    gathers, live, ok = MJ.walk_chain(
        spine.cols, spine.live_mask(),
        [(b.cols, b.live_mask(), b.n) for b in builds], criteria, growth)
    out = dict(spine.cols)
    for bdt, gather in zip(builds, gathers):
        for sym, v in bdt.cols.items():
            out[sym] = take_val(v, gather)
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
        out[sym] = take_val(v, probe_idx)
    verify = None
    for lk, rk in node.criteria:
        lv, rv = left.cols[lk], right.cols[rk]
        _unsupported_array(lv, "a join key")
        if lv.is_string or rv.is_string:
            continue
        e = take(lv.data, probe_idx) == take(rv.data, gather)
        if is_long_dec(lv.dtype) or is_long_dec(rv.dtype):
            e = e.all(dim=1)
        verify = e if verify is None else (verify & e)
    if verify is not None and not left_join:
        out_live = out_live & (verify | ~matched)
    for sym, v in right.cols.items():
        g = take_val(v, gather)
        if left_join:
            g = dataclasses.replace(g, valid=matched if g.valid is None
                                    else (matched & g.valid))
        # inner expansion emits matched rows only: matched is
        # redundant with out_live (see apply_join)
        out[sym] = g

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
        surv = surv.scatter_reduce(0, pidx, keep.to(torch.int32), "amax",
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
            out[sym] = dataclasses.replace(out[sym], valid=valid)
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
    matched = matched.index_put((slot,), torch.ones(
        (), dtype=torch.bool, device=dev))
    zero = torch.zeros(nb, dtype=torch.int64, device=dev)
    cols = {sym: dataclasses.replace(
                take_val(v, zero),
                valid=torch.zeros(nb, dtype=torch.bool, device=dev))
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
        if v0.is_array:
            vs = [broadcast_rows(v, p.n) for v, p in zip(vs, parts)]
            cap = max(v.data.shape[1] for v in vs)
            data = torch.cat([_pad_cap(v.data, cap, 0) for v in vs])
            lengths = torch.cat([v.lengths for v in vs])
            ev = None
            if any(v.elem_valid is not None for v in vs):
                ev = torch.cat([_pad_cap(v.elem_mask(), cap, False)
                                for v in vs])
        else:
            data = torch.cat([_rows(v.data, p.n, is_long_dec(v0.dtype))
                              for v, p in zip(vs, parts)])
            lengths = ev = None
        valid = None
        if any(v.valid is not None for v in vs):
            valid = torch.cat([
                torch.ones(p.n, dtype=torch.bool, device=p.device)
                if v.valid is None else v.valid.expand(p.n)
                for v, p in zip(vs, parts)])
        cols[sym] = Val(v0.dtype, data, valid, v0.dictionary, lengths, ev)
    live = torch.cat([p.live_mask() for p in parts])
    return DTable(cols, live, sum(p.n for p in parts), first.device)


def _pad_cap(x, cap: int, fill):
    """[n, c] element values padded to [n, cap] with ``fill`` (a
    concatenation: ``F.pad`` takes no bool tensor)."""
    if x.shape[1] == cap:
        return x
    pad = torch.full((x.shape[0], cap - x.shape[1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


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
        bits = bits.index_put(
            (torch.where(inside, bkey - lo, torch.full_like(bkey, span)),),
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
        if v.is_array:  # [n] lengths and the [n, cap] element mask
            arrays[f"{sym}!l"] = v.lengths.contiguous()
            if v.elem_valid is not None:
                arrays[f"{sym}!e"] = v.elem_valid.contiguous()
    out = K.dispatch("compact")(live.contiguous(), arrays, capacity)
    cols = {sym: Val(v.dtype, out[f"{sym}!d"], out.get(f"{sym}!v"),
                     v.dictionary, out.get(f"{sym}!l"), out.get(f"{sym}!e"))
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
            out[sym] = take_val(v, idx)
    live = take(left.live_mask(), i) & take(right.live_mask(), j)
    return DTable(out, live, nl * nr, dev)


def apply_cross_scalar(left: DTable, right: DTable) -> DTable:
    """Cross join against a single-row relation (an uncorrelated scalar
    subquery): the scalar row's columns broadcast over the probe side.
    The live row's index is an argmax on the device (0 with no live
    row; validity then makes every value NULL), gathered by
    ``index_select``: indexing with a 0-d tensor reads it on the host."""
    rlive = right.live_mask()
    idx = torch.argmax(rlive.to(torch.int32)).reshape(1)
    any_live = torch.any(rlive)
    out = dict(left.cols)
    for sym, v in right.cols.items():
        row = take_val(v, idx)
        rv = any_live if v.valid is None else (any_live & row.valid[0])
        row = dataclasses.replace(row, valid=rv.reshape(1))
        out[sym] = broadcast_rows(row, left.n)
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
        out.append(dataclasses.replace(v, data=take(remap, codes),
                                       dictionary=uobj))
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
            vals.append(v if v.is_string or v.is_array
                        else cast_val(v, dtype))
        if isinstance(dtype, T.VarcharType) or (
                isinstance(dtype, T.ArrayType)
                and isinstance(dtype.element, T.VarcharType)):
            vals = _unify_string_vals(vals)
        for r, v in zip(renamed, vals):
            r.cols[sym] = dataclasses.replace(
                v, dtype=dtype, dictionary=v.dictionary
                if v.is_string or v.is_array else None)
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
        key_ops.extend(_key_parts(v))
        if v.valid is not None:
            key_ops.append(v.valid)
    sg = H.SortedGroups(rh, live, key_ops, len(key_ops))
    # the stable sort puts each run's smallest row index first
    mark = torch.zeros(dt.n, dtype=torch.bool, device=dt.device)
    mark = mark.scatter(
        0, torch.clamp(sg.sidx.to(torch.int64), 0, dt.n - 1), sg.is_new)
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
        _unsupported_array(v, "ORDER BY")
        data = v.data
        if is_long_dec(v.dtype):
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


def merge_runs_perm(keys: list, k: int, m: int) -> torch.Tensor:
    """Permutation merging ``k`` presorted runs of ``m`` rows each
    (stored concatenated) into one sorted order: the kernel behind the
    merge exchange of a distributed sort (the reference's
    ``merge_runs_perm``, MergeOperator.java:44).

    Each row's output position is its rank in its own run plus, for
    every other run, the count of that run's rows ordered before it,
    found by a vectorised binary search under the full lexicographic
    comparator: O(N k log m) elementwise work instead of a sort of N
    rows. Ties break by (run, rank in run), as a stable sort of the
    concatenation would. ``keys`` are ``_sort_keys`` output: NaN-free
    (NULL and NaN ride in class-key levels), so the comparator is
    total. int64 permutation."""
    n = k * m
    dev = keys[0].device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    run_of = idx // m
    rank = idx % m
    # a lower-bound search over [0, m] takes floor(log2 m) + 1 halvings
    steps = m.bit_length()
    for j in range(k):
        run_keys = [kk[j * m:(j + 1) * m] for kk in keys]
        # ties in run j order before rows of later runs (stability)
        tie_after = run_of > j
        lo = torch.zeros(n, dtype=torch.int64, device=dev)
        hi = torch.full((n,), m, dtype=torch.int64, device=dev)
        for _ in range(steps):
            mid = (lo + hi) >> 1
            # a converged lane (lo == hi == m) reads a clamped row and
            # does not move
            at = torch.clamp(mid, 0, m - 1)
            lt = torch.zeros(n, dtype=torch.bool, device=dev)
            eq = torch.ones(n, dtype=torch.bool, device=dev)
            for rk, qk in zip(run_keys, keys):
                c = rk[at]
                lt = lt | (eq & (c < qk))
                eq = eq & (c == qk)
            before = lt | (eq & tie_after)  # run[mid] orders first
            open_ = lo < hi
            lo = torch.where(open_ & before, mid + 1, lo)
            hi = torch.where(open_ & ~before, mid, hi)
        rank = rank + torch.where(run_of == j, torch.zeros_like(lo), lo)
    # rank is a permutation of 0..n-1: invert it into a gather index
    perm = torch.empty_like(rank)
    perm[rank] = idx
    return perm


def merge_sorted_runs(dt: DTable, orderings: list[N.Ordering],
                      k: int) -> DTable:
    """Merge a table holding ``k`` concatenated presorted runs."""
    assert dt.n % k == 0
    perm = merge_runs_perm(_sort_keys(dt, orderings), k, dt.n // k)
    return _gather_table(dt, perm)


def head(dt: DTable, count: int) -> DTable:
    """The first ``count`` rows (a compaction after a sort: the analog
    of a bounded page flush before an exchange), every companion of a
    column with them; a scalar column expands to its rows first."""
    c = min(count, dt.n)
    idx = torch.arange(c, dtype=torch.int64, device=dt.device)
    cols = {}
    for sym, v in dt.cols.items():
        if v.is_array:
            v = broadcast_rows(v, dt.n)
        else:
            v = dataclasses.replace(
                v, data=_rows(v.data, dt.n, is_long_dec(v.dtype)),
                valid=None if v.valid is None else v.valid.expand(dt.n))
        cols[sym] = take_val(v, idx)
    live = None if dt.live is None else dt.live[:c]
    return DTable(cols, live, c, dt.device)


def _gather_table(dt: DTable, perm) -> DTable:
    out = {sym: take_val(v, perm) for sym, v in dt.cols.items()}
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
    array_cols = []
    for sym, v in dt.cols.items():
        di = len(payloads)
        if is_long_dec(v.dtype) or v.is_array:
            payloads += _key_parts(v)
            vi = None
            if v.valid is not None:
                vi = len(payloads)
                payloads.append(v.valid)
            if v.is_array:  # its values ride outside the keys
                array_cols.append((sym, v, vi))
            else:
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
    for sym, v, vi in array_cols:
        at = len(payloads)
        payloads += _array_payloads(v)
        refs.append((sym, v, ("array", at, at + 1, at + 2), vi))
    sg = H.SortedGroups(rh, live, payloads, num_key_payloads)
    ok = sg.ngroups <= capacity
    compacted, occupied = sg.compact_first(sg.payloads, capacity)
    out = {sym: _key_out(v, di, compacted,
                         None if vi is None else compacted[vi])
           for sym, v, di, vi in refs}
    # the columns in their input order
    out = {sym: out[sym] for sym in dt.cols}
    return DTable(out, occupied, capacity, dt.device), ok


def _repeat_rows(v: Val, k: int) -> Val:
    """Each row of a Val ``k`` times in a row, companions included
    (``repeat_interleave`` by a Python int: no host sync)."""
    def rep(x):
        return None if x is None else torch.repeat_interleave(x, k, dim=0)
    return Val(v.dtype, rep(v.data), rep(v.valid), v.dictionary,
               rep(v.lengths), rep(v.elem_valid),
               None if v.map_keys is None else _repeat_rows(v.map_keys, k))


def apply_unnest(dt: DTable, node: N.Unnest) -> DTable:
    """Array elements as rows (reference UnnestOperator over UnnestNode):
    output row (i, j) carries source row i's columns and each array's
    j-th element, a static n * cap rows. Several arrays zip to the
    longest length (shorter ones pad with NULLs); a NULL array gives no
    rows; ``ordinality_sym`` is the 1-based position."""
    n, dev = dt.n, dt.device
    arrays = {s: broadcast_rows(dt.cols[s], n) for s in node.array_syms}
    cap = max(a.data.shape[1] for a in arrays.values())
    # per-row zip length: the longest array (a NULL array counts 0)
    zlen = None
    for a in arrays.values():
        ln = a.lengths if a.valid is None \
            else torch.where(a.valid, a.lengths, 0)
        zlen = ln if zlen is None else torch.maximum(zlen, ln)
    out: dict[str, Val] = {}
    for sym, v in dt.cols.items():
        if sym in node.array_syms and sym not in node.out_syms:
            continue  # a consumed array drops from the output
        out[sym] = _repeat_rows(v, cap)
    j = torch.arange(cap, dtype=torch.int32, device=dev).repeat(n)
    for osym, asym in zip(node.out_syms, node.array_syms):
        a = arrays[asym]
        valid = None
        if len(arrays) > 1:
            # a shorter array of the zip pads with NULLs
            valid = j < torch.repeat_interleave(a.lengths, cap)
            if a.valid is not None:
                valid = valid & torch.repeat_interleave(a.valid, cap)
        # (one array's rows past its length are dead: the live mask
        # says so, and a dictionary column without validity keeps the
        # direct group-by path downstream)
        if a.elem_valid is not None:
            ev = _pad_cap(a.elem_valid, cap, False).reshape(n * cap)
            valid = ev if valid is None else valid & ev
        out[osym] = Val(node.out_types[osym],
                        _pad_cap(a.data, cap, 0).reshape(n * cap), valid,
                        a.dictionary)
    if node.ordinality_sym:
        out[node.ordinality_sym] = Val(T.BIGINT, (j + 1).to(torch.int64))
    live = (torch.repeat_interleave(dt.live_mask(), cap)
            & (j < torch.repeat_interleave(zlen, cap)))
    return DTable(out, live, n * cap, dev)


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
        if v.is_array:  # every part of the identity equal
            pair_eq = torch.ones(max(n - 1, 0), dtype=torch.bool,
                                 device=dev)
            for p in _key_parts(v):
                p = p[perm]
                pair_eq = pair_eq & (p[1:] == p[:-1])
        else:
            d = v.data[perm]
            pair_eq = d[1:] == d[:-1]
            if is_long_dec(v.dtype):  # limbs: equal iff both are
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
    inv = torch.zeros(n, dtype=torch.int64, device=dev).scatter(
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
    c = ExprCompiler({s: take_val(v, perm) for s, v in dt.cols.items()},
                     dev)
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
        _unsupported_array(v, "a window aggregate")
        if is_long_dec(v.dtype):
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
