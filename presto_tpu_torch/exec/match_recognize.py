"""MATCH_RECOGNIZE execution: predicates on the device, the NFA on the
host — the port of ``presto_tpu/exec/match_recognize.py``.

The split is the reference's (its matcher VM, operator/window/matcher/
Matcher.java, is row-at-a-time too): the input rows are sorted by
(partition, order) on the host; the per-row DEFINE predicates — the
data-heavy part — and the measure inputs run through the port's
``ExprCompiler`` on the device over the sorted columns (the shifted
``$prev`` columns included: ``torch.roll`` with the rows whose PREV
crosses a partition boundary NULL); one counted fetch brings every
variable's match mask and every measure back; only the pattern
automaton runs as a host loop over candidate match positions. ONE ROW
PER MATCH + AFTER MATCH SKIP PAST LAST ROW.

Thompson NFA with preference order: greedy quantifiers explore the
consume branch first; the first accepting path in preference order is
the SQL-required preferred match. A visited set per (state, position)
bounds the search linearly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table, dictionary_encode
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.compile import ExprCompiler, Val
from presto_tpu_torch.sql import ast as A


# -- pattern -> NFA ----------------------------------------------------------


@dataclasses.dataclass
class _State:
    kind: str  # var | split | accept
    var: str | None = None
    nxt: int = -1
    alt: int = -1  # split: preferred branch is nxt, then alt


def compile_pattern(pattern) -> list[_State]:
    states: list[_State] = []

    def add(st: _State) -> int:
        states.append(st)
        return len(states) - 1

    def build(p, nxt: int) -> int:
        """Returns the entry state for pattern ``p`` continuing to
        ``nxt``."""
        if isinstance(p, A.PatVar):
            return add(_State("var", p.name.lower(), nxt))
        if isinstance(p, A.PatConcat):
            entry = nxt
            for part in reversed(p.parts):
                entry = build(part, entry)
            return entry
        if isinstance(p, A.PatAlt):
            entry = build(p.options[-1], nxt)
            for opt in reversed(p.options[:-1]):
                o = build(opt, nxt)
                entry = add(_State("split", None, o, entry))
            return entry
        if isinstance(p, A.PatQuant):
            lo, hi = p.min, p.max
            entry = nxt
            if hi is None:
                # loop: split(enter-body -> loop, exit) — greedy
                # prefers the body
                loop = add(_State("split", None, -1, nxt))
                body = build(p.term, loop)
                states[loop].nxt = body
                entry = loop
            else:
                for _ in range(hi - lo):
                    body = build(p.term, entry)
                    entry = add(_State("split", None, body, entry))
            for _ in range(lo):
                entry = build(p.term, entry)
            return entry
        raise TypeError(f"unknown pattern node {type(p).__name__}")

    accept = add(_State("accept"))
    start = build(pattern, accept)
    return states, start  # type: ignore[return-value]


def match_at(states, start: int, var_match: dict[str, np.ndarray],
             pos: int, end: int):
    """Preferred match starting at ``pos``: returns (last_pos_exclusive,
    classifier list of per-row variables) or None. Iterative DFS in
    preference order with (state, pos) dedupe."""
    stack = [(start, pos, ())]
    seen: set[tuple[int, int]] = set()
    while stack:
        st, i, path = stack.pop()
        if (st, i) in seen:
            continue
        seen.add((st, i))
        s = states[st]
        if s.kind == "accept":
            if i > pos:  # empty matches produce no row (subset)
                return i, list(path)
            continue
        if s.kind == "split":
            # LIFO stack: push the less-preferred branch first
            stack.append((s.alt, i, path))
            stack.append((s.nxt, i, path))
            continue
        # var consume
        if i < end and bool(var_match[s.var][i]):
            stack.append((s.nxt, i + 1, path + (s.var,)))
    return None


# -- operator ----------------------------------------------------------------


def _sort_rows(table: Table, node) -> tuple:
    """(live row indices sorted by (partition, order), partition
    starts in that order), on the host as in the reference."""
    n = table.nrows
    live = (np.ones(n, bool) if table.mask is None
            else np.asarray(table.mask))
    idx = np.flatnonzero(live)
    # numpy lexsort: the least significant key first
    keys: list[np.ndarray] = []
    for o in reversed(node.orderings):
        data = np.asarray(table.columns[o.symbol].data)[idx]
        keys.append(-data if not o.ascending else data)
    for s in reversed(node.partition_by):
        keys.append(np.asarray(table.columns[s].data)[idx])
    ridx = idx[np.lexsort(keys)] if keys else idx
    m = len(ridx)
    new_part = np.zeros(m, bool)
    if m:
        new_part[0] = True
    for s in node.partition_by:
        d = np.asarray(table.columns[s].data)[ridx]
        new_part[1:] |= d[1:] != d[:-1]
        pvalid = table.columns[s].valid
        if pvalid is not None:
            vv = np.asarray(pvalid)[ridx]
            new_part[1:] |= vv[1:] != vv[:-1]
    return ridx, new_part


def _device_columns(engine, table: Table, node, ridx, new_part) -> dict:
    """The columns the DEFINE predicates and measures read, sorted and
    on the device, with each ``{sym}$prev{k}`` shift."""
    referenced = set()
    for cond in node.defines.values():
        referenced |= ir.referenced_columns([cond])
    for _sym, _kind, expr, _dtype in node.measures:
        if expr is not None:
            referenced |= ir.referenced_columns([expr])
    bases = {ref.rsplit("$prev", 1)[0] if "$prev" in ref else ref
             for ref in referenced}

    def up(a):
        return HS.upload(np.ascontiguousarray(a), engine.device,
                         "match-columns")

    cols: dict[str, Val] = {}
    for sym in bases:
        col = table.columns[sym]
        cols[sym] = Val(col.dtype, up(np.asarray(col.data)[ridx]),
                        None if col.valid is None
                        else up(np.asarray(col.valid)[ridx]),
                        col.dictionary)
    m = len(ridx)
    pos_in_part = None
    for ref in referenced:
        if "$prev" not in ref:
            continue
        base, cnt = ref.rsplit("$prev", 1)
        k = int(cnt)
        if pos_in_part is None:
            at = np.arange(m)
            pos_in_part = up(at - np.maximum.accumulate(
                np.where(new_part, at, 0)))
        src = cols[base]
        valid = (torch.ones(m, dtype=torch.bool, device=engine.device)
                 if src.valid is None else src.valid)
        # rows whose PREV crosses a partition boundary are NULL
        cols[ref] = Val(src.dtype, torch.roll(src.data, k, 0),
                        torch.roll(valid, k, 0) & (pos_in_part >= k),
                        src.dictionary)
    return cols


def evaluate(engine, table: Table, node) -> Table:
    """MATCH_RECOGNIZE over a materialized input table: the ONE ROW
    PER MATCH output table."""
    ridx, new_part = _sort_rows(table, node)
    m = len(ridx)
    part_start_idx = np.flatnonzero(new_part)
    c = ExprCompiler(_device_columns(engine, table, node, ridx, new_part),
                     engine.device)

    def rows(x):
        return x.expand(m) if x.ndim == 0 else x

    pattern_vars = _pattern_vars(node.pattern)
    masks = {}
    for var in pattern_vars:
        cond = node.defines.get(var)
        if cond is not None:
            v = c.compile(cond)
            masks[var] = rows(v.data if v.valid is None
                              else v.data & v.valid)
    measure_vals = {sym: c.compile(expr)
                    for sym, _kind, expr, _dtype in node.measures
                    if expr is not None}
    # ONE device->host fetch for every match mask and measure: reading
    # them inside the per-match loop below would sync once per match
    masks_np, meas_host = HS.fetch(
        (masks, {sym: (rows(v.data), None if v.valid is None
                       else rows(v.valid))
                 for sym, v in measure_vals.items()}),
        site="match-measures")
    # as Python lists: the automaton reads them one row at a time
    var_match = {var: masks_np[var].tolist() if var in masks_np
                 else [True] * m  # undefined: always true
                 for var in pattern_vars}
    meas_host = {sym: (data.tolist(), None if vmask is None
                       else vmask.tolist())
                 for sym, (data, vmask) in meas_host.items()}

    states, start_state = compile_pattern(node.pattern)

    out_rows: dict[str, list] = {s: [] for s in node.partition_by}
    out_meas: dict[str, list] = {sym: [] for sym, *_ in node.measures}
    out_valid: dict[str, list] = {sym: [] for sym, *_ in node.measures}
    match_no = 0
    bounds = list(part_start_idx) + [m]
    for b in range(len(bounds) - 1):
        lo, hi = bounds[b], bounds[b + 1]
        i = lo
        match_in_part = 0
        while i < hi:
            found = match_at(states, start_state, var_match, i, hi)
            if found is None:
                i += 1
                continue
            end, classifiers = found
            match_no += 1
            match_in_part += 1
            first_row, last_row = i, end - 1
            for s in node.partition_by:
                out_rows[s].append(int(ridx[first_row]))
            for sym, kind, _expr, _dtype in node.measures:
                if kind == "match_number":
                    out_meas[sym].append(match_in_part)
                    out_valid[sym].append(True)
                elif kind == "classifier":
                    out_meas[sym].append(classifiers[-1].upper())
                    out_valid[sym].append(True)
                else:
                    row = first_row if kind == "first" else last_row
                    data, vmask = meas_host[sym]
                    out_meas[sym].append(data[row])
                    out_valid[sym].append(True if vmask is None
                                          else bool(vmask[row]))
            i = end  # AFTER MATCH SKIP PAST LAST ROW

    nout = match_no
    out_cols: dict[str, Column] = {}
    for s in node.partition_by:
        src = table.columns[s]
        at = np.asarray(out_rows[s], dtype=np.int64)
        data = (np.asarray(src.data)[at] if nout
                else np.empty(0, np.asarray(src.data).dtype))
        valid = None
        if src.valid is not None:
            valid = (np.asarray(src.valid)[at] if nout
                     else np.empty(0, bool))
        out_cols[s] = Column(src.dtype, data, valid, src.dictionary)
    for sym, kind, expr, dtype in node.measures:
        valid = np.asarray(out_valid[sym], bool)
        if kind == "classifier":
            codes, d = dictionary_encode(np.asarray(out_meas[sym], object))
            out_cols[sym] = Column(dtype, codes,
                                   None if valid.all() else valid, d)
        elif (expr is not None and expr.dtype
              and isinstance(dtype, T.VarcharType)):
            out_cols[sym] = Column(
                dtype, np.asarray(out_meas[sym]),
                None if valid.all() else valid,
                measure_vals[sym].dictionary)
        else:
            phys = dtype.physical_dtype
            out_cols[sym] = Column(
                dtype, np.asarray(out_meas[sym], phys) if nout
                else np.empty(0, phys),
                None if valid.all() else valid, None)
    return Table(out_cols, nout, None)


def _pattern_vars(p) -> list[str]:
    out: list[str] = []

    def walk(q):
        if isinstance(q, A.PatVar):
            if q.name.lower() not in out:
                out.append(q.name.lower())
        elif isinstance(q, A.PatConcat):
            for x in q.parts:
                walk(x)
        elif isinstance(q, A.PatAlt):
            for x in q.options:
                walk(x)
        elif isinstance(q, A.PatQuant):
            walk(q.term)

    walk(p)
    return out
