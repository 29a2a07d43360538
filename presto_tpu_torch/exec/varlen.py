"""Host-finalized variable-length aggregates: array_agg, map_agg and
listagg — the port of ``presto_tpu/exec/varlen.py``.

A fixed-width device column cannot hold a group's variable-length
value, so these aggregates split execution as the reference does: the
device runs the aggregate's source subplan (one counted fetch of the
grouping keys, the arguments and the order keys) and, separately, the
scalar part of the aggregation; the host then builds each group's list,
map or string and attaches it to the scalar result by the group keys.

The reference groups the materialized rows in a Python loop over every
input row. Here the grouping is vectorized: the keys become integer
columns (strings as positions in one merged dictionary, so the two
tables' dictionaries need not be one object), one stable lexicographic
sort by (group, order key) puts each group's rows in place, and only
the loop that builds each group's value runs per group. The semantics
are the reference's: ``sorted(key=(is None, k), reverse=desc)`` puts
NULL order keys last ascending and first descending and keeps input
order among ties; array_agg keeps NULL elements, map_agg drops NULL
keys (a later duplicate key's value wins), listagg drops NULL values;
DISTINCT keeps each value's first occurrence; a group whose every row
was dropped (FILTER, NULLs) is NULL.

Supported plan shape: the varlen Aggregate under a chain of Output,
Project (varlen symbols passed as bare references), Sort, TopN and
Limit. Any other shape materializes the aggregate alone and runs the
rest of the plan over it as a host-table carrier (the padded 2-D array
layout), so ``cardinality``, ``transform`` and UNNEST read its lists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table, _decode_column
from presto_tpu_torch.expr import aggmeta as A
from presto_tpu_torch.expr import ir
from presto_tpu_torch.plan import nodes as N


def find_varlen_aggregate(plan: N.PlanNode) -> N.Aggregate | None:
    """The (single) Aggregate node carrying varlen calls, or None."""
    found: list[N.Aggregate] = []

    def visit(node):
        if isinstance(node, N.Aggregate) and any(
                c.fn in A.VARLEN_FNS for c in node.aggs.values()):
            found.append(node)
        for s in node.sources():
            visit(s)

    visit(plan)
    if len(found) > 1:
        raise NotImplementedError(
            "multiple variable-length aggregations in one query")
    return found[0] if found else None


def _chain_to(plan: N.PlanNode, target: N.Aggregate) -> list[N.PlanNode]:
    """Root->target node chain; validates the supported shape."""
    chain: list[N.PlanNode] = []
    node = plan
    varlen_syms = {s for s, c in target.aggs.items()
                   if c.fn in A.VARLEN_FNS}
    while node is not target:
        if isinstance(node, N.Output):
            pass
        elif isinstance(node, N.Project):
            for e in node.assignments.values():
                refs = ir.referenced_columns([e])
                if refs & varlen_syms and not isinstance(e, ir.ColumnRef):
                    raise NotImplementedError(
                        "variable-length aggregate results cannot feed "
                        "scalar expressions")
        elif isinstance(node, (N.Sort, N.TopN, N.Limit)):
            if isinstance(node, (N.Sort, N.TopN)) and any(
                    o.symbol in varlen_syms for o in node.orderings):
                raise NotImplementedError(
                    "ORDER BY on a variable-length aggregate result")
        else:
            raise NotImplementedError(
                f"plan node {type(node).__name__} above a "
                "variable-length aggregation is unsupported")
        chain.append(node)
        srcs = node.sources()
        if len(srcs) != 1:
            raise NotImplementedError(
                "variable-length aggregation under a multi-source node")
        node = srcs[0]
    return chain


def _strip_and_rebuild(chain: list[N.PlanNode], agg: N.Aggregate,
                       scalar_agg: N.Aggregate,
                       keep_syms: list[str]) -> N.PlanNode:
    """Rebuild the chain over ``scalar_agg`` with varlen symbols removed
    and group keys (``keep_syms``) passed through every level."""
    varlen_syms = {s for s, c in agg.aggs.items()
                   if c.fn in A.VARLEN_FNS}
    node: N.PlanNode = scalar_agg
    for level in reversed(chain):
        if isinstance(level, N.Output):
            keep_pairs = [(n, s) for n, s in
                          zip(level.names, level.symbols)
                          if s not in varlen_syms]
            names = [n for n, _ in keep_pairs]
            syms = [s for _, s in keep_pairs]
            # every group key also rides under a reserved name, so the
            # host matching never depends on what the user selected
            for k in keep_syms:
                names.append(f"__vl_{k}")
                syms.append(k)
            node = N.Output(node, names, syms)
        elif isinstance(level, N.Project):
            assigns = {s: e for s, e in level.assignments.items()
                       if not (ir.referenced_columns([e]) & varlen_syms)}
            for k in keep_syms:
                if k not in assigns:
                    assigns[k] = ir.ColumnRef(_sym_type(scalar_agg, k), k)
            node = N.Project(node, assigns)
        else:
            node = dataclasses.replace(level, source=node)
    return node


def _sym_type(agg: N.Aggregate, sym: str) -> T.DataType:
    return agg.source.output_types()[sym]


# -- vectorized grouping --------------------------------------------------------


def _live(table: Table) -> np.ndarray:
    return (np.ones(table.nrows, bool) if table.mask is None
            else np.asarray(table.mask, bool))


def _valid(col: Column, n: int) -> np.ndarray:
    return (np.ones(n, bool) if col.valid is None
            else np.asarray(col.valid, bool))


def _key_columns(cols: list[Column], union: list) -> list[np.ndarray]:
    """A key column as sort columns (NULL rows 0, with the NULL flag as
    its own column): a string's position in ``union`` (the sorted union
    of the key's dictionaries), a LONG decimal's two limbs, a float's
    value with -0.0 as 0.0, any other value as int64."""
    out = []
    for col, u in zip(cols, union):
        data = np.asarray(col.data)
        n = len(data)
        valid = _valid(col, n)
        if isinstance(col.dtype, T.VarcharType):
            pos = np.searchsorted(u, col.dictionary.astype("U"))
            parts = [pos[np.clip(data, 0, max(len(pos) - 1, 0))]
                     if len(pos) else np.zeros(n, np.int64)]
        elif data.ndim == 2:  # LONG decimal limbs
            parts = [data[:, 0], data[:, 1]]
        elif data.dtype.kind == "f":
            parts = [np.where(data == 0, 0.0, data)]
        else:
            parts = [data.astype(np.int64)]
        out.append((~valid).astype(np.int64))
        out.extend(np.where(valid, p, 0) if p.ndim == 1 else p
                   for p in parts)
    return out


def _string_union(cols_a: list[Column], cols_b: list[Column]) -> list:
    """Per key column, the sorted union of both tables' strings (None
    for a non-string key)."""
    out = []
    for a, b in zip(cols_a, cols_b):
        if not isinstance(a.dtype, T.VarcharType):
            out.append(None)
            continue
        out.append(np.unique(np.concatenate(
            [a.dictionary.astype("U"), b.dictionary.astype("U")])))
    return out


def _lexsort(columns: list[np.ndarray]) -> np.ndarray:
    """Stable lexicographic argsort, the first column most significant:
    successive stable sorts (least significant first) by torch's
    multi-threaded sort over the host arrays (numpy's lexsort takes
    ten times as long over 15M rows)."""
    perm = torch.arange(len(columns[0]))
    for c in reversed(columns):
        key = torch.from_numpy(np.ascontiguousarray(c))[perm]
        perm = perm[torch.sort(key, stable=True).indices]
    return perm.numpy()


def _group_ids(columns: list[np.ndarray], n: int) -> np.ndarray:
    """Dense ids of equal key tuples (0 when there is no key)."""
    if not columns:
        return np.zeros(n, np.int64)
    perm = _lexsort(columns)
    new = np.zeros(n, bool)
    if n:
        new[0] = True
    for c in columns:
        s = c[perm]
        new[1:] |= s[1:] != s[:-1]
    gid = np.empty(n, np.int64)
    gid[perm] = np.cumsum(new) - 1
    return gid


def _order_columns(col: Column, rows: np.ndarray, desc: bool) -> list:
    """Sort columns (least significant last) of an order key at
    ``rows``: the NULL class (NULLs last ascending, first descending,
    as ``(is None, k)`` sorted with ``reverse``), then the value
    (dictionary codes are in string order), negated for DESC."""
    data = np.asarray(col.data)[rows]
    null = ~_valid(col, len(np.asarray(col.data)))[rows]
    if data.ndim == 2:  # LONG decimal: signed high limb, unsigned low
        vals = [data[:, 1], data[:, 0].astype(np.uint64)]
    elif data.dtype.kind == "b":
        vals = [data.astype(np.int8)]
    else:
        vals = [data]
    cls = null.astype(np.int8)
    if desc:
        cls = -cls
        vals = [_reverse(v) for v in vals]
    return [cls] + [np.where(null, 0, v).astype(v.dtype) for v in vals]


def _reverse(v: np.ndarray) -> np.ndarray:
    """A column whose ascending order is ``v``'s descending order."""
    if v.dtype.kind == "f":
        return -v
    if v.dtype.kind == "u":
        return ~v
    return ~v.astype(np.int64)  # ~x = -x - 1: no overflow at the minimum


def _values(col: Column, rows: np.ndarray) -> np.ndarray:
    """The decoded values at ``rows`` as an object array of Python
    values (the reference's ``_decoded``), NULLs as None."""
    data = np.asarray(col.data)[rows]
    out = np.empty(len(rows), object)
    out[:] = np.asarray(_decode_column(col.dtype, data,
                                       col.dictionary)).tolist()
    if col.valid is not None:
        out[~np.asarray(col.valid, bool)[rows]] = None
    return out


def _first_occurrences(gid: np.ndarray, col: Column,
                       rows: np.ndarray) -> np.ndarray:
    """Mask of the entries (in their order) that are the first of their
    (group, value) pair: DISTINCT's de-duplication."""
    data = np.asarray(col.data)[rows]
    null = ~_valid(col, len(np.asarray(col.data)))[rows]
    keys = ([data[:, 0], data[:, 1]] if data.ndim == 2
            else [np.where(null, 0, data)])
    perm = _lexsort([gid, null] + keys)  # stable: positions in order
    new = np.zeros(len(rows), bool)
    if len(rows):
        new[0] = True
    for c in [gid, null] + keys:
        s = c[perm]
        new[1:] |= s[1:] != s[:-1]
    first = np.zeros(len(rows), bool)
    first[perm[new]] = True
    return first


def _assemble(call: A.AggCall, src: Table, syms: tuple, src_gid: np.ndarray,
              ngroups: int) -> list:
    """Each group's finished value (None where no row reached it)."""
    a_sym, a2_sym, o_sym = syms
    n = src.nrows
    rows = np.flatnonzero(_live(src))
    if call.mask is not None:  # FILTER (WHERE ...)
        m = src.columns[call.mask]
        keep = np.asarray(m.data, bool) & _valid(m, n)
        rows = rows[keep[rows]]
    arg = src.columns[a_sym]
    if call.fn == "map_agg" or call.fn == "listagg":
        # map_agg drops NULL keys, listagg NULL values; array_agg keeps
        rows = rows[_valid(arg, n)[rows]]
    gid = src_gid[rows]
    order = [gid]
    if o_sym is not None:
        order += _order_columns(src.columns[o_sym], rows, call.order_desc)
    perm = _lexsort(order)  # stable: ties keep input order
    rows, gid = rows[perm], gid[perm]
    if call.distinct and call.fn != "map_agg":
        keep = _first_occurrences(gid, arg, rows)
        rows, gid = rows[keep], gid[keep]
    vals = _values(arg, rows).tolist()
    keys = vals
    if call.fn == "map_agg":
        vals = _values(src.columns[a2_sym], rows).tolist()
    bounds = np.searchsorted(gid, np.arange(ngroups + 1))
    present = np.flatnonzero(bounds[1:] > bounds[:-1])
    out: list = [None] * ngroups
    sep = call.sep or ","
    # the one per-group loop: a slice of the sorted values each
    for g, lo, hi in zip(present.tolist(), bounds[present].tolist(),
                         bounds[present + 1].tolist()):
        if call.fn == "map_agg":
            out[g] = dict(zip(keys[lo:hi], vals[lo:hi]))
        elif call.fn == "listagg":
            out[g] = sep.join(map(str, vals[lo:hi]))
        else:
            out[g] = vals[lo:hi]
    return out


def _execute_varlen_carrier(engine, plan: N.PlanNode,
                            agg: N.Aggregate) -> Table:
    """General shape: materialize the varlen aggregate alone (host
    lists), then run the REST of the plan over it as a host-table
    carrier, whose padded 2-D arrays any downstream expression reads
    (cardinality, transform, UNNEST)."""
    from presto_tpu_torch.exec.executor import collect_scans, run_plan
    from presto_tpu_torch.exec.hostcarrier import carrier_scan
    from presto_tpu_torch.exec.streaming import _replace_node

    sub = N.Output(agg, list(agg.output_symbols), list(agg.output_symbols))
    table = execute_with_varlen(engine, sub, agg)
    node, scan = carrier_scan(engine, "__varlen__", table)
    rest = _replace_node(plan, agg, node)
    return run_plan(engine, rest, collect_scans(rest, engine,
                                                {node.table: scan}))


def execute_with_varlen(engine, plan: N.PlanNode,
                        agg: N.Aggregate) -> Table:
    from presto_tpu_torch.exec.executor import execute_part

    try:
        chain = _chain_to(plan, agg)
    except NotImplementedError:
        return _execute_varlen_carrier(engine, plan, agg)
    varlen = {s: c for s, c in agg.aggs.items() if c.fn in A.VARLEN_FNS}
    scalar = {s: c for s, c in agg.aggs.items()
              if c.fn not in A.VARLEN_FNS}

    # 1. the aggregation input on the device: group keys, varlen
    #    arguments, order keys and FILTER masks, fetched once
    need: dict[str, ir.Expr] = {}
    src_types = agg.source.output_types()
    for k in agg.group_keys:
        need[k] = ir.ColumnRef(src_types[k], k)
    arg_syms: dict[str, tuple] = {}
    for sym, call in varlen.items():
        a_sym = f"{sym}$arg"
        need[a_sym] = call.arg
        a2_sym = None
        if call.arg2 is not None:
            a2_sym = f"{sym}$arg2"
            need[a2_sym] = call.arg2
        o_sym = call.order_sym
        if o_sym is not None:
            need[o_sym] = ir.ColumnRef(src_types[o_sym], o_sym)
        if call.mask is not None:
            need[call.mask] = ir.ColumnRef(src_types[call.mask], call.mask)
        arg_syms[sym] = (a_sym, a2_sym, o_sym)
    src_plan = N.Output(N.Project(agg.source, need), list(need), list(need))
    src_table = execute_part(engine, src_plan)

    # 2. the scalar part on the device (a hidden count keeps the node
    #    non-empty)
    if not scalar:
        scalar = {"__vl_cnt": A.AggCall("count_star", None, T.BIGINT)}
    scalar_agg = dataclasses.replace(agg, aggs=scalar)
    scalar_plan = _strip_and_rebuild(chain, agg, scalar_agg,
                                     list(agg.group_keys))
    result = execute_part(engine, scalar_plan)

    # 3. one group id space over both tables' keys
    key_cols = [f"__vl_{k}" for k in agg.group_keys]
    if not all(c in result.columns for c in key_cols):
        key_cols = list(agg.group_keys)  # the chain was empty
    src_keys = [src_table.columns[k] for k in agg.group_keys]
    res_keys = [result.columns[c] for c in key_cols]
    union = _string_union(src_keys, res_keys)
    ns, nr = src_table.nrows, result.nrows
    joint = [np.concatenate([a, b]) for a, b in zip(
        _key_columns(src_keys, union), _key_columns(res_keys, union))]
    # a NULL flag column without a NULL sorts nothing
    joint = [c for c in joint if c.any()] or joint[:1]
    gid = _group_ids(joint, ns + nr)
    ngroups = int(gid.max()) + 1 if ns + nr else 0
    res_gid = gid[ns:]
    res_live = _live(result)

    # 4. each varlen column of the result, matched by group
    out_cols: dict[str, Column] = {}
    root = chain[0] if chain else plan
    if isinstance(root, N.Output):
        name_syms = list(zip(root.names, root.symbols))
    else:
        name_syms = [(s, s) for s in agg.group_keys + list(agg.aggs)]
    for name, sym in name_syms:
        if sym in varlen:
            call = varlen[sym]
            per_group = _assemble(call, src_table, arg_syms[sym], gid[:ns],
                                  ngroups)
            data = np.empty(nr, dtype=object)
            valid = np.zeros(nr, dtype=bool)
            rows = np.flatnonzero(res_live)
            for i, g in zip(rows.tolist(), res_gid[rows].tolist()):
                value = per_group[g]
                if value is not None:
                    data[i] = value
                    valid[i] = True
            out_cols[name] = Column(call.dtype, data, valid, None)
        elif name in result.columns:
            out_cols[name] = result.columns[name]
        else:  # the chain was empty: keyed by symbol
            out_cols[name] = result.columns[sym]
    return Table(out_cols, result.nrows, result.mask)
