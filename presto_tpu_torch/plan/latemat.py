"""Late materialization of FD-dependent group keys.

A star-schema aggregate often groups by a fact-side key PLUS dimension
attributes the key determines (TPC-H Q3: ``GROUP BY l_orderkey,
o_orderdate, o_shippriority`` — the orderkey determines the other two
through the unique join on ``o_orderkey``). The FD-reduction pass
(plan/dense.py) already stops hashing the dependents, but they still
ride the ENTIRE pipeline at probe width: a 60M-row gather per dependent
column inside the join program costs ~1.5s of random HBM traffic on
v5e, only for the values to be thrown away by compaction down to the
group count.

This pass instead drops such dependents from the aggregate entirely and
re-joins them AFTER grouping against a fresh scan of their base table —
at output-capacity width (1M-row gathers, ~10ms). The reference has no
direct analog (row-at-a-time paging makes column width a non-issue
there); the closest relatives are late-materialization designs in
column stores and Trino-class optimizers' redundant-join elimination
run in reverse.

Correctness rests on:
- the determinant symbol's PROVENANCE: its value IS the base table's
  single-column unique key, established through chains of INNER
  unique-build single-criterion joins (`fd_provenance`). A LEFT join
  link would fill NULL dependents of unmatched rows with base values,
  so only pass-through (not new provenance) crosses LEFT joins.
- the re-join being LEFT + build_unique on a unique scan key: every
  surviving group's determinant exists in the base table (it came from
  an INNER join against it), NULL determinants (possible through
  pass-through provenance) produce NULL dependents, and cardinality is
  preserved.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import ir
from presto_tpu_torch.plan import nodes as N


@dataclasses.dataclass(frozen=True)
class _Prov:
    """Symbol provenance: the symbol's value is ``catalog.table``'s
    unique key column ``pk_col``; ``deps`` maps dependent output
    symbols to their base-table column names."""

    catalog: str
    table: str
    pk_col: str
    deps: dict  # dep symbol -> base column name


def fd_provenance(node: N.PlanNode, engine) -> dict[str, _Prov]:
    if isinstance(node, N.TableScan):
        conn = engine.catalogs.get(node.catalog)
        if conn is None or node.catalog == "__segment__":
            return {}
        try:
            keys = conn.unique_keys(node.table)
        except (AttributeError, KeyError, NotImplementedError):
            return {}
        by_col = {c: s for s, c in node.assignments.items()}
        out = {}
        for key in keys:
            if len(key) == 1 and key[0] in by_col:
                pk_sym = by_col[key[0]]
                out[pk_sym] = _Prov(
                    node.catalog, node.table, key[0],
                    {s: c for s, c in node.assignments.items()
                     if s != pk_sym})
        return out
    if isinstance(node, (N.Filter, N.Sort, N.TopN, N.Limit,
                         N.Exchange, N.MarkDistinct, N.Window)):
        return fd_provenance(node.sources()[0], engine)
    if isinstance(node, N.SemiJoin):
        return fd_provenance(node.source, engine)
    if isinstance(node, N.Project):
        src = fd_provenance(node.source, engine)
        fwd: dict[str, list] = {}
        for sym, expr in node.assignments.items():
            if isinstance(expr, ir.ColumnRef):
                fwd.setdefault(expr.name, []).append(sym)
        out = {}
        for det, prov in src.items():
            for dsym in fwd.get(det, []):
                deps = {}
                for dep, col in prov.deps.items():
                    for fsym in fwd.get(dep, []):
                        deps[fsym] = col
                out[dsym] = dataclasses.replace(prov, deps=deps)
        return out
    if isinstance(node, N.Join):
        out = dict(fd_provenance(node.left, engine))
        right = fd_provenance(node.right, engine)
        out.update(right)
        if node.join_type == N.JoinType.INNER and node.build_unique \
                and len(node.criteria) == 1:
            lk, rk = node.criteria[0]
            if rk in right and lk not in out:
                out[lk] = right[rk]
        return out
    if isinstance(node, N.MultiJoin):
        # same provenance algebra as the INNER unique-build cascade
        # the fused chain replaced
        out = dict(fd_provenance(node.spine, engine))
        for build, crit in zip(node.builds, node.criteria):
            right = fd_provenance(build, engine)
            out.update(right)
            if len(crit) == 1:
                lk, rk = crit[0]
                if rk in right and lk not in out:
                    out[lk] = right[rk]
        return out
    return {}


def _scan_types(engine, catalog: str, table: str):
    conn = engine.catalogs.get(catalog)
    if conn is None:
        return None
    try:
        return conn.table_schema(table)
    except Exception:
        return None


def late_materialize(plan: N.PlanNode, engine) -> N.PlanNode:
    """Rewrite grouped aggregates bottom-up (see module docstring)."""
    # symbol ids are PER PLAN, counted deterministically, so repeated
    # plans of the same SQL produce identical symbol names — the
    # compiled-program cache keys on the plan fingerprint, which
    # includes symbols (plan/fingerprint.py)
    ids = iter(range(1 << 30))

    def rewrite(node: N.PlanNode) -> N.PlanNode:
        if isinstance(node, N.Aggregate):
            rewritten = _rewrite_aggregate(node, engine, ids)
            if rewritten is not None:
                return rewritten
        return node

    return N.rewrite_bottom_up(plan, rewrite)


def _rewrite_aggregate(node: N.Aggregate, engine, ids):
    if node.step != N.AggStep.SINGLE or not node.fd_keys \
            or not (set(node.fd_keys) < set(node.group_keys)):
        return None
    prov = fd_provenance(node.source, engine)
    # claim dependent group keys per (determinant, base table)
    claims: dict[tuple, list] = {}
    claimed: set = set()
    for det in node.fd_keys:
        p = prov.get(det)
        if p is None:
            continue
        for d in node.group_keys:
            if d in claimed or d == det or d in node.fd_keys:
                continue
            col = p.deps.get(d)
            if col is not None:
                claims.setdefault((det, p.catalog, p.table, p.pk_col),
                                  []).append((d, col))
                claimed.add(d)
    if not claims:
        return None
    new_group = [k for k in node.group_keys if k not in claimed]
    fd_keys = (None if list(node.fd_keys) == new_group
               else list(node.fd_keys))
    cur: N.PlanNode = dataclasses.replace(
        node, group_keys=new_group, fd_keys=fd_keys)
    restored: dict[str, ir.Expr] = {}
    for (det, catalog, table, pk_col), deps in claims.items():
        schema = _scan_types(engine, catalog, table)
        if schema is None or pk_col not in schema \
                or any(c not in schema for _, c in deps):
            # base table unreadable: leave these keys in the aggregate
            return None
        uid = next(ids)
        pk_sym = f"{pk_col}__lm{uid}"
        assignments = {pk_sym: pk_col}
        types = {pk_sym: schema[pk_col]}
        for d, c in deps:
            dsym = f"{c}__lm{uid}"
            assignments[dsym] = c
            types[dsym] = schema[c]
            restored[d] = ir.ColumnRef(schema[c], dsym)
        scan = N.TableScan(catalog, table, assignments, types)
        cur = N.Join(cur, scan, N.JoinType.LEFT,
                     [(det, pk_sym)], build_unique=True)
    # restore the aggregate's original output symbols (parents
    # reference dependents by name)
    out_types = cur.output_types()
    assigns: dict[str, ir.Expr] = {}
    for sym in node.output_symbols:
        assigns[sym] = restored.get(
            sym, ir.ColumnRef(out_types.get(sym, T.BIGINT), sym))
    return N.Project(cur, assigns)
