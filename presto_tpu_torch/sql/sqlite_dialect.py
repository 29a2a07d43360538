"""AST -> sqlite SQL rendering for the correctness oracle.

The analog of the reference's H2 oracle flow
(testing/trino-testing/.../H2QueryRunner.java:90): every engine query is
re-rendered in the oracle's dialect so results can be cross-checked.
Differences handled: DATE literals become ISO strings (dates are stored
as TEXT in the oracle, lexicographic order == date order), interval
arithmetic uses sqlite's date() modifiers, EXTRACT becomes strftime.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch.sql import ast as A


def dataclasses_replace_spec(spec: A.QuerySpec, items) -> A.QuerySpec:
    return dataclasses.replace(spec, select_items=items)


def to_sqlite(node) -> str:
    if isinstance(node, A.QueryStatement):
        return _query(node.query)
    if isinstance(node, A.Query):
        return _query(node)
    raise NotImplementedError(f"to_sqlite: {type(node).__name__}")


def _query(q: A.Query) -> str:
    parts = []
    if q.with_queries:
        ws = []
        for w in q.with_queries:
            cols = f" ({', '.join(w.column_aliases)})" if w.column_aliases \
                else ""
            ws.append(f"{w.name}{cols} AS ({_query(w.query)})")
        parts.append("WITH " + ", ".join(ws))
    parts.append(_body(q.body))
    if q.order_by:
        parts.append("ORDER BY " + ", ".join(
            _sort_item(s) for s in q.order_by))
    if q.limit is not None:
        parts.append(f"LIMIT {q.limit}")
    if q.offset:
        parts.append(f"OFFSET {q.offset}")
    return " ".join(parts)


def _body(body: A.Relation) -> str:
    if isinstance(body, A.QuerySpec):
        return _spec(body)
    if isinstance(body, A.SetOperation):
        op = body.op.upper() + ("" if body.distinct else " ALL")
        return (f"{_setop_operand(body.left)} {op} "
                f"{_setop_operand(body.right)}")
    if isinstance(body, A.SubqueryRelation):
        return f"({_query(body.query)})"
    raise NotImplementedError(type(body).__name__)


def _setop_operand(body: A.Relation) -> str:
    """sqlite rejects parenthesized compound operands: unwrap plain
    subquery operands, wrap ordered/limited ones as SELECT * FROM."""
    if isinstance(body, A.SubqueryRelation):
        q = body.query
        if not q.order_by and q.limit is None and not q.offset \
                and not q.with_queries \
                and isinstance(q.body, A.QuerySpec):
            # unwrapping a COMPOUND body would re-associate the chain
            # under sqlite's left-associative equal-precedence set ops
            return _body(q.body)
        return f"SELECT * FROM ({_query(q)})"
    return _body(body)


def _skip_agg(e) -> bool:
    """Skip NON-window aggregate calls (window calls named like
    aggregates must still be descended for key substitution). The
    aggregate name set is the planner's — one source of truth."""
    from presto_tpu_torch.plan.planner import AGG_FUNCTIONS
    return (isinstance(e, A.FunctionCall) and e.name in AGG_FUNCTIONS
            and e.window is None)


def _alias(a: str) -> str:
    # always quoted: covers "30 days" (official q99) AND keyword
    # aliases like "order" that isidentifier() would wave through
    return '"' + a + '"'


def _spec_one(s: A.QuerySpec, group_exprs: list | None) -> str:
    items = ", ".join(
        (_expr(i.expression)
         + (f" AS {_alias(i.alias)}" if i.alias else ""))
        for i in s.select_items)
    out = "SELECT " + ("DISTINCT " if s.distinct else "") + items
    if s.from_relation is not None:
        out += " FROM " + _rel(s.from_relation)
    if s.where is not None:
        out += " WHERE " + _expr(s.where)
    if group_exprs:
        out += " GROUP BY " + ", ".join(_expr(g) for g in group_exprs)
    if s.having is not None:
        out += " HAVING " + _expr(s.having)
    return out


def _fold_plain_grouping(node):
    # plain GROUP BY: nothing is ever rolled away -> grouping() == 0
    # (sqlite has no grouping() at all; the engine folds it the same
    # way, plan/planner.py)
    if isinstance(node, A.FunctionCall) and node.name == "grouping":
        return A.NumericLiteral("0")
    return None


def _rel_alias(r: A.Relation) -> str | None:
    if isinstance(r, A.AliasedRelation):
        return r.alias
    if isinstance(r, A.TableRef):
        return r.parts[-1]
    return None


def _full_join_anti_key(on: A.Expression,
                        left_alias: str) -> A.Dereference | None:
    """A left-side equi-join key column out of the ON condition: in
    ``L LEFT JOIN R``'s flipped anti branch, that column is NULL
    exactly on the R rows with no L match (an equality never matches
    through NULL, so matched rows always carry a non-null key).

    Only top-level AND conjuncts qualify: an equality under OR/NOT
    is not implied by a match (``ON l.a = r.a OR l.b = r.b`` can
    match rows whose ``l.a`` is NULL, so anti-filtering on it would
    duplicate those rows)."""
    def conjuncts(e):
        if isinstance(e, A.LogicalOp) and e.op == "and":
            for t in e.terms:
                yield from conjuncts(t)
        else:
            yield e
    for node in conjuncts(on):
        if isinstance(node, A.BinaryOp) and node.op == "=":
            for side in (node.left, node.right):
                if isinstance(side, A.Dereference) \
                        and side.parts[0] == left_alias:
                    return side
    return None


def _walk_expr(e):
    import dataclasses as _dc
    if not _dc.is_dataclass(e) or isinstance(e, type):
        return
    yield e
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        for item in (v if isinstance(v, tuple) else (v,)):
            if _dc.is_dataclass(item) and not isinstance(item, type):
                yield from _walk_expr(item)


def _emulate_full_join(s: A.QuerySpec) -> A.QuerySpec | None:
    """Rewrite ``SELECT ... FROM L la FULL JOIN R ra ON cond ...``
    for sqlite builds without FULL OUTER JOIN support (< 3.39): the
    join becomes a derived table

        SELECT <refs> FROM L la LEFT JOIN R ra ON cond
        UNION ALL
        SELECT <refs> FROM R ra LEFT JOIN L la ON cond
        WHERE la.<key> IS NULL           -- anti-joined right rows

    exposing exactly the alias-qualified columns the outer SELECT /
    WHERE / GROUP BY reference (collected from the spec and renamed
    ``cN``), with those references rewritten to the derived columns.
    Aggregates, windows, and the original WHERE stay in the OUTER
    spec, so their semantics over the unioned rows are unchanged.
    Returns None when the shape doesn't apply (no full join, or no
    equi-key to anti-join on)."""
    import dataclasses as _dc
    from presto_tpu_torch.sql.grouping import rewrite_ast as _ra

    jr = s.from_relation
    if not isinstance(jr, A.JoinRelation) or jr.join_type != "full" \
            or jr.on is None:
        return None
    la, ra = _rel_alias(jr.left), _rel_alias(jr.right)
    if la is None or ra is None:
        return None
    anti = _full_join_anti_key(jr.on, la)
    if anti is None:
        return None

    # every alias-qualified column the spec references (select items,
    # where, group by, having — sub-queries included: a correlated
    # reference to the join's columns must resolve against the derived
    # table too)
    refs: dict[A.Expression, str] = {}

    def collect(node):
        if isinstance(node, A.Dereference) and node.parts[0] in (la,
                                                                 ra):
            refs.setdefault(node, f"c{len(refs)}")
        return None

    for item in s.select_items:
        _ra(item.expression, collect)
    if s.where is not None:
        _ra(s.where, collect)
    for g in s.group_by:
        for e in g.expressions:
            _ra(e, collect)
    if s.having is not None:
        _ra(s.having, collect)
    if not refs:
        return None
    refs.setdefault(anti, f"c{len(refs)}")

    items = tuple(A.SelectItem(e, name) for e, name in refs.items())
    b1 = A.QuerySpec(select_items=items,
                     from_relation=A.JoinRelation(
                         "left", jr.left, jr.right, on=jr.on))
    b2 = A.QuerySpec(select_items=items,
                     from_relation=A.JoinRelation(
                         "left", jr.right, jr.left, on=jr.on),
                     where=A.IsNullPredicate(anti, negated=False))
    union = A.SetOperation("union", distinct=False, left=b1, right=b2)
    derived = A.AliasedRelation(
        A.SubqueryRelation(A.Query(union)), "__full_join__")

    def substitute(node):
        name = refs.get(node)
        return A.Identifier(name) if name is not None else None

    new_items = tuple(
        A.SelectItem(_ra(i.expression, substitute), i.alias)
        for i in s.select_items)
    new_where = (_ra(s.where, substitute)
                 if s.where is not None else None)
    new_group = tuple(
        _dc.replace(g, expressions=tuple(
            _ra(e, substitute) for e in g.expressions))
        for g in s.group_by)
    new_having = (_ra(s.having, substitute)
                  if s.having is not None else None)
    return _dc.replace(s, select_items=new_items,
                       from_relation=derived, where=new_where,
                       group_by=new_group, having=new_having)


def _spec(s: A.QuerySpec) -> str:
    import sqlite3

    import dataclasses as _dc
    from presto_tpu_torch.sql.grouping import (expand_grouping_sets,
                                         resolve_ordinal, rewrite_ast)
    if sqlite3.sqlite_version_info < (3, 39):
        # host sqlite predates native FULL/RIGHT OUTER JOIN: emulate
        rewritten = _emulate_full_join(s)
        if rewritten is not None:
            s = rewritten
    gsets = expand_grouping_sets(s)
    if gsets is None:
        if s.group_by:
            items = tuple(
                A.SelectItem(rewrite_ast(i.expression,
                                         _fold_plain_grouping,
                                         _skip_agg), i.alias)
                for i in s.select_items)
            having = (rewrite_ast(s.having, _fold_plain_grouping,
                                  _skip_agg)
                      if s.having is not None else None)
            s = _dc.replace(s, select_items=items, having=having)
        return _spec_one(s, [resolve_ordinal(e, s) for g in s.group_by
                             for e in g.expressions])
    # sqlite has no ROLLUP/CUBE: emulate with a UNION ALL of one plain
    # GROUP BY per expanded grouping set, substituting NULL for
    # rolled-away keys and constant-folding grouping() per set (the
    # expansion is SHARED with the engine planner, sql/grouping.py)
    all_exprs = []
    for gset in gsets:
        for e in gset:
            if e not in all_exprs:
                all_exprs.append(e)
    parts = []
    for gset in gsets:
        def sub(node, _gset=gset):
            if (isinstance(node, A.FunctionCall)
                    and node.name == "grouping"):
                bits = 0
                for a in node.args:
                    bits = (bits << 1) | (0 if a in _gset else 1)
                return A.NumericLiteral(str(bits))
            if node in all_exprs and node not in _gset:
                return A.NullLiteral()
            return None

        from presto_tpu_torch.sql.grouping import rewrite_ast as _ra
        items = tuple(
            A.SelectItem(_ra(i.expression, sub, _skip_agg), i.alias)
            for i in s.select_items)
        having = (_ra(s.having, sub, _skip_agg)
                  if s.having is not None else None)
        import dataclasses as _dc
        variant = _dc.replace(s, select_items=items, having=having,
                              group_by=())
        parts.append(_spec_one(variant, gset))
    # KNOWN LIMIT: window functions evaluate PER BRANCH here; that is
    # only correct when every window partition includes the grouping-
    # distinguishing keys/bits (true of the rollup+rank TPC-DS shapes,
    # q36/q70/q86) — windows spanning grouping sets would need the
    # union materialized first.
    # wrapped as a subquery: a bare A UNION ALL B would mis-associate
    # when this spec is itself an operand of INTERSECT/EXCEPT (sqlite
    # set ops are left-associative with equal precedence)
    return "SELECT * FROM (" + " UNION ALL ".join(parts) + ")"


def _rel(r: A.Relation) -> str:
    if isinstance(r, A.TableRef):
        return r.parts[-1]
    if isinstance(r, A.AliasedRelation):
        if r.column_aliases and isinstance(r.relation, A.SubqueryRelation):
            # sqlite lacks AS alias(col, ...): inject aliases into the
            # subquery's select items instead
            q = r.relation.query
            if isinstance(q.body, A.QuerySpec) and not q.with_queries:
                items = tuple(
                    A.SelectItem(i.expression,
                                 r.column_aliases[idx]
                                 if idx < len(r.column_aliases)
                                 else i.alias)
                    for idx, i in enumerate(q.body.select_items))
                body = dataclasses_replace_spec(q.body, items)
                q = A.Query(body, q.with_queries, q.order_by, q.limit,
                            q.offset)
                return f"({_query(q)}) AS {r.alias}"
        cols = f" ({', '.join(r.column_aliases)})" if r.column_aliases \
            else ""
        return f"{_rel(r.relation)} AS {r.alias}{cols}"
    if isinstance(r, A.SubqueryRelation):
        return f"({_query(r.query)})"
    if isinstance(r, A.JoinRelation):
        if r.join_type == "implicit":
            return f"{_rel(r.left)}, {_rel(r.right)}"
        if r.join_type == "cross":
            return f"{_rel(r.left)} CROSS JOIN {_rel(r.right)}"
        jt = {"inner": "JOIN", "left": "LEFT JOIN",
              "right": "RIGHT JOIN", "full": "FULL JOIN"}[r.join_type]
        out = f"{_rel(r.left)} {jt} {_rel(r.right)}"
        if r.on is not None:
            out += f" ON {_expr(r.on)}"
        elif r.using:
            out += f" USING ({', '.join(r.using)})"
        return out
    if isinstance(r, A.ValuesRelation):
        rows = ", ".join(
            "(" + ", ".join(_expr(e) for e in row) + ")"
            for row in r.rows)
        return f"(VALUES {rows})"
    raise NotImplementedError(type(r).__name__)


def _sort_item(s: A.SortItem) -> str:
    out = _expr(s.expression)
    out += " ASC" if s.ascending else " DESC"
    nulls_first = s.nulls_first
    if nulls_first is None:
        # engine default matches the reference: NULLS LAST in ASC,
        # NULLS FIRST in DESC; sqlite defaults the opposite way, so
        # always render explicitly
        nulls_first = not s.ascending
    out += " NULLS FIRST" if nulls_first else " NULLS LAST"
    return out


def _canon_timestamp_text(v: str) -> str:
    """'YYYY-MM-DD HH:MM:SS[.ffffff]' canonical text of a timestamp
    literal body (what sqlite datetime() emits; fraction kept only when
    nonzero). Must match testing/oracle.normalize_value's rendering of
    engine datetime64[us] values."""
    s = str(v).strip().replace("T", " ")
    date_part, _, time_part = s.partition(" ")
    if not time_part:
        time_part = "00:00:00"
    hms, _, frac = time_part.partition(".")
    if hms.count(":") == 1:
        hms += ":00"
    frac = frac.rstrip("0")
    out = f"{date_part} {hms}"
    return f"{out}.{frac}" if frac else out


def _is_timestampish(e: A.Expression) -> bool:
    """Best-effort: does this expression produce a timestamp (so
    interval arithmetic must keep sqlite's datetime() rendering)?"""
    if isinstance(e, A.TypedLiteral):
        return e.type_name == "timestamp"
    if isinstance(e, A.FunctionCall):
        return e.name in ("from_unixtime", "now", "current_timestamp",
                          "localtimestamp")
    if isinstance(e, A.CastExpression):
        return e.type_name.lower() == "timestamp"
    return False


_UNIT_SQLITE = {"year": "years", "month": "months", "day": "days",
                "week": "days"}


def _expr(e: A.Expression) -> str:
    if isinstance(e, A.Identifier):
        return e.name
    if isinstance(e, A.Dereference):
        return ".".join(e.parts)
    if isinstance(e, A.NumericLiteral):
        return e.text
    if isinstance(e, A.StringLiteral):
        v = e.value.replace("'", "''")
        return f"'{v}'"
    if isinstance(e, A.BooleanLiteral):
        return "1" if e.value else "0"
    if isinstance(e, A.NullLiteral):
        return "NULL"
    if isinstance(e, A.TypedLiteral):
        if e.type_name == "date":
            return f"'{e.value[:10]}'"
        if e.type_name == "timestamp":
            # canonical 'YYYY-MM-DD HH:MM:SS[.ffffff]' text (sqlite
            # datetime functions and lexicographic order both work)
            v = _canon_timestamp_text(e.value)
            return f"'{v}'"
        if e.type_name == "time":
            return f"'{e.value}'"
        return e.value
    if isinstance(e, A.BinaryOp):
        # date/timestamp +- interval -> sqlite date()/datetime() modifier
        for a, b, sign in ((e.left, e.right, ""), (e.right, e.left, "")):
            if isinstance(b, A.IntervalLiteral) and e.op in ("+", "-"):
                from presto_tpu_torch.plan.planner import _interval_value
                from presto_tpu_torch import types as _T
                itype, ival = _interval_value(b)
                if e.op == "-":
                    ival = -ival
                if itype is _T.INTERVAL_YEAR_MONTH:
                    fn = ("datetime" if _is_timestampish(a) else "date")
                    return f"{fn}({_expr(a)}, '{ival:+d} months')"
                if ival % 86_400_000_000 == 0 \
                        and not _is_timestampish(a):
                    days = ival // 86_400_000_000
                    return f"date({_expr(a)}, '{days:+d} days')"
                secs = ival / 1_000_000
                return f"datetime({_expr(a)}, '{secs:+g} seconds')"
        return f"({_expr(e.left)} {e.op} {_expr(e.right)})"
    if isinstance(e, A.UnaryOp):
        return f"({e.op}{_expr(e.operand)})"
    if isinstance(e, A.LogicalOp):
        return "(" + f" {e.op.upper()} ".join(
            _expr(t) for t in e.terms) + ")"
    if isinstance(e, A.NotOp):
        return f"(NOT {_expr(e.operand)})"
    if isinstance(e, A.IsNullPredicate):
        n = " NOT" if e.negated else ""
        return f"({_expr(e.operand)} IS{n} NULL)"
    if isinstance(e, A.BetweenPredicate):
        n = "NOT " if e.negated else ""
        return (f"({_expr(e.operand)} {n}BETWEEN {_expr(e.low)} "
                f"AND {_expr(e.high)})")
    if isinstance(e, A.InListPredicate):
        n = "NOT " if e.negated else ""
        vals = ", ".join(_expr(v) for v in e.values)
        return f"({_expr(e.operand)} {n}IN ({vals}))"
    if isinstance(e, A.InSubquery):
        n = "NOT " if e.negated else ""
        return f"({_expr(e.operand)} {n}IN ({_query(e.query)}))"
    if isinstance(e, A.ExistsPredicate):
        n = "NOT " if e.negated else ""
        return f"({n}EXISTS ({_query(e.query)}))"
    if isinstance(e, A.ScalarSubquery):
        return f"({_query(e.query)})"
    if isinstance(e, A.LikePredicate):
        n = "NOT " if e.negated else ""
        out = f"({_expr(e.operand)} {n}LIKE {_expr(e.pattern)}"
        if e.escape is not None:
            out += f" ESCAPE {_expr(e.escape)}"
        return out + ")"
    if isinstance(e, A.FunctionCall):
        d = "DISTINCT " if e.distinct else ""
        if e.name == "concat" and not e.is_star:
            # sqlite spells string concatenation ||
            return "(" + " || ".join(_expr(a) for a in e.args) + ")"
        if e.name in ("year", "month", "day", "hour", "minute",
                      "second", "day_of_year", "doy") and e.args:
            fmt = {"year": "%Y", "month": "%m", "day": "%d",
                   "hour": "%H", "minute": "%M", "second": "%S",
                   "day_of_year": "%j", "doy": "%j"}[e.name]
            return (f"CAST(strftime('{fmt}', {_expr(e.args[0])}) "
                    "AS INTEGER)")
        if e.name == "date_trunc" and len(e.args) == 2 \
                and isinstance(e.args[0], A.StringLiteral):
            unit = e.args[0].value.lower()
            x = _expr(e.args[1])
            ts = _is_timestampish(e.args[1])
            if unit in ("year", "month"):
                out = f"date({x}, 'start of {unit}')"
            elif unit == "quarter":
                out = (f"date({x}, 'start of year', '+' || "
                       f"(((CAST(strftime('%m', {x}) AS INTEGER) - 1) "
                       f"/ 3) * 3) || ' months')")
            elif unit == "week":
                out = f"date({x}, '+1 day', 'weekday 1', '-7 days')"
            elif unit == "day":
                out = f"date({x})"
            elif unit in ("hour", "minute"):
                fmt = ("%Y-%m-%d %H:00:00" if unit == "hour"
                       else "%Y-%m-%d %H:%M:00")
                return f"strftime('{fmt}', {x})"
            elif unit == "second":
                return f"strftime('%Y-%m-%d %H:%M:%S', {x})"
            else:
                out = f"date({x})"
            if ts and unit in ("year", "quarter", "month", "week",
                               "day"):
                return f"(({out}) || ' 00:00:00')"
            return out
        if e.name == "date_add" and len(e.args) == 3 \
                and isinstance(e.args[0], A.StringLiteral):
            unit = e.args[0].value.lower().rstrip("s")
            n, x = _expr(e.args[1]), _expr(e.args[2])
            fn = ("datetime"
                  if _is_timestampish(e.args[2])
                  or unit in ("hour", "minute", "second",
                              "millisecond") else "date")
            # sqlite modifiers know only days/months/years/hours/
            # minutes/seconds: rescale the units it lacks
            if unit == "week":
                return f"{fn}({x}, (({n}) * 7) || ' days')"
            if unit == "quarter":
                return f"{fn}({x}, (({n}) * 3) || ' months')"
            if unit == "millisecond":
                return f"{fn}({x}, (({n}) / 1000.0) || ' seconds')"
            return f"{fn}({x}, ({n}) || ' {unit}s')"
        if e.name == "date_diff" and len(e.args) == 3 \
                and isinstance(e.args[0], A.StringLiteral):
            unit = e.args[0].value.lower().rstrip("s")
            a, b = _expr(e.args[1]), _expr(e.args[2])
            if unit in ("year", "quarter", "month"):
                months = (f"((CAST(strftime('%Y', {b}) AS INTEGER) - "
                          f"CAST(strftime('%Y', {a}) AS INTEGER)) * 12 "
                          f"+ CAST(strftime('%m', {b}) AS INTEGER) - "
                          f"CAST(strftime('%m', {a}) AS INTEGER))")
                div = {"year": 12, "quarter": 3, "month": 1}[unit]
                return f"({months} / {div})" if div > 1 else months
            secs = {"second": 1, "minute": 60, "hour": 3600,
                    "day": 86400, "week": 604800}[unit]
            return (f"CAST((strftime('%s', {b}) - strftime('%s', {a}))"
                    f" / {secs} AS INTEGER)")
        if e.name == "from_unixtime" and len(e.args) == 1:
            return f"datetime({_expr(e.args[0])}, 'unixepoch')"
        if e.name == "to_unixtime" and len(e.args) == 1:
            return f"CAST(strftime('%s', {_expr(e.args[0])}) AS REAL)"
        args = "*" if e.is_star else ", ".join(_expr(a) for a in e.args)
        name = {"substring": "substr", "arbitrary": "max"}.get(
            e.name, e.name)
        out = f"{name}({d}{args})"
        if e.window is not None:
            w = e.window
            parts = []
            if w.partition_by:
                parts.append("PARTITION BY " + ", ".join(
                    _expr(p) for p in w.partition_by))
            if w.order_by:
                parts.append("ORDER BY " + ", ".join(
                    _sort_item(s) for s in w.order_by))
            if w.frame is not None:
                unit = w.frame.unit.upper()

                def bound(btype, bvalue):
                    fixed = {
                        "unbounded_preceding": "UNBOUNDED PRECEDING",
                        "unbounded_following": "UNBOUNDED FOLLOWING",
                        "current": "CURRENT ROW",
                        "preceding": f"{_expr(bvalue)} PRECEDING"
                        if bvalue is not None else "PRECEDING",
                        "following": f"{_expr(bvalue)} FOLLOWING"
                        if bvalue is not None else "FOLLOWING",
                    }
                    return fixed[btype]

                s = bound(w.frame.start_type, w.frame.start_value)
                if w.frame.end_type is not None:
                    t = bound(w.frame.end_type, w.frame.end_value)
                    parts.append(f"{unit} BETWEEN {s} AND {t}")
                else:
                    parts.append(f"{unit} {s}")
            out += f" OVER ({' '.join(parts)})"
        return out
    if isinstance(e, A.CastExpression):
        t = e.type_name.lower()
        if t.startswith("decimal") or t in ("double", "real", "float"):
            st = "REAL"
        elif t.startswith(("varchar", "char")):
            st = "TEXT"
        elif t == "date":
            st = "TEXT"
        else:
            st = "INTEGER"
        return f"CAST({_expr(e.operand)} AS {st})"
    if isinstance(e, A.CaseExpression):
        parts = ["CASE"]
        for c, r in e.whens:
            parts.append(f"WHEN {_expr(c)} THEN {_expr(r)}")
        if e.default is not None:
            parts.append(f"ELSE {_expr(e.default)}")
        parts.append("END")
        return "(" + " ".join(parts) + ")"
    if isinstance(e, A.Extract):
        fmt = {"year": "%Y", "month": "%m", "day": "%d", "hour": "%H",
               "minute": "%M", "second": "%S", "day_of_year": "%j",
               "doy": "%j"}[e.field]
        return f"CAST(strftime('{fmt}', {_expr(e.operand)}) AS INTEGER)"
    if isinstance(e, A.Star):
        return f"{e.qualifier}.*" if e.qualifier else "*"
    raise NotImplementedError(f"to_sqlite expr: {type(e).__name__}")
