"""Recursive-descent SQL parser.

The analog of the reference's generated parser + AstBuilder
(core/trino-parser/.../SqlParser.java:45, AstBuilder.java:1), hand-written
for the supported grammar subset. Expression precedence (low to high):
OR, AND, NOT, predicate (comparison/BETWEEN/IN/LIKE/IS), additive (+ - ||),
multiplicative (* / %), unary, primary — matching SqlBase.g4's booleanExpression/
valueExpression hierarchy.
"""

from __future__ import annotations

from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.sql.lexer import SqlSyntaxError, Token, tokenize

_RESERVED_STOP = {
    "from", "where", "group", "having", "order", "limit", "offset", "union",
    "intersect", "except", "on", "using", "join", "inner", "left", "right",
    "full", "cross", "when", "then", "else", "end", "and", "or", "not",
    "as", "by", "asc", "desc", "nulls", "first", "last", "with", "select",
    "distinct", "all", "between", "in", "like", "is", "exists", "case",
    "escape", "fetch", "match_recognize",
}


def parse_statement(sql: str) -> A.Statement:
    return Parser(tokenize(sql), text=sql).parse_statement()


def parse_expression(sql: str) -> A.Expression:
    p = Parser(tokenize(sql))
    e = p.expression()
    p.expect_eof()
    return e


class Parser:
    def __init__(self, tokens: list[Token], text: str | None = None):
        self.tokens = tokens
        self.i = 0
        # original SQL text when available: PREPARE stores the
        # prepared statement verbatim (token positions slice it)
        self.text = text

    # -- token helpers ------------------------------------------------------

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def at_keyword(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value in words

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def advance(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_keyword(self, word: str) -> None:
        if not self.accept_keyword(word):
            t = self.peek()
            raise SqlSyntaxError(
                f"expected {word.upper()} at position {t.pos}, "
                f"found {t.value!r}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise SqlSyntaxError(
                f"expected {op!r} at position {t.pos}, found {t.value!r}")

    def expect_eof(self) -> None:
        self.accept_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise SqlSyntaxError(
                f"unexpected trailing input at position {t.pos}: {t.value!r}")

    def identifier(self) -> str:
        t = self.peek()
        if t.kind == "qident":
            self.advance()
            return t.value
        if t.kind == "ident":
            self.advance()
            return t.value
        raise SqlSyntaxError(
            f"expected identifier at position {t.pos}, found {t.value!r}")

    def qualified_name(self) -> tuple[str, ...]:
        parts = [self.identifier()]
        while self.at_op(".") and self.peek(1).kind in ("ident", "qident"):
            self.advance()
            parts.append(self.identifier())
        return tuple(parts)

    # -- statements ---------------------------------------------------------

    def parse_statement(self) -> A.Statement:
        t = self.peek()
        if t.kind == "ident":
            if t.value == "explain":
                self.advance()
                analyze = self.accept_keyword("analyze")
                fmt = "text"
                if self.accept_op("("):
                    while not self.accept_op(")"):
                        if self.accept_keyword("format"):
                            fmt = self.identifier().lower()
                        else:
                            self.advance()
                        self.accept_op(",")
                stmt = self.parse_statement()
                return A.ExplainStatement(stmt, analyze, fmt)
            if t.value == "show":
                return self._show_statement()
            if t.value in ("describe", "desc"):
                # DESCRIBE t == SHOW COLUMNS FROM t (the reference
                # desugars it in sql/rewrite/DescribeInputRewrite-land)
                self.advance()
                table = self.qualified_name()
                self.expect_eof()
                return A.ShowColumns(table)
            if t.value in ("start", "begin"):
                self.advance()
                if t.value == "start":
                    self.expect_keyword("transaction")
                self.expect_eof()
                return A.StartTransaction()
            if t.value == "commit":
                self.advance()
                self.expect_eof()
                return A.CommitStatement()
            if t.value == "rollback":
                self.advance()
                self.expect_eof()
                return A.RollbackStatement()
            if t.value == "set":
                self.advance()
                self.expect_keyword("session")
                name = ".".join(self.qualified_name())
                self.expect_op("=")
                value = self.expression()
                self.expect_eof()
                return A.SetSession(name, value)
            if t.value == "create":
                self.advance()
                self.expect_keyword("table")
                table = self.qualified_name()
                self.expect_keyword("as")
                q = self.query()
                self.expect_eof()
                return A.CreateTableAs(table, q)
            if t.value == "insert":
                self.advance()
                self.expect_keyword("into")
                table = self.qualified_name()
                columns: tuple[str, ...] = ()
                if self.at_op("(") and self._looks_like_column_list():
                    self.advance()
                    names = [self.identifier()]
                    while self.accept_op(","):
                        names.append(self.identifier())
                    self.expect_op(")")
                    columns = tuple(names)
                q = self.query()
                self.expect_eof()
                return A.InsertStatement(table, columns, q)
            if t.value == "delete":
                self.advance()
                self.expect_keyword("from")
                table = self.qualified_name()
                where = None
                if self.accept_keyword("where"):
                    where = self.expression()
                self.expect_eof()
                return A.DeleteStatement(table, where)
            if t.value == "update":
                self.advance()
                table = self.qualified_name()
                self.expect_keyword("set")
                assigns = []
                while True:
                    col = self.identifier()
                    self.expect_op("=")
                    assigns.append((col, self.expression()))
                    if not self.accept_op(","):
                        break
                where = None
                if self.accept_keyword("where"):
                    where = self.expression()
                self.expect_eof()
                return A.UpdateStatement(table, tuple(assigns), where)
            if t.value == "prepare":
                # PREPARE name FROM <statement> (with ? markers;
                # validated for syntax here, planned at EXECUTE —
                # reference sql/tree/Prepare semantics)
                self.advance()
                name = self.identifier()
                self.expect_keyword("from")
                start = self.peek().pos
                if self.peek().kind == "eof":
                    raise SqlSyntaxError(
                        f"empty prepared statement at position {start}")
                self.parse_statement()  # syntax check; consumes to EOF
                sql = (self.text[start:] if self.text is not None
                       else "").strip().rstrip(";").strip()
                return A.Prepare(name, sql)
            if t.value == "execute":
                self.advance()
                name = self.identifier()
                params: tuple[A.Expression, ...] = ()
                if self.accept_keyword("using"):
                    exprs = [self.expression()]
                    while self.accept_op(","):
                        exprs.append(self.expression())
                    params = tuple(exprs)
                self.expect_eof()
                return A.ExecutePrepared(name, params)
            if t.value == "deallocate":
                self.advance()
                self.accept_keyword("prepare")
                name = self.identifier()
                self.expect_eof()
                return A.Deallocate(name)
            if t.value == "drop":
                self.advance()
                self.expect_keyword("table")
                if_exists = False
                if self.accept_keyword("if"):
                    self.expect_keyword("exists")
                    if_exists = True
                table = self.qualified_name()
                self.expect_eof()
                return A.DropTable(table, if_exists)
        q = self.query()
        self.expect_eof()
        return A.QueryStatement(q)

    def _looks_like_column_list(self) -> bool:
        # INSERT INTO t (a, b) SELECT... vs INSERT INTO t (SELECT ...)
        return not (self.peek(1).kind == "ident" and
                    self.peek(1).value in ("select", "with", "values"))

    def _show_statement(self) -> A.Statement:
        self.advance()  # show
        if self.accept_keyword("tables"):
            catalog = None
            if self.accept_keyword("from", "in"):
                catalog = self.identifier()
            self.expect_eof()
            return A.ShowTables(catalog)
        if self.accept_keyword("columns"):
            self.expect_keyword("from")
            table = self.qualified_name()
            self.expect_eof()
            return A.ShowColumns(table)
        if self.accept_keyword("catalogs"):
            self.expect_eof()
            return A.ShowCatalogs()
        if self.accept_keyword("session"):
            self.expect_eof()
            return A.ShowSession()
        t = self.peek()
        raise SqlSyntaxError(f"unsupported SHOW at position {t.pos}")

    # -- queries ------------------------------------------------------------

    def query(self) -> A.Query:
        withs: list[A.WithQuery] = []
        if self.accept_keyword("with"):
            while True:
                name = self.identifier()
                aliases: tuple[str, ...] = ()
                if self.accept_op("("):
                    cols = [self.identifier()]
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                    aliases = tuple(cols)
                self.expect_keyword("as")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                withs.append(A.WithQuery(name, q, aliases))
                if not self.accept_op(","):
                    break
        body = self._set_operation()
        order_by: tuple[A.SortItem, ...] = ()
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            order_by = self._sort_items()
        limit = None
        offset = 0
        if self.accept_keyword("offset"):
            offset = int(self.advance().value)
            self.accept_keyword("rows", "row")
        if self.accept_keyword("limit"):
            if self.accept_keyword("all"):
                limit = None
            else:
                limit = int(self.advance().value)
        elif self.accept_keyword("fetch"):
            self.accept_keyword("first", "next")
            limit = int(self.advance().value)
            self.accept_keyword("rows", "row")
            self.accept_keyword("only")
        return A.Query(body, tuple(withs), order_by, limit, offset)

    def _sort_items(self) -> tuple[A.SortItem, ...]:
        items = []
        while True:
            e = self.expression()
            asc = True
            if self.accept_keyword("asc"):
                asc = True
            elif self.accept_keyword("desc"):
                asc = False
            nulls_first = None
            if self.accept_keyword("nulls"):
                if self.accept_keyword("first"):
                    nulls_first = True
                else:
                    self.expect_keyword("last")
                    nulls_first = False
            items.append(A.SortItem(e, asc, nulls_first))
            if not self.accept_op(","):
                break
        return tuple(items)

    def _set_operation(self) -> A.Relation:
        return self._set_op_rest(self._query_term())

    def _set_op_rest(self, left: A.Relation) -> A.Relation:
        while self.at_keyword("union", "intersect", "except"):
            op = self.advance().value
            distinct = True
            if self.accept_keyword("all"):
                distinct = False
            else:
                self.accept_keyword("distinct")
            right = self._query_term()
            left = A.SetOperation(op, distinct, left, right)
        return left

    def _query_term(self) -> A.Relation:
        if self.at_op("("):
            self.advance()
            q = self.query()
            self.expect_op(")")
            return A.SubqueryRelation(q)
        if self.at_keyword("values"):
            self.advance()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expression()]
                while self.accept_op(","):
                    row.append(self.expression())
                self.expect_op(")")
                rows.append(tuple(row))
                if not self.accept_op(","):
                    break
            return A.ValuesRelation(tuple(rows))
        return self._query_spec()

    def _query_spec(self) -> A.QuerySpec:
        self.expect_keyword("select")
        distinct = False
        if self.accept_keyword("distinct"):
            distinct = True
        else:
            self.accept_keyword("all")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_rel = None
        if self.accept_keyword("from"):
            from_rel = self._relation()
        where = None
        if self.accept_keyword("where"):
            where = self.expression()
        group_by: tuple[A.GroupingElement, ...] = ()
        if self.accept_keyword("group"):
            self.expect_keyword("by")
            group_by = self._grouping_elements()
        having = None
        if self.accept_keyword("having"):
            having = self.expression()
        return A.QuerySpec(tuple(items), distinct, from_rel, where,
                           group_by, having)

    def _grouping_elements(self) -> tuple[A.GroupingElement, ...]:
        elems = []
        while True:
            if self.at_keyword("rollup", "cube"):
                kind = self.advance().value
                self.expect_op("(")
                exprs = [self.expression()]
                while self.accept_op(","):
                    exprs.append(self.expression())
                self.expect_op(")")
                elems.append(A.GroupingElement(kind, tuple(exprs)))
            elif self.at_keyword("grouping"):
                self.advance()
                self.expect_keyword("sets")
                self.expect_op("(")
                sets = []
                while True:
                    self.expect_op("(")
                    if self.at_op(")"):
                        exprs: tuple = ()
                    else:
                        lst = [self.expression()]
                        while self.accept_op(","):
                            lst.append(self.expression())
                        exprs = tuple(lst)
                    self.expect_op(")")
                    sets.append(exprs)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                elems.append(A.GroupingElement("sets", tuple(sets)))
            else:
                elems.append(
                    A.GroupingElement("simple", (self.expression(),)))
            if not self.accept_op(","):
                break
        return tuple(elems)

    def _select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.advance()
            return A.SelectItem(A.Star())
        # qualifier.*
        if (self.peek().kind in ("ident", "qident")
                and self.peek().value not in _RESERVED_STOP
                and self.peek(1).kind == "op" and self.peek(1).value == "."
                and self.peek(2).kind == "op" and self.peek(2).value == "*"):
            q = self.identifier()
            self.advance()
            self.advance()
            return A.SelectItem(A.Star(q))
        e = self.expression()
        alias = None
        if self.accept_keyword("as"):
            alias = self.identifier()
        elif (self.peek().kind == "qident"
              or (self.peek().kind == "ident"
                  and self.peek().value not in _RESERVED_STOP)):
            alias = self.identifier()
        return A.SelectItem(e, alias)

    # -- relations ----------------------------------------------------------

    def _relation(self) -> A.Relation:
        left = self._joined_relation()
        while self.accept_op(","):
            right = self._joined_relation()
            left = A.JoinRelation("implicit", left, right)
        return left

    def _joined_relation(self) -> A.Relation:
        left = self._relation_primary()
        while True:
            if self.accept_keyword("cross"):
                self.expect_keyword("join")
                right = self._relation_primary()
                left = A.JoinRelation("cross", left, right)
                continue
            jt = None
            if self.at_keyword("join"):
                jt = "inner"
            elif self.at_keyword("inner"):
                self.advance()
                jt = "inner"
            elif self.at_keyword("left"):
                self.advance()
                self.accept_keyword("outer")
                jt = "left"
            elif self.at_keyword("right"):
                self.advance()
                self.accept_keyword("outer")
                jt = "right"
            elif self.at_keyword("full"):
                self.advance()
                self.accept_keyword("outer")
                jt = "full"
            if jt is None:
                return left
            self.expect_keyword("join")
            right = self._relation_primary()
            if self.accept_keyword("on"):
                cond = self.expression()
                left = A.JoinRelation(jt, left, right, on=cond)
            elif self.accept_keyword("using"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                left = A.JoinRelation(jt, left, right, using=tuple(cols))
            else:
                raise SqlSyntaxError("JOIN requires ON or USING")

    def _relation_primary(self) -> A.Relation:
        if self.at_op("("):
            self.advance()
            # subquery or parenthesized join
            if self.at_keyword("select", "with", "values"):
                q = self.query()
                self.expect_op(")")
                rel: A.Relation = A.SubqueryRelation(q)
            else:
                rel = self._relation()
                if self.at_keyword("union", "intersect", "except") \
                        and isinstance(rel, A.SubqueryRelation):
                    # ((select ...) EXCEPT (select ...)) as a FROM
                    # subquery: continue the set-op chain (official
                    # TPC-DS q08/q87 shape), with an optional
                    # ORDER BY / LIMIT tail on the compound
                    body = self._set_op_rest(rel)
                    order: tuple[A.SortItem, ...] = ()
                    limit = None
                    offset = 0
                    if self.accept_keyword("order"):
                        self.expect_keyword("by")
                        order = self._sort_items()
                    if self.accept_keyword("limit"):
                        limit = int(self.advance().value)
                    if self.accept_keyword("offset"):
                        offset = int(self.advance().value)
                    rel = A.SubqueryRelation(
                        A.Query(body, (), order, limit, offset))
                self.expect_op(")")
            return self._maybe_alias(rel)
        if self.at_keyword("unnest"):
            self.advance()
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            ordinality = False
            if self.accept_keyword("with"):
                self.expect_keyword("ordinality")
                ordinality = True
            return self._maybe_alias(A.Unnest(tuple(exprs), ordinality))
        name = self.qualified_name()
        rel = A.TableRef(name)
        if self.at_keyword("match_recognize"):
            rel = self._match_recognize(rel)
        return self._maybe_alias(rel)

    def _match_recognize(self, rel: A.Relation) -> A.Relation:
        """MATCH_RECOGNIZE clause (SqlBase.g4 patternRecognition;
        supported subset: PARTITION BY / ORDER BY / MEASURES /
        ONE ROW PER MATCH / AFTER MATCH SKIP PAST LAST ROW /
        PATTERN with concat, |, *, +, ?, {n[,m]} / DEFINE)."""
        self.expect_keyword("match_recognize")
        self.expect_op("(")
        partition_by: tuple = ()
        order_by: tuple = ()
        measures: list[A.Measure] = []
        if self.accept_keyword("partition"):
            self.expect_keyword("by")
            parts = [self.expression()]
            while self.accept_op(","):
                parts.append(self.expression())
            partition_by = tuple(parts)
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            order_by = self._sort_items()
        if self.accept_keyword("measures"):
            while True:
                e = self.expression()
                self.expect_keyword("as")
                measures.append(A.Measure(e, self.identifier()))
                if not self.accept_op(","):
                    break
        if self.accept_keyword("one"):
            self.expect_keyword("row")
            self.expect_keyword("per")
            self.expect_keyword("match")
        if self.accept_keyword("after"):
            self.expect_keyword("match")
            self.expect_keyword("skip")
            self.expect_keyword("past")
            self.expect_keyword("last")
            self.expect_keyword("row")
        self.expect_keyword("pattern")
        self.expect_op("(")
        pattern = self._pattern_alt()
        self.expect_op(")")
        defines: list[tuple[str, A.Expression]] = []
        if self.accept_keyword("define"):
            while True:
                var = self.identifier()
                self.expect_keyword("as")
                defines.append((var, self.expression()))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        return A.MatchRecognizeRelation(
            rel, partition_by, order_by, tuple(measures), pattern,
            tuple(defines))

    def _pattern_alt(self):
        opts = [self._pattern_concat()]
        while self.accept_op("|"):
            opts.append(self._pattern_concat())
        if len(opts) == 1:
            return opts[0]
        return A.PatAlt(tuple(opts))

    def _pattern_concat(self):
        parts = []
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in (")", "|"):
                break
            parts.append(self._pattern_quant())
        if len(parts) == 1:
            return parts[0]
        return A.PatConcat(tuple(parts))

    def _pattern_quant(self):
        if self.accept_op("("):
            term: object = self._pattern_alt()
            self.expect_op(")")
        else:
            term = A.PatVar(self.identifier())
        while True:
            t = self.peek()
            if t.kind != "op":
                return term
            if t.value == "*":
                self.advance()
                term = A.PatQuant(term, 0, None)
            elif t.value == "+":
                self.advance()
                term = A.PatQuant(term, 1, None)
            elif t.value == "?":
                self.advance()
                term = A.PatQuant(term, 0, 1)
            elif t.value == "{":
                self.advance()
                lo = int(self.peek().value)
                self.advance()
                hi: int | None = lo
                if self.accept_op(","):
                    hi = None
                    if self.peek().kind == "number":
                        hi = int(self.peek().value)
                        self.advance()
                self.expect_op("}")
                term = A.PatQuant(term, lo, hi)
            else:
                return term

    def _maybe_alias(self, rel: A.Relation) -> A.Relation:
        alias = None
        if self.accept_keyword("as"):
            alias = self.identifier()
        elif (self.peek().kind == "qident"
              or (self.peek().kind == "ident"
                  and self.peek().value not in _RESERVED_STOP)):
            alias = self.identifier()
        if alias is None:
            return rel
        column_aliases: tuple[str, ...] = ()
        if self.at_op("(") and self.peek(1).kind in ("ident", "qident"):
            save = self.i
            self.advance()
            try:
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                column_aliases = tuple(cols)
            except SqlSyntaxError:
                self.i = save
        return A.AliasedRelation(rel, alias, column_aliases)

    # -- expressions --------------------------------------------------------

    def expression(self) -> A.Expression:
        # lambda: `x -> body` or `(x, y) -> body` (only meaningful as a
        # higher-order function argument; the planner rejects misuse)
        t = self.peek()
        if t.kind in ("ident", "qident") and self.peek(1).kind == "op" \
                and self.peek(1).value == "->":
            self.advance()
            self.advance()
            return A.Lambda((t.value,), self.expression())
        if t.kind == "op" and t.value == "(" \
                and self.peek(1).kind in ("ident", "qident"):
            save = self.i
            j = 1
            params = []
            while self.peek(j).kind in ("ident", "qident"):
                params.append(self.peek(j).value)
                j += 1
                if self.peek(j).kind == "op" \
                        and self.peek(j).value == ",":
                    j += 1
                    continue
                break
            if params and self.peek(j).kind == "op" \
                    and self.peek(j).value == ")" \
                    and self.peek(j + 1).kind == "op" \
                    and self.peek(j + 1).value == "->":
                for _ in range(j + 2):
                    self.advance()
                return A.Lambda(tuple(params), self.expression())
            self.i = save
        return self._or_expr()

    def _or_expr(self) -> A.Expression:
        terms = [self._and_expr()]
        while self.accept_keyword("or"):
            terms.append(self._and_expr())
        if len(terms) == 1:
            return terms[0]
        return A.LogicalOp("or", tuple(terms))

    def _and_expr(self) -> A.Expression:
        terms = [self._not_expr()]
        while self.accept_keyword("and"):
            terms.append(self._not_expr())
        if len(terms) == 1:
            return terms[0]
        return A.LogicalOp("and", tuple(terms))

    def _not_expr(self) -> A.Expression:
        if self.accept_keyword("not"):
            return A.NotOp(self._not_expr())
        return self._predicate()

    def _predicate(self) -> A.Expression:
        left = self._additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().value
                if op == "!=":
                    from presto_tpu_torch import warnings as W
                    W.warn(W.DEPRECATED_SYNTAX,
                           "'!=' is non-standard SQL; use '<>'")
                    op = "<>"
                # quantified subquery: = (SELECT ...) handled by ScalarSubquery
                right = self._additive()
                left = A.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_keyword("not"):
                negated = True
            if self.accept_keyword("between"):
                low = self._additive()
                self.expect_keyword("and")
                high = self._additive()
                left = A.BetweenPredicate(left, low, high, negated)
                continue
            if self.accept_keyword("in"):
                self.expect_op("(")
                if self.at_keyword("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = A.InSubquery(left, q, negated)
                else:
                    vals = [self.expression()]
                    while self.accept_op(","):
                        vals.append(self.expression())
                    self.expect_op(")")
                    left = A.InListPredicate(left, tuple(vals), negated)
                continue
            if self.accept_keyword("like"):
                pattern = self._additive()
                escape = None
                if self.accept_keyword("escape"):
                    escape = self._additive()
                left = A.LikePredicate(left, pattern, escape, negated)
                continue
            if self.accept_keyword("is"):
                neg = self.accept_keyword("not")
                self.expect_keyword("null")
                left = A.IsNullPredicate(left, neg)
                continue
            if negated:
                self.i = save
            break
        return left

    def _additive(self) -> A.Expression:
        left = self._multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.advance().value
            right = self._multiplicative()
            left = A.BinaryOp(op, left, right)
        return left

    def _multiplicative(self) -> A.Expression:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            right = self._unary()
            left = A.BinaryOp(op, left, right)
        return left

    def _unary(self) -> A.Expression:
        if self.at_op("-", "+"):
            op = self.advance().value
            return A.UnaryOp(op, self._unary())
        return self._postfix()

    def _postfix(self) -> A.Expression:
        e = self._primary()
        while self.at_op("["):
            self.advance()
            idx = self.expression()
            self.expect_op("]")
            e = A.Subscript(e, idx)
        return e

    def _primary(self) -> A.Expression:
        t = self.peek()
        if t.kind == "number":
            self.advance()
            return A.NumericLiteral(t.value)
        if t.kind == "string":
            self.advance()
            return A.StringLiteral(t.value)
        if t.kind == "op" and t.value == "?":
            # prepared-statement parameter marker: EXECUTE substitutes
            # a literal at this position before planning
            self.advance()
            return A.ParameterMarker(t.pos)
        if t.kind == "op" and t.value == "(":
            self.advance()
            if self.at_keyword("select", "with"):
                q = self.query()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.expression()
            self.expect_op(")")
            return e
        if t.kind == "qident":
            return self._name_or_call()
        if t.kind != "ident":
            raise SqlSyntaxError(
                f"unexpected token {t.value!r} at position {t.pos}")

        kw = t.value
        if kw == "null":
            self.advance()
            return A.NullLiteral()
        if kw == "array" and self.peek(1).kind == "op" \
                and self.peek(1).value == "[":
            self.advance()
            self.advance()
            items: list[A.Expression] = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return A.ArrayConstructor(tuple(items))
        if kw in ("true", "false"):
            self.advance()
            return A.BooleanLiteral(kw == "true")
        if kw in ("date", "timestamp", "time", "decimal") \
                and self.peek(1).kind == "string":
            self.advance()
            v = self.advance().value
            return A.TypedLiteral(kw, v)
        if kw == "interval":
            self.advance()
            negative = False
            if self.at_op("-"):
                self.advance()
                negative = True
            v = self.advance().value
            unit = self.identifier()
            if unit.endswith("s"):
                unit = unit[:-1]
            return A.IntervalLiteral(v, unit, negative)
        if kw == "case":
            return self._case()
        if kw in ("cast", "try_cast"):
            self.advance()
            self.expect_op("(")
            operand = self.expression()
            self.expect_keyword("as")
            type_name = self._type_name()
            self.expect_op(")")
            return A.CastExpression(operand, type_name, kw == "try_cast")
        if kw == "extract":
            self.advance()
            self.expect_op("(")
            field = self.identifier()
            self.expect_keyword("from")
            operand = self.expression()
            self.expect_op(")")
            return A.Extract(field, operand)
        if kw == "exists":
            self.advance()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return A.ExistsPredicate(q)
        return self._name_or_call()

    def _case(self) -> A.Expression:
        self.expect_keyword("case")
        operand = None
        if not self.at_keyword("when"):
            operand = self.expression()
        whens = []
        while self.accept_keyword("when"):
            cond = self.expression()
            self.expect_keyword("then")
            result = self.expression()
            if operand is not None:
                cond = A.BinaryOp("=", operand, cond)
            whens.append((cond, result))
        default = None
        if self.accept_keyword("else"):
            default = self.expression()
        self.expect_keyword("end")
        return A.CaseExpression(tuple(whens), default)

    def _type_name(self) -> str:
        base = self.identifier()
        if base == "double" and self.accept_keyword("precision"):
            base = "double"
        if self.accept_op("("):
            params = [self.advance().value]
            while self.accept_op(","):
                params.append(self.advance().value)
            self.expect_op(")")
            return f"{base}({','.join(params)})"
        return base

    def _name_or_call(self) -> A.Expression:
        parts = [self.identifier()]
        while self.at_op(".") and self.peek(1).kind in ("ident", "qident"):
            self.advance()
            parts.append(self.identifier())
        if len(parts) == 1 and self.at_op("("):
            return self._function_call(parts[0])
        if len(parts) == 1:
            return A.Identifier(parts[0])
        return A.Dereference(tuple(parts))

    def _function_call(self, name: str) -> A.Expression:
        self.expect_op("(")
        distinct = False
        is_star = False
        args: list[A.Expression] = []
        if self.at_op("*"):
            self.advance()
            is_star = True
        elif not self.at_op(")"):
            if self.accept_keyword("distinct"):
                distinct = True
            else:
                self.accept_keyword("all")
            args.append(self.expression())
            while self.accept_op(","):
                args.append(self.expression())
        agg_order: tuple[A.SortItem, ...] = ()
        if self.at_keyword("order"):
            # array_agg(x ORDER BY y)
            self.advance()
            self.expect_keyword("by")
            agg_order = self._sort_items()
        self.expect_op(")")
        if self.at_keyword("within"):
            # listagg(x, sep) WITHIN GROUP (ORDER BY y)
            self.advance()
            self.expect_keyword("group")
            self.expect_op("(")
            self.expect_keyword("order")
            self.expect_keyword("by")
            agg_order = self._sort_items()
            self.expect_op(")")
        filt = None
        if self.at_keyword("filter"):
            self.advance()
            self.expect_op("(")
            self.expect_keyword("where")
            filt = self.expression()
            self.expect_op(")")
        window = None
        if self.at_keyword("over"):
            self.advance()
            window = self._window_spec()
        return A.FunctionCall(name, tuple(args), distinct, is_star,
                              window, filt, agg_order)

    def _window_spec(self) -> A.WindowSpec:
        self.expect_op("(")
        partition: list[A.Expression] = []
        order: tuple[A.SortItem, ...] = ()
        frame = None
        if self.accept_keyword("partition"):
            self.expect_keyword("by")
            partition.append(self.expression())
            while self.accept_op(","):
                partition.append(self.expression())
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            order = self._sort_items()
        if self.at_keyword("rows", "range", "groups"):
            unit = self.advance().value
            if self.accept_keyword("between"):
                s_type, s_val = self._frame_bound()
                self.expect_keyword("and")
                e_type, e_val = self._frame_bound()
            else:
                s_type, s_val = self._frame_bound()
                e_type, e_val = "current", None
            frame = A.WindowFrame(unit, s_type, s_val, e_type, e_val)
        self.expect_op(")")
        return A.WindowSpec(tuple(partition), order, frame)

    def _frame_bound(self) -> tuple[str, A.Expression | None]:
        if self.accept_keyword("unbounded"):
            if self.accept_keyword("preceding"):
                return "unbounded_preceding", None
            self.expect_keyword("following")
            return "unbounded_following", None
        if self.accept_keyword("current"):
            self.expect_keyword("row")
            return "current", None
        v = self.expression()
        if self.accept_keyword("preceding"):
            return "preceding", v
        self.expect_keyword("following")
        return "following", v
