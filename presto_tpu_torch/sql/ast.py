"""SQL abstract syntax tree.

The subset of the reference's 223 AST classes
(core/trino-parser/src/main/java/io/trino/sql/tree/) needed for the
TPC-H/TPC-DS query language. Expression and relation nodes are plain
dataclasses; the analyzer decorates them via side tables (the reference's
Analysis pattern, sql/analyzer/Analysis.java) rather than mutation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class Node:
    pass


# ---- expressions ----------------------------------------------------------


class Expression(Node):
    pass


@dataclasses.dataclass(frozen=True)
class Identifier(Expression):
    name: str  # already lower-cased unless quoted


@dataclasses.dataclass(frozen=True)
class Dereference(Expression):
    """qualified name a.b(.c): base identifier chain for column refs."""
    parts: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class NumericLiteral(Expression):
    text: str  # verbatim; analyzer decides integer/decimal/double


@dataclasses.dataclass(frozen=True)
class StringLiteral(Expression):
    value: str


@dataclasses.dataclass(frozen=True)
class BooleanLiteral(Expression):
    value: bool


@dataclasses.dataclass(frozen=True)
class NullLiteral(Expression):
    pass


@dataclasses.dataclass(frozen=True)
class TypedLiteral(Expression):
    """DATE '1995-01-01', TIMESTAMP '...', DECIMAL '1.2'."""
    type_name: str
    value: str


@dataclasses.dataclass(frozen=True)
class IntervalLiteral(Expression):
    """INTERVAL '3' MONTH; sign applied to value."""
    value: str
    unit: str  # year|month|day|hour|minute|second
    negative: bool = False


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expression):
    op: str  # - | +
    operand: Expression


@dataclasses.dataclass(frozen=True)
class BinaryOp(Expression):
    op: str  # + - * / % || and comparisons = <> < <= > >=
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class LogicalOp(Expression):
    op: str  # and | or
    terms: tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class NotOp(Expression):
    operand: Expression


@dataclasses.dataclass(frozen=True)
class IsNullPredicate(Expression):
    operand: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class BetweenPredicate(Expression):
    operand: Expression
    low: Expression
    high: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InListPredicate(Expression):
    operand: Expression
    values: tuple[Expression, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(Expression):
    operand: Expression
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ExistsPredicate(Expression):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class LikePredicate(Expression):
    operand: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class FunctionCall(Expression):
    name: str
    args: tuple[Expression, ...]
    distinct: bool = False
    is_star: bool = False  # count(*)
    window: Optional["WindowSpec"] = None
    filter: Optional[Expression] = None
    # intra-aggregate ordering: array_agg(x ORDER BY y) or
    # listagg(x, s) WITHIN GROUP (ORDER BY y)
    agg_order_by: tuple["SortItem", ...] = ()


@dataclasses.dataclass(frozen=True)
class WindowSpec(Node):
    partition_by: tuple[Expression, ...] = ()
    order_by: tuple["SortItem", ...] = ()
    frame: Optional["WindowFrame"] = None


@dataclasses.dataclass(frozen=True)
class WindowFrame(Node):
    unit: str  # rows | range | groups
    start_type: str  # unbounded_preceding|preceding|current|following|unbounded_following
    start_value: Optional[Expression] = None
    end_type: Optional[str] = None
    end_value: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class CastExpression(Expression):
    operand: Expression
    type_name: str  # e.g. "decimal(12,2)", "bigint", "varchar"
    try_cast: bool = False


@dataclasses.dataclass(frozen=True)
class CaseExpression(Expression):
    """Searched CASE; simple CASE is desugared by the parser."""
    whens: tuple[tuple[Expression, Expression], ...]
    default: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class ArrayConstructor(Expression):
    """ARRAY[e1, e2, ...]"""

    items: tuple["Expression", ...] = ()


@dataclasses.dataclass(frozen=True)
class Subscript(Expression):
    """e[index] — array element access (SQL 1-based) / map lookup."""

    operand: "Expression" = None  # type: ignore[assignment]
    index: "Expression" = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class Lambda(Expression):
    """x -> body / (x, y) -> body (argument of array higher-order
    functions)."""

    params: tuple[str, ...] = ()
    body: "Expression" = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class Extract(Expression):
    field: str  # year|month|day|...
    operand: Expression


@dataclasses.dataclass(frozen=True)
class Star(Expression):
    """* or qualifier.* in a select list."""
    qualifier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ParameterMarker(Expression):
    """A ``?`` parameter of a prepared statement (reference
    sql/tree/Parameter.java). Only valid inside PREPARE'd text; EXECUTE
    splices literals over the markers before planning
    (templates/prepared.py), so the planner never sees one."""
    position: int = 0


# ---- relations ------------------------------------------------------------


class Relation(Node):
    pass


@dataclasses.dataclass(frozen=True)
class TableRef(Relation):
    parts: tuple[str, ...]  # [catalog.][schema.]table


@dataclasses.dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_aliases: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class JoinRelation(Relation):
    join_type: str  # inner|left|right|full|cross|implicit
    left: Relation
    right: Relation
    on: Optional[Expression] = None
    using: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Unnest(Relation):
    expressions: tuple[Expression, ...]
    with_ordinality: bool = False


@dataclasses.dataclass(frozen=True)
class ValuesRelation(Relation):
    rows: tuple[tuple[Expression, ...], ...]


# ---- MATCH_RECOGNIZE (row pattern recognition, SQL:2016) ------------------


@dataclasses.dataclass(frozen=True)
class PatVar:
    name: str


@dataclasses.dataclass(frozen=True)
class PatConcat:
    parts: tuple


@dataclasses.dataclass(frozen=True)
class PatAlt:
    options: tuple


@dataclasses.dataclass(frozen=True)
class PatQuant:
    term: object
    min: int
    max: int | None  # None = unbounded
    greedy: bool = True


@dataclasses.dataclass(frozen=True)
class Measure:
    expression: Expression
    name: str


@dataclasses.dataclass(frozen=True)
class MatchRecognizeRelation(Relation):
    input: Relation
    partition_by: tuple[Expression, ...]
    order_by: tuple["SortItem", ...]
    measures: tuple[Measure, ...]
    pattern: object
    defines: tuple[tuple[str, Expression], ...]


# ---- query structure ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    expression: Expression
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    expression: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class GroupingElement(Node):
    """Plain expressions; ROLLUP/CUBE/GROUPING SETS expand into sets."""
    kind: str  # simple | rollup | cube | sets
    expressions: tuple = ()  # simple: Expression; sets: tuple[Expression,...]


@dataclasses.dataclass(frozen=True)
class QuerySpec(Relation):
    """One SELECT block."""
    select_items: tuple[SelectItem, ...]
    distinct: bool = False
    from_relation: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: tuple[GroupingElement, ...] = ()
    having: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class SetOperation(Relation):
    op: str  # union | intersect | except
    distinct: bool = True  # False => ALL
    left: Relation = None  # type: ignore[assignment]
    right: Relation = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_aliases: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Query(Node):
    """Full query: WITH ... body ORDER BY ... LIMIT."""
    body: Relation  # QuerySpec | SetOperation | SubqueryRelation
    with_queries: tuple[WithQuery, ...] = ()
    order_by: tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# ---- statements -----------------------------------------------------------


class Statement(Node):
    pass


@dataclasses.dataclass(frozen=True)
class QueryStatement(Statement):
    query: Query


@dataclasses.dataclass(frozen=True)
class DeleteStatement(Statement):
    table: tuple[str, ...]
    where: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class UpdateStatement(Statement):
    table: tuple[str, ...]
    assignments: tuple[tuple[str, Expression], ...]
    where: Optional[Expression] = None


@dataclasses.dataclass(frozen=True)
class ExplainStatement(Statement):
    statement: Statement
    analyze: bool = False
    format: str = "text"


@dataclasses.dataclass(frozen=True)
class ShowTables(Statement):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowColumns(Statement):
    table: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class StartTransaction(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class CommitStatement(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class RollbackStatement(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class ShowCatalogs(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class ShowSession(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class SetSession(Statement):
    name: str = ""
    value: object = None


@dataclasses.dataclass(frozen=True)
class CreateTableAs(Statement):
    table: tuple[str, ...] = ()
    query: Query = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class InsertStatement(Statement):
    table: tuple[str, ...] = ()
    columns: tuple[str, ...] = ()
    query: Query = None  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class DropTable(Statement):
    table: tuple[str, ...] = ()
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Prepare(Statement):
    """PREPARE name FROM <statement> — stores the statement TEXT
    (with ? markers) under a session-scoped name (reference
    sql/tree/Prepare.java)."""
    name: str = ""
    sql: str = ""


@dataclasses.dataclass(frozen=True)
class ExecutePrepared(Statement):
    """EXECUTE name [USING literal, ...]."""
    name: str = ""
    params: tuple[Expression, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Statement):
    """DEALLOCATE PREPARE name."""
    name: str = ""
