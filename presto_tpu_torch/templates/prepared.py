"""PREPARE / EXECUTE ... USING: the user-visible face of plan
templates (Trino prepared-statement semantics, StatementClientV1 /
sql/analyzer/ParameterExtractor in the reference).

``PREPARE q FROM select ... where x = ?`` stores the statement TEXT
(with ``?`` parameter markers) under a session-scoped name;
``EXECUTE q USING <literal>, ...`` splices the literals into the
marker positions token-wise (markers are located by the SQL lexer, so
a ``?`` inside a string literal or comment is never touched) and runs
the resulting statement through the normal pipeline — which is the
point: every EXECUTE variant optimizes to the same plan shape, so the
template machinery (templates/analysis.py) keys them all onto one
compiled program.

Over HTTP the reference protocol is mirrored: a PREPARE answers with
``addedPreparedStatements`` and the client replays the registry via
the ``X-Trino-Prepared-Statement`` header on later requests
(server/server.py, client.py).
"""

from __future__ import annotations

from presto_tpu_torch.sql import ast as A
from presto_tpu_torch.sql.lexer import tokenize


def literal_sql(e: A.Expression) -> str:
    """SQL text of one EXECUTE ... USING argument (literals only —
    Trino's EXECUTE accepts expressions but this engine's USING list
    is the literal subset the templates hoist)."""
    if isinstance(e, A.StringLiteral):
        return "'" + e.value.replace("'", "''") + "'"
    if isinstance(e, A.NumericLiteral):
        return e.text
    if isinstance(e, A.BooleanLiteral):
        return "true" if e.value else "false"
    if isinstance(e, A.NullLiteral):
        return "null"
    if isinstance(e, A.TypedLiteral):
        return f"{e.type_name} '{e.value}'"
    if isinstance(e, A.IntervalLiteral):
        sign = "-" if e.negative else ""
        return f"interval {sign}'{e.value}' {e.unit}"
    if isinstance(e, A.UnaryOp) and e.op == "-":
        return "-" + literal_sql(e.operand)
    raise ValueError(
        "EXECUTE ... USING arguments must be literals, got "
        f"{type(e).__name__}")


def parameter_positions(sql: str) -> list[int]:
    """Character offsets of the ``?`` parameter markers of a prepared
    statement, in statement order (lexer-accurate: markers inside
    strings/comments don't count)."""
    return [t.pos for t in tokenize(sql)
            if t.kind == "op" and t.value == "?"]


def substitute(name: str, prepared_sql: str,
               args: tuple[A.Expression, ...]) -> str:
    """The executable SQL of ``EXECUTE name USING args``."""
    marks = parameter_positions(prepared_sql)
    if len(marks) != len(args):
        raise ValueError(
            f"prepared statement {name} takes {len(marks)} "
            f"parameter(s), EXECUTE supplied {len(args)}")
    out = []
    last = 0
    for pos, arg in zip(marks, args):
        out.append(prepared_sql[last:pos])
        out.append(literal_sql(arg))
        last = pos + 1
    out.append(prepared_sql[last:])
    return "".join(out)


def resolve_execute(registry: dict, stmt: "A.ExecutePrepared") -> str:
    """Look up + substitute one EXECUTE against a prepared-statement
    registry ({name: sql})."""
    stored = registry.get(stmt.name)
    if stored is None:
        raise ValueError(f"prepared statement not found: {stmt.name}")
    return substitute(stmt.name, stored, stmt.params)
