"""SQL lexer.

Token-level analog of the reference's ANTLR lexer rules
(core/trino-parser/src/main/antlr4/io/trino/sql/parser/SqlBase.g4:1).
Identifiers fold to lower case unless double-quoted; strings use ''
escaping; -- and /* */ comments are skipped.
"""

from __future__ import annotations

import dataclasses


class SqlSyntaxError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # ident | qident | string | number | op | eof
    value: str
    pos: int


_OPERATORS = [
    "<>", "!=", ">=", "<=", "||", "=>", "->",
    "(", ")", ",", ".", ";", "+", "-", "*", "/", "%", "<", ">", "=", "?",
    "[", "]", "|", "{", "}",
]


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlSyntaxError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlSyntaxError(f"unterminated string at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlSyntaxError(f"unterminated quoted identifier at {i}")
            # identifiers are case-insensitive even when quoted (the
            # reference lowercases all identifiers — its own TPC-DS
            # texts alias "YEAR" and reference "year")
            tokens.append(Token("qident", sql[i + 1:j].lower(), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    nxt = sql[j + 1:j + 2]
                    if nxt.isdigit() or (nxt in "+-" and
                                         sql[j + 2:j + 3].isdigit()):
                        seen_exp = True
                        j += 2 if nxt in "+-" else 1
                    else:
                        break
                else:
                    break
            tokens.append(Token("number", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            tokens.append(Token("ident", sql[i:j].lower(), i))
            i = j
            continue
        for op in _OPERATORS:
            if sql.startswith(op, i):
                tokens.append(Token("op", op, i))
                i += len(op)
                break
        else:
            raise SqlSyntaxError(f"unexpected character {c!r} at {i}")
    tokens.append(Token("eof", "", n))
    return tokens
