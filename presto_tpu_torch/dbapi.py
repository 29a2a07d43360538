"""PEP 249 (DB-API 2.0) driver over the coordinator HTTP protocol.

The reference ships a JDBC driver speaking the same nextUri-paged
statement protocol (client/trino-jdbc, client/trino-client); this is
the Python-ecosystem equivalent so tools written against DB-API
(SQLAlchemy dialects, pandas read_sql, plain scripts) can use the
engine without knowing its protocol.

    import presto_tpu_torch.dbapi as dbapi
    conn = dbapi.connect(host="localhost", port=8080, user="alice")
    cur = conn.cursor()
    cur.execute("select * from tpch.nation where n_regionkey = ?", (1,))
    print(cur.description, cur.fetchall())

Parameters use qmark style with client-side literal substitution — the
same approach the reference JDBC driver takes for non-prepared
statements (PrestoPreparedStatement client-side templating).
"""

from __future__ import annotations

import datetime

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Warning(Exception):  # noqa: A001 - name mandated by PEP 249
    pass


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


def _quote(value) -> str:
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, datetime.datetime):
        if value.tzinfo is not None:
            raise NotSupportedError(
                "timezone-aware datetimes are unsupported "
                "(no TIMESTAMP WITH TIME ZONE type)")
        return f"TIMESTAMP '{value:%Y-%m-%d %H:%M:%S.%f}'"
    if isinstance(value, datetime.date):
        return f"DATE '{value:%Y-%m-%d}'"
    if isinstance(value, datetime.time):
        return f"TIME '{value:%H:%M:%S.%f}'"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    raise ProgrammingError(f"cannot bind parameter of type {type(value)}")


def _substitute(sql: str, params) -> str:
    """Replace ? placeholders, skipping string literals, double-quoted
    identifiers, and -- / block comments. Runs even with no
    parameters so a leftover ? fails client-side, not as an opaque
    server parse error."""
    out = []
    it = iter(params)
    i = 0
    n = len(sql)
    while i < n:
        ch = sql[i]
        if ch == "'" or ch == '"':
            quote = ch
            j = i + 1
            while j < n:
                if sql[j] == quote:
                    if quote == "'" and j + 1 < n and sql[j + 1] == "'":
                        j += 2  # '' escape
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
        elif ch == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
        elif ch == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
        elif ch == "?":
            try:
                out.append(_quote(next(it)))
            except StopIteration:
                raise ProgrammingError("not enough parameters") from None
            i += 1
        else:
            out.append(ch)
            i += 1
    remaining = sum(1 for _ in it)
    if remaining:
        raise ProgrammingError(f"{remaining} unused parameters")
    return "".join(out)


def _parse_wire_timestamp(v: str) -> datetime.datetime:
    s = str(v).replace("T", " ")
    fmt = "%Y-%m-%d %H:%M:%S.%f" if "." in s else "%Y-%m-%d %H:%M:%S"
    return datetime.datetime.strptime(s, fmt)


def _parse_wire_time(v: str) -> datetime.time:
    fmt = "%H:%M:%S.%f" if "." in str(v) else "%H:%M:%S"
    return datetime.datetime.strptime(str(v), fmt).time()


_WIRE_CONVERTERS = {
    "date": lambda v: datetime.date.fromisoformat(str(v)),
    "timestamp": _parse_wire_timestamp,
    "time": _parse_wire_time,
}


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: list[tuple] | None = None
        self._pos = 0
        self.description = None
        self.rowcount = -1

    # -- PEP 249 ------------------------------------------------------------

    def execute(self, operation: str, parameters=None) -> "Cursor":
        if self._conn._client is None:
            raise InterfaceError("cursor on a closed connection")
        from presto_tpu_torch.client import QueryFailed

        sql = _substitute(operation, parameters or ())
        try:
            columns, rows = self._conn._client.execute(sql)
        except QueryFailed as e:
            raise DatabaseError(str(e)) from e
        except OSError as e:
            raise OperationalError(str(e)) from e
        self.description = [
            (c.get("name"), c.get("type"), None, None, None, None, None)
            for c in columns]
        convs = [_WIRE_CONVERTERS.get(str(c.get("type", "")).lower())
                 for c in columns]
        if any(convs):
            self._rows = [
                tuple(v if cv is None or v is None else cv(v)
                      for v, cv in zip(r, convs)) for r in rows]
        else:
            self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def executemany(self, operation: str, seq_of_parameters) -> None:
        for p in seq_of_parameters:
            self.execute(operation, p)

    def fetchone(self):
        if self._rows is None:
            raise ProgrammingError("fetch before execute")
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: int | None = None):
        n = size if size is not None else self.arraysize
        out = []
        for _ in range(n):
            row = self.fetchone()
            if row is None:
                break
            out.append(row)
        return out

    def fetchall(self):
        if self._rows is None:
            raise ProgrammingError("fetch before execute")
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self) -> None:
        self._rows = None

    def setinputsizes(self, sizes) -> None:  # pragma: no cover - no-op
        pass

    def setoutputsize(self, size, column=None) -> None:  # pragma: no cover
        pass


class Connection:
    def __init__(self, host: str, port: int, user: str,
                 password: str | None = None, scheme: str = "http"):
        from presto_tpu_torch.client import Client
        self._client = Client(f"{scheme}://{host}:{port}", user=user,
                              password=password)

    def cursor(self) -> Cursor:
        if self._client is None:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._client = None

    def commit(self) -> None:
        # autocommit protocol: every statement is its own transaction
        pass

    def rollback(self) -> None:
        raise NotSupportedError(
            "transactions are per-statement over the HTTP protocol; "
            "ROLLBACK is not supported here")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(host: str = "localhost", port: int = 8080,
            user: str = "presto", password: str | None = None,
            scheme: str = "http") -> Connection:
    return Connection(host, port, user, password, scheme)
