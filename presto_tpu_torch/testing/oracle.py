"""sqlite-backed correctness oracle.

Loads the same connector data into an in-memory sqlite database and runs a
sqlite-dialect rendering of each query; results are compared as (optionally
ordered) multisets with numeric tolerance. This mirrors the reference's
H2QueryRunner-based assertQuery flow
(testing/trino-testing/src/main/java/io/trino/testing/H2QueryRunner.java:90).

Encoding into sqlite: DECIMAL -> REAL (unscaled), DATE -> TEXT ISO-8601
(lexicographic order == date order), VARCHAR -> TEXT.
"""

from __future__ import annotations

import math
import sqlite3

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import _decode_column
from presto_tpu_torch.connectors.base import Connector


class _Variance:
    """Welford accumulator registered as sqlite UDAs (sqlite ships no
    statistical aggregates)."""

    def __init__(self, ddof: int, sqrt: bool):
        self.ddof = ddof
        self.sqrt = sqrt
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def step(self, value):
        if value is None:
            return
        self.n += 1
        d = value - self.mean
        self.mean += d / self.n
        self.m2 += d * (value - self.mean)

    def finalize(self):
        if self.n <= self.ddof:
            return None
        v = self.m2 / (self.n - self.ddof)
        return v ** 0.5 if self.sqrt else v


class SqliteOracle:
    def __init__(self) -> None:
        self.conn = sqlite3.connect(":memory:")
        mk = lambda ddof, sqrt: (  # noqa: E731
            lambda: _Variance(ddof, sqrt))
        for name, ddof, sqrt in (
                ("stddev", 1, True), ("stddev_samp", 1, True),
                ("stddev_pop", 0, True), ("variance", 1, False),
                ("var_samp", 1, False), ("var_pop", 0, False)):
            self.conn.create_aggregate(name, 1, mk(ddof, sqrt))

    def load_connector(self, connector: Connector) -> None:
        for name in connector.table_names():
            schema = connector.table_schema(name)
            cols = ", ".join(f"{c} {_sqlite_type(t)}" for c, t in schema.items())
            self.conn.execute(f"CREATE TABLE {name} ({cols})")
            tbl = connector.table(name)
            arrays = []
            for cname, dtype in schema.items():
                col = tbl.columns[cname]
                decoded = _decode_column(
                    dtype, np.asarray(col.data), col.dictionary)
                if isinstance(dtype, T.DateType):
                    decoded = [str(d) for d in decoded]  # ISO text in sqlite
                elif isinstance(dtype, T.VarcharType):
                    decoded = [str(s) for s in decoded]
                else:
                    decoded = decoded.tolist()
                if col.valid is not None:
                    valid = np.asarray(col.valid)
                    decoded = [d if ok else None
                               for d, ok in zip(decoded, valid)]
                arrays.append(decoded)
            rows = list(zip(*arrays)) if arrays else []
            ph = ", ".join("?" for _ in schema)
            self.conn.executemany(f"INSERT INTO {name} VALUES ({ph})", rows)
        self.conn.commit()

    def query(self, sql: str) -> list[tuple]:
        return [tuple(r) for r in self.conn.execute(sql).fetchall()]


def _sqlite_type(t: T.DataType) -> str:
    if isinstance(t, (T.BigintType, T.IntegerType)):
        return "INTEGER"
    if isinstance(t, (T.DoubleType, T.DecimalType)):
        return "REAL"
    return "TEXT"


def normalize_value(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.datetime64):
        # canonical 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' text matching what
        # sqlite datetime()/timestamp literals produce
        s = str(v).replace("T", " ")
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        return s
    if isinstance(v, np.timedelta64):  # TIME values (us since midnight)
        us = int(v.astype("timedelta64[us]").astype(np.int64))
        h, rem = divmod(us, 3_600_000_000)
        m, rem = divmod(rem, 60_000_000)
        sec, frac = divmod(rem, 1_000_000)
        out = f"{h:02d}:{m:02d}:{sec:02d}"
        return f"{out}.{frac:06d}".rstrip("0").rstrip(".") if frac \
            else out
    if isinstance(v, np.str_):
        return str(v)
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, np.bool_):
        return int(v)
    return v


def values_equal(a, b, rel: float = 1e-6, absol: float = 1e-9) -> bool:
    """Tolerant float compare. Beyond rel/abs closeness, accepts the
    engine value being the *decimal rounding* of the oracle value: the
    engine computes decimal(p,s) arithmetic exactly (rounding to scale s,
    reference DecimalOperators semantics) while the oracle's REAL keeps
    full precision — so 698.47 matches 698.4685714 via the scale-2 check
    without loosening every other comparison."""
    a, b = normalize_value(a), normalize_value(b)
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        try:
            fa, fb = float(a), float(b)
        except (TypeError, ValueError):
            return False
        if math.isclose(fa, fb, rel_tol=rel, abs_tol=absol):
            return True
        # engine value at some decimal scale k == oracle rounded to k?
        # k starts at 2 (the smallest decimal scale in our catalogs):
        # starting at 0 would let any integer-valued engine float match
        # any oracle value within 0.5 — e.g. 5.0 vs 5.4 — silently
        # masking real aggregation bugs. A value exact at scale < 2 is
        # also exact at scale 2, so nothing legitimate is lost.
        for k in range(2, 7):
            f = 10.0 ** k
            if abs(fa * f - round(fa * f)) < 1e-6:
                # engine value exact at scale k: accept it as a rounding
                # of the oracle value to that scale. Half-ulp tolerance
                # (not round-trip equality) because the engine rounds
                # HALF_UP in the exact scaled-int domain while the
                # oracle's float at a .5 boundary can land either way.
                return abs(fa - fb) <= 0.5 / f + 1e-9
        return False
    return a == b


def rows_equal(got: list[tuple], want: list[tuple], ordered: bool) -> tuple[bool, str]:
    if len(got) != len(want):
        return False, f"row count {len(got)} != expected {len(want)}"
    g, w = list(got), list(want)
    if not ordered:
        key = lambda r: tuple(
            (x is None, str(normalize_value(x))) for x in r)
        g, w = sorted(g, key=key), sorted(w, key=key)
    for i, (rg, rw) in enumerate(zip(g, w)):
        if len(rg) != len(rw):
            return False, f"row {i} width {len(rg)} != {len(rw)}"
        for j, (x, y) in enumerate(zip(rg, rw)):
            if not values_equal(x, y):
                return False, (f"row {i} col {j}: got {x!r} want {y!r}\n"
                               f"  got row:  {rg}\n  want row: {rw}")
    return True, ""


def assert_query(engine, oracle: SqliteOracle, sql: str,
                 sqlite_sql: str | None = None, ordered: bool | None = None):
    """Run ``sql`` on the engine and its sqlite rendering on the oracle;
    assert equal results. ``ordered`` defaults to whether the query has a
    top-level ORDER BY."""
    if sqlite_sql is None:
        from presto_tpu_torch.sql.sqlite_dialect import to_sqlite
        from presto_tpu_torch.sql.parser import parse_statement
        stmt = parse_statement(sql)
        sqlite_sql = to_sqlite(stmt)
    if ordered is None:
        ordered = "order by" in sql.lower()
    got = engine.execute(sql)
    want = oracle.query(sqlite_sql)
    ok, msg = rows_equal(got, want, ordered)
    assert ok, f"query mismatch: {msg}\n  sql: {sql}\n  sqlite: {sqlite_sql}"
