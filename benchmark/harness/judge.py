"""Decide ``correct``: the rows the timed path returned against the
plain reference's.

Both sides are put in one canonical form, by the reference's
``COLUMNS``: text, whole numbers, ISO dates, decimals exact at the
column's scale (a short decimal comes back from the port as the double
nearest its value, which names that value exactly while it has fewer
than 16 digits), doubles as they are. Rows must then agree exactly:
the values of every row, and the order by the query's ORDER BY, where
rows that tie on every ordering column may come in any order and a
LIMIT may cut among them.
"""

from __future__ import annotations

import collections
import decimal

import numpy as np

from reference.common import ordered


def canonical(value, kind: str):
    if value is None:
        return None
    if kind == "str":
        return str(value)
    if kind == "int":
        return int(value)
    if kind == "date":
        return str(np.datetime64(value, "D"))
    if kind == "double":
        return float(value)
    if kind.startswith("dec:"):
        scale = decimal.Decimal(1).scaleb(-int(kind[4:]))
        if isinstance(value, decimal.Decimal):
            return value.quantize(scale) if value == value.quantize(
                scale) else value
        return decimal.Decimal(float(value)).quantize(scale)
    raise ValueError(f"column kind {kind!r}")


def rows_of(ref, rows) -> list[tuple]:
    kinds = [k for _n, k in ref.COLUMNS]
    out = []
    for r in rows:
        if len(r) != len(kinds):
            out.append(("<row of width %d>" % len(r),))
            continue
        out.append(tuple(canonical(v, k) for v, k in zip(r, kinds)))
    return out


def mismatches(ref, got: list, want: list) -> int:
    """Rows of ``got`` (the port's, canonical) that break the answer
    ``want`` (the reference's, canonical and ordered with its ties),
    plus rows missing or extra."""
    expect = len(want) if ref.LIMIT is None else min(ref.LIMIT, len(want))
    wrong = abs(len(got) - expect)
    if not ref.ORDER:
        left = collections.Counter(want)
        for r in got:
            if left[r] > 0:
                left[r] -= 1
            else:
                wrong += 1
        return wrong
    cols = [c for c, _ in ref.ORDER]
    pool = collections.defaultdict(collections.Counter)
    for r in want:
        pool[tuple(r[c] for c in cols)][r] += 1
    for i, r in enumerate(got[:expect]):
        key = tuple(r[c] for c in cols)
        if key != tuple(want[i][c] for c in cols) or pool[key][r] <= 0:
            wrong += 1
            continue
        pool[key][r] -= 1
    return wrong


def reference_rows(ref, tables, params) -> list[tuple]:
    return ordered(ref.answer(tables, params), ref.ORDER, ref.LIMIT)
