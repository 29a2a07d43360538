"""What the plain references share: the tables on a device, exact
decimal arithmetic, and ordering with ties.

A reference computes a query's answer with plain PyTorch operations
over the generator's arrays: dimension keys are dense (1..n), so a
join is an index into the dimension's column, and a group is a
``torch.unique`` over its key. Decimals stay scaled integers: sums are
int64 sums, exact whenever the true total fits in 63 bits (two's
complement addition is exact modulo 2^64), which a float64 shadow sum
checks. Under ``precision`` "float64" or "float32" (the control) every
decimal product and sum runs in that float type instead and is
rounded to the column's scale only at the end.

Rows come back in canonical form: str, int, an ISO date string,
``decimal.Decimal`` at the column's scale, float, or None for a NULL.
"""

from __future__ import annotations

import decimal

import numpy as np
import torch

EPOCH = np.datetime64("1970-01-01")


class Tables:
    """The generator's arrays, put on ``device`` column by column as a
    reference asks for them. ``data[table][column]`` is a numpy array
    or an object with ``codes`` and ``dictionary`` (a string column)."""

    def __init__(self, data: dict, device, precision: str = "exact"):
        if precision not in ("exact", "float64", "float32"):
            raise ValueError(f"precision {precision!r}")
        self.data = data
        self.device = torch.device(device)
        self.precision = precision
        self._dev: dict = {}

    def col(self, table: str, column: str) -> torch.Tensor:
        """A numeric column (or a string column's codes) on the device."""
        key = (table, column)
        if key not in self._dev:
            a = self.data[table][column]
            a = getattr(a, "codes", a)
            self._dev[key] = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)
        return self._dev[key]

    def dictionary(self, table: str, column: str) -> np.ndarray:
        return self.data[table][column].dictionary

    def where(self, table: str, column: str, test) -> torch.Tensor:
        """Rows whose string satisfies ``test(str) -> bool``: the test
        runs once a dictionary entry, the rows look their code up."""
        d = self.dictionary(table, column)
        hit = torch.tensor([bool(test(s)) for s in d], dtype=torch.bool,
                           device=self.device)
        return hit[self.col(table, column).long()]

    def strings(self, table: str, column: str, codes) -> list:
        d = self.dictionary(table, column)
        return [str(d[int(c)]) for c in np.asarray(codes)]

    def dense(self, table: str, key: str, column: str | None = None,
              rows=None):
        """A lookup by key: ``out[k]`` is ``column`` (or True, or the
        ``rows`` mask) at the row whose ``key`` is k; 0 (False) where
        no row has k. The key column is the dimension's dense key."""
        keys = self.col(table, key).long()
        size = int(keys.max()) + 1 if keys.numel() else 1
        if column is None:
            out = torch.zeros(size, dtype=torch.bool, device=self.device)
            out[keys] = True if rows is None else rows
            return out
        vals = self.col(table, column)
        out = torch.zeros(size, dtype=vals.dtype, device=self.device)
        out[keys] = vals
        return out

    # -- decimal arithmetic ---------------------------------------------

    def num(self, t: torch.Tensor) -> torch.Tensor:
        """A scaled-integer column for arithmetic: int64, or the
        control's float type."""
        if self.precision == "exact":
            return t.long()
        return t.to(torch.float64 if self.precision == "float64"
                    else torch.float32)

    def sum(self, values: torch.Tensor, ids=None, n: int = 1):
        """Sums of ``values`` (all of them, or by group ``ids`` into
        ``n`` groups) on the device, in the values' scale: int64, or
        the control's float type."""
        if ids is None:
            ids = torch.zeros(values.shape[0], dtype=torch.long,
                              device=values.device)
        ids = ids.long()
        out = torch.zeros(n, dtype=values.dtype, device=values.device)
        out.index_add_(0, ids, values)
        if self.precision == "exact" and n:
            shadow = torch.zeros(n, dtype=torch.float64,
                                 device=values.device)
            shadow.index_add_(0, ids, values.double())
            if float(shadow.abs().max()) >= 2.0 ** 62:
                raise OverflowError("a decimal sum leaves int64")
        return out

    def ints(self, t: torch.Tensor) -> list[int]:
        """Sums from :meth:`sum` as Python ints; the control rounds
        its float sums to whole units of the scale."""
        if self.precision == "exact":
            return [int(v) for v in t.cpu().tolist()]
        return [int(round(float(v))) for v in t.cpu().tolist()]

    def count(self, ids, n: int) -> torch.Tensor:
        """Rows by group ``ids`` into ``n`` groups, on the device."""
        out = torch.zeros(n, dtype=torch.int64, device=ids.device)
        out.index_add_(0, ids.long(), torch.ones_like(ids, dtype=torch.int64))
        return out


def dec(units: int | None, scale: int):
    """``units`` of 10^-scale as a Decimal (None stays None)."""
    if units is None:
        return None
    return decimal.Decimal(int(units)).scaleb(-scale)


def div_half_up(a: int, b: int) -> int:
    """a / b rounded half away from zero (b > 0)."""
    q, r = divmod(abs(a), b)
    if 2 * r >= b:
        q += 1
    return q if a >= 0 else -q


def avg(total: int, count: int, precision: str = "exact") -> int:
    """avg of a decimal column in its own scale, rounded half up; the
    control divides in its float type."""
    if precision == "exact":
        return div_half_up(total, count)
    dt = np.float64 if precision == "float64" else np.float32
    q = dt(total) / dt(count)
    return int(np.sign(q) * np.floor(abs(float(q)) + 0.5))


def top(values: torch.Tensor, candidates: torch.Tensor, k: int,
        descending: bool = True) -> torch.Tensor:
    """The candidates whose value is among the ``k`` best, every tie of
    the k-th included: a mask over ``values``."""
    m = int(candidates.sum())
    if m <= k:
        return candidates
    v = values[candidates]
    kth = torch.topk(v, k, largest=descending).values[-1]
    keep = values >= kth if descending else values <= kth
    return candidates & keep


def add_months(day: str, months: int) -> int:
    """Days of ``day`` (an ISO date on the first of a month) plus
    ``months`` months."""
    m = np.datetime64(day, "M") + np.timedelta64(months, "M")
    return int((m.astype("datetime64[D]") - EPOCH).astype(int))


def iso(day: int) -> str:
    return str(EPOCH + np.timedelta64(int(day), "D"))


def days(s: str) -> int:
    return int((np.datetime64(s) - EPOCH).astype(int))


def group(keys: list[torch.Tensor]):
    """Group rows by the tuple of ``keys`` (int tensors): (the groups'
    key columns on the host, each row's group id, the group count)."""
    stacked = torch.stack([k.long() for k in keys], dim=1)
    uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
    return uniq.cpu().numpy(), inv, uniq.shape[0]


def ordered(rows: list[tuple], order: list[tuple[int, bool]],
            limit: int | None) -> list[tuple]:
    """``rows`` sorted by ``order`` ((column, descending) pairs; NULLs
    last), cut at ``limit`` but keeping every row that ties the last
    one kept on all the order's columns."""
    def key(r):
        parts = []
        for c, desc in order:
            v = r[c]
            parts.append((v is None, _Rev(v) if desc else v))
        return parts
    rows = sorted(rows, key=key)
    if limit is None or len(rows) <= limit:
        return rows
    last = [rows[limit - 1][c] for c, _ in order]
    end = limit
    while end < len(rows) and [rows[end][c] for c, _ in order] == last:
        end += 1
    return rows[:end]


class _Rev:
    """Reverses the order of a value in a sort key."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v
