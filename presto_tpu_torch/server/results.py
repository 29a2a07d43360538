"""Streaming result delivery: bounded per-query page queues.

The protocol layer's half of ROADMAP item 1: the old coordinator
materialized an ENTIRE query result into JSON-ready Python lists
(``q.rows``) before paging it out — at serve-mode QPS that is a serde
bottleneck and a ~10-100x memory amplifier (a Python list-of-lists of
boxed values over what the engine holds columnar), and a large SELECT
pinned O(result) protocol memory for its whole lifetime.

Now the execute path hands finished result pages to a
:class:`ResultQueue` incrementally: pages are decoded (JSON mode) or
Arrow-encoded (``X-Presto-TPU-Result: arrow`` mode) FROM THE COLUMNAR
RESULT one ``PAGE_ROWS`` slice at a time, ``nextUri`` fetches pop them
on demand, and the producer BLOCKS on a full queue — backpressure, the
protocol twin of the exchange OutputBuffer (parallel/buffer.py): a
slow client throttles the producer instead of growing the heap, the
coordinator holds O(page) protocol memory, and a producer abandoned by
its client aborts after ``IDLE_ABORT_S`` instead of pinning a
dispatcher thread forever. Reaper kills and client DELETEs wake a
blocked producer through its cancel token (checked every wait turn,
the MemoryPool discipline).

Token semantics mirror the exchange buffer: requesting token T
acknowledges (frees) pages below T, a re-request of the current token
is idempotent (client retry), and a request below the freed watermark
fails loudly rather than serving holes.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.obs.metrics import REGISTRY

_DEPTH = REGISTRY.gauge(
    "presto_tpu_result_page_queue_depth",
    "result pages buffered between query producers and protocol "
    "clients, summed over in-flight queries (bounded per query by "
    "PRESTO_TPU_RESULT_QUEUE_PAGES)")


class ResultAbandoned(RuntimeError):
    """The result stream was failed (cancel, reap, idle abort)."""


class ResultQueue:
    """One query's bounded result-page pipe (single consumer — the
    protocol client advancing continuation tokens)."""

    # a producer blocked this long with NO page acknowledged aborts:
    # a vanished client must not pin its dispatcher thread + pages
    IDLE_ABORT_S = 300.0

    def __init__(self, max_pages: int, owner=None):
        self.max_pages = max(1, int(max_pages))
        self.owner = owner  # exec/cancel.CancelToken | None
        self._cv = threading.Condition()
        self._pages: list = []  # deque window; absolute base _freed
        self._rows: list[int] = []
        self._freed = 0    # tokens below this are acknowledged+freed
        self._emitted = 0  # total pages produced
        self._closed = False
        self._failed: str | None = None
        self.rows_emitted = 0
        self.peak_depth = 0

    # -- producer side ---------------------------------------------------

    def put(self, payload, nrows: int) -> None:
        """Append one result page; BLOCKS while the queue is full
        (backpressure). The owner token is checked every wait turn so
        a canceled/reaped query raises its attributable exception
        promptly instead of sitting out the idle deadline."""
        with self._cv:
            idle = 0.0
            while (len(self._pages) >= self.max_pages
                   and self._failed is None):
                if self.owner is not None:
                    check = getattr(self.owner, "check", None)
                    if callable(check):
                        check()
                before = self._freed
                self._cv.wait(timeout=0.25)
                if self._freed > before:
                    idle = 0.0
                else:
                    idle += 0.25
                    if idle >= self.IDLE_ABORT_S:
                        self._fail_locked(
                            "client idle timeout: no result page "
                            f"fetched for {self.IDLE_ABORT_S:.0f}s")
                        break
            if self._failed is not None:
                raise ResultAbandoned(self._failed)
            self._pages.append(payload)
            self._rows.append(int(nrows))
            self._emitted += 1
            self.rows_emitted += int(nrows)
            self.peak_depth = max(self.peak_depth, len(self._pages))
            _DEPTH.inc()
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def fail(self, message: str) -> None:
        """Abort the stream: wakes a blocked producer (which raises
        ResultAbandoned unless its cancel token raises first) and any
        polling consumer."""
        with self._cv:
            self._fail_locked(message)

    def _fail_locked(self, message: str) -> None:
        """Abort under the condition: every failure path (fail(),
        idle abort) must release the buffered pages AND their depth-
        gauge contribution, or abandoned queries pin pages forever
        and the gauge drifts permanently upward."""
        if self._failed is None:
            self._failed = str(message)[:500]
        _DEPTH.dec(len(self._pages))
        self._pages.clear()
        self._rows.clear()
        self._cv.notify_all()

    # -- consumer side ---------------------------------------------------

    def get(self, token: int, poll_s: float = 0.5):
        """(payload | None, next_token, drained): the page at
        ``token``, acknowledging (freeing) every page below it.
        Long-polls briefly when the page is not produced yet; (None,
        token, False) means poll again, (None, token, True) means the
        stream is drained."""
        with self._cv:
            if self._failed is not None:
                raise ResultAbandoned(self._failed)
            if token < self._freed:
                raise ResultAbandoned(
                    f"result page {token} was already acknowledged "
                    "and released (tokens advance monotonically)")
            while self._freed < min(token, self._emitted):
                self._pages.pop(0)
                self._rows.pop(0)
                self._freed += 1
                _DEPTH.dec()
                self._cv.notify_all()
            deadline = time.monotonic() + poll_s
            while (token >= self._emitted and not self._closed
                   and self._failed is None
                   and time.monotonic() < deadline):
                self._cv.wait(timeout=0.05)
            if self._failed is not None:
                raise ResultAbandoned(self._failed)
            if token < self._emitted:
                return (self._pages[token - self._freed], token + 1,
                        False)
            return None, token, self._closed

    @property
    def drained(self) -> bool:
        with self._cv:
            return self._closed and not self._pages

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._pages)


# -- page production over a columnar result ---------------------------------


def json_value(v, dtype: T.DataType):
    """One result value in the protocol's JSON encoding (reference
    client wire types). Shared by the server's JSON pages and the
    arrow-mode client, so both paths produce byte-identical rows."""
    if v is None:
        return None
    if isinstance(dtype, T.DecimalType):
        return f"{v:.{dtype.scale}f}"
    if isinstance(dtype, T.DateType):
        return str(v)
    if isinstance(dtype, T.TimestampType):
        # Trino wire format: 'YYYY-MM-DD HH:MM:SS.fff'
        return str(v).replace("T", " ")
    if isinstance(v, np.timedelta64):
        us = int(v.astype("timedelta64[us]").astype(np.int64))
        h, rem = divmod(us, 3_600_000_000)
        m, rem = divmod(rem, 60_000_000)
        sec, frac = divmod(rem, 1_000_000)
        return (f"{h:02d}:{m:02d}:{sec:02d}.{frac:06d}" if frac
                else f"{h:02d}:{m:02d}:{sec:02d}")
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.str_):
        return str(v)
    if isinstance(v, np.datetime64):
        return str(v)
    return v


def compact_table(table):
    """(columns dict with dead rows dropped, live row count): applied
    ONCE per result, so page slices below are plain views."""
    from presto_tpu_torch.block import Column

    if table.mask is None:
        return dict(table.columns), int(table.nrows)
    mask = np.asarray(table.mask)
    out = {}
    for name, c in table.columns.items():
        out[name] = Column(
            c.dtype, np.asarray(c.data)[mask],
            None if c.valid is None else np.asarray(c.valid)[mask],
            c.dictionary)
    return out, int(mask.sum())


def page_slice(cols: dict, start: int, stop: int) -> dict:
    """Zero-copy column views of rows [start, stop)."""
    from presto_tpu_torch.block import Column

    return {
        name: Column(
            c.dtype, np.asarray(c.data)[start:stop],
            None if c.valid is None
            else np.asarray(c.valid)[start:stop],
            c.dictionary)
        for name, c in cols.items()}


def json_rows(cols: dict, nrows: int) -> list[list]:
    """Decode one page's columns to protocol JSON rows."""
    from presto_tpu_torch.block import Table

    dtypes = [c.dtype for c in cols.values()]
    return [
        [json_value(v, t) for v, t in zip(row, dtypes)]
        for row in Table(cols, nrows).to_pylist()]


def rows_from_wire_page(payload) -> list[list]:
    """Arrow-mode client decode: one wire page -> the SAME JSON-style
    rows the buffered/JSON path yields (byte-identical results across
    result modes is the oracle the data-plane tests pin)."""
    from presto_tpu_torch.parallel.wire import bytes_to_columns

    cols, nrows = bytes_to_columns(payload)
    return json_rows(cols, nrows)
