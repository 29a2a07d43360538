"""Distributed span tracer with explicit context propagation (a copy
of ``presto_tpu/obs/trace.py``).

The analog of later Trino's OpenTelemetry integration (spans around
query dispatch, planning, and every coordinator->worker task call,
io.trino.tracing.TrinoAttributes): a :class:`Span` records one timed
unit of work; the ambient (trace_id, span_id) context lives in a
``contextvars.ContextVar`` so engine internals can instrument
unconditionally — ``span()`` is a no-op when no trace is active, which
also bounds the store to queries someone traces: an HTTP-admitted
query (the server opens its trace), a worker task attached to the
coordinator's context, or a caller's own ``TRACER.trace``. A direct
``Engine.execute`` outside any trace records nothing, and each span
site then costs one ``ContextVar`` lookup.

Every span is stamped by :func:`clock` (epoch seconds), the one clock
that the Chrome export, a worker merge and a device-trace alignment
share. Span ids are a per-process random prefix and a counter, unique
across the processes whose spans :meth:`Tracer.import_spans` merges.
Spans past ``MAX_SPANS_PER_TRACE`` in one trace are dropped and counted
in ``presto_tpu_trace_spans_dropped_total``.

Cross-process propagation is explicit: the coordinator serializes the
current context into the ``X-Presto-TPU-Trace`` request header on task
POSTs (parallel/coordinator.py), and the worker HTTP handler
re-attaches it so worker-side spans parent under the coordinator's
task-dispatch span. Thread hops (dispatch pools, async task threads)
propagate the same way via :func:`current_context` + ``attach`` —
``ThreadPoolExecutor`` does NOT copy contextvars into its workers.

Per-trace spans export as Chrome trace-event JSON
(``GET /v1/query/{id}/trace`` on the coordinator, ``/v1/trace/{id}``
on workers for external cross-process collection), loadable in
Perfetto / ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import secrets
import threading
import time
from collections import OrderedDict

from presto_tpu_torch.obs.metrics import REGISTRY

TRACE_HEADER = "X-Presto-TPU-Trace"

_CURRENT: contextvars.ContextVar[tuple[str, str] | None] = \
    contextvars.ContextVar("presto_tpu_trace", default=None)

# ambient node name (worker id / "coordinator") stamped onto spans that
# don't set one: engine internals recording inside a worker's attached
# context land in that worker's process lane in the export
_NODE: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("presto_tpu_trace_node", default=None)

MAX_TRACES = 256
MAX_SPANS_PER_TRACE = 4096


_DROPPED = REGISTRY.counter(
    "presto_tpu_trace_spans_dropped_total",
    "spans not recorded because their trace held MAX_SPANS_PER_TRACE")


def clock() -> float:
    """The spans' clock: wall-clock epoch seconds (``time.time()``)."""
    return time.time()


def _reseed_ids() -> None:
    global _ID_PREFIX, _ID_SEQ
    _ID_PREFIX = f"{secrets.randbits(32):08x}"
    _ID_SEQ = itertools.count(1)


_reseed_ids()
# a forked child must not repeat its parent's ids
os.register_at_fork(after_in_child=_reseed_ids)


def _new_span_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_SEQ):08x}"


@dataclasses.dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    attrs: dict
    t0: float               # wall clock, seconds (clock())
    t1: float | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"),
                   d["name"], dict(d.get("attrs") or {}), d["t0"],
                   d.get("t1"))


def current_context() -> tuple[str, str] | None:
    """The ambient (trace_id, span_id), for explicit handoff across
    thread pools and HTTP hops."""
    return _CURRENT.get()


def format_context(ctx: tuple[str, str]) -> str:
    return f"{ctx[0]}:{ctx[1]}"


def parse_context(value: str | None) -> tuple[str, str] | None:
    """Parse an ``X-Presto-TPU-Trace`` header; malformed values are
    ignored (an untraced or hostile peer must not break the task)."""
    if not value or ":" not in value:
        return None
    trace_id, _, span_id = value.partition(":")
    trace_id, span_id = trace_id.strip(), span_id.strip()
    if not trace_id or not span_id or len(value) > 256:
        return None
    return trace_id, span_id


def trace_headers() -> dict:
    """Header dict propagating the current context (empty when
    untraced) — merge into outgoing internal HTTP requests."""
    ctx = _CURRENT.get()
    if ctx is None:
        return {}
    return {TRACE_HEADER: format_context(ctx)}


class Tracer:
    """Thread-safe per-trace span store + context management."""

    def __init__(self, max_traces: int = MAX_TRACES,
                 max_spans: int = MAX_SPANS_PER_TRACE):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, list[Span]] = OrderedDict()

    def _record(self, span: Span) -> None:
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                spans = self._traces[span.trace_id] = []
            if len(spans) < self.max_spans:
                spans.append(span)
                return
        _DROPPED.inc()

    # -- span creation ------------------------------------------------------

    def trace(self, trace_id: str, name: str, **attrs):
        """Open a ROOT span with an explicit trace id (query
        admission: the trace id IS the query id). A context manager
        that yields the span."""
        return _Scope(self, self._new(trace_id, None, name, attrs))

    def span(self, name: str, **attrs):
        """Child span of the ambient context, a context manager that
        yields it; yields None (and records nothing) when no trace is
        active."""
        ctx = _CURRENT.get()
        if ctx is None:
            return _UNTRACED
        return _Scope(self, self._new(ctx[0], ctx[1], name, attrs))

    @staticmethod
    def _new(trace_id: str, parent: str | None, name: str,
             attrs: dict) -> Span:
        if "node" not in attrs:
            node = _NODE.get()
            if node is not None:
                attrs["node"] = node
        return Span(trace_id, _new_span_id(), parent, name, attrs,
                    clock())

    def instant_for(self, trace_id: str, name: str,
                    create: bool = False, **attrs) -> None:
        """Zero-duration marker recorded into an EXPLICIT trace.
        Governance events happen on threads with no ambient trace
        context — the reaper sweep, the low-memory killer, 429/503
        shed decisions — yet belong on the query's timeline; the query
        id IS the trace id, so they can address it directly. With
        ``create`` False the marker only lands on traces that already
        exist (the memory killer's victim tag is a query id only for
        the query-level pool); True records unconditionally (a shed
        query's trace may consist of nothing but its shed marker)."""
        with self._lock:
            exists = trace_id in self._traces
        if not exists and not create:
            return
        attrs["instant"] = True
        span = self._new(trace_id, None, name, attrs)
        span.t1 = span.t0
        self._record(span)

    def add_span(self, name: str, t0: float, t1: float,
                 **attrs) -> None:
        """Record an already-finished interval under the ambient
        context (e.g. queue-admission wait measured retroactively)."""
        ctx = _CURRENT.get()
        if ctx is None:
            return
        span = self._new(ctx[0], ctx[1], name, attrs)
        span.t0, span.t1 = t0, t1
        self._record(span)

    @contextlib.contextmanager
    def attach(self, ctx: tuple[str, str] | None,
               node: str | None = None):
        """Re-enter a captured or header-propagated context in another
        thread/process; spans opened inside parent to ``ctx``'s span.
        ``node`` sets the ambient node name stamped onto those spans
        (workers pass their node id so even engine-internal spans land
        in the right process lane)."""
        if ctx is None and node is None:
            yield
            return
        ctx_token = (_CURRENT.set((ctx[0], ctx[1]))
                     if ctx is not None else None)
        node_token = _NODE.set(node) if node is not None else None
        try:
            yield
        finally:
            if ctx_token is not None:
                _CURRENT.reset(ctx_token)
            if node_token is not None:
                _NODE.reset(node_token)

    # -- export -------------------------------------------------------------

    def spans(self, trace_id: str) -> list[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> list[str]:
        """The ids of the traces in the store, oldest first."""
        with self._lock:
            return list(self._traces)

    def import_spans(self, dicts: list[dict]) -> None:
        """Merge remote spans (a worker's ``/v1/trace/{id}`` payload)
        into this store for unified export."""
        for d in dicts:
            self._record(Span.from_dict(d))

    def chrome_trace(self, trace_id: str) -> dict:
        """Chrome trace-event JSON (Perfetto/chrome://tracing): one
        complete ("X") event per finished span, grouped into one
        process lane per ``node`` attr, plus span/parent ids in
        ``args`` so the tree survives the format."""
        spans = self.spans(trace_id)
        now = clock()
        pids: dict[str, int] = {}
        events: list[dict] = []
        for s in spans:
            node = str(s.attrs.get("node", "coordinator"))
            pid = pids.get(node)
            if pid is None:
                pid = pids[node] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": node}})
            args = {k: v for k, v in s.attrs.items() if k != "node"}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.attrs.get("instant"):
                # governance markers (reaper/low-memory kills, shed
                # decisions) render as global instant events so the
                # incident is visible ON the timeline, not just in
                # counters
                events.append({
                    "name": s.name, "cat": "query", "ph": "i",
                    "s": "g", "ts": int(s.t0 * 1e6),
                    "pid": pid, "tid": 0, "args": args})
                continue
            if s.t1 is None:
                args["in_progress"] = True
            events.append({
                "name": s.name, "cat": "query", "ph": "X",
                "ts": int(s.t0 * 1e6),
                "dur": max(0, int(((s.t1 if s.t1 is not None else now)
                                   - s.t0) * 1e6)),
                "pid": pid, "tid": 0, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class _Scope:
    """An open span: recorded when entered, the ambient context while
    open, stamped and the context restored when left."""

    __slots__ = ("tracer", "span", "token")

    def __init__(self, tracer: Tracer, span: Span):
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        span = self.span
        self.tracer._record(span)
        self.token = _CURRENT.set((span.trace_id, span.span_id))
        return span

    def __exit__(self, *exc) -> None:
        self.span.t1 = clock()
        _CURRENT.reset(self.token)


# what span() returns outside a trace: enters to None, records nothing
_UNTRACED = contextlib.nullcontext()

# the process-wide default tracer: servers, engine, and executor layers
# all record here; an in-process cluster therefore exports unified
# traces, and separate worker processes expose theirs at /v1/trace/{id}
TRACER = Tracer()
