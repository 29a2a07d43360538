"""Query lifecycle events + pluggable listeners (the port of
``presto_tpu/events.py``).

Analog of the reference's event system (event/QueryMonitor.java:134,210
queryCreatedEvent/queryCompletedEvent -> EventListenerManager -> SPI
spi/eventlistener/EventListener.java): the engine emits a created event
when a query is admitted and a completed event with statistics when it
finishes; listeners are plain callables registered on the engine.
Recent completed events also back the system.runtime.queries table.

``monitored()`` is also the engine-level tracing entry: inside an open
trace (the HTTP server's, a worker's attached context, a caller's own
``TRACER.trace``) it opens the query's ``query`` span (obs/trace.py);
outside one it records nothing, so an untraced query pays no span.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np

from presto_tpu_torch.obs.jsonlog import LOG
from presto_tpu_torch.obs.trace import TRACER


@dataclasses.dataclass
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str
    create_time: float


@dataclasses.dataclass
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    state: str           # FINISHED | FAILED
    create_time: float
    end_time: float
    output_rows: int
    error: str | None = None

    @property
    def elapsed_ms(self) -> float:
        return (self.end_time - self.create_time) * 1000.0


class EventListenerManager:
    """Dispatches lifecycle events to registered listeners and keeps a
    bounded history for system.runtime.queries (reference
    EventListenerManager + QuerySystemTable). Thread-safe: the HTTP
    server runs queries on a pool, so id allocation, listener
    registration, and the history ring are all lock-guarded."""

    def __init__(self, history: int = 1000):
        self._lock = threading.Lock()
        self._listeners: list[Callable] = []
        self._history: deque = deque(maxlen=history)
        self._seq = 0

    def add_listener(self, fn: Callable) -> None:
        with self._lock:
            self._listeners.append(fn)

    def next_query_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"q_{self._seq:08d}"

    @property
    def history(self) -> list:
        """Snapshot of recent completed events (system.runtime.queries
        reads this while pool threads append)."""
        with self._lock:
            return list(self._history)

    def query_created(self, event: QueryCreatedEvent) -> None:
        self._emit(event)

    def query_completed(self, event: QueryCompletedEvent) -> None:
        with self._lock:
            self._history.append(event)
        LOG.log("query_completed", query_id=event.query_id,
                user=event.user, state=event.state,
                elapsed_ms=round(event.elapsed_ms, 3),
                rows=event.output_rows, error=event.error)
        self._emit(event)

    def _emit(self, event) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:
                # a broken listener must not fail the query (reference
                # EventListenerManager swallows listener errors too)
                pass


def monitored(engine, sql: str, run: Callable):
    """Run ``run()`` under query monitoring: emits created/completed
    events, records history, opens the query's ``query`` span when a
    trace is active (none otherwise) and opens the query's runtime-stats
    scope (obs/qstats.py; reused when a caller already opened one, so
    the stats id and the trace id coincide). The completed event fires
    INSIDE the stats scope: history listeners snapshot the finished
    tree off the ambient recorder. Returns run()'s result.

    Under ``SET SESSION device_profile = true`` the query runs inside a
    ``torch.profiler`` capture (``obs/devprof``; the CUDA activity on a
    CUDA engine), whose artifact directory goes into the query record
    (``profile_artifact``) before the query runs. It reads no tensor:
    the output rows are counted from the host result (a list of rows,
    or a host Table and its numpy mask)."""
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.obs import qstats as QS
    mgr: EventListenerManager = engine.events
    qid = mgr.next_query_id()
    t0 = time.time()
    user = engine.session.user
    want_profile = bool(engine.session.get("device_profile"))
    mgr.query_created(QueryCreatedEvent(qid, sql, user, t0))
    with QS.query_or_current(qid, sql, user) as qr, \
            TRACER.span("query", query_id=qid, user=user,
                        sql=sql[:200]) as sp, \
            devprof.maybe_capture(
                want_profile, qid,
                str(getattr(engine, "device", "")).startswith("cuda")
            ) as prof_dir:
        if prof_dir is not None:
            # known up front: history snapshots taken mid-query already
            # link the artifact directory
            qr.profile_artifact = prof_dir
        try:
            result = run()
        except Exception as exc:
            if sp is not None:
                sp.attrs["error"] = f"{type(exc).__name__}: {exc}"
            qr.state = "FAILED"
            qr.error = f"{type(exc).__name__}: {exc}"[:300]
            mgr.query_completed(QueryCompletedEvent(
                qid, sql, user, "FAILED", t0, time.time(), 0,
                error=f"{type(exc).__name__}: {exc}"))
            raise
        if isinstance(result, list):
            rows = len(result)
        else:
            mask = getattr(result, "mask", None)
            if mask is not None:
                rows = int(np.asarray(mask).sum())
            else:
                rows = getattr(result, "nrows", 0)
        qr.output_rows = rows
        mgr.query_completed(QueryCompletedEvent(
            qid, sql, user, "FINISHED", t0, time.time(), rows))
    return result
