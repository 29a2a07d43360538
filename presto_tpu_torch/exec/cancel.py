"""Cooperative query cancellation + run-time limits.

A monolithic XLA program cannot be interrupted mid-flight, so the
engine checks a per-thread cancellation token at every host-side
checkpoint: between capacity-retry compiles, between streamed scan
blocks, between spill partitions, and inside latency-simulating
connector scans. The reference reaches the same points through
QueryStateMachine transitions + Driver yield
(execution/QueryTracker enforced timeouts, Driver.processFor quanta);
here the quanta are the host-visible seams of device execution.

The token is thread-local because the server's dispatcher pool runs
each query wholly on one thread (server/server.py QueryManager).
"""

from __future__ import annotations

import threading
import time


class QueryCanceled(RuntimeError):
    """Raised at a checkpoint after cancel() or past the deadline."""


class TimeLimitExceeded(QueryCanceled):
    """A query lifetime limit (query_max_run_time at a checkpoint
    deadline, query_max_planning_time at a planning seam) was
    exceeded. Distinct from a user cancellation so the protocol layer
    reports FAILED + errorName EXCEEDED_TIME_LIMIT, not CANCELED."""


_state = threading.local()


class CancelToken:
    def __init__(self, deadline: float | None = None):
        self._event = threading.Event()
        self.deadline = deadline
        # set by kill(): the exception class/message the next checkpoint
        # raises INSTEAD of the generic QueryCanceled — the low-memory
        # killer and the lifetime reaper die loudly with an
        # attributable error (MemoryKilledError, timeout), not a
        # silent cancellation. Written before the Event is set, so a
        # checkpoint that observes the flag sees the exception too.
        self.kill_exc: BaseException | None = None

    def cancel(self) -> None:
        self._event.set()

    def kill(self, exc: BaseException) -> None:
        """Cancel with a specific exception raised at checkpoints."""
        self.kill_exc = exc
        self._event.set()

    def check(self) -> None:
        if self._event.is_set():
            exc = self.kill_exc
            if exc is not None:
                # a fresh instance per raising thread: tracebacks of
                # concurrent checkpoints must not chain onto one object
                raise type(exc)(str(exc))
            raise QueryCanceled("query canceled")
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise TimeLimitExceeded("query exceeded query_max_run_time")


def install(token: CancelToken | None) -> None:
    _state.token = token


def current() -> CancelToken | None:
    return getattr(_state, "token", None)


def checkpoint() -> None:
    token = getattr(_state, "token", None)
    if token is not None:
        token.check()
