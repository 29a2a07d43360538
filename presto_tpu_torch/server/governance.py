"""Query lifetime enforcement: the coordinator's reaper thread.

Analog of the reference QueryTracker's enforceTimeLimits sweep
(execution/QueryTracker.java:175 — a periodic task failing queries past
``query_max_run_time`` / ``query_max_queued_time``). The engine already
enforces the run-time limit cooperatively at host-side checkpoints
(exec/cancel.py deadline); the reaper covers what checkpoints cannot:

- a query stuck QUEUED behind a saturated resource group past its
  ``query_max_queued_time`` fails loudly without ever running;
- a RUNNING query past ``query_max_run_time`` is failed immediately at
  the protocol level (the client stops waiting NOW), its cancel token
  killed so the planner/compiler/executor abort at their next seam, and
  its in-flight worker fragment tasks DELETEd by query-id prefix so
  workers stop burning device time on a result nobody will read.

The sweep itself never raises: governance must not die with one
malformed query.
"""

from __future__ import annotations

import threading
import time

from presto_tpu_torch.obs.metrics import REGISTRY

REAPED = REGISTRY.counter(
    "presto_tpu_query_timeout_total",
    "queries failed by the lifetime reaper, by exceeded limit")


class QueryReaper:
    """Periodic lifetime sweep over a QueryManager's tracked queries."""

    def __init__(self, manager, interval_s: float = 0.2):
        self.manager = manager
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "QueryReaper":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="presto-tpu-reaper")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval_s + 5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 - governance never dies
                pass

    def sweep(self) -> None:
        """One pass: fail every query past its lifetime limits. The
        per-query header override wins — including an explicit 0
        (unlimited), so the fallback to the shared engine session
        applies only when the query carries no override at all; the
        property names are spelled literally so the dead-config
        tripwire in test_config sees each one consumed."""
        mgr = self.manager
        sess = mgr.engine.session
        now = time.monotonic()
        for q in mgr.snapshot():
            if q.state == "QUEUED":
                value = q.session_properties.get(
                    "query_max_queued_time")
                if value is None:
                    value = sess.get("query_max_queued_time")
                limit = float(value or 0)
                if limit > 0 and now - q.created > limit:
                    mgr.reap(
                        q, f"query exceeded query_max_queued_time "
                           f"({limit:g}s queued waiting for a "
                           f"resource-group slot)", kind="queued")
            elif q.state == "RUNNING":
                value = q.session_properties.get("query_max_run_time")
                if value is None:
                    value = sess.get("query_max_run_time")
                limit = float(value or 0)
                started = q.started or q.created
                if limit > 0 and now - started > limit:
                    mgr.reap(
                        q, f"query exceeded query_max_run_time "
                           f"({limit:g}s)", kind="run")
            elif q.state == "FINISHED":
                # abandoned result stream: the query finished with
                # pages still queued (result smaller than the queue
                # bound, so the producer never blocked and its own
                # idle-abort could not fire) and no client fetched
                # for the idle window — release the buffered pages
                # and their depth-gauge contribution, or every
                # crashed-after-submit client pins them for the
                # server's lifetime
                queue = q.result
                if (queue is not None and queue.depth > 0
                        and q.finished is not None
                        and now - q.finished > queue.IDLE_ABORT_S):
                    queue.fail(
                        "result abandoned: no page fetched for "
                        f"{queue.IDLE_ABORT_S:.0f}s after completion")
