"""Structured JSON logging (one JSON object per line; a copy of
``presto_tpu/obs/jsonlog.py`` with its import rewritten).

The repo previously had ZERO logging — servers ran silent (the base
handler even stubs ``log_message``). This writer is the minimal
structured analog of the reference's airlift log + QueryMonitor event
log: every record is one machine-parseable line with a wall-clock
timestamp, an event name, and flat fields, so an aggregator (or grep)
can follow a query across coordinator and worker processes via its
``trace_id``.

Disabled by default (tests and library use stay silent); enable with
the ``PRESTO_TPU_LOG`` environment variable (``stderr``, ``stdout``,
or a file path) or programmatically via :func:`configure`. Lifecycle
events (events.py) and worker task execution log here automatically
once enabled.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


class JsonLogWriter:
    """Thread-safe line-oriented JSON log sink."""

    def __init__(self, stream=None):
        self._lock = threading.Lock()
        self._stream = stream

    def configure(self, target) -> None:
        """``target``: "stderr", "stdout", a file path, an open
        file-like object, or None to disable."""
        stream = target
        if target == "stderr":
            stream = sys.stderr
        elif target == "stdout":
            stream = sys.stdout
        elif isinstance(target, str):
            stream = open(target, "a", encoding="utf-8")  # noqa: SIM115
        with self._lock:
            self._stream = stream

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._stream is not None

    def log(self, event: str, **fields) -> None:
        with self._lock:
            stream = self._stream
            if stream is None:
                return
            record = {"ts": round(time.time(), 6), "event": event}
            from presto_tpu_torch.obs.trace import current_context
            ctx = current_context()
            if ctx is not None:
                record["trace_id"] = ctx[0]
            record.update(fields)
            try:
                stream.write(json.dumps(record, default=str) + "\n")
                stream.flush()
            except (OSError, ValueError):
                pass  # a dead sink must never fail the query


LOG = JsonLogWriter()

if os.environ.get("PRESTO_TPU_LOG"):
    LOG.configure(os.environ["PRESTO_TPU_LOG"])


def configure(target) -> None:
    LOG.configure(target)
