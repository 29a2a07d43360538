"""Retry/backoff/deadline discipline for the distributed control plane.

The analog of Trino's fault-tolerant-execution retry machinery
(``retry-policy=QUERY|TASK``, io.trino.execution.QueryStateMachine +
io.airlift Backoff): every coordinator->worker RPC and worker->worker
exchange fetch routes through one :func:`retrying_call` helper that

- classifies failures as TRANSIENT (node died, connection refused,
  timeout, HTTP 502/503/504 — retrying elsewhere or later can succeed)
  vs APPLICATION errors (the task itself failed deterministically:
  ``TaskError`` / ``TaskFailed`` semantics — retrying would fail
  identically), and never retries the latter;
- backs off exponentially with FULL JITTER (sleep ~ U[0, min(cap,
  base*mult^attempt)] — the AWS-style decorrelated variant that avoids
  retry convoys when W workers retry the same dead peer at once);
- charges every retry against a per-query :class:`Deadline` budget so
  a flapping cluster fails loudly instead of retrying forever.

Retries are observable: each one increments
``presto_tpu_call_retries_total{op=...}`` and records a ``retry`` span
under the ambient trace (obs/trace.py), so a query's recovery shows up
in /metrics and the Chrome trace export.
"""

from __future__ import annotations

import dataclasses
import http.client
import random
import time
import urllib.error

from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.metrics import REGISTRY

# retry policies (session property ``retry_policy``, the analog of
# Trino's retry-policy): NONE fails the query on the first task/node
# failure, QUERY re-runs the whole fragmented attempt on the surviving
# workers, TASK re-dispatches only the failed fragment tasks over the
# spooled exchange (ft/spool.py).
RETRY_POLICIES = ("NONE", "QUERY", "TASK")

_CALL_RETRIES = REGISTRY.counter(
    "presto_tpu_call_retries_total",
    "transient-failure retries of internal HTTP calls, by operation")

# HTTP statuses that mean "the node cannot take this request right now"
# (drain 503, proxy 502/504) — transient by contract; anything else the
# worker answered deliberately (application error).
TRANSIENT_HTTP_CODES = (502, 503, 504)


class DeadlineExceeded(RuntimeError):
    """The query's retry budget (``retry_deadline_s``) ran out."""


class ExchangeFetchError(RuntimeError):
    """A worker could not pull a producer task's pages. Carries the
    producer coordinates in a parseable form so the coordinator's
    TASK-retry path can repair the exchange (re-point the consumer at
    a surviving worker's spool, or re-run just that producer task)."""

    def __init__(self, task_id: str, part: int, uri: str, cause: str):
        super().__init__(
            f"exchange-fetch-failed task_id={task_id} part={part} "
            f"uri={uri}: {cause}")
        self.task_id = task_id
        self.part = part
        self.uri = uri


def parse_exchange_failure(message: str) -> tuple[str, str] | None:
    """(task_id, uri) out of an ExchangeFetchError message that crossed
    an HTTP error boundary as text; None when the message is not one."""
    import re
    m = re.search(r"exchange-fetch-failed task_id=(\S+) part=\d+ "
                  r"uri=(\S+):", message)
    if m is None:
        return None
    return m.group(1), m.group(2)


def is_transient(exc: BaseException) -> bool:
    """Transient (retry can help) vs application (deterministic)
    failure classification, shared by every retry site."""
    # local import: parallel/ imports this module at load time
    from presto_tpu_torch.parallel.buffer import TaskFailed
    from presto_tpu_torch.parallel.coordinator import TaskError
    if isinstance(exc, DeadlineExceeded):
        return False
    if isinstance(exc, ExchangeFetchError):
        # needs exchange REPAIR (coordinator-level), not a blind retry
        return False
    if isinstance(exc, (TaskError, TaskFailed)):
        return False
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in TRANSIENT_HTTP_CODES
    if isinstance(exc, (urllib.error.URLError, TimeoutError, OSError,
                        http.client.HTTPException)):
        return True
    return False


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Bounded exponential backoff with full jitter."""

    attempts: int = 3                # total tries, including the first
    initial_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0

    def delay_s(self, attempt: int,
                rng: random.Random | None = None) -> float:
        """Sleep before retry number ``attempt`` (0-based): full jitter
        over the exponentially growing cap."""
        cap = min(self.max_delay_s,
                  self.initial_delay_s * self.multiplier ** attempt)
        u = rng.random() if rng is not None else random.random()
        return u * cap


class Deadline:
    """Per-query wall-clock retry budget. ``budget_s`` <= 0 means
    unlimited (the reference's default: retries bounded by attempts
    only)."""

    def __init__(self, budget_s: float = 0.0):
        self.budget_s = float(budget_s)
        self._t0 = time.monotonic()

    @property
    def unlimited(self) -> bool:
        return self.budget_s <= 0

    def remaining_s(self) -> float:
        if self.unlimited:
            return float("inf")
        return self.budget_s - (time.monotonic() - self._t0)

    @property
    def expired(self) -> bool:
        return not self.unlimited and self.remaining_s() <= 0

    def check(self, op: str) -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"retry deadline of {self.budget_s:.1f}s exhausted "
                f"during {op}")

    def clamp(self, timeout_s: float) -> float:
        """Cap an individual call timeout to the remaining budget."""
        if self.unlimited:
            return timeout_s
        return max(0.001, min(timeout_s, self.remaining_s()))


def retrying_call(fn, *, op: str,
                  backoff: BackoffPolicy | None = None,
                  deadline: Deadline | None = None,
                  classify=is_transient,
                  rng: random.Random | None = None,
                  sleep=time.sleep):
    """Run ``fn()`` with transient-failure retries under ``backoff``
    and the optional ``deadline`` budget. Application errors and
    exhausted budgets propagate; every retry is counted and spanned."""
    policy = backoff if backoff is not None else BackoffPolicy()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - classified below
            if not classify(exc) or attempt + 1 >= policy.attempts:
                raise
            if deadline is not None:
                deadline.check(op)
            delay = policy.delay_s(attempt, rng)
            _CALL_RETRIES.inc(op=op)
            with OT.TRACER.span("retry", op=op, attempt=attempt,
                                delay_s=round(delay, 4),
                                error=f"{type(exc).__name__}: "
                                      f"{str(exc)[:200]}"):
                sleep(delay)
            attempt += 1


def backoff_from_session(session, attempts: int) -> BackoffPolicy:
    """Build the session-configured backoff (the same delay knobs serve
    task- and query-level retries; only the attempt bound differs)."""
    return BackoffPolicy(
        attempts=max(1, int(attempts)),
        initial_delay_s=float(session.get("retry_initial_delay_s")),
        max_delay_s=float(session.get("retry_max_delay_s")))
