"""Deterministic fault injection for chaos-testing the cluster (the port
of ``presto_tpu/ft/faults.py``).

Named fault points sit at explicit call sites in the distributed
control plane (worker task intake, exchange page fetch, heartbeat
ping, task POST). The reference's ``compile-slow`` point stays in the
registry, so a fault spec names the same points in both packages, but
no site fires it: the port compiles no program. Each point is ARMED with a probability,
a seed, an optional substring ``match`` against the call-site key, and
an optional total-fire ``limit``; an unarmed point costs one dict
lookup and fires never, so the hooks stay in production code.

Determinism: the fire decision for (point, key) is a pure hash of
``seed:point:key`` compared against the probability — NOT a shared
RNG stream — so concurrent dispatch threads cannot reorder draws and
the same seed reproduces the same failure set no matter how the
scheduler interleaves the cluster (the property chaos tests need).

Arming:

- env: ``PRESTO_TPU_FAULTS="point[:prob[:seed[:match[:limit]]]],..."``
  parsed once at first use (worker subprocesses inherit it);
- code: ``FAULTS.arm("worker-task-crash", prob=1.0, match="w1")`` for
  the in-process clusters the test suite boots.

Every fire increments ``presto_tpu_faults_injected_total{point=...}``
and emits a structured log line, so injected chaos is observable in
the same /metrics and jsonlog streams as the recovery it provokes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time

from presto_tpu_torch.obs.jsonlog import LOG
from presto_tpu_torch.obs.metrics import REGISTRY

# the named points and where they are injected
FAULT_POINTS = {
    "worker-task-crash": ("worker.py POST /v1/task: drop the "
                          "connection with no response (a worker "
                          "process dying mid-dispatch)"),
    "task-post-503": ("worker.py POST /v1/task: answer HTTP 503 (a "
                      "draining or overloaded node)"),
    "exchange-fetch-delay": ("worker.py _fetch_pages: sleep before "
                             "the page GET (a slow or congested peer)"),
    "exchange-fetch-drop": ("worker.py _fetch_pages: fail the page "
                            "GET with a connection error"),
    "heartbeat-blackout": ("coordinator.py RemoteWorker.ping: report "
                           "the node unreachable"),
    "compile-slow": ("the reference's exec/executor.py prepare_plan: "
                     "sleep before compiling (no site in the port, "
                     "which compiles nothing)"),
}

ENV_VAR = "PRESTO_TPU_FAULTS"

_FIRED = REGISTRY.counter(
    "presto_tpu_faults_injected_total",
    "deterministic fault injections fired, by point (ft/faults.py)")


class InjectedFault(RuntimeError):
    """Raised by fault points that simulate a hard failure."""

    def __init__(self, point: str, key: str):
        super().__init__(f"injected fault {point!r} at {key!r}")
        self.point = point
        self.key = key


@dataclasses.dataclass
class _Armed:
    prob: float = 1.0
    seed: int = 0
    match: str = ""      # substring the key must contain ("" = any)
    limit: int | None = None  # max total fires (None = unbounded)
    delay_s: float = 0.05     # used by delay-type points
    fired: int = 0


def _decision(seed: int, point: str, key: str) -> float:
    """Uniform [0, 1) derived purely from (seed, point, key)."""
    digest = hashlib.blake2b(f"{seed}:{point}:{key}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


class FaultRegistry:
    """Thread-safe registry of armed fault points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Armed] = {}
        self._env_loaded = False

    # -- arming ----------------------------------------------------------

    def arm(self, point: str, prob: float = 1.0, seed: int = 0,
            match: str = "", limit: int | None = None,
            delay_s: float = 0.05) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} "
                f"(known: {sorted(FAULT_POINTS)})")
        with self._lock:
            self._armed[point] = _Armed(float(prob), int(seed),
                                        str(match), limit,
                                        float(delay_s))

    def disarm(self, point: str) -> None:
        with self._lock:
            self._armed.pop(point, None)

    def clear(self) -> None:
        with self._lock:
            self._armed.clear()

    def armed_points(self) -> list[str]:
        self._ensure_env()
        with self._lock:
            return sorted(self._armed)

    def load_env(self, value: str | None = None) -> None:
        """Parse ``PRESTO_TPU_FAULTS`` (or an explicit string):
        ``point[:prob[:seed[:match[:limit]]]]`` comma-separated."""
        spec = value if value is not None else os.environ.get(ENV_VAR)
        if not spec:
            return
        for item in spec.split(","):
            fields = item.strip().split(":")
            if not fields or not fields[0]:
                continue
            point = fields[0]
            prob = float(fields[1]) if len(fields) > 1 and fields[1] \
                else 1.0
            seed = int(fields[2]) if len(fields) > 2 and fields[2] \
                else 0
            match = fields[3] if len(fields) > 3 else ""
            limit = int(fields[4]) if len(fields) > 4 and fields[4] \
                else None
            self.arm(point, prob, seed, match, limit)

    def _ensure_env(self) -> None:
        with self._lock:
            if self._env_loaded:
                return
            self._env_loaded = True
        self.load_env()

    # -- firing ----------------------------------------------------------

    def should_fire(self, point: str, key: str = "") -> bool:
        """One deterministic draw for (point, key); counts and logs
        when it fires. The hot no-faults path is a single locked dict
        lookup."""
        self._ensure_env()
        with self._lock:
            armed = self._armed.get(point)
            if armed is None:
                return False
            if armed.match and armed.match not in key:
                return False
            if armed.limit is not None and armed.fired >= armed.limit:
                return False
            if _decision(armed.seed, point, key) >= armed.prob:
                return False
            armed.fired += 1
        _FIRED.inc(point=point)
        LOG.log("fault_injected", point=point, key=key)
        return True

    def fire(self, point: str, key: str = "") -> None:
        """Raise :class:`InjectedFault` when the point fires."""
        if self.should_fire(point, key):
            raise InjectedFault(point, key)

    def delay(self, point: str, key: str = "") -> None:
        """Sleep the armed delay when the point fires (slow-path
        chaos: compile stalls, congested exchange links)."""
        if not self.should_fire(point, key):
            return
        with self._lock:
            armed = self._armed.get(point)
            delay_s = armed.delay_s if armed is not None else 0.0
        time.sleep(delay_s)


# process-global registry: every injection site and the chaos tests
# share it (worker subprocesses re-create it from the env var)
FAULTS = FaultRegistry()
