"""Speculative straggler re-dispatch: attempt arbitration.

The Trino/Dryad-style mitigation for slow-node tail latency in the
TASK-mode stage walk (parallel/coordinator._execute_general_ft): when
most of a stage's sibling tasks have finished but one shard's task is
still running well past the siblings' typical completion time, the
coordinator dispatches a DUPLICATE attempt of that task on another
schedulable worker and takes whichever attempt finishes first. The
attempt-versioned task ids (``{qid}.{stage}.{shard}aN``) make the
duplicate collision-free, and the loser's output is dropped through
the existing task DELETE path (exact-id mode, so a losing primary
``...0`` cannot prefix-wipe its winning duplicate ``...0a1``).

This module holds the policy (session-configured thresholds) and the
:class:`StageArbiter` — the thread-safe first-finisher arbitration the
dispatch threads race through. The arbiter owns no sockets: dispatch,
retry, and cleanup stay in the coordinator; the arbiter only decides
who won, who should speculate, and when the stage is complete.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from presto_tpu_torch.obs.metrics import REGISTRY

SPECULATIVE_ATTEMPTS = REGISTRY.counter(
    "presto_tpu_speculative_attempts_total",
    "duplicate task attempts dispatched against stragglers "
    "(ft/speculate.py)")
SPECULATIVE_WINS = REGISTRY.counter(
    "presto_tpu_speculative_wins_total",
    "stage tasks whose winning attempt was a speculative duplicate")


@dataclasses.dataclass(frozen=True)
class SpeculationPolicy:
    """Session-configured straggler thresholds: a task speculates once
    at least ``quantile`` of its siblings have finished and its own
    runtime exceeds ``multiplier`` x the quantile sibling completion
    time (floored at ``min_runtime_s`` so sub-second stages never
    duplicate work)."""

    enabled: bool = False
    quantile: float = 0.75
    multiplier: float = 2.0
    min_runtime_s: float = 0.5

    @classmethod
    def from_session(cls, session) -> "SpeculationPolicy":
        return cls(
            enabled=bool(session.get("speculative_execution")),
            quantile=min(max(
                float(session.get("speculation_quantile")), 0.05), 1.0),
            multiplier=max(
                float(session.get("speculation_threshold")), 1.0),
            min_runtime_s=max(
                float(session.get("speculation_min_runtime_s")), 0.0))


class AttemptLost(Exception):
    """Internal sentinel: this attempt finished second — its result
    was discarded and its task should be cleaned up by the caller."""


class StageArbiter:
    """First-finisher arbitration for one stage's W sharded tasks.

    Dispatch threads (primary and speculative attempts alike) call
    :meth:`claim_win` when their POST succeeds; exactly one attempt per
    shard wins. The stage walk waits on :meth:`wait_all_won`, polling
    :meth:`stragglers` to launch duplicates. Failures decrement the
    shard's outstanding-attempt count; a shard whose every attempt
    failed surfaces the last error to the stage walk."""

    def __init__(self, nshards: int, policy: SpeculationPolicy,
                 clock=time.monotonic):
        self.nshards = nshards
        self.policy = policy
        self._clock = clock
        self._cv = threading.Condition()
        self._t0 = clock()
        # shard -> (winning task id, result, was-speculative)
        self._won: dict[int, tuple[str, object, bool]] = {}
        self._durations: list[float] = []
        self._speculated: set[int] = set()
        self._spec_won = 0
        self._outstanding: dict[int, int] = {
            i: 1 for i in range(nshards)}
        self._errors: dict[int, BaseException] = {}

    # -- dispatch-thread side --------------------------------------------

    def has_winner(self, shard: int) -> bool:
        with self._cv:
            return shard in self._won

    def claim_win(self, shard: int, task_id: str, out,
                  speculative: bool, on_win=None) -> bool:
        """True when this attempt is the shard's first finisher; False
        when another attempt already won (the caller discards and
        cleans up). ``on_win`` runs INSIDE the claim's critical
        section, BEFORE the stage walk can observe the win — the
        winner's placement must be published before ``all_won()`` can
        release the walk to build the next stage's payloads, or a
        preempted winner thread would leave its producer entry missing
        from the consumer refs."""
        with self._cv:
            if shard in self._won:
                return False
            if on_win is not None:
                on_win()
            self._won[shard] = (task_id, out, speculative)
            self._durations.append(self._clock() - self._t0)
            if speculative:
                self._spec_won += 1
            self._cv.notify_all()
        if speculative:
            SPECULATIVE_WINS.inc()
        return True

    def winner_task_id(self, shard: int) -> str | None:
        with self._cv:
            hit = self._won.get(shard)
            return hit[0] if hit is not None else None

    def winner_was_speculative(self, shard: int) -> bool:
        with self._cv:
            hit = self._won.get(shard)
            return bool(hit is not None and hit[2])

    def record_failure(self, shard: int, exc: BaseException) -> None:
        """One attempt for ``shard`` exhausted its retries. The stage
        only fails when no attempt for the shard remains in flight and
        none won."""
        with self._cv:
            self._outstanding[shard] -= 1
            self._errors[shard] = exc
            self._cv.notify_all()

    # -- stage-walk side -------------------------------------------------

    def note_speculation(self, shard: int) -> None:
        with self._cv:
            self._speculated.add(shard)
            self._outstanding[shard] += 1
        SPECULATIVE_ATTEMPTS.inc()

    def stragglers(self) -> list[int]:
        """Shards that should speculate NOW: enough siblings finished,
        the shard has no winner, no duplicate yet, and its runtime
        exceeds the policy threshold."""
        p = self.policy
        if not p.enabled or self.nshards < 2:
            return []
        with self._cv:
            done = sorted(self._durations)
            # at least the quantile share of siblings must have
            # finished — capped at W-1 so a 2-shard stage can still
            # speculate against its single straggler
            need = min(self.nshards - 1,
                       max(1, math.ceil(p.quantile * self.nshards)))
            if len(done) < need or len(self._won) >= self.nshards:
                return []
            # the quantile completion time of the finished siblings
            qi = min(max(math.ceil(p.quantile * len(done)) - 1, 0),
                     len(done) - 1)
            threshold = max(p.min_runtime_s, p.multiplier * done[qi])
            now = self._clock() - self._t0
            if now <= threshold:
                return []
            return [i for i in range(self.nshards)
                    if i not in self._won
                    and i not in self._speculated
                    and self._outstanding.get(i, 0) > 0]

    def wait_turn(self, timeout_s: float) -> None:
        with self._cv:
            if len(self._won) < self.nshards:
                self._cv.wait(timeout=timeout_s)

    def failed_shard(self) -> tuple[int, BaseException] | None:
        """A shard with zero attempts left and no winner, or None."""
        with self._cv:
            for i in range(self.nshards):
                if i not in self._won \
                        and self._outstanding.get(i, 0) <= 0:
                    return i, self._errors.get(
                        i, RuntimeError(f"shard {i} failed"))
            return None

    def all_won(self) -> bool:
        with self._cv:
            return len(self._won) >= self.nshards

    def results(self) -> list:
        with self._cv:
            return [self._won[i][1] for i in range(self.nshards)]

    def speculation_summary(self) -> dict:
        with self._cv:
            return {"speculated": sorted(self._speculated),
                    "speculative_wins": self._spec_won}
