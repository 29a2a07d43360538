"""Plan-time device-memory accounting: the port of
``presto_tpu/memory.py`` (its estimate, not its runtime pool).

Every operator's output is a fixed-capacity masked table, so walking
the plan and summing capacity x row width bounds a program's working
set before it runs. The estimate is host arithmetic over plan types and
connector row counts: on the same plan it equals the reference's byte
for byte.

The session's ``query_max_memory_bytes`` is enforced by
``exec/spill.try_execute_spilled``: an over-budget plan fails with
MemoryLimitExceeded (``spill_enabled=false``) or runs its dominant join
or grouped aggregate host-partitioned.

``MemoryPool`` is the runtime ledger (a copy of the reference's): each
program reserves the measured bytes of its input and output tensors
while it runs (``exec/executor.prepare_plan``), and the server's query
pool reserves each query's estimate at admission. A reservation that
does not fit blocks up to a deadline, and sustained exhaustion kills
the largest reservation with ``MemoryKilledError``.
"""

from __future__ import annotations

import dataclasses

from presto_tpu_torch import types as T
from presto_tpu_torch.plan import nodes as N


class MemoryLimitExceeded(RuntimeError):
    """Reference ExceededMemoryLimitException analog."""


class MemoryKilledError(MemoryLimitExceeded):
    """The query was chosen by the low-memory killer: the pool was
    exhausted for longer than the kill delay while other queries were
    blocked waiting for memory, and this query held the largest
    reservation (reference TotalReservationLowMemoryKiller +
    ClusterMemoryManager.killLargestQuery). The message carries the
    pool diagnostics at kill time so the failure is attributable."""


def _row_bytes(types: dict[str, T.DataType]) -> int:
    # +1 byte per column approximates the validity sibling array;
    # LONG decimals are two int64 limbs per value
    return sum(
        t.physical_dtype.itemsize
        * (2 if isinstance(t, T.DecimalType) and t.is_long else 1) + 1
        for t in types.values())


@dataclasses.dataclass
class NodeMemory:
    node: N.PlanNode
    rows: int          # estimated output rows (static capacity)
    resident: int      # bytes this node's outputs + tables hold


def estimate_plan_memory(plan: N.PlanNode, engine
                         ) -> tuple[int, list[NodeMemory]]:
    """(total peak bytes, per-node breakdown) for a logical plan.

    The model charges every node its output arrays (capacity x row
    width) plus hash-table state where applicable — an upper bound for
    the fused XLA program, which holds at most all intermediates at
    once and typically fewer after fusion.
    """
    per_node: list[NodeMemory] = []

    def rows_of(node: N.PlanNode) -> int:
        return next(m.rows for m in per_node if m.node is node)

    # post-order by an explicit stack: a nested function that calls
    # itself is a reference cycle, and this one would hold the engine
    stack = [(plan, False)]
    while stack:
        node, ready = stack.pop()
        if not ready:
            stack.append((node, True))
            stack.extend((s, False) for s in reversed(node.sources()))
            continue
        width = _row_bytes(node.output_types())
        if isinstance(node, N.TableScan):
            rows = engine.catalogs[node.catalog].row_count_estimate(
                node.table)
            resident = rows * width
        elif isinstance(node, (N.Filter, N.Project)):
            # masked in place: charge the new columns only
            rows = rows_of(node.source)
            if isinstance(node, N.Project):
                resident = rows * width
            else:
                resident = rows  # live-mask bytes
        elif isinstance(node, N.Aggregate):
            rows = node.capacity or 1024
            resident = rows * width + rows * 8  # slot hash table
        elif isinstance(node, (N.Distinct, N.MarkDistinct)):
            rows = rows_of(node.source)
            cap = node.capacity or rows
            resident = rows * width + cap * 8
        elif isinstance(node, N.Join):
            build = rows_of(node.right)
            cap = node.capacity or 2 * build
            if node.build_unique:
                rows = rows_of(node.left)
            else:
                rows = node.output_capacity or (rows_of(node.left) + build)
            # table: hash + row-id per slot; output: full width
            resident = cap * 16 + rows * width
        elif isinstance(node, N.MultiJoin):
            # probe-preserving fused chain: output at spine width, one
            # sorted build side resident per leg (hash + index per row)
            rows = rows_of(node.spine)
            resident = rows * width + sum(
                rows_of(b) * 16 for b in node.builds)
        elif isinstance(node, N.SemiJoin):
            rows = rows_of(node.source)
            cap = node.capacity or 2 * rows_of(node.filter_source)
            resident = cap * 16 + rows
        elif isinstance(node, N.CrossJoin):
            rows = rows_of(node.left)
            resident = rows * width
        elif isinstance(node, (N.Sort, N.Window)):
            rows = rows_of(node.source)
            resident = rows * width  # permuted copy
        elif isinstance(node, (N.TopN, N.Limit, N.Exchange, N.Output)):
            rows = rows_of(node.source)
            resident = rows * width if isinstance(node, N.TopN) else 0
        elif isinstance(node, N.Union):
            rows = sum(rows_of(s) for s in node.inputs)
            resident = rows * width
        elif isinstance(node, N.Values):
            rows = len(node.rows)
            resident = rows * width
        else:
            rows = max((rows_of(s) for s in node.sources()), default=1)
            resident = rows * width
        per_node.append(NodeMemory(node, max(rows, 1), resident))
    return sum(m.resident for m in per_node), per_node


def largest_join(per_node: list[NodeMemory]) -> N.Join | None:
    """The Join with the biggest estimated build side, if any."""
    best, best_rows = None, -1
    by_node = {id(m.node): m for m in per_node}
    for m in per_node:
        if isinstance(m.node, N.Join):
            build = by_node[id(m.node.right)].rows
            if build > best_rows:
                best, best_rows = m.node, build
    return best


class MemoryPool:
    """Runtime memory ledger: tagged byte reservations with a capacity
    (reference memory/MemoryPool.java:44 tagged reservations +
    LocalMemoryManager GENERAL pool). The engine reserves each
    program's measured input+output array bytes for the duration of
    execution; the coordinator aggregates pool snapshots cluster-wide
    (ClusterMemoryManager.java:89).

    Concurrent-serving governance (reference QueryContext memory limits
    + LowMemoryKiller): a reservation that does not fit may BLOCK with
    a deadline (``block_s``) instead of failing — freed bytes wake the
    waiters. A waiter blocked longer than ``kill_after_s`` triggers the
    low-memory killer: the tag holding the LARGEST reservation is
    marked killed, its registered owner (a CancelToken) is killed with
    a :class:`MemoryKilledError` carrying the pool diagnostics, and its
    eventual free() unblocks the rest. Reserving against a killed tag
    raises immediately, so a victim blocked in its own reserve() dies
    loudly too."""

    # pool-wide throttle between low-memory kills: one victim must get
    # the chance to actually release before a second is chosen
    KILL_INTERVAL_S = 1.0

    def __init__(self, capacity_bytes: int = 0, name: str = "general"):
        import threading
        self.capacity = capacity_bytes  # 0 = unbounded
        self.name = name
        self.reserved = 0
        self.peak = 0
        self.by_tag: dict[str, int] = {}
        self._killed: dict[str, str] = {}  # tag -> kill reason
        self._owners: dict[str, object] = {}  # tag -> CancelToken-like
        self._waiters = 0
        self._last_kill = float("-inf")
        self._cond = threading.Condition()

    def _diag(self) -> str:
        """Pool diagnostics for failure messages (cond held)."""
        top = sorted(self.by_tag.items(), key=lambda kv: -kv[1])[:5]
        held = ", ".join(f"{t}={b}" for t, b in top) or "none"
        return (f"pool '{self.name}': reserved={self.reserved} "
                f"capacity={self.capacity} waiters={self._waiters} "
                f"largest=[{held}]")

    def _blocked_gauge(self):
        from presto_tpu_torch.obs.metrics import REGISTRY
        return REGISTRY.gauge(
            "presto_tpu_memory_blocked_queries",
            "reservations currently blocked waiting for pool memory")

    def reserve(self, tag: str, nbytes: int, block_s: float = 0.0,
                kill_after_s: float = 0.0, owner: object = None) -> None:
        """Reserve ``nbytes`` under ``tag``. With ``block_s`` > 0 an
        over-capacity reservation blocks up to that deadline for other
        queries to free memory (reference memory-blocked operators)
        before raising; ``kill_after_s`` > 0 additionally arms the
        low-memory killer while blocked. ``owner`` registers the
        reserving query's cancel token so a kill propagates."""
        import time as _time

        start = _time.monotonic()
        with self._cond:
            if owner is not None:
                self._owners.setdefault(tag, owner)
            try:
                self._reserve_loop(tag, nbytes, block_s, kill_after_s,
                                   owner, start)
            except BaseException:
                # a reservation that RAISES may never see the caller's
                # free(): drop the owner hook registered above unless
                # the tag still holds bytes from an earlier reserve
                # (then free() owns the cleanup) — else every shed
                # query leaks an _owners entry forever
                if tag not in self.by_tag:
                    self._owners.pop(tag, None)
                raise

    def _reserve_loop(self, tag: str, nbytes: int, block_s: float,
                      kill_after_s: float, owner: object,
                      start: float) -> None:
        """reserve()'s wait loop (cond held)."""
        import time as _time

        from presto_tpu_torch.obs.metrics import REGISTRY
        while True:
            if tag in self._killed:
                raise MemoryKilledError(
                    f"query {tag} killed by the low-memory "
                    f"killer: {self._killed[tag]}; {self._diag()}")
            if owner is not None:
                # a canceled/killed/timed-out query must not sit
                # out the blocking deadline: its token's check()
                # raises the attributable exception promptly
                check = getattr(owner, "check", None)
                if callable(check):
                    check()
            if not self.capacity \
                    or self.reserved + nbytes <= self.capacity:
                self.reserved += nbytes
                self.peak = max(self.peak, self.reserved)
                self.by_tag[tag] = self.by_tag.get(tag, 0) + nbytes
                return
            waited = _time.monotonic() - start
            if waited >= block_s:
                REGISTRY.counter(
                    "presto_tpu_memory_limit_exceeded_total",
                    "reservations rejected by the pool "
                    "capacity").inc()
                blocked = (f" after blocking {waited:.1f}s"
                           if block_s > 0 else "")
                raise MemoryLimitExceeded(
                    f"pool exhausted: {self.reserved} + {nbytes} "
                    f"> {self.capacity} bytes (query {tag})"
                    f"{blocked}; {self._diag()}")
            if kill_after_s > 0 and waited >= kill_after_s:
                self._kill_largest(
                    f"sustained exhaustion ({waited:.1f}s) while "
                    f"query {tag} waits for {nbytes} bytes")
            self._waiters += 1
            self._blocked_gauge().set(self._waiters, pool=self.name)
            try:
                self._cond.wait(timeout=min(
                    0.05, max(block_s - waited, 0.001)))
            finally:
                self._waiters -= 1
                self._blocked_gauge().set(self._waiters,
                                          pool=self.name)

    def _kill_largest(self, reason: str) -> None:
        """Low-memory killer (cond held): mark the largest reservation
        killed and kill its owner token. Throttled so one victim gets
        to release before the next is chosen."""
        import time as _time

        from presto_tpu_torch.obs.jsonlog import LOG
        from presto_tpu_torch.obs.metrics import REGISTRY
        now = _time.monotonic()
        if now - self._last_kill < self.KILL_INTERVAL_S:
            return
        victims = [t for t in self.by_tag if t not in self._killed]
        if not victims:
            return
        victim = max(victims, key=self.by_tag.get)
        self._last_kill = now
        self._killed[victim] = reason
        REGISTRY.counter(
            "presto_tpu_query_killed_total",
            "queries killed by the low-memory killer "
            "(memory.MemoryPool)").inc(pool=self.name)
        LOG.log("memory_killed", pool=self.name, victim=victim,
                held_bytes=self.by_tag.get(victim, 0), reason=reason)
        # query-pool victims are tagged by protocol query id == trace
        # id: mark the kill on that query's timeline (create=False —
        # operator-pool tags are uuids, which must not spawn junk
        # traces)
        from presto_tpu_torch.obs.trace import TRACER
        TRACER.instant_for(victim, "low-memory-kill", pool=self.name,
                           held_bytes=self.by_tag.get(victim, 0))
        exc = MemoryKilledError(
            f"query {victim} killed by the low-memory killer "
            f"({self.by_tag.get(victim, 0)} bytes held, the largest "
            f"reservation): {reason}; {self._diag()}")
        owner = self._owners.get(victim)
        if owner is not None:
            kill = getattr(owner, "kill", None)
            if callable(kill):
                kill(exc)
            else:
                cancel = getattr(owner, "cancel", None)
                if callable(cancel):
                    cancel()
        self._cond.notify_all()

    def free(self, tag: str, nbytes: int | None = None) -> None:
        with self._cond:
            held = self.by_tag.pop(tag, 0)
            give_back = held if nbytes is None else min(nbytes, held)
            if nbytes is not None and held - give_back > 0:
                self.by_tag[tag] = held - give_back
            else:
                # fully released: the tag's kill marker and owner hook
                # served their purpose (a re-used tag is a new query)
                self._killed.pop(tag, None)
                self._owners.pop(tag, None)
            self.reserved -= give_back
            self._cond.notify_all()

    def largest_tag(self) -> tuple[str, int] | None:
        """Biggest current reservation — the low-memory killer's victim
        choice (TotalReservationLowMemoryKiller analog)."""
        with self._cond:
            if not self.by_tag:
                return None
            tag = max(self.by_tag, key=self.by_tag.get)
            return tag, self.by_tag[tag]

    def info(self) -> dict:
        with self._cond:
            return {"capacityBytes": self.capacity,
                    "reservedBytes": self.reserved,
                    "peakBytes": self.peak,
                    "blockedReservations": self._waiters,
                    "killedQueries": sorted(self._killed),
                    "queries": dict(self.by_tag)}
