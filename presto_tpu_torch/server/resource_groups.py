"""Hierarchical resource groups: admission control for query dispatch.

Analog of the reference's resource-group subsystem
(execution/resourcegroups/InternalResourceGroup.java:77 — a TREE of
groups with hardConcurrencyLimit/maxQueued and per-node scheduling
policies, selected per query by DispatchManager.selectGroup,
dispatcher/DispatchManager.java:189). Dotted group names define the
hierarchy ("global.adhoc" is a child of "global"); a query needs a free
slot in its leaf AND every ancestor; when a slot frees, the tree is
walked from the root choosing among children with eligible work by the
node's scheduling policy:

- fair           oldest queued query first (global FIFO age)
- weighted_fair  child with the lowest running/weight ratio
- weighted       child with the lowest admitted/weight ratio
- query_priority highest submission priority first

Queries over a full leaf queue are rejected (QUERY_QUEUE_FULL).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import threading
from typing import Callable


class QueryQueueFullError(RuntimeError):
    """Reference QUERY_QUEUE_FULL error code analog."""


class NoMatchingGroupError(RuntimeError):
    """Reference QUERY_REJECTED (no selector matched) analog."""


@dataclasses.dataclass
class GroupSpec:
    """Static configuration of one group (the file-based resource-group
    manager's JSON entries, plugin/trino-resource-group-managers).
    ``name`` may be dotted: parents are auto-created with permissive
    defaults unless configured explicitly."""

    name: str
    hard_concurrency_limit: int = 16
    max_queued: int = 1000
    user_pattern: str | None = None  # selector regex over the user
    scheduling_policy: str = "fair"  # applied to this node's children
    scheduling_weight: int = 1


@dataclasses.dataclass
class _Queued:
    start: Callable[[], None]
    seq: int
    priority: int


class InternalResourceGroup:
    """Runtime state of one group node. All state is guarded by the
    manager-wide lock (the reference synchronizes on the root the same
    way, InternalResourceGroup.java root.synchronized)."""

    def __init__(self, spec: GroupSpec,
                 parent: "InternalResourceGroup | None"):
        self.spec = spec
        self.parent = parent
        self.children: list[InternalResourceGroup] = []
        self.running = 0  # includes descendants' running queries
        self.queued: list[_Queued] = []
        self.total_admitted = 0

    # -- tree helpers (manager lock held) -----------------------------------

    def _can_run(self) -> bool:
        g: InternalResourceGroup | None = self
        while g is not None:
            if g.running >= g.spec.hard_concurrency_limit:
                return False
            g = g.parent
        return True

    def _inc_running(self) -> None:
        g: InternalResourceGroup | None = self
        while g is not None:
            g.running += 1
            g = g.parent

    def _dec_running(self) -> None:
        g: InternalResourceGroup | None = self
        while g is not None:
            g.running -= 1
            g = g.parent

    def _queued_head(self) -> _Queued | None:
        """Best eligible queued item in this subtree per the local
        scheduling policies; None when nothing can run."""
        if self.running >= self.spec.hard_concurrency_limit:
            return None
        best: _Queued | None = None
        best_child: InternalResourceGroup | None = None
        candidates = []
        if self.queued:
            # the node's policy orders its OWN queue too (matters for
            # query_priority; fair keeps FIFO via the seq tiebreak)
            own = min(self.queued,
                      key=lambda it: self._order_key(None, it))
            candidates.append((None, self._order_key(None, own), own))
        for c in self.children:
            h = c._queued_head()
            if h is not None:
                candidates.append((c, self._order_key(c, h), h))
        if not candidates:
            return None
        best_child, _, best = min(candidates, key=lambda t: t[1])
        del best_child
        return best

    def _order_key(self, child, item: _Queued):
        pol = self.spec.scheduling_policy
        if pol == "weighted_fair" and child is not None:
            return (0, child.running / max(child.spec.scheduling_weight,
                                           1), item.seq)
        if pol == "weighted" and child is not None:
            return (0, child.total_admitted
                    / max(child.spec.scheduling_weight, 1), item.seq)
        if pol == "query_priority":
            return (0, -item.priority, item.seq)
        return (0, 0, item.seq)  # fair: global FIFO age

    def _owner_of(self, item: _Queued) -> "InternalResourceGroup | None":
        if item in self.queued:
            return self
        for c in self.children:
            o = c._owner_of(item)
            if o is not None:
                return o
        return None

    def info(self) -> dict:
        """Public snapshot: takes the manager lock (the counters are
        written by dispatcher threads under it)."""
        with self._manager.lock:
            return self._info()

    def _info(self) -> dict:
        out = {
            "name": self.spec.name,
            "hardConcurrencyLimit": self.spec.hard_concurrency_limit,
            "maxQueued": self.spec.max_queued,
            "schedulingPolicy": self.spec.scheduling_policy,
            "schedulingWeight": self.spec.scheduling_weight,
            "running": self.running,
            "queued": len(self.queued),
            "totalAdmitted": self.total_admitted,
        }
        if self.children:
            out["subGroups"] = [c._info() for c in self.children]
        return out

    # -- public API used by the dispatcher ----------------------------------
    # (kept method-compatible with the round-2 flat implementation)

    def submit(self, start: Callable[[], None],
               priority: int = 0) -> str:
        mgr = self._manager
        with mgr.lock:
            if self._can_run():
                self._inc_running()
                self.total_admitted += 1
                run_now = True
            elif len(self.queued) >= self.spec.max_queued:
                raise QueryQueueFullError(
                    f"resource group '{self.spec.name}' queue is full "
                    f"({self.spec.max_queued})")
            else:
                self.queued.append(
                    _Queued(start, next(mgr.seq), priority))
                run_now = False
        if run_now:
            start()
            return "RUNNING"
        return "QUEUED"

    def cancel_queued(self, start: Callable[[], None]) -> bool:
        mgr = self._manager
        with mgr.lock:
            for item in self.queued:
                if item.start is start:
                    self.queued.remove(item)
                    return True
        return False

    def finish(self) -> None:
        mgr = self._manager
        with mgr.lock:
            self._dec_running()
            item = mgr.root._queued_head()
            if item is not None:
                owner = mgr.root._owner_of(item)
                owner.queued.remove(item)
                owner._inc_running()
                owner.total_admitted += 1
        if item is not None:
            item.start()

    _manager: "ResourceGroupManager" = None  # type: ignore[assignment]


class ResourceGroupManager:
    """Builds the group tree from dotted specs and selects a leaf per
    (user, sql) — InternalResourceGroupManager + selectors. First
    matching user_pattern wins; a pattern-less selectable group is a
    catch-all; otherwise the query is rejected."""

    def __init__(self, specs: list[GroupSpec] | None = None):
        specs = specs or [GroupSpec("global")]
        self.lock = threading.RLock()
        self.seq = itertools.count()
        self.by_name: dict[str, InternalResourceGroup] = {}
        self.root = InternalResourceGroup(
            GroupSpec("", hard_concurrency_limit=1 << 30,
                      max_queued=1 << 30), None)
        self.root._manager = self
        for s in specs:
            self._ensure(s.name, s)
        # selection order preserves spec order
        self.groups = [self.by_name[s.name] for s in specs]

    def _ensure(self, name: str,
                spec: GroupSpec | None) -> InternalResourceGroup:
        if name in self.by_name:
            g = self.by_name[name]
            if spec is not None:
                g.spec = dataclasses.replace(
                    spec, name=name)  # explicit config wins
            return g
        parent = self.root
        if "." in name:
            parent = self._ensure(name.rsplit(".", 1)[0], None)
        g = InternalResourceGroup(
            spec if spec is not None else GroupSpec(
                name, hard_concurrency_limit=1 << 30,
                max_queued=1 << 30), parent)
        g._manager = self
        parent.children.append(g)
        self.by_name[name] = g
        return g

    def select(self, user: str, sql: str) -> InternalResourceGroup:
        for g in self.groups:
            if g.children:
                continue  # only LEAF groups accept queries (reference
                # InternalResourceGroup.run rejects non-leaf groups)
            pat = g.spec.user_pattern
            if pat is None or re.fullmatch(pat, user):
                return g
        raise NoMatchingGroupError(
            f"no resource group selector matches user '{user}'")

    def info(self) -> list[dict]:
        with self.lock:
            return [c._info() for c in self.root.children]
