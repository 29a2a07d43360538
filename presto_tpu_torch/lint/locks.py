"""Lock-discipline rule: attributes guarded somewhere, bare elsewhere.

For every class in the threaded subsystems (``parallel/``, ``server/``,
``memory.py``), infer which instance attributes the class itself treats
as lock-guarded — written at least once inside ``with <lock>:`` (any
context manager whose name looks like a lock: ``self._lock``,
``mgr.lock``, ``self._cv``, ...) outside ``__init__`` — then report
every read or write of those attributes on a path that does not hold a
lock. The analysis is interprocedural within a module: a private helper
whose every observed call site holds the lock is treated as lock-held
(the reference encodes the same contract as "(manager lock held)"
comments on InternalResourceGroup helpers; here it is checked).

Approximations, chosen so the rule stays enforceable at zero findings:

- Any lock of the class counts; which lock guards which attribute is
  not tracked (single-lock classes dominate this codebase).
- ``x = self`` aliases (including the ``outer = self`` closure pattern
  around nested handler classes) are followed; attributes reached
  through other objects are not.
- ``__init__`` straight-line code is construction (single-threaded) and
  is exempt, but functions/classes *nested* inside it run on other
  threads and are analyzed.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                  qual_name, rule)
from presto_tpu_torch.lint.tracer import _resolve

LOCK_SCOPES = (
    "presto_tpu_torch/parallel/",
    # server/ covers the concurrent-serving governance modules too
    # (server/governance.py reaper, server/server.py admission)
    "presto_tpu_torch/server/",
    "presto_tpu_torch/memory.py",
    "presto_tpu_torch/obs/",
    "presto_tpu_torch/events.py",
    # exec/ as a whole: parallel segment compilation, the program
    # cache, spill/stream replays and cancellation state all run on
    # pool threads now — "single-threaded per query" stopped being
    # true when parallel_compile_width landed
    "presto_tpu_torch/exec/",
    "presto_tpu_torch/ft/",
    # plan-template pad caches are shared across concurrently
    # compiling queries (templates/shapes.py)
    "presto_tpu_torch/templates/",
    # the CBO now reads the shared divergence-ledger feedback
    # (cost/stats.py observed_* lookups) and hosts the skew decision
    # consulted by concurrently planning queries
    "presto_tpu_torch/cost/",
    # the engine object is shared by every concurrently-admitted
    # query (device-pin cache, carrier caps, preplanned handoff)
    "presto_tpu_torch/engine.py",
    # per-thread session overrides + the shared property dict
    "presto_tpu_torch/session.py",
    # kernel dispatch state (ambient backend + per-node collection)
    # is read by concurrently-tracing queries; the package must obey
    # the same discipline as the interpreters that install it
    "presto_tpu_torch/kernels/",
    # the host dictionary memo is shared by every concurrent query
    "presto_tpu_torch/expr/dictmemo.py",
)

_LOCK_NAME_RE = re.compile(
    r"(lock|mutex)$|^_?(cv|cond|condition)$", re.IGNORECASE)

# method calls that mutate their receiver
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "add", "discard", "setdefault",
             "appendleft", "extendleft"}


def _is_lock_expr(node: ast.AST) -> bool:
    """Does a with-item context expression look like a lock?"""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name is not None and _LOCK_NAME_RE.search(name):
            return True
    return False


def _lock_name(node: ast.AST) -> str:
    """Canonical name of a lock expression: the final name segment of
    its dotted path (``self._lock`` -> ``_lock``; ``mgr.lock``,
    ``self._manager.lock`` and the manager's own ``self.lock`` all ->
    ``lock``). Receiver chains are deliberately dropped: the same lock
    reaches different methods through different spellings (aliases,
    peer handles, the owning object itself), and a spelling-sensitive
    name would report those as disjoint locks. Two DIFFERENT locks
    sharing a final name therefore pool — a false negative, which is
    the safe direction for a rule enforced at zero findings; distinct
    locks in this codebase carry distinct attribute names."""
    q = qual_name(node)
    if q is not None:
        return q.rsplit(".", 1)[-1]
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name is not None and _LOCK_NAME_RE.search(name):
            return name
    return "<lock>"


# access kinds: a whole-reference assignment is atomic in CPython (the
# publish side of the snapshot-copy idiom); a mutation (augmented
# assignment, subscript store, del, mutator method) is not
KIND_ASSIGN = "assign"
KIND_MUTATE = "mutate"
KIND_READ = "read"


@dataclasses.dataclass
class _Access:
    attr: str
    is_write: bool
    locks: frozenset  # canonical lock names held lexically at the site
    unit: "_Unit"
    line: int
    col: int
    kind: str = KIND_READ

    @property
    def locked(self) -> bool:
        return bool(self.locks)


@dataclasses.dataclass
class _CallSite:
    callee: str  # bare method name
    locks: frozenset  # canonical lock names held lexically
    unit: "_Unit"
    line: int = 0
    col: int = 0
    qual: str | None = None  # dotted call path, for alias resolution

    @property
    def locked(self) -> bool:
        return bool(self.locks)


class _Unit:
    """One function body analyzed for a class: a method, or a
    function/method nested inside a method (which runs later, possibly
    on another thread)."""

    def __init__(self, cls_name: str, name: str, node: ast.AST,
                 self_names: set[str], is_init_body: bool,
                 is_method: bool):
        self.cls_name = cls_name
        self.name = name
        self.node = node
        self.self_names = self_names
        self.is_init_body = is_init_body  # construction: exempt
        self.is_method = is_method  # direct methods can be "locked by
        #                             caller"; nested thread bodies not
        self.accesses: list[_Access] = []
        self.call_sites: list[_CallSite] = []


def _root_self_attr(node: ast.AST, self_names: set[str]) -> str | None:
    """The attribute name when ``node`` bottoms out at
    ``<self>.<attr>[...]...``; None otherwise."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id in self_names:
        return node.attr
    return None


class _UnitVisitor(ast.NodeVisitor):
    def __init__(self, unit: _Unit, collector: "_ClassAnalysis"):
        self.unit = unit
        self.collector = collector
        self._lock_stack: list[str] = []
        # attribute nodes already recorded as writes/mutations, so the
        # generic visit_Attribute pass doesn't double-report them
        self._claimed: set[int] = set()

    @property
    def locks(self) -> frozenset:
        return frozenset(self._lock_stack)

    @property
    def locked(self) -> bool:
        return bool(self._lock_stack)

    def _record(self, attr: str, is_write: bool, node: ast.AST,
                kind: str = KIND_READ) -> None:
        self.unit.accesses.append(_Access(
            attr, is_write, self.locks, self.unit,
            node.lineno, node.col_offset, kind))

    # -- structure ---------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        held = [_lock_name(i.context_expr) for i in node.items
                if _is_lock_expr(i.context_expr)]
        for i in node.items:
            self.visit(i.context_expr)
        self._lock_stack.extend(held)
        for stmt in node.body:
            self.visit(stmt)
        if held:
            del self._lock_stack[-len(held):]

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.collector.add_nested(self.unit, node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self.collector.add_nested(self.unit, stmt)

    # -- accesses ----------------------------------------------------------

    def _claim_write_targets(self, target: ast.AST,
                             kind: str = KIND_ASSIGN) -> None:
        # a store through a subscript mutates the held object; only a
        # direct ``self.attr = ...`` atomically swaps the reference
        if isinstance(target, ast.Subscript):
            kind = KIND_MUTATE
        attr = _root_self_attr(target, self.unit.self_names)
        if attr is not None:
            self._record(attr, True, target, kind)
            for sub in ast.walk(target):
                self._claimed.add(id(sub))
        else:
            for child in ast.iter_child_nodes(target):
                if isinstance(child, (ast.Tuple, ast.List,
                                      ast.Starred)):
                    # tuple unpacking: each element is its own
                    # direct target, same kind
                    self._claim_write_targets(child, kind)
                elif isinstance(child, (ast.Attribute,
                                        ast.Subscript)):
                    # a store THROUGH an attribute chain
                    # (self.snap.field = v) mutates the object the
                    # field holds — it must void the atomic-publish
                    # exemption exactly like a subscript store
                    self._claim_write_targets(child, KIND_MUTATE)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._claim_write_targets(t)
            # ``alias = self`` inside a unit extends the alias set
            if isinstance(t, ast.Name) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in self.unit.self_names:
                self.unit.self_names.add(t.id)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._claim_write_targets(node.target)
        if isinstance(node.target, ast.Name) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in self.unit.self_names:
            self.unit.self_names.add(node.target.id)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        # read-modify-write: never atomic, whatever the target shape
        self._claim_write_targets(node.target, KIND_MUTATE)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._claim_write_targets(t, KIND_MUTATE)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _root_self_attr(node.func.value,
                                       self.unit.self_names)
                if attr is not None:
                    self._record(attr, True, node, KIND_MUTATE)
                    for sub in ast.walk(node.func.value):
                        self._claimed.add(id(sub))
            self.unit.call_sites.append(_CallSite(
                node.func.attr, self.locks, self.unit,
                node.lineno, node.col_offset, qual_name(node.func)))
        elif isinstance(node.func, ast.Name):
            self.unit.call_sites.append(_CallSite(
                node.func.id, self.locks, self.unit,
                node.lineno, node.col_offset, node.func.id))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if id(node) not in self._claimed and \
                isinstance(node.value, ast.Name) and \
                node.value.id in self.unit.self_names:
            self._record(node.attr, False, node)
        self.generic_visit(node)


class _ClassAnalysis:
    def __init__(self, mod: SourceModule, cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.units: list[_Unit] = []

    def add_nested(self, parent: _Unit,
                   node: ast.FunctionDef) -> None:
        """Nested function (thread body, callback) or nested-class
        method: inherits the parent's self/alias names minus any the
        nested signature shadows — which is also what strips a nested
        class's own ``self``, since that is NOT the outer instance."""
        params = {a.arg for a in node.args.posonlyargs
                  + node.args.args + node.args.kwonlyargs}
        self_names = set(parent.self_names) - params
        unit = _Unit(parent.cls_name, node.name, node, self_names,
                     is_init_body=False, is_method=False)
        self.units.append(unit)
        self._visit_unit(unit)

    def _visit_unit(self, unit: _Unit) -> None:
        v = _UnitVisitor(unit, self)
        for stmt in unit.node.body:
            v.visit(stmt)

    def run(self) -> None:
        # class-wide alias names: any ``name = self`` in any method
        aliases: set[str] = set()
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                args = stmt.args.posonlyargs + stmt.args.args
                if not args:
                    continue
                selfname = args[0].arg
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign) and \
                            isinstance(sub.value, ast.Name) and \
                            sub.value.id == selfname:
                        for t in sub.targets:
                            if isinstance(t, ast.Name):
                                aliases.add(t.id)
        for stmt in self.cls.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            args = stmt.args.posonlyargs + stmt.args.args
            if not args:
                continue
            self_names = {args[0].arg} | aliases
            unit = _Unit(self.cls.name, stmt.name, stmt, self_names,
                         is_init_body=(stmt.name == "__init__"),
                         is_method=True)
            self.units.append(unit)
            self._visit_unit(unit)


def _entry_locksets(all_units: list[_Unit]
                    ) -> dict[tuple[str, str], frozenset]:
    """Least-fixpoint map (class, method) -> set of locks provably
    held at ENTRY: the intersection, over every observed external call
    site (by bare name, within the module), of the locks held at that
    site — lexically plus the caller's own inferred entry lockset.
    A method with no provable common lock maps to the empty set.

    Only private methods (leading underscore) qualify — a public method
    is an API entry point and must take its own lock — and a method
    needs at least one call site outside its own body (pure
    self-recursion must not vouch for itself).

    Call sites match by bare name; to avoid pooling same-named methods
    of unrelated classes, a site only counts toward (cls, name) when it
    sits in a method of ``cls`` itself (covers self/peer-instance
    receivers) or when exactly one class in the module defines ``name``
    (unambiguous cross-class calls, e.g. a manager walking its node
    tree under the shared lock)."""
    sites_by_name: dict[str, list[_CallSite]] = {}
    for u in all_units:
        for cs in u.call_sites:
            sites_by_name.setdefault(cs.callee, []).append(cs)
    defined_in: dict[str, set[str]] = {}
    for u in all_units:
        if u.is_method:
            defined_in.setdefault(u.name, set()).add(u.cls_name)

    def relevant_sites(cls: str, name: str) -> list[_CallSite]:
        unambiguous = len(defined_in.get(name, ())) == 1
        return [cs for cs in sites_by_name.get(name, [])
                if cs.unit.cls_name == cls or unambiguous]

    method_unit = {(u.cls_name, u.name): u for u in all_units
                   if u.is_method}
    candidates = {key for key, u in method_unit.items()
                  if u.name != "__init__" and u.name.startswith("_")
                  and not u.name.startswith("__")
                  and any(cs.unit is not u
                          for cs in relevant_sites(*key))}
    # LEAST fixpoint, seeded from lexically-held locks at call sites:
    # entry locksets start EMPTY and only grow as callers' own entry
    # locksets are established. (A greatest fixpoint would let
    # mutually-recursive helpers — e.g. a thread body referenced via
    # Thread(target=self._loop), so the only observed calls are inside
    # the cycle — vouch for each other and silently suppress real
    # races.) Call sites inside the method itself are ignored:
    # self-recursion preserves whatever lock state the external
    # entries established.
    entry: dict[tuple[str, str], frozenset] = \
        {key: frozenset() for key in candidates}

    def site_locks(cs: _CallSite) -> frozenset:
        held = cs.locks
        if cs.unit.is_method:
            held = held | entry.get(
                (cs.unit.cls_name, cs.unit.name), frozenset())
        return held

    changed = True
    while changed:
        changed = False
        for key in candidates:
            own = method_unit[key]
            external = [cs for cs in relevant_sites(*key)
                        if cs.unit is not own]
            if not external:
                continue
            common = frozenset.intersection(
                *[site_locks(cs) for cs in external])
            if common != entry[key]:
                entry[key] = common
                changed = True
    return entry


def class_analyses(project: Project) -> dict[str, tuple]:
    """Per-class access/lockset analyses, shared by lock-discipline
    and the lockset rule (races.py): computing them twice per run
    doubled the cost of the most expensive rule family. Cached ON the
    project instance so the data dies with the run — a module-level
    cache would pin the last run's parsed package (ASTs plus walk
    caches, several MB) for the life of the process."""
    cached = getattr(project, "_locks_class_analyses", None)
    if cached is not None:
        return cached
    out: dict[str, tuple] = {}
    for mod in project.in_scope(LOCK_SCOPES):
        analyses: list[_ClassAnalysis] = []
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                a = _ClassAnalysis(mod, node)
                a.run()
                analyses.append(a)
        all_units = [u for a in analyses for u in a.units]
        out[mod.relpath] = (mod, analyses,
                            _entry_locksets(all_units))
    project._locks_class_analyses = out
    return out


@rule("lock-discipline")
def lock_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod, analyses, entry in class_analyses(project).values():

        def unit_locked(u: _Unit) -> bool:
            return u.is_method and bool(
                entry.get((u.cls_name, u.name)))

        for a in analyses:
            guarded: dict[str, int] = {}  # attr -> a guarded-write line
            for u in a.units:
                if u.is_init_body:
                    continue
                for acc in u.accesses:
                    if acc.is_write and \
                            (acc.locked or unit_locked(u)) and \
                            not _LOCK_NAME_RE.search(acc.attr):
                        guarded.setdefault(acc.attr, acc.line)
            if not guarded:
                continue
            for u in a.units:
                if u.is_init_body:
                    continue
                if unit_locked(u):
                    continue
                for acc in u.accesses:
                    if acc.locked or acc.attr not in guarded:
                        continue
                    kind = "written" if acc.is_write else "read"
                    findings.append(Finding(
                        "lock-discipline", mod.relpath, acc.line,
                        acc.col,
                        f"{a.cls.name}.{acc.attr} is {kind} without "
                        f"the lock in `{u.name}` but written under it "
                        f"elsewhere (e.g. line {guarded[acc.attr]}); "
                        "either lock this path or document the "
                        "invariant and suppress"))
    return findings


# -- blocking-under-lock -----------------------------------------------------

# scope: the subsystems where a held lock serializes OTHER threads
# (coordinator/worker RPC, serve-path handlers, failure detection)
_BLOCKING_SCOPES = (
    "presto_tpu_torch/server/",
    "presto_tpu_torch/parallel/",
    "presto_tpu_torch/ft/",
)

# call names that block for network/device time: a lock held across
# one stalls every thread contending for it (a device drain or a whole
# plan's passes inside a coordinator lock turns the whole serve path
# lock-step). The reference's JAX names stay (a fixture written for it
# reads the same here); the port's own are ``synchronize`` (of the
# device, a stream or an event) and ``run_plan_batched``
_BLOCKING_NAMES = {
    "urlopen": "a network round-trip",
    "_urlopen": "a network round-trip",
    "prepare_plan": "a program's passes (the capacity retry ladder)",
    "execute_plan": "full plan execution",
    "execute_plan_distributed": "full distributed execution",
    "run_plan": "full plan execution",
    "run_plan_batched": "a batched plan execution",
    "explain_analyze": "profiled plan execution",
    "explain_analyze_distributed": "profiled plan execution",
    "block_until_ready": "a device drain",
    "synchronize": "a device drain",
    "device_get": "a device->host transfer",
}

# resolved-qual prefixes that block: the counted hostsync boundary
# (fetch stalls on the device). Matched by RESOLVED
# name so that cv.wait()/event.wait() — correct under a lock — and
# unrelated fetch() helpers stay clean.
_BLOCKING_QUAL_PREFIX = "presto_tpu_torch.exec.hostsync."


@rule("blocking-under-lock")
def blocking_under_lock(project: Project) -> list[Finding]:
    """No network, compile, or device-sync call while holding a lock.

    Reuses the lock-discipline lockset analysis: a call site is "under
    a lock" when a lock is held lexically (``with self._lock:``) or
    when the enclosing private helper's inferred entry lockset is
    non-empty (every observed caller holds the lock). ``re.compile``
    and condition-variable ``wait`` are excluded by alias resolution.
    """
    findings: list[Finding] = []
    for relpath, (mod, analyses, entry) in sorted(
            class_analyses(project).items()):
        if not relpath.startswith(_BLOCKING_SCOPES):
            continue
        aliases = mod.aliases
        for a in analyses:
            for u in a.units:
                if u.is_init_body:
                    continue
                held_at_entry = u.is_method and bool(
                    entry.get((u.cls_name, u.name)))
                for cs in u.call_sites:
                    if not cs.locks and not held_at_entry:
                        continue
                    resolved = None
                    if cs.qual is not None:
                        resolved = _resolve(cs.qual, aliases)
                    what = None
                    if resolved is not None and resolved.startswith(
                            _BLOCKING_QUAL_PREFIX):
                        what = "a device->host sync (hostsync boundary)"
                    elif cs.callee in _BLOCKING_NAMES:
                        what = _BLOCKING_NAMES[cs.callee]
                    if what is None:
                        continue
                    lock = (sorted(cs.locks)[0] if cs.locks
                            else sorted(entry[(u.cls_name,
                                               u.name)])[0])
                    findings.append(Finding(
                        "blocking-under-lock", relpath, cs.line,
                        cs.col,
                        f"`{u.cls_name}.{u.name}` calls "
                        f"`{cs.callee}` — {what} — while holding "
                        f"`{lock}`: every thread contending for the "
                        "lock stalls behind it; snapshot state under "
                        "the lock, release it, then block"))
    return findings
