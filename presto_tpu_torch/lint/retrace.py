"""Capacity-memory misses: data-dependent values must be bucketed
before they key a program.

The reference keys compiled XLA programs on shapes, so a raw
data-dependent integer reaching a shape constructor, a Python branch
or a cache-key component recompiles per dataset. The port runs
eagerly: a tensor of any shape, or a branch either way, costs nothing
to "compile", so shape and branch sinks are not hazards here and this
rule does not report them. One sink keeps its cost. The program cache
and the capacity memory beside it (exec/progcache.py,
``engine._caps_memory``) are keyed by ``exec/executor._cache_key``,
and a program starts from the capacity vector remembered under its key
instead of climbing the overflow-retry ladder (each rung a full pass
over the plan). A raw data-dependent integer — a ``bincount().max()``,
a live count read back through ``hostsync.fetch``, an ``arr.max()`` —
that reaches a component of a cache key WITHOUT passing through
``ops/sizes.next_pow2`` (or the ``bucket_*`` helpers built on it)
makes the key differ per dataset: every query misses, starts from the
default capacities and pays the ladder again, and the entry it records
is never hit. The bug class is invisible in tests (tiny fixed inputs
always land in one bucket) and costs a card its warm start in
production.

This rule rides the shared ``lint/tracer.py`` ``CallGraph`` over the
tracekey scope and taints the *unbucketed data-dependent ints*:

- seeds: ``np.bincount``/``np.max``/``np.min``/``np.amax``/``np.amin``
  results, ``.max()``/``.min()`` method reductions, and host readbacks
  of device values (``hostsync.fetch``, ``.item()``, ``.tolist()``);
- propagation: arithmetic, comparisons, ``int``/``max``/``min``/
  ``abs``/``round``, tuple packing/unpacking, helper parameters and
  return values (tracekey least-fixpoint argument-taint);
- clears: ``next_pow2`` and the ``bucket_*`` helpers — bucketing IS
  the fix — plus ``len()``/``.shape`` reads (input shapes ride the key
  through ``templates.scan_shape_key``, bucketed there).

Findings (kind ``key`` in the exemption id): a tainted component in a
cache-key tuple or f-string — a value assigned to a name containing
``key``, or returned by a function whose name contains ``key``
(``_cache_key``, ``scan_shape_key``).

Justified hazards are declared in ``exec/progcache.RETRACE_EXEMPT``
(id -> justification, id form ``<relpath>:<dotted.unit>:key``) with
staleness enforcement: an entry matching no finding is itself a
finding.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import (Finding, Project, literal_str_dict,
                                  qual_name, rule)
from presto_tpu_torch.lint.tracekey import SCOPES, _params, _taint_targets
from presto_tpu_torch.lint.tracer import (CallGraph, _FnUnit, _resolve,
                                          call_graph)

RULE = "retrace"

# where the exemption registry lives (next to the cache it protects)
EXEMPT_PATH = "presto_tpu_torch/exec/progcache.py"

# numpy reductions whose result is a data-dependent int/array of ints
_NP_SEEDS = {"numpy.bincount", "numpy.max", "numpy.min", "numpy.amax",
             "numpy.amin"}

# builtins that pass a data-dependent int through unchanged
_PASSTHRU = {"int", "max", "min", "abs", "round", "sorted"}

# the counted device->host boundary: what it returns is data
_FETCH = "presto_tpu_torch.exec.hostsync.fetch"


def _is_bucketer(q: str | None, fn: ast.AST) -> bool:
    """Calls that CLEAR taint: pow2 bucketing and the helpers built on
    it (bucket_capacities, bucket_scans, bucket_scan_inputs,
    bucket_by_partition)."""
    name = None
    if q is not None:
        name = q.rsplit(".", 1)[-1]
    elif isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    return name is not None and (
        name == "next_pow2" or name.startswith("bucket"))


class _SizeTaint:
    """Least-fixpoint provenance of unbucketed data-dependent values
    (same machinery as devicesync._DeviceTaint, different seeds)."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.param_taint: dict[tuple, set[str]] = {}
        self.returns_tainted: set[tuple] = set()
        self._stmts: dict[tuple, list[ast.AST]] = {}
        self._propagate()

    def stmts(self, u: _FnUnit) -> list[ast.AST]:
        out = self._stmts.get(u.key)
        if out is None:
            out = self._stmts[u.key] = list(u.own_statements())
        return out

    # -- expression provenance ---------------------------------------

    def is_tainted(self, node: ast.AST, env: set[str],
                   u: _FnUnit) -> bool:
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, (ast.Subscript, ast.Starred,
                             ast.NamedExpr, ast.Await)):
            return self.is_tainted(node.value, env, u)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e, env, u) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self.is_tainted(node.body, env, u)
                    or self.is_tainted(node.orelse, env, u))
        if isinstance(node, ast.BinOp):
            return (self.is_tainted(node.left, env, u)
                    or self.is_tainted(node.right, env, u))
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand, env, u)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v, env, u) for v in node.values)
        if isinstance(node, ast.Compare):
            # `cnt <= cap` is as data-dependent as cnt itself — this is
            # exactly how taint reaches a branch test
            return (self.is_tainted(node.left, env, u)
                    or any(self.is_tainted(c, env, u)
                           for c in node.comparators))
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp)):
            return self.is_tainted(node.elt, env, u)
        if isinstance(node, ast.Call):
            return self._call_is_tainted(node, env, u)
        # Attribute (x.shape — rides the key bucketed), Constant,
        # JoinedStr: not hazards in themselves
        return False

    def _call_is_tainted(self, call: ast.Call, env: set[str],
                         u: _FnUnit) -> bool:
        aliases = self.graph.alias_cache[u.mod.relpath]
        fn = call.func
        q = _resolve(qual_name(fn), aliases)
        if _is_bucketer(q, fn):
            return False  # bucketing clears — it IS the fix
        if q is not None:
            if q in _NP_SEEDS:
                return True
            if q == _FETCH:
                return True  # device values read back on the host
        if isinstance(fn, ast.Attribute):
            if fn.attr in ("item", "tolist"):
                return True  # a device value read back on the host
            if fn.attr in ("max", "min") and not (
                    q is not None and q.startswith(("torch.", "numpy."))):
                # arr.max() / counts.min(): a data-dependent reduction
                # (torch.max stays a device value — devicesync's
                # concern, not a host int; np.max is a seed via
                # _NP_SEEDS already)
                return True
            if self.is_tainted(fn.value, env, u):
                # counts.sum(), sizes.tolist(): still the data's value
                return True
        if isinstance(fn, ast.Name) and fn.id in _PASSTHRU:
            return any(self.is_tainted(a, env, u) for a in call.args)
        for callee in self.graph.resolve_call(u, call):
            if callee.key in self.returns_tainted:
                return True
        return False

    # -- per-unit name environment ------------------------------------

    def _flood(self, t: ast.AST, env: set[str]) -> bool:
        if isinstance(t, (ast.Tuple, ast.List)):
            grew = False
            for e in t.elts:
                grew |= self._flood(e, env)
            return grew
        if isinstance(t, ast.Starred):
            return self._flood(t.value, env)
        while isinstance(t, (ast.Subscript, ast.Attribute)):
            t = t.value
        if isinstance(t, ast.Name) and t.id not in env:
            env.add(t.id)
            return True
        return False

    def _assign(self, t: ast.AST, v: ast.AST, env: set[str],
                u: _FnUnit) -> bool:
        if isinstance(t, (ast.Tuple, ast.List)) and \
                isinstance(v, (ast.Tuple, ast.List)) and \
                len(t.elts) == len(v.elts) and not any(
                    isinstance(e, ast.Starred) for e in t.elts):
            grew = False
            for te, ve in zip(t.elts, v.elts):
                grew |= self._assign(te, ve, env, u)
            return grew
        if not self.is_tainted(v, env, u):
            return False
        return self._flood(t, env)

    def env(self, u: _FnUnit) -> set[str]:
        env = set(self.param_taint.get(u.key, ()))
        changed = True
        while changed:
            changed = False
            for stmt in self.stmts(u):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        changed |= self._assign(t, stmt.value, env, u)
                elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                    if stmt.value is not None:
                        changed |= self._assign(stmt.target,
                                                stmt.value, env, u)
                elif isinstance(stmt, ast.NamedExpr):
                    changed |= self._assign(stmt.target, stmt.value,
                                            env, u)
                elif isinstance(stmt, ast.For):
                    if self.is_tainted(stmt.iter, env, u):
                        changed |= self._flood(stmt.target, env)
        return env

    # -- interprocedural fixpoint -------------------------------------

    def _propagate(self) -> None:
        units = list(self.graph.units.values())
        changed = True
        while changed:
            changed = False
            for u in units:
                env = self.env(u)
                for stmt in self.stmts(u):
                    if isinstance(stmt, ast.Return) and \
                            stmt.value is not None and \
                            u.key not in self.returns_tainted and \
                            self.is_tainted(stmt.value, env, u):
                        self.returns_tainted.add(u.key)
                        changed = True
                    if not isinstance(stmt, ast.Call):
                        continue
                    if _is_bucketer(_resolve(qual_name(stmt.func),
                                             self.graph.alias_cache[
                                                 u.mod.relpath]),
                                    stmt.func):
                        continue  # taint dies at the bucketer's door
                    args = [(i, a) for i, a in enumerate(stmt.args)
                            if self.is_tainted(a, env, u)]
                    kwargs = [kw for kw in stmt.keywords
                              if kw.arg is not None
                              and self.is_tainted(kw.value, env, u)]
                    if not args and not kwargs:
                        continue
                    for callee, shift in _taint_targets(
                            self.graph, u, stmt):
                        cp = _params(callee)
                        tset = self.param_taint.setdefault(
                            callee.key, set())
                        for i, _a in args:
                            j = i + shift
                            if j < len(cp) and cp[j] not in tset:
                                tset.add(cp[j])
                                changed = True
                        for kw in kwargs:
                            if kw.arg in cp and kw.arg not in tset:
                                tset.add(kw.arg)
                                changed = True


class _Hazard:
    __slots__ = ("kind", "unit", "line", "col", "what")

    def __init__(self, kind: str, unit: _FnUnit, line: int, col: int,
                 what: str):
        self.kind = kind
        self.unit = unit
        self.line = line
        self.col = col
        self.what = what

    @property
    def exempt_id(self) -> str:
        return (f"{self.unit.mod.relpath}:"
                f"{'.'.join(self.unit.path)}:{self.kind}")


def _key_parts(v: ast.AST) -> list[ast.AST]:
    """The components of a key expression: a tuple's elements (through
    ``+`` of tuples), an f-string's fields."""
    if isinstance(v, ast.Tuple):
        return list(v.elts)
    if isinstance(v, ast.JoinedStr):
        return [f.value for f in v.values
                if isinstance(f, ast.FormattedValue)]
    if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add):
        return _key_parts(v.left) + _key_parts(v.right)
    return []


def _collect(graph: CallGraph, taint: _SizeTaint) -> list[_Hazard]:
    out: list[_Hazard] = []
    for key in sorted(graph.units):
        u = graph.units[key]
        env = taint.env(u)
        keyed_fn = "key" in u.name.lower()
        for stmt in taint.stmts(u):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = (stmt.targets
                           if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if not any(isinstance(t, ast.Name)
                           and "key" in t.id.lower() for t in targets):
                    continue
                v = stmt.value
            elif isinstance(stmt, ast.Return) and keyed_fn:
                v = stmt.value
            else:
                continue
            if v is not None and any(taint.is_tainted(p, env, u)
                                     for p in _key_parts(v)):
                out.append(_Hazard(
                    "key", u, stmt.lineno, stmt.col_offset,
                    "an unbucketed data-dependent component into a "
                    "cache key"))
    return out


@rule(RULE)
def retrace(project: Project) -> list[Finding]:
    graph = call_graph(project, SCOPES)
    if not graph.mods:
        return []
    findings: list[Finding] = []

    exempt: dict[str, tuple[str, int]] = {}
    exempt_mod = project.by_relpath.get(EXEMPT_PATH)
    if exempt_mod is not None:
        exempt = literal_str_dict(exempt_mod, "RETRACE_EXEMPT")

    taint = _SizeTaint(graph)
    hazards = _collect(graph, taint)

    used_exemptions: set[str] = set()

    def exempted(eid: str) -> bool:
        if eid in exempt:
            used_exemptions.add(eid)
            return True
        return False

    for h in hazards:
        if exempted(h.exempt_id):
            continue
        findings.append(Finding(
            RULE, h.unit.mod.relpath, h.line, h.col,
            f"capacity-memory miss: `{'.'.join(h.unit.path)}` feeds "
            f"{h.what} — each distinct value is a distinct program "
            "key, so the program cache and the capacity memory miss "
            "and the program climbs the retry ladder again (tests "
            "never see it: tiny fixed inputs land in one bucket); "
            "route the value through ops/sizes.next_pow2 (or a "
            f"bucket_* helper) or exempt '{h.exempt_id}' in "
            "progcache.RETRACE_EXEMPT with a justification"))

    for eid, (reason, line) in sorted(exempt.items()):
        if eid not in used_exemptions:
            findings.append(Finding(
                RULE, EXEMPT_PATH, line, 0,
                f"stale-exemption: RETRACE_EXEMPT entry {eid!r} "
                "matched no finding this run — the hazard it excused "
                "was bucketed, moved, or removed; delete the stale "
                "exemption (it would silently waive the next real "
                "hazard under that id)"))
        elif not reason:
            findings.append(Finding(
                RULE, EXEMPT_PATH, line, 0,
                f"RETRACE_EXEMPT entry {eid!r} needs a non-empty "
                "justification string"))
    return findings
