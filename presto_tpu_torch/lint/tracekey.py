"""Program-key provenance: prove the program-cache key sound.

The program cache and the capacity memory beside it
(exec/progcache.py, ``engine._caps_memory``) are keyed by
``exec/executor._cache_key``: the plan fingerprint, the scan shapes,
the dictionaries' contents, the session properties of
``TRACE_RELEVANT_PROPERTIES`` and the platform fingerprint (torch,
device, kernel backend). A hit starts the program from the capacity
vector remembered under that key and reuses the meta recorded with it
(the output layout, the ok-flag and capacity keys, the kernel notes).
So every AMBIENT input that shapes what the interpreter runs (session
property, environment variable, mutable module global) must either
participate in the key or provably never vary between queries. A
missed input lets two queries that differ only in it share one entry:
the second starts from capacities, and reports kernel notes, recorded
under the first's setting, and a setting that changes which operators
run (a kernel backend, a join strategy) changes which capacity keys
exist at all (the reference defends the analogous planner seam with
PlanSanityChecker; "Fine-Tuning Data Structures" frames the
specialization-vs-invalidation contract this rule machine-checks).

The rule rides the vmap-reachability call graph (lint/tracer.py
``CallGraph``) from the entry points of a program's pass — the
``PlanInterpreter``/``ShardedInterpreter`` ``_r_*`` dispatch, the
``ExprCompiler`` ``_c_*`` dispatch, the ``kernels/`` package behind
its dispatch table, ``templates/runtime.py``, and the vmap roots
themselves — and reports three finding classes:

- **unsound-read**: a ``session.get``/``os.environ``/``os.getenv``
  read reachable from a pass entry whose key is not in
  ``TRACE_RELEVANT_PROPERTIES`` (session objects are tracked across
  aliases, parameters, and helper calls by a least-fixpoint argument
  taint, the entry-lockset machinery of lint/locks.py applied to
  values);
- **stale-key-entry**: a ``TRACE_RELEVANT_PROPERTIES`` entry no
  pass-reachable code reads — dead key entries split warm entries
  (their capacities climb the ladder again) and mask real drift;
- **unkeyed-global**: a module-level mutable container read inside a
  pass and mutated anywhere outside import time/``__init__`` —
  state that can change between queries without shifting any key.
  Mutation sites are scanned over the WHOLE analyzed project (a
  sibling module writing ``tables.LIMITS[k] = v`` through an import
  alias is as unsound as the defining module doing it), while reads
  only count inside pass-reachable units.

Deliberate host-control-plane reads and content-derived memoization
caches are declared in ``exec/progcache.TRACE_KEY_EXEMPT`` (id ->
justification). Exemptions carry the same staleness enforcement as the
kernel-parity registry: an entry that matches no finding this run is
itself a finding, so the registry cannot rot into a blanket waiver.

Exemption id forms: ``session:<property>``, ``env:<NAME>``,
``global:<relpath>:<NAME>``, ``key:<property>`` (stale-key-entry),
``dynamic:<relpath>:<function>`` (non-literal read key).
"""

from __future__ import annotations

import ast
from typing import Iterator

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                        literal_str_dict, qual_name, rule)
from presto_tpu_torch.lint.tracer import (TRACE_SCOPES, CallGraph,
                                          _collect_units, _FnUnit,
                                          _resolve, call_graph)

RULE = "tracekey"

# where a program's pass runs: the tracer family's scopes (the kernel
# bodies among them) plus the template runtime and the cost helpers
# the interpreters call mid-pass (cost/model.decide_join_distribution)
SCOPES = TRACE_SCOPES + (
    "presto_tpu_torch/templates/",
    "presto_tpu_torch/cost/",
)

REGISTRY_PATH = "presto_tpu_torch/exec/progcache.py"

_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                  "deque", "Counter"}
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "add", "discard", "setdefault",
             "appendleft", "extendleft"}


# -- registry parsing (static, like lint/kernels.py) ------------------------

def _literal_tuple(mod: SourceModule, name: str
                   ) -> dict[str, int] | None:
    """``name = ("a", "b", ...)`` at module level -> {value: line};
    None when absent or not a literal tuple of strings."""
    for node in mod.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
            continue
        value = node.value
        if not isinstance(value, (ast.Tuple, ast.List)):
            return None
        out: dict[str, int] = {}
        for e in value.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            out[e.value] = e.lineno
        return out
    return None


# -- pass entry points ------------------------------------------------------

def _trace_roots(graph: CallGraph) -> set[tuple]:
    """Entry points of a program's pass: vmap roots (the batched lane
    pass and the lane rules), every method of a ``_r_*``/``_c_*`` dispatch
    class (the interpreter/compiler pattern: ``run``/``compile``
    reaches handlers through getattr, so the whole class is live), the
    whole kernels package (entered through its dispatch table), and
    the template runtime (entered through ir.Parameter resolution)."""
    roots, _statics = graph.find_roots()
    roots = set(roots)
    for (relpath, _cname), method_paths in graph.classes.items():
        if any(p[-1].startswith(("_r_", "_c_")) for p in method_paths):
            for p in method_paths:
                if (relpath, p) in graph.units:
                    roots.add((relpath, p))
    for key, u in graph.units.items():
        rp = u.mod.relpath
        if rp.startswith("presto_tpu_torch/kernels/") or \
                rp == "presto_tpu_torch/templates/runtime.py":
            roots.add(key)
    return roots


# -- session taint ----------------------------------------------------------

def _params(u: _FnUnit) -> list[str]:
    a = u.node.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _is_method(u: _FnUnit) -> bool:
    a = u.node.args
    pos = a.posonlyargs + a.args
    return bool(pos) and pos[0].arg in ("self", "cls")


def _session_expr(node: ast.AST, names: set[str]) -> bool:
    """Does ``node`` syntactically denote a session? A name the taint
    fixpoint established (or the ``session`` naming convention), or an
    attribute whose final segment is ``session`` (``self.session``,
    ``engine.session``, ``interp.session`` — receiver chains dropped
    like lint/locks.py lock names: one session reaches pass code
    through many spellings)."""
    if isinstance(node, ast.Name):
        return node.id == "session" or node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr == "session"
    return False


def _session_names(u: _FnUnit, param_taint: dict[tuple, set[str]]
                   ) -> set[str]:
    """Names that hold a session inside ``u``: tainted/convention
    parameters plus local aliases (``s = self.session``), closed
    transitively within the unit."""
    names = set(param_taint.get(u.key, ()))
    names.update(p for p in _params(u) if p == "session")
    changed = True
    while changed:
        changed = False
        for stmt in u.own_statements():
            if isinstance(stmt, ast.Assign) and \
                    len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name) and \
                    _session_expr(stmt.value, names) and \
                    stmt.targets[0].id not in names:
                names.add(stmt.targets[0].id)
                changed = True
    return names


def _taint_targets(graph: CallGraph, u: _FnUnit, call: ast.Call
                   ) -> Iterator[tuple[_FnUnit, int]]:
    """(callee unit, positional shift) pairs for one call site: a
    method called through a receiver (or a class constructor) binds
    ``self`` first, so positional argument i lands on parameter i+1."""
    aliases = graph.alias_cache[u.mod.relpath]
    fn = call.func

    def functions(relpath: str, name: str):
        for t in graph.by_name.get((relpath, name), []):
            yield t, 1 if _is_method(t) and not isinstance(
                fn, ast.Name) else 0

    def inits(relpath: str, name: str):
        for p in graph.classes.get((relpath, name), []):
            if p[-1] == "__init__" and (relpath, p) in graph.units:
                yield graph.units[(relpath, p)], 1

    if isinstance(fn, ast.Name):
        if fn.id == "getattr":
            return
        relpath, name = u.mod.relpath, fn.id
        tq = aliases.get(fn.id)
        if tq and "." in tq:
            tmod, _, tname = tq.rpartition(".")
            m = graph.mod_by_name.get(tmod)
            if m is not None:
                relpath, name = m.relpath, tname
        yield from functions(relpath, name)
        yield from inits(relpath, name)
    elif isinstance(fn, ast.Attribute):
        base = _resolve(qual_name(fn.value), aliases)
        m = graph.mod_by_name.get(base) if base else None
        relpath = m.relpath if m is not None else u.mod.relpath
        yield from functions(relpath, fn.attr)
        yield from inits(relpath, fn.attr)


def _propagate_session_taint(graph: CallGraph,
                             reachable: list[_FnUnit]
                             ) -> dict[tuple, set[str]]:
    """Least fixpoint over call sites (the entry-lockset machinery of
    lint/locks.py applied to values): a parameter is session-tainted
    when ANY observed pass-reachable call site passes a session
    expression in its position — taint only grows, so helpers taking
    a session under another name are followed to any depth."""
    param_taint: dict[tuple, set[str]] = {}
    changed = True
    while changed:
        changed = False
        for u in reachable:
            names = _session_names(u, param_taint)
            for stmt in u.own_statements():
                if not isinstance(stmt, ast.Call):
                    continue
                args = [(i, a) for i, a in enumerate(stmt.args)
                        if _session_expr(a, names)]
                kwargs = [kw for kw in stmt.keywords
                          if kw.arg is not None
                          and _session_expr(kw.value, names)]
                if not args and not kwargs:
                    continue
                for callee, shift in _taint_targets(graph, u, stmt):
                    cp = _params(callee)
                    tset = param_taint.setdefault(callee.key, set())
                    for i, _a in args:
                        j = i + shift
                        if j < len(cp) and cp[j] not in tset:
                            tset.add(cp[j])
                            changed = True
                    for kw in kwargs:
                        if kw.arg in cp and kw.arg not in tset:
                            tset.add(kw.arg)
                            changed = True
    return param_taint


# -- ambient reads ----------------------------------------------------------

class _Read:
    """One ambient read inside a pass-reachable unit."""

    __slots__ = ("kind", "key", "unit", "line", "col")

    def __init__(self, kind: str, key: str, unit: _FnUnit, line: int,
                 col: int):
        self.kind = kind  # "session" | "env" | "dynamic"
        self.key = key
        self.unit = unit
        self.line = line
        self.col = col

    @property
    def exempt_id(self) -> str:
        if self.kind == "dynamic":
            return (f"dynamic:{self.unit.mod.relpath}:"
                    f"{'.'.join(self.unit.path)}")
        return f"{self.kind}:{self.key}"


def _collect_reads(graph: CallGraph, reachable: list[_FnUnit],
                   param_taint: dict[tuple, set[str]]) -> list[_Read]:
    reads: list[_Read] = []
    for u in reachable:
        aliases = graph.alias_cache[u.mod.relpath]
        names = _session_names(u, param_taint)
        for stmt in u.own_statements():
            if isinstance(stmt, ast.Subscript) and \
                    isinstance(stmt.ctx, ast.Load):
                if _resolve(qual_name(stmt.value),
                            aliases) == "os.environ":
                    sl = stmt.slice
                    if isinstance(sl, ast.Constant) and \
                            isinstance(sl.value, str):
                        reads.append(_Read("env", sl.value, u,
                                           stmt.lineno,
                                           stmt.col_offset))
                    else:
                        reads.append(_Read("dynamic", "os.environ[?]",
                                           u, stmt.lineno,
                                           stmt.col_offset))
                continue
            if not isinstance(stmt, ast.Call):
                continue
            rq = _resolve(qual_name(stmt.func), aliases)
            env_call = rq == "os.getenv" or (
                isinstance(stmt.func, ast.Attribute)
                and stmt.func.attr == "get"
                and _resolve(qual_name(stmt.func.value),
                             aliases) == "os.environ")
            session_call = (not env_call
                            and isinstance(stmt.func, ast.Attribute)
                            and stmt.func.attr == "get"
                            and _session_expr(stmt.func.value, names))
            if not env_call and not session_call:
                continue
            kind = "env" if env_call else "session"
            if stmt.args and isinstance(stmt.args[0], ast.Constant) \
                    and isinstance(stmt.args[0].value, str):
                reads.append(_Read(kind, stmt.args[0].value, u,
                                   stmt.lineno, stmt.col_offset))
            else:
                reads.append(_Read("dynamic", f"{kind} read", u,
                                   stmt.lineno, stmt.col_offset))
    return reads


# -- mutable module globals -------------------------------------------------

def _module_mutable_globals(mod: SourceModule) -> dict[str, int]:
    """Module-level ``NAME = <mutable container>`` assignments."""
    out: dict[str, int] = {}
    for node in mod.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        value = getattr(node, "value", None)
        if value is None:
            continue
        mutable = isinstance(value, _MUTABLE_LITERALS)
        if isinstance(value, ast.Call):
            q = value.func
            leaf = (q.id if isinstance(q, ast.Name)
                    else getattr(q, "attr", None))
            mutable = leaf in _MUTABLE_CTORS
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id != "__all__":
                out[t.id] = node.lineno
    return out


def _decorator_factory_names(mod: SourceModule) -> set[str]:
    """Module-local names used in decorator position: a registration
    decorator's table mutation runs when the decorated definition is
    executed — import time for this codebase's module-level tables."""
    out: set[str] = set()
    for node in mod.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            for dec in node.decorator_list:
                t = dec.func if isinstance(dec, ast.Call) else dec
                while isinstance(t, ast.Attribute):
                    t = t.value
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _shadows(u: _FnUnit, name: str) -> bool:
    """Is ``name`` a local of ``u`` (parameter or plain assignment
    without a ``global`` declaration)? Then its accesses are not the
    module global's."""
    if name in _params(u):
        return True
    has_global = any(isinstance(s, ast.Global) and name in s.names
                     for s in u.own_statements())
    if has_global:
        return False
    for stmt in u.own_statements():
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target]
                   if isinstance(stmt, (ast.AnnAssign, ast.For)) else [])
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                return True
    return False


def _root_target(node: ast.AST, aliases: dict[str, str],
                 mod_relpaths: dict[str, str], own_relpath: str
                 ) -> tuple[str, str] | None:
    """(defining module relpath, global name) a mutated expression
    bottoms out at: a bare ``NAME`` (this module's global) or a
    ``MOD.NAME`` attribute chain whose base resolves to a known
    module through the import aliases (cross-module mutation)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return (own_relpath, node.id)
    if isinstance(node, ast.Attribute):
        # peel trailing attribute segments down to MOD.NAME
        while isinstance(node.value, ast.Attribute) and \
                _resolve(qual_name(node.value), aliases) not in \
                mod_relpaths:
            node = node.value
        base = _resolve(qual_name(node.value), aliases)
        relpath = mod_relpaths.get(base) if base else None
        if relpath is not None:
            return (relpath, node.attr)
    return None


def _enclosing_unit(mod: SourceModule, node: ast.AST
                    ) -> _FnUnit | None:
    """The innermost function unit whose span contains ``node``, or
    None for module-level code (import time). Only evaluated for the
    handful of candidate mutation HITS — never per statement."""
    best: _FnUnit | None = None
    for u in _collect_units([mod]).values():
        lo = u.node.lineno
        hi = getattr(u.node, "end_lineno", lo) or lo
        if lo <= node.lineno <= hi and \
                (best is None or lo > best.node.lineno):
            best = u
    return best


def _runtime_mutations(project: Project,
                       candidates: dict[str, dict[str, int]]
                       ) -> dict[tuple[str, str], tuple[str, int]]:
    """(defining module relpath, global name) -> (where, line) of one
    RUNTIME mutation site of a candidate global, scanned over the
    WHOLE analyzed project — a sibling module writing
    ``tables.LIMITS[k] = v`` through an import alias is as unsound as
    the defining module doing it. Import-time mutation is exempt:
    module-level statements (no enclosing function) and units
    enclosed by a module-level decorator factory (``@scalar("add")``
    executing ``SCALARS[name] = fn`` while the module body runs) or
    by ``__init__`` (construction-time registration) are skipped.
    One pass over each module's CACHED flat walk with a name
    prefilter, so the whole-project sweep costs isinstance checks —
    not a re-walk (the wall-budget regression class). Cached on the
    project."""
    cached = getattr(project, "_tracekey_mutations", None)
    if cached is not None:
        return cached
    name_union = {g for gs in candidates.values() for g in gs}
    mod_relpaths: dict[str, str] = {}
    for m in project.modules:
        mod_relpaths[m.modname] = m.relpath
        if m.modname.endswith(".__init__"):
            mod_relpaths[m.modname[:-len(".__init__")]] = m.relpath
    out: dict[tuple[str, str], tuple[str, int]] = {}
    for mod in project.modules:
        deco_names: set[str] | None = None  # computed on first hit

        def record(target: ast.AST, node: ast.AST) -> None:
            nonlocal deco_names
            # cheap prefilter before any resolution work: the final
            # rooted name must be a candidate global's name
            probe = target
            while isinstance(probe, ast.Subscript):
                probe = probe.value
            leaf = (probe.id if isinstance(probe, ast.Name)
                    else probe.attr
                    if isinstance(probe, ast.Attribute) else None)
            if leaf not in name_union:
                return
            hit = _root_target(target, mod.aliases, mod_relpaths,
                               mod.relpath)
            if hit is None or hit in out or \
                    hit[1] not in candidates.get(hit[0], ()):
                return
            u = _enclosing_unit(mod, node)
            if u is None:  # module level: import time
                return
            if deco_names is None:
                deco_names = _decorator_factory_names(mod)
            if u.path[0] in deco_names or "__init__" in u.path:
                return
            if hit[0] == mod.relpath and _shadows(u, hit[1]):
                return
            out[hit] = (f"{mod.relpath}:{'.'.join(u.path)}",
                        node.lineno)

        for stmt in mod.walk():
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                targets = (stmt.targets
                           if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        record(t, stmt)
                    elif isinstance(t, ast.Name) and \
                            t.id in name_union and \
                            (u := _enclosing_unit(mod, stmt)) \
                            is not None and any(
                                isinstance(s, ast.Global)
                                and t.id in s.names
                                for s in u.own_statements()):
                        record(t, stmt)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        record(t, stmt)
            elif isinstance(stmt, ast.Call) and \
                    isinstance(stmt.func, ast.Attribute) and \
                    stmt.func.attr in _MUTATORS:
                record(stmt.func.value, stmt)
    project._tracekey_mutations = out
    return out
    return out


def _global_trace_reads(graph: CallGraph, reachable: list[_FnUnit],
                        per_mod: dict[str, dict[str, int]]
                        ) -> dict[tuple[str, str], tuple[str, int]]:
    """(module relpath, global name) -> (reading unit, line) for every
    mutable module global read inside a pass-reachable unit — bare
    name loads in the defining module plus ``MOD.NAME`` attribute
    loads resolved through the import aliases."""
    out: dict[tuple[str, str], tuple[str, int]] = {}
    for u in reachable:
        own = per_mod.get(u.mod.relpath, {})
        aliases = graph.alias_cache[u.mod.relpath]
        for stmt in u.own_statements():
            if isinstance(stmt, ast.Name) and \
                    isinstance(stmt.ctx, ast.Load):
                if stmt.id in own and not _shadows(u, stmt.id):
                    out.setdefault((u.mod.relpath, stmt.id),
                                   (".".join(u.path), stmt.lineno))
            elif isinstance(stmt, ast.Attribute) and \
                    isinstance(stmt.ctx, ast.Load):
                base = _resolve(qual_name(stmt.value), aliases)
                m = graph.mod_by_name.get(base) if base else None
                if m is not None and \
                        stmt.attr in per_mod.get(m.relpath, {}):
                    out.setdefault((m.relpath, stmt.attr),
                                   (".".join(u.path), stmt.lineno))
    return out


# -- the rule ---------------------------------------------------------------

@rule(RULE)
def tracekey(project: Project) -> list[Finding]:
    graph = call_graph(project, SCOPES)
    if not graph.mods:
        return []
    findings: list[Finding] = []

    reg_mod = project.by_relpath.get(REGISTRY_PATH)
    known: dict[str, int] = {}
    exempt: dict[str, tuple[str, int]] = {}
    if reg_mod is not None:
        parsed = _literal_tuple(reg_mod, "TRACE_RELEVANT_PROPERTIES")
        if parsed is None:
            return [Finding(
                RULE, REGISTRY_PATH, 1, 0,
                "TRACE_RELEVANT_PROPERTIES must be a literal tuple of "
                "property-name strings (the cache-key contract is "
                "checked statically against it)")]
        known = parsed
        exempt = literal_str_dict(reg_mod, "TRACE_KEY_EXEMPT")

    roots = _trace_roots(graph)
    reach_keys = graph.reachable(roots)
    reachable = [graph.units[k] for k in sorted(reach_keys)
                 if k in graph.units]
    param_taint = _propagate_session_taint(graph, reachable)
    reads = _collect_reads(graph, reachable, param_taint)

    used_exemptions: set[str] = set()

    def exempted(eid: str) -> bool:
        if eid in exempt:
            used_exemptions.add(eid)
            return True
        return False

    # (a) unsound reads
    read_keys: set[str] = set()
    for r in reads:
        where = f"pass-reachable `{'.'.join(r.unit.path)}`"
        if r.kind == "session":
            read_keys.add(r.key)
            if r.key in known or exempted(r.exempt_id):
                continue
            findings.append(Finding(
                RULE, r.unit.mod.relpath, r.line, r.col,
                f"unsound-read: {where} reads session property "
                f"{r.key!r}, which is not in "
                "TRACE_RELEVANT_PROPERTIES — two queries differing "
                f"only in {r.key!r} would share one program-cache "
                "entry, and the second would start from the "
                "capacities and meta recorded under the first's "
                "setting; add the key to "
                "TRACE_RELEVANT_PROPERTIES (exec/progcache.py) or "
                "exempt it in TRACE_KEY_EXEMPT with a justification"))
        elif r.kind == "env":
            if exempted(r.exempt_id):
                continue
            findings.append(Finding(
                RULE, r.unit.mod.relpath, r.line, r.col,
                f"unsound-read: {where} reads environment variable "
                f"{r.key!r}, which participates in no cache key — an "
                "entry recorded under a different value would be "
                "served unchanged; fold it into the platform "
                "fingerprint (exec/progcache.platform_fingerprint) or "
                "exempt it in TRACE_KEY_EXEMPT with a justification"))
        else:
            if exempted(r.exempt_id):
                continue
            findings.append(Finding(
                RULE, r.unit.mod.relpath, r.line, r.col,
                f"unsound-read: {where} performs an ambient read with "
                "a non-literal key — the provenance analysis cannot "
                "prove it keyed; use a literal key or exempt "
                f"{r.exempt_id!r} in TRACE_KEY_EXEMPT"))

    # (b) stale key entries
    for prop, line in sorted(known.items()):
        if prop in read_keys or exempted(f"key:{prop}"):
            continue
        findings.append(Finding(
            RULE, REGISTRY_PATH, line, 0,
            f"stale-key-entry: TRACE_RELEVANT_PROPERTIES lists "
            f"{prop!r} but no pass-reachable code reads it — a dead "
            "key entry splits warm entries whenever the property "
            "flips and masks real key drift; delete it (host-side "
            "reads are captured by the plan fingerprint or explicit "
            f"key components) or exempt 'key:{prop}' with a "
            "justification"))

    # (c) unkeyed mutable globals
    per_mod = {m.relpath: _module_mutable_globals(m)
               for m in graph.mods}
    greads = _global_trace_reads(graph, reachable, per_mod)
    mutations = _runtime_mutations(project, per_mod) if greads else {}
    for (relpath, gname), (runit, rline) in sorted(greads.items()):
        if (relpath, gname) not in mutations:
            continue  # import-time-only: content is process-constant
        if exempted(f"global:{relpath}:{gname}"):
            continue
        munit, mline = mutations[(relpath, gname)]
        findings.append(Finding(
            RULE, relpath, per_mod[relpath][gname], 0,
            f"unkeyed-global: module global {gname!r} is read in a "
            f"program's pass ({runit} line {rline}) and mutated at "
            f"runtime (`{munit}` line {mline}) — its contents shape "
            "what the pass runs but participate in no cache key, so a "
            "mutation between queries serves a stale entry; key "
            "its contents, make it import-time-only, or exempt "
            f"'global:{relpath}:{gname}' in TRACE_KEY_EXEMPT with a "
            "justification"))

    # exemption hygiene: the registry must not rot (kernel-parity's
    # staleness discipline)
    for eid, (reason, line) in sorted(exempt.items()):
        if eid not in used_exemptions:
            findings.append(Finding(
                RULE, REGISTRY_PATH, line, 0,
                f"stale-exemption: TRACE_KEY_EXEMPT entry {eid!r} "
                "matched no finding this run — the read it excused "
                "was fixed, moved, or re-keyed; delete the stale "
                "exemption (it would silently waive the next real "
                "finding under that id)"))
        elif not reason:
            findings.append(Finding(
                RULE, REGISTRY_PATH, line, 0,
                f"TRACE_KEY_EXEMPT entry {eid!r} needs a non-empty "
                "justification string"))
    return findings
