"""Device-boundary discipline: no hidden device->host syncs.

A host-blocking device read in the middle of the execute path —
``.item()`` on a CUDA scalar, ``.tolist()``/``.cpu()``/``.numpy()`` of
a CUDA tensor, ``np.asarray`` over one, ``int()``/``float()`` of a
0-d CUDA tensor, ``torch.cuda.synchronize()`` — stalls the host until
the stream drains and then pays a copy: every kernel queued behind it
waits, the host cannot queue the next one meanwhile, and one stray
``.item()`` in a stage walk turns an asynchronous stream into a
lock-step crawl. It costs nothing on a CPU engine, where the "copy" is
a view, so the tests never see it. The engine therefore has ONE
designated boundary — ``exec/hostsync.py`` (``fetch``, one batched
copy of a tree of tensors, counted per call site in ``SYNCS``) — and
this rule proves, whole-tree, that every sync on the execute path goes
through it.

The rule rides the shared ``lint/tracer.py`` ``CallGraph`` from the
execute-path roots (``exec/executor.prepare_plan``/``run_plan``,
``exec/batch.run_plan_batched``,
``parallel/executor.execute_plan_distributed``, the serve/result paths
in ``server/``, ``parallel/coordinator``, ``parallel/worker``, and the
``kernels/`` package, entered through its dispatch table) and asks,
for every reachable call site: is this a host-blocking sync, and is
the value a DEVICE value? Value provenance reuses the tracekey
least-fixpoint argument-taint over the call graph. Device-ness seeds
at:

- ``torch.*`` factories given a ``device=`` (``torch.zeros(n,
  device=dt.device)``), and ``torch.*`` ops over a device value;
- ``.to(<not the CPU>)``/``.cuda()`` and the methods of a device
  value, less those that return host metadata (``.shape``,
  ``.numel()``, ...);
- the kernels' entries (``kernels.run``, ``kernels.dispatch``),
  ``hostsync.upload`` and ``Engine.device_array``;
- the tensors of a ``DTable``/``Val`` (a constructor call, or a
  parameter or return annotated ``DTable``, ``Val`` or ``Tensor``,
  and the attributes that hold their tensors: ``live``, ``cols``,
  ``data``, ``valid``, ... — never ``n``, ``dtype`` or
  ``dictionary``);

and it propagates through tuple unpacking, subscripts, arithmetic,
comparisons, comprehensions, helper parameters, and return values. A
host ``np.ndarray`` is never a device value, and neither is a torch
tensor made on the CPU (``torch.from_numpy``, a factory without
``device=``, the host sorts of exec/varlen.py): ``.tolist()`` of
either is a host read, not a sync.

Findings (kind in the exemption id):

- ``torch.cuda.synchronize()`` and ``.synchronize()`` of a stream or
  an event outside the boundary: ALWAYS flagged (these exist only to
  sync);
- ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")``
  of a device value;
- ``np.asarray``/``np.array``/``np.ascontiguousarray`` of a device
  value (the implicit ``__array__`` round-trip);
- ``int()``/``float()``/``bool()`` of a device value (implicit
  concretization — one round-trip per flag instead of one per
  program).

Deliberate boundary reads are declared in
``exec/hostsync.DEVICE_SYNC_EXEMPT`` (id -> justification, id form
``<relpath>:<dotted.unit>:<kind>``) with kernel-parity-style
staleness enforcement: an entry matching no finding is itself a
finding.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import (Finding, Project, literal_str_dict,
                                        qual_name, rule)
from presto_tpu_torch.lint.tracekey import _params, _taint_targets
from presto_tpu_torch.lint.tracer import (_HOST_TORCH, _META_METHODS,
                                          _STATIC_TORCH,
                                          CallGraph, _FnUnit, _resolve,
                                          call_graph)

RULE = "device-sync"

# everything the execute path can reach: the trace scopes plus the
# serve/dispatch layers that demux results, the kernel wrappers, and
# the engine facade
SCOPES = (
    "presto_tpu_torch/ops/",
    "presto_tpu_torch/exec/",
    "presto_tpu_torch/expr/",
    "presto_tpu_torch/kernels/",
    "presto_tpu_torch/parallel/",
    "presto_tpu_torch/server/",
    "presto_tpu_torch/obs/",
    "presto_tpu_torch/templates/",
    "presto_tpu_torch/engine.py",
)

# the designated boundary: syncs INSIDE it are the point
BOUNDARY_PATH = "presto_tpu_torch/exec/hostsync.py"

# execute-path roots: whole serve/dispatch modules (every handler
# demuxes results), the named executor entry points, and the kernels
# package (entered through its dispatch table, which the call graph
# cannot follow)
_ROOT_MODULES = (
    "presto_tpu_torch/server/server.py",
    "presto_tpu_torch/server/results.py",
    "presto_tpu_torch/parallel/coordinator.py",
    "presto_tpu_torch/parallel/worker.py",
)
_ROOT_PREFIXES = ("presto_tpu_torch/kernels/",)
_ROOT_UNITS = (
    ("presto_tpu_torch/exec/executor.py", "prepare_plan"),
    ("presto_tpu_torch/exec/executor.py", "execute_plan"),
    ("presto_tpu_torch/exec/executor.py", "run_plan"),
    ("presto_tpu_torch/exec/executor.py", "run_plan_device"),
    ("presto_tpu_torch/exec/batch.py", "run_plan_batched"),
    ("presto_tpu_torch/parallel/executor.py", "execute_plan_distributed"),
    ("presto_tpu_torch/exec/streaming.py", "try_execute_streamed"),
    ("presto_tpu_torch/exec/spill.py", "try_execute_spilled"),
    ("presto_tpu_torch/exec/spill.py", "try_execute_grouped"),
    ("presto_tpu_torch/exec/profile.py", "explain_analyze"),
    ("presto_tpu_torch/exec/profile.py", "explain_analyze_distributed"),
)

# numpy coercions that call __array__ on a device value (one implicit
# device->host transfer each)
_NP_COERCE = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}

# builtins that concretize a device scalar
_CONCRETIZE = {"int", "float", "bool"}

# tensor methods that copy to the host
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

# the engine's device containers, and the attributes that carry their
# tensors: a DTable's live mask and columns, a Val's data, validity,
# array lengths and element mask, a ScanInput's arrays, a Program's
# output; a tensor's transposes and parts. Every other attribute (row
# counts, dtypes, dictionaries, a table's distribution) is host state
_CONTAINERS = {"DTable", "Val", "Tensor"}
_DEVICE_ATTRS = {"live", "cols", "data", "valid", "lengths", "emask",
                 "arrays", "out", "T", "mT", "real", "imag"}

# calls that return device values whatever their arguments
_DEVICE_CALLS = ("presto_tpu_torch.exec.hostsync.upload",
                 "presto_tpu_torch.kernels.run",
                 "presto_tpu_torch.kernels.dispatch")


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"``, ``torch.device("cpu")``: the target of a copy to the
    host."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args and \
            (qual_name(node.func) or "").endswith("device"):
        return _is_cpu(node.args[0])
    return False


def _to_target(call: ast.Call) -> ast.AST | None:
    """The device or dtype a ``.to(...)`` call names."""
    if call.args:
        return call.args[0]
    return next((kw.value for kw in call.keywords
                 if kw.arg == "device"), None)


def _is_dtype(node: ast.AST) -> bool:
    """``torch.int64``, ``v.dtype``, a name ``dtype``: a ``.to`` that
    converts in place, not a copy to another device."""
    q = qual_name(node) or ""
    return (q.startswith("torch.") and not isinstance(node, ast.Call)) \
        or q.rsplit(".", 1)[-1].endswith("dtype")


def _names_container(annotation: ast.AST | None) -> bool:
    """Does an annotation name a device container (``DTable``,
    ``Val | None``, ``torch.Tensor``, ``list[Tensor]``)?"""
    if annotation is None:
        return False
    for sub in ast.walk(annotation):
        if isinstance(sub, ast.Name) and sub.id in _CONTAINERS:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _CONTAINERS:
            return True
        if isinstance(sub, ast.Constant) and sub.value in _CONTAINERS:
            return True  # a quoted forward reference
    return False


def _roots(graph: CallGraph) -> set[tuple]:
    roots: set[tuple] = set()
    for key, u in graph.units.items():
        if u.mod.relpath in _ROOT_MODULES or \
                u.mod.relpath.startswith(_ROOT_PREFIXES):
            roots.add(key)
    for relpath, name in _ROOT_UNITS:
        for u in graph.named(relpath, name):
            roots.add(u.key)
    return roots


class _DeviceTaint:
    """Least-fixpoint device-value provenance over the call graph (the
    tracekey session-taint machinery applied to tensor values)."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.param_taint: dict[tuple, set[str]] = {}
        self.returns_device: set[tuple] = {
            u.key for u in graph.units.values()
            if u.mod.relpath != BOUNDARY_PATH
            and _names_container(u.node.returns)}
        self._stmts: dict[tuple, list[ast.AST]] = {}
        # a function whose every return is an n-tuple: n, and which of
        # its positions hold device values (``slots, capacity, sizes =
        # f()`` taints ``slots`` only)
        self.tuple_len: dict[tuple, int] = {}
        self.tuple_device: dict[tuple, set[int]] = {}
        for u in graph.units.values():
            self._tuple_returns(u)
        self._propagate()

    def _tuple_returns(self, u: _FnUnit) -> None:
        # ``return None`` (a fast path that does not apply) beside
        # n-tuples keeps the shape
        rets = [s.value for s in self.stmts(u)
                if isinstance(s, ast.Return) and s.value is not None
                and not (isinstance(s.value, ast.Constant)
                         and s.value.value is None)]
        lens = {len(r.elts) for r in rets if isinstance(r, ast.Tuple)}
        if rets and len(lens) == 1 and all(
                isinstance(r, ast.Tuple) for r in rets):
            self.tuple_len[u.key] = lens.pop()
        ann = u.node.returns
        if isinstance(ann, ast.Subscript) and \
                qual_name(ann.value) in ("tuple", "typing.Tuple",
                                         "Tuple") and \
                isinstance(ann.slice, ast.Tuple) and not any(
                    isinstance(e, ast.Constant) and e.value is Ellipsis
                    for e in ann.slice.elts) and \
                self.tuple_len.get(u.key, len(ann.slice.elts)) == \
                len(ann.slice.elts):
            self.tuple_len[u.key] = len(ann.slice.elts)
            self.tuple_device[u.key] = {
                i for i, e in enumerate(ann.slice.elts)
                if _names_container(e)}

    def stmts(self, u: _FnUnit) -> list[ast.AST]:
        out = self._stmts.get(u.key)
        if out is None:
            out = self._stmts[u.key] = list(u.own_statements())
        return out

    # -- expression provenance ---------------------------------------

    def is_device(self, node: ast.AST, env: set[str],
                  u: _FnUnit) -> bool:
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, (ast.Subscript, ast.Starred,
                             ast.NamedExpr, ast.Await)):
            return self.is_device(node.value, env, u)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_device(e, env, u) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.is_device(v, env, u) for v in node.values)
        if isinstance(node, ast.IfExp):
            return (self.is_device(node.body, env, u)
                    or self.is_device(node.orelse, env, u))
        if isinstance(node, ast.BinOp):
            return (self.is_device(node.left, env, u)
                    or self.is_device(node.right, env, u))
        if isinstance(node, ast.UnaryOp):
            return self.is_device(node.operand, env, u)
        if isinstance(node, ast.BoolOp):
            return any(self.is_device(v, env, u) for v in node.values)
        if isinstance(node, ast.Compare):
            # `live == 0` over a device tensor is a device tensor; an
            # identity test is a host bool
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            return any(self.is_device(v, env, u)
                       for v in [node.left] + node.comparators)
        if isinstance(node, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp)):
            return self.is_device(node.elt, env, u)
        if isinstance(node, ast.DictComp):
            return self.is_device(node.value, env, u)
        if isinstance(node, ast.Attribute):
            # a DTable's live mask, a Val's data: device; their shapes,
            # dtypes, row counts and dictionaries: host metadata
            return node.attr in _DEVICE_ATTRS and \
                self.is_device(node.value, env, u)
        if isinstance(node, ast.Call):
            return self._call_is_device(node, env, u)
        # Constant, JoinedStr, Lambda: host
        return False

    def _call_is_device(self, call: ast.Call, env: set[str],
                        u: _FnUnit) -> bool:
        aliases = self.graph.alias_cache[u.mod.relpath]
        fn = call.func
        q = _resolve(qual_name(fn), aliases)
        if q is not None:
            if q in _NP_COERCE or q.startswith("numpy."):
                return False  # numpy results live on the host
            if q in _DEVICE_CALLS:
                return True
            if q.startswith("torch."):
                if q.startswith(_HOST_TORCH) or q == "torch.from_numpy" \
                        or q.rsplit(".", 1)[1] in _STATIC_TORCH:
                    return False
                # a factory given a device, or an op over a device value
                return any(
                    (kw.arg == "device" and not _is_cpu(kw.value))
                    or self.is_device(kw.value, env, u)
                    for kw in call.keywords) or any(
                    self.is_device(a, env, u) for a in call.args)
        if isinstance(fn, ast.Call):
            # a kernel entry's callable: K.dispatch(name)(...)
            return self.is_device(fn, env, u)
        if isinstance(fn, ast.Name):
            # a device-returning callable bound to a local name
            if fn.id in env:
                return True
            if fn.id in _CONCRETIZE or fn.id == "len":
                return False
            if fn.id in _CONTAINERS:
                return True
        if isinstance(fn, ast.Attribute):
            if fn.attr in _SYNC_METHODS or fn.attr in _META_METHODS:
                return False  # the sync itself yields a HOST value
            if fn.attr == "to":
                target = _to_target(call)
                if target is None or _is_dtype(target):
                    return self.is_device(fn.value, env, u)
                return not _is_cpu(target)
            if fn.attr in ("cuda", "device_array") or \
                    fn.attr in _CONTAINERS:
                return True
            if self.is_device(fn.value, env, u):
                # a method of a device value (x.sum, live.any) stays
                # on the device
                return True
        for callee in self.graph.resolve_call(u, call):
            if callee.key in self.returns_device:
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
        # storing device data into a subscript taints the container (a
        # dict or list of tensors); an attribute store does not taint
        # its object: an engine, an interpreter or a run record holds
        # host state beside its tensors
        while isinstance(t, ast.Subscript):
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
        if isinstance(v, ast.Name):
            # ``direct = f(); a, b, c = direct``: unpack as the call
            v = self._single_call(u, v.id) or v
        if isinstance(t, (ast.Tuple, ast.List)) and \
                isinstance(v, ast.Call) and not any(
                    isinstance(e, ast.Starred) for e in t.elts):
            callees = list(self.graph.resolve_call(u, v))
            if callees and all(self.tuple_len.get(c.key) == len(t.elts)
                               for c in callees):
                grew = False
                for i, te in enumerate(t.elts):
                    if any(i in self.tuple_device.get(c.key, ())
                           for c in callees):
                        grew |= self._flood(te, env)
                return grew
        if not self.is_device(v, env, u):
            return False
        return self._flood(t, env)

    def _single_call(self, u: _FnUnit, name: str) -> ast.Call | None:
        """The call ``name`` is bound to, when ``u`` binds it once."""
        binds = [st.value for st in self.stmts(u)
                 if isinstance(st, ast.Assign) and any(
                     isinstance(t, ast.Name) and t.id == name
                     for t in st.targets)]
        if len(binds) != 1:
            return None
        v = binds[0]
        if isinstance(v, ast.IfExp):
            # ``f() if cond else None``
            arms = [a for a in (v.body, v.orelse)
                    if not (isinstance(a, ast.Constant)
                            and a.value is None)]
            v = arms[0] if len(arms) == 1 else v
        return v if isinstance(v, ast.Call) else None

    def env(self, u: _FnUnit) -> set[str]:
        env = set(self.param_taint.get(u.key, ()))
        a = u.node.args
        env.update(p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                   if _names_container(p.annotation))
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
                    # iterating a device value yields device elements
                    if self.is_device(stmt.iter, env, u):
                        changed |= self._flood(stmt.target, env)
        return env

    # -- interprocedural fixpoint -------------------------------------

    def _propagate(self) -> None:
        units = list(self.graph.units.values())
        changed = True
        while changed:
            changed = False
            for u in units:
                if u.mod.relpath == BOUNDARY_PATH:
                    continue  # fetch returns HOST values
                env = self.env(u)
                for stmt in self.stmts(u):
                    if isinstance(stmt, ast.Return) and \
                            stmt.value is not None:
                        if u.key not in self.returns_device and \
                                self.is_device(stmt.value, env, u):
                            self.returns_device.add(u.key)
                            changed = True
                        if u.key in self.tuple_len and \
                                isinstance(stmt.value, ast.Tuple):
                            pos = self.tuple_device.setdefault(u.key,
                                                               set())
                            for i, e in enumerate(stmt.value.elts):
                                if i not in pos and \
                                        self.is_device(e, env, u):
                                    pos.add(i)
                                    changed = True
                    if not isinstance(stmt, ast.Call):
                        continue
                    args = [(i, a) for i, a in enumerate(stmt.args)
                            if self.is_device(a, env, u)]
                    kwargs = [kw for kw in stmt.keywords
                              if kw.arg is not None
                              and self.is_device(kw.value, env, u)]
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


class _Sync:
    """One host-blocking sync call site."""

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


def _collect_syncs(graph: CallGraph, taint: _DeviceTaint,
                   reachable: set[tuple]) -> list[_Sync]:
    syncs: list[_Sync] = []
    for key in sorted(reachable):
        u = graph.units.get(key)
        if u is None or u.mod.relpath == BOUNDARY_PATH:
            continue
        aliases = graph.alias_cache[u.mod.relpath]
        env = taint.env(u)
        for stmt in taint.stmts(u):
            if not isinstance(stmt, ast.Call):
                continue
            fn = stmt.func
            q = _resolve(qual_name(fn), aliases)
            if q == "torch.cuda.synchronize" or (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "synchronize"):
                what = ("torch.cuda.synchronize"
                        if q == "torch.cuda.synchronize"
                        else ".synchronize")
                syncs.append(_Sync("synchronize", u, stmt.lineno,
                                   stmt.col_offset, f"`{what}()`"))
                continue
            if q in _NP_COERCE and stmt.args and \
                    taint.is_device(stmt.args[0], env, u):
                syncs.append(_Sync(
                    "asarray", u, stmt.lineno, stmt.col_offset,
                    f"`{q.replace('numpy.', 'np.')}` over a device "
                    "value (implicit `__array__` transfer)"))
                continue
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _SYNC_METHODS and \
                    taint.is_device(fn.value, env, u):
                syncs.append(_Sync(
                    fn.attr, u, stmt.lineno, stmt.col_offset,
                    f"`.{fn.attr}()` on a device value"))
                continue
            if isinstance(fn, ast.Attribute) and fn.attr == "to":
                target = _to_target(stmt)
                if target is not None and _is_cpu(target) and \
                        taint.is_device(fn.value, env, u):
                    syncs.append(_Sync(
                        "to_cpu", u, stmt.lineno, stmt.col_offset,
                        "`.to(\"cpu\")` of a device value"))
                continue
            if isinstance(fn, ast.Name) and fn.id in _CONCRETIZE and \
                    len(stmt.args) == 1 and \
                    taint.is_device(stmt.args[0], env, u):
                syncs.append(_Sync(
                    fn.id, u, stmt.lineno, stmt.col_offset,
                    f"`{fn.id}()` of a device value (implicit "
                    "concretization)"))
    return syncs


@rule(RULE)
def device_sync(project: Project) -> list[Finding]:
    graph = call_graph(project, SCOPES)
    if not graph.mods:
        return []
    findings: list[Finding] = []

    exempt: dict[str, tuple[str, int]] = {}
    boundary_mod = project.by_relpath.get(BOUNDARY_PATH)
    if boundary_mod is not None:
        exempt = literal_str_dict(boundary_mod, "DEVICE_SYNC_EXEMPT")

    roots = _roots(graph)
    if not roots:
        return []
    taint = _DeviceTaint(graph)
    reachable = graph.reachable(roots)
    syncs = _collect_syncs(graph, taint, reachable)

    used_exemptions: set[str] = set()

    def exempted(eid: str) -> bool:
        if eid in exempt:
            used_exemptions.add(eid)
            return True
        return False

    for s in syncs:
        if exempted(s.exempt_id):
            continue
        where = f"execute-path `{'.'.join(s.unit.path)}`"
        findings.append(Finding(
            RULE, s.unit.mod.relpath, s.line, s.col,
            f"hidden host sync: {where} calls {s.what} outside the "
            "exec/hostsync boundary — every occurrence blocks the "
            "host until the stream drains and serializes the kernel "
            "queue; batch it through hostsync.fetch (counted in "
            "hostsync.SYNCS) or exempt "
            f"'{s.exempt_id}' in DEVICE_SYNC_EXEMPT with a "
            "justification"))

    # exemption hygiene: the registry must not rot (kernel-parity's
    # staleness discipline)
    for eid, (reason, line) in sorted(exempt.items()):
        if eid not in used_exemptions:
            findings.append(Finding(
                RULE, BOUNDARY_PATH, line, 0,
                f"stale-exemption: DEVICE_SYNC_EXEMPT entry {eid!r} "
                "matched no finding this run — the sync it excused "
                "was fixed, moved, or routed through the boundary; "
                "delete the stale exemption (it would silently waive "
                "the next real sync under that id)"))
        elif not reason:
            findings.append(Finding(
                RULE, BOUNDARY_PATH, line, 0,
                f"DEVICE_SYNC_EXEMPT entry {eid!r} needs a non-empty "
                "justification string"))
    return findings
