"""Tracer-hygiene rules: Python-level inspection of batched tensors.

The port runs eagerly and traces nothing, except in one place: a
cross-query batch (``exec/batch.py``) runs one lane's plan pass under
``torch.func.vmap``, so every function that pass reaches sees
``BatchedTensor`` wrappers instead of tensors. Inspecting one from
Python raises at run time: ``.item()``, ``.tolist()``,
``int()``/``float()``/``bool()``, an ``if``/``while``/``assert`` on a
tensor, ``torch.nonzero``, ``torch.masked_select`` and boolean-mask
indexing (a data-dependent output shape) all fail with "vmap: It looks
like you're ...". numpy on a batched tensor fails the same way (its
``__array__`` reads the data). The serial path runs the same code on
plain tensors, where all of these work, so a branch on a tensor in an
operator passes every serial test and fails only on the batched path:
the counterpart of the reference's "crashes at trace time on a
rarely-hit path".

Reachability: vmap roots are functions handed to ``torch.func.vmap``
(``torch.vmap``, ``functorch.vmap``; decorator or call form) and the
lane rules registered with ``<op>.register_vmap`` (kernels/lanes.py).
A lane rule is called with its lanes stacked into plain tensors, one
call for all K lanes, and only on the batched path: a host read or a
data-dependent shape there breaks the ``(K, ...)`` layout it must
return or syncs once per batch, again where no serial test looks. The
rule follows calls from the roots through the scoped modules — plain
calls, imported-module attribute calls (``OP.f()``), and same-module
method calls; a ``getattr(self, ...)`` computed dispatch marks the
whole class reachable (the PlanInterpreter pattern). Host-side driver
code in the same files (the retry ladder, result demux) is outside
this set.

"Tensor value" is detected syntactically: a ``torch.*`` call (less the
functions that return metadata: dtypes, devices, ``finfo``/``iinfo``,
``is_tensor``, ...), a local name assigned from one, or an expression
over them; metadata reads (``x.dtype``, ``x.shape[0]``, ``x.numel()``)
and identity tests (``x is None``) are host values. Host work on numpy
arrays and Python ints — the dictionary transforms, shape arithmetic —
is deliberately not flagged; that asymmetry is what keeps the rule
enforceable at zero findings.

``tracer-static-arg`` checks what a vmap checks at call time and a
serial run never does: a literal ``in_dims`` tuple has one entry per
positional parameter of the mapped function, a lane rule's parameters
are ``(info, in_dims, <the custom op's parameters>)``, and no root has
a mutable default (state shared by every lane and every batch).
"""

from __future__ import annotations

import ast
from typing import Iterator

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                        qual_name, rule, walk_functions)

# directories whose functions run (transitively) under a vmap
TRACE_SCOPES = (
    "presto_tpu_torch/ops/",
    "presto_tpu_torch/exec/",
    "presto_tpu_torch/expr/",
    # the lane rules (kernels/lanes.py) are roots, and every kernel
    # entry runs inside the batched pass
    "presto_tpu_torch/kernels/",
    "presto_tpu_torch/parallel/executor.py",
    "presto_tpu_torch/parallel/exchange.py",
)

# torch functions that return metadata, not tensors
_STATIC_TORCH = {
    "dtype", "device", "finfo", "iinfo", "is_tensor", "is_floating_point",
    "is_complex", "is_storage", "promote_types", "result_type",
    "can_cast", "get_default_dtype", "Size", "Generator", "manual_seed",
    "set_num_threads", "get_num_threads", "no_grad", "inference_mode",
    "enable_grad", "set_grad_enabled", "numel",
}
# torch namespaces that do not produce tensors
_HOST_TORCH = ("torch.cuda.", "torch.backends.", "torch.library.",
               "torch.utils.", "torch._C.", "torch.profiler.",
               "torch.distributed.", "torch.func.", "torch.autograd.",
               "torch.multiprocessing.", "torch.testing.")

_VMAP_NAMES = {"torch.func.vmap", "torch.vmap", "functorch.vmap"}

# data-dependent output shapes: raise under vmap
_DYNAMIC_SHAPE = {"torch.nonzero", "torch.masked_select", "torch.unique",
                  "torch.unique_consecutive", "torch.argwhere"}
_DYNAMIC_METHODS = {"nonzero", "masked_select", "unique",
                    "unique_consecutive", "argwhere"}

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)


def _resolve(qname: str | None, aliases: dict[str, str]) -> str | None:
    """Expand the leading component of a dotted name through the
    module's imports: ``F.pad`` -> ``torch.nn.functional.pad``."""
    if qname is None:
        return None
    head, _, rest = qname.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _is_traced_producer(call_qname: str | None) -> bool:
    """Does a call of this resolved name return a tensor?"""
    if call_qname is None or not call_qname.startswith("torch."):
        return False
    if call_qname.startswith(_HOST_TORCH):
        return False
    return call_qname.rsplit(".", 1)[1] not in _STATIC_TORCH


# tensor attributes and methods that return host metadata
_META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
               "is_floating_point", "is_complex", "is_sparse",
               "requires_grad", "names", "itemsize", "nbytes"}
_META_METHODS = {"dim", "numel", "size", "element_size", "nelement",
                 "is_contiguous", "data_ptr", "stride", "storage_offset",
                 "get_device", "is_floating_point", "is_complex", "type",
                 "is_pinned", "item", "tolist"}
_HOST_BUILTINS = {"len", "isinstance", "type", "getattr", "hasattr",
                  "id", "repr", "str", "callable", "issubclass"}


def _is_tensor(node: ast.AST, aliases: dict[str, str],
               env: frozenset | set = frozenset()) -> bool:
    """Does ``node`` evaluate to a tensor? A ``torch.*`` producer call,
    a name of ``env``, or an expression over them; metadata reads
    (``x.dtype``, ``x.ndim``, ``x.shape[0]``, ``x.numel()``), identity
    tests (``x is None``) and host builtins (``len``, ``isinstance``)
    are host values."""
    if isinstance(node, ast.Name):
        return node.id in env
    if isinstance(node, ast.Call):
        fn = node.func
        rq = _resolve(qual_name(fn), aliases)
        if _is_traced_producer(rq):
            return True
        if isinstance(fn, ast.Name) and fn.id in _HOST_BUILTINS:
            return False
        if isinstance(fn, ast.Attribute):
            if fn.attr in _META_METHODS:
                return False
            return _is_tensor(fn.value, aliases, env)
        return False
    if isinstance(node, ast.Attribute):
        if node.attr in _META_ATTRS:
            return False
        return _is_tensor(node.value, aliases, env)
    if isinstance(node, (ast.Subscript, ast.Starred, ast.NamedExpr)):
        return _is_tensor(node.value, aliases, env)
    if isinstance(node, ast.BinOp):
        return (_is_tensor(node.left, aliases, env)
                or _is_tensor(node.right, aliases, env))
    if isinstance(node, ast.UnaryOp):
        return _is_tensor(node.operand, aliases, env)
    if isinstance(node, ast.BoolOp):
        return any(_is_tensor(v, aliases, env) for v in node.values)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
        return any(_is_tensor(v, aliases, env)
                   for v in [node.left] + node.comparators)
    if isinstance(node, ast.IfExp):
        return (_is_tensor(node.body, aliases, env)
                or _is_tensor(node.orelse, aliases, env))
    return False


class _FnUnit:
    def __init__(self, mod: SourceModule, path: tuple[str, ...],
                 node: ast.FunctionDef):
        self.mod = mod
        self.path = path
        self.node = node
        self.name = node.name

    @property
    def key(self) -> tuple:
        return (self.mod.relpath, self.path)

    def own_statements(self) -> Iterator[ast.AST]:
        """Walk the body excluding nested function/class subtrees
        (those are separate units)."""
        stack: list[ast.AST] = list(self.node.body)
        while stack:
            n = stack.pop()
            yield n
            for child in ast.iter_child_nodes(n):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                    stack.append(child)


def _unit_paths(tree: ast.AST) -> Iterator[tuple[tuple, ast.AST]]:
    """walk_functions, with same-named siblings told apart: the second
    ``def _`` of a scope (a lane rule after its ``register_fake``) is
    ``_@<line>``, so every function is its own unit."""
    seen: set[tuple] = set()
    for path, fn in walk_functions(tree):
        if path in seen:
            path = path[:-1] + (f"{path[-1]}@{fn.lineno}",)
        seen.add(path)
        yield path, fn


def _collect_units(mods: list[SourceModule]
                   ) -> dict[tuple, _FnUnit]:
    units: dict[tuple, _FnUnit] = {}
    for mod in mods:
        own = getattr(mod, "_fn_units", None)
        if own is None:
            # cached on the SourceModule: the tracer family and the
            # tracekey rule scope overlapping directories, and the
            # function walk is the expensive half of graph building
            own = mod._fn_units = {
                (mod.relpath, path): _FnUnit(mod, path, fn)
                for path, fn in _unit_paths(mod.tree)}
        units.update(own)
    return units


def _registry_decorators(mod: SourceModule) -> set[str]:
    """Module-local decorator factories that REGISTER the decorated
    function (store it into a dispatch table): their body, or a nested
    deco's body, assigns into a subscript (``TABLE[name] = fn``) or
    appends to a collection. Functions they decorate are invoked
    through the table by batched code, invisibly to the call graph — a
    plain wrapping decorator (timing, caching) does not qualify."""
    out: set[str] = set()
    for node in mod.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Subscript) for t in sub.targets):
                out.add(node.name)
                break
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("append", "add", "setdefault",
                                      "register"):
                out.add(node.name)
                break
    return out


def _class_methods(mods: list[SourceModule]
                   ) -> dict[tuple[str, str], list[tuple]]:
    """(relpath, class name) -> method unit keys, from real ClassDefs."""
    out: dict[tuple[str, str], list[tuple]] = {}

    def visit(mod, node, path):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                methods = [
                    path + (child.name, m.name)
                    for m in child.body
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))]
                out.setdefault((mod.relpath, child.name),
                               []).extend(methods)
                visit(mod, child, path + (child.name,))
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                visit(mod, child, path + (child.name,))
            else:
                visit(mod, child, path)

    for mod in mods:
        visit(mod, mod.tree, ())
    return out


def _positional(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _batched_params(fn: ast.FunctionDef) -> list[str]:
    """The parameters a vmap hands batched tensors (a parameter mapped
    with ``in_dims`` None is a plain tensor, which these rules treat
    alike)."""
    names = _positional(fn)
    if fn.args.vararg is not None:
        names.append(fn.args.vararg.arg)
    return names


def _find_roots(mods: list[SourceModule], units: dict[tuple, _FnUnit],
                alias_cache: dict[str, dict[str, str]]
                ) -> tuple[set[tuple], list[tuple]]:
    """(root unit keys, [(unit, kind, detail, anchor)]) — the second
    list carries what tracer-static-arg checks: ``("in_dims", n)`` for
    a vmap call with a literal ``in_dims`` of n entries, ``("rule",
    op_params)`` for a lane rule of a custom op defined in the module,
    ``("root", None)`` for every root (mutable defaults), ``("params",
    names)`` for the parameters of a root that hold batched tensors."""
    roots: set[tuple] = set()
    statics: list[tuple] = []
    by_name: dict[tuple[str, str], list[_FnUnit]] = {}
    by_node: dict[int, _FnUnit] = {}
    for u in units.values():
        by_name.setdefault((u.mod.relpath, u.name), []).append(u)
        by_node[id(u.node)] = u

    def mark(u: _FnUnit, anchor: ast.AST,
             tensors: list[str] | None = None) -> None:
        if u.key not in roots:
            roots.add(u.key)
            statics.append((u, "root", None, anchor))
        if tensors:
            statics.append((u, "params", tensors, anchor))

    for mod in mods:
        aliases = alias_cache[mod.relpath]
        registry_decos = _registry_decorators(mod)
        # custom ops of this module: decorated function name -> def
        ops: dict[str, ast.FunctionDef] = {}
        for node in mod.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) \
                        else dec
                    if _resolve(qual_name(target),
                                aliases) == "torch.library.custom_op":
                        ops[node.name] = node
        for node in mod.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                u = by_node.get(id(node))
                if u is None:
                    continue
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) \
                        else dec
                    rq = _resolve(qual_name(target), aliases)
                    # registry decorators (@scalar("add")-style): the
                    # decorated function is called through a dispatch
                    # table by batched code, invisibly to the call graph
                    if isinstance(dec, ast.Call) and \
                            isinstance(dec.func, ast.Name) and \
                            dec.func.id in registry_decos and \
                            rq not in ("functools.partial", "partial"):
                        mark(u, dec)
                    if rq in _VMAP_NAMES:
                        mark(u, dec, _batched_params(node))
                    elif isinstance(target, ast.Attribute) and \
                            target.attr == "register_vmap":
                        # (info, in_dims, <the op's arguments>): those
                        # the op types as tensors hold the lanes stacked
                        base = qual_name(target.value)
                        op = ops.get(base)
                        mark(u, dec, None if op is None else [
                            r for r, p in zip(_positional(node)[2:],
                                              op.args.posonlyargs
                                              + op.args.args)
                            if "Tensor" in ast.unparse(
                                p.annotation or ast.Constant(""))])
                        if op is not None:
                            statics.append((u, "rule", _positional(op),
                                            dec))
            elif isinstance(node, ast.Call):
                rq = _resolve(qual_name(node.func), aliases)
                if rq not in _VMAP_NAMES:
                    continue
                fn = node.args[0] if node.args else None
                if not isinstance(fn, ast.Name):
                    continue
                for u in by_name.get((mod.relpath, fn.id), []):
                    mark(u, node, _batched_params(u.node))
                    for kw in node.keywords:
                        if kw.arg == "in_dims" and isinstance(
                                kw.value, (ast.Tuple, ast.List)):
                            statics.append((u, "in_dims",
                                            len(kw.value.elts), node))
    return roots, statics


class CallGraph:
    """The vmap-reachability call graph over one scope set, shared by
    the tracer family and the trace-key provenance rule (tracekey.py):
    parsed function units, import aliases, name-resolution tables, and
    the edge relation. Obtain via :func:`call_graph` (cached per
    project so the families never re-walk the tree)."""

    def __init__(self, mods: list[SourceModule]):
        self.mods = mods
        self.units = _collect_units(mods)
        self.alias_cache = {m.relpath: m.aliases for m in mods}
        self.mod_by_name: dict[str, SourceModule] = {}
        for m in mods:
            self.mod_by_name[m.modname] = m
            if m.modname.endswith(".__init__"):
                # a package's functions are addressed through the
                # package name (`from presto_tpu_torch import kernels
                # as K; K.run(...)`), never through ``.__init__``
                self.mod_by_name[m.modname[:-len(".__init__")]] = m
        self.by_name: dict[tuple[str, str], list[_FnUnit]] = {}
        for u in self.units.values():
            self.by_name.setdefault((u.mod.relpath, u.name),
                                    []).append(u)
        self.classes = _class_methods(mods)

    def named(self, relpath: str, name: str) -> Iterator[_FnUnit]:
        """Units a bare name resolves to in ``relpath``: functions with
        that name, plus every method of a class with that name
        (instantiation makes the whole class live)."""
        yield from self.by_name.get((relpath, name), [])
        for key in self.classes.get((relpath, name), []):
            if (relpath, key) in self.units:
                yield self.units[(relpath, key)]

    def find_roots(self) -> tuple[set[tuple], list[tuple]]:
        return _find_roots(self.mods, self.units, self.alias_cache)

    def resolve_call(self, u: _FnUnit,
                     call: ast.Call) -> Iterator[_FnUnit]:
        """Units one Call node may enter (same resolution the edge
        relation uses; exposed for per-call-site analyses like the
        tracekey argument-taint fixpoint)."""
        aliases = self.alias_cache[u.mod.relpath]
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id == "getattr":
                return
            tq = aliases.get(fn.id)
            if tq and "." in tq:
                tmod, _, tname = tq.rpartition(".")
                m = self.mod_by_name.get(tmod)
                if m is not None:
                    yield from self.named(m.relpath, tname)
                    return
            yield from self.named(u.mod.relpath, fn.id)
        elif isinstance(fn, ast.Attribute):
            base = _resolve(qual_name(fn.value), aliases)
            m = self.mod_by_name.get(base) if base else None
            if m is not None:
                yield from self.named(m.relpath, fn.attr)
            else:
                yield from self.named(u.mod.relpath, fn.attr)

    def edges(self, u: _FnUnit) -> Iterator[_FnUnit]:
        """Callees of one unit: plain and imported-module calls,
        same-module method calls by name, class instantiation (all
        methods), bare function references (callbacks passed as
        values), and getattr-computed self dispatch (all sibling
        methods)."""
        class_wide = False
        for stmt in u.own_statements():
            if isinstance(stmt, ast.Name) and \
                    isinstance(stmt.ctx, ast.Load):
                # bare reference: a callback handed to other code
                yield from self.by_name.get((u.mod.relpath, stmt.id),
                                            [])
                continue
            if not isinstance(stmt, ast.Call):
                continue
            fn = stmt.func
            if isinstance(fn, ast.Name) and fn.id == "getattr":
                # computed dispatch: getattr(self, ...) marks every
                # sibling method reachable (PlanInterpreter.run)
                if stmt.args and \
                        isinstance(stmt.args[0], ast.Name) and \
                        stmt.args[0].id == "self":
                    class_wide = True
                continue
            yield from self.resolve_call(u, stmt)
        if class_wide and len(u.path) >= 2:
            prefix = u.path[:-1]
            for other in self.units.values():
                if other.mod is u.mod and len(other.path) == \
                        len(u.path) and other.path[:-1] == prefix:
                    yield other

    def reachable(self, roots: set[tuple]) -> set[tuple]:
        """BFS over the call graph from ``roots``."""
        seen = set(roots)
        frontier = [self.units[k] for k in roots if k in self.units]
        while frontier:
            u = frontier.pop()
            for tgt in self.edges(u):
                if tgt.key not in seen:
                    seen.add(tgt.key)
                    frontier.append(tgt)
        return seen


def call_graph(project: Project,
               scopes: tuple[str, ...]) -> CallGraph:
    """The CallGraph for ``scopes``, cached on the project instance
    (like locks.class_analyses: the data dies with the run instead of
    pinning the parsed package in a module global)."""
    cache = getattr(project, "_callgraph_cache", None)
    if cache is None:
        cache = project._callgraph_cache = {}
    graph = cache.get(scopes)
    if graph is None:
        graph = cache[scopes] = CallGraph(project.in_scope(scopes))
    return graph


def _tensor_names(u: _FnUnit, aliases: dict[str, str],
                  seed: set[str] | None = None) -> set[str]:
    """Local names of ``u`` assigned (directly, by tuple unpacking or
    as a loop variable) from an expression holding a tensor value,
    closed within the unit."""
    env: set[str] = set(seed or ())

    def flood(t: ast.AST) -> bool:
        if isinstance(t, (ast.Tuple, ast.List)):
            return any([flood(e) for e in t.elts])
        if isinstance(t, ast.Starred):
            return flood(t.value)
        if isinstance(t, ast.Name) and t.id not in env:
            env.add(t.id)
            return True
        return False

    stmts = [s for s in u.own_statements()
             if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                               ast.NamedExpr, ast.For))]
    changed = True
    while changed:
        changed = False
        for s in stmts:
            if isinstance(s, ast.For):
                value, targets = s.iter, [s.target]
            elif isinstance(s, ast.Assign):
                value, targets = s.value, s.targets
            else:
                value, targets = s.value, [s.target]
            if value is None or not _is_tensor(value, aliases, env):
                continue
            for t in targets:
                changed |= flood(t)
    return env


def _is_bool_mask(node: ast.AST, aliases: dict[str, str],
                  env: set[str]) -> bool:
    """An index expression that is a boolean mask over a tensor: a
    comparison, or ``~``/``&``/``|`` over comparisons, with a tensor
    value in it."""
    if isinstance(node, ast.Compare):
        return _is_tensor(node, aliases, env)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_bool_mask(node.operand, aliases, env)
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.BitAnd, ast.BitOr)):
        return (_is_bool_mask(node.left, aliases, env)
                or _is_bool_mask(node.right, aliases, env))
    return False


def _check_unit(u: _FnUnit, findings: list[Finding],
                aliases: dict[str, str],
                seed: set[str] | None = None) -> None:
    def f(node: ast.AST, rule_name: str, msg: str) -> None:
        findings.append(Finding(rule_name, u.mod.relpath, node.lineno,
                                node.col_offset, msg))

    env = _tensor_names(u, aliases, seed)

    def traced(node: ast.AST) -> bool:
        return _is_tensor(node, aliases, env)

    where = f"in vmap-reachable `{'.'.join(u.path)}`"
    for node in u.own_statements():
        if isinstance(node, ast.Call):
            rq = _resolve(qual_name(node.func), aliases)
            if rq in ("bool", "int", "float", "complex") and \
                    node.args and traced(node.args[0]):
                f(node, "tracer-concretize",
                  f"{rq}() on a tensor {where} raises on a batched "
                  "tensor (keep it a tensor: torch.where, a mask, or "
                  "hoist the read to the host driver)")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("item", "tolist") and \
                    traced(node.func.value):
                f(node, "tracer-concretize",
                  f".{node.func.attr}() on a tensor {where} raises "
                  "on a batched tensor (and syncs on a plain one)")
            elif rq in _DYNAMIC_SHAPE or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DYNAMIC_METHODS
                    and rq not in _DYNAMIC_SHAPE
                    and not (rq or "").startswith("numpy.")
                    and traced(node.func.value)):
                name = rq if rq in _DYNAMIC_SHAPE else \
                    f".{node.func.attr}()"
                f(node, "tracer-concretize",
                  f"{name} {where} has a data-dependent output shape, "
                  "which raises on a batched tensor (use a mask and "
                  "a static capacity: the compact kernel)")
            elif rq is not None and rq.startswith("numpy.") and \
                    any(traced(a) for a in list(node.args)
                        + [kw.value for kw in node.keywords]):
                f(node, "tracer-numpy",
                  f"{rq.replace('numpy', 'np')}() applied to a tensor "
                  f"{where}: numpy reads the data through __array__, "
                  "which raises on a batched tensor (use the torch "
                  "equivalent)")
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                _is_bool_mask(node.slice, aliases, env):
            f(node, "tracer-concretize",
              f"boolean-mask indexing {where} has a data-dependent "
              "output shape, which raises on a batched tensor (use "
              "torch.where, or the compact kernel at a capacity)")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if traced(node.test):
                kind = {"If": "if", "While": "while",
                        "IfExp": "conditional expression"}[
                    type(node).__name__]
                f(node, "tracer-branch",
                  f"Python `{kind}` on a tensor {where}: it raises on "
                  "a batched tensor (use torch.where, or decide on "
                  "the host before the pass)")
        elif isinstance(node, ast.Assert):
            if traced(node.test):
                f(node, "tracer-branch",
                  f"assert on a tensor {where} raises on a batched "
                  "tensor")
        elif isinstance(node, ast.comprehension):
            for cond in node.ifs:
                if traced(cond):
                    f(cond, "tracer-branch",
                      f"comprehension filter on a tensor {where} "
                      "raises on a batched tensor")


def _defaults(fn: ast.FunctionDef) -> dict[str, ast.AST]:
    args = fn.args
    pos = args.posonlyargs + args.args
    out: dict[str, ast.AST] = dict(zip(
        [a.arg for a in pos[len(pos) - len(args.defaults):]],
        args.defaults))
    out.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                         args.kw_defaults)
                if d is not None})
    return out


def _check_static_args(statics: list[tuple],
                       findings: list[Finding]) -> None:
    for u, kind, detail, anchor in statics:
        fn = u.node
        if kind == "in_dims":
            params = _positional(fn)
            if fn.args.vararg is None and detail != len(params):
                findings.append(Finding(
                    "tracer-static-arg", u.mod.relpath, anchor.lineno,
                    anchor.col_offset,
                    f"in_dims has {detail} entries but `{u.name}` "
                    f"takes {len(params)} positional parameters: the "
                    "vmap raises at call time, on the batched path "
                    "only"))
        elif kind == "rule":
            want = ["info", "in_dims"] + list(detail)
            got = _positional(fn)
            if len(got) != len(want) or got[2:] != want[2:]:
                findings.append(Finding(
                    "tracer-static-arg", u.mod.relpath, fn.lineno,
                    fn.col_offset,
                    f"lane rule `{'.'.join(u.path)}` takes "
                    f"({', '.join(got)}) but its custom op is called "
                    f"as ({', '.join(detail)}): a register_vmap rule "
                    "takes (info, in_dims, <the op's parameters>), and "
                    "a mismatch raises on the batched path only"))
        elif kind == "root":
            for name, d in _defaults(fn).items():
                if isinstance(d, _MUTABLE_LITERALS):
                    findings.append(Finding(
                        "tracer-static-arg", u.mod.relpath, d.lineno,
                        d.col_offset,
                        f"mutable default for parameter '{name}' of "
                        f"vmap root `{u.name}`: one object shared by "
                        "every lane and every batch is an aliasing "
                        "hazard"))


@rule("tracer-concretize")
def tracer_concretize(project: Project) -> list[Finding]:
    return _run_family(project, {"tracer-concretize"})


@rule("tracer-branch")
def tracer_branch(project: Project) -> list[Finding]:
    return _run_family(project, {"tracer-branch"})


@rule("tracer-numpy")
def tracer_numpy(project: Project) -> list[Finding]:
    return _run_family(project, {"tracer-numpy"})


@rule("tracer-static-arg")
def tracer_static_arg(project: Project) -> list[Finding]:
    return _run_family(project, {"tracer-static-arg"})


# [weakref to project, findings]: lets the four tracer rules share one
# reachability analysis within a run_lint call WITHOUT pinning the
# parsed package (full ASTs, tens of MB) after the run finishes
_family_cache: list = []


def _run_family(project: Project, keep: set[str]) -> list[Finding]:
    """All four tracer rules share one reachability analysis; compute
    once per project and filter."""
    import weakref
    if _family_cache and _family_cache[0]() is project:
        cached = _family_cache[1]
    else:
        # one CallGraph per (project, scopes) — module alias tables and
        # function units are cached on the modules themselves, so the
        # tracekey rule riding the same graph machinery pays nothing
        # extra for the shared directories
        graph = call_graph(project, TRACE_SCOPES)
        roots, statics = graph.find_roots()
        reach = graph.reachable(roots)
        cached = []
        seeds: dict[tuple, set[str]] = {}
        for u, kind, detail, _anchor in statics:
            if kind == "params":
                seeds.setdefault(u.key, set()).update(detail)
        for key in sorted(reach):
            u = graph.units.get(key)
            if u is not None:
                _check_unit(u, cached,
                            graph.alias_cache[u.mod.relpath],
                            seeds.get(key))
        _check_static_args(statics, cached)
        _family_cache[:] = [weakref.ref(project), cached]
    return [f for f in cached if f.rule in keep]
