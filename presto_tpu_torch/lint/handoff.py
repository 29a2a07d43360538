"""Ambient-context handoff rule: thread spawns must carry context over.

Four kinds of ambient state ride the spawning thread in this engine
and do NOT follow work onto a new thread (``ThreadPoolExecutor`` and
``threading.Thread`` copy neither contextvars nor ``threading.local``):

- the trace context (``obs/trace.py`` TRACER contextvar) — dropped, a
  worker thread's spans orphan into phantom root traces;
- the cancel token (``exec/cancel.py`` thread-local) — dropped, pool
  threads become unkillable by the reaper/low-memory killer;
- the stats recorder (``obs/qstats.py`` TaskRecorder contextvar) —
  dropped, the thread's operator stats vanish from the query tree;
- the per-query session override (``session.py`` thread-local) —
  dropped, HTTP queries compile under the wrong session properties.

Each of PRs 2, 4, 6 and 8 hand-fixed one instance of this bug class.
This rule makes the handoff a checked contract: every thread-spawn
site (``threading.Thread(target=...)``, ``threading.Timer``,
``<ThreadPoolExecutor>.submit/map``) in a module that USES ambient
context must show explicit handoff or establishment evidence in the
spawning function — a capture (``current_context()``,
``CANCEL.current()``, ``current_override()``, ``current_task()``/
``current_query()``, ``trace_headers()``), an install
(``TRACER.attach``, ``cancel.install``, ``install_override``,
``install_task``), or the thread opening its own fresh scope
(``TRACER.trace``/``root_or_span``, ``QS.task``/``QS.query``,
``CancelToken()``). The evidence scope is the innermost enclosing
function INCLUDING its nested defs, so the usual shape — capture
before the spawn, install inside the local target function — passes
as written.

A thread that is genuinely context-free (a daemon health sweeper, a
best-effort cleanup fan-out, a metrics scraper) carries
``# lint: disable=handoff`` on the spawn line plus a comment naming
why no ambient state applies. Modules that never touch ambient
context are out of scope — their threads cannot drop what the module
does not use.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                  qual_name, rule)

# ambient-state source modules: referencing anything under these marks
# the module as ambient-using (kind name -> module path prefix)
_AMBIENT_MODULES = {
    "trace context": "presto_tpu_torch.obs.trace",
    "stats recorder": "presto_tpu_torch.obs.qstats",
    "cancel token": "presto_tpu_torch.exec.cancel",
}
# session.py is imported nearly everywhere for plain properties; only
# the per-thread override APIs are ambient state
_AMBIENT_NAMES = {
    "current_override": "session override",
    "install_override": "session override",
    "current_context": "trace context",
    "trace_headers": "trace context",
    "current_task": "stats recorder",
    "current_query": "stats recorder",
    "install_task": "stats recorder",
    "TRACER": "trace context",
}

# call-name suffixes that count as handoff/establishment evidence
_EVIDENCE_CALLS = {
    # captures (snapshot on the spawning thread, installed on the new)
    "current_context", "trace_headers", "current_override",
    "current_task", "current_query",
    # installs on the receiving thread
    "attach", "install", "install_override", "install_task",
    # the thread establishing its OWN fresh context is equally sound
    "trace", "root_or_span", "task", "query", "CancelToken",
}
# "current" alone is too generic; require a cancel-ish receiver
_CANCEL_RECEIVER = ("cancel", "CANCEL")

_EXECUTOR_NAMES = ("ThreadPoolExecutor",
                   "concurrent.futures.ThreadPoolExecutor")


def _resolve(qname: str | None, aliases: dict[str, str]) -> str | None:
    if qname is None:
        return None
    head, _, rest = qname.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _ambient_kinds(mod: SourceModule,
                   aliases: dict[str, str]) -> set[str]:
    """Which kinds of ambient state this module touches at all."""
    kinds: set[str] = set()
    for node in mod.walk():
        q = None
        if isinstance(node, (ast.Name, ast.Attribute)):
            q = _resolve(qual_name(node), aliases)
        if q is None:
            continue
        for kind_name, prefix in _AMBIENT_MODULES.items():
            if q == prefix or q.startswith(prefix + "."):
                kinds.add(kind_name)
        tail = q.rsplit(".", 1)[-1]
        if tail in _AMBIENT_NAMES:
            kinds.add(_AMBIENT_NAMES[tail])
    return kinds


def _is_executor_ctor(call: ast.Call, aliases: dict[str, str]) -> bool:
    return _resolve(qual_name(call.func), aliases) in _EXECUTOR_NAMES


def _executor_names(fn: ast.AST,
                    aliases: dict[str, str]) -> set[str]:
    """Local names bound to a ThreadPoolExecutor inside ``fn`` (via
    assignment or ``with ... as name``)."""
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _is_executor_ctor(node.value, aliases):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call) and \
                        _is_executor_ctor(item.context_expr, aliases) \
                        and isinstance(item.optional_vars, ast.Name):
                    names.add(item.optional_vars.id)
    return names


def _module_executor_attrs(mod: SourceModule,
                           aliases: dict[str, str]) -> set[str]:
    """Attribute names assigned a ThreadPoolExecutor anywhere in the
    module (``self.pool = ThreadPoolExecutor(...)`` — submit sites may
    be in another method)."""
    attrs: set[str] = set()
    for node in mod.walk():
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                _is_executor_ctor(node.value, aliases):
            for t in node.targets:
                if isinstance(t, ast.Attribute):
                    attrs.add(t.attr)
    return attrs


def _has_evidence(scope: ast.AST, aliases: dict[str, str]) -> bool:
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        q = qual_name(node.func)
        if q is None:
            continue
        tail = q.rsplit(".", 1)[-1]
        if tail == "current":
            recv = q.rsplit(".", 2)[-2] if "." in q else ""
            if any(c in recv for c in _CANCEL_RECEIVER):
                return True
            continue
        if tail not in _EVIDENCE_CALLS:
            continue
        if tail in ("attach", "install", "trace", "root_or_span",
                    "task", "query"):
            # these are methods: require an ambient-ish receiver so
            # re.Match.span()-style lookalikes don't count
            recv = q.rsplit(".", 2)[-2] if "." in q else ""
            rq = _resolve(q, aliases) or q
            if not (recv in ("TRACER", "_TRACER", "tracer", "QS",
                             "qstats", "CANCEL", "cancel", "_cancel")
                    or ".obs.trace." in rq or ".obs.qstats." in rq
                    or ".exec.cancel." in rq):
                continue
        return True
    return False


def _enclosing_function_map(tree: ast.AST) -> dict[int, ast.AST]:
    """id(node) -> innermost enclosing FunctionDef (or the module)."""
    out: dict[int, ast.AST] = {}

    def visit(node: ast.AST, fn: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            out[id(child)] = fn
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                visit(child, child)
            else:
                visit(child, fn)

    visit(tree, tree)
    return out


_SPAWNISH = ("Thread", "Timer", "submit", "map")


def _has_spawn_candidate(mod: SourceModule) -> bool:
    """Cheap pre-filter: any call spelled like a spawn at all? Most
    modules have none, and the full ambient-usage scan is the
    expensive part of this rule."""
    for node in mod.calls():
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None)
        if name in _SPAWNISH:
            return True
    return False


@rule("handoff")
def handoff(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        if not mod.relpath.startswith("presto_tpu_torch/") or \
                mod.relpath.startswith("presto_tpu_torch/lint/"):
            continue
        if not _has_spawn_candidate(mod):
            continue
        aliases = mod.aliases
        kinds = _ambient_kinds(mod, aliases)
        if not kinds:
            continue
        enclosing = _enclosing_function_map(mod.tree)
        module_pool_attrs = _module_executor_attrs(mod, aliases)
        # executor-bound local names per function scope
        exec_names: dict[int, set[str]] = {}

        def spawn_desc(call: ast.Call) -> str | None:
            q = _resolve(qual_name(call.func), aliases)
            if q in ("threading.Thread", "threading.Timer"):
                return q
            fn = call.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in ("submit", "map"):
                recv = fn.value
                scope = enclosing.get(id(call), mod.tree)
                if id(scope) not in exec_names:
                    exec_names[id(scope)] = _executor_names(
                        scope, aliases)
                if isinstance(recv, ast.Name) and \
                        recv.id in exec_names[id(scope)]:
                    return f"{recv.id}.{fn.attr}"
                if isinstance(recv, ast.Attribute) and \
                        recv.attr in module_pool_attrs:
                    return f"{recv.attr}.{fn.attr}"
            return None

        for node in mod.calls():
            desc = spawn_desc(node)
            if desc is None:
                continue
            scope = enclosing.get(id(node), mod.tree)
            if _has_evidence(scope, aliases):
                continue
            findings.append(Finding(
                "handoff", mod.relpath, node.lineno, node.col_offset,
                f"{desc}(...) spawns a thread in a module using "
                f"ambient {', '.join(sorted(kinds))}, but the "
                "spawning function neither hands any of it over "
                "(current_context/CANCEL.current/current_override/"
                "current_task capture + attach/install on the "
                "thread) nor opens a fresh scope there — the new "
                "thread silently drops that state; hand it over, or "
                "suppress with a comment naming why this thread is "
                "context-free"))
    return findings
