"""Span-discipline rule: tracer spans open only via ``with``.

``Tracer.span``/``trace``/``root_or_span``/``attach`` are
contextmanagers that mutate the ambient contextvar on entry and restore
it on exit. A call site that enters one by hand (``sp =
TRACER.span(...)`` + manual ``__enter__``, or a generator held across
yields) leaks BOTH an unfinished span (``t1`` stays None, the Chrome
export shows a phantom still-running bar) and the restored context on
any exception between enter and close — every span opened afterwards on
that thread parents under the leaked one. The reference's span plumbing
(io.trino.tracing) wraps the same hazard in try-with-resources; this
rule is the static equivalent: every tracer-opening call must be the
context expression of a ``with`` item (or an ``ExitStack.enter_context``
argument, which has the same cleanup guarantee).

``Tracer.instant_for`` / ``add_span`` record already-closed intervals
and are exempt by construction (they never touch the ambient context).
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import Finding, Project, qual_name, rule

# contextmanager-returning Tracer entry points
_METHODS = ("span", "trace", "root_or_span", "attach")
# receiver spellings in this codebase: the module-global TRACER, its
# import aliases, and lowercase locals holding a Tracer
_RECEIVERS = ("TRACER", "_TRACER", "tracer", "tr")


@rule("span-discipline")
def span_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        managed: set[int] = set()
        for node in mod.walk():
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    managed.add(id(item.context_expr))
            elif isinstance(node, ast.Call):
                name = qual_name(node.func)
                if name and name.rsplit(".", 1)[-1] \
                        == "enter_context" and node.args:
                    managed.add(id(node.args[0]))
        for node in mod.calls():
            if not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in _METHODS:
                continue
            recv = qual_name(node.func.value)
            if recv is None \
                    or recv.rsplit(".", 1)[-1] not in _RECEIVERS:
                continue
            if id(node) in managed:
                continue
            findings.append(Finding(
                "span-discipline", mod.relpath, node.lineno,
                node.col_offset,
                f"{recv}.{node.func.attr}(...) opened outside a "
                "'with' statement: an exception between enter and "
                "close leaks an open span AND the ambient trace "
                "context for the rest of this thread — open tracer "
                "contextmanagers via 'with' (or "
                "ExitStack.enter_context)"))
    return findings
