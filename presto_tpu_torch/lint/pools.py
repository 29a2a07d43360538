"""Pool-discipline rule: every MemoryPool.reserve has a matching free.

A reservation leaked on an exception path permanently shrinks the
shared pool: under concurrent serving the coordinator/worker pools are
the cluster's memory governance, and a leak starves every later query
(the failure is invisible until admission starts blocking). The
contract: a function that calls ``<pool>.reserve(...)`` must also call
``<pool>.free(...)`` lexically inside a ``finally`` block of the SAME
function — the only construct that covers all exit paths, raising
included. A straight-line ``free()`` after the work is exactly the bug
this rule exists for (skipped when the work raises).

Receiver matching is by name: any receiver whose final segment contains
"pool" (``pool``, ``self.query_pool``, ``engine.memory_pool``) is
treated as a memory pool; reserve and free must agree on that segment.

Approximation: ownership transfers (a reserve whose release lives in
the CALLER's finally — the segment-carrier pipeline pattern) carry an
explicit per-line ``# lint: disable=pool-discipline`` naming the owner
in a comment. ``MemoryPool`` itself (the implementation in memory.py)
is exempt.
"""

from __future__ import annotations

import ast
import re

from presto_tpu_torch.lint.core import Finding, Project, rule

_POOL_RE = re.compile(r"pool", re.IGNORECASE)


def _receiver(call: ast.Call) -> str | None:
    """The receiver's final name segment of an attribute call
    (``engine.memory_pool.reserve`` -> ``memory_pool``), or None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    recv = fn.value
    if isinstance(recv, ast.Attribute):
        return recv.attr
    if isinstance(recv, ast.Name):
        return recv.id
    return None


def _scan_function(fn: ast.AST, reserves: list, frees: set) -> list:
    """Collect this function's pool reserve calls and finally-covered
    pool free receivers, recursing into nested functions as their OWN
    scopes (a nested def runs later — its finally does not cover the
    enclosing function's reserve)."""
    nested: list = []

    def walk(node: ast.AST, in_finally: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                nested.append(child)
                continue
            if isinstance(child, ast.Try):
                for part in child.body + child.orelse:
                    walk(part, in_finally)
                for handler in child.handlers:
                    walk(handler, in_finally)
                for part in child.finalbody:
                    walk(part, True)
                continue
            if isinstance(child, ast.Call):
                recv = _receiver(child)
                if recv is not None and _POOL_RE.search(recv):
                    attr = child.func.attr  # type: ignore[union-attr]
                    if attr == "reserve":
                        reserves.append((recv, child))
                    elif attr == "free" and in_finally:
                        frees.add(recv)
            walk(child, in_finally)

    walk(fn, False)
    return nested


@rule("pool-discipline")
def pool_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        if mod.relpath.endswith("presto_tpu_torch/memory.py"):
            continue  # the MemoryPool implementation itself
        # cheap pre-filter: no .reserve() call anywhere -> nothing to
        # pair, skip the per-function scope scan entirely
        if not any(isinstance(c.func, ast.Attribute)
                   and c.func.attr == "reserve"
                   for c in mod.calls()):
            continue
        # the shared walk yields every function (nested included)
        # exactly once; _scan_function skips nested bodies, so each
        # function is analyzed as its own innermost scope
        for fn in mod.walk():
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            reserves: list = []
            frees: set = set()
            _scan_function(fn, reserves, frees)
            for recv, call in reserves:
                if recv in frees:
                    continue
                findings.append(Finding(
                    "pool-discipline", mod.relpath, call.lineno,
                    call.col_offset,
                    f"{recv}.reserve(...) in {fn.name} has no "
                    f"matching {recv}.free(...) inside a finally "
                    f"block of the same function: a raise on any "
                    f"path leaks the reservation and permanently "
                    f"shrinks the shared pool (if a caller owns the "
                    f"release, suppress with a comment naming it)"))
    return findings
