"""Dispatch-exhaustiveness rule: every visitor handles every PlanNode.

The PlanNode subclass registry is read from ``plan/nodes.py`` (classes
transitively inheriting ``PlanNode``); each dispatch site is then
checked with a site-appropriate notion of "handles":

- ``isinstance`` sites (plan/sanity.py, plan/printer.py): the node
  class appears in an ``isinstance`` test somewhere in the module.
- ``register`` sites (plan/serde.py): the class is passed to
  ``_register(...)``.
- ``method-prefix`` sites (exec/executor.py): the interpreter class
  defines ``_r_<nodename>`` (matching the ``getattr`` dispatch in
  ``PlanInterpreter.run``).
- ``generic`` sites (plan/fingerprint.py): the module walks
  ``dataclasses.fields`` and declares ``GENERIC_PLAN_DISPATCH = True``
  — total over node types by construction.

A site may deliberately skip node types via a module-level

    DISPATCH_EXEMPT = {"NodeName": "why this site need not handle it"}

The rule also flags *stale* entries: an exemption for a node the site
actually handles, or for a node that no longer exists — so the opt-out
list cannot rot into silence (the same hygiene Trino's
PlanSanityChecker gets from its visitor base classes failing loudly).
"""

from __future__ import annotations

import ast
from pathlib import Path

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                  qual_name, rule)

REGISTRY_PATH = "presto_tpu_torch/plan/nodes.py"
REGISTRY_BASE = "PlanNode"

# relpath -> (kind, detail)
SITES: dict[str, tuple[str, str]] = {
    "presto_tpu_torch/plan/sanity.py": ("isinstance", ""),
    "presto_tpu_torch/plan/printer.py": ("isinstance", ""),
    "presto_tpu_torch/plan/serde.py": ("register", "_register"),
    "presto_tpu_torch/plan/fingerprint.py": ("generic", ""),
    "presto_tpu_torch/exec/executor.py": ("method-prefix", "_r_"),
    # StatsCalculator's per-node estimation rules: a PlanNode without a
    # stats rule would silently fall to the unknown-estimate default
    # and poison join ordering
    "presto_tpu_torch/cost/stats.py": ("method-prefix", "_s_"),
}


def plan_node_registry(tree: ast.AST) -> dict[str, int]:
    """Subclasses of PlanNode (transitive, by name) -> def line."""
    bases_of: dict[str, tuple[list[str], int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            names = []
            for b in node.bases:
                q = qual_name(b)
                if q:
                    names.append(q.rsplit(".", 1)[-1])
            bases_of[node.name] = (names, node.lineno)
    out: dict[str, int] = {}
    changed = True
    while changed:
        changed = False
        for name, (bases, line) in bases_of.items():
            if name == REGISTRY_BASE or name in out:
                continue
            if any(b == REGISTRY_BASE or b in out for b in bases):
                out[name] = line
                changed = True
    return out


def _load_registry(project: Project) -> dict[str, int] | None:
    mod = project.by_relpath.get(REGISTRY_PATH)
    if mod is not None:
        return plan_node_registry(mod.tree)
    # subtree run: locate nodes.py on disk relative to any loaded
    # module of the package
    for m in project.modules:
        if not m.relpath.startswith("presto_tpu_torch/"):
            continue
        depth = m.relpath.count("/")
        root = m.path
        for _ in range(depth):
            root = root.parent
        candidate = Path(root) / "plan" / "nodes.py"
        if candidate.is_file():
            return plan_node_registry(
                ast.parse(candidate.read_text(encoding="utf-8")))
    return None


def _exemptions(mod: SourceModule) -> dict[str, tuple[str, int]]:
    """Parse ``DISPATCH_EXEMPT = {"Name": "reason"}``."""
    out: dict[str, tuple[str, int]] = {}
    for node in mod.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets
                       if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            targets = [node.target]
            value = node.value
        else:
            continue
        if not any(t.id == "DISPATCH_EXEMPT" for t in targets):
            continue
        if isinstance(value, ast.Dict):
            for k, v in zip(value.keys, value.values):
                if isinstance(k, ast.Constant) and \
                        isinstance(k.value, str):
                    reason = (v.value if isinstance(v, ast.Constant)
                              and isinstance(v.value, str) else "")
                    out[k.value] = (reason, k.lineno)
    return out


def _handled_isinstance(mod: SourceModule,
                        registry: dict[str, int]) -> set[str]:
    handled: set[str] = set()
    for node in mod.walk():
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance"
                and len(node.args) == 2):
            continue
        types = node.args[1]
        elts = types.elts if isinstance(types, ast.Tuple) else [types]
        for e in elts:
            q = qual_name(e)
            if q:
                name = q.rsplit(".", 1)[-1]
                if name in registry:
                    handled.add(name)
    return handled


def _handled_register(mod: SourceModule, registry: dict[str, int],
                      fn_name: str) -> set[str]:
    handled: set[str] = set()
    for node in mod.walk():
        if isinstance(node, ast.Call) and \
                qual_name(node.func) is not None and \
                qual_name(node.func).rsplit(".", 1)[-1] == fn_name:
            for a in node.args:
                q = qual_name(a)
                if q:
                    name = q.rsplit(".", 1)[-1]
                    if name in registry:
                        handled.add(name)
    return handled


def _handled_method_prefix(mod: SourceModule,
                           registry: dict[str, int],
                           prefix: str) -> tuple[set[str], int]:
    """(handled names, anchor line of the dispatching class)."""
    by_lower = {name.lower(): name for name in registry}
    best: tuple[set[str], int] = (set(), 1)
    for node in mod.walk():
        if not isinstance(node, ast.ClassDef):
            continue
        handled: set[str] = set()
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) and \
                    stmt.name.startswith(prefix):
                suffix = stmt.name[len(prefix):]
                if suffix in by_lower:
                    handled.add(by_lower[suffix])
        if len(handled) > len(best[0]):
            best = (handled, node.lineno)
    return best


def _check_generic(mod: SourceModule) -> list[str]:
    """Problems with a generic (field-driven) site, as messages."""
    has_marker = False
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and \
                        t.id == "GENERIC_PLAN_DISPATCH" and \
                        isinstance(node.value, ast.Constant) and \
                        node.value.value is True:
                    has_marker = True
    walks_fields = any(
        isinstance(n, ast.Call) and qual_name(n.func) in
        ("dataclasses.fields", "fields")
        for n in mod.walk())
    problems = []
    if not walks_fields:
        problems.append(
            "declared generic over plan nodes but no "
            "dataclasses.fields() traversal found")
    if not has_marker:
        problems.append(
            "generic dispatch site must declare "
            "GENERIC_PLAN_DISPATCH = True to confirm it is total "
            "over node types by construction")
    return problems


@rule("plan-dispatch")
def plan_dispatch(project: Project) -> list[Finding]:
    registry = _load_registry(project)
    findings: list[Finding] = []
    if registry is None:
        return findings  # registry unreachable: nothing checkable
    for relpath, (kind, detail) in SITES.items():
        mod = project.by_relpath.get(relpath)
        if mod is None:
            continue
        exempt = _exemptions(mod)
        anchor = 1
        if kind == "isinstance":
            handled = _handled_isinstance(mod, registry)
        elif kind == "register":
            handled = _handled_register(mod, registry, detail)
        elif kind == "method-prefix":
            handled, anchor = _handled_method_prefix(mod, registry,
                                                     detail)
        elif kind == "generic":
            for msg in _check_generic(mod):
                findings.append(Finding("plan-dispatch", relpath, 1, 0,
                                        msg))
            handled = set(registry)
        else:  # pragma: no cover - config error
            continue
        for name in sorted(set(registry) - handled - set(exempt)):
            findings.append(Finding(
                "plan-dispatch", relpath, anchor, 0,
                f"plan node {name} (plan/nodes.py:{registry[name]}) "
                f"is not handled by this {kind} dispatch site; add a "
                "case or list it in DISPATCH_EXEMPT with a reason"))
        for name, (reason, line) in sorted(exempt.items()):
            if name not in registry:
                findings.append(Finding(
                    "plan-dispatch", relpath, line, 0,
                    f"DISPATCH_EXEMPT lists unknown plan node "
                    f"{name!r} (stale entry?)"))
            elif name in handled:
                findings.append(Finding(
                    "plan-dispatch", relpath, line, 0,
                    f"DISPATCH_EXEMPT lists {name} but this site "
                    "handles it; drop the stale exemption"))
            elif not reason:
                findings.append(Finding(
                    "plan-dispatch", relpath, line, 0,
                    f"DISPATCH_EXEMPT entry for {name} needs a "
                    "non-empty reason string"))
    return findings
