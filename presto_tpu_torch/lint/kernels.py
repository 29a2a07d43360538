"""Kernel-parity rule: every CUDA kernel has a reachable plain version.

The kernel subsystem's contract (presto_tpu_torch/kernels/__init__.py)
is that the ``kernel_backend`` session property can always force
``torch`` and get the same rows — which only holds if EVERY CUDA
kernel is registered in the :data:`KERNELS` dispatch table beside its
plain PyTorch version, and both names resolve to real functions. A
CUDA kernel wired directly into an operator (bypassing the table)
would be unreachable from the session property, untested by the
parity tests, uncounted by the device observatory (``COSTS``, read by
``run`` under a cost harvest) and unbatchable (a cross-query batch
reaches a kernel only through its lane rule, kernels/lanes.OPS).

Checked statically, in the spirit of lint/dispatch.py's plan-node
exhaustiveness sites:

- ``KERNELS`` is a literal dict of ``name -> {"cuda": ref,
  "torch": ref}`` with BOTH backend keys per row;
- every referenced function exists in the kernels module it names;
- every module-level ``*_cuda`` function in
  ``presto_tpu_torch/kernels/`` appears in some row's ``cuda`` slot
  (reachability from the dispatch table);
- ``COSTS`` is a literal dict with an entry for every row, each naming
  a function of ``kernels/__init__.py``;
- ``kernels/lanes.py``'s ``OPS`` (a literal dict) has a lane rule for
  every row;
- ``run`` exists and reads ``KERNELS`` (the call), and ``resolve``
  exists and reads the ``kernel_backend`` property (the selection).

Functions exempt from registration (shared bodies, guards) use a
module-level ``KERNEL_DISPATCH_EXEMPT = {"fn_name": "reason"}`` in
their defining module — same hygiene as DISPATCH_EXEMPT, including
staleness detection.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import (Finding, Project, SourceModule,
                                        literal_str_dict, qual_name, rule)

REGISTRY_PATH = "presto_tpu_torch/kernels/__init__.py"
LANES_PATH = "presto_tpu_torch/kernels/lanes.py"
PACKAGE_PREFIX = "presto_tpu_torch/kernels/"
BACKENDS = ("cuda", "torch")
RULE = "kernel-parity"


def _literal_dict(mod: SourceModule, name: str) -> ast.Dict | None | bool:
    """The module-level ``name = {...}`` dict node; False when the
    assignment is missing, None when its value is not a literal dict."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if any(isinstance(t, ast.Name) and t.id == name
               for t in targets):
            return node.value if isinstance(node.value, ast.Dict) \
                else None
    return False


def _str_keys(d: ast.Dict) -> dict[str, int] | None:
    out: dict[str, int] = {}
    for k in d.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        out[k.value] = k.lineno
    return out


def _registry_rows(mod: SourceModule):
    """Parse ``KERNELS = {...}``: name -> {backend: (module_alias,
    fn_name, line)}; None when the assignment is missing/not literal."""
    d = _literal_dict(mod, "KERNELS")
    if not isinstance(d, ast.Dict):
        return None
    rows: dict[str, dict[str, tuple]] = {}
    for k, v in zip(d.keys, d.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Dict)):
            return None
        entry: dict[str, tuple] = {}
        for bk, bv in zip(v.keys, v.values):
            if not (isinstance(bk, ast.Constant)
                    and isinstance(bk.value, str)):
                return None
            q = qual_name(bv)
            if q is None or "." not in q:
                return None
            alias, fn = q.rsplit(".", 1)
            entry[bk.value] = (alias, fn, bv.lineno)
        rows[k.value] = entry
    return rows


def _module_functions(mod: SourceModule) -> set[str]:
    return {n.name for n in mod.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _function(mod: SourceModule, name: str) -> ast.FunctionDef | None:
    for n in mod.tree.body:
        if isinstance(n, ast.FunctionDef) and n.name == name:
            return n
    return None


def _reads(fn: ast.FunctionDef | None, name: str) -> bool:
    return fn is not None and any(
        isinstance(sub, ast.Name) and sub.id == name
        for sub in ast.walk(fn))


def _exempt(mod: SourceModule) -> dict[str, tuple[str, int]]:
    return literal_str_dict(mod, "KERNEL_DISPATCH_EXEMPT")


@rule(RULE)
def kernel_parity(project: Project) -> list[Finding]:
    reg_mod = project.by_relpath.get(REGISTRY_PATH)
    if reg_mod is None:
        return []  # subtree run without the kernels package
    findings: list[Finding] = []

    def f(path: str, line: int, msg: str) -> None:
        findings.append(Finding(RULE, path, line, 0, msg))

    rows = _registry_rows(reg_mod)
    if rows is None:
        return [Finding(
            RULE, REGISTRY_PATH, 1, 0,
            "KERNELS must be a literal dict of "
            "name -> {'cuda': fn, 'torch': fn} (the parity contract "
            "is checked statically against it)")]

    # module alias -> kernels submodule relpath (from the imports)
    submods = {m.relpath.rsplit("/", 1)[-1][:-3]: m
               for m in project.modules
               if m.relpath.startswith(PACKAGE_PREFIX)
               and m.relpath != REGISTRY_PATH}
    alias_to_mod: dict[str, SourceModule] = {}
    for alias, target in reg_mod.aliases.items():
        leaf = target.rsplit(".", 1)[-1]
        if leaf in submods:
            alias_to_mod[alias] = submods[leaf]

    registered_cuda: set[tuple[str, str]] = set()  # (module, fn)
    for name, entry in sorted(rows.items()):
        for backend in BACKENDS:
            if backend not in entry:
                f(REGISTRY_PATH, 1,
                  f"kernel {name!r} has no {backend!r} entry — every "
                  "CUDA kernel needs a registered plain PyTorch "
                  "version (and vice versa) so kernel_backend can "
                  "always force either")
                continue
            alias, fn, line = entry[backend]
            mod = alias_to_mod.get(alias)
            if mod is None:
                f(REGISTRY_PATH, line,
                  f"kernel {name!r} {backend} entry references "
                  f"unknown module alias {alias!r}")
                continue
            if fn not in _module_functions(mod):
                f(REGISTRY_PATH, line,
                  f"kernel {name!r} {backend} entry references "
                  f"{mod.relpath}:{fn} which does not exist")
            elif backend == "cuda":
                registered_cuda.add((mod.relpath, fn))

    # the cost formulas obs/devprof counts a kernel call by
    costs = _literal_dict(reg_mod, "COSTS")
    if not isinstance(costs, ast.Dict) or _str_keys(costs) is None:
        f(REGISTRY_PATH, 1,
          "COSTS must be a literal dict of kernel name -> cost "
          "function (what obs/devprof counts for one call)")
    else:
        own = _module_functions(reg_mod)
        for k, v in zip(costs.keys, costs.values):
            if k.value not in rows:
                f(REGISTRY_PATH, k.lineno,
                  f"COSTS entry {k.value!r} names no KERNELS row "
                  "(stale entry?)")
            elif not (isinstance(v, ast.Name) and v.id in own):
                f(REGISTRY_PATH, k.lineno,
                  f"COSTS entry {k.value!r} must name a function of "
                  "kernels/__init__.py")
        for name in sorted(set(rows) - set(_str_keys(costs))):
            f(REGISTRY_PATH, 1,
              f"kernel {name!r} has no COSTS entry — under a cost "
              "harvest its calls would count nothing, and the device "
              "observatory would under-report every program using it")

    # the lane rules a cross-query batch reaches a kernel through
    lanes_mod = project.by_relpath.get(LANES_PATH)
    if lanes_mod is not None:
        ops = _literal_dict(lanes_mod, "OPS")
        keys = _str_keys(ops) if isinstance(ops, ast.Dict) else None
        if keys is None:
            f(LANES_PATH, 1,
              "OPS must be a literal dict of kernel name -> lane rule "
              "entry (checked statically against KERNELS)")
        else:
            for name in sorted(set(rows) - set(keys)):
                f(LANES_PATH, 1,
                  f"kernel {name!r} has no lane rule in OPS — a "
                  "cross-query batch reaching it under torch.func.vmap "
                  "would run it once per lane or fail")
            for name, line in sorted(keys.items()):
                if name not in rows:
                    f(LANES_PATH, line,
                      f"OPS entry {name!r} names no KERNELS row "
                      "(stale entry?)")

    # run() and resolve() are the selection point: a run() that
    # ignores the table would make the rows above decorative
    if not _reads(_function(reg_mod, "run"), "KERNELS"):
        f(REGISTRY_PATH, 1,
          "kernels/__init__.py must define run() reading the KERNELS "
          "table (where a kernel call is made)")
    resolve_fn = _function(reg_mod, "resolve")
    if resolve_fn is None or not any(
            isinstance(sub, ast.Constant) and sub.value == "kernel_backend"
            for sub in ast.walk(resolve_fn)):
        f(REGISTRY_PATH, 1,
          "kernels/__init__.py must define resolve() reading the "
          "kernel_backend session property (the backend selection "
          "point)")

    # reachability: every *_cuda kernel function is registered
    for mod in project.modules:
        if not mod.relpath.startswith(PACKAGE_PREFIX) \
                or mod.relpath == REGISTRY_PATH:
            continue
        exempt = _exempt(mod)
        fns = _module_functions(mod)
        for node in mod.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if not node.name.endswith("_cuda"):
                continue
            if (mod.relpath, node.name) in registered_cuda:
                continue
            if node.name in exempt:
                continue
            f(mod.relpath, node.lineno,
              f"CUDA kernel {node.name} is not registered in the "
              "kernel_backend dispatch table (kernels/__init__.KERNELS) "
              "— unreachable from the session property and invisible "
              "to parity testing; register it or list it in "
              "KERNEL_DISPATCH_EXEMPT with a reason")
        for name, (reason, line) in sorted(exempt.items()):
            if name not in fns:
                f(mod.relpath, line,
                  f"KERNEL_DISPATCH_EXEMPT lists unknown function "
                  f"{name!r} (stale entry?)")
            elif (mod.relpath, name) in registered_cuda:
                f(mod.relpath, line,
                  f"KERNEL_DISPATCH_EXEMPT lists {name} but it IS "
                  "registered; drop the stale exemption")
            elif not reason:
                f(mod.relpath, line,
                  f"KERNEL_DISPATCH_EXEMPT entry for {name} needs "
                  "a non-empty reason string")
    return findings
