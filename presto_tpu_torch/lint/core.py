"""Analyzer core: source loading, rule registry, suppressions.

The unit of analysis is a :class:`Project` — every ``.py`` file under
the paths given to the CLI, parsed once. Rules are functions from a
Project to findings, registered by name; per-line suppressions
(``# lint: disable=rule-name`` on the offending line) are honored
centrally so every rule gets them for free.

Paths are normalized to package-relative form (``presto_tpu_torch/...``), so
rule scopes (which directories a family applies to) match no matter
where the analyzed tree lives — the test suite exercises rules on
synthetic packages in temp directories this way.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable

PACKAGE = "presto_tpu_torch"

# comment syntax: a '#' then ``lint: disable=rule-a,rule-b``, or the
# bare ``disable`` form covering every rule (phrased here without the
# leading hash so the stale-suppression check does not read THIS
# comment as a suppression)
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable(?:=([A-Za-z0-9_,\- ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # package-relative, e.g. "presto_tpu_torch/exec/executor.py"
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SourceModule:
    """One parsed source file plus its suppression table and the
    shared walk/alias caches every rule reads instead of re-walking
    the tree (one full ``ast.walk`` per rule per module dominated
    lint runtime before these)."""

    def __init__(self, path: Path, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        # line -> set of suppressed rule names, or None meaning all
        self.suppressions: dict[int, set[str] | None] = {}
        self._scan_suppressions(text)
        self._walk_cache: list[ast.AST] | None = None
        self._call_cache: list[ast.Call] | None = None
        self._alias_cache: dict[str, str] | None = None

    @property
    def modname(self) -> str:
        return self.relpath[:-3].replace("/", ".")

    def walk(self) -> list[ast.AST]:
        """Every node of the module tree, walked ONCE and cached for
        the project's lifetime — rules iterate this flat list instead
        of paying their own ``ast.walk`` pass."""
        if self._walk_cache is None:
            self._walk_cache = list(ast.walk(self.tree))
        return self._walk_cache

    def calls(self) -> list[ast.Call]:
        """Just the Call nodes of the shared walk — most per-call
        rules (timeouts, spans, metric names, spawn sites) scan only
        these, a ~10x smaller list than the full walk."""
        if self._call_cache is None:
            self._call_cache = [n for n in self.walk()
                                if isinstance(n, ast.Call)]
        return self._call_cache

    @property
    def aliases(self) -> dict[str, str]:
        """Cached :func:`import_aliases` for this module (computed
        off the shared walk, not a private re-walk)."""
        if self._alias_cache is None:
            self._alias_cache = import_aliases(self.tree,
                                               nodes=self.walk())
        return self._alias_cache

    def _scan_suppressions(self, text: str) -> None:
        # tokenize (not line regex) so a lint-disable marker inside a
        # string literal is not treated as a suppression
        import io
        if "lint:" not in text:  # tokenizing every file is ~1/3 of
            return                # total runtime; most have nothing
        try:
            tokens = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                names = m.group(1)
                if names is None:
                    self.suppressions[tok.start[0]] = None
                else:
                    cur = self.suppressions.setdefault(tok.start[0],
                                                       set())
                    if cur is not None:
                        cur.update(n.strip() for n in names.split(",")
                                   if n.strip())
        except tokenize.TokenError:
            pass

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line, ...)
        if rules is ...:
            return False
        return rules is None or rule in rules


def _relpath(path: Path) -> str:
    """Path from the last ``presto_tpu_torch`` component down (how rule
    scopes are expressed); falls back to the bare filename."""
    parts = path.parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i:])
    return path.name


class Project:
    """Parsed modules for one lint run."""

    def __init__(self, modules: list[SourceModule]):
        self.modules = modules
        self.by_relpath = {m.relpath: m for m in modules}

    @classmethod
    def load(cls, paths: Iterable[str | Path]) -> "Project":
        files: list[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        modules = []
        seen = set()
        for f in files:
            key = f.resolve()
            if key in seen:
                continue
            seen.add(key)
            try:
                text = f.read_text(encoding="utf-8")
                modules.append(SourceModule(f, _relpath(f), text))
            except (SyntaxError, UnicodeDecodeError) as e:
                # surface as a usage error (CLI exit 2), not a
                # traceback a CI gate would misread as findings
                raise ValueError(f"cannot parse {f}: {e}") from e
        return cls(modules)

    def in_scope(self, scopes: tuple[str, ...]) -> list[SourceModule]:
        """Modules whose relpath starts with any of ``scopes`` (a
        trailing '/' scopes a directory, otherwise an exact file)."""
        out = []
        for m in self.modules:
            for s in scopes:
                if (m.relpath.startswith(s) if s.endswith("/")
                        else m.relpath == s):
                    out.append(m)
                    break
        return out


RuleFn = Callable[[Project], list[Finding]]
_RULES: dict[str, RuleFn] = {}


def rule(name: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        _RULES[name] = fn
        return fn
    return deco


def available_rules() -> list[str]:
    return sorted(_RULES)


# pseudo-rule emitted by run_lint itself for suppression comments that
# no longer suppress anything (it needs every real rule's output, so
# it cannot live in the registry)
STALE_RULE = "stale-suppression"


def _stale_suppressions(project: Project, selected: list[str],
                        used: dict[tuple[str, int], set[str]],
                        blanket_used: set[tuple[str, int]]
                        ) -> list[Finding]:
    """Suppression comments that excused nothing this run — the code
    they covered was fixed or deleted, and a stale disable would
    silently swallow the NEXT real finding on that line. Only rules
    that actually ran are judged (a ``--rules`` subset run cannot
    call another rule's suppression stale); blanket ``disable``
    comments are judged only on full runs for the same reason.
    Unknown rule names are always stale — a typo'd suppression
    suppresses nothing while looking like it does."""
    known = set(available_rules()) | {STALE_RULE}
    ran = set(selected)
    full_run = ran == set(available_rules())
    out: list[Finding] = []
    for mod in project.modules:
        for line, names in sorted(mod.suppressions.items()):
            key = (mod.relpath, line)
            stale: list[str] = []
            if names is None:
                if full_run and key not in blanket_used:
                    out.append(Finding(
                        STALE_RULE, mod.relpath, line, 0,
                        "blanket '# lint: disable' suppresses no "
                        "finding on this line; delete it (a stale "
                        "disable hides the next real finding here)"))
                continue
            for name in sorted(names):
                if name == STALE_RULE:
                    continue  # judged by its own mechanism below
                if name not in known:
                    out.append(Finding(
                        STALE_RULE, mod.relpath, line, 0,
                        f"suppression names unknown rule {name!r} "
                        f"(available: {', '.join(available_rules())})"
                        " — it suppresses nothing"))
                elif name in ran and name not in used.get(key, ()):
                    stale.append(name)
            if stale:
                out.append(Finding(
                    STALE_RULE, mod.relpath, line, 0,
                    f"'# lint: disable={','.join(stale)}' no longer "
                    "suppresses any finding; the code it excused was "
                    "fixed or moved — delete the stale suppression"))
    return out


def run_lint(paths: Iterable[str | Path],
             rules: Iterable[str] | None = None,
             only_files: set[Path] | None = None,
             collect_suppressed: list[Finding] | None = None
             ) -> list[Finding]:
    """Run the selected rules (default: all) over ``paths``; returns
    unsuppressed findings — plus ``stale-suppression`` findings for
    disable comments that excused nothing — sorted by location.
    ``only_files`` (resolved paths) restricts REPORTING to those
    files while the analysis still sees the whole tree (the CLI's
    ``--changed`` mode: cross-file rules stay sound).
    ``collect_suppressed`` (a list, appended in place) receives the
    findings an in-source ``# lint: disable`` excused — the SARIF
    export reports them as suppressed results instead of dropping
    them, so CI dashboards can audit the waivers."""
    import presto_tpu_torch.lint  # noqa: F401 - ensure rules registered
    paths = list(paths)
    missing = [str(p) for p in paths if not Path(p).exists()]
    if missing:
        raise ValueError(f"paths do not exist: {missing}")
    project = Project.load(paths)
    if not project.modules:
        # a typo'd path must not read as "lint clean"
        raise ValueError(
            f"no Python files found under {[str(p) for p in paths]}")
    selected = list(rules) if rules is not None else available_rules()
    unknown = [r for r in selected if r not in _RULES]
    if unknown:
        raise ValueError(f"unknown lint rules: {unknown} "
                         f"(available: {available_rules()})")
    findings: list[Finding] = []
    used: dict[tuple[str, int], set[str]] = {}
    blanket_used: set[tuple[str, int]] = set()
    for name in selected:
        for f in _RULES[name](project):
            mod = project.by_relpath.get(f.path)
            if mod is not None and mod.suppressed(f.line, f.rule):
                names = mod.suppressions.get(f.line, set())
                if names is None:
                    blanket_used.add((f.path, f.line))
                else:
                    used.setdefault((f.path, f.line),
                                    set()).add(f.rule)
                if collect_suppressed is not None:
                    collect_suppressed.append(f)
                continue
            findings.append(f)
    for f in _stale_suppressions(project, selected, used,
                                 blanket_used):
        mod = project.by_relpath.get(f.path)
        if mod is not None:
            names = mod.suppressions.get(f.line)
            # only an EXPLICIT disable=stale-suppression silences a
            # staleness report — the blanket being reported as stale
            # must not vouch for itself
            if names is not None and STALE_RULE in names:
                if collect_suppressed is not None:
                    collect_suppressed.append(f)
                continue
        findings.append(f)
    if only_files is not None:
        findings = [f for f in findings
                    if (m := project.by_relpath.get(f.path)) is not None
                    and m.path.resolve() in only_files]
        if collect_suppressed is not None:
            collect_suppressed[:] = [
                f for f in collect_suppressed
                if (m := project.by_relpath.get(f.path)) is not None
                and m.path.resolve() in only_files]
    if collect_suppressed is not None:
        collect_suppressed.sort(key=lambda f: (f.path, f.line, f.col,
                                               f.rule))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col,
                                           f.rule))


# -- shared AST helpers used by the rule modules ---------------------------

def qual_name(node: ast.AST) -> str | None:
    """Dotted name of a Name/Attribute chain ('torch.func.vmap'), else
    None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_functions(tree: ast.AST):
    """Yield (qualpath, FunctionDef) for every function in a module,
    including methods and nested functions. ``qualpath`` is a tuple of
    enclosing class/function names."""
    def visit(node, path):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                yield path + (child.name,), child
                yield from visit(child, path + (child.name,))
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, path + (child.name,))
            else:
                yield from visit(child, path)
    yield from visit(tree, ())


def literal_str_dict(mod: SourceModule, name: str
                     ) -> dict[str, tuple[str, int]]:
    """Module-level ``name = {"key": "reason", ...}`` assignments
    (plain or annotated) -> {key: (reason, line)}. The shared parser
    behind the exemption registries (KERNEL_DISPATCH_EXEMPT,
    TRACE_KEY_EXEMPT): non-string reasons parse as "" so the owning
    rule can demand a justification."""
    out: dict[str, tuple[str, int]] = {}
    for node in mod.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in targets):
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                reason = (v.value if isinstance(v, ast.Constant)
                          and isinstance(v.value, str) else "")
                out[k.value] = (reason, k.lineno)
    return out


def import_aliases(tree: ast.AST,
                   nodes: Iterable[ast.AST] | None = None
                   ) -> dict[str, str]:
    """Local name -> imported dotted module/object path. Pass a
    pre-walked node list via ``nodes`` to skip the tree walk."""
    out: dict[str, str] = {}
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out
