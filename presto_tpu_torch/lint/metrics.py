"""Metric-name rule: the registry's naming contract, checked statically.

``obs/metrics.py`` rejects bad names at registration — but a metric
registered only on a rarely-hit path (a failure counter, a
worker-only gauge) would ship the violation silently until production
hits that path. This rule applies :func:`validate_metric_name` (the
SAME function the runtime registry uses — one source of truth) to
every ``.counter("...")`` / ``.gauge("...")`` / ``.histogram("...")``
call with a literal name, anywhere in the package, and additionally
flags:

- the same metric name registered under two different kinds anywhere
  in the project (the registry raises on whichever loads second —
  which module wins then depends on import order);
- a registration with missing or empty HELP text — ``/metrics`` only
  renders ``# HELP`` when the text is non-empty, and an undocumented
  metric is unusable the moment its author context is gone (Prometheus
  exposition best practice); help passed as a non-literal expression
  is left to the author;
- a negative literal passed to ``.inc(...)`` — counters are monotonic
  by contract; gauges have ``.dec()``.

Dynamic (non-literal) names fall through to the runtime check.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import Finding, Project, rule
from presto_tpu_torch.obs.metrics import validate_metric_name

_REGISTER_METHODS = ("counter", "gauge", "histogram")


def _literal_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@rule("metric-name")
def metric_name(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    # name -> (kind, first registration site) for cross-module
    # duplicate-kind detection
    seen: dict[str, tuple[str, str]] = {}
    for mod in project.modules:
        for node in mod.calls():
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in _REGISTER_METHODS:
                name = _literal_str(node.args[0]) if node.args else None
                if name is None:
                    continue  # dynamic name: runtime registry checks
                err = validate_metric_name(name, attr)
                if err is not None:
                    findings.append(Finding(
                        "metric-name", mod.relpath, node.lineno,
                        node.col_offset, err))
                help_node = node.args[1] if len(node.args) > 1 else None
                for kw in node.keywords:
                    if kw.arg == "help_text":
                        help_node = kw.value
                if help_node is None or (
                        isinstance(help_node, ast.Constant)
                        and isinstance(help_node.value, str)
                        and not help_node.value.strip()):
                    findings.append(Finding(
                        "metric-name", mod.relpath, node.lineno,
                        node.col_offset,
                        f"metric {name!r} registered without HELP "
                        "text; /metrics only renders # HELP when "
                        "non-empty — pass a description"))
                prev = seen.get(name)
                if prev is None:
                    seen[name] = (attr, f"{mod.relpath}:{node.lineno}")
                elif prev[0] != attr:
                    findings.append(Finding(
                        "metric-name", mod.relpath, node.lineno,
                        node.col_offset,
                        f"metric {name!r} registered as {attr} here "
                        f"but as {prev[0]} at {prev[1]}; the registry "
                        "raises on whichever loads second"))
            elif attr == "inc" and node.args:
                a = node.args[0]
                neg = (isinstance(a, ast.UnaryOp)
                       and isinstance(a.op, ast.USub)
                       and isinstance(a.operand, ast.Constant))
                if not neg:
                    v = getattr(a, "value", None) \
                        if isinstance(a, ast.Constant) else None
                    neg = isinstance(v, (int, float)) and v < 0
                if neg:
                    findings.append(Finding(
                        "metric-name", mod.relpath, node.lineno,
                        node.col_offset,
                        "negative literal passed to .inc(): counters "
                        "are monotonic by contract; use Gauge.dec() "
                        "for gauges"))
    return findings
