"""Timeout-discipline rule: no internal HTTP call without a deadline.

Every ``urlopen`` / ``_urlopen`` call site in the package must pass an
explicit ``timeout=`` keyword. The distributed control plane long-polls
peers that can die mid-request; a call without a deadline turns one
dead node into a hung coordinator thread that the failure detector
cannot see (the class of bug the hard-coded ``post_task(timeout=300)``
and ``ping(timeout=2)`` literals defended against before ft/retry.py
made the deadlines session-configurable).

The rule is syntactic on purpose: a timeout threaded through a helper
must still be SPELLED at the boundary call (``timeout=timeout``), so
a refactor cannot silently drop the deadline. Positional timeouts are
rejected too — ``urllib.request.urlopen(req, data, 60)`` reads as a
body to most reviewers.
"""

from __future__ import annotations

import ast

from presto_tpu_torch.lint.core import Finding, Project, qual_name, rule

_TARGETS = ("urlopen", "_urlopen")


@rule("timeout-discipline")
def timeout_discipline(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules:
        for node in mod.calls():
            name = qual_name(node.func)
            if name is None:
                continue
            if name.rsplit(".", 1)[-1] not in _TARGETS:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            findings.append(Finding(
                "timeout-discipline", mod.relpath, node.lineno,
                node.col_offset,
                f"{name}(...) without an explicit timeout= keyword: "
                "internal HTTP calls must carry a deadline (a dead "
                "peer otherwise hangs this thread forever)"))
    return findings
