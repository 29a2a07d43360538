"""SARIF 2.1.0 export: machine-readable CI output for the lint suite.

``python -m presto_tpu_torch.lint --sarif`` emits one SARIF log so findings
annotate diffs in standard tooling (GitHub code scanning, VS Code
SARIF viewers, ``sarif-tools``) without bespoke glue: every result
carries the rule id, artifact URI, line/column region, and message.
In-source ``# lint: disable=rule`` waivers are NOT dropped in this
mode — they export as results with an ``inSource`` suppression (the
justification is the suppression comment itself), so dashboards can
audit what the tree waives, while the process exit code still ignores
them exactly like the text/JSON modes.

The pre-commit/CI recipe combines this with ``--changed``:
``python -m presto_tpu_torch.lint --changed --sarif`` analyzes the whole
tree (cross-file rules stay sound) but reports only files touched
since HEAD, in a format the CI diff-annotation step uploads verbatim.
"""

from __future__ import annotations

from presto_tpu_torch.lint.core import Finding

SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
          "master/Schemata/sarif-schema-2.1.0.json")
VERSION = "2.1.0"
TOOL_NAME = "presto_tpu_torch.lint"


def _result(f: Finding, suppressed: bool,
            rule_index: dict[str, int]) -> dict:
    out = {
        "ruleId": f.rule,
        "ruleIndex": rule_index[f.rule],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                # line-precision region on purpose: SARIF columns are
                # UTF-16 code units (§3.30.6) while ast col_offset is
                # a UTF-8 byte offset — emitting the raw offset would
                # underline the wrong column on any line with a
                # non-ASCII character before the finding, and diff
                # annotation (the consumer this mode exists for) is
                # line-granular anyway
                "region": {"startLine": max(f.line, 1)},
            },
        }],
    }
    # an explicit empty array means "checked, not suppressed" (SARIF
    # §3.27.23) — consumers distinguish that from "tool has no
    # suppression info", so active findings carry [] on purpose
    out["suppressions"] = [{"kind": "inSource"}] if suppressed else []
    return out


def to_sarif(findings: list[Finding],
             suppressed: list[Finding] | None = None,
             rule_ids: list[str] | None = None) -> dict:
    """One SARIF 2.1.0 log dict for a lint run. ``rule_ids`` is the
    full set of rules that RAN (they all appear in the tool driver's
    rule table, findings or not, so a consumer can tell "rule passed"
    from "rule never executed")."""
    suppressed = suppressed or []
    ids = sorted(set(rule_ids or ())
                 | {f.rule for f in findings}
                 | {f.rule for f in suppressed})
    rule_index = {r: i for i, r in enumerate(ids)}
    results = ([_result(f, False, rule_index) for f in findings]
               + [_result(f, True, rule_index) for f in suppressed])
    return {
        "$schema": SCHEMA,
        "version": VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": TOOL_NAME,
                "informationUri":
                    "https://github.com/willmostly/presto",
                "rules": [{"id": r,
                           "defaultConfiguration": {"level": "error"}}
                          for r in ids],
            }},
            "results": results,
        }],
    }
