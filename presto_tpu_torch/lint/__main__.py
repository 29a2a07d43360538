"""CLI: ``python -m presto_tpu_torch.lint [paths...] [--json | --sarif]
[--rules ...] [--changed]``.

Exits 0 when clean, 1 when there are unsuppressed findings, 2 on usage
errors — so the lint can gate CI the way the tier-1 tests do.
``--changed --sarif`` is the pre-commit/CI recipe: whole-tree
analysis, reporting scoped to files touched since HEAD, output a
SARIF 2.1.0 log standard diff-annotation tooling ingests verbatim.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from presto_tpu_torch.lint import available_rules, run_lint


def _changed_files(paths: list[str]) -> set[Path]:
    """Resolved paths of ``.py`` files touched since HEAD (worktree
    diff, staged diff, and untracked files) in the git repo containing
    the first analyzed path. Raises ValueError outside a repo."""
    anchor = Path(paths[0]).resolve()
    anchor_dir = anchor if anchor.is_dir() else anchor.parent
    try:
        root = subprocess.run(
            ["git", "-C", str(anchor_dir), "rev-parse",
             "--show-toplevel"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip()
        diff = subprocess.run(
            ["git", "-C", root, "diff", "--name-only", "HEAD", "--"],
            capture_output=True, text=True, check=True, timeout=30)
        untracked = subprocess.run(
            ["git", "-C", root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, check=True, timeout=30)
    except (subprocess.CalledProcessError, OSError,
            subprocess.TimeoutExpired) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ValueError(
            f"--changed needs a git checkout: {detail.strip()}") from e
    out: set[Path] = set()
    for line in (diff.stdout + untracked.stdout).splitlines():
        if line.strip().endswith(".py"):
            out.add((Path(root) / line.strip()).resolve())
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.lint",
        description="Engine-specific static analysis: tracer hygiene, "
                    "lock discipline, lockset/handoff concurrency "
                    "rules, plan-dispatch exhaustiveness.")
    parser.add_argument("paths", nargs="*", default=["presto_tpu_torch"],
                        help="files or directories to analyze "
                             "(default: presto_tpu_torch)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule subset "
                             f"(available: {', '.join(available_rules())})")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable JSON findings on stdout")
    parser.add_argument("--sarif", action="store_true",
                        dest="as_sarif",
                        help="SARIF 2.1.0 log on stdout (rule ids, "
                             "file/line regions, messages, in-source "
                             "suppressions as suppressed results) — "
                             "the CI/code-scanning format; combine "
                             "with --changed for the pre-commit "
                             "recipe")
    parser.add_argument("--changed", action="store_true",
                        help="report only findings in files changed "
                             "since HEAD (worktree + staged + "
                             "untracked) — the fast pre-commit mode; "
                             "analysis still covers the whole tree so "
                             "cross-file rules stay sound")
    args = parser.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    if args.as_json and args.as_sarif:
        print("--json and --sarif are mutually exclusive",
              file=sys.stderr)
        return 2
    only_files = None
    suppressed: list | None = [] if args.as_sarif else None
    try:
        if args.changed:
            only_files = _changed_files(args.paths)
            if not only_files:
                # validate paths and rule names even on the fast
                # exit: a pre-commit hook with a typo'd --rules or
                # path must fail loudly on EVERY run, not only once
                # the worktree is dirty
                missing = [p for p in args.paths
                           if not Path(p).exists()]
                if missing:
                    raise ValueError(f"paths do not exist: {missing}")
                if rules:
                    unknown = [r for r in rules
                               if r not in available_rules()]
                    if unknown:
                        raise ValueError(
                            f"unknown lint rules: {unknown} "
                            f"(available: {available_rules()})")
                if args.as_json:
                    print("[]")
                elif args.as_sarif:
                    from presto_tpu_torch.lint.sarif import to_sarif
                    print(json.dumps(to_sarif(
                        [], [], rules or available_rules()), indent=2))
                else:
                    print("no changed .py files; nothing to lint",
                          file=sys.stderr)
                return 0
        findings = run_lint(args.paths, rules, only_files=only_files,
                            collect_suppressed=suppressed)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.as_json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    elif args.as_sarif:
        from presto_tpu_torch.lint.sarif import to_sarif
        print(json.dumps(to_sarif(findings, suppressed,
                                  rules or available_rules()),
                         indent=2))
    else:
        for f in findings:
            print(f.format())
        if findings:
            print(f"\n{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
