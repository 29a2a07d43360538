"""Field-level lockset rule: every field agrees on WHICH lock guards it.

The Eraser algorithm (Savage et al., SOSP '97) adapted to this
codebase's static project model: for each ``self.<attr>`` of a class in
the threaded subsystems (locks.py LOCK_SCOPES), compute the set of
locks held at every read/write site — lexically held ``with`` locks
plus the entry lockset locks.py infers for lock-private helpers — and
require the write-side locksets to share a common lock that every
other lock-holding access also holds. ``lock-discipline`` (locks.py)
already flags accesses holding NO lock; this rule owns the cases it
cannot see:

- a field written under lock A in one method and under lock B in
  another (``mixed locksets``: neither lock orders the writes);
- a field written under lock A but read/mutated under a DISJOINT
  lock B — both sites "hold a lock", yet they do not exclude each
  other, which is exactly how the four hand-fixed races of PRs 2/4/6/8
  looked in review.

Refinements that keep the rule enforceable at zero findings:

- ``__init__`` straight-line writes are construction-time publication
  (no other thread can hold a reference yet) and are exempt, as in
  locks.py; a field ONLY ever written there is immutable-after-publish
  and entirely out of scope.
- Reads of a field whose every post-init write is a whole-reference
  assignment (``self._snap = new_obj``) are reads of an atomically
  swapped reference: CPython publishes the pointer atomically, so a
  reader under an unrelated lock sees a complete object (the
  snapshot-copy idiom). Mutating writes (``+=``, subscript stores,
  ``.append``/``.update``/...) void the exemption — a mutated object
  has intermediate states a disjoint-lock reader can observe.
- Deliberate single-field invariants (a benign racy counter, a
  grow-only cache) carry ``# lint: disable=lockset`` plus a comment
  saying why, same policy as every other rule here.
"""

from __future__ import annotations

from presto_tpu_torch.lint.core import Finding, Project, rule
from presto_tpu_torch.lint.locks import (KIND_ASSIGN, _LOCK_NAME_RE,
                                   _Access, class_analyses)


def _fmt(locks: frozenset) -> str:
    return "{" + ", ".join(sorted(locks)) + "}" if locks else "no lock"


@rule("lockset")
def lockset(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod, analyses, entry in class_analyses(project).values():

        def held(acc: _Access, entry=entry) -> frozenset:
            locks = acc.locks
            u = acc.unit
            if u.is_method:
                locks = locks | entry.get((u.cls_name, u.name),
                                          frozenset())
            return locks

        for a in analyses:
            by_attr: dict[str, list[_Access]] = {}
            for u in a.units:
                if u.is_init_body:
                    continue
                for acc in u.accesses:
                    if not _LOCK_NAME_RE.search(acc.attr):
                        by_attr.setdefault(acc.attr, []).append(acc)
            for attr, accesses in sorted(by_attr.items()):
                writes = [x for x in accesses if x.is_write]
                locked_writes = [x for x in writes if held(x)]
                if not locked_writes:
                    # never lock-guarded on the write side: either not
                    # shared state, or a bare-write bug that is
                    # lock-discipline's finding, not ours
                    continue
                guard = frozenset.intersection(
                    *[held(x) for x in locked_writes])
                if not guard:
                    # anchor at the first write whose lockset actually
                    # conflicts with the first site's, so the finding
                    # (and any suppression) lands on a genuinely
                    # disagreeing line, not an innocent third write
                    first = held(locked_writes[0])
                    w = next((x for x in locked_writes[1:]
                              if not (held(x) & first)),
                             locked_writes[-1])
                    others = sorted({_fmt(held(x))
                                     for x in locked_writes})
                    findings.append(Finding(
                        "lockset", mod.relpath, w.line, w.col,
                        f"{a.cls.name}.{attr} is written under mixed "
                        f"locksets ({' vs '.join(others)}): no common "
                        "lock orders the writes, so they do not "
                        "exclude each other — pick one lock for this "
                        "field (or suppress with the invariant that "
                        "makes the mix safe)"))
                    continue
                atomically_published = all(
                    x.kind == KIND_ASSIGN for x in writes)
                # only READS can disagree from here on: every locked
                # write contains guard by construction (guard is their
                # intersection), disjoint-locked writes emptied guard
                # above, and unlocked writes are lock-discipline's
                for acc in accesses:
                    if acc.is_write:
                        continue
                    locks = held(acc)
                    if not locks or locks & guard:
                        # unlocked sites are lock-discipline findings;
                        # sites sharing the guard are correct
                        continue
                    if atomically_published:
                        # reading an atomically swapped whole-object
                        # reference under an unrelated lock is the
                        # blessed snapshot idiom
                        continue
                    findings.append(Finding(
                        "lockset", mod.relpath, acc.line, acc.col,
                        f"{a.cls.name}.{attr} is read under "
                        f"{_fmt(locks)} in `{acc.unit.name}` but its "
                        f"write-side lockset is {_fmt(guard)} (e.g. "
                        f"line {locked_writes[0].line}): disjoint "
                        "locks do not exclude each other — take the "
                        "guarding lock here, restructure to an atomic "
                        "whole-reference publish, or suppress with "
                        "the invariant that makes this safe"))
    return findings
