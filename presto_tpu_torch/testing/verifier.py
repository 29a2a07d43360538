"""Verifier: A/B replay of a query suite against two engines.

Analog of the reference's trino-verifier (service/trino-verifier —
replays a suite against a control and a test cluster and compares row
checksums + relative wall times). Targets are either in-process Engines
or live coordinators through the REST client, so upgrades can be
validated control-vs-test exactly like the reference workflow."""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable


@dataclasses.dataclass
class VerifyResult:
    sql: str
    status: str  # MATCH | MISMATCH | CONTROL_ERROR | TEST_ERROR
    control_rows: int = 0
    test_rows: int = 0
    control_s: float = 0.0
    test_s: float = 0.0
    detail: str = ""


def _canonical_checksum(rows: list[tuple], ordered: bool) -> str:
    def norm(v):
        if isinstance(v, float):
            return f"{v:.9g}"
        if isinstance(v, bool):
            return str(int(v))
        return str(v)

    lines = ["\x1f".join(norm(v) for v in row) for row in rows]
    if not ordered:
        lines.sort()
    h = hashlib.blake2b(digest_size=16)
    for ln in lines:
        h.update(ln.encode())
        h.update(b"\x1e")
    return h.hexdigest()


class Verifier:
    """``control`` / ``test``: callables sql -> list of row tuples (an
    Engine's .execute, a Client's lambda, or a mesh-bound runner)."""

    def __init__(self, control: Callable, test: Callable):
        self.control = control
        self.test = test

    def run_one(self, sql: str) -> VerifyResult:
        ordered = "order by" in sql.lower()
        t0 = time.perf_counter()
        try:
            want = self.control(sql)
        except Exception as e:  # noqa: BLE001 - reported, not raised
            return VerifyResult(sql, "CONTROL_ERROR",
                                detail=f"{type(e).__name__}: {e}")
        control_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            got = self.test(sql)
        except Exception as e:  # noqa: BLE001
            return VerifyResult(sql, "TEST_ERROR", len(want), 0,
                                control_s,
                                detail=f"{type(e).__name__}: {e}")
        test_s = time.perf_counter() - t0
        want_ck = _canonical_checksum([tuple(r) for r in want], ordered)
        got_ck = _canonical_checksum([tuple(r) for r in got], ordered)
        if want_ck != got_ck:
            return VerifyResult(
                sql, "MISMATCH", len(want), len(got), control_s, test_s,
                detail=f"checksum {want_ck[:12]} != {got_ck[:12]}")
        return VerifyResult(sql, "MATCH", len(want), len(got),
                            control_s, test_s)

    def run_suite(self, queries: list[str]) -> list[VerifyResult]:
        return [self.run_one(q) for q in queries]


def format_report(results: list[VerifyResult]) -> str:
    counts: dict[str, int] = {}
    for r in results:
        counts[r.status] = counts.get(r.status, 0) + 1
    lines = [
        "verifier: " + "  ".join(
            f"{k}={v}" for k, v in sorted(counts.items()))]
    for r in results:
        head = r.sql.strip().splitlines()[0][:60]
        speed = (f"{r.control_s / r.test_s:.2f}x"
                 if r.test_s > 0 else "-")
        lines.append(
            f"  [{r.status:>13}] rows {r.control_rows}/{r.test_rows} "
            f"control/test {r.control_s * 1e3:.0f}/{r.test_s * 1e3:.0f}"
            f" ms ({speed})  {head}" + (f"  {r.detail}" if r.detail
                                        else ""))
    return "\n".join(lines)
