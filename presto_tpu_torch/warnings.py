"""Per-query warning collection (reference
execution/warnings/WarningCollector.java:21, spi TrinoWarning /
WarningCode): non-fatal diagnostics accumulate during
parse/plan/execute and surface through the protocol next to results.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class EngineWarning:
    """spi/TrinoWarning analog."""

    code: int
    name: str
    message: str

    def to_dict(self) -> dict:
        return {"warningCode": {"code": self.code, "name": self.name},
                "message": self.message}


# warning codes (reference spi/connector/StandardWarningCode.java)
PARSER_WARNING = (1, "PARSER_WARNING")
PERFORMANCE_WARNING = (2, "PERFORMANCE_WARNING")
DEPRECATED_SYNTAX = (3, "DEPRECATED_SYNTAX")


class WarningCollector:
    """Thread-safe accumulator, one per query."""

    def __init__(self, max_warnings: int = 100):
        self._warnings: list[EngineWarning] = []
        self._max = max_warnings
        self._lock = threading.Lock()

    def add(self, code: tuple[int, str], message: str) -> None:
        with self._lock:
            if len(self._warnings) >= self._max:
                return
            w = EngineWarning(code[0], code[1], message)
            if w not in self._warnings:
                self._warnings.append(w)

    def list(self) -> list[EngineWarning]:
        with self._lock:
            return list(self._warnings)


_CURRENT = threading.local()


def current() -> WarningCollector | None:
    return getattr(_CURRENT, "collector", None)


def push(collector: WarningCollector) -> None:
    _CURRENT.collector = collector


def pop() -> None:
    _CURRENT.collector = None


def warn(code: tuple[int, str], message: str) -> None:
    """Record into the active query's collector (no-op outside one)."""
    c = current()
    if c is not None:
        c.add(code, message)
