"""Unified metrics registry with Prometheus text exposition.

Analog of the reference's JMX metric surface (every subsystem registers
MBeans, io.airlift.stats CounterStat/DistributionStat, exported over
REST /v1/jmx/mbean): one process-wide, thread-safe registry of
counters, gauges, and histograms that both the coordinator and the
worker serve at ``GET /metrics`` in the standard scrape format. Metric
naming is VALIDATED at registration (and statically by
``lint/metrics.py``): names match ``presto_tpu_[a-z0-9_]+``, counters
end ``_total`` and never decrease, gauges never end ``_total``, and
histograms carry a unit suffix — the class of dashboard-corrupting bug
the old hand-rolled ``/metrics`` string builder shipped (a "counter"
recomputed from a bounded snapshot that DECREASED on history eviction).

Per-node values (memory, cache sizes) are labeled ``node=...`` so
several servers in one process — the in-process cluster the tests
boot — share the registry without clobbering each other.
"""

from __future__ import annotations

import re
import threading

_NAME_RE = re.compile(r"^presto_tpu_[a-z0-9_]+$")

# unit suffixes accepted on histogram names (Prometheus base units;
# _ratio is the dimensionless unit — e.g. actual/estimated rows,
# _queries counts whole queries — e.g. cross-query batch sizes)
HISTOGRAM_UNITS = ("_seconds", "_bytes", "_rows", "_ratio", "_queries")

DEFAULT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 1.0, 2.5, 10.0,
                   30.0, 120.0)


class MetricError(ValueError):
    """Invalid metric name, duplicate registration, or misuse (e.g.
    counter decrement)."""


def validate_metric_name(name: str, kind: str) -> str | None:
    """The naming contract, shared verbatim by the runtime registry and
    the static lint rule (lint/metrics.py). Returns an error message or
    None when the name is valid for ``kind``."""
    if not _NAME_RE.match(name):
        return (f"metric name {name!r} must match "
                "presto_tpu_[a-z0-9_]+")
    if kind == "counter" and not name.endswith("_total"):
        return (f"counter {name!r} must end in _total "
                "(Prometheus counter convention)")
    if kind == "gauge" and name.endswith("_total"):
        return (f"gauge {name!r} must not end in _total — _total "
                "promises monotonicity a gauge cannot keep")
    if kind == "histogram" and not name.endswith(HISTOGRAM_UNITS):
        return (f"histogram {name!r} must carry a unit suffix "
                f"({', '.join(HISTOGRAM_UNITS)})")
    return None


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in key)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.6f}"
    return str(int(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def render(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, v in items:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines


class Counter(_Metric):
    """Monotonic counter. ``inc`` with a negative amount raises — the
    registry's guarantee that a scrape series never goes backwards."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise MetricError(
                f"counter {self.name} cannot decrease (inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum over every label combination (bench/test reporting of
        labeled counters — callers must not reach into _values)."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (le-labeled buckets + _sum/_count,
    the exposition Prometheus expects for latency series)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets))
        # label key -> [bucket counts..., +Inf count, sum]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = self._series[key] = [0] * (len(self.buckets) + 1) \
                    + [0.0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
            row[len(self.buckets)] += 1  # +Inf / count
            row[-1] += value

    def count(self, **labels) -> int:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return 0 if row is None else row[len(self.buckets)]

    def sum(self, **labels) -> float:
        with self._lock:
            row = self._series.get(_label_key(labels))
            return 0.0 if row is None else row[-1]

    def render(self) -> list[str]:
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, row in items:
            for i, b in enumerate(self.buckets):
                lk = _render_labels(key + (("le", _fmt(float(b))),))
                lines.append(f"{self.name}_bucket{lk} {row[i]}")
            lk = _render_labels(key + (("le", "+Inf"),))
            lines.append(f"{self.name}_bucket{lk} "
                         f"{row[len(self.buckets)]}")
            lines.append(f"{self.name}_sum{_render_labels(key)} "
                         f"{row[-1]:.6f}")
            lines.append(f"{self.name}_count{_render_labels(key)} "
                         f"{row[len(self.buckets)]}")
        return lines


class MetricsRegistry:
    """Thread-safe, name-validated metric registry.

    Registration is get-or-create: the coordinator and every worker in
    one process register the same instruments and share the series
    (tests boot whole clusters in-process). Re-registering a name as a
    DIFFERENT kind is the error the lint rule also catches statically.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, name: str, kind: str, factory) -> _Metric:
        err = validate_metric_name(name, kind)
        if err is not None:
            raise MetricError(err)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind:
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {kind}")
                return existing
            m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(
            name, "counter", lambda: Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(
            name, "gauge", lambda: Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            name, "histogram", lambda: Histogram(name, help_text,
                                                 buckets))

    def render(self) -> str:
        """Prometheus text exposition of every registered metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# the process-wide default registry: both server roles scrape this
REGISTRY = MetricsRegistry()
