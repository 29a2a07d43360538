"""The port's own spans of a traced window, read back from its tracer.

``record.Spans`` opens one trace of ``obs/trace.TRACER`` around each
query of a traced window, rooted at a ``bench-query`` span; the engine
records its own spans into it: ``query``, ``plan``, ``execute`` and,
below ``execute``, ``program``, ``pass``, one span per plan node
(named by its type), ``fetch`` and ``upload`` (each with its ``site``
and ``bytes``). The tracer keeps its newest ``MAX_TRACES`` (256)
traces, so after the window it still holds the window's last 256
queries, 32 whole rounds of an eight-query mix, or all of a shorter
window. Nothing else in a run opens a trace.

:func:`window` sums those traces for the metric readers, and reads
nothing unless the tracer holds one for each of the window's last 256
queries. The rest serves ``spanreport.py``: idle gaps named by the
innermost span open over them, the device's copies by the transfer
span open over them, self time by span, and the routes the queries
took.
"""

from __future__ import annotations

import collections

import numpy as np

ROOT = "bench-query"
DROPPED = "presto_tpu_trace_spans_dropped_total"


def port_tracer():
    from presto_tpu_torch.obs.trace import TRACER
    return TRACER


def window_traces(tracer=None) -> list[list]:
    """The spans of each window query the tracer still holds, oldest
    first; none where the program cannot list its traces."""
    if tracer is None:
        tracer = port_tracer()
    ids = getattr(tracer, "trace_ids", None)
    if ids is None:
        return []
    out = []
    for tid in ids():
        spans = tracer.spans(tid)
        if spans and spans[0].name == ROOT and spans[0].parent_id is None:
            out.append(spans)
    return out


def dropped() -> int:
    """Spans the tracer dropped at its per-trace cap in this process."""
    from presto_tpu_torch.obs.metrics import REGISTRY
    return int(REGISTRY.counter(
        DROPPED, "spans not recorded because their trace held "
        "MAX_SPANS_PER_TRACE").value())


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by the union of ``intervals``."""
    covered, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return covered


def totals(traces) -> dict:
    """Sums over the traces: ``queries``, ``spans`` recorded,
    ``execute`` spans, ``pass_s`` (seconds of ``pass`` spans),
    ``execute_self_s`` (seconds of each ``execute`` span not covered by
    the union of the ``pass`` and ``fetch`` spans inside it),
    ``fetch_bytes`` and ``upload_bytes`` (of ``fetch`` and ``upload``
    spans), ``programs``, ``cache_hits`` and ``extra_passes`` (of
    ``program`` spans). Unfinished spans count only as recorded."""
    out = dict(queries=len(traces), spans=0, execute=0, pass_s=0.0,
               execute_self_s=0.0, fetch_bytes=0, upload_bytes=0,
               programs=0, cache_hits=0, extra_passes=0)
    for spans in traces:
        out["spans"] += len(spans)
        done = [s for s in spans if s.t1 is not None]
        cover = [(s.t0, s.t1) for s in done if s.name in ("pass", "fetch")]
        for s in done:
            if s.name == "pass":
                out["pass_s"] += s.t1 - s.t0
            elif s.name == "execute":
                out["execute"] += 1
                out["execute_self_s"] += (s.t1 - s.t0) - union_s(
                    cover, s.t0, s.t1)
            elif s.name in ("fetch", "upload"):
                out[f"{s.name}_bytes"] += int(s.attrs.get("bytes", 0))
            elif s.name == "program":
                out["programs"] += 1
                out["cache_hits"] += bool(s.attrs.get("cache_hit"))
                out["extra_passes"] += max(
                    0, int(s.attrs.get("passes", 1)) - 1)
    return out


def window(run, tracer=None) -> dict | None:
    """:func:`totals` of the traces of the window's last
    ``tracer.max_traces`` (256) queries, or None: for an untraced run,
    off the card (there a tensor's pass computes it on the host, and a
    fetch copies nothing across a bus), where the tracer does not hold
    exactly one trace for each of those queries (a smaller store, or
    one that something else filled), where no trace holds an
    ``execute`` span (a program without these spans), and where the
    tracer dropped a span at its cap (a sum would come out short)."""
    if run.trace is None or run.peak_window_bytes is None:
        return None
    if tracer is None:
        tracer = port_tracer()
    traces = window_traces(tracer)
    want = min(run.trace.queries, getattr(tracer, "max_traces", 0))
    if len(traces) != want:
        return None
    t = totals(traces)
    if not t["queries"] or not t["execute"] or dropped():
        return None
    return t


def span_label(s) -> str:
    """A span as a label names it: its name, and a transfer's site."""
    site = s.attrs.get("site") if s.name in ("fetch", "upload") else None
    return s.name if site is None else f"{s.name} {site}"


def below_execute(traces) -> list:
    """Per query: (label, t0, t1) of each finished span inside one of
    its finished ``execute`` spans, in the order they were recorded."""
    out = []
    for spans in traces:
        done = [s for s in spans if s.t1 is not None]
        ex = [(s.t0, s.t1) for s in done if s.name == "execute"]
        out.append([(span_label(s), s.t0, s.t1) for s in done
                    if s.name != "execute"
                    and any(a <= s.t0 and s.t1 <= b for a, b in ex)])
    return out


def innermost(gap_start, gap_end, q_t0, below) -> list:
    """Per gap (sorted by start): the label of the innermost span open
    at its middle below its query's ``execute`` (the latest to open of
    those that hold it, the later recorded on a tie), else None.
    ``q_t0`` are the queries' starts, ``below`` as
    :func:`below_execute` gives it, one entry per query."""
    mids = (np.asarray(gap_start, float) + np.asarray(gap_end, float)) / 2
    qi = np.searchsorted(np.asarray(q_t0, float), mids, side="right") - 1
    out: list = [None] * len(mids)
    for i, inner in enumerate(below):
        lo, hi = np.searchsorted(qi, [i, i + 1])
        if not inner or lo == hi:
            continue
        s0 = np.array([x[1] for x in inner])
        s1 = np.array([x[2] for x in inner])
        rank = np.empty(len(inner), dtype=np.int64)
        rank[np.lexsort((np.arange(len(inner)), s0))] = np.arange(len(inner))
        m = mids[lo:hi, None]
        key = np.where((m >= s0) & (m <= s1), rank, -1)
        best = key.argmax(axis=1)
        for g in np.flatnonzero(key.max(axis=1) >= 0):
            out[lo + g] = inner[best[g]][0]
    return out


def label_gaps(gap_start, gap_end, queries, plans, below) -> list:
    """Idle seconds by what the host was doing at each gap's middle,
    every label, largest first: ``<query> execute <span>`` inside a
    span below the query's ``execute``, else ``record.label_gaps``'s
    labels (``<query> plan``, ``<query> execute`` or ``client``).
    ``queries`` are (name, t0, t1), ``plans`` (t0, t1), epoch s."""
    q_t0 = np.array([q[1] for q in queries])
    p = np.array(sorted(plans)) if plans else np.zeros((0, 2))
    inner = innermost(gap_start, gap_end, q_t0, below)
    out: collections.Counter = collections.Counter()
    for k, (a, b) in enumerate(zip(gap_start, gap_end)):
        mid = (a + b) / 2
        i = int(np.searchsorted(q_t0, mid, side="right")) - 1
        if i < 0 or mid > queries[i][2]:
            out["client"] += b - a
        elif inner[k] is not None:
            out[f"{queries[i][0]} execute {inner[k]}"] += b - a
        else:
            j = int(np.searchsorted(p[:, 0], mid, side="right")) - 1 \
                if len(p) else -1
            phase = "plan" if j >= 0 and mid <= p[j, 1] else "execute"
            out[f"{queries[i][0]} {phase}"] += b - a
    return [[k, float(v)] for k, v in out.most_common()]


def copies_by_span(names, starts, ends, kind: str, spans, t0: float,
                   t1: float) -> dict:
    """Device seconds within [t0, t1] of the activities whose name
    starts with ``kind`` (``Memcpy DtoH``), by the label of the span
    open at each one's middle, else ``outside``. ``spans`` are (label,
    t0, t1), none inside another (``fetch`` spans, or ``upload``)."""
    sp = sorted(spans, key=lambda x: x[1])
    s0 = np.array([x[1] for x in sp])
    s1 = np.array([x[2] for x in sp])
    out: collections.Counter = collections.Counter()
    for n, a, b in zip(names, starts, ends):
        a, b = max(a, t0), min(b, t1)
        if b <= a or not n.startswith(kind):
            continue
        mid = (a + b) / 2
        i = int(np.searchsorted(s0, mid, side="right")) - 1
        out[sp[i][0] if i >= 0 and mid <= s1[i] else "outside"] += b - a
    return dict(out)


def routes(traces, names=None) -> dict:
    """Count of ``execute`` spans by ``<query> <route>``, or by route
    alone where ``names`` (the queries', one a trace) is not given."""
    if names is None or len(names) != len(traces):
        names = [None] * len(traces)
    out: collections.Counter = collections.Counter()
    for name, spans in zip(names, traces):
        for s in spans:
            if s.name == "execute":
                r = s.attrs.get("route")
                out[str(r) if name is None else f"{name} {r}"] += 1
    return dict(out)


def self_by_label(traces) -> dict:
    """Host seconds of every finished span less the union of its
    finished children, summed by label."""
    out: collections.Counter = collections.Counter()
    for spans in traces:
        kids = collections.defaultdict(list)
        for s in spans:
            if s.t1 is not None and s.parent_id is not None:
                kids[s.parent_id].append((s.t0, s.t1))
        for s in spans:
            if s.t1 is not None:
                out[span_label(s)] += (s.t1 - s.t0) - union_s(
                    kids[s.span_id], s.t0, s.t1)
    return dict(out)
