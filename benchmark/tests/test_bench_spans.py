"""The readers of the port's own spans (harness/spans.py and the four
metrics on it) on hand-made traces, and the span report of
spanreport.py on a small CPU run."""

from __future__ import annotations

import json

import numpy as np
import pytest

import run as R
from conftest import BENCH
from harness import cell as C
from harness import record
from harness import spans as S
from presto_tpu_torch.obs import trace as OT

NEW = ("operator_host_ms", "execute_self_ms", "fetch_mib_per_query",
       "upload_mib_per_query")


class Q:
    """Builds one query's trace: spans by (name, t0, t1, parent)."""

    def __init__(self, tid: str):
        self.tid = tid
        self.spans: list = []

    def add(self, name, t0, t1, parent=None, **attrs):
        s = OT.Span(self.tid, f"{self.tid}-{len(self.spans)}",
                    None if parent is None else parent.span_id, name,
                    attrs, t0, t1)
        self.spans.append(s)
        return s


def _query(tid, t0, *, fetch_bytes=(4096,), upload_bytes=(1 << 20,),
           overlap=False):
    """A bench query at ``t0``: plan 1 ms, then execute 10 ms with one
    program of two passes (3 ms and 2 ms), a fetch after each pass, an
    upload inside the first pass; ``overlap`` puts the first fetch
    inside the first pass."""
    q = Q(tid)
    root = q.add(S.ROOT, t0, t0 + 0.012)
    query = q.add("query", t0, t0 + 0.012, root)
    q.add("plan", t0, t0 + 0.001, query)
    ex = q.add("execute", t0 + 0.001, t0 + 0.011, query, route="whole")
    prog = q.add("program", t0 + 0.0015, t0 + 0.0095, ex, cache_hit=True,
                 passes=2)
    p0 = q.add("pass", t0 + 0.002, t0 + 0.005, prog)
    agg = q.add("Aggregate", t0 + 0.002, t0 + 0.005, p0)
    q.add("upload", t0 + 0.003, t0 + 0.0035, agg, site="literal",
          bytes=upload_bytes[0])
    f0 = (t0 + 0.0045, t0 + 0.0055) if overlap else (t0 + 0.005,
                                                     t0 + 0.0055)
    q.add("fetch", *f0, prog, site="ok-ladder", bytes=fetch_bytes[0])
    q.add("pass", t0 + 0.006, t0 + 0.008, prog)
    q.add("fetch", t0 + 0.008, t0 + 0.009, prog, site="ok-ladder", bytes=0)
    return q


def _tracer(queries, other=()):
    tracer = OT.Tracer()
    for q in list(queries) + list(other):
        tracer.import_spans([s.to_dict() for s in q.spans])
    return tracer


def _run(card=True, traced=True, queries=3):
    tr = None
    if traced:
        tr = R.Trace(queries=queries, plan_s=0.003, syncs=12, launch_bytes=0,
                     launch_s=0.0, hbm_bytes_per_s=None, busy_s=None,
                     window_s=1.0, device_ops=[], idle_gaps=[])
    return R.Run(setup_s=1.0, window_s=1.0, latencies=[0.012] * 3,
                 completed=3, peak_window_bytes=2 ** 30 if card else None,
                 trace=tr)


@pytest.fixture
def window(monkeypatch):
    """Three bench queries in the port's tracer, and one trace that is
    not the benchmark's (a server's query)."""
    qs = [_query(f"bench-{i}", 100.0 + i) for i in range(3)]
    other = Q("q_0001")
    other.add("query", 99.0, 99.5)
    monkeypatch.setattr(OT, "TRACER", _tracer(qs, [other]))
    monkeypatch.setattr(S, "dropped", lambda: 0)
    return qs


def test_readers_of_the_window(window):
    run = _run()
    # per query: passes 3 + 2 ms; execute 10 ms less passes and fetches
    # (0.5 + 1 ms, outside the passes) = 3.5 ms
    assert C.reader("operator_host_ms")(run) == pytest.approx(5.0)
    assert C.reader("execute_self_ms")(run) == pytest.approx(3.5)
    assert C.reader("fetch_mib_per_query")(run) == pytest.approx(
        4096 / 2**20)
    assert C.reader("upload_mib_per_query")(run) == pytest.approx(1.0)


def test_readers_with_nothing_to_read(window, monkeypatch):
    for name in NEW:
        assert C.reader(name)(_run(card=False)) is None
        assert C.reader(name)(_run(traced=False)) is None
    monkeypatch.setattr(S, "dropped", lambda: 1)
    for name in NEW:
        assert C.reader(name)(_run()) is None
    monkeypatch.setattr(S, "dropped", lambda: 0)
    # the parent's spans: plan, no execute
    plain = Q("bench-p")
    root = plain.add(S.ROOT, 1.0, 2.0)
    plain.add("plan", 1.0, 1.1, plain.add("query", 1.0, 2.0, root))
    monkeypatch.setattr(OT, "TRACER", _tracer([plain]))
    for name in NEW:
        assert C.reader(name)(_run()) is None
    # a program whose tracer cannot list its traces
    monkeypatch.setattr(OT, "TRACER", object())
    for name in NEW:
        assert C.reader(name)(_run()) is None


def test_every_cell_lists_the_new_metrics():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in spec["workloads"]]
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert entries[name]["workloads"] == cells
        assert entries[name]["moves"] == "queries_per_s"


def test_readers_need_a_trace_for_each_of_the_last_queries(monkeypatch):
    monkeypatch.setattr(S, "dropped", lambda: 0)
    qs = [_query(f"bench-{i}", 100.0 + i, fetch_bytes=(1 << (20 + i),))
          for i in range(3)]
    # a store of two: it holds the window's last two queries
    small = OT.Tracer(max_traces=2)
    for q in qs:
        small.import_spans([s.to_dict() for s in q.spans])
    monkeypatch.setattr(OT, "TRACER", small)
    assert C.reader("fetch_mib_per_query")(_run()) == pytest.approx(3.0)
    # a window of four queries with three traces: one is missing
    monkeypatch.setattr(OT, "TRACER", _tracer(qs))
    for name in NEW:
        assert C.reader(name)(_run(queries=4)) is None
    # a store another trace filled: the window's oldest query fell out
    monkeypatch.setattr(OT, "TRACER", small)
    other = Q("q_0001")
    other.add("query", 99.0, 99.5)
    small.import_spans([s.to_dict() for s in other.spans])
    for name in NEW:
        assert C.reader(name)(_run()) is None


def test_routes_by_query():
    a, b = _query("bench-a", 1.0), _query("bench-b", 2.0)
    for s in b.spans:
        if s.name == "execute":
            s.attrs["route"] = "streamed"
    assert S.routes([a.spans, b.spans, a.spans], ["q14", "q01", "q14"]) \
        == {"q14 whole": 2, "q01 streamed": 1}
    assert S.routes([a.spans, b.spans]) == {"whole": 1, "streamed": 1}
    assert S.routes([a.spans], ["q14", "q01"]) == {"whole": 1}


def test_self_time_is_not_double_counted_where_spans_overlap():
    t = S.totals([_query("bench-o", 10.0, overlap=True).spans])
    # the first fetch starts 0.5 ms inside its pass: the union covers
    # 3 + 2 ms of passes, 0.5 + 1 ms of fetches outside them
    assert t["execute_self_s"] == pytest.approx(0.0035)
    assert t["pass_s"] == pytest.approx(0.005)
    assert (t["programs"], t["cache_hits"], t["extra_passes"]) == (1, 1, 1)
    assert S.union_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)], 0.5, 5.8) == \
        pytest.approx(3.3)


def test_label_gaps_names_the_innermost_span():
    q = Q("bench-l")
    root = q.add(S.ROOT, 0.0, 1.0)
    query = q.add("query", 0.0, 1.0, root)
    q.add("plan", 0.0, 0.1, query)
    ex = q.add("execute", 0.1, 0.9, query)
    p = q.add("pass", 0.2, 0.6, q.add("program", 0.15, 0.8, ex))
    union = q.add("Union", 0.2, 0.6, p)
    q.add("Aggregate", 0.3, 0.4, union)
    q.add("fetch", 0.65, 0.7, ex, site="result-demux")
    queries = [("q27", 0.0, 1.0), ("q19", 1.5, 2.0)]
    plans = [(0.0, 0.1), (1.5, 1.6)]
    gaps = np.array([[0.02, 0.06],    # plan
                     [0.12, 0.14],    # execute, below nothing
                     [0.16, 0.18],    # program
                     [0.25, 0.29],    # Union, outside its Aggregate
                     [0.33, 0.37],    # Aggregate, inside Union
                     [0.66, 0.69],    # fetch
                     [1.2, 1.4],      # between queries: client
                     [1.7, 1.9]])     # q19 has no spans
    below = S.below_execute([q.spans, []])
    got = dict(S.label_gaps(gaps[:, 0], gaps[:, 1], queries, plans, below))
    want = {"q27 plan": 0.04, "q27 execute": 0.02,
            "q27 execute program": 0.02, "q27 execute Union": 0.04,
            "q27 execute Aggregate": 0.04,
            "q27 execute fetch result-demux": 0.03, "client": 0.2,
            "q19 execute": 0.2}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v)
    # a tie on the start: the later recorded is the inner one
    tie = Q("bench-t")
    r = tie.add("execute", 0.0, 1.0)
    outer = tie.add("pass", 0.2, 0.6, r)
    tie.add("Output", 0.2, 0.6, outer)
    assert S.innermost([0.3], [0.4], [0.0],
                       S.below_execute([tie.spans])) == ["Output"]


def test_label_gaps_without_spans_equals_the_harness():
    f = json.loads((BENCH / "tests" / "trace_fixture.json").read_text())
    starts = np.array([a[1] for a in f["activity"]])
    ends = np.array([a[2] for a in f["activity"]])
    _busy, g0, g1 = record.busy_and_gaps(starts, ends, *f["window"])
    queries = [tuple(q) for q in f["queries"]]
    plans = [tuple(p) for p in f["plans"]]
    want = record.label_gaps(g0, g1, queries, plans)
    got = S.label_gaps(g0, g1, queries, plans, [[] for _ in queries])
    assert dict(got) == pytest.approx(dict(want))


def test_copies_by_the_span_open_over_them():
    names = ["Memcpy DtoH (Device -> Pageable)", "kernel",
             "Memcpy DtoH (Device -> Pageable)",
             "Memcpy DtoH (Device -> Pinned)", "Memcpy HtoD"]
    starts = np.array([1.0, 1.0, 2.5, 4.0, 1.1])
    ends = np.array([1.2, 3.0, 2.7, 4.5, 1.15])
    fetches = [("fetch ok-ladder", 0.9, 1.3), ("fetch result-demux",
                                              3.9, 4.6)]
    got = S.copies_by_span(names, starts, ends, "Memcpy DtoH", fetches,
                           0.0, 4.2)
    assert got == pytest.approx({"fetch ok-ladder": 0.2, "outside": 0.2,
                                 "fetch result-demux": 0.2})


def test_self_seconds_by_span():
    q = _query("bench-s", 0.0)
    got = S.self_by_label([q.spans])
    assert got["Aggregate"] == pytest.approx(0.0025)  # less the upload
    assert got["pass"] == pytest.approx(0.002)  # the second pass
    assert got["fetch ok-ladder"] == pytest.approx(0.0015)


def test_span_report_on_the_cpu():
    import spanreport as SR
    cap = SR.Capture()
    plain = (record.Spans, record.DeviceTrace, record.top_ops,
             record.label_gaps)
    cap.install()
    try:
        out, lines = R.run("tpch-sf10.power", 2 ** 31 + 29, 1.0, True,
                           device="cpu", scale=0.01)
    finally:
        cap.uninstall()
    assert (record.Spans, record.DeviceTrace, record.top_ops,
            record.label_gaps) == plain
    assert out["correct"], lines
    assert len(cap.traces) == out["attempted"]
    extra, nums = cap.report(out)
    assert nums["queries"] == out["attempted"]
    assert nums["spans_per_query"] > 10 and nums["spans_dropped"] == 0
    assert 0 <= nums["cache_hit_share"] <= 1
    t = S.totals(cap.traces)
    assert t["execute"] == out["attempted"] and t["pass_s"] > 0
    assert extra[0].startswith("traced:")
    assert extra[-1].startswith("host self seconds by span:")
    assert any(x.startswith("execute spans by query and route:")
               for x in extra)
    assert sum(nums["routes"].values()) == out["attempted"]
