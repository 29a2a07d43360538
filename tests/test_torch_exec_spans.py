"""The port's spans inside the executor and operators, and its transfer
byte counters (obs/trace.py, exec/executor.py, exec/hostsync.py), on
the tpch connector at SF0.01 on the CPU:

- under a trace a query's spans form ``query`` -> ``plan``, ``execute``
  -> ``program`` -> ``pass`` -> one span per plan node, each with its
  parent's id; a streamed and a segmented plan carry their ``route``
  and more than one ``program``;
- each ``fetch`` and ``upload`` span's ``bytes`` equal the arrays that
  crossed, and their sums by site equal the change in the registry's
  ``presto_tpu_fetch_bytes_total`` and ``presto_tpu_upload_bytes_total``
  (``SYNCS.bytes_total()``, ``UPLOADS.bytes_total()``);
- an untraced query records nothing; span ids stay unique; spans past
  a trace's cap are counted as dropped."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from presto_tpu_torch import Engine
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import executor as EX
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.metrics import REGISTRY, Counter

from tpch_queries import QUERIES

Q1 = QUERIES["q01"]
NODE_TYPES = {"Output", "Sort", "Aggregate", "Project", "Filter",
              "TableScan", "Join", "MultiJoin", "TopN", "Limit"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(scale=0.01)


@pytest.fixture
def port(conn):
    e = Engine(device="cpu")
    e.register_catalog("tpch", conn)
    return e


_IDS = itertools.count()


def _traced(engine, sql):
    """(rows, spans) of ``sql`` run in a trace of its own."""
    tid = f"t-exec-spans-{next(_IDS)}"
    with OT.TRACER.trace(tid, "client"):
        rows = engine.execute(sql)
    return rows, OT.TRACER.spans(tid)


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def test_spans_form_the_layer_tree(port):
    want = port.execute(Q1)
    rows, spans = _traced(port, Q1)
    assert rows == want
    by_id = {s.span_id: s for s in spans}
    assert all(s.t1 is not None for s in spans)
    assert all(s.parent_id is None or s.parent_id in by_id for s in spans)
    root = spans[0]
    (query,) = _children(spans, root)
    assert query.name == "query"
    assert [s.name for s in _children(spans, query)] == ["plan", "execute"]
    plan, execute = _children(spans, query)
    assert plan.t1 <= execute.t0
    assert execute.attrs["route"] == "whole"
    programs = [s for s in _children(spans, execute) if s.name == "program"]
    assert len(programs) == 1
    prog = programs[0]
    assert prog.attrs == {"cache_hit": True,  # Q1's second run
                          "passes": port.last_run.passes[0]}
    passes = [s for s in _children(spans, prog) if s.name == "pass"]
    assert len(passes) == prog.attrs["passes"]
    assert all(p.attrs == {} for p in passes)
    (top,) = _children(spans, passes[-1])
    assert top.name == "Output" and top.attrs == {}

    def walk(s, depth):
        kids = [k for k in _children(spans, s) if k.name in NODE_TYPES]
        assert all(s.t0 <= k.t0 and k.t1 <= s.t1 for k in kids)
        return max([depth] + [walk(k, depth + 1) for k in kids])
    assert walk(top, 0) >= 3  # Output, Sort, Aggregate, ..., TableScan
    nodes = [s for s in spans if s.name in NODE_TYPES
             and by_id[s.parent_id].name in NODE_TYPES | {"pass"}]
    assert {s.name for s in nodes} >= {"Output", "Sort", "Aggregate",
                                       "TableScan"}
    # the ok-flag fetch comes after the pass, not inside it
    fetches = [s for s in spans if s.name == "fetch"]
    assert {s.attrs["site"] for s in fetches} >= {"result-demux"}
    for f in fetches:
        assert not any(p.t0 <= f.t0 and f.t1 <= p.t1 for p in passes)


@pytest.mark.parametrize("route", ["streamed", "segmented"])
def test_streamed_and_segmented_plans_carry_their_route(port, route,
                                                        monkeypatch):
    if route == "streamed":
        port.session.set("scan_block_rows", 16384)
        sql = "select sum(l_quantity), count(*) from lineitem"
    else:
        monkeypatch.setattr(EX, "AGG_SPLIT_MIN_ROWS", 0)
        sql = QUERIES["q10"]
    _rows, spans = _traced(port, sql)
    (execute,) = [s for s in spans if s.name == "execute"]
    assert execute.attrs["route"] == route == port.last_run.route
    programs = [s for s in spans if s.name == "program"]
    assert len(programs) > 1
    assert len(programs) == len(port.last_run.programs)
    assert all(p.parent_id == execute.span_id for p in programs)
    assert all(p.attrs["passes"] >= 1 for p in programs)


def test_fetch_and_upload_bytes_match_their_counters(port, monkeypatch):
    crossed = {"fetch": [], "upload": []}
    first = {}  # (name, site): the site's registry bytes before its first
    fetch, upload = HS.fetch, HS._upload

    def counting_fetch(tree, site):
        first.setdefault(("fetch", site), HS.SYNCS.bytes.value(site=site))
        out = fetch(tree, site)
        tensors = []

        def walk(a, b):
            if isinstance(a, torch.Tensor):
                tensors.append(b)
            elif isinstance(a, (list, tuple)):
                for x, y in zip(a, b):
                    walk(x, y)
            elif isinstance(a, dict):
                for k in a:
                    walk(a[k], b[k])
        walk(tree, out)
        assert all(isinstance(t, np.ndarray) for t in tensors)
        crossed["fetch"].append((site, sum(t.nbytes for t in tensors)))
        return out

    def counting_upload(array, device, site):
        first.setdefault(("upload", site), HS.UPLOADS.bytes.value(site=site))
        crossed["upload"].append((site, np.asarray(array).nbytes))
        return upload(array, device, site)
    monkeypatch.setattr(HS, "fetch", counting_fetch)
    monkeypatch.setattr(HS, "_upload", counting_upload)
    s0, u0 = HS.SYNCS.bytes_total(), HS.UPLOADS.bytes_total()
    # a fresh engine: the scanned columns go up inside the trace
    _rows, spans = _traced(port, QUERIES["q03"])
    for name, counter, before in (("fetch", HS.SYNCS, s0),
                                  ("upload", HS.UPLOADS, u0)):
        got = [(s.attrs["site"], s.attrs["bytes"]) for s in spans
               if s.name == name]
        assert got == crossed[name]
        assert sum(b for _s, b in got) == counter.bytes_total() - before
        assert sum(b for _s, b in got) > 0
        for site in {s for s, _b in got}:
            assert counter.bytes.value(site=site) - first[name, site] == \
                sum(b for s, b in got if s == site)
    assert {s for s, _b in crossed["upload"]} >= {"scan-column"}
    text = REGISTRY.render()
    assert 'presto_tpu_fetch_bytes_total{site="result-demux"}' in text
    assert 'presto_tpu_upload_bytes_total{site="scan-column"}' in text


def test_byte_counters_by_site():
    c = HS.SyncCounter(Counter("presto_tpu_test_bytes_total", "test"))
    c.inc("a", 10)
    c.inc("a")
    c.inc("b", 5)
    assert c.by_site == {"a": 2, "b": 1} and c.total() == 3
    assert (c.bytes.value(site="a"), c.bytes.value(site="b")) == (10, 5)
    assert c.bytes_total() == 15


def test_shared_uploads_count_no_bytes():
    arr = np.arange(16, dtype=np.int64)
    with HS.shared_uploads():
        HS.upload(arr, "cpu", "literal")
        u0, b0 = HS.UPLOADS.total(), HS.UPLOADS.bytes_total()
        HS.upload(arr, "cpu", "literal")
        assert (HS.UPLOADS.total(), HS.UPLOADS.bytes_total()) == (u0, b0)
    HS.upload(arr, "cpu", "literal")
    assert HS.UPLOADS.bytes_total() - b0 == arr.nbytes


def test_untraced_query_records_nothing(port):
    port.execute(Q1)
    before = OT.TRACER.trace_ids()
    assert OT.current_context() is None
    port.execute(Q1)
    port.execute("select count(*) from nation")
    assert OT.TRACER.trace_ids() == before
    with OT.TRACER.span("orphan") as sp:
        assert sp is None


def test_span_ids_are_unique():
    tracer = OT.Tracer(max_spans=20_000)
    with tracer.trace("t-ids", "root"):
        for _ in range(10_000):
            with tracer.span("s"):
                pass
    ids = [s.span_id for s in tracer.spans("t-ids")]
    assert len(ids) == 10_001 == len(set(ids))
    # the per-process prefix: a second tracer draws from the same
    # sequence, and the ids carry this process's prefix
    other = OT.Tracer()
    with other.trace("t-ids-2", "root") as s:
        assert s.span_id not in set(ids)
        assert s.span_id[:8] == ids[0][:8]


def test_spans_past_the_cap_are_counted():
    dropped = REGISTRY.counter("presto_tpu_trace_spans_dropped_total")
    tracer = OT.Tracer(max_spans=5)
    before = dropped.value()
    with tracer.trace("t-cap", "root"):
        for _ in range(7):
            with tracer.span("s") as sp:
                assert sp is not None  # still the ambient context
    assert len(tracer.spans("t-cap")) == 5
    assert dropped.value() - before == 3
    tracer.import_spans([s.to_dict() for s in tracer.spans("t-cap")][:1])
    assert dropped.value() - before == 4


def test_clock_stamps_spans(monkeypatch):
    ticks = iter([100.0, 100.25, 101.0, 102.5])
    monkeypatch.setattr(OT, "clock", lambda: next(ticks))
    tracer = OT.Tracer()
    with tracer.trace("t-clock", "root"):
        with tracer.span("child"):
            pass
    root, child = tracer.spans("t-clock")
    assert (root.t0, child.t0, child.t1, root.t1) == (100.0, 100.25,
                                                       101.0, 102.5)
