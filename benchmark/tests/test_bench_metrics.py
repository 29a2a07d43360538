"""The metric arithmetic, on a small recorded trace and on hand-made
runs."""

from __future__ import annotations

import json

import numpy as np
import pytest

import run as R
from conftest import BENCH
from harness import cell as C
from harness import record


def _fixture():
    return json.loads((BENCH / "tests" / "trace_fixture.json").read_text())


def test_busy_idle_and_breakdown():
    f = _fixture()
    names = [a[0] for a in f["activity"]]
    starts = np.array([a[1] for a in f["activity"]])
    ends = np.array([a[2] for a in f["activity"]])
    t0, t1 = f["window"]
    busy, g0, g1 = record.busy_and_gaps(starts, ends, t0, t1)
    assert busy == pytest.approx(f["expect"]["busy_s"])
    assert (g1 - g0).sum() == pytest.approx(1.0 - f["expect"]["busy_s"])
    gaps = dict(record.label_gaps(g0, g1, [tuple(q) for q in f["queries"]],
                                  [tuple(p) for p in f["plans"]]))
    want = {k: v for k, v in f["expect"]["idle_gaps"].items() if v}
    assert gaps.keys() == want.keys()
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v)
    ops = dict(record.top_ops(names, starts, ends, t0, t1))
    assert ops == pytest.approx(f["expect"]["device_ops"])


def _run(**trace):
    tr = None
    if trace:
        fields = dict(queries=20, plan_s=0.3, syncs=90, launch_bytes=6.7e9,
                      launch_s=0.01, hbm_bytes_per_s=3.35e12, busy_s=2.5,
                      window_s=10.0, device_ops=[], idle_gaps=[])
        fields.update(trace)
        tr = R.Trace(**fields)
    return R.Run(setup_s=41.5, window_s=20.0, latencies=[
        0.01 * k for k in range(1, 101)], completed=100,
        peak_window_bytes=3 * 2 ** 30, trace=tr)


def test_end_to_end_readers():
    run = _run()
    assert C.reader("queries_per_s")(run) == pytest.approx(5.0)
    assert C.reader("latency_p95_s")(run) == pytest.approx(0.95)
    assert C.reader("peak_mem_gib")(run) == pytest.approx(3.0)
    assert C.reader("setup_s")(run) == pytest.approx(41.5)


def test_per_layer_readers():
    run = _run(queries=20)
    assert C.reader("plan_ms")(run) == pytest.approx(15.0)
    assert C.reader("host_syncs_per_query")(run) == pytest.approx(4.5)
    # 6.7e9 bytes at 3.35e12 B/s is 2 ms, over 10 ms of launches
    assert C.reader("kernel_roofline_pct")(run) == pytest.approx(20.0)
    assert C.reader("device_idle_pct")(run) == pytest.approx(75.0)


def test_readers_with_nothing_to_read():
    assert C.reader("plan_ms")(_run()) is None
    assert C.reader("kernel_roofline_pct")(_run(launch_s=0.0)) is None
    assert C.reader("kernel_roofline_pct")(_run(hbm_bytes_per_s=None)) is None
    assert C.reader("device_idle_pct")(_run(busy_s=None)) is None
    off_card = _run()
    off_card.peak_window_bytes = None
    assert C.reader("peak_mem_gib")(off_card) is None


def test_split_takes_the_harness_out_of_the_trace():
    """Two marked launches on stream 7: each entry's seconds are its own
    activities summed (the gap between them does not count); the
    markers and the harness's byte counts are not the program's; a
    copy on stream 9 and the work between launches are."""
    M = record.MARK
    trace = [  # name, start, end, stream
        ("before", 0.0, 1.0, 7),
        (M, 1.0, 1.1, 7), ("seg_sum_reg", 1.2, 1.5, 7),
        ("direct_copy", 2.0, 2.25, 7), (M, 2.3, 2.4, 7),
        ("reduce_kernel", 2.4, 2.6, 7), (M, 2.6, 2.7, 7),
        ("Memcpy DtoH", 2.5, 3.5, 9),
        ("between", 3.0, 3.2, 7),
        (M, 4.0, 4.1, 7), ("build_table_kernel", 4.1, 4.6, 7),
        (M, 4.6, 4.7, 7), (M, 4.7, 4.8, 7),
    ]
    names = [t[0] for t in trace]
    starts = np.array([t[1] for t in trace])
    ends = np.array([t[2] for t in trace])
    streams = [t[3] for t in trace]
    keep, seconds = record.split(names, starts, ends, streams, 2)
    assert [n for n, k in zip(names, keep) if k] == [
        "before", "seg_sum_reg", "direct_copy", "Memcpy DtoH", "between",
        "build_table_kernel"]
    assert seconds == pytest.approx([0.55, 0.5])
    # a marker missing, or markers on two streams: no launch is timed
    assert record.split(names[:-1], starts[:-1], ends[:-1], streams[:-1],
                        2)[1] is None
    assert record.split(names, starts, ends, streams[:-1] + [9], 2)[1] \
        is None
