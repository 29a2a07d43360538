"""What a traced run records around the window: the port's kernel
launches, its spans, its host syncs and the device's activity.

- :class:`Launches` wraps every entry of ``kernels.KERNELS`` (both
  backends) for the window and counts the bytes each launch needs
  (``roofline.BYTES``), summed on the device. On the card it brackets
  each launch with empty marker kernels on the stream, so that the
  profiler's trace tells the entry's own device work from the
  harness's count and from the rest of the program (:func:`split`).
- :class:`Spans` opens one trace of the port's tracer around each
  query, so the engine's own ``plan`` spans land in it.
- :class:`DeviceTrace` runs ``torch.profiler`` over the window, CUDA
  activity only, and reduces it to busy time, time by kernel name and
  idle gaps by what the host was doing.
"""

from __future__ import annotations

import collections
import time
import uuid

import numpy as np
import torch

from harness import roofline

# the kernel of torch.cuda._sleep, which the port never launches: with
# 0 cycles an empty kernel, the harness's marker on the stream
MARK = "spin_kernel"


def mark() -> None:
    torch.cuda._sleep(0)


class Launches:
    """Per launch of a kernel entry in the window: its name, and the
    bytes it needs. On the card the stream carries, for each launch in
    order, a marker before the entry, one after it and one after the
    harness's count of its bytes."""

    def __init__(self, device):
        from presto_tpu_torch import kernels as K
        self._kernels = K.KERNELS
        self.device = torch.device(device)
        self.marks = self.device.type == "cuda"
        self.names: list[str] = []  # every launch, in order
        self.failed: list[int] = []  # launches that raised
        self.count: collections.Counter = collections.Counter()
        self.host_bytes: collections.Counter = collections.Counter()
        self.dev_bytes: dict = {}
        self._saved: dict = {}

    def __enter__(self):
        for name, impls in self._kernels.items():
            for backend, fn in list(impls.items()):
                self._saved[(name, backend)] = fn
                impls[backend] = self._wrap(name, fn)
        return self

    def __exit__(self, *exc):
        for (name, backend), fn in self._saved.items():
            self._kernels[name][backend] = fn
        self._saved.clear()

    def _wrap(self, name, fn):
        count = roofline.BYTES[name]

        def entry(*args):
            index = len(self.names)
            self.names.append(name)
            ok = False
            try:
                if self.marks:
                    mark()
                out = fn(*args)
                ok = True
            finally:  # a launch that raises still gets its three marks
                if self.marks:
                    mark()
                if not ok:
                    self.failed.append(index)
                    if self.marks:
                        mark()
            host, dev = count(out, *args)
            if self.marks:
                mark()
            self.count[name] += 1
            self.host_bytes[name] += int(host)
            self.dev_bytes[name] = (dev if name not in self.dev_bytes
                                    else self.dev_bytes[name] + dev)
            return out
        return entry

    def bytes(self) -> dict[str, int]:
        """Bytes needed by kernel entry, summed over its launches."""
        return {n: self.host_bytes[n] + int(self.dev_bytes[n])
                for n in self.count}


def split(names, starts, ends, streams, launches: int):
    """Tell the harness's device work from the program's in a trace of
    a window that :class:`Launches` marked: (which activities are the
    program's, the device seconds of each launch or None).

    On the marked stream, in order, a launch ``k`` is marker, the
    entry's work, marker, the harness's count, marker: the entry's
    seconds are the sum of its activities (gaps between them, where the
    device waited for the host, do not count), and the markers and the
    count are not the program's. Without exactly three markers a
    launch on one stream the launches' seconds are not read (None)."""
    is_mark = np.array([MARK in n for n in names], dtype=bool)
    keep = ~is_mark
    streams = np.asarray(streams)
    marked = set(streams[is_mark].tolist())
    if len(marked) != 1 or int(is_mark.sum()) != 3 * launches:
        return keep, None
    on = np.flatnonzero(streams == marked.pop())
    on = on[np.argsort(starts[on], kind="stable")]
    m = is_mark[on]
    seen = np.cumsum(m)
    entry = ~m & (seen % 3 == 1)
    counting = ~m & (seen % 3 == 2)
    keep[on[counting]] = False
    seconds = np.bincount(seen[entry] // 3,
                          weights=(ends - starts)[on[entry]],
                          minlength=launches)
    return keep, seconds


class Spans:
    """One tracer trace a query: the port's ``plan`` spans land in it."""

    def __init__(self):
        from presto_tpu_torch.obs.trace import TRACER
        self.tracer = TRACER
        self.plan_s = 0.0
        self.plans: list = []  # (t0, t1) of every plan span, epoch s

    def around(self, run):
        tid = "bench-" + uuid.uuid4().hex
        with self.tracer.trace(tid, "bench-query"):
            out = run()
        for s in self.tracer.spans(tid):
            if s.name == "plan" and s.t1 is not None:
                self.plan_s += s.t1 - s.t0
                self.plans.append((s.t0, s.t1))
        return out


class DeviceTrace:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t_host_ns = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a marker kernel on an idle device: its start in the trace is
        # this host time, which aligns the two clocks
        torch.cuda.synchronize(self.device)
        self.t_host_ns = time.time_ns()
        torch.zeros(1, device=self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)

    def activity(self):
        """(names, starts, ends, streams) of every device activity,
        host epoch seconds, sorted by start."""
        names, starts, ends, streams = [], [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
            streams.append(e.device_resource_id())
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], ends[order]
        names = [names[i] for i in order]
        streams = np.asarray(streams, dtype=np.int64)[order]
        shift = (self.t_host_ns - starts[0]) if len(starts) else 0
        return (names, (starts + shift) / 1e9, (ends + shift) / 1e9,
                streams)


def busy_and_gaps(starts, ends, t0: float, t1: float):
    """The union of [starts, ends) within [t0, t1]: (busy seconds, the
    idle gaps as (start, end) arrays)."""
    s = np.clip(starts, t0, t1)
    e = np.clip(ends, t0, t1)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return 0.0, np.array([t0]), np.array([t1])
    reach = np.maximum.accumulate(e)
    gap_start = np.concatenate([[t0], reach])
    gap_end = np.concatenate([s, [t1]])
    gap = gap_end > gap_start
    idle = float((gap_end - gap_start)[gap].sum())
    return (t1 - t0) - idle, gap_start[gap], gap_end[gap]


def label_gaps(gap_start, gap_end, queries, plans) -> list:
    """Idle seconds summed by what the host was doing at each gap's
    middle: ``<query> plan``, ``<query> execute`` or ``client``.
    ``queries`` are (name, t0, t1), ``plans`` (t0, t1), epoch s."""
    q_t0 = np.array([q[1] for q in queries])
    p = np.array(sorted(plans)) if plans else np.zeros((0, 2))
    out: collections.Counter = collections.Counter()
    for a, b in zip(gap_start, gap_end):
        mid = (a + b) / 2
        i = int(np.searchsorted(q_t0, mid, side="right")) - 1
        if i < 0 or mid > queries[i][2]:
            out["client"] += b - a
            continue
        j = int(np.searchsorted(p[:, 0], mid, side="right")) - 1 \
            if len(p) else -1
        phase = "plan" if j >= 0 and mid <= p[j, 1] else "execute"
        out[f"{queries[i][0]} {phase}"] += b - a
    return [[k, float(v)] for k, v in out.most_common(10)]


def top_ops(names, starts, ends, t0: float, t1: float) -> list:
    """Device seconds by operation name within [t0, t1], the ten
    largest."""
    out: collections.Counter = collections.Counter()
    s = np.clip(starts, t0, t1)
    e = np.clip(ends, t0, t1)
    for n, d in zip(names, (e - s).tolist()):
        if d > 0:
            out[n] += d
    return [[k, float(v)] for k, v in out.most_common(10)]
