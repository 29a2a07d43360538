"""A traced run of one cell, with what the port's own spans say about it.

    python3 benchmark/spanreport.py --workload tpch-sf10.power --seed 7 \
        --seconds 51

The same run as ``run.py --trace 1`` (its lines and its result line),
with every query's spans kept (``harness/spans.py``) and these lines
added on standard error:

- the window's queries per second, traced;
- spans a query, spans dropped, the share of ``program`` spans that
  found the program cache's entry, extra passes a query;
- the device's copies (``Memcpy DtoH``, ``Memcpy HtoD``) in the window
  by the ``fetch`` or ``upload`` span open over each, by site, and
  outside every such span;
- the device clock less the spans' clock (``obs/trace.clock``) at an
  alignment kernel on the idle device at each end of the window, and
  their difference: the drift the alignment at the start leaves;
- idle seconds inside ``execute``, and the share named by a span below
  it; idle seconds by the innermost span open over each gap (the
  result line's ``breakdown.idle_gaps`` too);
- host self seconds by span: each span less its children;
- ``execute`` spans by query and the ``route`` the executor took
  (whole, segmented, streamed, ...).

The result line also carries these numbers under ``spans``. The
benchmark's runs never run this command.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run as R  # noqa: E402
from harness import record  # noqa: E402
from harness import spans as S  # noqa: E402


class Capture:
    """What the hooks saw of one run, and its report."""

    def __init__(self):
        self.traces: list = []  # every query's spans, in order
        self.dtrace = None
        self.activity = None  # the program's (names, starts, ends, t0, t1)
        self.named = None  # idle seconds by label, every label
        self.names = None  # the window's queries' names, in order

    def install(self) -> None:
        """Put the hooks into ``harness.record`` (until uninstall)."""
        cap = self
        self._saved = (record.Spans, record.DeviceTrace, record.top_ops,
                       record.label_gaps)

        class KeepSpans(record.Spans):
            def around(self, run):
                try:
                    return super().around(run)
                finally:
                    # the query's trace is the newest in the store
                    tr = self.tracer
                    ids = (tr.trace_ids() if hasattr(tr, "trace_ids")
                           else list(tr._traces))
                    cap.traces.append(tr.spans(ids[-1]) if ids else [])

        class TwoEnds(record.DeviceTrace):
            """Aligned on the spans' clock, with a second alignment
            kernel after the window, measured and then left out."""

            def __enter__(self):
                import torch
                from torch.profiler import ProfilerActivity, profile

                from presto_tpu_torch.obs import trace
                self.clock = getattr(trace, "clock", time.time)
                self.t_end_ns = self.offsets_ns = None
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                torch.cuda.synchronize(self.device)
                self.t_host_ns = round(self.clock() * 1e9)
                torch.zeros(1, device=self.device)
                cap.dtrace = self
                return self

            def __exit__(self, *exc):
                import torch
                torch.cuda.synchronize(self.device)
                self.t_end_ns = round(self.clock() * 1e9)
                torch.zeros(1, device=self.device)
                return super().__exit__(*exc)

            def activity(self):
                import torch
                names, starts, ends, streams = super().activity()
                if self.t_end_ns is not None and len(names) > 1 \
                        and names[-1] == names[0]:
                    first = min(
                        e.start_ns()
                        for e in self.prof.profiler.kineto_results.events()
                        if e.device_type() == torch.autograd.DeviceType.CUDA)
                    shift = self.t_host_ns - first
                    self.offsets_ns = (
                        -shift, starts[-1] * 1e9 - shift - self.t_end_ns)
                    names, starts, ends = names[:-1], starts[:-1], ends[:-1]
                    streams = streams[:-1]
                return names, starts, ends, streams

        top_ops, label_gaps = record.top_ops, record.label_gaps

        def keep_ops(names, starts, ends, t0, t1):
            cap.activity = (names, starts, ends, t0, t1)
            return top_ops(names, starts, ends, t0, t1)

        def by_span(g0, g1, queries, plans):
            cap.names = [q[0] for q in queries]
            if not cap.traces:
                return label_gaps(g0, g1, queries, plans)
            cap.named = S.label_gaps(g0, g1, queries, plans,
                                     S.below_execute(cap.traces))
            return cap.named[:10]

        record.Spans, record.DeviceTrace = KeepSpans, TwoEnds
        record.top_ops, record.label_gaps = keep_ops, by_span

    def uninstall(self) -> None:
        (record.Spans, record.DeviceTrace, record.top_ops,
         record.label_gaps) = self._saved

    def report(self, out: dict) -> tuple[list[str], dict]:
        t = S.totals(self.traces)
        n = max(t["queries"], 1)
        nums: dict = {"queries": t["queries"],
                      "spans_per_query": t["spans"] / n,
                      "spans_dropped": S.dropped(),
                      "cache_hit_share": (t["cache_hits"] / t["programs"]
                                          if t["programs"] else None),
                      "extra_passes_per_query": t["extra_passes"] / n}
        dev = out.get("device", {})
        if dev.get("window_s"):
            nums["queries_per_s"] = out["attempted"] / dev["window_s"]
        lines = [f"traced: {nums.get('queries_per_s', 0):.4f} queries/s; "
                 f"{nums['spans_per_query']:.1f} spans a query, "
                 f"{nums['spans_dropped']} dropped; program spans "
                 f"{t['programs']}, cache hits "
                 f"{t['cache_hits'] / max(t['programs'], 1):.1%}, extra "
                 f"passes {nums['extra_passes_per_query']:.3f} a query"]
        if self.activity is not None:
            names, starts, ends, t0, t1 = self.activity
            for kind, name in (("Memcpy DtoH", "fetch"),
                               ("Memcpy HtoD", "upload")):
                sp = [(S.span_label(s), s.t0, s.t1) for q in self.traces
                      for s in q if s.name == name and s.t1 is not None]
                by = S.copies_by_span(names, starts, ends, kind, sp, t0, t1)
                nums[f"{name}_copy_s"] = by
                lines.append(f"{kind} seconds by {name} span: " + (", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(
                        by.items(), key=lambda kv: -kv[1])) or "none"))
        d = self.dtrace
        if d is not None and d.offsets_ns is not None:
            a, b = d.offsets_ns
            nums["clock_offset_us"] = [a / 1e3, b / 1e3, (b - a) / 1e3]
            lines.append(f"clock offset, device less host, us: start "
                         f"{a / 1e3:.1f}, end {b / 1e3:.1f}, drift over "
                         f"the window {(b - a) / 1e3:.1f}")
        named = self.named
        if named is not None:
            phase = [(k.split(" ", 2)[1:], v) for k, v in named]
            inside = sum(v for p, v in phase if p and p[0] == "execute")
            below = sum(v for p, v in phase
                        if len(p) == 2 and p[0] == "execute")
            nums["idle_execute_s"] = [inside, below]
            nums["idle_by_span"] = named[:30]
            lines.append(f"idle seconds inside execute {inside:.4f}, named "
                         f"by a span below it {below:.4f} ("
                         f"{below / inside if inside else 0:.1%})")
            lines.append("idle seconds by span: " + ", ".join(
                f"{k} {v:.4f}" for k, v in named[:30]))
        routes = S.routes(self.traces, self.names)
        nums["routes"] = routes
        lines.append("execute spans by query and route: " + ", ".join(
            f"{k} {v}" for k, v in sorted(routes.items())))
        own = sorted(S.self_by_label(self.traces).items(),
                     key=lambda kv: -kv[1])[:25]
        nums["self_s_by_span"] = own
        lines.append("host self seconds by span: " + ", ".join(
            f"{k} {v:.4f}" for k, v in own))
        return lines, nums


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    cap = Capture()
    cap.install()
    plain = R.run

    def run(*args, **kw):
        out, lines = plain(*args, **kw)
        extra, nums = cap.report(out)
        out["spans"] = nums
        return out, lines + extra
    R.run = run
    return R.main(argv)


if __name__ == "__main__":
    sys.exit(main())
