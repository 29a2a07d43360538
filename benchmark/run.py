"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload tpch-sf10.power --seed 7 \
        --seconds 30 --trace 0

In order: set-up (the cell's data from ``--seed``, the port's engine
over it, each of the cell's queries once), a closed loop of one client
for ``--seconds`` seconds, the comparison of the answers with the plain
reference, and the result as the last line of standard output (one
JSON object). With ``--trace 1`` the window runs under the recorders of
``harness/record.py`` and the line carries the per-layer metrics, else
the end-to-end ones. Without a CUDA device the command exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
# every build and kernel cache of the program, at fixed paths inside
# the checkout: only the first run of a cell there builds
CACHES = {"TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
          "TRITON_CACHE_DIR": "build/benchmark/triton"}
# the port's persistent program store stays off: it keeps an entry for
# each set of literals a run meets, so a run would start from what every
# earlier run in the checkout left there, and a cell's runs would not be
# alike. Each run climbs its own capacity rungs, in set-up and window.
NO_STORE = "PRESTO_TPU_PROGRAM_CACHE_DIR"
FORBIDDEN = {"jax", "jaxlib", "flax", "presto_tpu"}
COMPARE_PER_QUERY = 2  # sets of literals compared for each query name


def started() -> float:
    """This process's start on the monotonic clock (its start time in
    /proc, in clock ticks since boot), or now where /proc lacks it."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
        ticks = int(fields.split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        age = boot - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = started()


@dataclasses.dataclass
class Query:
    name: str
    params: dict
    t0: float  # monotonic
    t1: float
    wall0: float  # epoch
    wall1: float
    rows: list | None
    error: str | None


@dataclasses.dataclass
class Trace:
    queries: int
    plan_s: float
    syncs: int
    launch_bytes: int
    launch_s: float
    hbm_bytes_per_s: float | None
    busy_s: float | None  # None where no device was traced
    window_s: float
    device_ops: list
    idle_gaps: list


@dataclasses.dataclass
class Run:
    setup_s: float
    window_s: float
    latencies: list
    completed: int
    peak_window_bytes: int | None  # None off the card
    trace: Trace | None


def closed_loop(engine, stream, seconds: float, around) -> list[Query]:
    """One client: the next query as soon as the last one's rows are
    back, from the stream's position 0, until ``seconds`` have passed;
    the query under way then runs to its end."""
    out = []
    start = time.monotonic()
    while time.monotonic() - start < seconds:
        name, params, sql = stream.query(len(out))
        w0, t0 = time.time(), time.monotonic()
        try:
            rows, error = around(lambda: engine.execute(sql)), None
        except Exception as exc:  # a failed query counts, the run goes on
            rows, error = None, f"{type(exc).__name__}: {exc}"
        out.append(Query(name, params, t0, time.monotonic(), w0,
                         time.time(), rows, error))
    return out


def judge(cell, data, queries: list[Query], seed: int, device,
          control: str | None = None) -> dict:
    """Compare the answers with the reference: per query, the literals
    of its slowest run and more drawn from the seed, up to
    ``COMPARE_PER_QUERY``; every answer given with those literals.
    With ``control`` ("float64", "float32") each of those answers is
    replaced by the reference computed in that precision: the control
    that the comparison has to fail (control.py)."""
    import numpy as np

    from harness import judge as J
    from reference.common import Tables

    def key(q):
        return json.dumps(q.params, sort_keys=True)
    by_name: dict = {}
    for q in queries:
        if q.rows is not None:
            by_name.setdefault(q.name, {}).setdefault(key(q), []).append(q)
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    tables = Tables(data, device)
    low = Tables(data, device, control) if control else None
    wrong = compared = 0
    worst: list = []
    for name in sorted(by_name):
        groups = by_name[name]
        slowest = key(max((q for g in groups.values() for q in g),
                          key=lambda q: q.t1 - q.t0))
        rest = sorted(k for k in groups if k != slowest)
        rng.shuffle(rest)
        ref = cell.references[name]
        for k in [slowest] + rest[:COMPARE_PER_QUERY - 1]:
            want = J.reference_rows(ref, tables, json.loads(k))
            lowered = (J.reference_rows(ref, low, json.loads(k))
                       if low is not None else None)
            for q in groups[k]:
                got = (lowered if lowered is not None
                       else J.rows_of(ref, q.rows))
                bad = J.mismatches(ref, got, want)
                compared += 1
                wrong += bad
                if bad and len(worst) < 3:
                    worst.append(f"{name} {k}: {bad} rows differ")
    return {"mismatched_rows": wrong, "answers_compared": compared,
            "notes": worst}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, scale: float | None = None) -> tuple[dict, list]:
    """One run of the cell: (the result's fields, the lines of its
    comparison). ``device`` and ``scale`` exist for the tests, which
    drive a run on the CPU at a small scale."""
    import torch

    from harness import cell as C
    from harness import program, record, roofline, traffic
    from presto_tpu_torch.exec import hostsync

    cell = C.load(CHECKOUT, BENCH, workload)
    config = dict(cell.config)
    if scale is not None:
        config["scale"] = scale
    steps = [("start", time.monotonic() - T_START)]
    data, gen = program.generate(config, seed)
    steps.append(("data", time.monotonic() - T_START))
    engine = program.engine(config, data, gen, device=device)
    steps.append(("engine", time.monotonic() - T_START))
    dev = engine.device
    on_card = dev.type == "cuda"
    stream = traffic.Stream(cell.mix, cell.references, seed)
    for _name, _params, sql in stream.warm():
        engine.execute(sql)
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - T_START
    steps.append(("warm", setup_s))

    around = (lambda f: f())
    launches = spans = dtrace = None
    if trace:
        launches = record.Launches(dev).__enter__()
        spans = record.Spans()
        around = spans.around
        if on_card:
            dtrace = record.DeviceTrace(dev).__enter__()
        syncs0 = hostsync.SYNCS.total()
    w0 = time.time()
    try:
        queries = closed_loop(engine, stream, seconds, around)
    finally:
        if dtrace is not None:
            dtrace.__exit__(None, None, None)
        if launches is not None:
            launches.__exit__(None, None, None)
    w1 = queries[-1].wall1 if queries else time.time()
    done = [q for q in queries if q.error is None]
    window_s = queries[-1].t1 - queries[0].t0 if queries else 0.0
    peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    memory_peak = max(setup_peak, peak_window) if on_card else 0

    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    tr = None
    if trace:
        syncs = hostsync.SYNCS.total() - syncs0
        busy = None
        ops = gaps = []
        launch_s = 0.0
        if dtrace is not None:
            names, starts, ends, streams = dtrace.activity()
            # the program's activity alone: the harness's markers and
            # byte counts are taken out of every device number
            keep, per_launch = record.split(names, starts, ends, streams,
                                            len(launches.names))
            names = [n for n, k in zip(names, keep) if k]
            starts, ends = starts[keep], ends[keep]
            busy, g0, g1 = record.busy_and_gaps(starts, ends, w0, w1)
            ops = record.top_ops(names, starts, ends, w0, w1)
            gaps = record.label_gaps(
                g0, g1, [(q.name, q.wall0, q.wall1) for q in queries],
                spans.plans)
            if per_launch is not None:
                per_launch[launches.failed] = 0.0
                launch_s = float(per_launch.sum())
        tr = Trace(queries=len(queries), plan_s=spans.plan_s, syncs=syncs,
                   launch_bytes=sum(launches.bytes().values()),
                   launch_s=launch_s,
                   hbm_bytes_per_s=roofline.peak(name, "hbm_bytes_per_s"),
                   busy_s=busy, window_s=w1 - w0, device_ops=ops,
                   idle_gaps=gaps)

    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = judge(cell, data, done, seed, dev)
    failed = len(queries) - len(done)
    result = Run(setup_s, window_s, [q.t1 - q.t0 for q in done], len(done),
                 peak_window if on_card else None, tr)

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = C.reader(m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": failed == 0 and verdict["mismatched_rows"] == 0
           and verdict["answers_compared"] > 0,
           "attempted": len(queries), "failed": failed,
           "metrics": metrics, "device": device_info}
    if tr is not None and tr.busy_s is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    if on_card:
        out["card"] = card()
    out["checks"] = {
        "mismatched_rows": {"value": verdict["mismatched_rows"],
                            "limit": 0},
        "failed_queries": {"value": failed, "limit": 0},
        "answers_compared": {"value": verdict["answers_compared"],
                             "limit": 1, "at_least": True}}
    lines = [q.error for q in queries if q.error][:3] + verdict["notes"]
    lines.append("set-up, seconds since the process started: " + ", ".join(
        f"{k} {v:.2f}" for k, v in steps))
    by_name: dict = {}
    for q in done:
        by_name.setdefault(q.name, []).append(q.t1 - q.t0)
    lines.append("median seconds by query: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.4f} ({len(v)})"
        for n, v in sorted(by_name.items())))
    lines += [f"check {k} {v['value']} limit {v['limit']}"
              + (" (at least)" if v.get("at_least") else "")
              for k, v in out["checks"].items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)
    os.environ.pop(NO_STORE, None)
    sys.path[:0] = [str(BENCH), str(CHECKOUT)]
    import torch
    from harness import cell as C

    chips = C.load(CHECKOUT, BENCH, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, lines = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"modules that must not load here were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
