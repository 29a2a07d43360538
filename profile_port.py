"""Where the time of a presto_tpu_torch query goes on the GPU.

    python3 profile_port.py [--scale 10] [--queries q03,q09]
                            [--suite tpch] [--backend cuda] [--top 25]
                            [--host] [--kernels]

Generates TPC-H (``--suite tpch``: the texts of chip_smoke.QUERIES)
or TPC-DS (``--suite tpcds``: tests/test_tpcds.py's texts over the
port's TPC-DS connector, seed 20030527 unless ``--seed`` names one)
with the port's connector, runs each query once to
upload its columns, then once more under ``torch.profiler`` (CPU and
CUDA activities), and prints the query's wall time, the device-busy
sum and the top operators by device time and by host time (with
``--host``, a third run under cProfile: the host functions by
cumulative time, Python outside torch ops included). With
``--kernels`` it prints, instead of the operator tables, the device
time of each hand-written kernel (summed over its CUDA functions, by
name) with its wrapper's launch count, per query and summed over the
queries it ran (a ``kernel_share`` JSON line). Prints the card's
``nvidia-smi`` name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

from chip_smoke import QUERIES, TPCDS_SEED, tpcds_queries

# the CUDA functions of each wrapper (kernels/csrc/*.cu, all in an
# anonymous namespace; a template's arguments follow its name);
# segment_cmp's carry kMax as their last template argument
_KERNEL_FUNCTIONS = {
    "seg_sum_reg": "segment_sum", "seg_sum_lanes": "segment_sum",
    "seg_sum_shared": "segment_sum",
    "seg_sum_global": "segment_sum", "seg_cmp_reg": "segment_cmp",
    "seg_cmp_lanes": "segment_cmp",
    "seg_cmp_shared": "segment_cmp", "seg_cmp_global": "segment_cmp",
    "build_table_kernel": "build_table", "part_count_kernel": "build_table",
    "part_scatter_kernel": "build_table", "build_part_kernel": "build_table",
    "probe_table_kernel": "probe_table",
    "multijoin_walk_kernel": "multijoin_walk",
    "compact_kernel": "filter_compact",
    "zero_tail_kernel": "filter_compact",
    # the first design's functions, so that this script still charges
    # them when it profiles an older checkout's package
    "seg_cmp_one": "segment_cmp", "count_kernel": "filter_compact",
    "scan_kernel": "filter_compact", "scatter_kernel": "filter_compact"}
_FUNCTION = re.compile(r"\(anonymous namespace\)::(\w+)")


def kernel_of(event_name: str) -> str | None:
    """The wrapper a profiled CUDA function belongs to, or None."""
    m = _FUNCTION.search(event_name)
    wrapper = _KERNEL_FUNCTIONS.get(m.group(1)) if m else None
    if wrapper == "segment_cmp":
        return "segment_max" if "true>" in event_name else "segment_min"
    return wrapper


def kernel_share(events, launches: dict) -> dict:
    """Per wrapper: device ms, CUDA function launches, wrapper
    launches, and device ms per CUDA function."""
    from torch.autograd import DeviceType
    out = {name: {"ms": 0.0, "device_launches": 0, "launches": n,
                  "functions": {}}
           for name, n in launches.items()}
    for e in events:
        name = kernel_of(e.key) if e.device_type == DeviceType.CUDA \
            else None
        if name is not None:
            ms = e.self_device_time_total / 1e3
            fn = _FUNCTION.search(e.key).group(1)
            out[name]["ms"] += ms
            out[name]["device_launches"] += e.count
            out[name]["functions"][fn] = \
                out[name]["functions"].get(fn, 0.0) + ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="the generator's seed (19920101 for tpch, "
                    f"{TPCDS_SEED} for tpcds)")
    ap.add_argument("--suite", default="tpch", choices=("tpch", "tpcds"))
    ap.add_argument("--queries", default="q03,q09")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--host", action="store_true",
                    help="also run each query under cProfile and print "
                    "the host functions by cumulative time")
    ap.add_argument("--kernels", action="store_true",
                    help="print each hand-written kernel's device time "
                    "and launches per query and over all the queries, "
                    "instead of the operator tables")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.kernels import build as B

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    engine = Engine()
    if args.suite == "tpcds":
        queries = tpcds_queries()
        engine.register_catalog("tpcds", TpcdsConnector(
            scale=args.scale,
            seed=TPCDS_SEED if args.seed is None else args.seed))
        engine.session.catalog = "tpcds"
    else:
        queries = QUERIES
        engine.register_catalog("tpch", TpchConnector(
            scale=args.scale,
            seed=19920101 if args.seed is None else args.seed))
    engine.session.set("kernel_backend", args.backend)
    total: dict = {}
    for q in args.queries.split(","):
        engine.execute(queries[q])  # uploads the scan columns
        torch.cuda.synchronize()
        B.LAUNCHES.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.execute(queries[q])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = B.LAUNCHES.snapshot()
        events = prof.key_averages()
        # the kernels' own rows: an aten op's row repeats the time of
        # the kernels it launched
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        print(f"\n== {q} sf={args.scale:g} backend={args.backend}: wall "
              f"{wall:.3f} s, device busy {device_us / 1e6:.3f} s",
              flush=True)
        if args.kernels:
            share = kernel_share(events, launches)
            for name, row in share.items():
                acc = total.setdefault(name, {"ms": 0.0,
                                              "device_launches": 0,
                                              "launches": 0,
                                              "functions": {}})
                for key in ("ms", "device_launches", "launches"):
                    acc[key] += row[key]
                for fn, ms in row["functions"].items():
                    acc["functions"][fn] = acc["functions"].get(fn, 0.0) + ms
            print("kernels " + json.dumps({"query": q, "wall_s": wall,
                                           "device_s": device_us / 1e6,
                                           "kernels": share}), flush=True)
        else:
            print(events.table(sort_by="self_device_time_total",
                               row_limit=args.top,
                               max_name_column_width=60), flush=True)
            print(events.table(sort_by="self_cpu_time_total",
                               row_limit=args.top,
                               max_name_column_width=60), flush=True)
        if args.host:
            import cProfile
            import pstats
            host = cProfile.Profile()
            host.enable()
            engine.execute(queries[q])
            torch.cuda.synchronize()
            host.disable()
            print(f"\n== {q} host (cProfile, cumulative)", flush=True)
            pstats.Stats(host, stream=sys.stdout).sort_stats(
                "cumulative").print_stats(args.top)
    if args.kernels:
        print("kernel_share " + json.dumps({"queries": args.queries,
                                            "kernels": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
