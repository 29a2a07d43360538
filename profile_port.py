"""Where the time of a presto_tpu_torch query goes on the GPU.

    python3 profile_port.py [--scale 10] [--queries q03,q09]
                            [--backend cuda] [--top 25] [--host]

Generates TPC-H with the port's connector, runs each query once to
upload its columns, then once more under ``torch.profiler`` (CPU and
CUDA activities), and prints the query's wall time, the device-busy
sum and the top operators by device time and by host time (with
``--host``, a third run under cProfile: the host functions by
cumulative time, Python outside torch ops included). Prints the
card's ``nvidia-smi`` name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from chip_smoke import QUERIES


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--queries", default="q03,q09")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--host", action="store_true",
                    help="also run each query under cProfile and print "
                    "the host functions by cumulative time")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpch import TpchConnector

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    engine = Engine()
    engine.register_catalog("tpch", TpchConnector(scale=args.scale,
                                                  seed=args.seed))
    engine.session.set("kernel_backend", args.backend)
    for q in args.queries.split(","):
        engine.execute(QUERIES[q])  # uploads the scan columns
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.execute(QUERIES[q])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        events = prof.key_averages()
        # the kernels' own rows: an aten op's row repeats the time of
        # the kernels it launched
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        print(f"\n== {q} sf={args.scale:g} backend={args.backend}: wall "
              f"{wall:.3f} s, device busy {device_us / 1e6:.3f} s",
              flush=True)
        print(events.table(sort_by="self_device_time_total",
                           row_limit=args.top, max_name_column_width=60),
              flush=True)
        print(events.table(sort_by="self_cpu_time_total",
                           row_limit=args.top, max_name_column_width=60),
              flush=True)
        if args.host:
            import cProfile
            import pstats
            host = cProfile.Profile()
            host.enable()
            engine.execute(QUERIES[q])
            torch.cuda.synchronize()
            host.disable()
            print(f"\n== {q} host (cProfile, cumulative)", flush=True)
            pstats.Stats(host, stream=sys.stdout).sort_stats(
                "cumulative").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
