"""Read the comparison's two ends on the card: the program's number on
sound runs and the control's, for the seeds given, in one process.

    python3 benchmark/control.py --workload tpch-sf10.power \
        --seeds 11,12,13 --seconds 15

Per seed: the cell's set-up and a window at its own load, as a run
makes them; then ``mismatched_rows`` of the program's answers, and of
the same answers replaced by the reference computed in float64 and in
float32 (the decimal arithmetic's nearest lower precisions). One JSON
line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import run as R


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(R.BENCH), str(R.CHECKOUT)]
    import torch

    from harness import cell as C
    from harness import program, traffic
    cell = C.load(R.CHECKOUT, R.BENCH, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        data, gen = program.generate(cell.config, seed)
        engine = program.engine(cell.config, data, gen)
        stream = traffic.Stream(cell.mix, cell.references, seed)
        for _n, _p, sql in stream.warm():
            engine.execute(sql)
        queries = R.closed_loop(engine, stream, args.seconds,
                                lambda f: f())
        dev = engine.device
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        done = [q for q in queries if q.error is None]
        line = {"workload": args.workload, "seed": seed,
                "attempted": len(queries), "failed": len(queries) - len(done)}
        for control in (None, "float64", "float32"):
            v = R.judge(cell, data, done, seed, dev, control)
            line[control or "program"] = {
                "mismatched_rows": v["mismatched_rows"],
                "answers_compared": v["answers_compared"],
                "notes": v["notes"]}
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
