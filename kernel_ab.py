"""Time the kernels of two checkouts of the port in turns on one card.

    python3 kernel_ab.py --trees build/parent,.,.,build/parent

Each tree is a checkout of this repository (an earlier commit unpacked
with ``git archive`` into a directory that git ignores). For each tree,
in the order given, a fresh process imports that tree's
``presto_tpu_torch``, builds its kernels from its sources, and runs
the kernel phase of this checkout's ``chip_smoke.py`` against it: every
kernel at the main path's shapes from the same seed, held against its
plain version and timed with CUDA events. Turns A, B, B, A put each
version on both sides of the other, so drift of the card shows as a
spread between the two turns of one tree. Prints the card's name and
power limit, each turn's ``kernel`` lines, then one ``ab`` JSON line
per kernel and shape with the milliseconds of every turn.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def case_key(name: str, case: dict) -> str:
    """The key of one timed case: the kernel's name, then the case's
    label (or its k, or nothing for a kernel timed at one shape)."""
    if "case" in case:
        return f"{name} {case['case']}"
    return name + (f" k={case['k']}" if "k" in case else "")


def one(tree: Path, seed: int) -> int:
    """Run the kernel phase against ``tree``'s package; print it as one
    ``result`` JSON line."""
    sys.path.insert(0, str(tree))
    import torch

    import presto_tpu_torch
    from presto_tpu_torch.kernels import build as B
    if not Path(presto_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {presto_tpu_torch.__file__}, not "
                           f"the package of {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B.LIBRARY.get()
    out = smoke.kernel_phase(torch.device("cuda"), seed)
    times = {case_key(name, case): case["ms"]
             for name, res in out.items()
             for case in res.get("cases", [res])}
    print("result " + json.dumps(times), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", default="build/parent,.,.,build/parent")
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(Path(args.one).resolve(), args.seed)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    trees = args.trees.split(",")
    turns = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", tree,
             "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=1200)
        print(f"== {tree} (exit {proc.returncode})", flush=True)
        print(proc.stdout, proc.stderr[-4000:], flush=True)
        if proc.returncode != 0:
            return 1
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("result ")][-1]
        turns.append(json.loads(line[len("result "):]))
    for key in turns[0]:
        print("ab " + json.dumps({"kernel": key, "trees": trees,
                                  "ms": [t.get(key) for t in turns]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
