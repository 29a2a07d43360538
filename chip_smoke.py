"""Drive presto_tpu_torch on the GPU: build its CUDA kernels, hold each
against its plain PyTorch version at the main path's shapes, then run
all 22 TPC-H queries, a lineitem-partsupp join (the unique non-dense
join shape that reaches join_lookup at SF10), a grouped min/max (which
reaches segment_min: no TPC-H query folds a min through it) and a
general cross join (which reaches the compaction kernel) at SF10 on
both kernel backends.

    python3 chip_smoke.py [--scale 10] [--seed 19920101]

Phases (any failure exits non-zero before the result line):

1. The card's ``nvidia-smi`` name and power limit; the kernel build.
2. Kernels: segment_sum, segment_max and segment_min over 60M rows
   (k = 6 or 1, 4096, 1<<20; max/min with values at +-2^63 and empty
   segments), build_table on 15M rows and probe_table with 60M rows,
   multijoin_walk over a 60M spine with 3 builds, and filter_compact of
   a 60M-row mask (about 4% live) into 2^23 rows with int64, float64,
   [n, 2] int64 and bool columns. Each is compared with its plain
   version on the same inputs (exact equality required; live rows for
   the compaction) and timed with CUDA events beside the plain
   version, the one PyTorch call that computes the same function where
   there is one, and the least time the card could take for the bytes
   it must move.
3. Queries: data made by the port's own TPC-H generator from the seed;
   every query runs with kernel_backend=cuda (the launch counts are
   reset just before this pass and read just after, and each query's
   peak device memory is read) and then with kernel_backend=torch;
   rows must be identical, and Q1/Q6 (and Q11's row count, which is
   0 at SF10) are checked against an independent numpy computation
   over the generator's arrays.

The queries are the repository's TPC-H texts (tests/tpch_queries.py).
The last lines are the card, a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import decimal
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from tpch_queries import QUERIES as TPCH  # noqa: E402 (the 22 texts)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM rate outside the tensor cores

KERNELS = {
    "segment_sum": ("presto_tpu_torch/kernels/csrc/segment_sum.cu",
                    "presto_tpu/kernels/segagg.py:68"),
    "segment_max": ("presto_tpu_torch/kernels/csrc/segment_cmp.cu",
                    "presto_tpu/kernels/segagg.py:118"),
    "segment_min": ("presto_tpu_torch/kernels/csrc/segment_cmp.cu",
                    "presto_tpu/kernels/segagg.py:118"),
    "build_table": ("presto_tpu_torch/kernels/csrc/hashjoin.cu",
                    "presto_tpu/kernels/hashjoin.py:59"),
    "probe_table": ("presto_tpu_torch/kernels/csrc/hashjoin.cu",
                    "presto_tpu/kernels/hashjoin.py:151"),
    "multijoin_walk": ("presto_tpu_torch/kernels/csrc/multijoin.cu",
                       "presto_tpu/kernels/multijoin.py:59"),
    "filter_compact": ("presto_tpu_torch/kernels/csrc/compact.cu",
                       "presto_tpu/kernels/compact.py:84"),
}
# the kernel each query must run on the card. At SF10 the cost-based
# planner builds Q3's orders-lineitem join on lineitem (an expanding
# join, which has no kernel in the reference either) and its customer
# join is dense, so the unique non-dense join that reaches join_lookup
# is a lineitem-partsupp join on partsupp's composite key
QUERY_KERNELS = {"q01": "cuda:agg_sum", "q06": "cuda:agg_sum",
                 "q05": "cuda:multijoin", "q09": "cuda:multijoin",
                 "q15": "cuda:agg_max",
                 "lineitem_partsupp": "cuda:join_lookup",
                 "lineitem_extrema": "cuda:agg_min",
                 "cross_join": "cuda:compact"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the current stream."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.is_floating_point():
        if not torch.equal(a, b):  # bits, NaN aside
            return float((a - b).abs().max())
        return 0.0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return float(d.max()) if d.numel() else 0.0


def require_equal(name: str, pairs) -> float:
    err = max(max_abs_err(a, b) for a, b in pairs)
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


# -- phase 2: kernels at the main path's shapes -----------------------------


def kernel_phase(dev, seed: int) -> dict:
    import torch

    from presto_tpu_torch.kernels import hashjoin as HJ
    from presto_tpu_torch.kernels import multijoin as MJ
    from presto_tpu_torch.kernels import segagg as SA
    from presto_tpu_torch.ops import hash as H

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: dict = {}

    # segment_sum: Q1's fold is 60M int64 rows into a handful of groups
    n = 60_000_000
    data = torch.randint(-(1 << 40), 1 << 40, (n,), dtype=torch.int64,
                         device=dev, generator=gen)
    cases = []
    for k in (6, 4096, 1 << 20):
        ids = torch.randint(0, k, (n,), dtype=torch.int32, device=dev,
                            generator=gen)
        got = SA.segment_sum_cuda(data, ids, k)
        want = SA.segment_sum_torch(data, ids, k)
        err = require_equal(f"segment_sum k={k}", [(got, want)])
        ids64 = ids.to(torch.int64)

        def library(ids64=ids64, k=k):
            torch.zeros(k, dtype=torch.int64, device=dev).index_add_(
                0, ids64, data)
        b_ms, b_by = bound(n * (8 + 4) + k * 8, n)
        case = {"k": k, "max_abs_err": err,
                "ms": cuda_ms(lambda ids=ids, k=k:
                              SA.segment_sum_cuda(data, ids, k)),
                "plain_ms": cuda_ms(lambda ids=ids, k=k:
                                    SA.segment_sum_torch(data, ids, k)),
                "library_ms": cuda_ms(library),
                "bound_ms": b_ms, "bound_by": b_by}
        log("kernel " + json.dumps({"name": "segment_sum", **case}))
        cases.append(case)
        del ids, ids64
    out["segment_sum"] = {**cases[0], "cases": cases}

    # segment_max / segment_min: Q15's global max is k = 1; values at
    # +-2^63 and ids that leave the upper half of the segments empty
    data[:2] = torch.tensor([(1 << 63) - 1, -(1 << 63)], device=dev)
    for name, is_max in (("segment_max", True), ("segment_min", False)):
        cases = []
        kernel = SA.segment_max_cuda if is_max else SA.segment_min_cuda
        plain = SA.segment_max_torch if is_max else SA.segment_min_torch
        for k in (1, 4096, 1 << 20):
            ids = torch.randint(-1, max(k // 2, 1), (n,), dtype=torch.int32,
                                device=dev, generator=gen)
            got = kernel(data, ids, k)
            want = plain(data, ids, k)
            err = require_equal(f"{name} k={k}", [(got, want)])
            idx = torch.where(ids >= 0, ids, k).to(torch.int64)

            def library(idx=idx, k=k, is_max=is_max):
                torch.full((k + 1,), -(1 << 63) if is_max
                           else (1 << 63) - 1, dtype=torch.int64,
                           device=dev).scatter_reduce_(
                    0, idx, data, "amax" if is_max else "amin")
            b_ms, b_by = bound(n * (8 + 4) + k * 8, n)
            case = {"k": k, "max_abs_err": err,
                    "ms": cuda_ms(lambda ids=ids, k=k: kernel(data, ids, k)),
                    "plain_ms": cuda_ms(lambda ids=ids, k=k:
                                        plain(data, ids, k)),
                    "library_ms": cuda_ms(library),
                    "bound_ms": b_ms, "bound_by": b_by}
            log("kernel " + json.dumps({"name": name, **case}))
            cases.append(case)
            del ids, idx
        out[name] = {**cases[0], "cases": cases}
    del data

    # build_table on an orders-sized build (15M unique keys of a 60M
    # span), probe_table with a lineitem-sized probe (60M rows)
    nb, npr = 15_000_000, 60_000_000
    bkeys = torch.randperm(4 * nb, device=dev, generator=gen)[:nb]
    pkeys = torch.randint(0, 4 * nb, (npr,), dtype=torch.int64, device=dev,
                          generator=gen)
    bh = H.combine_hashes([H.hash_int_column(bkeys)])
    ph = H.combine_hashes([H.hash_int_column(pkeys)])
    bl = torch.rand(nb, device=dev, generator=gen) > 0.05
    pl = torch.rand(npr, device=dev, generator=gen) > 0.05
    cap = H.next_pow2(2 * nb)
    got = HJ.lookup_join_cuda(bh, bl, ph, pl, cap)
    want = HJ.lookup_join_torch(bh, bl, ph, pl, cap)
    if not bool(got[2]):
        raise AssertionError("build/probe reported a chain overflow")
    err = require_equal("build_table/probe_table",
                        [(got[0], want[0]), (got[1], want[1])])
    keys, rows, _ok = HJ.build_table(bh, bl, cap)
    b_ms, b_by = bound(nb * (8 + 1) + cap * (8 + 4) + 4, nb * 8)
    out["build_table"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: HJ.build_table(bh, bl,
                                                                cap)),
        "plain_ms": cuda_ms(lambda: H.sort_build_side(bh, bl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log("kernel " + json.dumps({"name": "build_table",
                                **out["build_table"]}))
    p_ms, p_by = bound(npr * (8 + 1) + cap * (8 + 4) + npr * (4 + 1) + 4,
                       npr * 8)
    out["probe_table"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: HJ.probe_table(keys, rows, ph, pl)),
        "plain_ms": cuda_ms(lambda: H.probe_runs(bh, bl, ph, pl)),
        "library_ms": None, "bound_ms": p_ms, "bound_by": p_by}
    log("kernel " + json.dumps({"name": "probe_table",
                                **out["probe_table"]}))
    del keys, rows, got, want, bh, ph, pl

    # multijoin_walk over a lineitem-sized spine with three builds: an
    # orders-sized one on the spine, a supplier-sized one on the spine,
    # and a customer-sized one keyed by the first build's column
    from presto_tpu_torch import kernels as K
    from presto_tpu_torch import types as T
    from presto_tpu_torch.exec import operators as OP
    from presto_tpu_torch.expr.compile import Val

    def table(cols, live):
        return OP.DTable({k: Val(T.BIGINT, v) for k, v in cols.items()},
                         live, live.shape[0], dev)
    width = 60_000_000
    spine = table({"l_orderkey": pkeys,
                   "l_suppkey": torch.randint(0, 100_000, (width,),
                                              device=dev, generator=gen)},
                  torch.rand(width, device=dev, generator=gen) > 0.05)
    builds = [
        table({"o_orderkey": bkeys,
               "o_custkey": torch.randint(0, 1_500_000, (nb,), device=dev,
                                          generator=gen)}, bl),
        table({"s_suppkey": torch.randperm(100_000, device=dev,
                                           generator=gen)},
              torch.ones(100_000, dtype=torch.bool, device=dev)),
        table({"c_custkey": torch.randperm(1_500_000, device=dev,
                                           generator=gen)},
              torch.rand(1_500_000, device=dev, generator=gen) > 0.5)]
    crit = [[("l_orderkey", "o_orderkey")], [("l_suppkey", "s_suppkey")],
            [("o_custkey", "c_custkey")]]
    args = (spine.cols, spine.live, width,
            [(b.cols, b.live, b.n) for b in builds], crit)
    with K.use_backend("cuda"):
        got = MJ.multijoin_cuda(*args)
    want = MJ.multijoin_torch(*args)
    if not bool(got[2]):
        raise AssertionError("multijoin reported a chain overflow")
    err = require_equal("multijoin_walk",
                        [(got[1], want[1])]
                        + [(g, w) for g, w in zip(got[0], want[0])])
    steps = MJ._resolve(spine.cols, [(b.cols, b.live, b.n) for b in builds],
                        crit)
    desc, keep, _oks = MJ.step_descriptors(
        steps, [(b.cols, b.live, b.n) for b in builds])
    caps = [H.next_pow2(2 * b.n) for b in builds]
    # inputs read once: spine live, the two spine key hashes, the
    # chained key's hash over the first build, every table; outputs:
    # three gathers and the live mask
    w_bytes = (width * 1 + 2 * width * 8 + nb * 8
               + sum(c * 12 for c in caps) + 3 * width * 4 + width)
    w_ms, w_by = bound(w_bytes, width * 3 * 8)
    out["multijoin_walk"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: MJ.multijoin_walk(desc, 3, spine.live,
                                                width)),
        "fused_ms": cuda_ms(lambda: MJ.multijoin_cuda(*args)),
        "plain_ms": cuda_ms(lambda: MJ.multijoin_torch(*args)),
        "library_ms": None, "bound_ms": w_ms, "bound_by": w_by}
    log("kernel " + json.dumps({"name": "multijoin_walk",
                                **out["multijoin_walk"]}))
    del keep, desc, got, want, spine, builds, args, bkeys, pkeys, bl

    # filter_compact: the general cross join's left side, a 60M-row
    # scan with about 4% live compacted into 2^23 rows
    from presto_tpu_torch.kernels import compact as CP
    live = torch.rand(width, device=dev, generator=gen) < 0.04
    arrays = {
        "i64": torch.randint(-(1 << 62), 1 << 62, (width,), device=dev,
                             generator=gen),
        "f64": torch.rand(width, dtype=torch.float64, device=dev,
                          generator=gen),
        "dec": torch.randint(-(1 << 62), 1 << 62, (width, 2), device=dev,
                             generator=gen),
        "flag": torch.rand(width, device=dev, generator=gen) < 0.5}
    cap = 1 << 23
    got = CP.filter_compact_cuda(live, arrays, cap)
    want = CP.filter_compact_torch(live, arrays, cap)
    nlive = int(live.sum())
    rows = min(nlive, cap)
    err = require_equal("filter_compact", [(got[k][:rows], want[k][:rows])
                                           for k in arrays])
    row_bytes = sum(a.element_size() * (a.shape[1] if a.ndim == 2 else 1)
                    for a in arrays.values())

    def library():
        # nonzero syncs with the host for its output size
        idx = torch.nonzero(live).squeeze(1)[:cap]
        return {k: a.index_select(0, idx) for k, a in arrays.items()}
    c_ms, c_by = bound(width + rows * row_bytes + cap * row_bytes, width)
    out["filter_compact"] = {
        "max_abs_err": err, "live_rows": nlive, "capacity": cap,
        "ms": cuda_ms(lambda: CP.filter_compact_cuda(live, arrays, cap)),
        "plain_ms": cuda_ms(lambda: CP.filter_compact_torch(live, arrays,
                                                            cap)),
        "library_ms": cuda_ms(library), "library_note":
            "torch.nonzero + index_select (nonzero syncs with the host)",
        "bound_ms": c_ms, "bound_by": c_by}
    log("kernel " + json.dumps({"name": "filter_compact",
                                **out["filter_compact"]}))
    del live, arrays, got, want
    torch.cuda.empty_cache()
    return out


# -- phase 3: the main path at SF10 -----------------------------------------

QUERIES = {**TPCH,
           "lineitem_partsupp": """
select ps_supplycost, sum(l_quantity) as q, count(*) as c
from lineitem, partsupp
where l_partkey = ps_partkey and l_suppkey = ps_suppkey
  and l_shipdate < date '1993-01-01'
group by ps_supplycost
order by q desc, ps_supplycost
limit 5""",
           # the extremes of each line status: a direct group-by whose
           # min/max fold through the agg_min/agg_max entries (no
           # TPC-H query folds a min there: Q2's goes the sorted way)
           "lineitem_extrema": """
select l_returnflag, l_linestatus, min(l_shipdate) as first_ship,
  max(l_receiptdate) as last_receipt, min(l_extendedprice) as min_price,
  max(l_quantity) as max_qty, min(l_discount) as min_disc
from lineitem
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus""",
           # a fact table crossed with a small dimension: the general
           # cross join compacts its filtered lineitem side (planned
           # at 2.4M rows, so a 2^23-row capacity) before the product
           "cross_join": """
select r_name, count(*) as c, sum(l_extendedprice) as s
from lineitem cross join region
where l_orderkey < 600000
group by r_name
order by r_name""",
           }


def independent_checks(conn, rows: dict) -> None:
    """Q6's revenue, Q1's group counts and Q11's row count recomputed
    with numpy from the generator's arrays, independent of the
    engine."""
    li = conn.table("lineitem").columns

    def days(s):
        return int((np.datetime64(s) - np.datetime64("1970-01-01"))
                   .astype(int))
    ship = np.asarray(li["l_shipdate"].data)
    disc = np.asarray(li["l_discount"].data)
    qty = np.asarray(li["l_quantity"].data)
    price = np.asarray(li["l_extendedprice"].data)
    m = ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    revenue = int((price[m] * disc[m]).sum())  # scale 4, fits int64
    got = rows["q06"][0][0]
    if got != decimal.Decimal(revenue).scaleb(-4):
        raise AssertionError(f"Q6 revenue {got} != numpy {revenue}e-4")
    keep = ship <= days("1998-12-01") - 90
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    codes = (np.asarray(rf.data)[keep].astype(np.int64) * len(ls.dictionary)
             + np.asarray(ls.data)[keep])
    counts = np.bincount(codes, minlength=len(rf.dictionary)
                         * len(ls.dictionary))
    want = {(rf.dictionary[c // len(ls.dictionary)],
             ls.dictionary[c % len(ls.dictionary)]): int(v)
            for c, v in enumerate(counts) if v}
    have = {(r[0], r[1]): int(r[-1]) for r in rows["q01"]}
    if have != want:
        raise AssertionError(f"Q1 counts {have} != numpy {want}")
    check_q11(conn, rows["q11"])


def check_q11(conn, got) -> None:
    """Q11's parts over the threshold, recomputed with numpy: its fixed
    fraction 0.0001 is the SF1 value of the spec's 0.0001 / SF, so at
    SF10 no part may reach it and the empty answer is the right one."""
    ps = conn.table("partsupp").columns
    su = conn.table("supplier").columns
    na = conn.table("nation").columns
    names = na["n_name"]
    germany = np.asarray(na["n_nationkey"].data)[
        list(names.dictionary).index("GERMANY")
        == np.asarray(names.data)]
    sup = np.asarray(su["s_suppkey"].data)[
        np.isin(np.asarray(su["s_nationkey"].data), germany)]
    m = np.isin(np.asarray(ps["ps_suppkey"].data), sup)
    value = (np.asarray(ps["ps_supplycost"].data)[m].astype(np.int64)
             * np.asarray(ps["ps_availqty"].data)[m])  # scale 2
    parts, inv = np.unique(np.asarray(ps["ps_partkey"].data)[m],
                           return_inverse=True)
    sums = np.zeros(len(parts), np.int64)
    np.add.at(sums, inv, value)
    over = int((sums * 10_000 > int(value.sum())).sum()) if len(parts) \
        else 0
    if len(got) != over:
        raise AssertionError(f"Q11 rows {len(got)} != numpy {over}")


def query_phase(scale: float, seed: int) -> tuple[dict, dict]:
    import torch

    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.kernels import build as B

    t0 = time.perf_counter()
    conn = TpchConnector(scale=scale, seed=seed)
    for name in conn.table_names():
        conn.table(name)
    log(f"datagen sf={scale:g} seed={seed}: "
        f"{time.perf_counter() - t0:.1f} s")
    engine = Engine()
    engine.register_catalog("tpch", conn)

    def run(backend: str) -> tuple[dict, dict, dict]:
        engine.session.set("kernel_backend", backend)
        rows, secs, notes = {}, {}, {}
        for q, sql in QUERIES.items():
            passes0 = HS.SYNCS.by_site.get("ok-ladder", 0)
            syncs0 = HS.SYNCS.total()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rows[q] = engine.execute(sql)
            torch.cuda.synchronize()
            secs[q] = time.perf_counter() - t
            notes[q] = {
                "kernels": sorted({tag for tags in
                                   engine.last_kernel_notes.values()
                                   for tag in tags}),
                "host_syncs": HS.SYNCS.total() - syncs0,
                "ok_ladder_syncs": HS.SYNCS.by_site.get("ok-ladder", 0)
                - passes0,
                # resident scan columns included
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        return rows, secs, notes

    t = time.perf_counter()
    run("cuda")  # uploads the scan columns once; not counted
    log(f"first pass (column upload included): "
        f"{time.perf_counter() - t:.1f} s")
    B.LAUNCHES.reset()
    rows, secs, notes = run("cuda")
    launches = B.LAUNCHES.snapshot()
    plain_rows, plain_secs, plain_notes = run("torch")
    lineitem_rows = conn.table("lineitem").nrows
    queries = {}
    for q in QUERIES:
        if rows[q] != plain_rows[q]:
            raise AssertionError(f"{q}: cuda and torch backends differ")
        if not rows[q] and q != "q11":  # check_q11 holds its count
            raise AssertionError(f"{q}: no rows")
        if q in QUERY_KERNELS and QUERY_KERNELS[q] not in \
                notes[q]["kernels"]:
            raise AssertionError(f"{q} did not run {QUERY_KERNELS[q]}: "
                                 f"{notes[q]}")
        queries[q] = {"rows": len(rows[q]), "s": secs[q],
                      "lineitem_rows_per_s": lineitem_rows / secs[q],
                      "plain_s": plain_secs[q], **notes[q],
                      "plain_kernels": plain_notes[q]["kernels"]}
        log("query " + json.dumps({"query": q, **queries[q]}))
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path: {launches}")
    independent_checks(conn, rows)
    log("independent numpy checks of Q1, Q6 and Q11: ok")
    log("launches " + json.dumps(launches))
    return launches, queries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=19920101)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from presto_tpu_torch.kernels import build as B

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    B.LIBRARY.get()
    log(f"kernel build: {B.LIBRARY.build_seconds:.1f} s ({B.LIBRARY.path})")
    dev = torch.device("cuda")

    t = time.perf_counter()
    kernels = kernel_phase(dev, args.seed)
    log(f"kernel phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches, _queries = query_phase(args.scale, args.seed)
    log(f"query phase: {time.perf_counter() - t:.1f} s")

    summary = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
