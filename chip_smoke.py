"""Drive presto_tpu_torch on the GPU: build its CUDA kernels, hold each
against its plain PyTorch version at the main path's shapes, then run
all 22 TPC-H queries, a lineitem-partsupp join (the unique non-dense
join shape that reaches join_lookup at SF10), a grouped min/max (which
reaches segment_min: no TPC-H query folds a min through it) and a
general cross join (which reaches the compaction kernel) at SF10 on
both kernel backends; then the TPC-DS queries at scale 10, and the
function library's aggregates, sketches and scalar functions at SF10,
and ARRAY and MAP values, lambdas, UNNEST, the variable-length
aggregates and MATCH_RECOGNIZE at SF10, and the session's paths at
SF10: spill, grouped execution, the capacity memory, templates,
PREPARE/EXECUTE, EXPLAIN ANALYZE and cancellation.

    python3 chip_smoke.py [--scale 10] [--seed 19920101]

Phases (any failure exits non-zero before the result line):

1. The card's ``nvidia-smi`` name and power limit; the kernel build.
2. Kernels: segment_sum over 60M rows (k = 6 and 1 in registers, 32
   in lane columns of shared memory, 4096 in shared-memory partials,
   1<<20 by global atomics), segment_max and segment_min over 60M rows
   (k = 1, 6 in int64 and int32, 4096, 1<<20 in random and in sorted
   order, with values at +-2^63 and empty segments), build_table on
   15M rows and probe_table with 60M rows (and a build with duplicate
   keys, compared only), multijoin_walk over a 60M spine with 3
   builds, and filter_compact of a 60M-row mask (about 4% live) into
   2^23 rows with int64, float64, [n, 2] int64 and bool columns. Each
   is compared with its plain version on the same inputs (exact
   equality required; live rows for the compaction) and timed with
   CUDA events beside the plain version, the one PyTorch call that
   computes the same function where there is one, and the least time
   the card could take for the bytes it must move; the probe and the
   walk also beside their random-read floor, one ``index_select`` of
   as many random 16-byte table slots as their live first probes, and
   the compaction beside its gather floor, ``index_select`` of every
   column at the live indices found beforehand plus the zeroed tail.
3. Queries: data made by the port's own TPC-H generator from the seed;
   every query runs through the executor's default route (block
   streaming, segmented execution, dynamic filtering, at the session's
   defaults) with kernel_backend=cuda (the launch counts are reset just
   before this pass and read just after, and each query's peak device
   memory, segments, streamed blocks, capacity rungs, host syncs and
   uploads are read) and then with kernel_backend=torch; rows must be
   identical, and Q1/Q6 (and Q11's row count, which is 0 at SF10) are
   checked against an independent numpy computation over the
   generator's arrays. The paths check: Q1 and Q6 stream in 4 blocks
   and equal the same query unstreamed (``scan_block_rows=0``); Q5, Q9
   and Q12 give the same rows with dynamic filtering off, and Q12's
   orders scan keeps more live rows without it.
4. TPC-DS: the TPC-H engine and its resident columns are let go, then
   the port's TPC-DS generator makes scale 10 (28.8M store_sales rows,
   about 66M in all) and the 101 queries of tests/test_tpcds.py run as
   in phase 3: a first cuda pass that uploads the columns, a timed
   cuda pass between a reset and a read of the launch counts, then
   kernel_backend=torch; rows identical, the kernel pinned for a query
   in ``TPCDS_QUERY_KERNELS`` run, no query empty unless numpy finds no
   row that could answer it (``EMPTY_CHECKS``), and Q96's count and
   Q55's brand sums equal a numpy computation over the generator's
   arrays. A query that does not fit the card (``TPCDS_OVER_MEMORY``,
   with its blocker) runs last and must run out of memory; q72's line
   carries the rows of its expanding join, counted with numpy.

5. Functions: the TPC-H tables of phase 3 (made again when it did not
   run) through the queries of ``FUNCTION_QUERIES`` on both backends
   as in phase 3: every aggregate of the function library grouped (F1),
   a global sketch (F2), 512 groups of HLL registers and percentile
   reservoirs (F3: about 2^20 register and 2^19 reservoir segments
   through segment_max and segment_min), dates, strings over part
   joined to lineitem, numbers and a varchar-to-number cast (F4-F7).
   Rows identical on both backends but for the columns finalized from
   float states (``FLOAT_STATE_COLUMNS``: corr, covar_samp, regr_slope,
   skewness, kurtosis, geometric_mean and float sums, which sum with
   atomics on the card), within a relative 1e-9; F1-F3 must run
   ``cuda:agg_max`` and ``cuda:agg_min``; numpy checks the answers
   (``check_functions``); F3's widest register and reservoir folds are
   held against the plain versions and timed.
6. Arrays: the TPC-H tables again through ``ARRAY_QUERIES`` on both
   backends as in phase 3: word counts over part names through the
   part-partsupp join and UNNEST (A1, segment_sum), an ARRAY group key
   made below the aggregate-input split, so its segment carrier holds
   the array with its ``$len`` and ``$emask`` companions (A2, compacted
   by filter_compact; the carrier's arrays are printed), lambdas and
   array scalars over every lineitem row and a map lookup over orders
   (A3), array_agg of 15M orders by customer read by cardinality
   through the host-table carrier, and listagg and map_agg over nation
   and region (A4), and the V-shape MATCH_RECOGNIZE over the orders of
   the customers o_custkey <= ``MR_CUT_CUSTKEY`` (A5: 1.5M orders, SF1's
   worth, because the pattern automaton is the reference's host loop).
   Rows identical on both backends, each query's kernel
   (``ARRAY_QUERY_KERNELS``) run, segment_sum and filter_compact
   launched; numpy (and plain python for the names and the V shapes)
   checks every answer (``check_arrays``).

7. Session: the TPC-H tables again, each case on a fresh engine, on
   both backends (the cuda runs between a reset and a read of the
   launch counts, which the summary adds): S1 lineitem_partsupp under
   ``query_max_memory_bytes`` set to a quarter of its
   ``estimate_plan_memory`` total spills its join in at least 2
   partitions through ``cuda:join_lookup``, rows equal to the whole run
   (the estimate, partitions, build rows and both peaks printed); S2 a
   group-by of orders by its 10,000 clerks spills its aggregate
   (``cuda:agg_sum``) and, with ``spill_enabled=false``, raises
   MemoryLimitExceeded; S3 orders joined to lineitem with grouped
   execution in 8 buckets equals the default route; S4 Q18 repeated
   takes 0 rungs, every program's capacities from memory, and with
   HAVING > 312 hits its template with 0 rungs and rows equal to a
   fresh engine's; Q6 prepared with its dates as parameters equals its
   literal SQL for two date pairs; S5 EXPLAIN ANALYZE of Q5 and Q21
   shows one section per segment, every node's rows equal to a plain
   run's node rows, Q21's carriers compacted by filter_compact; S6 Q9
   under ``query_max_run_time=0.001`` raises TimeLimitExceeded, a
   cancelled token QueryCanceled, and Q1 then equals its phase-3 rows.
   Every case's rows are identical on both backends.

The query lines of phases 3-6 carry the first (cold) pass's time and
capacity rungs (``cold_s``, ``cold_rungs``) beside the timed pass's:
the timed pass starts every program from the capacities the first
remembered (``from_memory``).

    python3 chip_smoke.py --phases kernels,tpch,tpcds,functions,arrays,session

(the default) runs the named phases only (a shorter call while a phase
is worked on; the summary line needs all seven).

The queries are the repository's TPC-H texts (tests/tpch_queries.py),
TPC-DS texts (tests/test_tpcds.py), ``FUNCTION_QUERIES`` and
``ARRAY_QUERIES``. The last
lines are the card, a JSON summary of the kernels (each with the PR
that last redesigned it, ``redesigned_in``, and its launches summed
over phases 3 to 7) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import decimal
import gc
import json
import re
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
# the PR whose redesign each kernel runs (None: as first ported)
REDESIGNED_IN = {"segment_sum": 3, "segment_max": 5, "segment_min": 5,
                 "build_table": 3, "probe_table": 4,
                 "multijoin_walk": 4, "filter_compact": 5}
SLOT_BYTES = 16  # a hash-table slot: key, row and pad (csrc/common.cuh)
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


# the kernel each TPC-DS query must run on the card at scale 10 (one
# query, at least, for each kernel the sweep launches; no query of the
# sweep reaches segment_min): q58's segments compact their carriers
TPCDS_QUERY_KERNELS = {"q96": "cuda:agg_sum", "q42": "cuda:join_lookup",
                       "q07": "cuda:multijoin", "q23": "cuda:agg_max",
                       "q58": "cuda:compact"}
# queries whose answer does not fit the card at scale 10, each with its
# blocker (ROADMAP Queue 3): the phase runs them on both backends last
# and requires the out-of-memory error, so that one that starts to fit
# is moved back into the sweep
TPCDS_OVER_MEMORY = {
    "q72": "its WHERE conjuncts on the dimensions stay above the LEFT "
           "joins, so catalog_sales (14.4M rows) joins inventory on the "
           "item alone, 626,407,591 rows, all live: a segment cannot "
           "compact them, and the program that makes them runs out of "
           "memory at 81.3 GB on both backends (needs the dimension "
           "predicates pushed below the LEFT joins, which the reference's "
           "planner does not do either; the reference's spill would not "
           "bound these rows, as it concatenates every partition's join "
           "output before the rest of the plan)",
}
TPCDS_SCALE = 10.0
PHASES = ("kernels", "tpch", "tpcds", "functions", "arrays", "session")
TPCDS_SEED = 20030527  # the connector's default, as tests/test_tpcds.py


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


def random_read_ms(dev, seed: int, tables: list[tuple[int, int]]) -> float:
    """The random-read floor of a hash-table kernel: the time of
    ``index_select`` over (slots in the table, live first probes)
    pairs, with that many random slot indices into a table of that
    many 16-byte slots (viewed as complex128, one element a slot, so
    each index is one 16-byte read). The same random reads and nothing
    else; not the same function, so no library call."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    work = [(torch.zeros(cap, dtype=torch.complex128, device=dev),
             torch.randint(0, cap, (n,), device=dev, generator=gen))
            for cap, n in tables]
    ms = cuda_ms(lambda: [t.index_select(0, slots) for t, slots in work])
    del work
    return ms


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
    # (k = 6, the headline); a global fold is k = 1; k = 32 is the lane
    # path's widest, 4096 the shared-memory path's, 1<<20 the global
    # atomics'
    n = 60_000_000
    data = torch.randint(-(1 << 40), 1 << 40, (n,), dtype=torch.int64,
                         device=dev, generator=gen)
    cases = []
    for k in (6, 1, 32, 4096, 1 << 20):
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

    # segment_max / segment_min: Q15's global max is k = 1 (ids -1 or
    # 0); lineitem_extrema's direct group-by folds int64 decimals and an
    # int32 date into k = 6; 4096 takes the shared-memory partials and
    # 1<<20 the global atomics (ids in [-1, k // 2): values at +-2^63,
    # the upper half of the segments empty). The last case sorts the
    # values the way that defeats the kernel's skipped atomics
    # (ascending for max, descending for min: every row beats its
    # segment so far)
    data[:2] = torch.tensor([(1 << 63) - 1, -(1 << 63)], device=dev)
    data32 = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                           device=dev, generator=gen)
    data32[:2] = torch.tensor([(1 << 31) - 1, -(1 << 31)], device=dev)
    ascending = torch.sort(data).values
    cmp_cases = [("k=1", data, 1, False), ("k=6", data, 6, True),
                 ("k=6 int32", data32, 6, True),
                 ("k=4096", data, 4096, False),
                 ("k=1048576", data, 1 << 20, False),
                 ("k=1048576 sorted", ascending, 1 << 20, False)]
    for name, is_max in (("segment_max", True), ("segment_min", False)):
        cases = []
        kernel = SA.segment_max_cuda if is_max else SA.segment_min_cuda
        plain = SA.segment_max_torch if is_max else SA.segment_min_torch
        for label, values, k, full in cmp_cases:
            if label.endswith("sorted") and not is_max:
                values = values.flip(0)
            ids = torch.randint(0 if full else -1, k if full
                                else max(k // 2, 1), (n,), dtype=torch.int32,
                                device=dev, generator=gen)
            got = kernel(values, ids, k)
            want = plain(values, ids, k)
            err = require_equal(f"{name} {label}", [(got, want)])
            idx = torch.where(ids >= 0, ids, k).to(torch.int64)
            info = torch.iinfo(values.dtype)

            def library(values=values, idx=idx, k=k, is_max=is_max,
                        info=info):
                torch.full((k + 1,), info.min if is_max else info.max,
                           dtype=values.dtype, device=dev).scatter_reduce_(
                    0, idx, values, "amax" if is_max else "amin")
            b_ms, b_by = bound(n * (values.element_size() + 4) + k * 8, n)
            case = {"case": label, "k": k, "max_abs_err": err,
                    "ms": cuda_ms(lambda values=values, ids=ids, k=k:
                                  kernel(values, ids, k)),
                    "plain_ms": cuda_ms(lambda values=values, ids=ids, k=k:
                                        plain(values, ids, k)),
                    "library_ms": cuda_ms(library),
                    "bound_ms": b_ms, "bound_by": b_by}
            log("kernel " + json.dumps({"name": name, **case}))
            cases.append(case)
            del ids, idx
        out[name] = {**cases[0], "cases": cases}
    del data32, ascending
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
    # duplicate build keys (15M draws from a 60M span repeat ~1.7M
    # keys): the kernel must keep each key's largest row, as the plain
    # version's last-of-run does
    dkeys = torch.randint(0, 4 * nb, (nb,), dtype=torch.int64, device=dev,
                          generator=gen)
    dh = H.combine_hashes([H.hash_int_column(dkeys)])
    dup = HJ.lookup_join_cuda(dh, bl, ph, pl, cap)
    dup_want = HJ.lookup_join_torch(dh, bl, ph, pl, cap)
    if not bool(dup[2]):
        raise AssertionError("build/probe (duplicates) reported a chain "
                             "overflow")
    err = max(err, require_equal("build_table/probe_table (duplicates)",
                                 [(dup[0], dup_want[0]),
                                  (dup[1], dup_want[1])]))
    log(f"build/probe with {nb - int(torch.unique(dkeys).numel())} "
        "duplicate build keys: equal to the plain version")
    del dkeys, dh, dup, dup_want
    # one [cap, 2] slot tensor (older trees return a key plane and a
    # row plane), so kernel_ab.py can time either
    *table, _ok = HJ.build_table(bh, bl, cap)
    b_ms, b_by = bound(nb * (8 + 1) + cap * SLOT_BYTES + 4, nb * 8)
    out["build_table"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: HJ.build_table(bh, bl,
                                                                cap)),
        "plain_ms": cuda_ms(lambda: H.sort_build_side(bh, bl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log("kernel " + json.dumps({"name": "build_table",
                                **out["build_table"]}))
    p_ms, p_by = bound(npr * (8 + 1) + cap * SLOT_BYTES + npr * (4 + 1) + 4,
                       npr * 8)
    out["probe_table"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: HJ.probe_table(*table, ph, pl)),
        "plain_ms": cuda_ms(lambda: H.probe_runs(bh, bl, ph, pl)),
        "library_ms": None, "bound_ms": p_ms, "bound_by": p_by,
        "random_read_floor_ms": random_read_ms(
            dev, seed + 1, [(cap, int(pl.sum()))])}
    log("kernel " + json.dumps({"name": "probe_table",
                                **out["probe_table"]}))
    del table, got, want, bh, ph, pl

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
               + sum(c * SLOT_BYTES for c in caps) + 3 * width * 4 + width)
    w_ms, w_by = bound(w_bytes, width * 3 * 8)
    # the rows that probe each step: live entering it (no key is null)
    probes = [int(spine.live.sum())] + [
        int(MJ.multijoin_torch(*args[:3], args[3][:s], crit[:s])[1].sum())
        for s in (1, 2)]
    out["multijoin_walk"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: MJ.multijoin_walk(desc, 3, spine.live,
                                                width)),
        "fused_ms": cuda_ms(lambda: MJ.multijoin_cuda(*args)),
        "plain_ms": cuda_ms(lambda: MJ.multijoin_torch(*args)),
        "library_ms": None, "bound_ms": w_ms, "bound_by": w_by,
        "step_probes": probes,
        "random_read_floor_ms": random_read_ms(dev, seed + 2,
                                               list(zip(caps, probes)))}
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
    # the gather floor: the same live rows gathered at indices found
    # beforehand (index_select of every column, each live row's sectors
    # read as the kernel reads them) and the rows past them zeroed: the
    # kernel's reads and writes without its scan
    live_idx = torch.nonzero(live).squeeze(1)[:cap]

    def rows_of(a):
        # one element a row: index_select moves a [n, 2] row as two
        # elements, several times slower than one 16-byte element
        return a.view(torch.complex128).squeeze(1) if a.ndim == 2 else a
    columns = [(rows_of(a), rows_of(torch.empty(
        (cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)))
        for a in arrays.values()]

    def gather_floor():
        for a, o in columns:
            torch.index_select(a, 0, live_idx, out=o[:rows])
            o[rows:].zero_()
    out["filter_compact"] = {
        "max_abs_err": err, "live_rows": nlive, "capacity": cap,
        "ms": cuda_ms(lambda: CP.filter_compact_cuda(live, arrays, cap)),
        "plain_ms": cuda_ms(lambda: CP.filter_compact_torch(live, arrays,
                                                            cap)),
        "library_ms": cuda_ms(library), "library_note":
            "torch.nonzero + index_select (nonzero syncs with the host)",
        "bound_ms": c_ms, "bound_by": c_by,
        "gather_floor_ms": cuda_ms(gather_floor)}
    log("kernel " + json.dumps({"name": "filter_compact",
                                **out["filter_compact"]}))
    del live, arrays, got, want, live_idx, columns
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


def sweep(engine, queries: dict[str, str]):
    """The cuda pass that uploads the columns and learns each program's
    capacities (uncounted), the timed cuda pass between a reset and a
    read of the launch counts, and the plain pass: (rows, secs, notes,
    launches, plain rows, plain secs, plain notes). Each query's notes
    carry the first pass's wall time (``cold_s``) and capacity rungs
    (``cold_rungs``): the timed pass starts every program from the
    capacities the first remembered."""
    from presto_tpu_torch.kernels import build as B
    t = time.perf_counter()
    _rows, cold_secs, cold_notes = run_queries(engine, queries, "cuda")
    log(f"first pass (column upload included): "
        f"{time.perf_counter() - t:.1f} s")
    B.LAUNCHES.reset()
    rows, secs, notes = run_queries(engine, queries, "cuda")
    launches = B.LAUNCHES.snapshot()
    for q in queries:
        notes[q] = {**notes[q], "cold_s": cold_secs[q],
                    "cold_rungs": cold_notes[q]["rungs"]}
    return (rows, secs, notes, launches,
            *run_queries(engine, queries, "torch"))


def run_queries(engine, queries: dict[str, str],
                backend: str) -> tuple[dict, dict, dict]:
    """Each query once on ``backend``: rows, wall seconds (a device
    synchronize on either side) and notes (kernels, host syncs,
    uploads, capacity rungs, peak device memory)."""
    import torch

    from presto_tpu_torch.exec import hostsync as HS
    engine.session.set("kernel_backend", backend)
    rows, secs, notes = {}, {}, {}
    for q, sql in queries.items():
        syncs0 = HS.SYNCS.total()
        uploads0 = HS.UPLOADS.total()
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
            # pinned, non-blocking host-to-device copies
            "uploads": HS.UPLOADS.total() - uploads0,
            "segments": sum(map(len, engine.last_run.segments)),
            "blocks": engine.last_streamed_blocks,
            # extra interpreter passes, summed over the query's programs
            "rungs": engine.last_run.rungs,
            # programs that started from remembered capacities
            "from_memory": sum(engine.last_run.from_memory),
            # resident scan columns included
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return rows, secs, notes


def tpch_data(scale: float, seed: int):
    """The port's TPC-H generator's tables, all made up front."""
    from presto_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    conn = TpchConnector(scale=scale, seed=seed)
    for name in conn.table_names():
        conn.table(name)
    log(f"datagen sf={scale:g} seed={seed}: "
        f"{time.perf_counter() - t0:.1f} s")
    return conn


def query_phase(conn) -> tuple[dict, dict]:
    from presto_tpu_torch import Engine

    engine = Engine()
    engine.register_catalog("tpch", conn)
    (rows, secs, notes, launches, plain_rows, plain_secs,
     plain_notes) = sweep(engine, QUERIES)
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
    paths_check(engine, rows, notes)
    log("launches " + json.dumps(launches))
    return launches, queries, rows


def paths_check(engine, rows: dict, notes: dict) -> None:
    """The executor's default paths at SF10 on the cuda backend: Q1 and
    Q6 streamed in 4 blocks equal the same queries unstreamed; Q5, Q9
    and Q12 give the same rows without dynamic filtering, and the
    filter prunes Q12's orders scan (the probe side of its join with the
    filtered lineitem). At SF10 Q5's lineitem is the build side of its
    expanding join with orders, which no filter reaches (at SF0.01 it is
    a spine; tests/test_torch_dynamic_filter.py); Q9's lineitem spine
    keeps every row in both packages, because its partsupp build
    registers l_partkey again after the part build, unfiltered."""
    from presto_tpu_torch.exec.executor import scan_live_rows
    engine.session.set("kernel_backend", "cuda")
    block = engine.session.get("scan_block_rows")
    for q in ("q01", "q06"):
        if notes[q]["blocks"] != 4:
            raise AssertionError(f"{q} streamed in {notes[q]['blocks']} "
                                 "blocks, not 4")
        engine.session.set("scan_block_rows", 0)
        try:
            whole = engine.execute(QUERIES[q])
        finally:
            engine.session.set("scan_block_rows", block)
        if whole != rows[q]:
            raise AssertionError(f"{q}: streamed rows differ from the "
                                 "whole-table run")
    scanned = {}  # (query, table, filter on) -> live rows of its scans
    for df in (True, False):
        engine.session.set("enable_dynamic_filtering", df)
        try:
            for q in ("q05", "q09", "q12"):
                got = engine.execute(QUERIES[q])
                for table in ("lineitem", "orders"):
                    scanned[f"{q} {table} {'on' if df else 'off'}"] = \
                        scan_live_rows(engine, table)
                if got != rows[q]:
                    raise AssertionError(f"{q}: rows differ with dynamic "
                                         f"filtering {df}")
        finally:
            engine.session.set("enable_dynamic_filtering", True)
    on, off = scanned["q12 orders on"], scanned["q12 orders off"]
    if not sum(on) < sum(off):
        raise AssertionError(f"q12: the filter kept {on} of {off} "
                             "orders rows")
    log("paths " + json.dumps({
        "streamed_blocks": {q: notes[q]["blocks"] for q in ("q01", "q06")},
        "scan_live_rows": scanned}))


# -- phase 4: TPC-DS at scale 10 ---------------------------------------------


def tpcds_queries() -> dict[str, str]:
    """The 101 texts of tests/test_tpcds.py, read from its ``QUERIES``
    literal: the module itself imports presto_tpu, which the port's
    runs must not."""
    import ast
    path = Path(__file__).resolve().parent / "tests" / "test_tpcds.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "QUERIES"
                for t in node.targets):
            return dict(sorted(ast.literal_eval(node.value).items()))
    raise RuntimeError(f"no QUERIES literal in {path}")


def _host(conn, table: str, column: str):
    """A generator column's values (strings decoded) and validity."""
    col = conn.table(table).columns[column]
    data = np.asarray(col.data)
    if col.dictionary is not None:
        data = np.asarray(col.dictionary, dtype=object)[data]
    valid = (np.ones(len(data), bool) if col.valid is None
             else np.asarray(col.valid))
    return data, valid


def _dim(conn, table: str, key: str, fk: np.ndarray, fk_valid, column):
    """``column`` of dimension ``table`` at each foreign key (by its
    unique surrogate ``key``), and whether the key was found."""
    keys, kvalid = _host(conn, table, key)
    order = np.argsort(keys, kind="stable")
    pos = np.clip(np.searchsorted(keys[order], fk), 0, len(keys) - 1)
    row = order[pos]
    found = fk_valid & (keys[row] == fk) & kvalid[row]
    vals, vvalid = _host(conn, table, column)
    return vals[row], found & vvalid[row]


def check_q96(conn, got) -> None:
    """Q96's count recomputed with numpy over the generator's arrays."""
    sold_time, tv = _host(conn, "store_sales", "ss_sold_time_sk")
    hdemo, hv = _host(conn, "store_sales", "ss_hdemo_sk")
    store, sv = _host(conn, "store_sales", "ss_store_sk")
    hour, h_ok = _dim(conn, "time_dim", "t_time_sk", sold_time, tv,
                      "t_hour")
    minute, m_ok = _dim(conn, "time_dim", "t_time_sk", sold_time, tv,
                        "t_minute")
    dep, d_ok = _dim(conn, "household_demographics", "hd_demo_sk", hdemo,
                     hv, "hd_dep_count")
    name, n_ok = _dim(conn, "store", "s_store_sk", store, sv,
                      "s_store_name")
    m = (h_ok & m_ok & d_ok & n_ok & (hour == 20) & (minute >= 30)
         & (dep == 7) & (name == "ese"))
    if got != [(int(m.sum()),)]:
        raise AssertionError(f"Q96 {got} != numpy {int(m.sum())}")


def check_q55(conn, got) -> None:
    """Q55's per-brand revenue of one month, recomputed with numpy:
    the top 100 brands by revenue (ties by brand id), each with its
    id, name and exact decimal sum."""
    date, dv = _host(conn, "store_sales", "ss_sold_date_sk")
    item, iv = _host(conn, "store_sales", "ss_item_sk")
    price, pv = _host(conn, "store_sales", "ss_ext_sales_price")
    moy, moy_ok = _dim(conn, "date_dim", "d_date_sk", date, dv, "d_moy")
    year, y_ok = _dim(conn, "date_dim", "d_date_sk", date, dv, "d_year")
    mgr, g_ok = _dim(conn, "item", "i_item_sk", item, iv, "i_manager_id")
    bid, b_ok = _dim(conn, "item", "i_item_sk", item, iv, "i_brand_id")
    brand, n_ok = _dim(conn, "item", "i_item_sk", item, iv, "i_brand")
    m = (moy_ok & y_ok & g_ok & (moy == 11) & (year == 1999)
         & (mgr == 28))
    sums: dict[tuple, list] = {}
    for k_id, k_ok, name, name_ok, cents, c_ok in zip(
            bid[m], b_ok[m], brand[m], n_ok[m], price[m], pv[m]):
        key = (int(k_id) if k_ok else None, name if name_ok else None)
        acc = sums.setdefault(key, [0, 0])
        if c_ok:
            acc[0] += int(cents)
            acc[1] += 1
    want = sorted(
        ((k[0], k[1], v[0] if v[1] else None) for k, v in sums.items()),
        key=lambda r: (r[2] is None, -(r[2] or 0),
                       r[0] is None, r[0] or 0))[:100]
    # the revenue in cents, whether the engine returns it as a Decimal
    # or a float
    have = [(r[0], r[1], None if r[2] is None
             else int(decimal.Decimal(str(r[2])).scaleb(2))) for r in got]
    if have != want:
        raise AssertionError(f"Q55 rows differ from numpy: {have[:3]} vs "
                             f"{want[:3]}")
    if not want:
        raise AssertionError("Q55's month has no sales: pick another")


# -- why a TPC-DS query may be empty: each function counts, with numpy over
# the generator's arrays, the rows that could still produce an output row
# (a superset); an empty answer is right only when the count is 0


def _isin(conn, table: str, column: str, values) -> int:
    data, valid = _host(conn, table, column)
    return int((valid & np.isin(data, values)).sum())


def _nulls(conn, table: str, column: str, where=None) -> int:
    _data, valid = _host(conn, table, column)
    return int((~valid if where is None else (~valid & where)).sum())


def _date_parts(conn, table: str, column: str):
    sk, ok = _host(conn, table, column)
    year, y_ok = _dim(conn, "date_dim", "d_date_sk", sk, ok, "d_year")
    moy, m_ok = _dim(conn, "date_dim", "d_date_sk", sk, ok, "d_moy")
    return year, moy, y_ok & m_ok


def _store_cs_chain(conn, ss_when, sr_when, cs_when) -> int:
    """Q25/Q29's chain: store_sales rows (by sale date) returned (by
    return date, matched on ticket, item and customer) by a customer who
    bought the item from the catalog (by catalog sale date)."""
    def triples(table, ticket, item, cust, when):
        t, tv = _host(conn, table, ticket)
        i, iv = _host(conn, table, item)
        c, cv = _host(conn, table, cust)
        ok = tv & iv & cv & when
        return ((t[ok].astype(np.int64) << 38)
                | (i[ok].astype(np.int64) << 20) | c[ok].astype(np.int64))
    sold = triples("store_sales", "ss_ticket_number", "ss_item_sk",
                   "ss_customer_sk", ss_when)
    returned = triples("store_returns", "sr_ticket_number", "sr_item_sk",
                       "sr_customer_sk", sr_when)
    returned = returned[np.isin(returned, sold)]
    pairs = returned & ((1 << 38) - 1)  # (item, customer)
    i, iv = _host(conn, "catalog_sales", "cs_item_sk")
    c, cv = _host(conn, "catalog_sales", "cs_bill_customer_sk")
    ok = iv & cv & cs_when
    bought = (i[ok].astype(np.int64) << 20) | c[ok].astype(np.int64)
    return int(np.isin(pairs, bought).sum())


def _q25(conn) -> int:
    y1, m1, ok1 = _date_parts(conn, "store_sales", "ss_sold_date_sk")
    y2, m2, ok2 = _date_parts(conn, "store_returns", "sr_returned_date_sk")
    y3, m3, ok3 = _date_parts(conn, "catalog_sales", "cs_sold_date_sk")
    return _store_cs_chain(
        conn, ok1 & (m1 == 4) & (y1 == 2000),
        ok2 & (m2 >= 4) & (m2 <= 10) & (y2 == 2000),
        ok3 & (m3 >= 4) & (m3 <= 10) & (y3 == 2000))


def _q29(conn) -> int:
    y1, m1, ok1 = _date_parts(conn, "store_sales", "ss_sold_date_sk")
    y2, m2, ok2 = _date_parts(conn, "store_returns", "sr_returned_date_sk")
    y3, _m3, ok3 = _date_parts(conn, "catalog_sales", "cs_sold_date_sk")
    return _store_cs_chain(
        conn, ok1 & (m1 == 4) & (y1 == 1999),
        ok2 & (m2 >= 4) & (m2 <= 7) & (y2 == 1999),
        ok3 & np.isin(y3, [1999, 2000, 2001]))


def _q34(conn) -> int:
    # a (ticket, customer) group of 15 to 20 store_sales rows
    t, tv = _host(conn, "store_sales", "ss_ticket_number")
    c, cv = _host(conn, "store_sales", "ss_customer_sk")
    ok = tv & cv
    _keys, counts = np.unique((t[ok].astype(np.int64) << 21)
                              | c[ok].astype(np.int64), return_counts=True)
    return int(((counts >= 15) & (counts <= 20)).sum())


def _q39(conn) -> int:
    # a January (warehouse, item) group of 2001 whose quantity has a
    # coefficient of variation over 1.5
    year, moy, ok = _date_parts(conn, "inventory", "inv_date_sk")
    w, wv = _host(conn, "inventory", "inv_warehouse_sk")
    i, iv = _host(conn, "inventory", "inv_item_sk")
    q, qv = _host(conn, "inventory", "inv_quantity_on_hand")
    m = ok & wv & iv & qv & (year == 2001) & (moy == 1)
    _keys, group = np.unique((w[m].astype(np.int64) << 32)
                             | i[m].astype(np.int64), return_inverse=True)
    x = q[m].astype(np.float64)
    n = np.bincount(group)
    mean = np.bincount(group, x) / n
    var = (np.bincount(group, x * x) - n * mean * mean) / np.maximum(n - 1, 1)
    cov = np.sqrt(np.maximum(var, 0)) / np.where(mean == 0, np.inf, mean)
    return int(((n > 1) & (cov > 1.5)).sum())


def _q44(conn) -> int:
    # the HAVING threshold averages store 4's rows with a NULL address
    store, sv = _host(conn, "store_sales", "ss_store_sk")
    return _nulls(conn, "store_sales", "ss_addr_sk", sv & (store == 4))


def _q49(conn) -> int:
    # every branch keeps returns of more than 10000.00 only
    return sum(int(((_host(conn, t, c)[0] > 1_000_000)
                    & _host(conn, t, c)[1]).sum())
               for t, c in (("web_returns", "wr_return_amt"),
                            ("catalog_returns", "cr_return_amount"),
                            ("store_returns", "sr_return_amt")))


EMPTY_CHECKS = {
    "q10": lambda conn: _isin(conn, "customer_address", "ca_county", [
        "Rush County", "Toole County", "Jefferson County",
        "Dona Ana County", "La Porte County"]),
    "q24": lambda conn: _isin(conn, "item", "i_color", ["pale"]),
    "q25": _q25,
    "q29": _q29,
    "q34": _q34,
    "q39": _q39,
    "q44": _q44,
    "q49": _q49,
    "q73": lambda conn: _isin(conn, "store", "s_county", [
        "Williamson County", "Franklin Parish", "Bronx County",
        "Orange County"]),
    # every branch keeps rows with a NULL foreign key only
    "q76": lambda conn: (_nulls(conn, "store_sales", "ss_store_sk")
                         + _nulls(conn, "web_sales", "ws_ship_customer_sk")
                         + _nulls(conn, "catalog_sales", "cs_ship_addr_sk")),
}


def tpcds_phase(scale: float, seed: int) -> dict:
    """The 101 TPC-DS queries on both backends at ``scale``."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    queries = tpcds_queries()
    t0 = time.perf_counter()
    conn = TpcdsConnector(scale=scale, seed=seed)
    for name in conn.table_names():
        conn.table(name)
    log(f"tpcds datagen scale={scale:g} seed={seed}: "
        f"{time.perf_counter() - t0:.1f} s, store_sales "
        f"{conn.table('store_sales').nrows} rows, "
        f"{sum(conn.table(n).nrows for n in conn.table_names())} in all")
    engine = Engine()
    engine.register_catalog("tpcds", conn)
    engine.session.catalog = "tpcds"
    fits = {q: sql for q, sql in queries.items()
            if q not in TPCDS_OVER_MEMORY}
    (rows, secs, notes, launches, plain_rows, plain_secs,
     plain_notes) = sweep(engine, fits)
    # every query's faults, collected, then raised together
    faults = []
    for q in fits:
        if rows[q] != plain_rows[q]:
            faults.append(f"{q}: cuda and torch backends differ")
        if not rows[q]:
            if q not in EMPTY_CHECKS:
                faults.append(f"{q}: no rows, and no numpy check of why")
            elif EMPTY_CHECKS[q](conn):
                faults.append(f"{q}: no rows, but numpy finds "
                              f"{EMPTY_CHECKS[q](conn)} that could make one")
            else:
                log(f"tpcds {q}: no rows, and numpy finds none that could "
                    "make one")
        if q in TPCDS_QUERY_KERNELS and TPCDS_QUERY_KERNELS[q] not in \
                notes[q]["kernels"]:
            faults.append(f"{q} did not run {TPCDS_QUERY_KERNELS[q]}: "
                          f"{notes[q]['kernels']}")
        log("tpcds " + json.dumps({
            "query": q, "rows": len(rows[q]), "s": secs[q],
            "plain_s": plain_secs[q], **notes[q],
            "plain_kernels": plain_notes[q]["kernels"]}))
    log(f"tpcds cuda pass: {sum(secs.values()):.2f} s, plain pass: "
        f"{sum(plain_secs.values()):.2f} s, peak "
        f"{max(n['peak_gb'] for n in notes.values()):.2f} GB")
    log("tpcds launches " + json.dumps(launches))
    if faults:
        raise AssertionError("TPC-DS faults:\n" + "\n".join(faults))
    check_q96(conn, rows["q96"])
    check_q55(conn, rows["q55"])
    log("independent numpy checks of Q96 and Q55: ok")
    for q, blocker in TPCDS_OVER_MEMORY.items():
        require_over_memory(engine, q, queries[q], blocker,
                            {"expanding_join_rows": q72_expansion(conn)}
                            if q == "q72" else {})
    return launches


def q72_expansion(conn) -> int:
    """The rows of q72's join of catalog_sales with inventory on the
    item alone (each sale meets every inventory row of its item),
    counted with numpy over the generator's arrays."""
    item, ok = _host(conn, "catalog_sales", "cs_item_sk")
    inv, inv_ok = _host(conn, "inventory", "inv_item_sk")
    per_item = np.bincount(inv[inv_ok].astype(np.int64))
    sold = item[ok].astype(np.int64)
    sold = sold[sold < len(per_item)]
    return int(per_item[sold].sum())


def require_over_memory(engine, q: str, sql: str, blocker: str,
                        measured: dict) -> None:
    """Run ``q`` on both backends and require the card's out-of-memory
    error; the memory it held is released before the next run."""
    import torch
    for backend in ("cuda", "torch"):
        engine.session.set("kernel_backend", backend)
        torch.cuda.reset_peak_memory_stats()
        fitted = True
        try:
            engine.execute(sql)
        except torch.OutOfMemoryError:
            fitted = False
        peak = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        if fitted:
            raise AssertionError(
                f"{q} now fits on the card ({backend}, peak {peak:.2f} "
                "GB): run it with the others, drop it from "
                "TPCDS_OVER_MEMORY")
        log("tpcds " + json.dumps({"query": q, "backend": backend,
                                   "out_of_memory_at_gb": peak,
                                   **measured, "blocker": blocker}))


# -- phase 5: the function library at SF10 -----------------------------------

# the queries of the functions phase (tests/test_torch_functions.py and
# tests/test_torch_sketches.py run them at SF0.01 against sqlite and
# presto_tpu): F1-F3 fold every new aggregate and the sketches (HLL
# registers through segment_max, the percentile reservoir through
# segment_min), F4-F7 the date, string, number and varchar-to-number
# functions
FUNCTION_QUERIES = {
    "F1": """
select l_returnflag, l_linestatus, count_if(l_discount > 0.05) as ci,
  bool_and(l_quantity < 50) as ba, bool_or(l_tax = 0) as bo,
  every(l_shipdate < l_receiptdate) as ev, approx_distinct(l_partkey) as ad,
  approx_percentile(l_extendedprice, 0.5) as p50,
  min_by(l_orderkey, l_extendedprice) as mnb,
  max_by(l_orderkey, l_extendedprice) as mxb,
  corr(l_quantity, l_extendedprice) as co,
  covar_samp(l_quantity, l_extendedprice) as cs,
  regr_slope(l_quantity, l_extendedprice) as rs,
  skewness(l_discount) as sk, kurtosis(l_discount) as ku,
  geometric_mean(l_quantity) as gm, checksum(l_orderkey) as ck
from lineitem
group by 1, 2
order by 1, 2""",
    "F2": """
select approx_distinct(l_orderkey) as ad,
  approx_percentile(l_quantity, 0.9) as p90
from lineitem""",
    "F3": """
select l_suppkey % 512 as g, approx_distinct(l_partkey) as ad,
  approx_percentile(l_extendedprice, 0.25) as p25
from lineitem
group by 1
order by 1""",
    "F4_dates": """
select year(l_shipdate) as y, quarter(l_shipdate) as q,
  month(l_shipdate) as m, day_of_week(l_shipdate) as w,
  sum(date_diff('day', l_shipdate, l_receiptdate)) as d,
  min(date_add('month', 1, l_shipdate)) as a,
  max(date_trunc('month', l_commitdate)) as t
from lineitem
group by 1, 2, 3, 4
order by 1, 2, 3, 4""",
    "F4_date_format": """
select date_format(o_orderdate, '%Y') as y, count(*) as c
from orders
group by 1
order by 1""",
    "F5": """
select split_part(p_type, ' ', 2) as t, starts_with(p_container, 'SM') as sm,
  regexp_extract(p_name, '^([a-z]+)', 1) as w, count(*) as c,
  sum(l_quantity) as q, sum(length(p_name)) as n,
  sum(strpos(p_name, 'green')) as g, max(lpad(p_brand, 12, '*')) as b,
  min(replace(p_type, 'BRASS', 'B')) as r
from lineitem, part
where l_partkey = p_partkey
group by 1, 2, 3
order by 1, 2, 3""",
    "F6": """
select sign(l_quantity - 25) as s,
  width_bucket(l_extendedprice, 0, 110000, 10) as wb,
  floor(sqrt(l_quantity)) as f, bitwise_and(l_orderkey, 255) % 3 as b,
  count(*) as c, sum(ln(l_quantity)) as lq, sum(power(l_discount, 2)) as p2
from lineitem
group by 1, 2, 3, 4
order by 1, 2, 3, 4""",
    "F7": """
select cast(split_part(c_phone, '-', 1) as bigint) as cc, count(*) as c
from customer
group by 1
order by 1""",
}
# columns finalized from float states, which sum with index_add_ (atomics
# on the card): their last bits may differ between runs and backends, so
# they agree within a relative 1e-9, with an absolute 1e-12 beside it
# for the dimensionless statistics near zero (a symmetric column's
# skewness, about 1e-5, is a small difference of large cubes, and a
# reordered sum moves its ninth digit); every other column is identical
FLOAT_STATE_COLUMNS = {"F1": (10, 11, 12, 13, 14, 15), "F6": (5, 6)}
FLOAT_STATE_RTOL = 1e-9
FLOAT_STATE_ATOL = 1e-12
# the queries whose folds must reach both extremum kernels
SKETCH_QUERIES = ("F1", "F2", "F3")
HLL_SE = 1.04 / 2048 ** 0.5  # HyperLogLog's standard error, p = 11


def floats_agree(a, b) -> bool:
    """Two values of a float-state column agree (both NULL, or within
    FLOAT_STATE_RTOL relative and FLOAT_STATE_ATOL absolute)."""
    if a is None or b is None:
        return a is b
    return abs(a - b) <= (FLOAT_STATE_RTOL * max(abs(a), abs(b))
                          + FLOAT_STATE_ATOL)


def rows_agree(q: str, got: list, want: list) -> bool:
    """Identical rows, but for FLOAT_STATE_COLUMNS (floats_agree)."""
    floats = FLOAT_STATE_COLUMNS.get(q, ())
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            if not (floats_agree(a, b) if i in floats else a == b):
                return False
    return True


def np_splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64's finalizer over uint64 (wrapping)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _close(name: str, got: float, want: float, rtol: float) -> None:
    if not abs(got - want) <= rtol * max(abs(want), 1e-300):
        raise AssertionError(f"{name}: {got} != numpy {want} (rtol {rtol})")


def check_functions(conn, rows: dict) -> None:
    """The functions phase's answers recomputed with numpy over the
    generator's arrays: F1's counts, bools and checksums exactly, its
    sketches within their error, its min_by/max_by rows among those
    attaining the extremum, its corr and skewness within 1e-9; F2's
    sketches; F4's date_format groups against the years; F6's sign
    groups; F7 exactly."""
    li = conn.table("lineitem").columns
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    group = (np.asarray(rf.data).astype(np.int64) * len(ls.dictionary)
             + np.asarray(ls.data))
    qty = np.asarray(li["l_quantity"].data)
    price = np.asarray(li["l_extendedprice"].data)
    disc = np.asarray(li["l_discount"].data)
    tax = np.asarray(li["l_tax"].data)
    okey = np.asarray(li["l_orderkey"].data)
    part = np.asarray(li["l_partkey"].data).astype(np.int64)
    ship = np.asarray(li["l_shipdate"].data)
    receipt = np.asarray(li["l_receiptdate"].data)
    nparts = int(part.max()) + 1
    present = np.bincount(group * nparts + part,
                          minlength=6 * nparts).reshape(-1, nparts) > 0
    hashes = np_splitmix64(okey.astype(np.int64).view(np.uint64))
    for row in rows["F1"]:
        g = (list(rf.dictionary).index(row[0]) * len(ls.dictionary)
             + list(ls.dictionary).index(row[1]))
        m = group == g
        exact = (int((disc[m] > 5).sum()), bool((qty[m] < 5000).all()),
                 bool((tax[m] == 0).any()),
                 bool((ship[m] < receipt[m]).all()))
        if tuple(row[2:6]) != exact:
            raise AssertionError(f"F1 {row[:2]}: {row[2:6]} != numpy "
                                 f"{exact}")
        distinct = int(present[g].sum())
        if abs(row[6] - distinct) > 4 * HLL_SE * distinct:
            raise AssertionError(f"F1 {row[:2]}: approx_distinct {row[6]}"
                                 f" vs exact {distinct}")
        p = price[m] / 100.0
        rank = float((p <= float(row[7])).mean())
        if abs(rank - 0.5) > 0.06:
            raise AssertionError(f"F1 {row[:2]}: percentile rank {rank}")
        if row[8] not in set(okey[m][p == p.min()].tolist()) or \
                row[9] not in set(okey[m][p == p.max()].tolist()):
            raise AssertionError(f"F1 {row[:2]}: min_by/max_by rows "
                                 f"{row[8:10]} attain no extremum")
        q = qty[m] / 100.0
        _close(f"F1 {row[:2]} corr", row[10], float(np.corrcoef(q, p)[0, 1]),
               1e-9)
        # a near-symmetric group's skewness is a small difference of
        # large cubes: within 1e-9 of the skewness of |x - mean|, the
        # size of the terms that cancel (the port's two-pass sum, the
        # reference's, carries the mean's rounding into it)
        d = disc[m] / 100.0 - (disc[m] / 100.0).mean()
        m2 = (d ** 2).sum() ** 1.5 / np.sqrt(len(d))
        skew, scale = (d ** 3).sum() / m2, (np.abs(d) ** 3).sum() / m2
        if not abs(row[13] - skew) <= 1e-9 * max(abs(skew), scale):
            raise AssertionError(f"F1 {row[:2]}: skewness {row[13]} != "
                                 f"numpy {skew} (1e-9 of {scale})")
        ck = int(hashes[m].sum(dtype=np.uint64).view(np.int64))
        if row[16] != ck:
            raise AssertionError(f"F1 {row[:2]}: checksum {row[16]} != "
                                 f"numpy {ck}")
    (ad, p90), = rows["F2"]
    distinct = len(np.unique(okey))
    if abs(ad - distinct) > 4 * HLL_SE * distinct:
        raise AssertionError(f"F2: approx_distinct {ad} vs exact {distinct}")
    rank = float((qty / 100.0 <= float(p90)).mean())
    if abs(rank - 0.9) > 0.06:
        raise AssertionError(f"F2: percentile rank {rank}")
    if len(rows["F3"]) != 512:
        raise AssertionError(f"F3: {len(rows['F3'])} groups, not 512")
    odate = np.asarray(conn.table("orders").columns["o_orderdate"].data)
    years = odate.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    yv, yc = np.unique(years, return_counts=True)
    want = [(str(y), int(c)) for y, c in zip(yv, yc)]
    if len(want) != 7 or [(r[0], int(r[1])) for r in
                          rows["F4_date_format"]] != want:
        raise AssertionError(f"F4 date_format groups "
                             f"{rows['F4_date_format']} != years {want}")
    signs = {}
    for r in rows["F6"]:
        signs[r[0]] = signs.get(r[0], 0) + int(r[4])
    sv, sc = np.unique(np.sign(qty.astype(np.int64) - 2500),
                       return_counts=True)
    if signs != {int(v): int(c) for v, c in zip(sv, sc)}:
        raise AssertionError(f"F6 sign groups {signs} != numpy")
    phone = conn.table("customer").columns["c_phone"]
    text = np.asarray(phone.dictionary, dtype=object)[np.asarray(phone.data)]
    cc = np.array([int(s.split("-", 1)[0]) for s in text])
    cv, cn = np.unique(cc, return_counts=True)
    if [(int(a), int(b)) for a, b in rows["F7"]] != \
            [(int(a), int(b)) for a, b in zip(cv, cn)]:
        raise AssertionError("F7 country codes differ from numpy")


def sketch_folds(engine, sql: str) -> dict:
    """The inputs of the widest segment_max and segment_min fold of one
    cuda run of ``sql`` (captured, not timed)."""
    from presto_tpu_torch.ops import segred
    widest: dict = {}
    wrapped = {name: getattr(segred, name)
               for name in ("segment_max", "segment_min")}

    def capture(name):
        def fold(data, segment_ids, num_segments):
            if num_segments > widest.get(name, (0,))[0]:
                widest[name] = (num_segments, data, segment_ids)
            return wrapped[name](data, segment_ids, num_segments)
        return fold
    engine.session.set("kernel_backend", "cuda")
    try:
        for name in wrapped:
            setattr(segred, name, capture(name))
        engine.execute(sql)
    finally:
        for name, fn in wrapped.items():
            setattr(segred, name, fn)
    return widest


def functions_phase(conn) -> dict:
    """The FUNCTION_QUERIES on both backends at SF10."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch.kernels import segagg as SA

    engine = Engine()
    engine.register_catalog("tpch", conn)
    (rows, secs, notes, launches, plain_rows, plain_secs,
     plain_notes) = sweep(engine, FUNCTION_QUERIES)
    faults = []
    for q in FUNCTION_QUERIES:
        if not rows_agree(q, rows[q], plain_rows[q]):
            faults.append(f"{q}: cuda and torch backends differ")
        if not rows[q]:
            faults.append(f"{q}: no rows")
        if q in SKETCH_QUERIES:
            for tag in ("cuda:agg_max", "cuda:agg_min"):
                if tag not in notes[q]["kernels"]:
                    faults.append(f"{q} did not run {tag}: "
                                  f"{notes[q]['kernels']}")
        log("functions " + json.dumps({
            "query": q, "rows": len(rows[q]), "s": secs[q],
            "plain_s": plain_secs[q], **notes[q],
            "plain_kernels": plain_notes[q]["kernels"]}))
    log(f"functions cuda pass: {sum(secs.values()):.2f} s, plain pass: "
        f"{sum(plain_secs.values()):.2f} s")
    log("functions launches " + json.dumps(launches))
    if launches.get("segment_min", 0) < 1:
        faults.append(f"segment_min never launched: {launches}")
    if faults:
        raise AssertionError("functions faults:\n" + "\n".join(faults))
    check_functions(conn, rows)
    log("independent numpy checks of F1, F2, F3, F4, F6 and F7: ok")
    # F3's widest register and reservoir folds, each kernel against its
    # plain version and timed there (the kernel phase's k = 1<<20 case
    # is random ids over 60M rows)
    for name, (k, data, ids) in sorted(sketch_folds(
            engine, FUNCTION_QUERIES["F3"]).items()):
        kernel = getattr(SA, f"{name}_cuda")
        plain = getattr(SA, f"{name}_torch")
        err = require_equal(f"F3 {name} k={k}",
                            [(kernel(data, ids, k), plain(data, ids, k))])
        b_ms, b_by = bound(data.shape[0] * (data.element_size() + 4)
                           + k * data.element_size(), data.shape[0])
        log("functions kernel " + json.dumps({
            "name": name, "query": "F3", "k": k, "rows": data.shape[0],
            "dtype": str(data.dtype), "max_abs_err": err,
            "ms": cuda_ms(lambda: kernel(data, ids, k)),
            "plain_ms": cuda_ms(lambda: plain(data, ids, k)),
            "bound_ms": b_ms, "bound_by": b_by}))
    return launches


# phase 6: ARRAY and MAP values, lambdas, UNNEST, the variable-length
# aggregates and MATCH_RECOGNIZE at SF10
ARRAY_QUERIES = {
    # word counts over part names through the part-partsupp join: 8M
    # joined rows unnest to 40M words
    "A1": """
select w, count(*) as c, sum(ps_availqty) as q
from part, partsupp, unnest(split(p_name, ' ')) t(w)
where p_partkey = ps_partkey
group by w
order by w""",
    # an ARRAY group key, made below the aggregate-input split: the
    # segment carrier holds it with its $len and $emask companions
    "A2": """
select a, cardinality(a) as n, count(*) as c, sum(ps_availqty) as q
from (select array[p_size % 5, p_size % 3, ps_availqty % 2] as a,
        ps_availqty
      from part, partsupp
      where p_partkey = ps_partkey and p_size < 10)
group by a
order by element_at(a, 1), element_at(a, 2), element_at(a, 3)""",
    # lambdas and array scalars over every lineitem row
    "A3": """
select
  sum(reduce(filter(array[l_partkey, l_suppkey, l_linenumber],
                    x -> x % 3 <> 0),
             cast(0 as bigint), (a, x) -> a + x)) as r,
  count_if(any_match(array[l_linenumber, l_suppkey % 50], x -> x > 45)) as am,
  sum(array_max(array[l_partkey % 1000, l_suppkey % 1000, l_linenumber]))
    as mx,
  sum(array_position(array_sort(array[l_suppkey % 10, l_linenumber,
                                      l_partkey % 10]), l_linenumber)) as ps,
  sum(cardinality(array_distinct(array[l_partkey % 4, l_suppkey % 4,
                                       l_linenumber % 4]))) as cd
from lineitem""",
    "A3_map": """
select sum(element_at(map(array['F', 'O', 'P'], array[1, 2, 3]),
                      o_orderstatus)) as m, count(*) as c
from orders""",
    # array_agg over 15M orders by customer, read through the host-table
    # carrier by cardinality and grouped by it
    "A4": """
select cardinality(ks) as n, count(*) as c
from (select o_custkey, array_agg(o_orderkey order by o_orderdate) as ks
      from orders group by o_custkey)
group by 1
order by 1""",
    "A4_names": """
select r_name, listagg(n_name, ',') within group (order by n_name desc)
         as ns,
       map_agg(n_name, n_nationkey) as m
from nation, region
where n_regionkey = r_regionkey
group by r_name
order by r_name""",
    # tests/test_match_recognize.py's V shape over orders: the orders of
    # the customers o_custkey <= MR_CUT_CUSTKEY (the catalog "cut")
    "A5": """
select count(*) as matches, sum(mno) as mnos, sum(k1 - k0) as span,
  sum(p1) as p
from cut.orders match_recognize (
  partition by o_custkey order by o_orderdate, o_orderkey
  measures first(o_orderkey) as k0, last(o_orderkey) as k1,
           last(o_totalprice) as p1, match_number() as mno
  one row per match
  after match skip past last row
  pattern (strt down+ up+)
  define down as o_totalprice < prev(o_totalprice),
         up as o_totalprice > prev(o_totalprice))""",
}
# the kernel each query must run on the card (A4 groups by the sorted
# path's scans: none)
ARRAY_QUERY_KERNELS = {"A1": "cuda:agg_sum", "A2": "cuda:compact",
                       "A3": "cuda:agg_sum", "A3_map": "cuda:agg_sum",
                       "A4_names": "cuda:agg_sum", "A5": "cuda:agg_sum"}
# A5's cut: the host NFA is the reference's per-position loop, so the
# pattern runs over SF1's worth of orders (1.5M), not SF10's 15M
MR_CUT_CUSTKEY = 150_000


def cut_orders(conn):
    """Catalog "cut": a memory table ``orders`` holding the generator's
    orders of the customers o_custkey <= MR_CUT_CUSTKEY (A5)."""
    from presto_tpu_torch.connectors.memory import MemoryConnector
    o = conn.table("orders").columns
    keep = np.asarray(o["o_custkey"].data) <= MR_CUT_CUSTKEY
    cols = ("o_custkey", "o_orderkey", "o_orderdate", "o_totalprice")
    cut = MemoryConnector()
    cut.create_table("orders", {c: o[c].dtype for c in cols},
                     {c: np.asarray(o[c].data)[keep] for c in cols},
                     {c: None for c in cols})
    return cut


def carrier_types(engine, sql: str) -> list:
    """The segment carriers one cuda run of ``sql`` makes: each
    carrier's arrays with their dtypes and shapes (captured, not
    timed)."""
    from presto_tpu_torch.exec import executor as EX
    made = []
    run_plan_device = EX.run_plan_device

    def recording(*args, **kw):
        made.append(run_plan_device(*args, **kw))
        return made[-1]
    engine.session.set("kernel_backend", "cuda")
    EX.run_plan_device = recording
    try:
        engine.execute(sql)
    finally:
        EX.run_plan_device = run_plan_device
    return [{name: f"{str(a.dtype).replace('torch.', '')}"
             f"{list(a.shape)}" for name, a in c.arrays.items()}
            for c in made]


def _v_shapes(cust, price, key):
    """A5 recomputed without the engine: over rows sorted by customer,
    the V shapes ``strt down+ up+`` found greedily left to right, each
    match skipping past its last row. (count, sum of match numbers,
    sum of last - first orderkey, sum of last prices)."""
    n = len(price)
    down = np.zeros(n, bool)
    up = np.zeros(n, bool)
    same = np.zeros(n, bool)
    same[1:] = cust[1:] == cust[:-1]
    down[1:] = same[1:] & (price[1:] < price[:-1])
    up[1:] = same[1:] & (price[1:] > price[:-1])
    count = mnos = span = total = 0
    i = 0
    number = 0
    while i < n:
        if i == 0 or not same[i]:
            number = 0
        j = i + 1
        while j < n and down[j]:
            j += 1
        k = j
        while j > i + 1 and k < n and up[k]:
            k += 1
        if j > i + 1 and k > j:
            number += 1
            count += 1
            mnos += number
            span += int(key[k - 1]) - int(key[i])
            total += int(price[k - 1])
            i = k
        else:
            i += 1
    return count, mnos, span, total


def check_arrays(conn, cut, rows: dict) -> None:
    """Phase 6's answers recomputed with numpy (and plain python for the
    names and the V shapes) over the generator's arrays."""
    pa = conn.table("part").columns
    ps = conn.table("partsupp").columns
    li = conn.table("lineitem").columns
    od = conn.table("orders").columns
    ps_part = np.asarray(ps["ps_partkey"].data).astype(np.int64)
    avail = np.asarray(ps["ps_availqty"].data).astype(np.int64)
    p_key = np.asarray(pa["p_partkey"].data).astype(np.int64)
    nparts = int(p_key.max()) + 1
    per_part_rows = np.bincount(ps_part, minlength=nparts)
    per_part_avail = np.bincount(ps_part, weights=avail, minlength=nparts)
    # A1: each word of each name, weighted by its part's partsupp rows
    names = pa["p_name"]
    codes = np.asarray(names.data)
    per_code_rows = np.bincount(codes, weights=per_part_rows[p_key],
                                minlength=len(names.dictionary))
    per_code_avail = np.bincount(codes, weights=per_part_avail[p_key],
                                 minlength=len(names.dictionary))
    words: dict = {}
    for c in np.flatnonzero(per_code_rows):
        for w in str(names.dictionary[c]).split(" "):
            n0, q0 = words.get(w, (0, 0))
            words[w] = (n0 + int(per_code_rows[c]),
                        q0 + int(per_code_avail[c]))
    want = sorted((w, n, q) for w, (n, q) in words.items())
    if [(w, int(n), int(q)) for w, n, q in rows["A1"]] != want:
        raise AssertionError("A1 word counts differ from numpy")
    # A2: the array key's groups
    size = np.zeros(nparts, np.int64)
    size[p_key] = np.asarray(pa["p_size"].data)
    s = size[ps_part]
    m = s < 10
    key = np.stack([s[m] % 5, s[m] % 3, avail[m] % 2], axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    want = [(list(map(int, u)), 3, int(c), int(q)) for u, c, q in zip(
        uniq, np.bincount(inv), np.bincount(inv, weights=avail[m]))]
    have = [([int(x) for x in a], int(n), int(c), int(q))
            for a, n, c, q in rows["A2"]]
    if have != want:
        raise AssertionError(f"A2 groups {have[:3]} != numpy {want[:3]}")
    # A3: every lambda and scalar, summed
    lp = np.asarray(li["l_partkey"].data).astype(np.int64)
    lsk = np.asarray(li["l_suppkey"].data).astype(np.int64)
    ln = np.asarray(li["l_linenumber"].data).astype(np.int64)
    r = sum(np.where(x % 3 != 0, x, 0).sum() for x in (lp, lsk, ln))
    am = int(((ln > 45) | (lsk % 50 > 45)).sum())
    mx = int(np.maximum(np.maximum(lp % 1000, lsk % 1000), ln).sum())
    srt = np.sort(np.stack([lsk % 10, ln, lp % 10], axis=1), axis=1)
    pos = int((np.argmax(srt == ln[:, None], axis=1) + 1).sum())
    del srt
    d4 = np.sort(np.stack([lp % 4, lsk % 4, ln % 4], axis=1), axis=1)
    cd = int((1 + (d4[:, 1:] != d4[:, :-1]).sum(axis=1)).sum())
    del d4
    if tuple(int(x) for x in rows["A3"][0]) != (int(r), am, mx, pos, cd):
        raise AssertionError(f"A3 {rows['A3'][0]} != numpy "
                             f"{(int(r), am, mx, pos, cd)}")
    status = od["o_orderstatus"]
    weight = np.array([{"F": 1, "O": 2, "P": 3}.get(str(x), 0)
                       for x in status.dictionary], np.int64)
    sc = np.asarray(status.data)
    if tuple(int(x) for x in rows["A3_map"][0]) != (
            int(weight[sc].sum()), len(sc)):
        raise AssertionError(f"A3_map {rows['A3_map'][0]} differs")
    # A4: customers by their order count
    per_cust = np.bincount(np.asarray(od["o_custkey"].data))
    hist = np.bincount(per_cust[per_cust > 0])
    want = [(k, int(c)) for k, c in enumerate(hist) if c]
    if [(int(n), int(c)) for n, c in rows["A4"]] != want:
        raise AssertionError("A4 histogram of orders per customer differs")
    na, re_ = conn.table("nation").columns, conn.table("region").columns
    nname, _ = _host(conn, "nation", "n_name")
    rname, _ = _host(conn, "region", "r_name")
    nreg = np.asarray(na["n_regionkey"].data)
    nkey = np.asarray(na["n_nationkey"].data)
    rkey = np.asarray(re_["r_regionkey"].data)
    want = []
    for rk, rn in sorted(zip(rkey, rname), key=lambda t: t[1]):
        sel = nreg == rk
        want.append((rn, ",".join(sorted(nname[sel], reverse=True)),
                     dict(zip(nname[sel], map(int, nkey[sel])))))
    if [(a, b, {k: int(v) for k, v in m.items()})
            for a, b, m in rows["A4_names"]] != want:
        raise AssertionError("A4_names differs from python")
    # A5: the V shapes, found without the engine
    co = cut.table("orders").columns
    cust = np.asarray(co["o_custkey"].data)
    order = np.lexsort((np.asarray(co["o_orderkey"].data),
                        np.asarray(co["o_orderdate"].data), cust))
    count, mnos, span, total = _v_shapes(
        cust[order], np.asarray(co["o_totalprice"].data)[order],
        np.asarray(co["o_orderkey"].data)[order])
    got = rows["A5"][0]
    if (int(got[0]), int(got[1]), int(got[2])) != (count, mnos, span) \
            or round(float(got[3]) * 100) != total:
        raise AssertionError(f"A5 {got} != python "
                             f"{(count, mnos, span, total / 100)}")


def arrays_phase(conn) -> dict:
    """The ARRAY_QUERIES on both backends at SF10."""
    from presto_tpu_torch import Engine

    engine = Engine()
    engine.register_catalog("tpch", conn)
    cut = cut_orders(conn)
    engine.register_catalog("cut", cut)
    (rows, secs, notes, launches, plain_rows, plain_secs,
     plain_notes) = sweep(engine, ARRAY_QUERIES)
    faults = []
    for q in ARRAY_QUERIES:
        if rows[q] != plain_rows[q]:
            faults.append(f"{q}: cuda and torch backends differ")
        if not rows[q]:
            faults.append(f"{q}: no rows")
        if q in ARRAY_QUERY_KERNELS and ARRAY_QUERY_KERNELS[q] not in \
                notes[q]["kernels"]:
            faults.append(f"{q} did not run {ARRAY_QUERY_KERNELS[q]}: "
                          f"{notes[q]['kernels']}")
        log("arrays " + json.dumps({
            "query": q, "rows": len(rows[q]), "s": secs[q],
            "plain_s": plain_secs[q], **notes[q],
            "plain_kernels": plain_notes[q]["kernels"]}))
    log(f"arrays cuda pass: {sum(secs.values()):.2f} s, plain pass: "
        f"{sum(plain_secs.values()):.2f} s")
    log("arrays launches " + json.dumps(launches))
    for name in ("segment_sum", "filter_compact"):
        if launches.get(name, 0) < 1:
            faults.append(f"{name} never launched: {launches}")
    if faults:
        raise AssertionError("arrays faults:\n" + "\n".join(faults))
    log("arrays A2 carriers " + json.dumps(
        carrier_types(engine, ARRAY_QUERIES["A2"])))
    check_arrays(conn, cut, rows)
    log("independent checks of A1-A5 (numpy, python): ok")
    return launches


# -- phase 7: the session's paths at SF10 ------------------------------------

# S2: a grouped aggregate with no join over orders (15M rows, under
# scan_block_rows, so it does not stream), by its 10,000 clerks: a
# dictionary key, so each partition groups by the direct path, whose
# counts and sums fold through segment_sum
SPILL_AGG_SQL = """
select o_clerk, count(*) as c, sum(o_totalprice) as s
from orders
group by o_clerk
order by s desc, o_clerk
limit 10"""
# S3: tests/test_connector_partitioning.py's grouped-execution query
GROUPED_SQL = """
select o_orderpriority, count(*) as c, sum(l_quantity) as q
from orders, lineitem
where o_orderkey = l_orderkey
group by o_orderpriority order by o_orderpriority"""
# S4: Q6 with its two dates as parameters ({lo} and {hi})
Q6_DATED = TPCH["q06"].replace(
    "date '1994-01-01' + interval '1' year", "{hi}").replace(
    "date '1994-01-01'", "{lo}")
Q6_DATES = (("1994-01-01", "1995-01-01"), ("1996-01-01", "1997-01-01"))
Q18_VARIANT = ("> 300", "> 312")
SEGMENT_LINE = re.compile(r"^Segment (\d+) \(([\d.]+) ms, (\d+) live rows "
                          r"-> (s\d+\[\d+\])\)$", re.M)
NODE_ROWS = re.compile(r"  \[rows: (\d+)(?: \(est \d+\))?\]$", re.M)


def timed(engine, sql: str, **props) -> dict:
    """One run of ``sql`` with session ``props`` set for it (restored
    after): rows, wall seconds (a synchronize on either side), rungs,
    programs from memory, kernels, peak device GB."""
    import torch
    before = {k: engine.session.get(k) for k in props}
    for k, v in props.items():
        engine.session.set(k, v)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rows = engine.execute(sql)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        for k, v in before.items():
            engine.session.set(k, v)
    run = engine.last_run
    return {"rows": rows, "s": secs, "rungs": run.rungs,
            "programs": len(run.programs),
            "from_memory": sum(run.from_memory),
            "kernels": sorted({t for tags in
                               engine.last_kernel_notes.values()
                               for t in tags}),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _line(case: str, backend: str, got: dict, **more) -> None:
    log("session " + json.dumps({
        "case": case, "backend": backend,
        **{k: v for k, v in got.items() if k != "rows"},
        "result_rows": len(got["rows"]), **more}))


def explained_rows(text: str) -> list[int]:
    """Every annotated node's actual rows, in the order printed."""
    return [int(r) for r in NODE_ROWS.findall(text)]


def plain_node_rows(engine) -> list[int]:
    """The node rows of the engine's last run, program by program in
    preorder: the order EXPLAIN ANALYZE prints them."""
    from presto_tpu_torch.exec import executor as EX
    run = engine.last_run
    return [run.node_rows[(i, pos)]
            for i, plan in enumerate(run.programs)
            for pos, _node in enumerate(EX._preorder(plan))]


def session_cases(conn, backend: str, q01_rows) -> dict:
    """S1-S6 on one backend, each on a fresh engine over ``conn``:
    {case: rows}. Faults raise."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.exec import cancel as C
    from presto_tpu_torch.memory import (MemoryLimitExceeded,
                                         estimate_plan_memory)

    def engine():
        e = Engine()
        e.register_catalog("tpch", conn)
        e.session.set("kernel_backend", backend)
        return e

    cuda = backend == "cuda"
    out = {}

    # S1: the join of lineitem_partsupp under a quarter of its estimate
    e = engine()
    sql = QUERIES["lineitem_partsupp"]
    total, _ = estimate_plan_memory(e.plan_sql(sql)[0], e)
    whole = timed(e, sql)
    spilled = timed(e, sql, query_max_memory_bytes=total // 4)
    spill = e.last_spill
    if not spill or spill["partitions"] < 2:
        raise AssertionError(f"S1 did not spill: {spill}")
    if spilled["rows"] != whole["rows"]:
        raise AssertionError("S1: spilled rows differ from the whole run")
    if cuda and "cuda:join_lookup" not in spilled["kernels"]:
        raise AssertionError(f"S1 did not run cuda:join_lookup: {spilled}")
    _line("S1 whole", backend, whole, estimated_bytes=total)
    _line("S1 spilled", backend, spilled, **spill)
    out["S1"] = spilled["rows"]

    # S2: an aggregation spill over orders; without spill it must fail
    total, _ = estimate_plan_memory(e.plan_sql(SPILL_AGG_SQL)[0], e)
    whole = timed(e, SPILL_AGG_SQL)
    spilled = timed(e, SPILL_AGG_SQL, query_max_memory_bytes=total // 4)
    spill = e.last_spill
    if not spill or spill.get("kind") != "aggregate":
        raise AssertionError(f"S2 did not spill the aggregate: {spill}")
    if spilled["rows"] != whole["rows"]:
        raise AssertionError("S2: spilled rows differ from the whole run")
    if cuda and "cuda:agg_sum" not in spilled["kernels"]:
        raise AssertionError(f"S2 did not run cuda:agg_sum: {spilled}")
    try:
        timed(e, SPILL_AGG_SQL, query_max_memory_bytes=total // 4,
              spill_enabled=False)
    except MemoryLimitExceeded as exc:
        refused = str(exc)
    else:
        raise AssertionError("S2 ran over its budget with spill disabled")
    _line("S2 whole", backend, whole, estimated_bytes=total)
    _line("S2 spilled", backend, spilled, **spill, without_spill=refused)
    out["S2"] = spilled["rows"]
    del e

    # S3: grouped execution, 8 buckets, against the default route
    e = engine()
    whole = timed(e, GROUPED_SQL)
    grouped = timed(e, GROUPED_SQL, grouped_execution=True,
                    grouped_execution_partitions=8)
    if not e.last_grouped or e.last_grouped["partitions"] != 8:
        raise AssertionError(f"S3 did not run grouped: {e.last_grouped}")
    if grouped["rows"] != whole["rows"]:
        raise AssertionError("S3: grouped rows differ from the default")
    _line("S3 default", backend, whole)
    _line("S3 grouped", backend, grouped, **e.last_grouped)
    out["S3"] = grouped["rows"]
    del e

    # S4: the capacity memory and templates
    e = engine()
    q18 = TPCH["q18"]
    variant = q18.replace(*Q18_VARIANT)
    first = timed(e, q18)
    again = timed(e, q18)
    hits = TPL._TPL_HITS.value()
    var = timed(e, variant)
    hit = TPL._TPL_HITS.value() > hits
    fresh = timed(engine(), variant)
    # the repeat starts every program from memory; the variant's
    # literal moves the rows its later programs read, so a program past
    # a carrier whose width changed keys afresh (the carrier-width floor
    # is left out), but none may climb
    if again["rungs"] or again["from_memory"] != again["programs"]:
        raise AssertionError(f"S4 Q18 repeat climbed the ladder: {again}")
    if var["rungs"] or not var["from_memory"]:
        raise AssertionError(f"S4 Q18 variant climbed the ladder: {var}")
    if again["rows"] != first["rows"] or not hit \
            or var["rows"] != fresh["rows"]:
        raise AssertionError(f"S4: repeat rows, template hit {hit} or "
                             "the variant's rows against a fresh engine")
    _line("S4 q18 first", backend, first)
    _line("S4 q18 repeat", backend, again)
    _line("S4 q18 variant", backend, var, template_hit=hit)
    _line("S4 q18 variant, fresh engine", backend, fresh)
    e.execute("prepare q6 from " + Q6_DATED.format(lo="?", hi="?"))
    prepared = []
    for lo, hi in Q6_DATES:
        got = timed(e, f"execute q6 using date '{lo}', date '{hi}'")
        literal = e.execute(Q6_DATED.format(lo=f"date '{lo}'",
                                            hi=f"date '{hi}'"))
        if got["rows"] != literal:
            raise AssertionError(f"S4: EXECUTE q6 {lo} {hi} differs from "
                                 "its literal SQL")
        _line(f"S4 execute q6 {lo} {hi}", backend, got)
        prepared.append(got["rows"])
    out["S4"] = [first["rows"], var["rows"], prepared]
    del e

    # S5: EXPLAIN ANALYZE against a plain run's node rows
    e = engine()
    explained = {}
    for q in ("q05", "q21"):
        t = time.perf_counter()
        text = e.execute("explain analyze " + TPCH[q])[0][0]
        secs = time.perf_counter() - t
        segments = SEGMENT_LINE.findall(text)
        carriers = {tag for (i, key), tags in e.last_kernel_notes.items()
                    if key == "carrier" for tag in tags}
        want_segments = sum(map(len, e.last_run.segments))
        shown = explained_rows(text)
        e.execute(TPCH[q])
        if len(segments) != want_segments or not segments:
            raise AssertionError(f"S5 {q}: {len(segments)} segment "
                                 f"sections for {want_segments} segments")
        if shown != plain_node_rows(e):
            raise AssertionError(f"S5 {q}: annotated rows differ from the "
                                 "plain run's node rows")
        if cuda and q == "q21" and "cuda:compact" not in carriers:
            raise AssertionError(f"S5 q21's carriers were not compacted by "
                                 f"filter_compact: {carriers}")
        log("session " + json.dumps({
            "case": f"S5 explain analyze {q}", "backend": backend,
            "s": secs, "segments": len(segments), "nodes": len(shown),
            "carrier_kernels": sorted(carriers)}))
        for line in text.splitlines()[:6]:
            log(f"  {line[:160]}")
        explained[q] = shown
    out["S5"] = explained
    del e

    # S6: cancellation, then Q1 as before
    e = engine()
    before = e.execute(TPCH["q01"])
    try:
        timed(e, TPCH["q09"], query_max_run_time=0.001)
    except C.TimeLimitExceeded as exc:
        limited = str(exc)
    else:
        raise AssertionError("S6: q09 outran query_max_run_time=0.001")
    token = C.CancelToken()
    token.cancel()
    try:
        e.execute(TPCH["q09"], cancel_token=token)
    except C.QueryCanceled as exc:
        if isinstance(exc, C.TimeLimitExceeded):
            raise
        canceled = str(exc)
    else:
        raise AssertionError("S6: a cancelled token did not stop q09")
    after = e.execute(TPCH["q01"])
    if after != before or (q01_rows is not None and after != q01_rows):
        raise AssertionError("S6: Q1 after the cancellations differs")
    log("session " + json.dumps({"case": "S6", "backend": backend,
                                 "time_limit": limited,
                                 "canceled": canceled,
                                 "q01_after_equal": True}))
    out["S6"] = after
    return out


def session_phase(conn, q01_rows=None) -> dict:
    """S1-S6 on both backends at SF10: the cuda runs between a reset
    and a read of the launch counts, then the plain runs; every case's
    rows identical between them."""
    from presto_tpu_torch.kernels import build as B
    B.LAUNCHES.reset()
    t = time.perf_counter()
    got = session_cases(conn, "cuda", q01_rows)
    launches = B.LAUNCHES.snapshot()
    log(f"session cuda cases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    plain = session_cases(conn, "torch", q01_rows)
    log(f"session plain cases: {time.perf_counter() - t:.1f} s")
    differ = [case for case in got if got[case] != plain[case]]
    if differ:
        raise AssertionError(f"session cases differ between backends: "
                             f"{differ}")
    log("session launches " + json.dumps(launches))
    for name in ("segment_sum", "build_table", "probe_table",
                 "multijoin_walk", "filter_compact"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched in the session "
                                 f"phase: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phase in {args.phases!r}")

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

    kernels, launches, conn, tpch_rows = {}, {}, None, {}

    def add(more: dict) -> dict:
        return {name: launches.get(name, 0) + more.get(name, 0)
                for name in KERNELS}
    if "kernels" in phases:
        t = time.perf_counter()
        kernels = kernel_phase(dev, args.seed)
        log(f"kernel phase: {time.perf_counter() - t:.1f} s")
    if "tpch" in phases:
        t = time.perf_counter()
        conn = tpch_data(args.scale, args.seed)
        launches, _queries, tpch_rows = query_phase(conn)
        del _queries
        log(f"query phase: {time.perf_counter() - t:.1f} s")
    if "tpcds" in phases:
        # the TPC-H engine and its resident columns are gone by now (its
        # host tables stay for the functions phase)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches = add(tpcds_phase(TPCDS_SCALE, TPCDS_SEED))
        log(f"tpcds phase: {time.perf_counter() - t:.1f} s")
    if "functions" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        conn = conn or tpch_data(args.scale, args.seed)
        launches = add(functions_phase(conn))
        log(f"functions phase: {time.perf_counter() - t:.1f} s")
    if "arrays" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches = add(arrays_phase(conn or tpch_data(args.scale,
                                                      args.seed)))
        log(f"arrays phase: {time.perf_counter() - t:.1f} s")
    if "session" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches = add(session_phase(conn or tpch_data(args.scale,
                                                       args.seed),
                                     tpch_rows.get("q01")))
        log(f"session phase: {time.perf_counter() - t:.1f} s")
    if phases != set(PHASES):
        log(f"phases {sorted(phases)} passed; no summary without all "
            f"{len(PHASES)}")
        return 1

    summary = []
    for name, (source, replaces) in KERNELS.items():
        k = kernels[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"],
                        "library_ms": k["library_ms"],
                        "random_read_floor_ms":
                            k.get("random_read_floor_ms"),
                        "gather_floor_ms": k.get("gather_floor_ms"),
                        "redesigned_in": REDESIGNED_IN[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
