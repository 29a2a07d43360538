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
   every query runs with kernel_backend=cuda (the launch counts are
   reset just before this pass and read just after, and each query's
   peak device memory is read) and then with kernel_backend=torch;
   rows must be identical, and Q1/Q6 (and Q11's row count, which is
   0 at SF10) are checked against an independent numpy computation
   over the generator's arrays.
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
   with its blocker) runs last and must run out of memory.

    python3 chip_smoke.py --phases kernels,tpch,tpcds   # the default

runs the named phases only (a shorter call while a phase is worked on;
the summary line needs all three).

The queries are the repository's TPC-H texts (tests/tpch_queries.py)
and TPC-DS texts (tests/test_tpcds.py). The last lines are the card, a
JSON summary of the kernels (each with the PR that last redesigned it,
``redesigned_in``, and its launches summed over phases 3 and 4) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import decimal
import gc
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
# sweep reaches segment_min or filter_compact)
TPCDS_QUERY_KERNELS = {"q96": "cuda:agg_sum", "q42": "cuda:join_lookup",
                       "q07": "cuda:multijoin", "q23": "cuda:agg_max"}
# queries whose answer does not fit the card at scale 10, each with its
# blocker (ROADMAP Queue 3): the phase runs them on both backends last
# and requires the out-of-memory error, so that one that starts to fit
# is moved back into the sweep
TPCDS_OVER_MEMORY = {
    "q72": "its WHERE conjuncts on the dimensions stay above the LEFT "
           "joins, so catalog_sales (14.4M rows) expands through "
           "inventory on the item alone, about 626M rows (14.4M x 7.83M "
           "inventory rows / 180k items), before any "
           "filter (needs segmented execution, ROADMAP item 3f)",
}
TPCDS_SCALE = 10.0
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
    """The cuda pass that uploads the columns (uncounted), the timed
    cuda pass between a reset and a read of the launch counts, and the
    plain pass: (rows, secs, notes, launches, plain rows, plain secs,
    plain notes)."""
    from presto_tpu_torch.kernels import build as B
    t = time.perf_counter()
    run_queries(engine, queries, "cuda")
    log(f"first pass (column upload included): "
        f"{time.perf_counter() - t:.1f} s")
    B.LAUNCHES.reset()
    rows, secs, notes = run_queries(engine, queries, "cuda")
    launches = B.LAUNCHES.snapshot()
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
        passes0 = HS.SYNCS.by_site.get("ok-ladder", 0)
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
            "ok_ladder_syncs": HS.SYNCS.by_site.get("ok-ladder", 0)
            - passes0,
            # resident scan columns included
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return rows, secs, notes


def query_phase(scale: float, seed: int) -> tuple[dict, dict]:
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpch import TpchConnector

    t0 = time.perf_counter()
    conn = TpchConnector(scale=scale, seed=seed)
    for name in conn.table_names():
        conn.table(name)
    log(f"datagen sf={scale:g} seed={seed}: "
        f"{time.perf_counter() - t0:.1f} s")
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
    log("launches " + json.dumps(launches))
    return launches, queries


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
        require_over_memory(engine, q, queries[q], blocker)
    return launches


def require_over_memory(engine, q: str, sql: str, blocker: str) -> None:
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
                                   "blocker": blocker}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=19920101)
    ap.add_argument("--phases", default="kernels,tpch,tpcds",
                    help="comma-separated subset of kernels,tpch,tpcds")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= {"kernels", "tpch", "tpcds"}:
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

    kernels, launches = {}, {}
    if "kernels" in phases:
        t = time.perf_counter()
        kernels = kernel_phase(dev, args.seed)
        log(f"kernel phase: {time.perf_counter() - t:.1f} s")
    if "tpch" in phases:
        t = time.perf_counter()
        launches, _queries = query_phase(args.scale, args.seed)
        del _queries
        log(f"query phase: {time.perf_counter() - t:.1f} s")
    if "tpcds" in phases:
        # the TPC-H engine and its resident columns are gone by now
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ds_launches = tpcds_phase(TPCDS_SCALE, TPCDS_SEED)
        launches = {name: launches.get(name, 0) + ds_launches.get(name, 0)
                    for name in KERNELS}
        log(f"tpcds phase: {time.perf_counter() - t:.1f} s")
    if phases != {"kernels", "tpch", "tpcds"}:
        log(f"phases {sorted(phases)} passed; no summary without all three")
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
