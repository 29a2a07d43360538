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
PREPARE/EXECUTE, EXPLAIN ANALYZE and cancellation; and the statement
surface at SF10: CREATE TABLE AS, INSERT, DELETE, UPDATE, DROP TABLE,
transactions, the metadata catalogs, the query events and the bound of
the device cache; and distributed execution over 8 shards of the card
at SF10; and the cluster tier: four HTTP workers and a coordinator in
this process, every engine on the card; and the server tier: a
CoordinatorServer on a card engine, its serving layer, and cross-query
batches whose every kernel launches once for all lanes; and SQL over
parquet files at SF1; and the device observatory at SF10: a query's
torch.profiler capture, its device cost per operator in
system.operator_stats, a worker's profile endpoints and process gauges,
and the capacity-overflow counters.

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
   in phase 3: a first cuda pass that uploads the columns, then a
   timed cuda pass between a reset and a read of the launch counts;
   the kernel pinned for a query in ``TPCDS_QUERY_KERNELS`` run, no
   query empty unless numpy finds no row that could answer it
   (``EMPTY_CHECKS``), and Q96's count and Q55's brand sums equal a
   numpy computation over the generator's arrays. A query that does
   not fit the card (``TPCDS_OVER_MEMORY``, with its blocker) runs
   last on the card and must run out of memory; q72's line carries the
   rows of its expanding join, counted with numpy. The queries of
   ``TPCDS_PLAIN_QUERIES`` (cut from all 101) run again with
   kernel_backend=torch: rows identical to the card's.

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
   (A3), array_agg by customer of the orders of the customers
   o_custkey <= ``MR_CUT_CUSTKEY`` (the catalog "cut": 1.5M orders,
   SF1's worth, because the lists are built on the host) read by
   cardinality through the host-table carrier, and listagg and map_agg
   over nation and region (A4), and the V-shape MATCH_RECOGNIZE over
   the same orders (A5, because the pattern automaton is the
   reference's host loop).
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
8. Statements: the TPC-H tables again, each case on a fresh engine
   over one memory catalog, all of a backend's engines sharing one
   event manager, on the card (between a reset and a read of the
   launch counts, which the summary adds), then ST1-ST3 on the plain
   backend (cut from all seven). ST1 CREATE
   TABLE AS: memory.li from lineitem's eight numeric columns
   (59,986,052 rows), memory.ord from orders with its two VARCHAR
   columns (15M rows) and memory.ord_cut, the orders of o_custkey <=
   ``ST_CUT_CUSTKEY``; each with its row count, more than one writer
   task (``engine.last_write``) and the seconds of its query, its
   decode and its sink (``WriteClock``), and one scan of memory.ord
   timed, which re-encodes its strings on the host. ST2 ``ST_Q1`` (Q1's
   aggregates, ``cuda:agg_sum``) and ``ST_JOIN`` (memory.li joined to
   partsupp, ``cuda:join_lookup``) equal the same reads of lineitem.
   ST3 ``ST_UPDATE`` counts what numpy counts, writes a new l_quantity
   and the old one is no longer resident, and ST_Q1 then equals numpy
   over the updated column. ST5 ``ST_GROUP`` over memory.ord_cut: a repeat at the
   default limit holds two copies of the re-encoded column; under
   dev_cache_limit set to one and a half copies, ``ST_REPEATS``
   repeats keep the cached bytes under it and the peak after the last
   within 5% of the peak after the second. ST4 a DELETE in a rolled
   back transaction, an INSERT that doubles memory.ord_cut and DROP
   TABLE of every table, counts equal to numpy's, SHOW TABLES FROM
   memory empty. ST7 Q5 under query_max_planning_time=1e-9 raises
   TimeLimitExceeded with no kernel launched, then equals its phase-3
   rows. ST6 SHOW CATALOGS, DESCRIBE lineitem equal to SHOW COLUMNS,
   and system.runtime.queries holding every statement of the phase in
   order, ST7's Q5 the one FAILED. ST1-ST3's rows are identical on
   both backends; agg_sum and join_lookup must launch.
9. Distributed: the TPC-H tables again (phase 3's rows and times beside
   them; made and run once when phase 3 did not run), over
   ``LocalShardGroup(DIST_SHARDS, "cuda")``: 8 shards on the one card,
   each kernel launched once per shard on its rows. On each backend,
   on a fresh engine (the cuda runs between a reset and a read of the
   launch counts, which the summary adds): D1 the reference's
   ``DIST_QUERIES`` (tests/test_distributed.py), a cold run and a
   timed repeat, rows equal to phase 3's (floats within
   FLOAT_STATE_RTOL), the repeat with no rung and no scan upload; D2 Q3
   under PARTITIONED joins (``probe_exch`` and ``build_exch`` used,
   all_to_all called) and BROADCAST (neither), and lineitem_partsupp
   PARTITIONED through join_lookup; D3 ``DIST_SORT_SQL`` with
   distributed_sort on (one merge of 8 runs) and off, the same rows;
   D4 ``DIST_ORDERKEY_JOIN`` over bucket-sharded orders and lineitem
   with neither exchange, its repeat uploading no scan column nor row
   order; D6 EXPLAIN ANALYZE of Q5 over the shards; D5 a hybrid skew
   join and a salted join of Q3 on ``DIST_SKEW`` data at SF1 (reduced:
   a second SF10 dataset would double the generation time), rows equal
   to the local engine's. Every line carries the cold and timed
   seconds, rungs, syncs, uploads, collective calls and bytes by kind,
   the peak device GB and phase 3's local seconds; agg_sum,
   join_lookup and multijoin must run, and the two backends' rows
   agree.
10. Cluster: ``CLUSTER_WORKERS`` WorkerServers and a ClusterCoordinator
   in this process, every engine on the card, over loopback HTTP (the
   launch counts set to 0 just before each cluster query and read just
   after, so the single-engine runs the rows are held against stay
   out). C1 tests/
   test_cluster.py's ``QUERIES`` and Q6 (``CLUSTER_PARTIALS``) at the
   phase's scale, each in one stage of partial aggregates over the
   workers' row ranges; the Q1 shape's counts and Q6's revenue against
   numpy. C4 Q5 at that scale under ``PRESTO_TPU_WIRE=npz`` and
   ``arrow`` (where pyarrow imports), the native page codec loaded.
   C2 ``CLUSTER_FRAGMENTS`` as stage DAGs (the orders-lineitem join,
   Q3, Q5, Q9, lineitem_partsupp, Q3 PARTITIONED) and C3 Q5 under
   ``retry_policy=TASK`` over the spooled exchange with every task POST
   to w1 crashing, then with a 4 s straggler under speculation, and
   C5 tests/test_adaptive.py's poisoned-ledger re-plan, all three at
   ``CLUSTER_SMALL_SCALE`` (SF1, cut: at SF10 C2 alone took 61 s a
   pass), C5 held on rows, on its capacity rungs and on its records
   (``system.adaptive_decisions``, the annotated plan), and again at
   the reference test's SF0.01, where the join fits the re-costed
   capacity and the re-plan pays no rung. Rows
   equal phase 3's (or one engine's), floats within FLOAT_STATE_RTOL. Then
   one C1 and one C2 case at SF1 with the workers on the card and
   again on the CPU (the plain versions): equal rows. Each case's line
   carries cold and timed seconds beside phase 3's, the mode, stages
   and worker tasks, exchange pages and bytes by codec, the process's
   host syncs and uploads, launches, the worker operators' and the
   coordinator's kernel notes, the peak device GB and the system.tasks
   row count; segment_sum must launch on the workers (``cuda:agg_sum``).
11. Serving: each kernel entry's lane rule (kernels/lanes.py) under
   ``torch.func.vmap`` over 8 lanes of the kernel phase's rows cut to
   an eighth a lane, on the card against the plain rule under the same
   vmap, each kernel launched once for all lanes (``lanes`` lines).
   Then a CoordinatorServer on a card engine at the phase's scale: SV1
   the 22 TPC-H queries through ``dbapi`` in JSON (cold and timed) and
   in arrow mode, rows equal to phase 3's; SV2 a repeated Q1 over a
   memory table answered from the result cache with no launch and no
   host sync, then invalidated by an INSERT; SV3 eight concurrent
   identical Q5s run once (the others dedup or hit the cache), with
   one run's launches; SV4 a batch group of 8 literal variants for
   each kernel case (``BATCH_KERNELS``; Q5's at ``BATCH_SF``), every
   lane equal to its serial run on both backends, the group's launches
   equal to one serial run's, the batched counter up by 8, seconds and
   peak printed, then the Q6 group as 8 concurrent clients inside one
   batch window (``batch_window_ms``), rows right, some batched and no
   batch fallen back to serial runs; SV5 16 clients of ``SERVING_MIX`` under a query-pool
   capacity of the two largest estimates, rows right and no
   reservation left, then a small pool in which the low-memory killer
   kills the largest reservation (a stalled blackhole scan) while the
   two queries blocked behind it finish. The phase's launches are
   those of the served runs (each request and each batched run, the
   counts set to 0 just before it and read just after), not those of
   the serial runs they are held against.
12. Parquet: the TPC-H tables at ``PARQUET_SCALE`` (SF1, cut from 10:
   the reader decodes pages on the host) written with pyarrow
   (``write_tpch_parquet``: every column at its type; lineitem and
   orders uncompressed and dictionary-encoded, orders in version 2.0
   data pages, the others snappy; a second lineitem sorted by
   l_shipdate in row groups of 2^20 rows); where pyarrow does not
   import, the phase raises. A ``ParquetConnector`` over the files:
   each table's host decode, upload seconds and bytes; then
   ``PARQUET_QUERIES`` as in phase 3 (a first cuda pass, the timed
   pass between a reset and a read of the launch counts, the plain
   pass), each query's rows on both backends equal to the same query
   over the tpch connector at SF1 on the card (floats within
   FLOAT_STATE_RTOL), the kernel tags of both runs logged: the files
   declare no keys, so no join is unique (no ``join_lookup``, no
   ``multijoin``). ``PARQUET_OVER_MEMORY`` (Q5, its keyless join order)
   must run out of memory on the card. Q6 over the sorted lineitem
   keeps fewer row groups than the file has (apply_filter's pruning)
   and returns the same rows. Every kernel the parquet plans tag
   launches in the phase.
13. Observe: phase 3's tables (made again when it did not run). O1 Q5's
   first pass on fresh engines (a program-cache miss), its programs'
   costs known to the process (no count) and forgotten
   (``devprof.forget_costs``: counted by ``obs/devprof.harvest``),
   alternately after one that makes them known: the count's cost is
   the difference; then a fresh engine's cold run and its hit, neither
   counted; O2 the hit again under ``device_profile``, twice (the
   process's first capture, then another): a Chrome trace in the
   query's artifact directory naming a port kernel; O3 every ``system.operator_stats``
   row of the cold run and of the hit with nonzero flops, hbm_bytes,
   intensity and roofline, each program's rows summing to its counted
   flops within rounding; O4 a ``WorkerServer(device="cuda")`` over
   SF1: ``/v1/profile/start``, a task, ``/v1/profile/stop`` answer 200
   with a trace, and ``/metrics`` has the process gauges; O5
   ``OBSERVE_RUNG_SQL`` with its group-by table hinted too small
   climbs rungs, each counted once in
   ``presto_tpu_capacity_overflow_retries_total``.

The query lines of phases 3-6 carry the first (cold) pass's time and
capacity rungs (``cold_s``, ``cold_rungs``) beside the timed pass's:
the timed pass starts every program from the capacities the first
remembered (``from_memory``).

    python3 chip_smoke.py --phases kernels,tpch,tpcds,functions,arrays,session,statements,distributed,cluster,serving,parquet,observe

(the default) runs the named phases only (a shorter call while a phase
is worked on; the summary line needs all twelve).

The queries are the repository's TPC-H texts (tests/tpch_queries.py),
TPC-DS texts (tests/test_tpcds.py), ``FUNCTION_QUERIES`` and
``ARRAY_QUERIES``. The last
lines are the card, a JSON summary of the kernels (each with the PR
that last redesigned it, ``redesigned_in``, its launches summed
over phases 3 to 13, phase 11's among them (``serving_launches``,
``batched_launches`` for SV4's groups), phase 12's
(``parquet_launches``) and phase 13's (``observe_launches``), and its
lane rule at 8 lanes (``batched_ms``, ``batched_plain_ms``,
``batched_bound_ms``, ``batched_max_abs_err``)) and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# the kernels behind each kernel tag of a plan node
TAG_KERNELS = {"agg_sum": ("segment_sum",), "agg_max": ("segment_max",),
               "agg_min": ("segment_min",),
               "join_lookup": ("build_table", "probe_table"),
               "multijoin": ("build_table", "multijoin_walk"),
               "compact": ("filter_compact",)}
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
# the queries the plain backend runs again at TPCDS_SCALE, each held to
# the card's rows: one for each kernel the sweep pins and the two that
# numpy checks (cut from all 101, a pass of 49.6 s on the H100; the
# card's tests hold all 101 on both backends at scale 0.1)
TPCDS_PLAIN_QUERIES = ("q96", "q42", "q07", "q23", "q58", "q55")
PHASES = ("kernels", "tpch", "tpcds", "functions", "arrays", "session",
          "statements", "distributed", "cluster", "serving", "parquet",
          "observe")
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

    def walk_chain():
        # the entry the interpreter calls (operators._walk)
        with K.use_backend("cuda"):
            return MJ.walk_chain(spine.cols, spine.live, args[3], crit)
    got = walk_chain()
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
        "fused_ms": cuda_ms(walk_chain),
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


# phase 11's cross-query batches (SV4): per kernel lane rule, a query
# shape whose literals hoist into a plan template, and its variants.
# The kernel each case must launch on the card, under its lane rule
BATCH_KERNELS = {"q06": ("segment_sum",),
                 "q01": ("segment_sum",),
                 "extrema": ("segment_sum", "segment_max", "segment_min"),
                 "join": ("build_table", "probe_table", "segment_sum"),
                 "q05": ("multijoin_walk", "build_table", "segment_sum"),
                 "cross_join": ("filter_compact", "segment_sum")}
# the scale each case runs at on the card. Q5's MultiJoin is a segment
# of its own once its spine (lineitem) has AGG_SPLIT_MIN_ROWS = 2^21
# rows (from SF0.35 on; at SF10 60M), and a segmented plan is not
# batchable, in the reference as here: Q5 batches at SF0.34 at most
BATCH_SF = {"q05": 0.34}
_REGIONS = ("ASIA", "EUROPE", "AMERICA", "AFRICA", "MIDDLE EAST")


def _plus_days(day: str, n: int) -> str:
    return str(np.datetime64(day) + np.timedelta64(n, "D"))


def batch_variants(case: str, sf: float, k: int = 8) -> list[str]:
    """``k`` literal variants of batch case ``case`` at scale ``sf``."""
    out = []
    for i in range(k):
        if case == "q06":
            year = 1993 + i % 5
            lo = 2 + i % 6
            out.append(
                "select sum(l_extendedprice * l_discount) as revenue "
                "from lineitem "
                f"where l_shipdate >= date '{year}-01-01' "
                f"and l_shipdate < date '{year + 1}-01-01' "
                f"and l_discount between 0.0{lo - 1} and 0.0{lo + 1} "
                f"and l_quantity < {24 + i % 3}")
        elif case == "q01":
            out.append(TPCH["q01"].replace(
                "date '1998-12-01' - interval '90' day",
                f"date '{_plus_days('1998-09-02', -97 * i)}'"))
        elif case == "extrema":
            out.append(QUERIES["lineitem_extrema"].replace(
                "from lineitem\n",
                "from lineitem\nwhere l_shipdate < "
                f"date '{_plus_days('1998-08-02', -181 * i)}'\n"))
        elif case == "join":
            out.append(
                "select sum(l_quantity) as q, count(*) as c, "
                "sum(ps_supplycost) as s from lineitem, partsupp "
                "where l_partkey = ps_partkey and l_suppkey = ps_suppkey "
                f"and l_shipdate < date '{_plus_days('1993-01-01', 127 * i)}'")
        elif case == "q05":
            out.append(TPCH["q05"].replace(
                "'ASIA'", f"'{_REGIONS[i % 5]}'").replace(
                "1994-01-01", f"{1994 + i // 5}-01-01"))
        elif case == "cross_join":
            # the order-key bound stays: the planner sizes the cross
            # join's compaction from it, and a plan template's
            # fingerprint holds that size
            out.append(QUERIES["cross_join"].replace(
                "600000", f"{int(60000 * sf)} and l_linenumber <> {i + 1}"))
        else:
            raise KeyError(case)
    return out


def _days(s: str) -> int:
    return int((np.datetime64(s) - np.datetime64("1970-01-01"))
               .astype(int))


def check_q06(conn, rows) -> None:
    """Q6's revenue recomputed with numpy from the generator's arrays."""
    li = conn.table("lineitem").columns
    ship = np.asarray(li["l_shipdate"].data)
    disc = np.asarray(li["l_discount"].data)
    qty = np.asarray(li["l_quantity"].data)
    price = np.asarray(li["l_extendedprice"].data)
    m = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    revenue = int((price[m] * disc[m]).sum())  # scale 4, fits int64
    got = rows[0][0]
    if got != decimal.Decimal(revenue).scaleb(-4):
        raise AssertionError(f"Q6 revenue {got} != numpy {revenue}e-4")


def check_q1_counts(conn, rows, count_col: int = -1) -> None:
    """Q1's group counts (column ``count_col`` of each row) recomputed
    with numpy from the generator's arrays."""
    li = conn.table("lineitem").columns
    keep = np.asarray(li["l_shipdate"].data) <= _days("1998-12-01") - 90
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    codes = (np.asarray(rf.data)[keep].astype(np.int64) * len(ls.dictionary)
             + np.asarray(ls.data)[keep])
    counts = np.bincount(codes, minlength=len(rf.dictionary)
                         * len(ls.dictionary))
    want = {(rf.dictionary[c // len(ls.dictionary)],
             ls.dictionary[c % len(ls.dictionary)]): int(v)
            for c, v in enumerate(counts) if v}
    have = {(r[0], r[1]): int(r[count_col]) for r in rows}
    if have != want:
        raise AssertionError(f"Q1 counts {have} != numpy {want}")


def independent_checks(conn, rows: dict) -> None:
    """Q6's revenue, Q1's group counts and Q11's row count recomputed
    with numpy from the generator's arrays, independent of the
    engine."""
    check_q06(conn, rows["q06"])
    check_q1_counts(conn, rows["q01"])
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
    """The 101 TPC-DS queries at ``scale`` on the card (a first pass,
    then the timed, counted one), ``TPCDS_PLAIN_QUERIES`` again with
    kernel_backend=torch."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.kernels import build as B

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
    t = time.perf_counter()
    _rows, cold_secs, cold_notes = run_queries(engine, fits, "cuda")
    log(f"first pass (column upload included): "
        f"{time.perf_counter() - t:.1f} s")
    B.LAUNCHES.reset()
    rows, secs, notes = run_queries(engine, fits, "cuda")
    launches = B.LAUNCHES.snapshot()
    plain = {q: fits[q] for q in TPCDS_PLAIN_QUERIES}
    plain_rows, plain_secs, plain_notes = run_queries(engine, plain,
                                                      "torch")
    # every query's faults, collected, then raised together
    faults = []
    for q in fits:
        if q in plain and rows[q] != plain_rows[q]:
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
            "plain_s": plain_secs.get(q), **notes[q],
            "cold_s": cold_secs[q], "cold_rungs": cold_notes[q]["rungs"],
            "plain_kernels": (plain_notes[q]["kernels"] if q in plain
                              else None)}))
    log(f"tpcds cuda pass: {sum(secs.values()):.2f} s, plain pass "
        f"({len(plain)} queries): {sum(plain_secs.values()):.2f} s, peak "
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
                        measured: dict, phase: str = "tpcds",
                        listed_in: str = "TPCDS_OVER_MEMORY") -> None:
    """Run ``q`` on the card and require its out-of-memory error; the
    memory it held is released after the run. (The plain backend runs
    out as the card's does, at the same 79.2 GB for q72; its attempt is
    left out to save the script its time.)"""
    import torch
    engine.session.set("kernel_backend", "cuda")
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
            f"{q} now fits on the card (peak {peak:.2f} GB): run it with "
            f"the others, drop it from {listed_in}")
    log(f"{phase} " + json.dumps({"query": q, "backend": "cuda",
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
    # array_agg over orders by customer, read through the host-table
    # carrier by cardinality and grouped by it: the orders of the
    # catalog "cut" (1.5M; cut from SF10's 15M, as A5's: the lists are
    # built on the host)
    "A4": """
select cardinality(ks) as n, count(*) as c
from (select o_custkey, array_agg(o_orderkey order by o_orderdate) as ks
      from cut.orders group by o_custkey)
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
# A4's and A5's cut: array_agg builds its lists on the host and the NFA
# is the reference's per-position loop, so both run over SF1's worth of
# orders (1.5M), not SF10's 15M
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
    # A4: customers of the cut by their order count
    per_cust = np.bincount(np.asarray(
        cut.table("orders").columns["o_custkey"].data))
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


# -- phase 8: the statement surface ---------------------------------------------

ST_LI_COLUMNS = ("l_orderkey, l_partkey, l_suppkey, l_linenumber, "
                 "l_quantity, l_extendedprice, l_discount, l_tax")
ST_ORD_COLUMNS = ("o_orderkey, o_custkey, o_totalprice, o_orderdate, "
                  "o_orderpriority, o_orderstatus")
# ST4 and ST5 scan a memory VARCHAR table again and again, and every scan
# re-encodes its strings on the host (block.dictionary_encode): they run
# over the orders of o_custkey <= ST_CUT_CUSTKEY (1,500,000 rows), the
# cut of A5; ST1 times one scan of all 15M
ST_CUT_CUSTKEY = 150_000
# Q1's aggregates over the eight numeric columns of memory.li, grouped
# by a dictionary column (a numeric key groups by sorting, which no
# kernel serves): the orders' priority, through the dense join on the
# order key
ST_Q1 = """
select o_orderpriority, sum(l_quantity) as sum_qty,
  sum(l_extendedprice) as sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
  avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
  avg(l_discount) as avg_disc, count(*) as count_order
from {li}, tpch.orders
where l_orderkey = o_orderkey
group by o_orderpriority
order by o_orderpriority"""
# memory.li probes partsupp's unique key; unfiltered, because memory.li
# has no column statistics and a filter on it turns the join around at
# SF1 and above (the filtered lineitem becomes the build of an
# expanding join, which no kernel serves)
ST_JOIN = """
select ps_supplycost, sum(l_quantity) as q, count(*) as c
from {li}, tpch.partsupp
where l_partkey = ps_partkey and l_suppkey = ps_suppkey
group by ps_supplycost
order by q desc, ps_supplycost
limit 5"""
ST_UPDATE = ("update memory.li set l_quantity = l_quantity + 100 "
             "where l_orderkey % 7 = 0")
ST_GROUP = ("select o_orderpriority, count(*) as c from memory.ord_cut "
            "group by o_orderpriority order by o_orderpriority")
ST_REPEATS = 10


class WriteClock:
    """Host seconds of a write's two steps after its query: the result's
    columns to host arrays (``engine._table_to_host``, strings decoded,
    on the writer tasks) and the connector's sink
    (``engine._stream_to_sink``), summed while installed."""

    def __init__(self):
        self.decode_s = self.sink_s = 0.0

    def __enter__(self):
        from presto_tpu_torch import engine as PE
        self._saved = PE._table_to_host, PE._stream_to_sink

        def timed_call(fn, attr):
            def run(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    setattr(self, attr, getattr(self, attr)
                            + time.perf_counter() - t)
            return run

        PE._table_to_host = timed_call(self._saved[0], "decode_s")
        PE._stream_to_sink = timed_call(self._saved[1], "sink_s")
        return self

    def __exit__(self, *exc):
        from presto_tpu_torch import engine as PE
        PE._table_to_host, PE._stream_to_sink = self._saved


def _st_line(case: str, backend: str, secs: float, **more) -> None:
    log("statements " + json.dumps({"case": case, "backend": backend,
                                    "s": secs, **more}))


def statement_cases(conn, backend: str, q05_rows,
                    writes_only: bool = False) -> dict:
    """ST1-ST7 on one backend, each on a fresh engine over ``conn`` and
    one memory connector, all sharing one event manager: {case: rows};
    ``writes_only``: ST1-ST3 (the writes, the reads of what they wrote
    and the UPDATE). Faults raise."""
    import torch

    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.events import EventListenerManager
    from presto_tpu_torch.exec import cancel as C
    from presto_tpu_torch.kernels import build as B

    mem, events, executed = MemoryConnector(), EventListenerManager(), []
    cuda = backend == "cuda"

    def engine():
        # no gc.collect() first: an Engine is no reference cycle, so the
        # last case's engine and its device copies went at its last
        # reference
        e = Engine()
        e.register_catalog("tpch", conn)
        e.register_catalog("memory", mem)
        e.session.set("kernel_backend", backend)
        e.events = events
        return e

    def run(e, sql):
        executed.append(sql)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows = e.execute(sql)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t

    def notes(e) -> list:
        return sorted({tag for tags in e.last_kernel_notes.values()
                       for tag in tags})

    out = {}
    orders_custkey = _host(conn, "orders", "o_custkey")[0]
    cut = orders_custkey <= ST_CUT_CUSTKEY
    priority = _host(conn, "orders", "o_orderpriority")[0][cut]

    # ST1: CREATE TABLE AS, writer tasks and the host's share
    t0 = time.perf_counter()
    e = engine()
    made = {}
    for name, sql in (
            ("li", f"create table memory.li as select {ST_LI_COLUMNS} "
                   "from lineitem"),
            ("ord", f"create table memory.ord as select {ST_ORD_COLUMNS} "
                    "from orders"),
            ("ord_cut", f"create table memory.ord_cut as select "
                        f"{ST_ORD_COLUMNS} from orders where o_custkey <= "
                        f"{ST_CUT_CUSTKEY}")):
        with WriteClock() as clock:
            rows, secs = run(e, sql)
        want = {"li": conn.table("lineitem").nrows,
                "ord": conn.table("orders").nrows,
                "ord_cut": int(cut.sum())}[name]
        write = dict(e.last_write)
        if rows != [(want,)] or write["rows"] != want:
            raise AssertionError(f"ST1 {name}: {rows}, {write}, want {want}")
        if write["writer_tasks"] < 2:
            raise AssertionError(f"ST1 {name}: one writer task: {write}")
        _st_line(f"ST1 create {name}", backend, secs, **write,
                 decode_s=clock.decode_s, sink_s=clock.sink_s,
                 query_s=secs - clock.decode_s - clock.sink_s,
                 write_share=(clock.decode_s + clock.sink_s) / secs)
        made[name] = rows
    if cuda:
        # the host cost of every later scan of a VARCHAR memory table:
        # its string columns are encoded again (both, 15M rows each)
        t = time.perf_counter()
        mem.table("ord")
        _st_line("ST1 scan memory.ord (re-encode)", backend,
                 time.perf_counter() - t)
    out["ST1"] = made
    _st_line("ST1", backend, time.perf_counter() - t0)
    del e

    # ST2: reads of the written tables equal the same reads of lineitem
    t0 = time.perf_counter()
    e = engine()
    got = {}
    for name, text, kernel in (("q1", ST_Q1, "cuda:agg_sum"),
                               ("join", ST_JOIN, "cuda:join_lookup")):
        rows, secs = run(e, text.format(li="memory.li"))
        kernels = notes(e)
        want, want_secs = run(e, text.format(li="tpch.lineitem"))
        if rows != want or not rows:
            raise AssertionError(f"ST2 {name}: memory.li's rows differ "
                                 "from lineitem's")
        if cuda and kernel not in kernels:
            raise AssertionError(f"ST2 {name} did not run {kernel}: "
                                 f"{kernels}")
        _st_line(f"ST2 {name}", backend, secs, lineitem_s=want_secs,
                 kernels=kernels, blocks=e.last_streamed_blocks,
                 result_rows=len(rows))
        got[name] = rows
    out["ST2"] = got
    _st_line("ST2", backend, time.perf_counter() - t0)
    del e

    # ST3: UPDATE drops the resident column; the repeat equals numpy
    t0 = time.perf_counter()
    e = engine()
    li = mem._data["li"]
    qty, okey = li["l_quantity"], li["l_orderkey"]
    before, _ = run(e, ST_Q1.format(li="memory.li"))
    if e.resident(qty) is None:
        raise AssertionError("ST3: l_quantity is not resident after a read")
    hit = okey % 7 == 0
    updated, secs = run(e, ST_UPDATE)
    if updated != [(int(hit.sum()),)]:
        raise AssertionError(f"ST3: UPDATE counted {updated}, numpy "
                             f"{int(hit.sum())}")
    if li["l_quantity"] is qty or e.resident(qty) is not None:
        raise AssertionError("ST3: the old l_quantity is still resident "
                             "(or was written in place)")
    qty = li["l_quantity"]
    after, after_secs = run(e, ST_Q1.format(li="memory.li"))
    # numpy: each line's order priority by its order key, then the
    # quantities (scaled by 100; whole numbers, so float sums are exact)
    # and the lines per priority
    orders = conn.table("orders")
    okeys = np.asarray(orders.columns["o_orderkey"].data)
    prio = orders.columns["o_orderpriority"]
    by_key = np.argsort(okeys, kind="stable")
    code = np.asarray(prio.data)[
        by_key[np.searchsorted(okeys[by_key], okey)]]
    k = len(prio.dictionary)
    sums = np.bincount(code, weights=qty.astype(np.float64), minlength=k)
    counts = np.bincount(code, minlength=k)
    want = [(prio.dictionary[i], int(sums[i]), int(counts[i]))
            for i in range(k) if counts[i]]
    if [(r[0], round(float(r[1]) * 100), int(r[-1])) for r in after] \
            != want:
        raise AssertionError("ST3: the group-by after the UPDATE differs "
                             "from numpy")
    if after == before:
        raise AssertionError("ST3: the UPDATE changed no group")
    _st_line("ST3 update", backend, secs, rows=updated[0][0])
    _st_line("ST3 repeat", backend, after_secs, kernels=notes(e))
    out["ST3"] = [updated, after]
    _st_line("ST3", backend, time.perf_counter() - t0)
    del e
    if writes_only:
        return out

    # ST5: repeats over a VARCHAR memory table stay under the bound
    t0 = time.perf_counter()
    e = engine()
    first, _ = run(e, ST_GROUP)
    one = e._dev_cache_bytes
    again, _ = run(e, ST_GROUP)
    grown = e._dev_cache_bytes
    if again != first or grown != 2 * one:
        raise AssertionError(f"ST5: a repeat at the default limit held "
                             f"{grown} bytes, not {2 * one}")
    e.dev_cache_limit = one + one // 2
    peaks, secs = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(ST_REPEATS):
        rows, s = run(e, ST_GROUP)
        if rows != first:
            raise AssertionError("ST5: a repeat's rows differ")
        if e._dev_cache_bytes > e.dev_cache_limit:
            raise AssertionError(f"ST5: {e._dev_cache_bytes} cached bytes "
                                 f"over the limit {e.dev_cache_limit}")
        peaks.append(torch.cuda.max_memory_allocated())
        secs.append(s)
    if cuda and "cuda:agg_sum" not in notes(e):
        raise AssertionError(f"ST5 did not run cuda:agg_sum: {notes(e)}")
    if peaks[-1] > 1.05 * peaks[1]:
        raise AssertionError(f"ST5: peak {peaks[-1]} after the last repeat "
                             f"over 5% above {peaks[1]} after the second")
    _st_line("ST5 bound", backend, sum(secs), repeats=ST_REPEATS,
             repeat_s=secs, copy_bytes=one, default_limit_bytes=grown,
             limit=e.dev_cache_limit, cached_bytes=e._dev_cache_bytes,
             peak_2nd=peaks[1], peak_last=peaks[-1])
    out["ST5"] = first
    _st_line("ST5", backend, time.perf_counter() - t0)
    del e

    # ST4: DELETE in a transaction rolled back, INSERT, DROP TABLE
    t0 = time.perf_counter()
    e = engine()
    n = int(cut.sum())
    urgent = int((priority == "1-URGENT").sum())
    count = "select count(*) from memory.ord_cut"
    steps = [(count, n), ("start transaction", None),
             ("delete from memory.ord_cut where o_orderpriority = "
              "'1-URGENT'", urgent), (count, n - urgent),
             ("rollback", None), (count, n),
             ("insert into memory.ord_cut select * from memory.ord_cut", n),
             (count, 2 * n)]
    for sql, want in steps:
        rows, secs = run(e, sql)
        if rows != ([] if want is None else [(want,)]):
            raise AssertionError(f"ST4 {sql}: {rows}, numpy {want}")
        _st_line(f"ST4 {sql}", backend, secs)
    for table in ("ord_cut", "ord", "li"):
        run(e, f"drop table memory.{table}")
    tables, _ = run(e, "show tables from memory")
    if tables or mem.table_names():
        raise AssertionError(f"ST4: tables left after DROP: {tables}")
    out["ST4"] = [n, urgent]
    _st_line("ST4", backend, time.perf_counter() - t0)
    del e

    # ST7: the planning-time limit stops Q5 before any kernel
    t0 = time.perf_counter()
    e = engine()
    e.session.set("query_max_planning_time", 1e-9)
    launched = B.LAUNCHES.snapshot()
    try:
        run(e, TPCH["q05"])
    except C.TimeLimitExceeded as exc:
        limited = str(exc)
    else:
        raise AssertionError("ST7: Q5 outran query_max_planning_time")
    if B.LAUNCHES.snapshot() != launched:
        raise AssertionError("ST7: a kernel launched before the limit")
    e.session.set("query_max_planning_time", 0)
    q5, secs = run(e, TPCH["q05"])
    if not q5 or (q05_rows is not None and q5 != q05_rows):
        raise AssertionError("ST7: Q5 differs from its phase-3 rows")
    _st_line("ST7", backend, time.perf_counter() - t0, time_limit=limited,
             q05_s=secs)
    out["ST7"] = q5
    del e

    # ST6: catalogs, DESCRIBE, and every statement of the phase in
    # system.runtime.queries (ST7's Q5 the one FAILED)
    t0 = time.perf_counter()
    e = engine()
    catalogs, _ = run(e, "show catalogs")
    if catalogs != [("information_schema",), ("memory",), ("system",),
                    ("tpch",)]:
        raise AssertionError(f"ST6: catalogs {catalogs}")
    described, _ = run(e, "describe lineitem")
    shown, _ = run(e, "show columns from lineitem")
    if described != shown or len(described) != 16:
        raise AssertionError("ST6: DESCRIBE lineitem differs from SHOW "
                             "COLUMNS")
    seen = list(executed)
    queries, _ = run(e, "select query, state from system.runtime.queries "
                        "order by query_id")
    if [q for q, _ in queries] != seen:
        raise AssertionError("ST6: system.runtime.queries does not hold "
                             "the phase's statements in order")
    failed = [q for q, state in queries if state == "FAILED"]
    if failed != [TPCH["q05"]]:
        raise AssertionError(f"ST6: FAILED statements {failed}")
    _st_line("ST6", backend, time.perf_counter() - t0,
             statements=len(queries), failed=len(failed))
    out["ST6"] = [catalogs, described, [state for _, state in queries]]
    return out


def statements_phase(conn, q05_rows=None) -> dict:
    """ST1-ST7 at SF10 on the card, between a reset and a read of the
    launch counts, then ST1-ST3 on the plain backend (cut from all
    seven: ST4-ST7 run no kernel the reads of ST2-ST3 do not, and their
    plain pass took 44 s on the H100's host); every plain case's rows
    identical to the card's."""
    from presto_tpu_torch.kernels import build as B
    B.LAUNCHES.reset()
    t = time.perf_counter()
    got = statement_cases(conn, "cuda", q05_rows)
    launches = B.LAUNCHES.snapshot()
    log(f"statements cuda cases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    plain = statement_cases(conn, "torch", q05_rows, writes_only=True)
    log(f"statements plain cases (ST1-ST3): "
        f"{time.perf_counter() - t:.1f} s")
    differ = [case for case in plain if got[case] != plain[case]]
    if differ:
        raise AssertionError(f"statement cases differ between backends: "
                             f"{differ}")
    log("statements launches " + json.dumps(launches))
    for name in ("segment_sum", "build_table", "probe_table"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched in the statements "
                                 f"phase: {launches}")
    return launches


# -- phase 9: distributed execution over 8 shards on the one card ----------

# tests/test_distributed.py's DIST_QUERIES, SORT_SQL and
# tests/test_connector_partitioning.py's ORDERKEY_JOIN
DIST_QUERIES = ("q01", "q03", "q05", "q06", "q10", "q12", "q13", "q14",
                "q18", "q19")
DIST_SHARDS = 8
DIST_SORT_SQL = ("select l_orderkey, l_extendedprice from lineitem "
                 "where l_quantity < 10 "
                 "order by l_extendedprice desc, l_orderkey")
DIST_ORDERKEY_JOIN = (
    "select o_orderpriority, count(*) as c "
    "from orders, lineitem where o_orderkey = l_orderkey "
    "and l_quantity < 2500 group by o_orderpriority "
    "order by o_orderpriority")
# D5's skewed data: SF1, not SF10 (a second SF10 dataset would double
# the phase's generation time)
DIST_SKEW_SCALE = 1.0
DIST_SKEW = "zipf:1.3"
DIST_SKEW_PROPS = {"multiway_join": False,
                   "broadcast_join_threshold_rows": 64,
                   "skew_hot_key_threshold": 64}
DIST_KERNELS = ("cuda:agg_sum", "cuda:join_lookup", "cuda:multijoin")


def values_close(a, b) -> bool:
    """Equal, but floats within FLOAT_STATE_RTOL and FLOAT_STATE_ATOL:
    a distributed aggregate merges partial float states in another
    order than one device sums them."""
    if isinstance(a, float) or isinstance(b, float):
        return floats_agree(a, b)
    return a == b


def rows_close(got: list, want: list) -> bool:
    """Rows equal in order with values_close; where the order differs,
    equal as multisets, which is what rows tied under their ORDER BY
    may do between a merge of sorted shards and one sort."""
    if len(got) != len(want):
        return False
    if all(len(g) == len(w) and all(map(values_close, g, w))
           for g, w in zip(got, want)):
        return True
    return rows_close(sorted(got, key=repr), sorted(want, key=repr))


def dist_run(engine, group, sql: str, table: bool = False, **props) -> dict:
    """One distributed run of ``sql`` over ``group`` with session
    ``props`` (restored after): rows (or the host Table), seconds (a
    device synchronize on either side), rungs, host syncs, uploads (all
    and scan columns), collective calls and bytes by kind, peak device
    GB, kinds of the capacities used and the kernels noted."""
    import torch

    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.parallel.group import COLLECTIVES
    before = {k: engine.session.get(k) for k in props}
    for k, v in props.items():
        engine.session.set(k, v)
    syncs0, up0 = HS.SYNCS.total(), HS.UPLOADS.total()
    scan0 = sum(HS.UPLOADS.by_site.get(site, 0)
                for site in ("scan-column", "shard-order"))
    COLLECTIVES.reset()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rows = (engine.execute_table(sql, mesh=group) if table
                else engine.execute(sql, mesh=group))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        for k, v in before.items():
            engine.session.set(k, v)
    coll = COLLECTIVES.snapshot()
    return {"rows": rows, "s": secs, "rungs": engine.last_run.rungs,
            "host_syncs": HS.SYNCS.total() - syncs0,
            "uploads": HS.UPLOADS.total() - up0,
            # scan columns and bucket-sharded scans' row orders
            "scan_uploads": sum(HS.UPLOADS.by_site.get(site, 0)
                                for site in ("scan-column", "shard-order"))
            - scan0,
            "collective_calls": coll["calls"],
            "collective_bytes": coll["bytes"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kinds": sorted({k for _p, k in
                             engine.last_dist_meta["used_capacity"]}),
            "kernels": sorted({t for tags in
                               engine.last_kernel_notes.values()
                               for t in tags})}


def _dist_line(case: str, backend: str, got: dict, **more) -> None:
    log("distributed " + json.dumps({
        "case": case, "backend": backend, "shards": DIST_SHARDS,
        **{k: v for k, v in got.items() if k not in ("rows", "kinds")},
        **more}))


def _sort_arrays(table) -> list:
    """The live rows of a host Table, column by column."""
    live = (np.ones(table.nrows, bool) if table.mask is None
            else np.asarray(table.mask))
    return [np.asarray(c.data)[live] for c in table.columns.values()]


def _force_joins(plan, distribution: str, **fields):
    """Every equi Join of ``plan`` (every unique-build one under
    ``hybrid``) with ``distribution`` and ``fields`` (the white-box
    rewrite of tests/test_skew_join.py: the cost model picks neither
    path for Q3 at SF1, where no key passes a shard's share of rows)."""
    import dataclasses

    from presto_tpu_torch.plan import nodes as N

    def visit(node):
        if (isinstance(node, N.Join) and node.criteria
                and (distribution != "hybrid" or node.build_unique)):
            return dataclasses.replace(node, distribution=distribution,
                                       **fields)
        return node
    return N.rewrite_bottom_up(plan, visit)


def distributed_cases(conn, skew_conn, backend: str, local_rows: dict,
                      local_secs: dict, device="cuda") -> dict:
    """D1-D6 on one backend over LocalShardGroup(DIST_SHARDS, device):
    {case: rows}. Each engine is fresh and dropped before the next."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch.parallel.executor import execute_plan_distributed
    from presto_tpu_torch.parallel.group import LocalShardGroup

    group = LocalShardGroup(DIST_SHARDS, device)

    def engine(c, **props):
        e = Engine(device=device)
        e.register_catalog("tpch", c)
        e.session.set("kernel_backend", backend)
        for k, v in props.items():
            e.session.set(k, v)
        return e

    out, notes = {}, set()
    e = engine(conn)
    # D1: the distributed queries, a cold run and a timed repeat
    for q in DIST_QUERIES:
        cold = dist_run(e, group, QUERIES[q])
        got = dist_run(e, group, QUERIES[q])
        if not rows_close(got["rows"], local_rows[q]):
            raise AssertionError(f"D1 {q}: {DIST_SHARDS} shards differ "
                                 "from phase 3's rows")
        if got["rows"] != cold["rows"]:
            raise AssertionError(f"D1 {q}: the repeat differs")
        if got["rungs"] or got["scan_uploads"]:
            raise AssertionError(f"D1 {q}: the repeat climbed "
                                 f"{got['rungs']} rungs, uploaded "
                                 f"{got['scan_uploads']} scan columns")
        notes.update(got["kernels"])
        out[q] = got["rows"]
        _dist_line(f"D1 {q}", backend, got, cold_s=cold["s"],
                   cold_rungs=cold["rungs"],
                   cold_host_syncs=cold["host_syncs"],
                   cold_uploads=cold["uploads"],
                   local_s=local_secs.get(q))
    # D2: Q3 partitioned and broadcast, the partsupp join partitioned
    def twice(sql, **props):
        """A cold run, then the timed repeat with the cold figures."""
        cold = dist_run(e, group, sql, **props)
        got = dist_run(e, group, sql, **props)
        if got["rungs"] or got["scan_uploads"]:
            raise AssertionError(f"the repeat of {sql[:40]!r} climbed "
                                 f"{got['rungs']} rungs, uploaded "
                                 f"{got['scan_uploads']} scan columns")
        return {**got, "cold_s": cold["s"], "cold_rungs": cold["rungs"],
                "cold_host_syncs": cold["host_syncs"],
                "cold_uploads": cold["uploads"]}

    part = twice(QUERIES["q03"], join_distribution_type="PARTITIONED")
    if not ({"probe_exch", "build_exch"} <= set(part["kinds"])
            and part["collective_calls"].get("all_to_all", 0) > 0):
        raise AssertionError(f"D2 q03 PARTITIONED: {part['kinds']} "
                             f"{part['collective_calls']}")
    bcast = twice(QUERIES["q03"], join_distribution_type="BROADCAST",
                  partitioned_agg_min_groups=1 << 30)
    if ({"probe_exch", "build_exch"} & set(bcast["kinds"])
            or "all_to_all" in bcast["collective_calls"]):
        raise AssertionError(f"D2 q03 BROADCAST: {bcast['kinds']} "
                             f"{bcast['collective_calls']}")
    ps = twice(QUERIES["lineitem_partsupp"],
               join_distribution_type="PARTITIONED")
    if f"{backend}:join_lookup" not in ps["kernels"]:
        raise AssertionError(f"D2 lineitem_partsupp: {ps['kernels']}")
    for name, got, q in (("q03 PARTITIONED", part, "q03"),
                         ("q03 BROADCAST", bcast, "q03"),
                         ("lineitem_partsupp PARTITIONED", ps,
                          "lineitem_partsupp")):
        if not rows_close(got["rows"], local_rows[q]):
            raise AssertionError(f"D2 {name}: rows differ from phase 3")
        notes.update(got["kernels"])
        out[f"D2 {name}"] = got["rows"]
        _dist_line(f"D2 {name}", backend, got, kinds=got["kinds"],
                   local_s=local_secs.get(q))
    # D3: the merge exchange against a gather and one sort
    on = twice(DIST_SORT_SQL, table=True, distributed_sort=True)
    merges = e.last_dist_meta["merged_runs"]
    off = twice(DIST_SORT_SQL, table=True, distributed_sort=False)
    if len(merges) != 1 or merges[0][1] != DIST_SHARDS \
            or e.last_dist_meta["merged_runs"]:
        raise AssertionError(f"D3: merges {merges}, then "
                             f"{e.last_dist_meta['merged_runs']}")
    a, b = _sort_arrays(on["rows"]), _sort_arrays(off["rows"])
    if not all(np.array_equal(x, y) for x, y in zip(a, b)) \
            or len(a[0]) == 0:
        raise AssertionError("D3: distributed_sort on and off differ")
    out["D3"] = [x.tolist()[:100] for x in a]
    for flag, got in (("on", on), ("off", off)):
        _dist_line(f"D3 sort distributed_sort={flag}", backend, got,
                   result_rows=len(a[0]),
                   merged_runs=merges if flag == "on" else [])
    # D4: co-partitioned scans skip both exchanges
    co = dist_run(e, group, DIST_ORDERKEY_JOIN,
                  join_distribution_type="PARTITIONED")
    co_again = dist_run(e, group, DIST_ORDERKEY_JOIN,
                        join_distribution_type="PARTITIONED")
    want = e.execute(DIST_ORDERKEY_JOIN)
    if {"probe_exch", "build_exch"} & set(co["kinds"]) \
            or not rows_close(co["rows"], want) \
            or co_again["rows"] != co["rows"] or co_again["scan_uploads"]:
        raise AssertionError(f"D4: {co['kinds']}, repeat scan uploads "
                             f"{co_again['scan_uploads']}")
    out["D4"] = co["rows"]
    _dist_line("D4 orderkey join", backend, co_again, cold_s=co["s"],
               cold_uploads=co["uploads"], kinds=co["kinds"])
    # D6: EXPLAIN ANALYZE over the shards
    text = e.execute("explain analyze " + QUERIES["q05"], mesh=group)[0][0]
    if not text.startswith(f"Distributed plan over {DIST_SHARDS} devices") \
            or "[sharded]" not in text:
        raise AssertionError("D6: " + text[:300])
    node_rows = e.last_run.node_rows
    if node_rows[(0, 0)] != len(local_rows["q05"]):
        raise AssertionError(f"D6: root rows {node_rows[(0, 0)]}")
    out["D6"] = sorted(node_rows.items())
    log("distributed " + json.dumps({
        "case": "D6 explain analyze q05", "backend": backend,
        "header": text.splitlines()[0], "nodes": len(node_rows)}))
    del e
    # D5: skew joins on Zipf data, at SF1, the plans forced as
    # tests/test_skew_join.py forces them
    import torch
    reduced = (f"SF{DIST_SKEW_SCALE:g} {DIST_SKEW}, not SF10: a second "
               "SF10 dataset would double the phase's generation time")
    plain = engine(skew_conn).execute(QUERIES["q03"])
    for case, props, dist, fields, kinds in (
            ("hybrid", DIST_SKEW_PROPS, "hybrid", {"hot_keys": 1024},
             {"hot", "htab", "probe_exch", "build_exch"}),
            ("salted", {"multiway_join": False,
                        "skew_hot_key_threshold": 0},
             "partitioned", {"salt_factor": 4},
             {"probe_exch", "build_exch"})):
        sk = engine(skew_conn, **props)
        plan, _ = sk.plan_sql(QUERIES["q03"])
        from presto_tpu_torch.exec import hostsync as HS
        from presto_tpu_torch.parallel.group import COLLECTIVES
        COLLECTIVES.reset()
        syncs0 = HS.SYNCS.total()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = execute_plan_distributed(
            sk, _force_joins(plan, dist, **fields), group)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        rows = [tuple(r) for r in got.to_pylist()]
        used = {k for _p, k in sk.last_dist_meta["used_capacity"]}
        if not kinds <= used or not rows_close(rows, plain):
            raise AssertionError(f"D5 {case}: {sorted(used)}, rows "
                                 f"{'equal' if rows_close(rows, plain) else 'differ'}")
        out[f"D5 {case}"] = rows
        coll = COLLECTIVES.snapshot()
        log("distributed " + json.dumps({
            "case": f"D5 {case} q03", "backend": backend,
            "shards": DIST_SHARDS, "s": secs,
            "rungs": sk.last_run.rungs,
            "host_syncs": HS.SYNCS.total() - syncs0,
            "collective_calls": coll["calls"],
            "collective_bytes": coll["bytes"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kinds": sorted(used), **fields, "reduced": reduced}))
        del sk
    out["notes"] = sorted(notes)
    return out


def dist_local_rows(conn) -> tuple[dict, dict]:
    """Phase 3's rows and timed seconds of the queries the distributed
    phase holds, on one engine (for ``--phases distributed`` alone)."""
    from presto_tpu_torch import Engine
    engine = Engine()
    engine.register_catalog("tpch", conn)
    queries = {q: QUERIES[q] for q in DIST_QUERIES + ("lineitem_partsupp",)}
    run_queries(engine, queries, "cuda")
    rows, secs, _notes = run_queries(engine, queries, "cuda")
    return rows, {q: {"s": secs[q]} for q in queries}


def distributed_phase(conn, local_rows: dict, local_secs: dict) -> dict:
    """D1-D6 on both backends over 8 shards of the card (the cuda runs
    between a reset and a read of the launch counts): rows identical
    between the backends but for floats within FLOAT_STATE_RTOL."""
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.kernels import build as B
    t = time.perf_counter()
    skew_conn = TpchConnector(scale=DIST_SKEW_SCALE, skew=DIST_SKEW)
    log(f"datagen sf={DIST_SKEW_SCALE:g} {DIST_SKEW}: "
        f"{time.perf_counter() - t:.1f} s")
    B.LAUNCHES.reset()
    t = time.perf_counter()
    got = distributed_cases(conn, skew_conn, "cuda", local_rows, local_secs)
    launches = B.LAUNCHES.snapshot()
    log(f"distributed cuda cases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    plain = distributed_cases(conn, skew_conn, "torch", local_rows,
                              local_secs)
    log(f"distributed plain cases: {time.perf_counter() - t:.1f} s")
    differ = [case for case in got if case != "notes"
              and not rows_close(got[case], plain[case])]
    if differ:
        raise AssertionError(f"distributed cases differ between backends: "
                             f"{differ}")
    missing = [k for k in DIST_KERNELS if k not in got["notes"]]
    if missing:
        raise AssertionError(f"the distributed phase did not run {missing}")
    log("distributed launches " + json.dumps(launches))
    for name in ("segment_sum", "build_table", "probe_table",
                 "multijoin_walk"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched in the "
                                 f"distributed phase: {launches}")
    return launches


# -- phase 10: the cluster tier ----------------------------------------------

CLUSTER_WORKERS = 4
# C1: tests/test_cluster.py's QUERIES (the checksum/approx_distinct
# states cross the wire) and Q6, through the partial-aggregate path
CLUSTER_PARTIALS = {
    "count": "select count(*) from lineitem",
    "q1_shape": "select l_returnflag, l_linestatus, sum(l_quantity) as q, "
                "count(*) as c, avg(l_extendedprice) as a, "
                "min(l_discount) as mn, max(l_tax) as mx from lineitem "
                "where l_shipdate <= date '1998-09-02' "
                "group by l_returnflag, l_linestatus "
                "order by l_returnflag, l_linestatus",
    "shipmode_top3": "select l_shipmode, "
                     "sum(l_extendedprice * (1 - l_discount)) as rev "
                     "from lineitem group by l_shipmode "
                     "order by rev desc limit 3",
    "checksum": "select l_returnflag, checksum(l_partkey) as ck, "
                "approx_distinct(l_suppkey) as ad from lineitem "
                "group by l_returnflag order by l_returnflag",
    "q06": TPCH["q06"],
}
# C2: stage DAGs (test_join_distributes_as_fragments's join, Q3, Q5,
# Q9, lineitem_partsupp and Q3 with PARTITIONED joins)
CLUSTER_JOIN = ("select o_orderpriority, count(*) as c from orders, "
                "lineitem where o_orderkey = l_orderkey "
                "group by o_orderpriority order by o_orderpriority")
CLUSTER_FRAGMENTS = {
    "join": (CLUSTER_JOIN, {}),
    "q03": (TPCH["q03"], {}),
    "q05": (TPCH["q05"], {}),
    "q09": (TPCH["q09"], {}),
    "lineitem_partsupp": (QUERIES["lineitem_partsupp"], {}),
    "q03 PARTITIONED": (TPCH["q03"],
                        {"join_distribution_type": "partitioned"}),
}
# C2, C3, C5 and the plain-version cases run at SF1, cut from the
# phase's scale: at SF10 the six C2 queries took 61.2 s a pass (q09
# 26.1 s, q05 15.7 s; NVIDIA H100 80GB HBM3, 700 W), their exchanges
# 0.4-2.1 GB of pages over loopback HTTP each, and C5's expanding join
# of supplier and customer on the nation key holds 1.2e9 rows. C1 and
# C4 run at the phase's scale
CLUSTER_SMALL_SCALE = 1.0
# C5: tests/test_adaptive.py's poisoned-ledger re-plan
CLUSTER_ADAPTIVE_SQL = (
    "select s_nationkey, count(*) as c from supplier, customer "
    "where s_nationkey = c_nationkey and c_mktsegment = 'BUILDING' "
    "group by s_nationkey order by s_nationkey")
CLUSTER_POISON_KEY = ("tpch.customer", "eq(c_mktsegment, ?)")
# tests/test_adaptive.py's scale, C5's second run: there the expanding
# join fits the capacity that cost/adapt.revise_join re-costs
CLUSTER_ADAPTIVE_REF_SCALE = 0.01
CLUSTER_JOIN_KERNELS = ("build_table", "probe_table", "multijoin_walk",
                        "filter_compact")


@contextlib.contextmanager
def cluster(conn, device="cuda", spool_dir=None, **props):
    """``CLUSTER_WORKERS`` WorkerServers in this process over one
    catalog, their engines on ``device``, and a started
    ClusterCoordinator whose own engine is on the card (session
    ``props`` set); everything stops on exit, on failure too."""
    from presto_tpu_torch import Engine
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer
    workers, coord = [], None
    try:
        for i in range(CLUSTER_WORKERS):
            workers.append(WorkerServer(
                {"tpch": conn}, node_id=f"w{i}", spool_dir=spool_dir,
                device=device).start())
        local = Engine(device="cuda")
        local.register_catalog("tpch", conn)
        local.session.catalog = "tpch"
        for k, v in props.items():
            local.session.set(k, v)
        coord = ClusterCoordinator(local, heartbeat_interval_s=0.5)
        for w in workers:
            coord.add_worker(w.uri)
        yield coord.start()
    finally:
        if coord is not None:
            coord.stop()
        for w in workers:
            w.stop()


def wait_all_live(coord, timeout_s: float = 60.0) -> None:
    """Until the heartbeats have every worker schedulable again."""
    deadline = time.monotonic() + timeout_s
    while len(coord.live_workers()) < len(coord.workers):
        if time.monotonic() > deadline:
            raise AssertionError(
                f"{len(coord.live_workers())} of {len(coord.workers)} "
                f"workers live after {timeout_s:g} s")
        time.sleep(0.1)


def cluster_run(coord, sql: str, **props) -> dict:
    """One run of ``sql`` on the cluster with session ``props``
    (restored after): rows, seconds (a device synchronize on either
    side), the distribution, the stage tree's stages and worker tasks,
    exchange pages and bytes by codec (pulled by the tasks), retries,
    host syncs and uploads of the whole process (the workers and the
    coordinator), launches per kernel, the counts set to 0 just before
    ``coord.execute`` and read just after (the workers' tasks and the
    coordinator's own stage), the kernels the worker tasks' operators
    noted, those the coordinator's engine noted, the capacity rungs the
    process paid (``presto_tpu_capacity_overflow_retries_total``), the
    process's peak device GB and the query's system.tasks row count."""
    import torch

    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.kernels import build as B
    from presto_tpu_torch.obs import qstats as QS
    from presto_tpu_torch.obs.metrics import REGISTRY
    rungs = REGISTRY.counter("presto_tpu_capacity_overflow_retries_total")
    engine = coord.engine
    before = {k: engine.session.get(k) for k in props}
    for k, v in props.items():
        engine.session.set(k, v)
    syncs0, up0 = HS.SYNCS.total(), HS.UPLOADS.total()
    rungs0 = rungs.total()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        B.LAUNCHES.reset()
        t = time.perf_counter()
        rows = coord.execute(sql)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: n for k, n in B.LAUNCHES.snapshot().items() if n}
    finally:
        for k, v in before.items():
            engine.session.set(k, v)
    syncs = HS.SYNCS.total() - syncs0
    uploads = HS.UPLOADS.total() - up0
    paid = rungs.total() - rungs0
    peak = torch.cuda.max_memory_allocated() / 1e9
    coordinator_kernels = sorted({
        tag for tags in engine.last_kernel_notes.values() for tag in tags})
    dist = dict(coord.last_distribution or {})
    qid = engine.events.history[-1].query_id
    snap = QS.STORE.get(qid).snapshot()
    tasks = [t for s in snap["stages"] if s["stage"] != "coordinator"
             for t in s["tasks"]]
    by_codec: dict[str, int] = {}
    for t in tasks:
        for codec, n in (t.get("exchangeBytesByCodec") or {}).items():
            by_codec[codec] = by_codec.get(codec, 0) + n
    system_tasks = int(engine.execute(
        "select count(*) from system.tasks "
        f"where query_id = '{qid}'")[0][0])
    return {"rows": rows, "s": secs,
            "mode": dist.get("mode", "partials"),
            "nshards": dist.get("nshards"), "stages": dist.get("stages"),
            "partial_rows": dist.get("partial_rows"),
            "worker_tasks": len(tasks),
            "task_retries": snap["taskRetries"],
            "exchange_pages": sum(t["exchangePages"] for t in tasks),
            "exchange_bytes_by_codec": by_codec,
            "pages_emitted": sum(t["pagesEmitted"] for t in tasks),
            "host_syncs": syncs, "uploads": uploads, "rungs": paid,
            "launches": launches,
            "worker_kernels": sorted({
                k for t in tasks for op in t["operators"]
                for k in (op.get("kernel") or "").split(",") if k}),
            "coordinator_kernels": coordinator_kernels,
            "peak_gb": peak, "system_tasks_rows": system_tasks,
            "distribution": dist}


def _cluster_line(case: str, got: dict, **more) -> None:
    log("cluster " + json.dumps({
        "case": case, "workers": CLUSTER_WORKERS,
        **{k: v for k, v in got.items()
           if k not in ("rows", "distribution")}, **more},
        default=str))


def cluster_cases(conn, small_conn, local_rows: dict,
                  local_secs: dict) -> dict:
    """C1-C5 with every engine on the card: {case: rows}, the worker
    and coordinator kernel notes, and the launches per kernel summed
    over the cluster queries (the reference rows each case is held
    against are run outside their counts). C1 and C4 over ``conn``, C2,
    C3 and C5 over ``small_conn``. ``local_rows`` holds phase 3's
    single-engine rows of the queries it ran over ``conn``,
    ``local_secs`` their timed seconds. A query without such rows is
    held against the coordinator's own engine running it alone."""
    import os
    import shutil
    import tempfile

    from presto_tpu_torch import native
    from presto_tpu_torch.ft.faults import FAULTS
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.parallel import wire

    out, notes, coord_notes, launched = {}, set(), set(), {}

    def run(coord, sql, **props):
        got = cluster_run(coord, sql, **props)
        for k, n in got["launches"].items():
            launched[k] = launched.get(k, 0) + n
        notes.update(got["worker_kernels"])
        coord_notes.update(got["coordinator_kernels"])
        return got

    def twice(coord, case, sql, want, **props):
        cold = run(coord, sql, **props)
        got = run(coord, sql, **props)
        if got["rows"] != cold["rows"]:
            raise AssertionError(f"{case}: the repeat differs")
        if not rows_close(got["rows"], want):
            raise AssertionError(f"{case}: rows differ from one engine's")
        return {**got, "cold_s": cold["s"],
                "cold_host_syncs": cold["host_syncs"],
                "cold_uploads": cold["uploads"]}

    # C1: the partial-aggregate path at the phase's scale
    with cluster(conn) as coord:
        for name, sql in CLUSTER_PARTIALS.items():
            want = local_rows.get(name)
            if want is None:
                # a query phase 3 does not run: the coordinator's own
                # engine runs it alone
                want = coord.engine.execute(sql)
            got = twice(coord, f"C1 {name}", sql, want)
            # the partials mode: one stage of partial aggregates whose
            # states the coordinator finishes (the general fragmenter's
            # one-stage DAG, or _execute_partial_fragments where it
            # declines the plan)
            if got["nshards"] != CLUSTER_WORKERS \
                    or got["partial_rows"] is None \
                    or got["stages"] not in (None, 1):
                raise AssertionError(f"C1 {name}: {got['distribution']}")
            out[f"C1 {name}"] = got["rows"]
            _cluster_line(f"C1 {name}", got,
                          local_s=local_secs.get(name))
        check_q1_counts(conn, out["C1 q1_shape"], count_col=3)
        check_q06(conn, out["C1 q06"])
        log("cluster C1: numpy checks of the Q1 shape and Q6: ok")
        q05 = local_rows.get("q05")
        if q05 is None:
            q05 = coord.engine.execute(TPCH["q05"])
        # C4: the two page codecs
        if native.codec() is None:
            raise AssertionError("C4: the native page codec did not "
                                 "load")
        log("cluster " + json.dumps({
            "case": "C4 codec", "have_arrow": wire.have_arrow(),
            "native_build_s": native.BUILD_SECONDS,
            "native_library": native._lib_path()}))
        saved = os.environ.get("PRESTO_TPU_WIRE")
        codecs = ["npz"] + (["arrow"] if wire.have_arrow() else [])
        try:
            for codec in codecs:
                os.environ["PRESTO_TPU_WIRE"] = codec
                got = run(coord, TPCH["q05"])
                if not rows_close(got["rows"], q05) or \
                        not got["exchange_bytes_by_codec"].get(codec):
                    raise AssertionError(
                        f"C4 {codec}: "
                        f"{got['exchange_bytes_by_codec']}")
                out[f"C4 {codec}"] = got["rows"]
                _cluster_line(f"C4 q05 PRESTO_TPU_WIRE={codec}", got,
                              scale=conn.scale,
                              local_s=local_secs.get("q05"))
        finally:
            if saved is None:
                os.environ.pop("PRESTO_TPU_WIRE", None)
            else:
                os.environ["PRESTO_TPU_WIRE"] = saved

    spool = tempfile.mkdtemp(prefix="presto_tpu_torch_spool_")
    try:
        with cluster(small_conn, spool_dir=spool) as coord:
            # C2: stage DAGs
            for name, (sql, props) in CLUSTER_FRAGMENTS.items():
                want = coord.engine.execute(sql)
                got = twice(coord, f"C2 {name}", sql, want, **props)
                if got["mode"] != "fragments" or got["stages"] < 2:
                    raise AssertionError(
                        f"C2 {name}: {got['distribution']}")
                out[f"C2 {name}"] = got["rows"]
                _cluster_line(f"C2 {name}", got, props=props,
                              scale=small_conn.scale)
            small_q05 = out["C2 q05"]
            # C3: TASK retries over the spooled exchange, a crash of
            # every task POST on w1
            FAULTS.arm("worker-task-crash", prob=1.0, seed=7, match="w1")
            try:
                got = run(coord, TPCH["q05"], retry_policy="TASK",
                          exchange_spooling=True)
            finally:
                FAULTS.clear()
            if not rows_close(got["rows"], small_q05) \
                    or got["distribution"].get("task_retries", 0) < 1:
                raise AssertionError(f"C3 crash: {got['distribution']}")
            out["C3 crash"] = got["rows"]
            _cluster_line("C3 q05 TASK retry, w1 crashes", got,
                          fault="worker-task-crash w1",
                          scale=small_conn.scale)
            wait_all_live(coord)
            # ... and a straggler under speculation: the first fetch
            # from a side1 producer stalls 4 s, a duplicate wins
            attempts = REGISTRY.counter(
                "presto_tpu_speculative_attempts_total")
            wins = REGISTRY.counter("presto_tpu_speculative_wins_total")
            a0, w0 = attempts.value(), wins.value()
            FAULTS.arm("exchange-fetch-delay", prob=1.0, match=".side1.",
                       limit=1, delay_s=4.0)
            try:
                got = run(coord, TPCH["q05"], retry_policy="TASK",
                          speculative_execution=True,
                          speculation_min_runtime_s=0.3,
                          speculation_threshold=1.5)
            finally:
                FAULTS.clear()
            spec = {"attempts": attempts.value() - a0,
                    "wins": wins.value() - w0}
            if not rows_close(got["rows"], small_q05) \
                    or spec["attempts"] < 1:
                raise AssertionError(f"C3 straggler: {spec}")
            out["C3 straggler"] = got["rows"]
            _cluster_line("C3 q05 straggler under speculation", got,
                          speculation=spec,
                          fault="exchange-fetch-delay .side1. 4 s",
                          scale=small_conn.scale)
            wait_all_live(coord)
    finally:
        shutil.rmtree(spool, ignore_errors=True)

    # C5: the poisoned-ledger re-plan, on rows, rungs and records, at
    # the phase's small scale and at the reference test's
    out["C5"] = adaptive_case(small_conn, run)
    out["C5 reference scale"] = adaptive_case(
        tpch_data(CLUSTER_ADAPTIVE_REF_SCALE, small_conn.gen.seed), run)
    out["notes"] = sorted(notes)
    out["coordinator_notes"] = sorted(coord_notes)
    out["launches"] = launched
    return out


def adaptive_case(conn, run) -> list:
    """C5: tests/test_adaptive.py's chaos run over ``conn`` under
    retry_policy=TASK, each query through ``run`` (cluster_run's
    signature): with the ledger poisoned (customer's segment filter
    claimed to keep 1/1500 of its rows), the static plan broadcasts the
    customer side; the adaptive run re-plans the rest after that stage
    (the join flipped to partitioned, its capacity re-bucketed). Both
    equal one engine's rows; the flip is in ``last_distribution``, the
    annotated plan and ``system.adaptive_decisions``. The static run
    pays capacity rungs. Where the join's rows fit revise_join's bound,
    8x its larger input, the adaptive run pays none, as the reference's
    test asserts; where they do not (SF1: 1.2e7 rows against 8x 30,000
    customers), no more than the static run (the reference on the CPU
    pays 12 and 9 there). Returns the adaptive run's rows."""
    from presto_tpu_torch.obs import qstats as QS

    # between the poisoned estimate of the filtered customers (1/1500
    # of them) and their true number (1/5), as 64 is at SF0.01
    threshold = max(64, int(conn.table("customer").nrows) // 150)

    def poison():
        # the earlier real observations of the same predicate (Q3's
        # segment filter, in phase 3 and in C2) go first: they would
        # pull the poisoned mean back over the line
        QS.DIVERGENCE.forget_selectivity(*CLUSTER_POISON_KEY)
        for _ in range(400):
            QS.DIVERGENCE.observe_selectivity(*CLUSTER_POISON_KEY, 1500, 1)

    with cluster(conn, retry_policy="TASK",
                 broadcast_join_threshold_rows=threshold) as coord:
        want = coord.engine.execute(CLUSTER_ADAPTIVE_SQL)
        # the join's rows and its inputs' (the filtered customers, the
        # suppliers), from the run: does revise_join's bound hold it?
        join_rows = sum(int(c) for _k, c in want)
        inputs = max(int(conn.table("supplier").nrows), int(
            coord.engine.execute(
                "select count(*) from customer "
                "where c_mktsegment = 'BUILDING'")[0][0]))
        fits = join_rows <= 8 * inputs
        try:
            poison()
            static = run(coord, CLUSTER_ADAPTIVE_SQL,
                         adaptive_replanning=False)
            poison()  # the static run recorded real observations
            adapt = run(coord, CLUSTER_ADAPTIVE_SQL,
                        adaptive_replanning=True)
        finally:
            QS.DIVERGENCE.forget_selectivity(*CLUSTER_POISON_KEY)
        kinds = {d["kind"]
                 for d in adapt["distribution"].get("adaptive", [])}
        audit = coord.engine.execute(
            "select kind, old_strategy, new_strategy "
            "from system.adaptive_decisions "
            "where kind = 'join-distribution'")
        if not (rows_close(static["rows"], want)
                and adapt["rows"] == static["rows"]
                and 0 < static["rungs"]
                and adapt["rungs"] <= (0 if fits else static["rungs"])
                and adapt["distribution"].get("replans", 0) >= 1
                and "join-capacity" in kinds
                and "replanned: broadcast->partitioned"
                in (coord.last_adaptive_explain or "")
                and ("join-distribution", "broadcast", "partitioned")
                in [tuple(r) for r in audit]):
            raise AssertionError(
                f"C5: rungs {static['rungs']} static, {adapt['rungs']} "
                f"adaptive ({join_rows} join rows, 8x {inputs} inputs); "
                f"{adapt['distribution']}, {audit}")
        reduced = (f"SF{conn.scale:g}: the expanding join holds 1.2e9 "
                   "rows at SF10")
        _cluster_line("C5 static (poisoned ledger)", static,
                      reduced=reduced, threshold=threshold,
                      scale=conn.scale)
        _cluster_line("C5 adaptive re-plan", adapt, reduced=reduced,
                      threshold=threshold, decisions=sorted(kinds),
                      scale=conn.scale, join_rows=join_rows,
                      fits_revise_join_bound=fits)
    return adapt["rows"]


def plain_cluster_cases(small_conn) -> None:
    """One C1 and one C2 case at SF1 with the workers on the card and
    again on the CPU (every kernel replaced by its plain version; the
    coordinator's engine stays on the card): equal rows."""
    for case, sql in (("C1 q1_shape", CLUSTER_PARTIALS["q1_shape"]),
                      ("C2 join", CLUSTER_JOIN)):
        got = {}
        for workers in ("cuda", "cpu"):
            with cluster(small_conn, workers) as coord:
                got[workers] = cluster_run(coord, sql)
        if not rows_close(got["cpu"]["rows"], got["cuda"]["rows"]):
            raise AssertionError(f"{case} SF{small_conn.scale:g}: CPU "
                                 "workers differ from card workers")
        for workers, run in got.items():
            _cluster_line(f"{case} SF{small_conn.scale:g} workers on "
                          f"{workers}", run)


def cluster_local_rows(conn) -> tuple[dict, dict]:
    """Phase 3's rows and timed seconds of the queries phase 10 holds,
    on one engine (for ``--phases cluster`` alone)."""
    from presto_tpu_torch import Engine
    engine = Engine()
    engine.register_catalog("tpch", conn)
    queries = {q: QUERIES[q] for q in ("q03", "q05", "q06", "q09",
                                       "lineitem_partsupp")}
    run_queries(engine, queries, "cuda")
    rows, secs, _notes = run_queries(engine, queries, "cuda")
    return rows, {q: {"s": secs[q]} for q in queries}


def cluster_phase(conn, scale: float, seed: int, local_rows: dict,
                  local_secs: dict) -> dict:
    """C1-C5 with every engine on the card, then the plain-version
    cases at SF1. Returns the cluster queries' launches per kernel."""
    small = (conn if scale == CLUSTER_SMALL_SCALE
             else tpch_data(CLUSTER_SMALL_SCALE, seed))
    log(f"cluster C2, C3 and C5 at SF{CLUSTER_SMALL_SCALE:g} (reduced "
        f"from SF{scale:g})")
    t = time.perf_counter()
    got = cluster_cases(conn, small, local_rows, local_secs)
    launches = got["launches"]
    log(f"cluster cuda cases: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    plain_cluster_cases(small)
    log(f"cluster plain-version cases: {time.perf_counter() - t:.1f} s")
    log("cluster launches " + json.dumps(launches))
    log("cluster " + json.dumps({
        "case": "join kernels",
        "launched": {k: launches.get(k, 0) for k in CLUSTER_JOIN_KERNELS},
        "worker_kernels": got["notes"],
        "coordinator_kernels": got["coordinator_notes"]}))
    if launches.get("segment_sum", 0) < 1 \
            or "cuda:agg_sum" not in got["notes"]:
        raise AssertionError("segment_sum did not launch on the workers: "
                             f"{launches}, {got['notes']}")
    return launches


# -- phase 11: the server tier -------------------------------------------------

# SV5's mixed clients: sixteen of these, each query twice
SERVING_MIX = ("q01", "q03", "q05", "q06", "q10", "q12", "q14", "q19")
# the kernels' lane rules at K = 8 lanes (lane_kernels)
LANES = 8


_DECIMAL_TEXT = re.compile(r"-?[0-9]+\.[0-9]+")


def wire_rows(rows) -> list:
    """Rows in one form for the engine's values and the protocol's (a
    decimal is a string on the wire, a date its ISO text): a decimal
    as a float (compared within FLOAT_STATE_RTOL), a date as its ISO
    text, numpy scalars as Python ones."""
    import datetime

    def one(v):
        if isinstance(v, (np.datetime64, datetime.date)):
            return str(v)[:10]
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, decimal.Decimal) or (
                isinstance(v, str) and _DECIMAL_TEXT.fullmatch(v)):
            return float(v)
        return v
    return [tuple(one(v) for v in row) for row in rows]


def lane_kernels(dev, seed: int) -> dict:
    """Each kernel entry's lane rule (kernels/lanes.py) on the card:
    ``torch.func.vmap`` over K = 8 lanes of the kernel phase's shapes
    cut to an eighth a lane, so the folded work has the kernel phase's
    rows. The cuda rule launches each kernel once for all lanes and
    equals the plain rule under the same vmap. ms: the batched entry
    (the fold, the launch and the unfold); bound: the bytes the K
    lanes' function needs, each input shared by the lanes read once,
    each lane's own inputs, tables and outputs once per lane, no
    filler row."""
    import torch
    from torch.func import vmap

    from presto_tpu_torch import kernels as K
    from presto_tpu_torch.kernels import build as B
    from presto_tpu_torch.kernels import hashjoin as HJ
    from presto_tpu_torch.kernels import multijoin as MJ
    from presto_tpu_torch.ops import hash as H

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    out: dict = {}

    def rand(n, hi, dtype=torch.int64):
        return torch.randint(0, hi, (n,), dtype=dtype, device=dev,
                             generator=gen)

    def check(name, fn, want_launches, nbytes):
        """fn(backend) -> tensors; the cuda rule equals the plain rule,
        and launches each kernel of ``want_launches`` once."""
        plain = fn("torch")
        B.LAUNCHES.reset()
        got = fn("cuda")
        torch.cuda.synchronize()
        launched = {k: n for k, n in B.LAUNCHES.snapshot().items() if n}
        if launched != want_launches:
            raise AssertionError(f"lanes {name}: launched {launched}, "
                                 f"want {want_launches}")
        err = require_equal(f"lanes {name}", list(zip(got, plain)))
        b_ms, b_by = bound(nbytes, 0)
        case = {"lanes": LANES, "max_abs_err": err,
                "ms": cuda_ms(lambda: fn("cuda")),
                "plain_ms": cuda_ms(lambda: fn("torch")),
                "bound_ms": b_ms, "bound_by": b_by}
        log("lanes " + json.dumps({"name": name, **case}))
        return case

    # segment_sum, max and min: a 60M-row fold into 6 groups, as 8
    # lanes of 7.5M rows whose live rows differ (dead rows id -1)
    n = 60_000_000 // LANES
    data = torch.randint(-(1 << 40), 1 << 40, (LANES, n),
                         dtype=torch.int64, device=dev, generator=gen)
    ids = torch.where(torch.rand((LANES, n), device=dev, generator=gen)
                      < 0.9, rand(LANES * n, 6, torch.int32).view(LANES, n),
                      torch.full((LANES, n), -1, dtype=torch.int32,
                                 device=dev))
    for name, kern in (("segment_sum", "agg_sum"), ("segment_max", "agg_max"),
                       ("segment_min", "agg_min")):
        out[name] = check(
            name, lambda b, kern=kern: (vmap(
                lambda d, i: K.dispatch(kern, b)(d, i, 6))(data, ids),),
            {name: 1}, LANES * n * (8 + 4) + LANES * 6 * 8)
    del data, ids

    # join_lookup: one 15M-row build side (unique keys) and 60M probes
    # shared by the lanes, each lane with its own live rows
    nb, npr = 15_000_000 // LANES, 60_000_000 // LANES
    keys = torch.randperm(4 * nb, device=dev, generator=gen)[:nb]
    bh = H.hash_int_column(keys)
    ph = H.hash_int_column(keys[rand(npr, nb)])
    bl = torch.rand((LANES, nb), device=dev, generator=gen) < 0.7
    pl = torch.rand((LANES, npr), device=dev, generator=gen) < 0.5
    cap = H.next_pow2(2 * nb)
    out["build_table"] = out["probe_table"] = check(
        "join_lookup", lambda b: vmap(
            lambda x, y: K.dispatch("join_lookup", b)(bh, x, ph, y, cap)[:2],
            in_dims=(0, 0))(bl, pl),
        {"build_table": 1, "probe_table": 1},
        # bh and ph shared; per lane: the live masks, a table, the
        # probe rows' build row and found flag
        (nb + npr) * 8 + LANES * (nb + npr + npr * (4 + 1)
                                  + cap * SLOT_BYTES))
    del keys, bh, ph, bl, pl

    # multijoin_walk: a 60M spine over three builds (1M, 100k, 25 rows),
    # the middle step keyed by the first build's column
    sizes = (1_000_000, 100_000, 25)
    n = 60_000_000 // LANES
    bkeys = [torch.arange(s, device=dev) for s in sizes]
    link = rand(sizes[0], sizes[1])
    spine_keys = [rand(n, sizes[0]), rand(n, sizes[2])]
    walk = MJ.Walk(
        build_live=[torch.ones(s, dtype=torch.bool, device=dev)
                    for s in sizes],
        build_hash=[H.hash_int_column(k) for k in bkeys],
        build_step=[0, 1, 2],
        key_hash=[H.hash_int_column(spine_keys[0]),
                  H.hash_int_column(link), H.hash_int_column(spine_keys[1])],
        key_valid=[], key_step=[0, 1, 2], key_source=[-1, 0, -1],
        key_valid_at=[-1, -1, -1])
    lives = [torch.rand((LANES, s), device=dev, generator=gen) < 0.8
             for s in sizes]
    spine_live = torch.rand((LANES, n), device=dev, generator=gen) < 0.6

    def walk_lanes(b):
        def lane(live, l0, l1, l2):
            w = dataclasses.replace(walk, build_live=[l0, l1, l2])
            g, a, _ok = K.dispatch("multijoin", b)(live, w, 1,
                                                   HJ.MAX_PROBES)
            return g, a
        return vmap(lane)(spine_live, *lives)

    # shared: the two spine key hashes, the chained key's hash over the
    # first build, the builds' hashes; per lane: the spine and build
    # live masks, every table, three gathers and the live mask out
    caps = [H.next_pow2(2 * s) for s in sizes]
    out["multijoin_walk"] = check(
        "multijoin", walk_lanes,
        {"build_table": 3, "multijoin_walk": 1},
        2 * n * 8 + sizes[0] * 8 + sum(sizes) * 8
        + LANES * (n + sum(sizes) + sum(caps) * SLOT_BYTES
                   + 3 * n * 4 + n))
    del walk, lives, spine_live, spine_keys, link, bkeys

    # filter_compact: 60M rows at 4% live (per lane), three columns
    n = 60_000_000 // LANES
    cols = {"a": rand(n, 1 << 40), "b": rand(n, 1 << 30, torch.int32),
            "c": rand(n, 1 << 40)}
    live = torch.rand((LANES, n), device=dev, generator=gen) < 0.04
    capacity = H.next_pow2(int(live.sum(1).max()))
    # per lane: the mask and the capacity rows out; the columns shared,
    # each row that some lane keeps read once (as the kernel phase
    # counts the live rows)
    kept = int(live.any(0).sum())
    out["filter_compact"] = check(
        "compact", lambda b: tuple(vmap(
            lambda lv: K.dispatch("compact", b)(lv, cols, capacity))(
                live).values()),
        {"filter_compact": 1},
        kept * 20 + LANES * (n + capacity * 20))
    del cols, live
    torch.cuda.empty_cache()
    return out


def sv_server(engine, **kw):
    from presto_tpu_torch.server import CoordinatorServer
    return CoordinatorServer(engine, **kw).start()


def counted(fn):
    """(fn(), the kernels it launched and how often): the counts set
    to 0 just before ``fn`` and read just after."""
    from presto_tpu_torch.kernels import build as B
    B.LAUNCHES.reset()
    out = fn()
    return out, {k: n for k, n in B.LAUNCHES.snapshot().items() if n}


def run_all(threads) -> None:
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def serving_cases(conn, small_conn, local_rows: dict) -> dict:
    """SV1-SV5 on the card; returns what the phase prints in its
    summary: the launches of the served runs per kernel (each request
    through the server and each batched run, the counts set to 0 just
    before it and read just after; the reference runs they are held
    against stay out), those of SV4's batched runs, SV4's group
    lines."""
    import threading

    import torch

    from presto_tpu_torch import Engine
    from presto_tpu_torch import dbapi
    from presto_tpu_torch import templates as TPL
    from presto_tpu_torch.client import Client
    from presto_tpu_torch.exec import batch as BT
    from presto_tpu_torch.exec import hostsync as HS
    from presto_tpu_torch.memory import estimate_plan_memory
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.server import serving as SV

    result: dict = {}
    served = {name: 0 for name in KERNELS}
    batched_launches = {name: 0 for name in KERNELS}

    def serve(fn, into=()):
        """Run one served request, or a set of concurrent ones, and add
        its launches to the phase's served column (and ``into``)."""
        out, launched = counted(fn)
        for name, count in launched.items():
            served[name] += count
            for more in into:
                more[name] += count
        return out, launched

    fallbacks = SV.BATCH_FALLBACKS.total()
    engine = Engine()
    engine.register_catalog("tpch", conn)
    srv = sv_server(engine)
    try:
        # SV1: the 22 TPC-H queries through dbapi, JSON then arrow
        conn_db = dbapi.connect("127.0.0.1", srv.port, user="sv1")
        client = conn_db._client
        passes = {}
        # every pass executes: the result cache stays off
        client.session_properties = {"result_cache": False}
        for label, fmt in (("cold", "json"), ("timed", "json"),
                           ("arrow", "arrow")):
            client.result_format = fmt
            total = 0.0
            for q, sql in TPCH.items():
                cur = conn_db.cursor()
                t = time.perf_counter()
                got = serve(lambda: (cur.execute(sql),
                                     cur.fetchall())[1])[0]
                total += time.perf_counter() - t
                want = wire_rows(local_rows[q])
                if not rows_close(wire_rows(got), want):
                    raise AssertionError(f"SV1 {label} {q}: rows differ "
                                         "from phase 3's")
            passes[label] = total
        log("serving " + json.dumps({"case": "SV1 tpch22", **{
            f"{k}_s": v for k, v in passes.items()}}))
        result["SV1"] = passes

        # SV2: a repeated Q1 over a memory table hits the result cache
        # with no launch and no sync; an INSERT invalidates it
        engine.register_catalog("memory", __import__(
            "presto_tpu_torch.connectors.memory",
            fromlist=["MemoryConnector"]).MemoryConnector())
        cols = ("l_returnflag, l_linestatus, l_quantity, "
                "l_extendedprice, l_discount, l_tax, l_shipdate")
        cut = int(600_000 * conn.scale)  # a tenth of the orders
        engine.execute(f"create table memory.li as select {cols} "
                       f"from tpch.lineitem where l_orderkey <= {cut}")
        q1 = TPCH["q01"].replace("from lineitem", "from memory.li")
        c2 = Client(f"http://127.0.0.1:{srv.port}", user="sv2")
        first = serve(lambda: c2.execute(q1)[1])[0]
        syncs0 = HS.SYNCS.total()
        t = time.perf_counter()
        again, launched = serve(lambda: c2.execute(q1)[1])
        hit_s = time.perf_counter() - t
        hit_launches = sum(launched.values())
        hit_syncs = HS.SYNCS.total() - syncs0
        infos = [q for q in srv.manager.snapshot() if q.sql == q1]
        if again != first or not infos[-1].cache_hit or hit_launches \
                or hit_syncs:
            raise AssertionError(
                f"SV2: hit {infos[-1].cache_hit}, launches {hit_launches},"
                f" syncs {hit_syncs}")
        serve(lambda: c2.execute(
            f"insert into memory.li select {cols} from tpch.lineitem "
            f"where l_orderkey between {cut + 1} and {cut + cut // 60}"))
        names, after = serve(lambda: c2.execute(q1))[0]
        infos = [q for q in srv.manager.snapshot() if q.sql == q1]
        count_col = [c["name"] for c in names].index("count_order")
        if infos[-1].cache_hit or sum(r[count_col] for r in after) <= sum(
                r[count_col] for r in first):
            raise AssertionError("SV2: the INSERT did not invalidate Q1")
        log("serving " + json.dumps({
            "case": "SV2 q01 result cache", "hit_s": hit_s,
            "launches": hit_launches, "host_syncs": hit_syncs,
            "invalidated": True}))
        engine.execute("drop table memory.li")

        # SV3: 8 concurrent identical Q5s make one execution: the
        # first one's; the others await it in flight (dedup) or, if
        # they come after it, hit its cached result
        one_run = counted(lambda: engine.execute(TPCH["q05"]))[1]
        barrier = threading.Barrier(8)
        got3: list = []
        sql5 = TPCH["q05"]

        def q5_client():
            c = Client(f"http://127.0.0.1:{srv.port}", user="sv3")
            barrier.wait()
            got3.append(c.execute(sql5)[1])

        threads = [threading.Thread(target=q5_client) for _ in range(8)]
        t = time.perf_counter()
        launched = serve(lambda: run_all(threads))[1]
        dedup_s = time.perf_counter() - t
        mine = [q for q in srv.manager.snapshot() if q.sql == sql5]
        deduped = sum(q.deduped for q in mine)
        hits = sum(q.cache_hit for q in mine)
        want5 = wire_rows(local_rows["q05"])
        if any(not rows_close(wire_rows(r), want5) for r in got3) \
                or launched != one_run or deduped + hits != 7:
            raise AssertionError(f"SV3: launches {launched} vs one run "
                                 f"{one_run}, {deduped} deduped, {hits} "
                                 "cache hits")
        log("serving " + json.dumps({
            "case": "SV3 8 x q05 one execution", "s": dedup_s,
            "deduped": deduped, "cache_hits": hits,
            "launches": launched}))
    finally:
        srv.stop()

    # SV4: batch groups of 8 variants, one per kernel case. A plan that
    # could stream is not batchable (the reference's rule), and at SF10
    # lineitem's 60M rows pass the default scan block (2^24 rows): the
    # groups and their serial runs go without streaming
    batched_total = REGISTRY.counter("presto_tpu_batched_queries_total")
    small = Engine()
    small.register_catalog("tpch", small_conn)
    groups = {}
    serial_rows = {}
    for case, kernels in BATCH_KERNELS.items():
        eng = small if BATCH_SF.get(case) else engine
        eng.session.set("scan_block_rows", 0)
        sf = BATCH_SF.get(case, conn.scale)
        sqls = batch_variants(case, sf)
        eng.session.set("kernel_backend", "torch")
        plain = [eng.execute(s) for s in sqls]
        eng.session.set("kernel_backend", "cuda")
        serial = [eng.execute(s) for s in sqls]  # cold: capacities
        serial_rows[case] = dict(zip(sqls, serial))
        one_run = counted(lambda: eng.execute(sqls[0]))[1]
        tpls = [TPL.parameterize(eng.plan_sql(s)[0]) for s in sqls]
        if not BT.batchable(eng, tpls[0].plan):
            raise AssertionError(f"SV4 {case}: not batchable")
        torch.cuda.synchronize()
        t = time.perf_counter()
        # cold: the batch's capacities
        serve(lambda: BT.run_plan_batched(eng, tpls),
              into=(batched_launches,))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        before = batched_total.value()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        lanes, launched = serve(lambda: BT.run_plan_batched(eng, tpls),
                                into=(batched_launches,))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 1e9
        for sql, lane, s_rows, p_rows in zip(sqls, lanes, serial, plain):
            got = lane.to_pylist()
            if not rows_close(got, s_rows) or not rows_close(got, p_rows):
                raise AssertionError(f"SV4 {case}: a lane differs from "
                                     f"its serial run: {sql}")
        on_card = eng.device.type == "cuda"
        if launched != one_run or (on_card
                                   and not set(kernels) <= set(launched)):
            raise AssertionError(f"SV4 {case}: batch launched {launched}, "
                                 f"one serial run {one_run}")
        if batched_total.value() != before + len(sqls):
            raise AssertionError(f"SV4 {case}: batched counter moved "
                                 f"{batched_total.value() - before}")
        serial_s = 0.0
        for s in sqls:
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.execute(s)
            torch.cuda.synchronize()
            serial_s += time.perf_counter() - t
        groups[case] = {"lanes": len(sqls), "sf": sf, "s": secs,
                        "cold_s": cold, "serial_s": serial_s,
                        "peak_gb": peak, "launches": launched}
        log("serving " + json.dumps({"case": f"SV4 {case}",
                                     **groups[case]}))
    engine.session.properties.pop("scan_block_rows")
    del small

    # the Q6 group again as 8 concurrent clients inside one batch
    # window: the serving layer's own route, whose fallback to serial
    # runs (a batched run that raised) must not fire
    srv = sv_server(engine)
    try:
        want4 = serial_rows["q06"]
        barrier = threading.Barrier(len(want4))
        got4: dict = {}

        def variant(sql):
            c = Client(f"http://127.0.0.1:{srv.port}", user="sv4")
            c.session_properties = {"result_cache": False,
                                    "subplan_dedup": False,
                                    "scan_block_rows": 0,
                                    "batch_window_ms": 300.0}
            barrier.wait()
            got4[sql] = c.execute(sql)[1]

        threads = [threading.Thread(target=variant, args=(s,))
                   for s in want4]
        t = time.perf_counter()
        launched = serve(lambda: run_all(threads))[1]
        secs = time.perf_counter() - t
        marks = [q.batched for q in srv.manager.snapshot()
                 if q.sql in want4]
        moved = SV.BATCH_FALLBACKS.total() - fallbacks
        if any(not rows_close(wire_rows(got4.get(s, [])), wire_rows(w))
               for s, w in want4.items()) or not any(
                   b > 1 for b in marks) or moved:
            raise AssertionError(f"SV4 served q06: batched {marks}, "
                                 f"{moved} fallbacks")
        log("serving " + json.dumps({
            "case": "SV4 q06 served", "s": secs, "batched": marks,
            "fallbacks": moved, "launches": launched}))
    finally:
        srv.stop()

    # SV5: 16 clients of mixed queries under a query-pool capacity
    est = {q: estimate_plan_memory(engine.plan_sql(TPCH[q])[0], engine)[0]
           for q in SERVING_MIX}
    capacity = sum(sorted(est.values())[-2:])
    engine.session.set("memory_reserve_timeout_s", 20.0)
    engine.session.set("low_memory_killer_delay_s", 600.0)
    srv = sv_server(engine, query_memory_bytes=capacity)
    try:
        res: dict = {}
        torch.cuda.reset_peak_memory_stats()

        def mixed(i):
            q = SERVING_MIX[i % len(SERVING_MIX)]
            c = Client(f"http://127.0.0.1:{srv.port}", user=f"sv5-{i}")
            c.session_properties = {"result_cache": False,
                                    "subplan_dedup": False}
            try:
                res[i] = (q, c.execute(TPCH[q])[1])
            except Exception as e:  # noqa: BLE001 - reported below
                res[i] = (q, e)

        threads = [threading.Thread(target=mixed, args=(i,))
                   for i in range(16)]
        t = time.perf_counter()
        serve(lambda: run_all(threads))
        mix_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 1e9
        for i, (q, got) in sorted(res.items()):
            if isinstance(got, Exception) or not rows_close(
                    wire_rows(got), wire_rows(local_rows[q])):
                raise AssertionError(f"SV5 client {i} {q}: {got!r:.300}")
        pool_left = srv.manager.query_pool.reserved
        if pool_left or engine.memory_pool.reserved:
            raise AssertionError("SV5: reservations left behind")
        log("serving " + json.dumps({
            "case": "SV5 16 mixed clients", "s": mix_s,
            "capacity_gb": capacity / 1e9, "peak_gb": peak,
            "estimates_gb": {q: v / 1e9 for q, v in est.items()}}))

        # a small pool: the largest reservation (a running query that
        # scans a stalling blackhole table) is killed while the
        # queries blocked behind it finish
        from presto_tpu_torch import BIGINT
        from presto_tpu_torch.connectors.blackhole import BlackholeConnector
        bh = BlackholeConnector(rows_per_table=10,
                                page_processing_delay_s=5.0)
        bh.create_table("slow", {"x": BIGINT}, {"x": []}, {"x": None})
        engine.register_catalog("bh", bh)
        slow_sql = "select count(*) from bh.slow"
        engine.session.set("low_memory_killer_delay_s", 0.5)
        # room for one survivor at a time, not beside the victim
        srv.manager.query_pool.capacity = max(est["q06"], est["q14"])
        victim = Client(f"http://127.0.0.1:{srv.port}", user="victim")
        survivors: dict = {}

        def small_q(q):
            c = Client(f"http://127.0.0.1:{srv.port}", user="survivor")
            c.session_properties = {"result_cache": False,
                                    "subplan_dedup": False}
            try:
                survivors[q] = c.execute(TPCH[q])[1]
            except Exception as e:  # noqa: BLE001 - reported below
                survivors[q] = e

        def kill_round():
            qid, _ = victim.submit(slow_sql)
            for _ in range(400):
                if srv.manager.query_pool.reserved:
                    break
                time.sleep(0.01)
            run_all([threading.Thread(target=small_q, args=(q,))
                     for q in ("q06", "q14")])
            for _ in range(600):
                if victim.query_state(qid) not in ("QUEUED", "RUNNING"):
                    break
                time.sleep(0.05)
            return qid
        qid = serve(kill_round)[0]
        info = srv.manager.get(qid)
        if info.error_name != "CLUSTER_OUT_OF_MEMORY" \
                or "low-memory killer" not in (info.error or ""):
            raise AssertionError(f"SV5 kill: {info.state} "
                                 f"{info.error_name} {info.error}")
        for q in ("q06", "q14"):
            got = survivors.get(q)
            if not isinstance(got, list) or not rows_close(
                    wire_rows(got), wire_rows(local_rows[q])):
                raise AssertionError(f"SV5 kill: {q}: {got!r:.300}")
        log("serving " + json.dumps({
            "case": "SV5 low-memory kill", "victim": slow_sql,
            "error": info.error_name, "survivors": sorted(survivors)}))
    finally:
        srv.stop()
        engine.session.set("memory_reserve_timeout_s", 0.0)
        engine.session.set("low_memory_killer_delay_s", 5.0)
    moved = SV.BATCH_FALLBACKS.total() - fallbacks
    if moved:
        raise AssertionError(f"serving: {moved} batch groups fell back "
                             "to serial runs")
    result["groups"] = groups
    result["launches"] = served
    result["batched_launches"] = batched_launches
    return result


def serving_local_rows(conn) -> dict:
    """Phase 3's rows of the 22 queries on one engine (for
    ``--phases serving`` alone)."""
    from presto_tpu_torch import Engine
    engine = Engine()
    engine.register_catalog("tpch", conn)
    rows, _secs, _notes = run_queries(engine, TPCH, "cuda")
    return rows


def serving_phase(conn, scale: float, seed: int, local_rows: dict,
                  dev) -> dict:
    """Phase 11: the kernels' lane rules, then SV1-SV5. Returns the
    launches of the served runs (serving_cases), the lane rules'
    measurements and the batched launches."""
    lanes = lane_kernels(dev, seed)
    small = tpch_data(BATCH_SF["q05"], seed)
    cases = serving_cases(conn, small, local_rows)
    log("serving launches " + json.dumps(cases["launches"]))
    return {"lanes": lanes, **cases}



# -- phase 12: SQL over parquet files at SF1 ---------------------------------

PARQUET_SCALE = 1.0
# phase 3's queries that reach every kernel, over parquet files and over
# the tpch connector
PARQUET_QUERIES = ("q01", "q03", "q06", "q09", "lineitem_partsupp",
                   "lineitem_extrema", "cross_join")
# phase 3's queries that do not fit the card over the files, each with
# its blocker (ROADMAP's open items): the phase requires the
# out-of-memory error, so that one that starts to fit is moved back
PARQUET_OVER_MEMORY = {
    "q05": "the files declare no keys and no distinct counts, so the "
           "planner (as the reference's) joins lineitem's ASIA suppliers "
           "to customer on s_nationkey = c_nationkey before orders: "
           "every such lineitem row meets every customer of its "
           "supplier's nation (needs key or distinct-count statistics "
           "for parquet tables)"}
# written uncompressed and dictionary-encoded; the other tables snappy
PARQUET_PLAIN_TABLES = ("lineitem", "orders")
PARQUET_V2_TABLE = "orders"  # its data pages of version 2.0
PARQUET_SORTED_ROW_GROUP = 1 << 20  # the l_shipdate-sorted lineitem's


def arrow_table(table):
    """A TPC-H host Table as a pyarrow table, every column at its type:
    VARCHAR a dictionary array of the column's codes, DECIMAL decimal128
    of its scaled integers, DATE date32, BIGINT int64."""
    import pyarrow as pa

    from presto_tpu_torch import types as T
    cols = {}
    for name, col in table.columns.items():
        if col.valid is not None:
            raise ValueError(f"{name}: a TPC-H column has no NULL")
        data = np.asarray(col.data)
        dt = col.dtype
        if isinstance(dt, T.VarcharType):
            cols[name] = pa.DictionaryArray.from_arrays(
                pa.array(data.astype(np.int32)),
                pa.array(list(col.dictionary), pa.string()))
        elif isinstance(dt, T.DecimalType):
            # decimal128's little-endian words: a short decimal's high
            # word is its sign
            words = (data if data.ndim == 2
                     else np.stack([data, data >> 63], axis=1))
            cols[name] = pa.Array.from_buffers(
                pa.decimal128(dt.precision, dt.scale), len(words),
                [None, pa.py_buffer(
                    np.ascontiguousarray(words, "<i8").tobytes())])
        elif isinstance(dt, T.DateType):
            cols[name] = pa.array(data.astype(np.int32), pa.date32())
        else:
            cols[name] = pa.array(data)
    return pa.table(cols)


def write_tpch_parquet(conn, tables_dir: str, sorted_dir: str,
                       sorted_row_group: int = PARQUET_SORTED_ROW_GROUP
                       ) -> dict:
    """Write the connector's eight tables into ``tables_dir`` with
    pyarrow (lineitem and orders uncompressed and dictionary-encoded,
    orders in version 2.0 data pages, the others snappy) and lineitem
    sorted by l_shipdate, in row groups of ``sorted_row_group`` rows,
    into ``sorted_dir``. Returns per file its seconds and bytes."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq
    out = {}
    for name in conn.table_names():
        t = time.perf_counter()
        kw = (dict(compression="none", use_dictionary=True)
              if name in PARQUET_PLAIN_TABLES else
              dict(compression="snappy"))
        if name == PARQUET_V2_TABLE:
            kw["data_page_version"] = "2.0"
        path = os.path.join(tables_dir, f"{name}.parquet")
        pq.write_table(arrow_table(conn.table(name)), path, **kw)
        out[name] = {"write_s": time.perf_counter() - t,
                     "file_bytes": os.path.getsize(path)}
    t = time.perf_counter()
    li = conn.table("lineitem")
    order = np.argsort(np.asarray(li.columns["l_shipdate"].data),
                       kind="stable")
    path = os.path.join(sorted_dir, "lineitem.parquet")
    pq.write_table(arrow_table(li).take(pa.array(order)), path,
                   compression="none", row_group_size=sorted_row_group)
    out["lineitem (sorted)"] = {"write_s": time.perf_counter() - t,
                                "file_bytes": os.path.getsize(path)}
    return out


def q05_keyless_expansion(conn) -> int:
    """The rows of Q5's join of lineitem (its suppliers in ASIA) with
    customer on the nation alone, as planned over files without keys,
    counted with numpy over the generator's arrays."""
    supp, _ = _host(conn, "supplier", "s_suppkey")
    s_nation, _ = _host(conn, "supplier", "s_nationkey")
    nation, _ = _host(conn, "nation", "n_nationkey")
    n_region, _ = _host(conn, "nation", "n_regionkey")
    region, _ = _host(conn, "region", "r_regionkey")
    r_name, _ = _host(conn, "region", "r_name")
    asia = np.isin(n_region, region[r_name == "ASIA"])
    nation_of = np.full(int(supp.max()) + 1, -1, np.int64)
    nation_of[supp.astype(np.int64)] = s_nation
    l_nation = nation_of[_host(conn, "lineitem", "l_suppkey")[0]
                         .astype(np.int64)]
    per_nation = np.bincount(
        _host(conn, "customer", "c_nationkey")[0].astype(np.int64),
        minlength=int(nation.max()) + 1)
    l_nation = l_nation[np.isin(l_nation, nation[asia])]
    return int(per_nation[l_nation].sum())


def kept_row_groups(engine, sql: str) -> list[int]:
    """The row groups each parquet scan of ``sql``'s plan keeps after
    the optimizer offered its filter to the connector's apply_filter."""
    from presto_tpu_torch.connectors.parquet import ParquetConnector
    from presto_tpu_torch.exec.executor import _preorder
    from presto_tpu_torch.plan import nodes as N
    plan, _ = engine.plan_sql(sql)
    out = []
    for node in _preorder(plan):
        if isinstance(node, N.TableScan):
            conn = engine.catalogs[node.catalog]
            _base, keep = ParquetConnector._parse_name(node.table)
            files = conn._meta(node.table)
            out.append(sum(len(keep[fi]) if keep is not None and fi in keep
                           else len(f.row_groups)
                           for fi, f in enumerate(files)))
    return out


def parquet_cases(conn, workdir: str,
                  sorted_row_group: int = PARQUET_SORTED_ROW_GROUP,
                  over_memory: bool = True) -> dict:
    """Phase 12 over ``conn``'s tables written to ``workdir``: the
    write, each table's host decode and upload, ``PARQUET_QUERIES``
    over the files (``sweep``: a first cuda pass, a timed cuda pass
    between a reset and a read of the launch counts, the plain pass)
    held against the same queries over ``conn`` on the card (rows; the
    kernel tags of both logged side by side), ``PARQUET_OVER_MEMORY``
    on the card with its out-of-memory error required (``over_memory``),
    and Q6 over the sorted lineitem with its row groups pruned. Returns
    the launches of the timed parquet runs and the kernels their plans'
    tags name."""
    import os

    import torch

    from presto_tpu_torch import Engine
    from presto_tpu_torch.connectors.parquet import ParquetConnector
    tables_dir = os.path.join(workdir, "tables")
    sorted_dir = os.path.join(workdir, "sorted")
    os.makedirs(tables_dir)
    os.makedirs(sorted_dir)
    written = write_tpch_parquet(conn, tables_dir, sorted_dir,
                                 sorted_row_group)
    pconn = ParquetConnector(tables_dir)
    engine = Engine()
    engine.register_catalog("tpch", pconn)
    for name in pconn.table_names():
        t = time.perf_counter()
        table = pconn.table(name)
        read_s = time.perf_counter() - t
        arrays = [a for col in table.columns.values()
                  for a in (col.data, col.valid) if a is not None]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for a in arrays:
            engine.device_array(a)
        torch.cuda.synchronize()
        log("parquet " + json.dumps({
            "table": name, "rows": table.nrows, **written[name],
            "read_s": read_s, "upload_s": time.perf_counter() - t,
            "upload_bytes": sum(int(np.asarray(a).nbytes)
                                for a in arrays)}))
    queries = {q: QUERIES[q] for q in PARQUET_QUERIES}
    ref = Engine()
    ref.register_catalog("tpch", conn)
    run_queries(ref, queries, "cuda")  # uploads, learns the capacities
    want, want_s, want_notes = run_queries(ref, queries, "cuda")
    (rows, secs, notes, launches, plain_rows, plain_secs,
     plain_notes) = sweep(engine, queries)
    faults = []
    tags: set = set()
    for q in queries:
        for backend, got in (("cuda", rows[q]), ("torch", plain_rows[q])):
            if not rows_close(got, want[q]):
                faults.append(f"{q} over parquet ({backend}) differs from "
                              "the tpch connector's rows")
        tags.update(t.split(":", 1)[1] for t in notes[q]["kernels"])
        log("parquet " + json.dumps({
            "query": q, "rows": len(rows[q]), "s": secs[q],
            "plain_s": plain_secs[q], "tpch_s": want_s[q], **notes[q],
            "plain_kernels": plain_notes[q]["kernels"],
            "tpch_kernels": want_notes[q]["kernels"]}))
    for q, blocker in (PARQUET_OVER_MEMORY.items() if over_memory else ()):
        require_over_memory(
            engine, q, QUERIES[q], blocker,
            {"expanding_join_rows": q05_keyless_expansion(conn)},
            "parquet", "PARQUET_OVER_MEMORY")
    # Q6 over the l_shipdate-sorted lineitem: the optimizer offers its
    # date range to apply_filter, which keeps the row groups whose
    # min/max statistics can hold it
    sconn = ParquetConnector(sorted_dir)
    sorted_engine = Engine()
    sorted_engine.register_catalog("tpch", sconn)
    groups = len(sconn._meta("lineitem")[0].row_groups)
    kept = kept_row_groups(sorted_engine, QUERIES["q06"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    got, launched = counted(lambda: sorted_engine.execute(QUERIES["q06"]))
    torch.cuda.synchronize()
    for name, n in launched.items():
        launches[name] = launches.get(name, 0) + n
    if not rows_close(got, want["q06"]):
        faults.append("q06 over the sorted lineitem differs from the tpch "
                      "connector's rows")
    if not kept or kept[0] >= groups:
        faults.append(f"q06 over the sorted lineitem kept {kept} of "
                      f"{groups} row groups")
    log("parquet " + json.dumps({
        "query": "q06 sorted", "row_groups": groups, "kept": kept,
        "s": time.perf_counter() - t, "launches": launched}))
    if faults:
        raise AssertionError("parquet faults:\n" + "\n".join(faults))
    return {"launches": launches, "rows": rows,
            "kernels": sorted({k for t in tags for k in TAG_KERNELS[t]})}


def parquet_phase(seed: int) -> dict:
    """Phase 12: the TPC-H tables at ``PARQUET_SCALE`` through parquet
    files (the data made again at that scale). pyarrow writes them;
    where it does not import, the phase raises. Every kernel that the
    parquet plans tag must launch; the files declare no keys, so the
    planner finds no unique join and the kernels of those
    (``build_table``, ``probe_table``, ``multijoin_walk``) are not on
    this path. Returns the launches."""
    import shutil
    import tempfile

    import pyarrow  # noqa: F401 - the writer; raises where it is absent
    conn = tpch_data(PARQUET_SCALE, seed)
    workdir = tempfile.mkdtemp(prefix="presto_tpu_parquet-")
    try:
        out = parquet_cases(conn, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = out["launches"]
    log("parquet launches " + json.dumps(
        {**launches, "tagged": out["kernels"],
         "not_on_path": [k for k in KERNELS if k not in out["kernels"]]}))
    silent = [k for k in out["kernels"] if not launches.get(k)]
    if not out["kernels"] or silent:
        raise AssertionError(f"parquet scans launched no {silent} of the "
                             f"tagged {out['kernels']}")
    return launches


# -- phase 13: the device observatory at SF10 --------------------------------

# a group-by whose table, sized by ``OBSERVE_TABLE_SIZE``, overflows
# once: one rung of the capacity ladder
OBSERVE_RUNG_SQL = ("select o_custkey % 7 as k, count(*) as c from orders "
                    "group by o_custkey % 7 order by k")
OBSERVE_TABLE_SIZE = 2
# O1's first passes of Q5 with and without the count, alternately
OBSERVE_FIRST_PASS_PAIRS = 5
OBSERVE_WORKER_SQL = ("select l_returnflag, count(*) as c, "
                      "sum(l_quantity) as q from lineitem "
                      "group by l_returnflag order by l_returnflag")
# the port's CUDA kernels as a trace names them (kernels/csrc/*.cu)
PORT_KERNEL_NAMES = ("seg_sum_", "seg_cmp_", "build_table_kernel",
                     "probe_table_kernel", "build_part_kernel",
                     "part_count_kernel", "part_scatter_kernel",
                     "multijoin_walk_kernel", "compact_kernel",
                     "zero_tail_kernel")
PROCESS_GAUGES = ("presto_tpu_process_rss_bytes",
                  "presto_tpu_process_threads",
                  "presto_tpu_process_uptime_seconds")


def trace_kernels(artifact: str,
                  names: tuple = PORT_KERNEL_NAMES) -> list[str]:
    """The events of a capture's Chrome trace named like ``names``
    (default: the port's kernels)."""
    import os

    from presto_tpu_torch.obs import devprof
    with open(os.path.join(artifact, devprof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if any(k in str(e.get("name", "")) for k in names)})


def _op_rows(engine, qid: str) -> list:
    return engine.execute(
        "select plan_node_id, node_type, flops, hbm_bytes, intensity, "
        f"roofline from system.operator_stats where query_id = '{qid}'")


def check_costs(engine, qid: str, costs: list) -> dict:
    """Every operator row of query ``qid`` carries nonzero flops,
    hbm_bytes, intensity and roofline, and each program's rows sum to
    its harvested flops within rounding (one per row)."""
    ops = _op_rows(engine, qid)
    bad = [r for r in ops if not all(r[2:])]
    if not ops or bad:
        raise AssertionError(f"{qid}: operator rows without a cost: "
                             f"{bad or 'none at all'}")
    sums: dict = {}
    for r in ops:
        program = str(r[0]).split(".")[0]
        n, total = sums.get(program, (0, 0))
        sums[program] = (n + 1, total + int(r[2]))
    harvested = [c["flops"] for c in costs if c is not None]
    got = [sums[p] for p in sorted(sums, key=int)]
    if len(got) != len(harvested) or any(
            abs(total - want) > n
            for (n, total), want in zip(got, harvested)):
        raise AssertionError(f"{qid}: operator flops {got} against the "
                             f"harvested {harvested}")
    return {"operators": len(ops), "programs": len(got),
            "flops": harvested,
            "roofline": [min(r[5] for r in ops), max(r[5] for r in ops)]}


def observe_cases(conn, worker_conn, q05_rows=None,
                  trace_names: tuple = PORT_KERNEL_NAMES) -> dict:
    """O1-O5 over ``conn`` (a worker over ``worker_conn``), with
    ``PRESTO_TPU_PROFILE_DIR`` a fresh directory; O2's trace must name
    one of ``trace_names``. Returns the launches of the runs it
    drives."""
    import os
    import shutil
    import tempfile
    import urllib.request

    import torch

    from presto_tpu_torch import Engine
    from presto_tpu_torch.events import QueryCompletedEvent
    from presto_tpu_torch.obs import devprof
    from presto_tpu_torch.obs.metrics import REGISTRY
    from presto_tpu_torch.parallel.coordinator import ClusterCoordinator
    from presto_tpu_torch.parallel.worker import WorkerServer

    launches: dict = {name: 0 for name in KERNELS}
    harvests = REGISTRY.counter("presto_tpu_cost_harvests_total")

    def run(engine, sql):
        """(rows, seconds, harvests, query id, costs, rungs), launches
        counted."""
        qids: list = []
        engine.events.add_listener(
            lambda ev: qids.append(ev.query_id)
            if isinstance(ev, QueryCompletedEvent) else None)
        h0 = harvests.total()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows, launched = counted(lambda: engine.execute(sql))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        for name, n in launched.items():
            launches[name] += n
        return (rows, secs, harvests.total() - h0, qids[-1],
                list(engine.last_run.costs), engine.last_run.rungs)

    profile_dir = tempfile.mkdtemp(prefix="presto_tpu_profiles-")
    saved = os.environ.get(devprof.ENV_PROFILE_DIR)
    os.environ[devprof.ENV_PROFILE_DIR] = profile_dir
    out: dict = {}
    try:
        q05 = QUERIES["q05"]

        def first_pass(count: bool):
            """Q5 on a fresh engine (a program-cache miss, the tables
            uploaded again), its programs' costs forgotten (counted) or
            known to the process (not counted)."""
            if count:
                devprof.forget_costs()
            fresh = Engine()
            fresh.register_catalog("tpch", conn)
            r = run(fresh, q05)
            del fresh
            gc.collect()
            torch.cuda.empty_cache()
            return r
        # O1: Q5's first pass with and without the count, alternately
        # after one that makes its costs known (and warms the host),
        # then a fresh engine's cold run and its hit: neither counts
        first_pass(False)
        passes = {False: [], True: []}
        for count in (False, True) * OBSERVE_FIRST_PASS_PAIRS:
            passes[count].append(first_pass(count))
        engine = Engine()
        engine.register_catalog("tpch", conn)
        cold = run(engine, q05)
        hit = run(engine, q05)
        engine.session.set("device_profile", True)
        prof = run(engine, q05)
        prof_again = run(engine, q05)
        engine.session.set("device_profile", False)
        if q05_rows is not None and not rows_close(cold[0], q05_rows):
            raise AssertionError("O1: Q5 differs from phase 3's rows")
        runs = passes[False] + passes[True] + [hit, prof, prof_again]
        if any(r[0] != cold[0] for r in runs):
            raise AssertionError("O1: Q5's runs differ")
        if None in cold[4] or cold[2] or hit[2] or prof[2] or prof_again[2] \
                or any(r[2] for r in passes[False]) \
                or any(r[2] != len(cold[4]) for r in passes[True]) \
                or any(r[4] != cold[4] for r in runs):
            raise AssertionError(
                f"O1: costs {[r[4] for r in runs]}, harvests "
                f"{[r[2] for r in runs]}")
        known_s = [r[1] for r in passes[False]]
        counted_s = [r[1] for r in passes[True]]
        out["O1"] = {"first_s": known_s, "first_counted_s": counted_s,
                     "harvest_cost_s": float(np.median(counted_s)
                                             - np.median(known_s)),
                     "first_rungs": [r[5] for r in passes[True]],
                     "programs": len(cold[4]),
                     "cold_s": cold[1], "cold_harvests": cold[2],
                     "hit_s": hit[1], "hit_harvests": hit[2],
                     "costs": cold[4]}
        log("observe " + json.dumps({"case": "O1 q05 harvest",
                                     **out["O1"]}))
        # O2: Q5 under device_profile: a Chrome trace naming the kernels
        from presto_tpu_torch.obs import qstats as QS
        record = QS.STORE.get(prof[3])
        artifact = None if record is None else record.snapshot()["profile"]
        if artifact is None or not artifact.startswith(profile_dir):
            raise AssertionError(f"O2: no profile artifact ({artifact})")
        names = trace_kernels(artifact, trace_names)
        if not names:
            raise AssertionError(f"O2: the trace names none of "
                                 f"{trace_names}")
        out["O2"] = {"s": prof[1], "again_s": prof_again[1],
                     "hit_s": hit[1],
                     "profile_cost_s": prof[1] - hit[1],
                     "again_cost_s": prof_again[1] - hit[1],
                     "trace_bytes": os.path.getsize(os.path.join(
                         artifact, devprof.TRACE_FILE)),
                     "kernels": names}
        log("observe " + json.dumps({"case": "O2 q05 device_profile",
                                     **out["O2"]}))
        # O3: system.operator_stats of the cold run and of the hit
        out["O3"] = {"cold": check_costs(engine, cold[3], cold[4]),
                     "hit": check_costs(engine, hit[3], hit[4])}
        log("observe " + json.dumps({"case": "O3 operator_stats",
                                     **out["O3"]}))
        # O4: a card worker's profile endpoints around a task, and its
        # /metrics
        worker = WorkerServer({"tpch": worker_conn}, device="cuda").start()
        local = Engine()
        local.register_catalog("tpch", worker_conn)
        coord = ClusterCoordinator(local).start()
        try:
            coord.add_worker(worker.uri)
            wait_all_live(coord)

            def post(path):
                req = urllib.request.Request(worker.uri + path, data=b"{}",
                                             method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read())
            started = post("/v1/profile/start")
            got, launched = counted(
                lambda: coord.execute(OBSERVE_WORKER_SQL))
            for name, n in launched.items():
                launches[name] += n
            stopped = post("/v1/profile/stop")
            with urllib.request.urlopen(worker.uri + "/metrics",
                                        timeout=60) as r:
                metrics = r.read().decode()
        finally:
            coord.stop()
            worker.stop()
        if got != local.execute(OBSERVE_WORKER_SQL):
            raise AssertionError("O4: the worker's rows differ")
        if (started[0], stopped[0]) != (200, 200) \
                or stopped[1].get("artifact") != started[1].get("dir"):
            raise AssertionError(f"O4: profile endpoints {started} "
                                 f"{stopped}")
        gauges = {g: f'{g}{{node="{worker.node_id}"}}' in metrics
                  for g in PROCESS_GAUGES}
        if not all(gauges.values()):
            raise AssertionError(f"O4: /metrics lacks {gauges}")
        out["O4"] = {"kernels": trace_kernels(stopped[1]["artifact"],
                                              trace_names),
                     "gauges": sorted(gauges), "launches": launched}
        log("observe " + json.dumps({"case": "O4 worker profile",
                                     **out["O4"]}))
        # O5: a group-by table hinted too small climbs rungs; each rung
        # counts once in the retry counter
        retries = REGISTRY.counter(
            "presto_tpu_capacity_overflow_retries_total")
        probes = REGISTRY.counter("presto_tpu_hash_probe_overflow_total")
        want = run(engine, OBSERVE_RUNG_SQL)
        fresh = Engine()
        fresh.register_catalog("tpch", conn)
        fresh.session.set("groupby_table_size", OBSERVE_TABLE_SIZE)
        r0, p0 = retries.total(), probes.total()
        small = run(fresh, OBSERVE_RUNG_SQL)
        delta = retries.total() - r0
        if small[0] != want[0] or not small[5] or delta != small[5]:
            raise AssertionError(
                f"O5: {small[5]} rungs, retries counted {delta}")
        out["O5"] = {"rungs": small[5], "retries": delta,
                     "probe_overflows": probes.total() - p0,
                     "s": small[1]}
        log("observe " + json.dumps({"case": "O5 forced rung",
                                     **out["O5"]}))
    finally:
        if saved is None:
            os.environ.pop(devprof.ENV_PROFILE_DIR, None)
        else:
            os.environ[devprof.ENV_PROFILE_DIR] = saved
        shutil.rmtree(profile_dir, ignore_errors=True)
    out["launches"] = launches
    return out


def observe_phase(conn, seed: int, q05_rows=None) -> dict:
    """Phase 13 over phase 3's SF10 tables (made again when it did not
    run); the worker of O4 over SF1. Returns the launches."""
    worker_conn = tpch_data(CLUSTER_SMALL_SCALE, seed)
    launches = observe_cases(conn, worker_conn, q05_rows)["launches"]
    log("observe launches " + json.dumps(launches))
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

    kernels, launches, conn, tpch_rows, tpch_queries = {}, {}, None, {}, {}

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
        launches, tpch_queries, tpch_rows = query_phase(conn)
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
    if "statements" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        launches = add(statements_phase(conn or tpch_data(args.scale,
                                                          args.seed),
                                        tpch_rows.get("q05")))
        log(f"statements phase: {time.perf_counter() - t:.1f} s")
    if "distributed" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        conn = conn or tpch_data(args.scale, args.seed)
        if not tpch_rows:
            # phase 3 did not run: its single-engine rows and times
            tpch_rows, tpch_queries = dist_local_rows(conn)
        launches = add(distributed_phase(
            conn, tpch_rows, {q: v["s"] for q, v in tpch_queries.items()}))
        log(f"distributed phase: {time.perf_counter() - t:.1f} s")
    if "cluster" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        conn = conn or tpch_data(args.scale, args.seed)
        if not tpch_rows:
            # phases 3 and 9 did not run: the single-engine rows and
            # times of the queries phase 10 holds
            tpch_rows, tpch_queries = cluster_local_rows(conn)
        launches = add(cluster_phase(
            conn, args.scale, args.seed, tpch_rows,
            {q: v["s"] for q, v in tpch_queries.items()}))
        log(f"cluster phase: {time.perf_counter() - t:.1f} s")
    serving: dict = {}
    if "serving" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        conn = conn or tpch_data(args.scale, args.seed)
        if not all(q in tpch_rows for q in TPCH):
            # phase 3 did not run: its rows of the 22 queries
            tpch_rows = {**tpch_rows, **serving_local_rows(conn)}
        serving = serving_phase(conn, args.scale, args.seed, tpch_rows,
                                dev)
        launches = add(serving["launches"])
        log(f"serving phase: {time.perf_counter() - t:.1f} s")
    if "parquet" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        parquet = parquet_phase(args.seed)
        launches = add(parquet)
        log(f"parquet phase: {time.perf_counter() - t:.1f} s")
    if "observe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        conn = conn or tpch_data(args.scale, args.seed)
        observe = observe_phase(conn, args.seed, tpch_rows.get("q05"))
        launches = add(observe)
        log(f"observe phase: {time.perf_counter() - t:.1f} s")
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
                        "redesigned_in": REDESIGNED_IN[name],
                        # phase 11: the serving cases' launches, those
                        # of SV4's batch groups among them, and the
                        # lane rule at K = 8 lanes (lane_kernels)
                        "serving_launches": serving["launches"][name],
                        "batched_launches":
                            serving["batched_launches"][name],
                        "batched_ms": serving["lanes"][name]["ms"],
                        "batched_plain_ms":
                            serving["lanes"][name]["plain_ms"],
                        "batched_bound_ms":
                            serving["lanes"][name]["bound_ms"],
                        "batched_max_abs_err":
                            serving["lanes"][name]["max_abs_err"],
                        # phases 12 and 13: the parquet scans' and the
                        # observatory's runs
                        "parquet_launches": parquet.get(name, 0),
                        "observe_launches": observe.get(name, 0)})
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
