"""Skew-aware join-distribution decisions.

The plan-time half of the engine's heavy-hitter handling (the JSPIM
skew-aware partitioning idea, PAPERS.md 2508.08503): a partitioned
join whose probe keys concentrate on few values collapses its
``all_to_all`` onto the hot keys' owner shards — one shard receives a
heavy hitter's whole row set while its peers idle, and the
capacity-overflow retry ladder burns a recompile per rung. This module
decides, from CBO statistics (cost/stats.py — per-symbol NDVs already
seeded by the divergence ledger's ``observed_ndv`` feedback,
obs/qstats.py), whether a partitioned join should compile the HYBRID
path and/or salt its exchanges:

- **hybrid**: the traced program carries a count sketch over the probe
  keys; keys whose mesh-global row count exceeds the session
  ``skew_hot_key_threshold`` keep their probe rows LOCAL and their
  build rows replicate (``all_gather``), while the cold tail
  hash-partitions as before (parallel/executor.py ``_r_join``). The
  decision here only chooses to PAY for that machinery — the hot set
  itself is data, detected at runtime, so a hybrid program over
  uniform data degrades to a plain partitioned join (empty hot set).
- **salting**: probe rows of one key spread over ``salt_factor``
  shards (build rows tile once per salt value), bounding the cold
  tail's per-shard imbalance when even sub-threshold keys exceed a
  shard's fair share.

Everything written into plan nodes is power-of-two bucketed
(ops/hash.next_pow2), so literal variants of one query shape keep
identical fingerprints and the plan-template/program caches keep
hitting.

Heavy-hitter estimation assumes a Zipf(1) worst case when no
observation says otherwise: with N distinct keys over R probe rows,
the rank-k key holds ~ R / (k * ln N) rows, so the number of keys
exceeding a threshold T is ~ R / (T * ln N). That errs toward
compiling the hybrid path (cheap when the hot set turns out empty)
rather than missing real skew.
"""

from __future__ import annotations

import dataclasses
import math

from presto_tpu_torch.ops.sizes import next_pow2

# count-sketch width used by the runtime heavy-hitter detector
# (parallel/executor.py): collisions only over-count, so a cold key
# sharing a bucket with a hot one is merely broadcast too — correct
# either way, never a miss
SKETCH_BUCKETS = 1 << 13

# hybrid is pointless under this mesh size (one shard holds everything)
MIN_SHARDS = 2


@dataclasses.dataclass(frozen=True)
class SkewDecision:
    """Plan-time skew annotations for one partitioned join.

    ``hybrid`` selects the hot-key-broadcast path; ``hot_keys`` is the
    pow2-bucketed heavy-hitter count estimate sizing the replicated
    hot-build table; ``salt_factor`` (pow2, >= 1) fans the cold tail's
    exchange out over that many sub-buckets per key."""

    hybrid: bool = False
    hot_keys: int | None = None
    salt_factor: int = 1

    @property
    def active(self) -> bool:
        return self.hybrid or self.salt_factor > 1


NO_SKEW = SkewDecision()


def _key_ndv(probe_est, lkeys) -> tuple[float, bool]:
    """Distinct-tuple estimate of the probe join keys (product of
    per-key NDVs capped at rows), and whether every key had real
    statistics behind it."""
    ndv = 1.0
    confident = True
    for k in lkeys:
        st = probe_est.symbol(k)
        if st.ndv is None:
            confident = False
            ndv *= 32.0
        else:
            ndv *= max(st.ndv, 1.0)
    return max(min(ndv, max(probe_est.row_count, 1.0)), 1.0), confident


def estimate_hot_keys(probe_rows: float, key_ndv: float,
                      threshold: int) -> int:
    """Zipf(1) worst-case count of keys whose probe frequency exceeds
    ``threshold``: freq(rank k) ~ rows / (k * ln ndv)."""
    if threshold <= 0 or probe_rows <= 0:
        return 0
    h = max(math.log(max(key_ndv, 2.0)), 1.0)
    hot = probe_rows / (threshold * h)
    return int(min(hot, key_ndv))


def choose_salt_factor(probe_rows: float, nshards: int,
                       max_freq: float, max_salt: int) -> int:
    """Salt fan-out bounding one key's per-shard share: spread a key
    expected to hold ``max_freq`` rows over enough shards that no
    single shard receives more than the mesh's fair per-shard row
    budget. pow2-bucketed and capped at the session ``join_salting``
    limit (and at the mesh width — more salts than shards buys
    nothing)."""
    if max_salt <= 1 or nshards < MIN_SHARDS or probe_rows <= 0:
        return 1
    fair = max(probe_rows / nshards, 1.0)
    if max_freq <= fair:
        return 1
    # pow2 the demand first, then FLOOR to the caps — rounding up
    # after capping would exceed the session limit (and tiling more
    # build copies than shards buys nothing)
    cap = min(max_salt, nshards)
    f = next_pow2(int(math.ceil(max_freq / fair)))
    while f > cap:
        f //= 2
    return max(f, 1)


def decide_skew(probe_est, build_est, criteria, build_unique: bool,
                join_type_inner: bool, nshards: int,
                hot_threshold: int, max_salt: int) -> SkewDecision:
    """THE skew decision for one already-partitioned join (consulted by
    cost/reorder.py when it writes distributions into Join nodes).
    ``probe_est``/``build_est`` are PlanNodeStatsEstimates whose NDVs
    the StatsCalculator already seeded from the observed-NDV ledger, so
    history participates without a second lookup here."""
    if nshards < MIN_SHARDS:
        return NO_SKEW
    lkeys = [lk for lk, _ in criteria]
    if not lkeys:
        return NO_SKEW
    ndv, _confident = _key_ndv(probe_est, lkeys)
    rows = max(probe_est.row_count, 1.0)
    hot = estimate_hot_keys(rows, ndv, hot_threshold) \
        if hot_threshold > 0 else 0
    # a unique build holds one row per key: the replicated hot-build
    # table can never need more slots than the build side has rows
    hot = int(min(hot, max(build_est.row_count, 1.0)))
    # hybrid only when the worst-case TOP key both clears the
    # threshold and exceeds a shard's fair row share — a heavy hitter
    # smaller than rows/nshards cannot imbalance the all_to_all, and
    # compiling the hybrid path anyway would pay its second
    # full-probe-width join and wider concatenated output on every
    # execution of a perfectly uniform join. (Shapes: the runtime only
    # supports probe-preserving INNER/LEFT unique builds; FULL and
    # expanding joins keep their existing paths and rely on salting.)
    top = rows / max(math.log(max(ndv, 2.0)), 1.0)
    hybrid = bool(hot >= 1 and hot_threshold > 0
                  and top >= hot_threshold
                  and top >= rows / nshards
                  and build_unique and join_type_inner)
    salt = 1
    if max_salt > 1:
        # the hottest key the cold tail can still hold: the threshold
        # itself under hybrid (hotter keys were broadcast), else the
        # Zipf top-rank estimate
        h = max(math.log(max(ndv, 2.0)), 1.0)
        top = rows / h
        max_cold = float(min(top, hot_threshold)) if hybrid else top
        salt = choose_salt_factor(rows, nshards, max_cold, max_salt)
    if not hybrid and salt <= 1:
        return NO_SKEW
    return SkewDecision(
        hybrid=hybrid,
        hot_keys=next_pow2(max(hot, 1)) if hybrid else None,
        salt_factor=salt)
