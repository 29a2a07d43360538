"""Session: per-query configuration.

Analog of the reference's Session + SystemSessionProperties
(core/trino-main/src/main/java/io/trino/Session.java,
SystemSessionProperties.java — 163 properties). Properties here control the
TPU execution strategy instead of JVM task knobs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

# Per-thread user override: HTTP queries run concurrently on a shared
# Engine, so the authenticated user is bound to the executing thread
# for the query's duration rather than mutated on the shared session
# (reference: Session is per-query; here the override restores that
# scoping over a process-global Session).
_USER_OVERRIDE = threading.local()


# name -> (default, type, description). Every property is read by the
# engine (tests/test_partitioned.py flips each and asserts the
# plan/HLO/result changes); analog of SystemSessionProperties.java:55-129.
SYSTEM_SESSION_PROPERTIES: dict[str, tuple[Any, type, str]] = {
    "groupby_table_size": (0, int,
                           "hash-table capacity override for group-by "
                           "(0 = derive from stats)"),
    "join_distribution_type": ("AUTOMATIC", str,
                               "AUTOMATIC | BROADCAST | PARTITIONED "
                               "(distributed joins; reference "
                               "DetermineJoinDistributionType)"),
    "broadcast_join_threshold_rows": (1 << 20, int,
                                      "AUTOMATIC: max build rows for "
                                      "broadcast joins (consulted "
                                      "through the cost model's single "
                                      "decision, cost/model.py)"),
    "multiway_join": (True, bool,
                      "collapse INNER unique-build equi-join chains "
                      "(>= 3 joins sharing a probe spine) into one "
                      "fused MultiJoin operator: one program, one "
                      "live mask, and in the distributed lowering at "
                      "most ONE fact-table repartition instead of a "
                      "shuffle per join (plan/optimizer.py "
                      "collapse_multiway; TrieJax-style multi-way "
                      "join). Only applies under AUTOMATIC join "
                      "reordering"),
    "skew_hot_key_threshold": (1 << 16, int,
                               "mesh-global probe rows per join key "
                               "above which the key counts as a heavy "
                               "hitter: hybrid-distribution joins "
                               "broadcast the hot keys' build rows "
                               "and hash-partition only the cold "
                               "tail (cost/skew.py decides WHEN to "
                               "compile the hybrid path; the hot SET "
                               "is detected at runtime by a count "
                               "sketch inside the program). "
                               "0 disables hybrid distribution"),
    "join_salting": (8, int,
                     "max salt fan-out for skewed partitioned-join "
                     "exchanges: probe rows of one key spread over up "
                     "to this many shards (build rows tile per salt). "
                     "The cost model picks the actual pow2 factor; "
                     "0 disables salting"),
    "optimizer_join_reordering_strategy": (
        "AUTOMATIC", str,
        "AUTOMATIC (cost-based DP reorder, cost/reorder.py) | "
        "ELIMINATE_CROSS_JOINS (keep planner order, refresh "
        "estimates) | NONE (reference "
        "SystemSessionProperties.JOIN_REORDERING_STRATEGY)"),
    "cost_estimation_worst_case_ratio": (
        8.0, float,
        "cap on expanding-join output estimates relative to the larger "
        "input when key statistics are unknown (bounds worst-case "
        "plans picked off bad estimates)"),
    "partitioned_agg_min_groups": (1 << 15, int,
                                   "min estimated groups before a "
                                   "distributed aggregate hash-repartitions "
                                   "its partial states instead of "
                                   "gathering them"),
    "partial_aggregation": (True, bool,
                            "partial->final aggregation across shards"),
    "grouped_execution": (False, bool,
                          "execute joins of co-bucketed tables "
                          "bucket-by-bucket so peak memory is one "
                          "bucket's working set (reference lifespans, "
                          "execution/Lifespan.java)"),
    "grouped_execution_partitions": (8, int,
                                     "bucket count for grouped "
                                     "execution"),
    "use_connector_partitioning": (True, bool,
                                   "bucket-shard scans of tables with "
                                   "connector-defined partitioning so "
                                   "co-partitioned joins/aggregations "
                                   "skip the FIXED_HASH exchange "
                                   "(reference ConnectorNodePartitioning"
                                   "Provider)"),
    "allow_local_fallback": (False, bool,
                             "rerun a distributed query locally when "
                             "its shape cannot distribute or a worker "
                             "fails mid-query; off by default, so "
                             "failures surface as REMOTE_TASK-style "
                             "errors (reference fails loudly — "
                             "SURVEY §5)"),
    "enable_late_materialization": (True, bool,
                                    "re-join FD-dependent group keys "
                                    "from their base table after "
                                    "aggregation (plan/latemat.py); "
                                    "the coordinator disables it when "
                                    "planning for distribution — the "
                                    "fragmenter expects aggregate-"
                                    "rooted shapes"),
    "enable_dynamic_filtering": (True, bool,
                                 "prune probe scans with build-side "
                                 "join-key min/max ranges (reference "
                                 "DynamicFilterService)"),
    "query_max_memory_bytes": (0, int,
                               "plan-time device-memory budget per query "
                               "(0 = unlimited); over-budget plans spill "
                               "or fail (reference query.max-memory + "
                               "MemoryPool)"),
    "spill_enabled": (True, bool,
                      "host-partitioned join spill when the memory "
                      "budget is exceeded (reference spill-enabled + "
                      "GenericPartitioningSpiller)"),
    "distributed_sort": (True, bool,
                         "sort sharded inputs per-shard and n-way merge "
                         "the presorted runs (reference MergeOperator) "
                         "instead of gathering and fully sorting"),
    "query_max_run_time": (0.0, float,
                           "wall-clock limit in seconds per query "
                           "(0 = unlimited), enforced at host-side "
                           "checkpoints AND by the coordinator's "
                           "reaper thread, which also cancels the "
                           "query's in-flight worker tasks "
                           "(reference QueryTracker "
                           "query.max-run-time)"),
    "query_max_queued_time": (0.0, float,
                              "max seconds a query may wait QUEUED "
                              "for a resource-group slot before the "
                              "reaper fails it loudly (0 = unlimited; "
                              "reference query.max-queued-time)"),
    "query_max_planning_time": (0.0, float,
                                "max seconds the planner/optimizer "
                                "may spend on one query before it "
                                "fails loudly (0 = unlimited; "
                                "reference query.max-planning-time)"),
    "memory_reserve_timeout_s": (0.0, float,
                                 "how long an over-capacity memory "
                                 "reservation BLOCKS for other "
                                 "queries to free pool bytes before "
                                 "failing (0 = fail immediately, the "
                                 "single-query behavior; reference "
                                 "memory-blocked operator states)"),
    "low_memory_killer_delay_s": (5.0, float,
                                  "sustained pool exhaustion a "
                                  "blocked reservation tolerates "
                                  "before the low-memory killer "
                                  "kills the query holding the "
                                  "largest reservation (active only "
                                  "while blocking; reference "
                                  "low-memory-killer.delay)"),
    "scan_block_rows": (1 << 24, int,
                        "stream scans bigger than this in blocks of this "
                        "many rows through a partial-aggregate kernel "
                        "(the split analog; 0 disables streaming)"),
    "require_distribution": (False, bool,
                             "fail queries the multi-host coordinator "
                             "cannot distribute instead of silently "
                             "running them on the local engine"),
    "program_cache_entries": (64, int,
                              "max programs whose meta (output "
                              "layout, capacity keys, kernel notes, "
                              "device cost) the engine's in-memory "
                              "LRU program cache holds "
                              "(exec/progcache.py; the persistent "
                              "store at PRESTO_TPU_PROGRAM_CACHE_DIR, "
                              "which also keeps each program's "
                              "successful capacities, is bounded "
                              "separately by "
                              "PRESTO_TPU_PROGRAM_CACHE_DISK_BYTES)"),
    "parallel_compile_width": (4, int,
                               "max concurrent XLA compilations for "
                               "independent plan segments (1 = "
                               "serial; XLA compilation releases the "
                               "GIL, so a wave of independent "
                               "segments compiles in parallel)"),
    "retry_policy": ("QUERY", str,
                     "NONE | QUERY | TASK (ft/retry.py; reference "
                     "retry-policy). NONE fails the query on the "
                     "first node/task failure, QUERY re-runs the "
                     "whole fragmented attempt on surviving workers, "
                     "TASK re-dispatches only failed fragment tasks "
                     "over the spooled exchange"),
    "task_retry_attempts": (4, int,
                            "max attempts per fragment task under "
                            "retry_policy=TASK (reference "
                            "task-retry-attempts-per-task)"),
    "query_retry_attempts": (1, int,
                             "max whole-DAG retries under "
                             "retry_policy=QUERY (reference "
                             "query-retry-attempts)"),
    "retry_initial_delay_s": (0.05, float,
                              "base of the exponential full-jitter "
                              "retry backoff (ft/retry.py "
                              "BackoffPolicy)"),
    "retry_max_delay_s": (2.0, float,
                          "cap on a single retry backoff sleep"),
    "retry_deadline_s": (0.0, float,
                         "per-query wall-clock retry budget in "
                         "seconds (0 = unlimited); an exhausted "
                         "budget fails the query loudly instead of "
                         "retrying forever"),
    "exchange_spooling": (True, bool,
                          "persist buffered task output pages to the "
                          "worker spool directory "
                          "(PRESTO_TPU_SPOOL_DIR) so TASK retries "
                          "re-fetch a dead producer's pages instead "
                          "of recomputing (ft/spool.py; no-op when "
                          "no spool directory is configured)"),
    "exchange_wire_codec": ("", str,
                            "page serialization for the exchange "
                            "data plane: arrow (zero-copy Arrow IPC "
                            "RecordBatches) | npz (framed np.savez "
                            "fallback) | '' = auto (PRESTO_TPU_WIRE "
                            "env, else arrow when pyarrow is "
                            "available). Pinned per query into every "
                            "task payload (parallel/wire.py)"),
    "plan_templates": (True, bool,
                       "hoist comparison/arithmetic literals out of "
                       "traced programs into runtime arguments and key "
                       "the program cache on the parameterized plan "
                       "template (templates/), so literal variants of "
                       "one query shape share a compiled executable "
                       "instead of recompiling (reference "
                       "prepared-statement execution)"),
    "template_shape_bucketing": (True, bool,
                                 "pad host scan buffers to pow2 row "
                                 "buckets (dead rows masked) so the "
                                 "shape component of the template "
                                 "cache key buckets the way "
                                 "capacities already do "
                                 "(templates/shapes.py); only "
                                 "consulted when plan_templates is "
                                 "on"),
    "kernel_backend": ("auto", str,
                       "operator inner-loop implementation: auto "
                       "(the CUDA kernels on a CUDA engine, the plain "
                       "PyTorch versions on a CPU engine) | cuda (the "
                       "kernels; tensors on the CPU take the plain "
                       "versions) | torch (the plain versions on any "
                       "device). Identical results either way "
                       "(presto_tpu_torch/kernels/)"),
    "task_request_timeout_s": (300.0, float,
                               "HTTP deadline for coordinator->worker "
                               "task POSTs (was hard-coded 300)"),
    "heartbeat_timeout_s": (2.0, float,
                            "HTTP deadline for failure-detector "
                            "pings (was hard-coded 2)"),
    # -- adaptive execution (parallel/adaptive.py, ft/speculate.py) ----
    # Host-side control-plane properties: none of them are read at
    # trace time, so they deliberately stay OUT of the program-cache
    # key (exec/progcache.TRACE_RELEVANT_PROPERTIES) — flipping them
    # must not re-key compiled programs. Both directions of that
    # contract are machine-checked by the `tracekey` lint rule
    # (lint/tracekey.py): a trace-reachable read of an unkeyed
    # property fails tier-1 as unsound-read, and a keyed property no
    # trace-reachable code reads fails as stale-key-entry.
    "adaptive_replanning": (True, bool,
                            "mid-query adaptive re-planning in the "
                            "retry_policy=TASK stage walk: after each "
                            "stage completes, materially divergent "
                            "(>=4x) actual row counts re-optimize the "
                            "not-yet-dispatched remainder — "
                            "broadcast<->partitioned flips, capacity "
                            "re-bucketing, MultiJoin de/re-fusion — "
                            "with decisions audited in "
                            "system.adaptive_decisions"),
    "speculative_execution": (False, bool,
                              "dispatch a duplicate attempt of a "
                              "straggling TASK-mode stage task on "
                              "another schedulable worker and take "
                              "the first finisher (the loser's task "
                              "is DELETEd); ft/speculate.py"),
    "speculation_quantile": (0.75, float,
                             "fraction of a stage's sibling tasks "
                             "that must have completed before a "
                             "still-running task can be judged a "
                             "straggler (also the completion-time "
                             "quantile the threshold is taken at)"),
    "speculation_threshold": (2.0, float,
                              "straggler runtime threshold as a "
                              "multiple of the sibling quantile "
                              "completion time"),
    "speculation_min_runtime_s": (0.5, float,
                                  "floor on the straggler threshold: "
                                  "tasks never speculate before "
                                  "running at least this long"),
    # -- device observatory (obs/devprof.py) ---------------------------
    # Host-side only, like the adaptive block above: the profiler wrap
    # happens around execution (events.monitored), never at trace
    # time, so this stays OUT of TRACE_RELEVANT_PROPERTIES — toggling
    # profiling must not re-key compiled programs.
    "device_profile": (False, bool,
                       "wrap each query's execution in a programmatic "
                       "jax.profiler device trace written under "
                       "PRESTO_TPU_PROFILE_DIR; the artifact directory "
                       "is stamped into the query's history record and "
                       "surfaced in the Web UI"),
    # -- tenant-scale serving (server/serving.py, exec/batch.py) --------
    # Host-side serving-layer properties: consulted by the HTTP
    # dispatcher BEFORE execution starts, never at trace time, so all
    # three stay OUT of TRACE_RELEVANT_PROPERTIES (the batch axis that
    # batching adds to a program is keyed explicitly by the executor,
    # not through these toggles).
    "result_cache": (True, bool,
                     "serve-mode result-set cache keyed on (plan "
                     "fingerprint x connector table versions): an "
                     "identical re-issued SELECT whose input tables "
                     "are unchanged replays the cached result pages "
                     "through the protocol layer without executing. "
                     "Tables whose connector reports no version "
                     "(table_version None) are never cached, and DML "
                     "actively purges stale entries"),
    "subplan_dedup": (True, bool,
                      "serve-mode in-flight dedup: concurrent queries "
                      "whose optimized plans share a fingerprint (and "
                      "table versions) await one leader execution "
                      "instead of racing duplicate device dispatches"),
    "batch_window_ms": (0.0, float,
                        "serve-mode cross-query batching window in "
                        "milliseconds: queries landing on the SAME "
                        "plan template within the window stack their "
                        "parameter vectors into one vmapped device "
                        "dispatch, demuxed per query afterwards "
                        "(0 disables batching)"),
}


@dataclasses.dataclass
class Session:
    """Per-query session. ``catalog`` names the default connector."""

    catalog: str = "tpch"
    default_user: str = "presto"
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)
    # PREPARE name FROM <sql> registry (templates/prepared.py; the
    # reference keeps prepared statements in Session the same way —
    # over HTTP the registry is per-client, replayed via the
    # X-Trino-Prepared-Statement header instead of stored here)
    prepared_statements: dict[str, str] = dataclasses.field(
        default_factory=dict)

    @property
    def user(self) -> str:
        override = getattr(_USER_OVERRIDE, "user", None)
        return override if override is not None else self.default_user

    @user.setter
    def user(self, value: str) -> None:
        self.default_user = value

    @contextlib.contextmanager
    def as_user(self, user: str, properties: dict[str, Any] | None = None):
        """Bind ``user`` (and optional per-query property overrides) on
        this thread only (used by the HTTP dispatcher so access-control
        checks and session properties are scoped to the authenticated
        submitter's query, not the shared engine session)."""
        prev = getattr(_USER_OVERRIDE, "user", None)
        prev_props = getattr(_USER_OVERRIDE, "properties", None)
        _USER_OVERRIDE.user = user
        _USER_OVERRIDE.properties = properties or None
        try:
            yield
        finally:
            _USER_OVERRIDE.user = prev
            _USER_OVERRIDE.properties = prev_props

    def get(self, name: str) -> Any:
        override = getattr(_USER_OVERRIDE, "properties", None)
        if override is not None and name in override:
            return override[name]
        if name in self.properties:
            return self.properties[name]
        if name not in SYSTEM_SESSION_PROPERTIES:
            raise KeyError(f"unknown session property: {name}")
        return SYSTEM_SESSION_PROPERTIES[name][0]

    def set(self, name: str, value: Any) -> None:
        self.properties[name] = coerce_property(name, value)


def current_override() -> tuple:
    """Snapshot of the calling thread's (user, properties) override —
    hand it to worker threads that trace/compile on behalf of a query
    (ThreadPoolExecutor threads share no threading.local state)."""
    return (getattr(_USER_OVERRIDE, "user", None),
            getattr(_USER_OVERRIDE, "properties", None))


def install_override(ov: tuple) -> None:
    """Install a current_override() snapshot on this thread."""
    _USER_OVERRIDE.user, _USER_OVERRIDE.properties = ov


def coerce_property(name: str, value: Any) -> Any:
    """Validate a property name and convert ``value`` to its declared
    type (used by SET SESSION and by the HTTP X-Trino-Session header)."""
    if name not in SYSTEM_SESSION_PROPERTIES:
        raise KeyError(f"unknown session property: {name}")
    _default, typ, _ = SYSTEM_SESSION_PROPERTIES[name]
    if typ is bool and isinstance(value, str):
        value = value.lower() in ("true", "1", "on")
    return typ(value)
