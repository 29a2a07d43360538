"""Runtime query statistics: the always-on Operator -> Task -> Stage ->
Query stats tree, persisted query history, and the estimated-vs-actual
divergence ledger (the port of ``presto_tpu/obs/qstats.py``).

Per-operator actuals come from the live-row counts every program
brings back with its result in the one fetch it makes anyway
(``exec/executor.Program.note_rows``), so the stats are collected on
the normal execution path and recording them adds no host sync.

Three pieces:

- **Recorders** (:class:`TaskRecorder`, :class:`QueryRecorder`): ambient
  (contextvar) accumulators. The executor calls :func:`record_program`
  after every program whose node rows came back; workers open a task
  scope per fragment task (parallel/worker.py) and ``events.monitored``
  opens a query scope around each query. The bounded :data:`STORE`
  backs the ``system.tasks`` / ``system.operator_stats`` tables,
  mid-flight and after.

- **Query history** (:class:`QueryHistory`): a bounded on-disk JSONL
  store (``PRESTO_TPU_HISTORY_DIR``) appended through an EventListener
  on query completion (atomic O_APPEND writes, oldest-first pruning),
  so finished-query profiles survive restarts and repopulate
  ``system.query_history``.

- **Divergence ledger** (:class:`DivergenceLedger`): for every
  scan/filter/join/aggregate node, the CBO's estimated rows recorded
  next to runtime actuals (``system.plan_divergence`` +
  ``presto_tpu_estimate_divergence_ratio``), plus per-(table,
  predicate-shape) observed selectivity and per-(table, group-keys)
  observed NDV, persisted alongside the history. The cost model reads
  them back (cost/stats.py), and adaptive re-planning logs its
  decisions in :data:`ADAPTIVE` (``system.adaptive_decisions``).

Each program's execute time splits across its operators by the flop
share of its device cost (``obs/devprof``: counted on the program's
first pass in the process, known since), and by rows through each
operator where a program has no cost (the reference's own fallback).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import threading
import time
from collections import OrderedDict, deque

from presto_tpu_torch.obs.metrics import REGISTRY

_DIVERGENCE_RATIO = REGISTRY.histogram(
    "presto_tpu_estimate_divergence_ratio",
    "actual/estimated output rows per costed plan node "
    "((actual+1)/(est+1); 1.0 = perfect estimate)",
    buckets=(0.01, 0.1, 0.25, 0.5, 0.8, 1.25, 2.0, 4.0, 10.0, 100.0))

_CURRENT_TASK: contextvars.ContextVar["TaskRecorder | None"] = \
    contextvars.ContextVar("presto_tpu_qstats_task", default=None)
_CURRENT_QUERY: contextvars.ContextVar["QueryRecorder | None"] = \
    contextvars.ContextVar("presto_tpu_qstats_query", default=None)

# node types the divergence ledger tracks (the ones the CBO actually
# costs; Exchange/Output/Project pass rows through)
_DIVERGENCE_NODES = ("TableScan", "Filter", "Join", "MultiJoin",
                     "SemiJoin", "Aggregate", "Distinct")

_SHARD_SUFFIX = re.compile(r"^\d+(a\d+)?$")


def stage_of(task_id: str) -> str:
    """Stage name embedded in a task id: ``{qid}.{stage}.{shard}aN``
    (retry_policy=TASK) or ``{qid}.{stage}`` (shared-id stages)."""
    parts = str(task_id).split(".")
    if len(parts) >= 2 and _SHARD_SUFFIX.fullmatch(parts[-1]):
        return parts[-2]
    return parts[-1] if parts and parts[-1] else "?"


# -- ambient recorder context ------------------------------------------------

def current_task() -> "TaskRecorder | None":
    return _CURRENT_TASK.get()


def current_query() -> "QueryRecorder | None":
    return _CURRENT_QUERY.get()


def install_task(rec: "TaskRecorder | None") -> None:
    """Explicit handoff into pool threads (ThreadPoolExecutor does not
    inherit contextvars; exec/executor._segment_carriers hands the
    recorder over like the cancel token and trace context)."""
    _CURRENT_TASK.set(rec)


@contextlib.contextmanager
def task(task_id: str, node: str, shard: int = 0,
         stage: str | None = None):
    """Open a task recording scope (worker fragment/partial tasks)."""
    rec = TaskRecorder(str(task_id or "?"),
                       stage if stage is not None else stage_of(task_id),
                       node, shard)
    tok = _CURRENT_TASK.set(rec)
    try:
        yield rec
    except BaseException as e:
        rec.error = f"{type(e).__name__}: {e}"[:300]
        rec.finish("failed")
        raise
    finally:
        _CURRENT_TASK.reset(tok)
        rec.finish("finished")


@contextlib.contextmanager
def query(query_id: str, sql: str, user: str):
    """Open a query recording scope and register it in :data:`STORE`
    (the HTTP coordinator opens one per admitted query under the
    protocol query id; the trace id and the stats id coincide)."""
    rec = QueryRecorder(query_id, sql, user)
    STORE.put(query_id, rec)
    qtok = _CURRENT_QUERY.set(rec)
    ttok = _CURRENT_TASK.set(rec.local)
    try:
        yield rec
    except BaseException as e:
        with rec._lock:
            if rec.state == "RUNNING":
                rec.state = "FAILED"
                rec.error = f"{type(e).__name__}: {e}"[:300]
        raise
    finally:
        _CURRENT_TASK.reset(ttok)
        _CURRENT_QUERY.reset(qtok)
        rec.close()


@contextlib.contextmanager
def query_or_current(query_id: str, sql: str, user: str):
    """The ``events.monitored`` entry: reuse the already-open query
    scope (HTTP-admitted queries, whose scope the server opened under
    the protocol query id) or open a fresh one (CLI/dbapi/direct
    Engine queries)."""
    cur = _CURRENT_QUERY.get()
    if cur is not None:
        yield cur
        return
    with query(query_id, sql, user) as rec:
        yield rec


# -- recorders ---------------------------------------------------------------

class TaskRecorder:
    """Accumulates one task's stats (the reference TaskStats/
    OperatorStats pair). Writes come from the executing thread;
    ``snapshot()`` may be called concurrently (system.tasks mid-flight),
    so every mutation holds the lock."""

    def __init__(self, task_id: str, stage: str, node: str,
                 shard: int = 0):
        self._lock = threading.Lock()
        self.task_id = task_id
        self.stage = stage
        self.node = node
        self.shard = int(shard)
        self.state = "running"
        self.error: str | None = None
        self.t0 = time.time()
        self.t1: float | None = None
        self.programs = 0
        self.compiles = 0
        self.cache_hits = 0
        self.template_programs = 0
        self.template_hits = 0
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.input_rows_by_source: dict[str, int] = {}
        self.output_rows = 0
        self.exchange_pages = 0
        self.exchange_bytes = 0
        # pulled exchange bytes split by wire codec (arrow | npz):
        # the "exchange bytes/s roughly doubles on arrow" claim is
        # checked against this split in system.tasks
        self.exchange_bytes_by_codec: dict[str, int] = {}
        self.pages_emitted = 0
        # emitted page bytes split by wire codec (the producer-side
        # twin of exchange_bytes_by_codec)
        self.emitted_bytes_by_codec: dict[str, int] = {}
        self.spooled_pages = 0
        self.peak_memory_bytes = 0
        # attempt number parsed from attempt-versioned task ids
        # ("{qid}.{stage}.{shard}aN", retry_policy=TASK): attempt N
        # means N earlier attempts failed
        m = re.search(r"\.\d+a(\d+)$", task_id)
        self.retries = int(m.group(1)) if m else 0
        self.operators: list[dict] = []

    def finish(self, state: str) -> None:
        with self._lock:
            if self.t1 is None:
                self.t1 = time.time()
                self.state = state

    def default_output_rows(self, rows: int) -> None:
        """Backfill output rows when nothing page-level set them (the
        coordinator task's output IS the query's result rows)."""
        with self._lock:
            if self.output_rows == 0:
                self.output_rows = int(rows)

    def snapshot(self) -> dict:
        with self._lock:
            wall = (self.t1 if self.t1 is not None else time.time()) \
                - self.t0
            return {
                "taskId": self.task_id, "stage": self.stage,
                "node": self.node, "shard": self.shard,
                "state": self.state, "error": self.error,
                "wallMillis": int(wall * 1000),
                "compileMillis": int(self.compile_s * 1000),
                "executeMillis": int(self.execute_s * 1000),
                "programs": self.programs, "compiles": self.compiles,
                "cacheHits": self.cache_hits,
                "templatePrograms": self.template_programs,
                "templateHits": self.template_hits,
                "inputRowsBySource": dict(self.input_rows_by_source),
                "inputRows": sum(self.input_rows_by_source.values()),
                "outputRows": self.output_rows,
                "exchangePages": self.exchange_pages,
                "exchangeBytes": self.exchange_bytes,
                "exchangeBytesByCodec": dict(
                    self.exchange_bytes_by_codec),
                "pagesEmitted": self.pages_emitted,
                "emittedBytesByCodec": dict(
                    self.emitted_bytes_by_codec),
                "spooledPages": self.spooled_pages,
                "peakMemoryBytes": self.peak_memory_bytes,
                "retries": self.retries,
                "operators": [dict(o) for o in self.operators],
            }


class QueryRecorder:
    """One query's stats tree under assembly: a coordinator-local task
    (the final/local programs run on the dispatching thread) plus the
    remote StageStats the cluster coordinator registers after pulling
    worker TaskStats."""

    def __init__(self, query_id: str, sql: str, user: str):
        self._lock = threading.Lock()
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.state = "RUNNING"
        self.error: str | None = None
        self.t0 = time.time()
        self.t1: float | None = None
        self.output_rows = 0
        self.task_retries = 0
        self.query_retries = 0
        self.local = TaskRecorder(f"{query_id}.coordinator.0",
                                  "coordinator", "coordinator")
        self.remote_stages: list[dict] = []
        # live-progress state (coordinator stage walks feed it): the
        # current stage-weight plan plus dispatch/complete marks. The
        # floor makes the estimate monotonic across adaptive replans —
        # a re-weight may shrink the instantaneous fraction, but the
        # reported value never goes backwards.
        self._stage_weights: dict[str, float] = {}
        self._stages_dispatched: set[str] = set()
        self._stages_done: set[str] = set()
        self._progress_floor = 0.0
        # device-profile artifact directory (obs/devprof capture under
        # SET SESSION device_profile = true), set by events.monitored
        self.profile_artifact: str | None = None

    def add_stages(self, stages: list[dict]) -> None:
        with self._lock:
            self.remote_stages.extend(stages)

    # -- live progress (tentpole 3) --------------------------------------

    def progress_plan(self, weights: dict[str, float]) -> None:
        """Install (or, on an adaptive replan, replace) the stage
        weight table — est-rows per stage name. Completed/dispatched
        marks for stages that survive the replan keep counting; the
        monotonic floor absorbs any shrink from re-weighting."""
        with self._lock:
            self._stage_weights = {
                str(k): max(1.0, float(v)) for k, v in weights.items()}

    def note_stage_dispatched(self, name: str) -> None:
        with self._lock:
            self._stages_dispatched.add(str(name))

    def note_stage_completed(self, name: str) -> None:
        with self._lock:
            self._stages_dispatched.add(str(name))
            self._stages_done.add(str(name))

    def _progress_locked(self) -> float:
        if self.t1 is not None and self.state == "FINISHED":
            return 1.0
        names = (set(self._stage_weights)
                 | self._stages_dispatched | self._stages_done)
        p = 0.0
        total = sum(self._stage_weights.get(n, 1.0) for n in names)
        if total > 0:
            done = sum(self._stage_weights.get(n, 1.0)
                       for n in self._stages_done)
            # a dispatched-but-unfinished stage counts half its weight
            inflight = sum(self._stage_weights.get(n, 1.0)
                           for n in self._stages_dispatched
                           - self._stages_done)
            p = (done + 0.5 * inflight) / total
        # never report 1.0 while the query is still running
        p = max(self._progress_floor, min(p, 0.99))
        self._progress_floor = p
        return p

    def progress(self) -> float:
        """Monotonic 0..1 completion estimate (1.0 only on FINISHED)."""
        with self._lock:
            return round(self._progress_locked(), 4)

    def note_task_retry(self) -> None:
        with self._lock:
            self.task_retries += 1

    def note_query_retry(self) -> None:
        with self._lock:
            self.query_retries += 1

    def close(self) -> None:
        with self._lock:
            if self.t1 is None:
                self.t1 = time.time()
                if self.state == "RUNNING":
                    self.state = "FINISHED"
            rows = self.output_rows
        self.local.default_output_rows(rows)
        self.local.finish("finished")

    def snapshot(self) -> dict:
        coord = _stage_from_tasks("coordinator",
                                  [self.local.snapshot()], {})
        with self._lock:
            stages = [dict(s) for s in self.remote_stages] + [coord]
            wall = (self.t1 if self.t1 is not None else time.time()) \
                - self.t0
            return {
                "queryId": self.query_id, "query": self.sql,
                "user": self.user, "state": self.state,
                "error": self.error,
                "createTime": self.t0, "endTime": self.t1,
                "wallMillis": int(wall * 1000),
                "outputRows": self.output_rows,
                "taskRetries": self.task_retries,
                "queryRetries": self.query_retries,
                "progress": round(self._progress_locked(), 4),
                "profile": self.profile_artifact,
                "stages": stages,
            }


def _stage_from_tasks(stage: str, tasks: list[dict],
                      sources: dict) -> dict:
    """Roll task snapshots into one StageStats dict, including the
    per-shard output-row skew (max/mean across the stage's tasks — the
    first thing to look at when one straggler shard dominates a
    distributed stage's wall time)."""
    outs = [int(t.get("outputRows") or 0) for t in tasks]
    total = sum(outs)
    mean = total / len(outs) if outs else 0.0
    skew = (max(outs) / mean) if outs and mean > 0 else 1.0
    input_by_source: dict[str, int] = {}
    for t in tasks:
        for src, n in (t.get("inputRowsBySource") or {}).items():
            input_by_source[src] = input_by_source.get(src, 0) + int(n)
    return {
        "stage": stage,
        "tasks": tasks,
        "outputRows": total,
        "inputRowsBySource": input_by_source,
        "outputRowSkew": round(float(skew), 4),
        "sources": dict(sources or {}),
    }


def build_stages(task_snapshots: list[dict],
                 sources_of: dict[str, dict] | None = None
                 ) -> list[dict]:
    """Group worker task snapshots by stage (parsed from the task id
    server-side, carried in the snapshot) into StageStats dicts.
    ``sources_of`` maps stage name -> {source table: {"stage":
    producer, "mode": "part"|"all"}} from the fragmenter, so consumers
    of the tree can check producer/consumer row conservation."""
    by_stage: dict[str, list[dict]] = {}
    for t in task_snapshots:
        by_stage.setdefault(str(t.get("stage") or "?"), []).append(t)
    sources_of = sources_of or {}
    return [
        _stage_from_tasks(name, tasks, sources_of.get(name, {}))
        for name, tasks in sorted(by_stage.items())]


# -- ambient accumulation hooks (no-ops outside a task scope) ----------------

def add_input_rows(source: str, rows: int) -> None:
    rec = _CURRENT_TASK.get()
    if rec is None:
        return
    with rec._lock:
        rec.input_rows_by_source[source] = \
            rec.input_rows_by_source.get(source, 0) + int(rows)


def set_output_rows(rows: int) -> None:
    rec = _CURRENT_TASK.get()
    if rec is None:
        return
    with rec._lock:
        rec.output_rows = int(rows)


def note_exchange(pages: int, nbytes: int,
                  codec: str | None = None) -> None:
    rec = _CURRENT_TASK.get()
    if rec is None:
        return
    with rec._lock:
        rec.exchange_pages += int(pages)
        rec.exchange_bytes += int(nbytes)
        if codec:
            rec.exchange_bytes_by_codec[codec] = \
                rec.exchange_bytes_by_codec.get(codec, 0) + int(nbytes)


def note_emitted_page(nbytes: int, spooled: bool,
                      codec: str | None = None) -> None:
    """Called by the output buffer per produced page (the producer
    thread IS the task thread, so the ambient recorder applies)."""
    rec = _CURRENT_TASK.get()
    if rec is None:
        return
    with rec._lock:
        rec.pages_emitted += 1
        if codec:
            rec.emitted_bytes_by_codec[codec] = \
                rec.emitted_bytes_by_codec.get(codec, 0) + int(nbytes)
        if spooled:
            rec.spooled_pages += 1


# -- per-program recording (the executor hook) -------------------------------

def record_program(engine, plan, meta: dict, counts,
                   compile_s: float, execute_s: float,
                   cache_hit: bool, template: bool,
                   template_hit: bool) -> None:
    """Fold one successful program execution into the ambient task
    recorder and the divergence ledger. ``plan`` is the PRE-template
    plan (literal values intact, same tree shape — the CBO cannot
    estimate over hoisted ``Parameter`` leaves); ``counts`` is the
    per-node live rows the program brought back, host values aligned
    with ``meta["count_nodes"]`` (stable preorder positions), and
    ``meta["kernels"]`` holds each position's kernel notes
    (``cuda:<kernel>``). Never raises: stats must not fail queries."""
    rec = _CURRENT_TASK.get()
    if rec is None:
        return
    try:
        _record_program(engine, rec, plan, meta, counts, compile_s,
                        execute_s, cache_hit, template, template_hit)
    except Exception:  # noqa: BLE001 - observability never fails a query
        pass


def _record_program(engine, rec: TaskRecorder, plan, meta, counts,
                    compile_s, execute_s, cache_hit, template,
                    template_hit) -> None:
    from presto_tpu_torch.exec.executor import _preorder, preorder_index
    from presto_tpu_torch.memory import _row_bytes

    order = preorder_index(plan)
    # a loop, not a recursive closure (a closure that calls itself is a
    # reference cycle that outlives the call)
    by_pos: dict[object, object] = {
        order.get(id(node), id(node)): node for node in _preorder(plan)}

    est_by_pos: dict[object, int] = {}
    try:
        from presto_tpu_torch.cost import row_estimates
        est_by_pos = {order.get(nid, nid): est
                      for nid, est in row_estimates(plan, engine).items()}
    except Exception:  # noqa: BLE001 - carrier scans may lack stats
        pass

    actual: dict[object, int] = {}
    if counts is not None:
        # host values: they came back with the program's result
        for key, c in zip(meta.get("count_nodes") or [], counts):
            pos = key[0] if isinstance(key, tuple) else key
            actual[pos] = int(c)

    qr = _CURRENT_QUERY.get()
    qid = qr.query_id if qr is not None else rec.task_id
    with rec._lock:
        # allocate this program's index under the lock: parallel
        # segment compilation shares one recorder across pool threads,
        # and two threads reading then incrementing would mint
        # colliding planNodeIds
        program = rec.programs
        rec.programs += 1
    kernels_by_pos = meta.get("kernels") or {}
    ops: list[dict] = []
    weights: list[int] = []
    node_shapes: list[tuple[str, int, int, int]] = []
    for pos, node in by_pos.items():
        rows = actual.get(pos)
        if rows is None:
            continue
        ntype = type(node).__name__
        label = getattr(node, "table", "") \
            if ntype == "TableScan" else ""
        kids = [order.get(id(s), id(s)) for s in node.sources()]
        in_rows = sum(actual.get(k, 0) for k in kids) if kids else None
        try:
            nbytes = rows * _row_bytes(node.output_types())
        except Exception:  # noqa: BLE001 - exotic output types
            nbytes = 0
        est = est_by_pos.get(pos)
        ops.append({
            "planNodeId": f"{program}.{pos}",
            "nodeType": ntype, "label": str(label or ""),
            "inputRows": -1 if in_rows is None else int(in_rows),
            "outputRows": int(rows), "outputBytes": int(nbytes),
            "estRows": -1 if est is None else int(est),
            "kernel": ",".join(kernels_by_pos.get(pos) or ()),
        })
        weights.append((0 if in_rows is None else int(in_rows))
                       + int(rows) + 1)
        node_shapes.append((ntype,
                            0 if in_rows is None else int(in_rows),
                            int(rows), int(nbytes)))
        if ntype in _DIVERGENCE_NODES and est is not None:
            ratio = (rows + 1) / (est + 1)
            _DIVERGENCE_RATIO.observe(ratio, node_type=ntype)
            DIVERGENCE.observe(qid, rec.stage, f"{program}.{pos}",
                               ntype, _subtree_table(node), est, rows)

    # attribute the program's first-pass device cost (obs/devprof; the
    # process keeps it, so a hit attributes too) across
    # its operators, then split the execute wall by flops share. No
    # per-operator timer runs on the execute path: the weighting makes
    # "which operator dominates" answerable from SQL, and rounding
    # means the parts sum to the program wall only approximately.
    # Without a cost (a program run outside the cache) the split falls
    # back to rows through each operator (in+out), which let a
    # cheap-wide node absorb an expensive-narrow node's wall
    from presto_tpu_torch.obs import devprof
    per_node, flop_w = devprof.attribute(meta.get("cost"), node_shapes,
                                         getattr(engine, "device", None))
    for op, costs in zip(ops, per_node):
        op.update(costs)
    wall_w = flop_w if flop_w is not None else weights
    total_w = sum(wall_w) or 1
    for op, w in zip(ops, wall_w):
        op["wallMillis"] = round(execute_s * 1000.0 * w / total_w)

    _observe_shapes(by_pos, order, actual)

    pool = getattr(engine, "memory_pool", None)
    reserved = 0 if pool is None else int(pool.reserved)
    with rec._lock:
        rec.compile_s += float(compile_s)
        rec.execute_s += float(execute_s)
        if cache_hit:
            rec.cache_hits += 1
        else:
            rec.compiles += 1
        if template:
            rec.template_programs += 1
            if template_hit:
                rec.template_hits += 1
        rec.peak_memory_bytes = max(rec.peak_memory_bytes, reserved)
        rec.operators.extend(ops)


def _subtree_table(node) -> str:
    """The single base table under a node, or '' (multi-table joins
    attribute divergence to the probe-side scan chain's ambiguity)."""
    from presto_tpu_torch.exec.executor import _preorder
    tables = {f"{n.catalog}.{n.table}" for n in _preorder(node)
              if type(n).__name__ == "TableScan"
              and not str(getattr(n, "catalog", "")).startswith("__")}
    return tables.pop() if len(tables) == 1 else ""


def _observe_shapes(by_pos: dict, order: dict, actual: dict) -> None:
    """Per-(table, predicate-shape) selectivity and per-(table,
    group-keys) NDV observations — the ROADMAP item 4 substrate, now
    consumed by the StatsCalculator's feedback rules (cost/stats.py):
    keys normalize through ``base_symbol`` so different statements'
    symbol numberings pool into one observation series.

    Only SINGLE-relation programs record: in a program with joins,
    dynamic filtering prunes probe scans with build-side key sets, so
    a filter's scan baseline (and its own output) measure the JOIN
    CONTEXT, not the predicate — migrating that into a context-free
    estimate rule would teach the planner wrong selectivities (and
    wobble plan annotations that key the template/program caches)."""
    from presto_tpu_torch.cost.stats import base_symbol, predicate_shape

    if any(type(n).__name__ in ("Join", "MultiJoin", "SemiJoin",
                                "CrossJoin") for n in by_pos.values()):
        return
    for pos, node in by_pos.items():
        rows = actual.get(pos)
        if rows is None:
            continue
        ntype = type(node).__name__
        if ntype == "Filter":
            scan = _single_scan(node)
            if scan is None:
                continue
            scan_rows = actual.get(order.get(id(scan), id(scan)))
            if not scan_rows:
                continue
            table = f"{scan.catalog}.{scan.table}"
            shape = predicate_shape(node.predicate)
            DIVERGENCE.observe_selectivity(
                table, shape, int(scan_rows), int(rows))
        elif ntype == "Aggregate" and getattr(node, "group_keys", None):
            # a Filter below the aggregate makes the group count a
            # property of the PREDICATE, not the table — recording it
            # would let a filtered lower bound overwrite a correct
            # connector NDV on every later plan (the selectivity side
            # keys by predicate shape for the same reason). Likewise
            # only SINGLE-step aggregates measure a true distinct
            # count: a worker fragment's PARTIAL step counts one
            # shard's groups, and a coordinator FINAL counts groups of
            # gathered partial STATES — neither is the table's NDV
            if str(getattr(getattr(node, "step", None), "value", "")) \
                    != "single":
                continue
            if _subtree_has_filter(node):
                continue
            table = _subtree_table(node)
            if table:
                DIVERGENCE.observe_ndv(
                    table,
                    tuple(base_symbol(k) for k in node.group_keys),
                    int(rows))


def _subtree_has_filter(node) -> bool:
    """Any Filter (or filter-decorated pushed-down scan) below
    ``node`` — its row counts are predicate-conditional."""
    for s in node.sources():
        tname = type(s).__name__
        if tname == "Filter":
            return True
        if tname == "TableScan" and "#" in str(getattr(s, "table", "")):
            return True
        if _subtree_has_filter(s):
            return True
    return False


def _single_scan(node):
    """The TableScan a Filter directly profiles: its source chain down
    through Filters/Projects to exactly one base-catalog scan."""
    cur = node
    while True:
        srcs = cur.sources()
        if len(srcs) != 1:
            return None
        cur = srcs[0]
        tname = type(cur).__name__
        if tname == "TableScan":
            return (None if str(cur.catalog).startswith("__")
                    else cur)
        if tname not in ("Filter", "Project"):
            return None


# -- bounded query-stats store ----------------------------------------------

class QueryStatsStore:
    """Bounded id -> QueryRecorder map backing ``GET /v1/query/{id}``
    and the ``system.tasks`` / ``system.operator_stats`` tables (live
    queries included — recorders snapshot consistently mid-flight)."""

    def __init__(self, max_queries: int = 256):
        self.max_queries = max_queries
        self._lock = threading.Lock()
        self._queries: OrderedDict[str, QueryRecorder] = OrderedDict()

    def put(self, query_id: str, rec: QueryRecorder) -> None:
        with self._lock:
            self._queries.pop(query_id, None)
            self._queries[query_id] = rec
            while len(self._queries) > self.max_queries:
                self._queries.popitem(last=False)

    def get(self, query_id: str) -> QueryRecorder | None:
        with self._lock:
            return self._queries.get(query_id)

    def recorders(self) -> list[QueryRecorder]:
        with self._lock:
            return list(self._queries.values())


STORE = QueryStatsStore()


# -- divergence ledger -------------------------------------------------------

class DivergenceLedger:
    """Estimated-vs-actual rows per costed node (bounded record ring ->
    ``system.plan_divergence``) plus aggregated per-(table,
    predicate-shape) selectivity and per-(table, keys) NDV
    observations, persisted as JSONL next to the query history so a
    restarted engine keeps what it learned. Observation-only in this
    PR: :meth:`observed_selectivity` / :meth:`observed_ndv` are the
    read API adaptive re-planning (ROADMAP item 4) will consume."""

    MAX_RECORDS = 4096
    MAX_KEYS = 512
    FILE = "selectivity.jsonl"
    # persistence batching: observations arrive per filtered program
    # per query — a synchronous file append each would serialize every
    # concurrent query behind one lock and one fd. Flush when either
    # bound trips.
    FLUSH_RECORDS = 32
    FLUSH_SECONDS = 2.0

    def __init__(self):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.MAX_RECORDS)
        # (table, shape) -> {"n", "sel_sum", "last_sel", "last_rows"}
        self._selectivity: OrderedDict[tuple, dict] = OrderedDict()
        # (table, keys) -> {"n", "last_ndv", "max_ndv"}
        self._ndv: OrderedDict[tuple, dict] = OrderedDict()
        self._dir: str | None = None
        self._pending: list[bytes] = []
        self._last_flush = 0.0

    # -- recording -----------------------------------------------------------

    def observe(self, query_id: str, stage: str, node_id: str,
                node_type: str, table: str, est: int,
                actual: int) -> None:
        with self._lock:
            self._records.append({
                "query_id": query_id, "stage": stage,
                "plan_node_id": node_id, "node_type": node_type,
                "table": table, "est_rows": int(est),
                "actual_rows": int(actual),
                "ratio": round((actual + 1) / (est + 1), 6),
            })

    def observe_selectivity(self, table: str, shape: str,
                            scan_rows: int, actual: int) -> None:
        sel = min(1.0, actual / max(scan_rows, 1))
        with self._lock:
            agg = self._selectivity.get((table, shape))
            if agg is None:
                agg = self._selectivity[(table, shape)] = {
                    "n": 0, "sel_sum": 0.0, "last_sel": sel,
                    "last_rows": actual}
                while len(self._selectivity) > self.MAX_KEYS:
                    self._selectivity.popitem(last=False)
            agg["n"] += 1
            agg["sel_sum"] += sel
            agg["last_sel"] = sel
            agg["last_rows"] = int(actual)
        self._persist({"kind": "sel", "table": table, "shape": shape,
                       "rows": int(scan_rows), "actual": int(actual),
                       "sel": round(sel, 8)})

    def observe_ndv(self, table: str, keys: tuple, actual: int) -> None:
        with self._lock:
            agg = self._ndv.get((table, keys))
            if agg is None:
                agg = self._ndv[(table, keys)] = {
                    "n": 0, "last_ndv": 0, "max_ndv": 0}
                while len(self._ndv) > self.MAX_KEYS:
                    self._ndv.popitem(last=False)
            agg["n"] += 1
            agg["last_ndv"] = int(actual)
            agg["max_ndv"] = max(agg["max_ndv"], int(actual))
        self._persist({"kind": "ndv", "table": table,
                       "keys": list(keys), "actual": int(actual)})

    # -- read API (adaptive execution's future input) ------------------------

    def observed_selectivity(self, table: str,
                             shape: str) -> float | None:
        with self._lock:
            agg = self._selectivity.get((table, shape))
            return None if agg is None or not agg["n"] \
                else agg["sel_sum"] / agg["n"]

    def observed_ndv(self, table: str, keys: tuple) -> int | None:
        with self._lock:
            agg = self._ndv.get((table, keys))
            return None if agg is None else agg["max_ndv"]

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def forget_selectivity(self, table: str, shape: str) -> None:
        """Drop the observations of one (table, predicate shape): the
        next reading is of what is observed after."""
        with self._lock:
            self._selectivity.pop((table, shape), None)

    # -- persistence ---------------------------------------------------------

    def attach_dir(self, path: str) -> None:
        """Enable persistence under ``path`` (the history dir), loading
        prior observations once per directory."""
        with self._lock:
            if self._dir == path:
                return
            self._dir = path
        try:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, self.FILE),
                      encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            with self._lock:
                if rec.get("kind") == "sel":
                    key = (rec["table"], rec["shape"])
                    agg = self._selectivity.setdefault(
                        key, {"n": 0, "sel_sum": 0.0, "last_sel": 0.0,
                              "last_rows": 0})
                    agg["n"] += 1
                    agg["sel_sum"] += float(rec.get("sel") or 0.0)
                    agg["last_sel"] = float(rec.get("sel") or 0.0)
                    agg["last_rows"] = int(rec.get("actual") or 0)
                elif rec.get("kind") == "ndv":
                    key = (rec["table"], tuple(rec.get("keys") or ()))
                    agg = self._ndv.setdefault(
                        key, {"n": 0, "last_ndv": 0, "max_ndv": 0})
                    agg["n"] += 1
                    agg["last_ndv"] = int(rec.get("actual") or 0)
                    agg["max_ndv"] = max(agg["max_ndv"],
                                         int(rec.get("actual") or 0))

    def _persist(self, rec: dict) -> None:
        """Queue one observation for the batched JSONL append (one
        os.write per batch; a hot serving path must not pay per-node
        file I/O)."""
        now = time.monotonic()
        with self._lock:
            d = self._dir
            if d is None:
                return
            self._pending.append(
                (json.dumps(rec, default=str,
                            separators=(",", ":")) + "\n").encode())
            if len(self._pending) < self.FLUSH_RECORDS \
                    and now - self._last_flush < self.FLUSH_SECONDS:
                return
            batch = b"".join(self._pending)
            self._pending.clear()
            self._last_flush = now
        try:
            _append_blob(os.path.join(d, self.FILE), batch,
                         max_bytes=_history_max_bytes())
        except OSError:
            pass


DIVERGENCE = DivergenceLedger()


# -- adaptive-execution decision log -----------------------------------------

class AdaptiveLog:
    """Bounded ring of mid-query adaptive-execution decisions
    (parallel/adaptive.py) backing ``system.adaptive_decisions``: what
    was re-planned (or speculated), why (est vs actual rows), and the
    old -> new strategy — the audit trail for the within-query half of
    the feedback loop, next to the between-queries divergence ledger
    above."""

    MAX_RECORDS = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.MAX_RECORDS)

    def note(self, query_id: str, stage: str, kind: str,
             node_type: str = "", detail: str = "",
             est_rows: int = -1, actual_rows: int = -1,
             old_strategy: str = "", new_strategy: str = "") -> None:
        with self._lock:
            self._records.append({
                "query_id": str(query_id), "stage": str(stage),
                "kind": str(kind), "node_type": str(node_type),
                "detail": str(detail)[:300],
                "est_rows": int(est_rows),
                "actual_rows": int(actual_rows),
                "old_strategy": str(old_strategy),
                "new_strategy": str(new_strategy),
                "time": time.time(),
            })

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)


ADAPTIVE = AdaptiveLog()


# -- query history (on-disk JSONL) -------------------------------------------

def _history_max_bytes() -> int:
    return int(os.environ.get("PRESTO_TPU_HISTORY_MAX_BYTES",
                              8 << 20) or (8 << 20))


_APPEND_LOCK = threading.Lock()


def _append_jsonl(path: str, rec: dict, max_bytes: int) -> None:
    """Append one record as a single O_APPEND write (atomic at line
    granularity even across processes sharing the file), pruning
    oldest-first by rewrite (tmp+rename) when the file outgrows
    ``max_bytes``."""
    _append_blob(path, (json.dumps(rec, default=str,
                                   separators=(",", ":"))
                        + "\n").encode(), max_bytes)


def _append_blob(path: str, line: bytes, max_bytes: int) -> None:
    with _APPEND_LOCK:
        fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                     0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
        try:
            if os.path.getsize(path) <= max_bytes:
                return
            with open(path, "rb") as f:
                lines = f.readlines()
            keep, total = [], 0
            for ln in reversed(lines):  # newest-first budget
                total += len(ln)
                if total > max_bytes // 2:
                    break
                keep.append(ln)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.writelines(reversed(keep))
            os.replace(tmp, path)
        except OSError:
            pass


class QueryHistory:
    """Bounded on-disk JSONL of finished-query profiles
    (``PRESTO_TPU_HISTORY_DIR``), appended via an EventListener on the
    engine's EventListenerManager and loaded at engine start so
    ``system.query_history`` survives restarts (the reference persists
    the same record through EventListener plugins)."""

    FILE = "query_history.jsonl"
    MAX_RECORDS = 1000

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.FILE)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.MAX_RECORDS)
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn tail line must not poison the store
            with self._lock:
                self._records.append(rec)

    def on_event(self, event) -> None:
        """EventListener hook: completed events append one history
        record carrying the query's stats tree (pulled from the ambient
        recorder — the listener runs synchronously on the query's
        thread). Created events are ignored."""
        if getattr(event, "end_time", None) is None:
            return
        qr = current_query()
        stats = None
        if qr is not None:
            stats = qr.snapshot()
            # the completed event fires INSIDE the still-open query
            # scope (the recorder closes in the scope's finally, after
            # this listener): stamp the terminal state the scope is
            # about to set, or every persisted profile would claim a
            # forever-RUNNING query after reload
            stats["state"] = event.state
            stats["endTime"] = event.end_time
            stats["wallMillis"] = int(event.elapsed_ms)
            stats["outputRows"] = event.output_rows
            if event.state == "FINISHED":
                stats["progress"] = 1.0
            for stage in stats["stages"]:
                if stage["stage"] == "coordinator":
                    for t in stage["tasks"]:
                        if t["state"] == "running":
                            t["state"] = ("finished"
                                          if event.state == "FINISHED"
                                          else "failed")
        rec = {
            "query_id": (qr.query_id if qr is not None
                         else event.query_id),
            "query": event.sql, "user": event.user,
            "state": event.state,
            "create_time": event.create_time,
            "end_time": event.end_time,
            "elapsed_ms": round(event.elapsed_ms, 3),
            "output_rows": event.output_rows,
            "error": event.error,
            # device-profile artifact directory when the query ran
            # under SET SESSION device_profile = true (devprof)
            "profile": (qr.profile_artifact if qr is not None
                        else None),
            "stats": stats,
        }
        with self._lock:
            self._records.append(rec)
        try:
            _append_jsonl(self.path, rec,
                          max_bytes=_history_max_bytes())
        except OSError:
            pass  # history must never fail the query

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)
