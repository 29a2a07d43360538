"""HTTP coordinator: Trino-protocol query execution over the engine.

The port of ``presto_tpu/server/server.py``. ``CoordinatorServer(engine)``
serves whatever device the engine is on (``Engine()`` is the card,
``Engine(device="cpu")`` the CPU); ``CoordinatorServer(cluster=)``
routes SELECTs through the port's ``ClusterCoordinator``. Arrow result
pages are the port's own wire codec (``parallel/wire.py``). ``/metrics``
refreshes the process gauges (``obs/procstats``) at scrape time, and
``/v1/profile/start`` / ``/v1/profile/stop`` wrap whatever runs between
them in a ``torch.profiler`` capture (``obs/devprof``).

Endpoints (reference file:line):
- POST /v1/statement            submit SQL; returns QueryResults JSON with
                                nextUri (QueuedStatementResource.java:176)
- GET  /v1/statement/executing/{id}/{token}
                                poll results; data paged with continuation
                                tokens (ExecutingStatementResource.java)
- DELETE /v1/statement/executing/{id}/{token}
                                cancel (Query.java cancel)
- GET  /v1/info                 server info (ServerInfoResource)
- GET  /v1/status               node status (StatusResource.java)
- GET  /v1/query                query list (QueryResource.java)

Queries run on a thread pool (the dispatcher analog,
dispatcher/DispatchManager.java:140); state machine QUEUED -> RUNNING ->
FINISHED|FAILED|CANCELED mirrors execution/QueryState.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

from presto_tpu_torch import types as T
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs.jsonlog import LOG
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.obs.trace import TRACER
from presto_tpu_torch.server.httpbase import HttpService, JsonHandler
from presto_tpu_torch.server.results import (ResultAbandoned, ResultQueue,
                                       compact_table, json_rows,
                                       json_value as _json_value,
                                       page_slice)

PAGE_ROWS = 4096
# result pages buffered ahead of the client per query; the streaming
# producer BLOCKS when full (server/results.py backpressure), so a
# query's protocol-layer memory is bounded by this window regardless
# of result size
RESULT_QUEUE_PAGES = int(os.environ.get(
    "PRESTO_TPU_RESULT_QUEUE_PAGES", "8") or 8)
# request header selecting the result-page delivery form: "arrow"
# streams pages as wire-codec bytes handed through untouched;
# default JSON matches the reference protocol
RESULT_FORMAT_HEADER = "X-Presto-TPU-Result"

# coordinator instruments (process-wide shared registry, obs/metrics).
# The counters are REAL monotonic counters incremented at the state
# transition — the old scrape-time recomputation from the bounded query
# snapshot DECREASED when history evicted, which corrupts rate() on any
# collector.
_TRANSITIONS = REGISTRY.counter(
    "presto_tpu_query_state_transitions_total",
    "query state machine transitions, by entered state")
_RESULT_ROWS = REGISTRY.counter(
    "presto_tpu_result_rows_total", "rows returned by finished queries")
_DURATION = REGISTRY.histogram(
    "presto_tpu_query_duration_seconds",
    "query wall time, start of execution to completion")
_QUERIES_BY_STATE = REGISTRY.gauge(
    "presto_tpu_queries", "tracked queries by current state")
_SHED = REGISTRY.counter(
    "presto_tpu_query_shed_total",
    "work rejected for overload protection (worker task-queue caps, "
    "coordinator queue-full), by site")


@dataclasses.dataclass
class QueryInfo:
    query_id: str
    sql: str
    user: str
    state: str = "QUEUED"  # QUEUED|RUNNING|FINISHED|FAILED|CANCELED
    error: str | None = None
    # protocol error code (reference StandardErrorCode names):
    # QUERY_QUEUE_FULL, EXCEEDED_TIME_LIMIT, CLUSTER_OUT_OF_MEMORY, ...
    error_name: str | None = None
    columns: list[dict] | None = None
    # small/statement results buffer here (the legacy path); SELECT
    # results stream through ``result`` instead — O(page) protocol
    # memory with producer backpressure (server/results.py)
    rows: list[list] | None = None
    result: ResultQueue | None = None
    # "json" | "arrow" — from the X-Presto-TPU-Result request header
    result_format: str = "json"
    created: float = dataclasses.field(default_factory=time.monotonic)
    # wall-clock twin of ``created`` for the trace timeline (spans use
    # wall time; ``created`` stays monotonic for duration math)
    created_wall: float = dataclasses.field(default_factory=time.time)
    started: float | None = None
    finished: float | None = None
    rows_sent: int = 0
    cancel_token: object = None  # exec/cancel.CancelToken
    # accumulated EngineWarning dicts (reference QueryResults.warnings)
    warnings: list = dataclasses.field(default_factory=list)
    # per-query property overrides from the X-Trino-Session header
    session_properties: dict = dataclasses.field(default_factory=dict)
    # SET SESSION result handed back to the client, which carries it on
    # subsequent requests (reference: X-Trino-Set-Session response
    # header + StatementClientV1 session accumulation)
    set_session: dict | None = None
    # this request's prepared-statement registry from the
    # X-Trino-Prepared-Statement header ({name: sql}); PREPARE /
    # DEALLOCATE answer with added/deallocated entries the client
    # accumulates, mirroring the set_session round-trip
    prepared_statements: dict = dataclasses.field(default_factory=dict)
    add_prepared: dict | None = None
    remove_prepared: list | None = None
    # tenant-scale serving markers (server/serving.py): answered from
    # the result cache; demuxed from a cross-query batch of N queries;
    # reused an in-flight duplicate's result
    cache_hit: bool = False
    batched: int = 0
    deduped: bool = False

    def rows_done(self) -> int:
        """Rows produced so far: counted at page-EMIT time for
        streamed results (a streaming query must report true totals,
        not the length of a buffer it no longer keeps)."""
        if self.result is not None:
            return self.result.rows_emitted
        return len(self.rows or [])

    def stats(self) -> dict:
        wall = ((self.finished or time.monotonic())
                - (self.started or self.created))
        return {
            "state": self.state,
            "queued": self.state == "QUEUED",
            "scheduled": self.state in ("RUNNING", "FINISHED"),
            "elapsedTimeMillis": int(wall * 1000),
            "processedRows": self.rows_done(),
            "progress": self.progress(),
        }

    def progress(self) -> float:
        """Monotonic 0..1 completion estimate for the protocol stats
        blob and the Web UI (the qstats recorder's stage-walk estimate
        when the query is recording, else state-derived)."""
        if self.state == "FINISHED":
            return 1.0
        if self.state in ("FAILED", "CANCELED"):
            return 0.0
        from presto_tpu_torch.obs import qstats as QS
        rec = QS.STORE.get(self.query_id)
        if rec is not None:
            return rec.progress()
        return 0.0


def _classify_error(e: BaseException) -> str | None:
    """Protocol error code for a failed query (reference
    StandardErrorCode) — clients triage overload/kill/timeout failures
    without parsing messages."""
    from presto_tpu_torch.exec.cancel import TimeLimitExceeded
    from presto_tpu_torch.memory import MemoryKilledError, MemoryLimitExceeded
    if isinstance(e, MemoryKilledError):
        return "CLUSTER_OUT_OF_MEMORY"
    if isinstance(e, MemoryLimitExceeded):
        return "EXCEEDED_MEMORY_LIMIT"
    if isinstance(e, TimeLimitExceeded):
        return "EXCEEDED_TIME_LIMIT"
    return None


class QueryManager:
    """Dispatch + tracking (DispatchManager + QueryTracker analog).
    Admission goes through resource groups: a query over its group's
    concurrency limit waits QUEUED until a slot frees
    (dispatcher/DispatchManager.java:189 selectGroup + submit)."""

    def __init__(self, engine, max_concurrency: int = 8,
                 resource_groups=None, cluster=None,
                 query_memory_bytes: int | None = None):
        import os

        from presto_tpu_torch.memory import MemoryPool
        from presto_tpu_torch.server.governance import QueryReaper
        from presto_tpu_torch.server.resource_groups import ResourceGroupManager

        self.engine = engine
        # optional parallel.coordinator.ClusterCoordinator: SELECT
        # queries then distribute over its HTTP workers instead of
        # running on the local engine (trace context rides along)
        self.cluster = cluster
        self.queries: dict[str, QueryInfo] = {}
        self.resource_groups = ResourceGroupManager(resource_groups)
        # cluster memory governance (reference ClusterMemoryManager +
        # per-query QueryContext limits): each SELECT reserves its
        # plan-time estimate (memory.estimate_plan_memory) in this
        # query-level pool at admission and holds it until completion.
        # Over-capacity queries BLOCK up to the session's
        # memory_reserve_timeout_s; sustained exhaustion triggers the
        # low-memory killer (the blocked query's
        # low_memory_killer_delay_s), which kills the largest
        # reservation with a loud MemoryKilledError. Capacity 0 (the
        # default) disables admission charging entirely.
        self.query_pool = MemoryPool(
            query_memory_bytes if query_memory_bytes is not None
            else int(os.environ.get(
                "PRESTO_TPU_QUERY_MEMORY_POOL_BYTES", "0") or 0),
            name="query")
        # the engine's operator-level runtime pool is env-sizable too
        # (workers read PRESTO_TPU_WORKER_MEMORY_BYTES the same way)
        engine_cap = int(os.environ.get(
            "PRESTO_TPU_MEMORY_POOL_BYTES", "0") or 0)
        if engine_cap and not engine.memory_pool.capacity:
            engine.memory_pool.capacity = engine_cap
        # the pool must cover every group's concurrency allowance or
        # group-admitted queries would serialize behind each other in
        # the pool FIFO, defeating per-group isolation; reject configs
        # the pool cannot honor instead of silently under-providing
        allowance = sum(g.spec.hard_concurrency_limit
                        for g in self.resource_groups.groups)
        if allowance > 256:
            raise ValueError(
                f"resource group concurrency allowances sum to "
                f"{allowance}; the dispatcher pool supports at most 256")
        self.pool = ThreadPoolExecutor(
            max_workers=max(max_concurrency, allowance))
        # tenant-scale serving rungs for the local SELECT path
        # (server/serving.py): result cache, subplan dedup, and the
        # cross-query batch window, each per-query toggleable
        from presto_tpu_torch.server.serving import ServingLayer
        self.serving = ServingLayer(engine)
        self.lock = threading.Lock()
        self._tickets: dict[str, tuple] = {}  # qid -> (group, start_fn)
        # lifetime enforcement: the reaper fails queries past
        # query_max_{queued,run}_time and cancels their worker tasks.
        # Started LAST: its sweep reads self.lock/queries, and a
        # constructor that raises above must not leak a live thread
        self.reaper = QueryReaper(self).start()

    def submit(self, sql: str, user: str,
               session_properties: dict | None = None,
               prepared_statements: dict | None = None,
               result_format: str = "json") -> QueryInfo:
        from presto_tpu_torch.server.resource_groups import (
            NoMatchingGroupError, QueryQueueFullError)

        qid = f"{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:5]}"
        q = QueryInfo(qid, sql, user,
                      session_properties=session_properties or {},
                      prepared_statements=prepared_statements or {},
                      result_format=(result_format
                                     if result_format == "arrow"
                                     else "json"))
        _TRANSITIONS.inc(state="queued")
        with self.lock:
            self.queries[qid] = q
        if self.cluster is None and q.result_format == "json":
            # serving fast path (server/serving.py): a repeated SELECT
            # whose complete result sits in the result cache is
            # answered HERE, synchronously on the submitting handler
            # thread — no pool dispatch, no recorder/tracer scopes, no
            # resource-group slot (a hit consumes no device or memory
            # resources), rows pre-encoded on the cache entry. The
            # POST response then carries the data inline with no
            # nextUri: the whole query is ONE protocol round trip.
            try:
                hit = self.serving.try_fast_hit(q)
            except Exception:  # noqa: BLE001 - fall to the full path
                hit = False
            if hit:
                now = time.monotonic()
                with self.lock:
                    if q.state == "QUEUED":
                        q.state = "FINISHED"
                        q.started = now
                        q.finished = now
                        _TRANSITIONS.inc(state="running")
                        _TRANSITIONS.inc(state="finished")
                        _RESULT_ROWS.inc(len(q.rows or []))
                        _DURATION.observe(0.0)
                LOG.log("query", query_id=q.query_id, user=q.user,
                        state=q.state, elapsed_ms=0.0,
                        rows=len(q.rows or []), error=None)
                return q
        try:
            group = self.resource_groups.select(user, sql)

            def start():
                # context-free by design: _run is the query ENTRY
                # point — it opens the root trace and stats scopes
                # itself (there is no ambient context to inherit; the
                # submitting HTTP handler thread has none either)
                self.pool.submit(self._run, q, group)  # lint: disable=handoff

            with self.lock:
                self._tickets[qid] = (group, start)
            group.submit(start)
            # cancel() or the reaper may have run any time after
            # queries[qid] became visible (listings snapshot it
            # immediately): a cancel/reap that lands before the group
            # admission above scanned an empty queue, so the dead
            # entry would sit in a max_queued slot — forever under a
            # saturated group. Retract on any terminal state and drop
            # the ticket we may have re-published over the pop.
            with self.lock:
                retract = q.state in ("CANCELED", "FAILED")
                if retract:
                    self._tickets.pop(qid, None)
            if retract:
                group.cancel_queued(start)
        except (QueryQueueFullError, NoMatchingGroupError) as e:
            if isinstance(e, QueryQueueFullError):
                _SHED.inc(site="coordinator-queue-full")
                # a shed query's timeline is just this marker — but it
                # makes /v1/query/{id}/trace answer "why did my query
                # never run" (reference QUERY_QUEUE_FULL + Web UI)
                TRACER.instant_for(qid, "query-shed", create=True,
                                   site="coordinator-queue-full")
            with self.lock:
                # a concurrent cancel() may have won: CANCELED sticks
                if q.state != "CANCELED":
                    q.error = str(e)
                    q.error_name = (
                        "QUERY_QUEUE_FULL"
                        if isinstance(e, QueryQueueFullError)
                        else "QUERY_REJECTED")
                    q.state = "FAILED"
                    _TRANSITIONS.inc(state="failed")
                q.finished = time.monotonic()
                self._tickets.pop(qid, None)
        return q

    def _run(self, q: QueryInfo, group) -> None:
        from presto_tpu_torch.exec.cancel import (CancelToken, QueryCanceled,
                                            TimeLimitExceeded)
        try:
            with self.lock:
                if q.state != "QUEUED":
                    # canceled or reaped while group-queued: the
                    # terminal state (and its transition count) sticks
                    return
                q.state = "RUNNING"
                q.started = time.monotonic()
                q.cancel_token = CancelToken()
            _TRANSITIONS.inc(state="running")
            # the trace id IS the protocol query id: the root span of
            # everything this query does on any node; GET
            # /v1/query/{id}/trace exports the tree. The runtime-stats
            # scope (obs/qstats.py) opens under the same id, so
            # GET /v1/query/{id} serves the Query->Stage->Task->
            # Operator tree keyed the way clients know the query.
            with QS.query(q.query_id, q.sql, q.user) as qrec, \
                    TRACER.trace(q.query_id, "query", user=q.user,
                                 sql=q.sql[:200],
                                 node="coordinator") as root:
                TRACER.add_span("admission", q.created_wall,
                                time.time())
                # terminal transitions only fire from RUNNING: the
                # reaper/canceller owns any state it already set (the
                # orphaned run thread must not overwrite FAILED)
                try:
                    self._execute(q)
                    with self.lock:
                        if q.state == "RUNNING":
                            q.state = "FINISHED"
                            _TRANSITIONS.inc(state="finished")
                            if q.result is None:
                                # streamed results already counted
                                # their rows at page-emit time
                                _RESULT_ROWS.inc(len(q.rows or []))
                            _DURATION.observe(
                                time.monotonic() - q.started)
                except TimeLimitExceeded as e:
                    # an exceeded lifetime limit detected INSIDE the
                    # engine (planning seam, checkpoint deadline) is a
                    # loud FAILURE, not a user cancellation — same
                    # terminal shape the reaper produces
                    root.attrs["error"] = str(e)
                    with self.lock:
                        if q.state == "RUNNING":
                            q.error = str(e)
                            q.error_name = "EXCEEDED_TIME_LIMIT"
                            q.state = "FAILED"
                            _TRANSITIONS.inc(state="failed")
                            from presto_tpu_torch.server.governance import (
                                REAPED)
                            REAPED.inc(kind="checkpoint")
                except QueryCanceled:
                    with self.lock:
                        # cancel() usually set the state (and counted
                        # the transition) already; don't double-count
                        if q.state == "RUNNING":
                            q.state = "CANCELED"
                            _TRANSITIONS.inc(state="canceled")
                except Exception as e:  # noqa: BLE001 - to client
                    root.attrs["error"] = f"{type(e).__name__}: {e}"
                    with self.lock:
                        if q.state == "RUNNING":
                            q.error = f"{type(e).__name__}: {e}"
                            q.error_name = _classify_error(e)
                            q.state = "FAILED"
                            _TRANSITIONS.inc(state="failed")
                finally:
                    q.finished = time.monotonic()
                    # sync the protocol-level terminal state into the
                    # stats tree before its scope closes (the reaper
                    # may have set FAILED; the recorder must agree).
                    # Row totals come from rows_done(): emit-time
                    # counts for streamed results, so a streaming
                    # query reports its TRUE total
                    qrec.state = q.state
                    qrec.error = q.error
                    qrec.output_rows = q.rows_done()
            LOG.log("query", query_id=q.query_id, user=q.user,
                    state=q.state,
                    elapsed_ms=round((q.finished - q.started) * 1e3, 3),
                    rows=q.rows_done(), error=q.error)
        finally:
            with self.lock:
                self._tickets.pop(q.query_id, None)
            group.finish()

    def _execute(self, q: QueryInfo) -> None:
        """Plan once; queries return typed columns from the result
        table itself (the old path re-parsed and re-planned after
        execution just to name the columns)."""
        from presto_tpu_torch.sql import ast as A
        from presto_tpu_torch.sql.parser import parse_statement

        sql = q.sql
        stmt = parse_statement(sql)
        if isinstance(stmt, A.ExecutePrepared):
            # splice literals over the stored text's ? markers and run
            # the result through the normal pipeline — every variant
            # lands on the same plan template (templates/prepared.py).
            # Resolution happens BEFORE the statement-kind guards
            # below: a prepared `start transaction` (or nested
            # PREPARE) must hit the same HTTP-protocol rejections a
            # direct one does, not smuggle past them into the shared
            # engine.
            from presto_tpu_torch.templates.prepared import resolve_execute
            sql = resolve_execute(q.prepared_statements, stmt)
            stmt = parse_statement(sql)
        if isinstance(stmt, (A.StartTransaction, A.CommitStatement,
                             A.RollbackStatement)):
            # the TransactionManager is process-global; over HTTP a
            # transaction would be shared by every concurrent user's
            # statements (the dbapi driver declares transactions
            # unsupported over HTTP for the same reason)
            raise ValueError(
                "transactions are not supported over the HTTP protocol")
        if isinstance(stmt, A.Prepare):
            # never stored engine-side: the registry goes back to THIS
            # client, which replays it via the
            # X-Trino-Prepared-Statement header (the set_session model)
            q.add_prepared = {stmt.name: stmt.sql}
            q.columns = []
            q.rows = []
            return
        if isinstance(stmt, A.Deallocate):
            if stmt.name not in q.prepared_statements:
                raise ValueError(
                    f"prepared statement not found: {stmt.name}")
            q.remove_prepared = [stmt.name]
            q.columns = []
            q.rows = []
            return
        if isinstance(stmt, A.SetSession):
            # never mutates the shared engine session: the validated
            # property goes back to THIS client, which replays it via
            # the X-Trino-Session header on its later queries
            from presto_tpu_torch.engine import _literal_value
            from presto_tpu_torch.session import coerce_property
            value = coerce_property(stmt.name,
                                    _literal_value(stmt.value))
            q.set_session = {stmt.name: value}
            q.columns = []
            q.rows = []
            return
        overrides = dict(q.session_properties)
        if not isinstance(stmt, A.QueryStatement):
            with self.engine.session.as_user(q.user, overrides):
                rows = self.engine.execute(sql,
                                           cancel_token=q.cancel_token)
            q.warnings = [w.to_dict() for w in
                          getattr(self.engine, "last_warnings", [])]
            width = len(rows[0]) if rows else 1
            q.columns = [{"name": f"_col{i}", "type": "varchar"}
                         for i in range(width)]
            q.rows = [[_json_value(v, T.VARCHAR) for v in row]
                      for row in rows]
            return
        with self._admission(q, overrides, sql):
            if self.cluster is not None:
                # multi-host path: fragments ship to the cluster's
                # HTTP workers under the protocol query id, so the
                # reaper can cancel this query's tasks by prefix; the
                # root span's context rides the task POSTs.
                # (Host-checkpoint cancellation applies between
                # stages and retries; in-flight remote tasks run to
                # completion.)
                with self.engine.session.as_user(q.user, overrides):
                    table = self.cluster.execute_table(
                        sql, query_id=q.query_id,
                        cancel_token=q.cancel_token)
            else:
                # local path goes through the serving rungs: result
                # cache, then the cross-query batch window, then
                # in-flight dedup, then ordinary serial execution
                with self.engine.session.as_user(q.user, overrides):
                    table = self.serving.execute(q, sql)
        q.warnings = [w.to_dict() for w in
                      getattr(self.engine, "last_warnings", [])]
        q.columns = [{"name": n, "type": str(c.dtype)}
                     for n, c in table.columns.items()]
        self._stream_result(q, table)

    def _stream_result(self, q: QueryInfo, table) -> None:
        """Hand the columnar result to the protocol layer one page at
        a time through a bounded queue (server/results.py): pages are
        decoded to JSON rows — or Arrow-encoded untouched wire bytes
        in ``X-Presto-TPU-Result: arrow`` mode — per PAGE_ROWS slice
        ON DEMAND, and this producer BLOCKS when the client lags
        RESULT_QUEUE_PAGES behind (backpressure). The old path
        materialized the ENTIRE result into ``q.rows`` Python lists
        before the first page went out — a ~10-100x memory amplifier
        held for the query's whole protocol lifetime. Result rows
        count into the protocol metrics at page-EMIT time, so
        streaming queries report true totals."""
        from presto_tpu_torch.parallel import wire

        queue = ResultQueue(RESULT_QUEUE_PAGES, owner=q.cancel_token)
        with self.lock:
            q.result = queue
        cols, total = compact_table(table)
        start = 0
        while start < total:
            stop = min(start + PAGE_ROWS, total)
            page = page_slice(cols, start, stop)
            if q.result_format == "arrow":
                # narrow each page's varchar dictionary to the codes
                # it references: slicing keeps the FULL dictionary,
                # and shipping it whole per page would scale bytes
                # (and the queue's buffered memory) by the page count
                payload: object = wire.columns_to_bytes(
                    wire.compact_page_dictionaries(page),
                    codec=wire.WIRE_ARROW)
            else:
                payload = json_rows(page, stop - start)
            _RESULT_ROWS.inc(stop - start)
            queue.put(payload, stop - start)
            start = stop
        queue.close()

    @contextlib.contextmanager
    def _admission(self, q: QueryInfo, overrides: dict,
                   sql: str | None = None):
        """Cluster memory governance (reference ClusterMemoryManager):
        with a query-pool capacity configured, reserve the query's
        plan-time device-memory estimate for its whole lifetime. An
        over-capacity query BLOCKS (with a deadline) for running ones
        to release; sustained exhaustion invokes the low-memory killer
        against the largest reservation. With capacity 0 (default)
        admission charges nothing."""
        if sql is None:
            sql = q.sql
        if not self.query_pool.capacity:
            yield
            return
        from presto_tpu_torch.memory import estimate_plan_memory
        # the query's cancel token is installed for the admission
        # planning pass too: this IS the query's only planning (the
        # preplanned handoff below), so a reaper kill or client DELETE
        # must abort it at the planning-seam checkpoints, not after
        with self.engine.session.as_user(q.user, overrides), \
                self.engine._cancel_scope(q.cancel_token):
            # plan with the flavor the execution path will use so the
            # one-shot preplanned handoff below replaces (not doubles)
            # its planning pass; the handoff stays thread-local and is
            # consumed under the SAME session scope on this thread
            if self.cluster is not None:
                plan, _ = self.engine.plan_sql(sql,
                                               enable_latemat=False)
            else:
                plan, _ = self.engine.plan_sql(sql)
            est, _per_node = estimate_plan_memory(plan, self.engine)
        charge = max(int(est), 1)
        with TRACER.span("memory-admission", bytes=charge,
                         pool="query"):
            self.query_pool.reserve(
                q.query_id, charge,
                block_s=self.limit_of(q, "memory_reserve_timeout_s"),
                kill_after_s=self.limit_of(
                    q, "low_memory_killer_delay_s"),
                owner=q.cancel_token)
        self.engine.offer_preplanned(sql, plan)
        try:
            yield
        finally:
            self.engine.clear_preplanned()
            self.query_pool.free(q.query_id)

    def limit_of(self, q: QueryInfo, name: str) -> float:
        """A query's effective lifetime/memory limit: its own header
        override first, then the shared engine session (the reaper and
        admission read limits for queries submitted by OTHER threads,
        where the thread-local override is not installed)."""
        value = q.session_properties.get(name)
        if value is None:
            value = self.engine.session.get(name)
        try:
            return float(value or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def reap(self, q: QueryInfo, message: str, kind: str) -> None:
        """Fail a query that exceeded a lifetime limit: terminal state
        NOW (the client stops waiting), the cancel token killed so the
        engine aborts at its next host-side seam, and the query's
        worker fragment tasks DELETEd by query-id prefix."""
        from presto_tpu_torch.exec.cancel import TimeLimitExceeded
        from presto_tpu_torch.server.governance import REAPED
        ticket = None
        with self.lock:
            if q.state not in ("QUEUED", "RUNNING"):
                return
            was_queued = q.state == "QUEUED"
            q.state = "FAILED"
            q.error = message
            q.error_name = "EXCEEDED_TIME_LIMIT"
            q.finished = time.monotonic()
            _TRANSITIONS.inc(state="failed")
            if was_queued:
                ticket = self._tickets.pop(q.query_id, None)
            token = q.cancel_token
        REAPED.inc(kind=kind)
        LOG.log("query_reaped", query_id=q.query_id, kind=kind,
                error=message)
        # mark the kill on the query's trace timeline (the reaper
        # thread has no ambient trace context; the query id IS the
        # trace id — create covers queries reaped while still QUEUED,
        # whose trace would otherwise not exist yet)
        TRACER.instant_for(q.query_id, "reaper-kill", create=True,
                           kind=kind, error=message[:200])
        if token is not None:
            token.kill(TimeLimitExceeded(message))
        if q.result is not None:
            # wake a producer blocked on the full page queue (its next
            # wait turn raises the attributable TimeLimitExceeded via
            # the killed token) and any polling consumer
            q.result.fail(message)
        if ticket is not None:
            group, start = ticket
            group.cancel_queued(start)
        if self.cluster is not None and not was_queued:
            # stop the burn: workers drop this query's task buffers,
            # fail producers blocked on them, and clear its spool (a
            # QUEUED query never dispatched tasks — skip the fan-out,
            # the reaper thread must not stall on dead workers for it)
            self.cluster.cancel_query(q.query_id)

    def close(self) -> None:
        """Stop governance threads and the dispatch pool (server
        shutdown; queries already running finish on their own)."""
        self.reaper.stop()
        self.pool.shutdown(wait=False)

    def get(self, qid: str) -> QueryInfo | None:
        # submit() inserts under the lock from dispatcher threads
        with self.lock:
            return self.queries.get(qid)

    def snapshot(self) -> list[QueryInfo]:
        """Stable copy for handler threads: iterating the live dict
        view races submit() inserting under the lock."""
        with self.lock:
            return list(self.queries.values())

    def cancel(self, qid: str) -> None:
        with self.lock:
            q = self.queries.get(qid)
            if q is None or q.state not in ("QUEUED", "RUNNING"):
                return
            q.state = "CANCELED"
            _TRANSITIONS.inc(state="canceled")
            q.finished = time.monotonic()
            # pop, don't get: a query canceled while still group-queued
            # never runs _run's finally, so leaving the entry here
            # would leak a (group, start-closure) per canceled query
            ticket = self._tickets.pop(qid, None)
            if q.cancel_token is not None:
                # a RUNNING query observes this at its next host-side
                # checkpoint (between blocks / retries / spill parts)
                # and aborts, freeing the device
                q.cancel_token.cancel()
        if q.result is not None:
            # a producer blocked streaming pages to a now-canceled
            # query wakes immediately (QueryCanceled via the token)
            q.result.fail("Query was canceled")
        if ticket is not None:
            group, start = ticket
            # a still-group-queued query frees its max_queued slot now;
            # an admitted one releases via _run's finally
            group.cancel_queued(start)


class _Handler(JsonHandler):
    manager: QueryManager = None  # type: ignore[assignment]
    authenticator = None  # security.PasswordAuthenticator | None
    server_start = time.time()

    def _authenticated_user(self) -> str | None:
        """Resolve the request user; None means 401 was sent. With no
        authenticator configured the user header is trusted (the
        reference's insecure authentication mode)."""
        import base64

        from presto_tpu_torch.security import AuthenticationError

        header_user = self.headers.get(
            "X-Trino-User", self.headers.get("X-Presto-User",
                                             "anonymous"))
        if self.authenticator is None:
            return header_user
        auth = self.headers.get("Authorization", "")
        if auth.startswith("Basic "):
            try:
                raw = base64.b64decode(auth[6:]).decode()
                user, _, password = raw.partition(":")
                self.authenticator.authenticate(user, password)
                return user
            except (AuthenticationError, ValueError):
                pass
        body = b'{"error": "authentication failed"}'
        self.send_response(401)
        self.send_header("WWW-Authenticate", "Basic realm=presto-tpu")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return None

    # -- helpers ------------------------------------------------------------

    # set to "https" by CoordinatorServer when TLS is enabled so
    # nextUri/infoUri send clients back over the same scheme
    uri_scheme = "http"

    def _base_uri(self) -> str:
        host = self.headers.get("Host", "localhost")
        return f"{self.uri_scheme}://{host}"

    def _metrics_text(self) -> str:
        """Prometheus text exposition — the observability export the
        reference provides through JMX+REST (/v1/jmx/mbean; here the
        standard scrape format). Counters/histograms accumulate in the
        shared MetricsRegistry at the event sites; snapshot-derived
        gauges refresh here at scrape time, then the whole registry
        renders (the worker's /metrics renders the same registry)."""
        from presto_tpu_torch.obs.procstats import update_process_gauges
        update_process_gauges(node="coordinator")
        qs = self.manager.snapshot()
        for state in ("QUEUED", "RUNNING", "FINISHED", "FAILED",
                      "CANCELED"):
            _QUERIES_BY_STATE.set(
                sum(q.state == state for q in qs),
                state=state.lower())
        info = self.manager.engine.memory_pool.info()
        REGISTRY.gauge(
            "presto_tpu_memory_reserved_bytes",
            "runtime memory pool reservation").set(
            info["reservedBytes"], node="coordinator")
        REGISTRY.gauge(
            "presto_tpu_memory_capacity_bytes",
            "runtime memory pool capacity (0 = unbounded)").set(
            info["capacityBytes"], node="coordinator")
        qinfo = self.manager.query_pool.info()
        REGISTRY.gauge(
            "presto_tpu_query_memory_reserved_bytes",
            "admission-time query-level memory reservations "
            "(cluster memory governance)").set(
            qinfo["reservedBytes"], node="coordinator")
        REGISTRY.gauge(
            "presto_tpu_query_memory_capacity_bytes",
            "query-level admission pool capacity "
            "(0 = admission disabled)").set(
            qinfo["capacityBytes"], node="coordinator")
        REGISTRY.gauge(
            "presto_tpu_compiled_programs",
            "entries in the compiled-program cache").set(
            len(self.manager.engine._program_cache),
            node="coordinator")
        REGISTRY.gauge(
            "presto_tpu_uptime_seconds",
            "seconds since server start").set(
            time.time() - self.server_start, node="coordinator")
        return REGISTRY.render()

    def _query_results(self, q: QueryInfo, token: int) -> dict:
        out: dict = {
            "id": q.query_id,
            "infoUri": f"{self._base_uri()}/v1/query/{q.query_id}",
            "stats": q.stats(),
        }
        if q.state == "FAILED":
            out["error"] = {"message": q.error,
                            "errorName": (q.error_name
                                          or "GENERIC_INTERNAL_ERROR")}
            return out
        if q.state == "CANCELED":
            out["error"] = {"message": "Query was canceled",
                            "errorName": "USER_CANCELED"}
            return out
        if q.state in ("QUEUED", "RUNNING"):
            # streamed results deliver data pages WHILE RUNNING: the
            # producer fills a bounded queue as pages finish, and the
            # client drains it here instead of waiting for the whole
            # result to buffer (reference protocol: data flows in the
            # RUNNING state)
            queue = q.result
            if (q.state == "RUNNING" and queue is not None
                    and q.columns is not None
                    and q.result_format == "json"):
                out["columns"] = q.columns
                try:
                    payload, nxt, _done = queue.get(token, poll_s=0.25)
                except ResultAbandoned:
                    # mid-RUNNING stream failure: the terminal state
                    # (set by the producer/reaper momentarily) carries
                    # the real error on the next poll
                    payload, nxt = None, token
                if payload:
                    out["data"] = payload
                    token = nxt
            out["nextUri"] = (f"{self._base_uri()}/v1/statement/executing/"
                              f"{q.query_id}/{token}")
            return out
        if q.state == "FINISHED":
            if q.set_session:
                out["setSession"] = q.set_session
            if q.add_prepared:
                out["addedPreparedStatements"] = q.add_prepared
            if q.remove_prepared:
                out["deallocatedPreparedStatements"] = q.remove_prepared
            if getattr(q, "warnings", None):
                # reference protocol/QueryResults warnings field
                out["warnings"] = q.warnings
            out["columns"] = q.columns
            if q.result is not None and q.result_format != "json":
                # arrow-mode data pages go out through the binary
                # route only; this JSON envelope just points there
                out["nextUri"] = (
                    f"{self._base_uri()}/v1/statement/executing/"
                    f"{q.query_id}/{token}")
                return out
            if q.result is not None:
                try:
                    payload, nxt, done = q.result.get(token,
                                                      poll_s=0.25)
                except ResultAbandoned as e:
                    # a released/failed stream on a FINISHED query
                    # fails LOUDLY (a re-requested token below the
                    # freed watermark must not poll forever)
                    out["error"] = {
                        "message": str(e),
                        "errorName": "RESULT_PAGES_RELEASED"}
                    return out
                if payload:
                    out["data"] = payload
                if not done:
                    out["nextUri"] = (
                        f"{self._base_uri()}/v1/statement/executing/"
                        f"{q.query_id}/{nxt if payload else token}")
                return out
            start = token * PAGE_ROWS
            chunk = (q.rows or [])[start:start + PAGE_ROWS]
            if chunk:
                out["data"] = chunk
            if start + PAGE_ROWS < len(q.rows or []):
                out["nextUri"] = (
                    f"{self._base_uri()}/v1/statement/executing/"
                    f"{q.query_id}/{token + 1}")
        return out

    # -- routes -------------------------------------------------------------

    def do_POST(self):  # noqa: N802
        if self.path == "/v1/statement":
            user = self._authenticated_user()
            if user is None:
                return
            try:
                props = self._session_properties()
            except (KeyError, ValueError) as e:
                self._send_json({"error": {"message": str(e)}}, 400)
                return
            length = int(self.headers.get("Content-Length", 0))
            sql = self.rfile.read(length).decode()
            q = self.manager.submit(
                sql, user, session_properties=props,
                prepared_statements=self._prepared_statements(),
                result_format=str(self.headers.get(
                    RESULT_FORMAT_HEADER, "json")).strip().lower())
            if q.error_name == "QUERY_QUEUE_FULL":
                # fast 429-style shed (reference QUERY_QUEUE_FULL +
                # Too Many Requests): the client backs off and
                # retries later instead of polling a doomed query
                self._send_json(self._query_results(q, 0), 429,
                                extra_headers={"Retry-After": "1"})
                return
            self._send_json(self._query_results(q, 0))
            return
        if self.path in ("/v1/profile/start", "/v1/profile/stop"):
            # on-demand device profiler (obs/devprof.py): wraps
            # whatever executes between start and stop in a
            # torch.profiler capture under PRESTO_TPU_PROFILE_DIR
            if self._authenticated_user() is None:
                return
            from presto_tpu_torch.obs import devprof
            if self.path.endswith("/start"):
                res = devprof.start_capture(
                    "coordinator",
                    cuda=self.manager.engine.device.type == "cuda")
            else:
                res = devprof.stop_capture()
            self._send_json(res, 503 if res.get("error") else 200)
            return
        self._send_json({"error": "not found"}, 404)

    def _session_properties(self) -> dict:
        """Per-request property overrides from the X-Trino-Session
        header (comma-separated name=value pairs), validated and typed."""
        from urllib.parse import unquote

        from presto_tpu_torch.session import coerce_property
        header = self.headers.get("X-Trino-Session", "")
        props = {}
        for pair in header.split(","):
            pair = pair.strip()
            if not pair:
                continue
            name, sep, value = pair.partition("=")
            if not sep:
                raise ValueError(f"malformed session header entry: {pair}")
            props[name.strip()] = coerce_property(
                name.strip(), unquote(value.strip()))
        return props

    def _prepared_statements(self) -> dict:
        """This request's prepared-statement registry from the
        X-Trino-Prepared-Statement header (comma-separated
        name=url-encoded-sql pairs, the reference protocol encoding)."""
        from urllib.parse import unquote

        header = self.headers.get("X-Trino-Prepared-Statement", "")
        out = {}
        for pair in header.split(","):
            pair = pair.strip()
            if not pair:
                continue
            name, sep, sql = pair.partition("=")
            if sep:
                out[unquote(name.strip())] = unquote(sql.strip())
        return out

    def do_GET(self):  # noqa: N802
        parts = self.path.strip("/").split("/")
        if self.path in ("/", "/ui", "/ui/"):
            from presto_tpu_torch.server import ui
            self._send_html(ui.dashboard_html())
            return
        if len(parts) == 3 and parts[:2] == ["ui", "query"]:
            # per-query observatory page: the Stage->Task->Operator
            # tree with the device-cost columns, progress, and the
            # trace/profile export links. The current snapshot is
            # embedded server-side (and re-polled by the page's JS).
            from presto_tpu_torch.server import ui
            user = self._authenticated_user()
            if user is None:
                return
            qid = parts[2]
            q = self.manager.get(qid)
            info = None
            if q is not None and self._can_view(user, q):
                info = {"queryId": q.query_id, "state": q.state,
                        "query": q.sql, "user": q.user,
                        "stats": q.stats(), "error": q.error,
                        "cacheHit": q.cache_hit, "batched": q.batched,
                        "deduped": q.deduped}
                rec = QS.STORE.get(q.query_id)
                if rec is not None:
                    info["queryStats"] = rec.snapshot()
            self._send_html(ui.query_page_html(qid, info),
                            200 if info is not None else 404)
            return
        if self.path == "/v1/cluster":
            qs = self.manager.snapshot()
            out = {
                "runningQueries": sum(q.state == "RUNNING" for q in qs),
                "queuedQueries": sum(q.state == "QUEUED" for q in qs),
                "finishedQueries": sum(q.state == "FINISHED"
                                       for q in qs),
                "failedQueries": sum(q.state in ("FAILED", "CANCELED")
                                     for q in qs),
                "totalQueries": len(qs),
            }
            cluster = self.manager.cluster
            if cluster is not None:
                # node lifecycle visibility for the FT subsystem: a
                # draining worker shows alive but not schedulable
                # (operators watch the drain complete here before
                # stopping the process)
                out["workers"] = [
                    {"uri": w.uri, "alive": w.alive,
                     "schedulable": w.schedulable,
                     "state": w.state, "nodeId": w.node_id,
                     "activeTasks": w.active_tasks}
                    for w in cluster.workers]
            self._send_json(out)
            return
        if self.path == "/v1/info":
            self._send_json({
                "nodeVersion": {"version": "presto-tpu-0.1"},
                "environment": "tpu",
                "coordinator": True,
                "starting": False,
                "uptime": f"{time.time() - self.server_start:.0f}s",
            })
            return
        if self.path == "/v1/status":
            self._send_json({
                "nodeId": "coordinator",
                "state": "active",
                "coordinator": True,
                "uptime": f"{time.time() - self.server_start:.0f}s",
                "memory": self.manager.engine.memory_pool.info(),
            })
            return
        if self.path == "/v1/resourceGroup":
            self._send_json(self.manager.resource_groups.info())
            return
        if self.path == "/metrics":
            body = self._metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/v1/query":
            user = self._authenticated_user()
            if user is None:
                return
            self._send_json([
                {"queryId": q.query_id, "state": q.state,
                 "query": q.sql, "user": q.user,
                 "progress": q.progress(),
                 "elapsedMillis": q.stats()["elapsedTimeMillis"]}
                for q in self.manager.snapshot()
                if self._can_view(user, q)])
            return
        if len(parts) == 4 and parts[:2] == ["v1", "query"] \
                and parts[3] == "trace":
            # Chrome trace-event JSON of the query's span tree
            # (chrome://tracing / Perfetto loadable); owner-scoped like
            # the other per-query endpoints
            user = self._authenticated_user()
            if user is None:
                return
            q = self.manager.get(parts[2])
            if q is None or not self._can_view(user, q):
                self._send_json({"error": "unknown query"}, 404)
                return
            self._send_json(TRACER.chrome_trace(q.query_id))
            return
        if len(parts) == 3 and parts[:2] == ["v1", "query"]:
            user = self._authenticated_user()
            if user is None:
                return
            q = self.manager.get(parts[2])
            if q is None or not self._can_view(user, q):
                self._send_json({"error": "unknown query"}, 404)
                return
            out = {
                "queryId": q.query_id, "state": q.state, "query": q.sql,
                "user": q.user, "stats": q.stats(),
                "error": q.error,
                "cacheHit": q.cache_hit, "batched": q.batched,
                "deduped": q.deduped}
            rec = QS.STORE.get(q.query_id)
            if rec is not None:
                # the full Query->Stage->Task->Operator runtime tree
                # (reference QueryResource's QueryInfo with stage/task
                # stats), live mid-flight and final after completion
                out["queryStats"] = rec.snapshot()
            self._send_json(out)
            return
        if len(parts) == 5 and parts[:3] == ["v1", "statement",
                                             "executing"]:
            user = self._authenticated_user()
            if user is None:
                return
            q = self.manager.get(parts[3])
            if q is None or not self._can_view(user, q):
                self._send_json({"error": "unknown query"}, 404)
                return
            if self._send_arrow_page(q, int(parts[4])):
                return
            self._send_json(self._query_results(q, int(parts[4])))
            return
        self._send_json({"error": "not found"}, 404)

    def _send_arrow_page(self, q: QueryInfo, token: int) -> bool:
        """Arrow result mode: streamed pages go to the client as the
        wire-codec bytes the producer encoded, UNTOUCHED — no JSON
        boxing anywhere on the result path. State/token/columns ride
        response headers; terminal/error states fall through to the
        JSON envelope (returns False)."""
        import json as _json

        from presto_tpu_torch.parallel import wire
        if (q.result_format != "arrow" or q.result is None
                or q.state not in ("RUNNING", "FINISHED")):
            return False
        try:
            payload, nxt, done = q.result.get(token, poll_s=0.25)
        except ResultAbandoned as e:
            if q.state == "FINISHED":
                # released/failed stream on a finished query: fail
                # LOUDLY — the JSON fallback would re-point nextUri
                # here forever
                self._send_json({
                    "id": q.query_id,
                    "stats": q.stats(),
                    "error": {"message": str(e),
                              "errorName": "RESULT_PAGES_RELEASED"}})
                return True
            return False  # terminal state will carry the error
        headers = {
            "X-PrestoTpu-State": q.state,
            "X-PrestoTpu-Next-Token": str(nxt),
            "X-PrestoTpu-Complete":
                "1" if (q.state == "FINISHED" and done) else "0",
        }
        if q.columns is not None:
            headers["X-PrestoTpu-Columns"] = _json.dumps(q.columns)
        self._send_bytes(
            payload or b"",
            content_type=wire.CONTENT_TYPES[wire.WIRE_ARROW],
            extra_headers=headers)
        return True

    def _can_view(self, user: str, q: QueryInfo) -> bool:
        """With an authenticator configured, query state/results are
        owner-scoped (cross-user result disclosure otherwise: query ids
        are guessable). Insecure mode trusts headers and shows all,
        matching the reference's insecure-auth Web UI."""
        return self.authenticator is None or q.user == user

    def do_PUT(self):  # noqa: N802
        if self.path == "/v1/node":
            # elastic membership (the JOIN counterpart to the worker's
            # PUT /v1/info/state drain): register a new worker with the
            # running cluster; the scheduler rebalances subsequent
            # stage dispatches onto it once its first heartbeat
            # confirms it active
            import json as _json
            if self._authenticated_user() is None:
                return
            cluster = self.manager.cluster
            if cluster is None:
                self._send_json(
                    {"error": "not running a cluster"}, 400)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = _json.loads(self.rfile.read(length) or b"{}")
                uri = str(body["uri"])
            except (ValueError, KeyError):
                self._send_json(
                    {"error": "body must be JSON with a 'uri'"}, 400)
                return
            worker = cluster.join_worker(uri)
            self._send_json({"uri": worker.uri, "state": worker.state,
                             "workers": len(cluster.workers)})
            return
        self._send_json({"error": "not found"}, 404)

    def do_DELETE(self):  # noqa: N802
        parts = self.path.strip("/").split("/")
        if len(parts) >= 4 and parts[:3] == ["v1", "statement",
                                             "executing"]:
            user = self._authenticated_user()
            if user is None:
                return
            q = self.manager.get(parts[3])
            # unknown and not-owned answer identically (404): a
            # status-code difference would be a query-id existence
            # oracle for other users' queries
            if q is None or not self._can_view(user, q):
                self._send_json({"error": "unknown query"}, 404)
                return
            self.manager.cancel(parts[3])
            self.send_response(204)
            self.end_headers()
            return
        self._send_json({"error": "not found"}, 404)


# The Web UI pages live in presto_tpu_torch/server/ui.py (single-file
# no-dependency HTML+JS dashboard + per-query observatory page).


class CoordinatorServer(HttpService):
    """Threaded HTTP coordinator over an Engine (Server.java:75 analog)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 resource_groups=None, authenticator=None,
                 tls: tuple[str, str] | None = None, cluster=None,
                 query_memory_bytes: int | None = None):
        self.manager = QueryManager(
            engine, resource_groups=resource_groups, cluster=cluster,
            query_memory_bytes=query_memory_bytes)
        handler = type("BoundHandler", (_Handler,), {
            "manager": self.manager,
            "authenticator": authenticator,
            "uri_scheme": "https" if tls is not None else "http"})
        super().__init__(handler, host, port, tls=tls)

    def stop(self) -> None:
        # governance threads (reaper) stop with the server
        self.manager.close()
        super().stop()
