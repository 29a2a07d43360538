"""Multi-host coordinator: split scheduling, heartbeat failure
detection, partial/final merge over worker HTTP (the port of
``presto_tpu/parallel/coordinator.py``). The coordinator's own engine
runs the final programs (and the local fallback) on its device, over
the gathered worker pages uploaded as one carrier scan.

Analogs (reference file:line):
- split placement over live nodes: execution/scheduler/NodeScheduler +
  SqlQueryScheduler.java:538 (here: one row-range split per worker,
  failed splits rescheduled on surviving nodes — elastic recovery);
- task RPC: server/remotetask/HttpRemoteTask.java:533 (here: a
  synchronous POST /v1/task carrying {sql, shard, nshards});
- failure detection: failuredetector/HeartbeatFailureDetector.java:78
  (exponential-decay failure ratio against a threshold, failed nodes
  excluded from scheduling);
- final merge: PushPartialAggregationThroughExchange — workers return
  partial aggregation states, the coordinator runs the FINAL step over
  the gathered state rows through the same carrier mechanism as
  block-streamed scans (exec/streaming.py phase 2).
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
import urllib.error
import urllib.request

from presto_tpu_torch.server.httpbase import urlopen as _urlopen
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import cancel as CANCEL
from presto_tpu_torch.ft import retry as FTR
from presto_tpu_torch.ft.faults import FAULTS
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.plan import nodes as N

_TASK_RETRIES = REGISTRY.counter(
    "presto_tpu_task_retries_total",
    "fragment tasks re-dispatched after a failure "
    "(retry_policy=TASK, ft/retry.py)")
_QUERY_RETRIES = REGISTRY.counter(
    "presto_tpu_query_retries_total",
    "whole fragmented attempts re-run on surviving workers "
    "(retry_policy=QUERY)")


class NoWorkersError(RuntimeError):
    pass


class TaskError(RuntimeError):
    """The task itself failed on the worker (application error): the
    node is healthy, retrying elsewhere would fail identically."""


class RemoteWorker:
    def __init__(self, uri: str, shared_secret: str | None = None):
        from presto_tpu_torch.parallel import auth as _auth
        self.uri = uri
        self.shared_secret = (shared_secret
                              if shared_secret is not None
                              else _auth.default_secret())
        self.failure_ratio = 0.0  # exponential decay of ping failures
        self.state = "active"  # last lifecycle state seen by ping()
        # live-node view captured by ping() for system.nodes: the
        # worker's self-reported id and running/admitted task count
        self.node_id: str | None = None
        self.active_tasks = 0
        self.lock = threading.Lock()

    def _auth_headers(self) -> dict:
        if self.shared_secret is None:
            return {}
        from presto_tpu_torch.parallel import auth as _auth
        return {_auth.HEADER: _auth.make_token(self.shared_secret)}

    DECAY = 0.7
    THRESHOLD = 0.5

    def record(self, failed: bool) -> None:
        with self.lock:
            self.failure_ratio = (self.DECAY * self.failure_ratio
                                  + (1 - self.DECAY) * float(failed))

    @property
    def alive(self) -> bool:
        # the heartbeat thread writes failure_ratio concurrently with
        # scheduling reads; take the same lock record() publishes under
        with self.lock:
            return self.failure_ratio < self.THRESHOLD

    @property
    def schedulable(self) -> bool:
        """Alive AND accepting tasks: a draining node
        (``shutting_down``) stays healthy — its buffers keep serving —
        but receives no new work (reference graceful shutdown)."""
        with self.lock:
            return (self.failure_ratio < self.THRESHOLD
                    and self.state == "active")

    def post_task(self, payload: dict,
                  timeout: float | None = None) -> dict:
        out = self.post_task_any(payload, timeout)
        if isinstance(out, bytes):
            raise TaskError("unexpected binary task response")
        return out

    # session ``task_request_timeout_s`` overrides per query; this is
    # the fallback for direct callers
    DEFAULT_TASK_TIMEOUT_S = 300.0

    def post_task_any(self, payload: dict,
                      timeout: float | None = None) -> dict | bytes:
        """POST a task; returns parsed JSON or raw bytes for binary
        (inline fragment result) responses. The dispatch records a
        ``task-dispatch`` span whose id rides the X-Presto-TPU-Trace
        header, so worker-side spans parent under it.

        HTTP 502/503/504 (drain, overload) propagate as transient
        failures; any other worker answer is a deterministic
        TaskError. No transport-level retry here on purpose: the
        task/query retry layers own POST failures, and they rotate
        to another worker — strictly better than re-POSTing to the
        same one."""
        if timeout is None:
            timeout = self.DEFAULT_TASK_TIMEOUT_S
        with OT.TRACER.span("task-dispatch", worker=self.uri,
                            task_id=str(payload.get("task_id", ""))):
            req = urllib.request.Request(
                f"{self.uri}/v1/task",
                data=json.dumps(payload).encode(), method="POST",
                headers={"Content-Type": "application/json",
                         **OT.trace_headers(),
                         **self._auth_headers()})
            try:
                with _urlopen(req, timeout=timeout) as resp:
                    body = resp.read()
                    if resp.headers.get("Content-Type",
                                        "").startswith(
                            "application/octet-stream"):
                        return body
                    out = json.loads(body)
            except urllib.error.HTTPError as e:
                if e.code in FTR.TRANSIENT_HTTP_CODES:
                    raise  # node cannot take work: transient
                # the worker answered: node is up, the TASK failed
                try:
                    msg = json.loads(e.read()).get("error", str(e))
                except Exception:  # noqa: BLE001
                    msg = str(e)
                raise TaskError(msg) from e
            if "error" in out:
                raise TaskError(out["error"])
            return out

    def fetch_task_stats(self, prefix: str,
                         timeout: float = 5.0) -> list[dict]:
        """TaskStats snapshots for every task on this worker whose id
        starts with ``prefix`` (one GET per worker assembles a whole
        query's StageStats). Best-effort: stats collection must never
        fail or stall a query."""
        req = urllib.request.Request(
            f"{self.uri}/v1/task/{prefix}/stats",
            headers=self._auth_headers())
        try:
            with _urlopen(req, timeout=timeout) as resp:
                out = json.loads(resp.read())
            tasks = out.get("tasks")
            return tasks if isinstance(tasks, list) else []
        except Exception:  # noqa: BLE001 - best-effort observability
            return []

    def delete_task(self, prefix: str, timeout: float = 10.0,
                    exact: bool = False) -> None:
        """Prefix DELETE of the worker's tasks; ``exact`` deletes one
        task id verbatim (speculation loser-cancel: a losing primary
        id is a prefix of its winning duplicate's id)."""
        url = f"{self.uri}/v1/task/{prefix}"
        if exact:
            url += "?exact=1"
        req = urllib.request.Request(url, method="DELETE",
                                     headers=self._auth_headers())
        try:
            with _urlopen(req, timeout=timeout):
                pass
        except Exception:  # noqa: BLE001 - cleanup is best-effort
            pass

    def ping(self, timeout: float = 2.0) -> bool:
        """Healthy = the node answers /v1/status with a known state.
        A DRAINING node pings healthy (its buffers must stay
        reachable); ``schedulable`` is what excludes it from new
        work. The ``heartbeat-blackout`` fault point simulates an
        unreachable node deterministically (ft/faults.py)."""
        if FAULTS.should_fire("heartbeat-blackout", key=self.uri):
            return False
        try:
            with _urlopen(urllib.request.Request(
                    f"{self.uri}/v1/status"), timeout=timeout) as resp:
                payload = json.loads(resp.read())
                st = str(payload.get("state") or "")
        except Exception:  # noqa: BLE001 - any failure counts
            return False
        with self.lock:
            self.state = st
            self.node_id = str(payload.get("nodeId")
                               or self.node_id or "")
            try:
                self.active_tasks = int(payload.get("activeTasks") or 0)
            except (TypeError, ValueError):
                self.active_tasks = 0
        return st in ("active", "shutting_down")


class HeartbeatFailureDetector:
    """Continuously pings workers; decayed failure ratio over threshold
    marks a node dead (HeartbeatFailureDetector.java:78).

    ``ping_timeout``: () -> float giving the per-ping HTTP deadline
    (the coordinator wires the session's ``heartbeat_timeout_s``)."""

    def __init__(self, workers: list[RemoteWorker],
                 interval_s: float = 0.5, ping_timeout=None):
        self.workers = workers
        self.interval_s = interval_s
        self._ping_timeout = ping_timeout
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        # context-free by design: the health sweeper outlives every
        # query and pings on its own behalf — no trace/token/recorder
        # belongs to it
        self._thread = threading.Thread(target=self._loop, daemon=True,  # lint: disable=handoff
                                        name="presto-tpu-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        """Interruptible shutdown: the loop re-checks the stop Event
        between individual pings, so the worst-case join is ~one ping
        timeout — the old fixed join(5) could return with the thread
        still alive behind a slow ping, leaking it."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout_s() + self.interval_s + 5)
        self._thread = None

    def timeout_s(self) -> float:
        if self._ping_timeout is None:
            return 2.0
        try:
            return float(self._ping_timeout())
        except Exception:  # noqa: BLE001 - session misconfig
            return 2.0

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            for w in list(self.workers):
                if self._stop.is_set():
                    return
                w.record(not w.ping(timeout=self.timeout_s()))


class ClusterCoordinator:
    """Schedules partial-aggregatable queries across workers; anything
    else runs on the local engine (single-node fallback, the
    coordinator is also a worker in the reference's default config)."""

    def __init__(self, engine, heartbeat_interval_s: float = 0.5):
        self.engine = engine
        self.workers: list[RemoteWorker] = []
        self.detector = HeartbeatFailureDetector(
            self.workers, heartbeat_interval_s,
            ping_timeout=self._ping_timeout)
        self.last_distribution: dict | None = None
        # EXPLAIN-ANALYZE-style rendering of the last adaptively
        # re-planned query's plan, with [replanned: old->new] markers
        # (parallel/adaptive.py AdaptiveController.annotated_plan)
        self.last_adaptive_explain: str | None = None
        # live cluster view for the engine's system.nodes table
        # (connectors/information_schema.py reads worker uri/state/
        # active-task counts off this handle)
        engine._cluster_view = self

    def add_worker(self, uri: str) -> None:
        self.workers.append(RemoteWorker(uri))

    def join_worker(self, uri: str) -> RemoteWorker:
        """Elastic scale-out: admit a worker into a RUNNING cluster
        (the JOIN counterpart to the worker-side drain). The node
        enters in the ``joining`` lifecycle state — visible in
        system.nodes and /v1/cluster but not schedulable — and becomes
        eligible for dispatch when its first heartbeat reads an
        ``active`` /v1/status, at most one detector interval later.
        live_workers() is consulted per stage dispatch, so rebalancing
        onto the newcomer needs no further plumbing. Idempotent by
        uri: re-announcing a registered worker returns the existing
        handle (its failure ratio recovers through ordinary pings) —
        and REVIVES it through ``joining`` if it had drained or died,
        which is exactly how an autoscaler returns capacity it
        previously drained away."""
        for w in self.workers:
            if w.uri == uri:
                if w.state != "active":
                    w.state = "joining"
                return w
        w = RemoteWorker(uri)
        # pre-publication write: the detector and scheduler only see
        # the worker after the append below
        w.state = "joining"
        self.workers.append(w)
        return w

    def start(self) -> "ClusterCoordinator":
        self.detector.start()
        return self

    def stop(self) -> None:
        self.detector.stop()

    def live_workers(self) -> list[RemoteWorker]:
        return [w for w in self.workers if w.schedulable]

    # -- session-configured fault-tolerance knobs (ft/retry.py) ----------

    def _retry_policy(self) -> str:
        policy = str(self.engine.session.get("retry_policy")
                     or "QUERY").upper()
        if policy not in FTR.RETRY_POLICIES:
            raise ValueError(
                f"unknown retry_policy {policy!r} "
                f"(one of {FTR.RETRY_POLICIES})")
        return policy

    def _task_timeout(self) -> float:
        return float(self.engine.session.get("task_request_timeout_s"))

    def _wire_codec(self) -> str:
        """Page codec pinned into this query's task payloads (one
        codec per stage DAG): session ``exchange_wire_codec``
        override, else the process default (PRESTO_TPU_WIRE env /
        arrow-when-available). See parallel/wire.py."""
        from presto_tpu_torch.parallel import wire
        return wire.resolve_codec(
            str(self.engine.session.get("exchange_wire_codec")
                or "") or None)

    def _ping_timeout(self) -> float:
        return float(self.engine.session.get("heartbeat_timeout_s"))

    # -- query execution ----------------------------------------------------

    def execute(self, sql: str) -> list[tuple]:
        return self.execute_table(sql).to_pylist()

    def execute_table(self, sql: str, query_id: str | None = None,
                      cancel_token=None):
        """Run SQL across the cluster, returning the result Table
        (typed columns — the HTTP coordinator frontend needs them).

        ``query_id`` names the worker-side task-id prefix, so the
        caller (the HTTP QueryManager's reaper above all) can cancel
        this query's in-flight tasks by prefix; ``cancel_token``
        installs a cooperative cancellation scope checked between
        stages and before every retry."""
        from presto_tpu_torch.events import monitored

        def run():
            with self.engine._cancel_scope(cancel_token):
                return self._execute(sql, query_id=query_id)

        return monitored(self.engine, sql, run)

    def cancel_query(self, query_id: str) -> None:
        """Best-effort DELETE of every worker task belonging to
        ``query_id`` (task ids are prefixed with it): buffers are
        dropped, producers blocked on full buffers are failed loose,
        and spooled pages are removed — a reaped or abandoned query
        stops burning worker time (reference HttpRemoteTask abort +
        TaskResource DELETE). The DELETEs fan out in parallel under
        one short bound: this runs on the single reaper thread, and a
        dead worker (the very situation that reaps queries) must not
        stall every other query's lifetime enforcement behind serial
        10s connect timeouts."""
        threads = [
            # context-free by design: best-effort cleanup DELETEs for
            # a query that is already dead — there is no live trace,
            # token, or recorder to hand over from the reaper thread
            threading.Thread(  # lint: disable=handoff
                target=w.delete_task, args=(query_id,),
                kwargs={"timeout": 5.0}, daemon=True,
                name=f"presto-tpu-cancel-{query_id}")
            for w in list(self.workers)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _execute(self, sql: str, query_id: str | None = None):
        from presto_tpu_torch.exec.streaming import (_find_streamable,
                                               _replace_node)

        # plan with late materialization off: its rewritten shape
        # (dimension re-join above the aggregate) is a single-chip
        # width optimization the fragmenter cannot stage
        plan = self.engine.take_preplanned(sql)
        if plan is None:
            plan, _ = self.engine.plan_sql(sql, enable_latemat=False)
        workers = self.live_workers()
        require = bool(self.engine.session.get("require_distribution"))
        allow_fb = bool(self.engine.session.get("allow_local_fallback"))

        def run_local():
            self.last_distribution = None
            from presto_tpu_torch.exec.executor import execute_plan
            return execute_plan(self.engine, plan)

        def _scans_tables(node) -> bool:
            from presto_tpu_torch.plan import nodes as NN
            if isinstance(node, NN.TableScan) and node.catalog not in (
                    "information_schema", "system"):
                return True
            return any(_scans_tables(sub) for sub in node.sources())

        def local(reason: str):
            if require:
                raise NoWorkersError(
                    f"require_distribution is set but the query "
                    f"cannot be distributed: {reason}")
            # metadata / constant queries are coordinator-only by
            # nature (the reference also runs them there); data-scan
            # queries fail loudly unless the fallback is opted into
            if workers and not allow_fb and _scans_tables(plan):
                raise NoWorkersError(
                    f"query cannot be distributed ({reason}) and "
                    "allow_local_fallback is not set")
            return run_local()

        if workers:
            from presto_tpu_torch.parallel.fragmenter import (
                fragment_join_plan, fragment_plan_general)
            general = fragment_plan_general(
                plan, mode=str(self.engine.session.get(
                    "join_distribution_type") or "automatic").lower(),
                broadcast_threshold=int(self.engine.session.get(
                    "broadcast_join_threshold_rows")))
            policy = self._retry_policy()
            budget = float(self.engine.session.get("retry_deadline_s"))
            deadline = FTR.Deadline(budget)

            def _with_failover(run):
                """Node loss mid-stage loses that query's buffers
                (without the spooled exchange); under retry_policy=
                QUERY the whole stage DAG re-runs on the surviving
                workers, up to ``query_retry_attempts`` times with
                full-jitter backoff under the retry deadline budget
                (the original single-failover semantics are the
                defaults). NONE fails on the first error. A
                deterministic TaskError only retries when the cluster
                actually shrank — on a stable cluster it would fail
                identically. If retries exhaust, the query FAILS like
                the reference's REMOTE_TASK_ERROR unless local
                fallback was opted into."""
                session = self.engine.session
                max_retries = max(
                    0, int(session.get("query_retry_attempts")))
                delays = FTR.backoff_from_session(session,
                                                  max_retries)
                qr = QS.current_query()
                ws = workers
                retries = 0
                while True:
                    # a canceled/reaped/memory-killed query must stop
                    # retrying (and stop dispatching) at this seam
                    CANCEL.checkpoint()
                    try:
                        return run(ws)
                    except (NoWorkersError, TaskError) as e:
                        if policy == "NONE":
                            raise
                        # ping refreshes w.state; schedulable then
                        # drops draining nodes (they answer pings but
                        # 503 every task POST)
                        survivors = [
                            w for w in ws
                            if w.ping(timeout=self._ping_timeout())
                            and w.schedulable]
                        shrank = bool(survivors) \
                            and len(survivors) < len(ws)
                        transient = not isinstance(e, TaskError)
                        if retries < max_retries and survivors \
                                and (shrank or transient) \
                                and not deadline.expired:
                            _QUERY_RETRIES.inc()
                            if qr is not None:
                                qr.note_query_retry()
                            delay = delays.delay_s(retries)
                            with OT.TRACER.span(
                                    "query-retry", attempt=retries,
                                    survivors=len(survivors),
                                    error=f"{type(e).__name__}: "
                                          f"{str(e)[:200]}"):
                                time.sleep(delay)
                            ws = survivors
                            retries += 1
                            continue
                        if require or not allow_fb:
                            raise
                        return run_local()

            if general is not None:
                if policy == "TASK":
                    try:
                        return self._execute_general_ft(
                            plan, general, workers, deadline,
                            query_id=query_id)
                    except (NoWorkersError, TaskError,
                            FTR.DeadlineExceeded):
                        if require or not allow_fb:
                            raise
                        return run_local()
                return _with_failover(
                    lambda ws: self._execute_general(plan, general,
                                                     ws,
                                                     query_id=query_id))
            fragged = fragment_join_plan(plan)
            if fragged is not None:
                # raw-row join shapes (no aggregate) keep stage-level
                # QUERY failover even under TASK policy: the join
                # fragmenter's streamed stages are not task-retryable
                return _with_failover(
                    lambda ws: self._execute_fragmented(
                        plan, fragged, ws, query_id=query_id))
        found = _find_streamable(plan)
        if found is None or not workers:
            # single-node fallback: run the plan we already built (the
            # monitored() wrapper above owns the lifecycle events)
            return local("no workers" if not workers
                         else "plan shape not distributable")
        agg, _scan = found
        return self._execute_partial_fragments(plan, agg, workers,
                                               query_id=query_id)

    def _run_stage(self, workers: list[RemoteWorker],
                   payloads: list[dict]) -> list:
        """One task per worker; any node failure aborts the fragmented
        attempt (buffers on the dead node are lost) and surfaces to
        the retry_policy layer: QUERY re-runs the DAG on survivors,
        TASK avoids this path entirely (_execute_general_ft
        re-dispatches single tasks over the spooled exchange)."""
        # dispatch threads do NOT inherit contextvars from this thread;
        # hand the trace context over explicitly so per-task dispatch
        # spans parent under the query
        ctx = OT.current_context()
        timeout = self._task_timeout()
        tok = CANCEL.current()  # pool threads don't inherit it

        def run_one(i: int):
            if tok is not None:
                tok.check()
            w = workers[i]
            if not w.alive:
                raise NoWorkersError(f"worker {w.uri} died")
            try:
                with OT.TRACER.attach(ctx):
                    out = w.post_task_any(payloads[i],
                                          timeout=timeout)
                w.record(False)
                return out
            except TaskError:
                raise
            except Exception as e:  # noqa: BLE001 - node failure
                w.record(True)
                w.record(True)
                raise NoWorkersError(str(e)) from e

        with ThreadPoolExecutor(max_workers=len(workers)) as pool:
            return list(pool.map(run_one, range(len(workers))))

    def _collect_stage_stats(self, workers: list[RemoteWorker],
                             qid: str,
                             sources_of: dict | None = None) -> None:
        """Pull every worker's TaskStats for this query (one GET per
        worker, best-effort) and register the rolled-up StageStats on
        the ambient QueryRecorder — the coordinator-side assembly of
        the Query->Stage->Task->Operator tree (reference
        SqlQueryExecution's stage-info rollup). Runs BEFORE the
        cleanup DELETE fan-out (which clears worker-side stats) and
        never raises. The GETs fan out in parallel under ONE short
        bound and skip dead nodes: a crashed worker is exactly the
        failure-path case this runs on, and it must not stall query
        completion by a connect timeout per node (same reasoning as
        cancel_query's parallel DELETE fan-out)."""
        qr = QS.current_query()
        if qr is None:
            return
        try:
            tasks: list[dict] = []
            lock = threading.Lock()

            def fetch(w: RemoteWorker) -> None:
                got = w.fetch_task_stats(qid, timeout=3.0)
                with lock:
                    tasks.extend(got)

            threads = [
                threading.Thread(target=fetch, args=(w,), daemon=True,
                                 name="presto-tpu-stats-fetch")
                for w in workers if w.alive]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 3.0
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            with lock:
                got_all = list(tasks)
            if got_all:
                qr.add_stages(QS.build_stages(got_all, sources_of))
        except Exception:  # noqa: BLE001 - stats never fail the query
            pass

    def _progress_weights(self, stages) -> dict[str, float]:
        """Est-rows weight per stage name for the live progress
        estimate (QueryRecorder.progress_plan): each stage counts its
        fragment root's CBO row estimate, so completing a bulk scan
        stage moves the bar further than a narrow join stage. Stages
        without a fragment or stats weigh 1. Never raises."""
        weights: dict[str, float] = {}
        for st in stages:
            w = 1.0
            frag = getattr(st, "fragment", None)
            if frag is not None:
                try:
                    from presto_tpu_torch.cost import row_estimates
                    ests = row_estimates(frag, self.engine)
                    w = float(ests.get(id(frag))
                              or (max(ests.values()) if ests else 0.0))
                except Exception:  # noqa: BLE001 - statless fragments
                    pass
            weights[str(st.name)] = max(1.0, w)
        return weights

    def _finish_with_partials(self, plan, agg, boundary,
                              buffers: list[bytes], meta: dict,
                              adapt=None):
        """Coordinator completion: concatenate worker partial-aggregate
        buffers, splice a FINAL aggregate over a carrier scan into the
        original plan, and run the remainder locally. ``adapt`` (the
        query's AdaptiveController) re-buckets the FINAL aggregate's
        capacity hint from the observed partial-state row count before
        the final program compiles."""
        import dataclasses as DC

        from presto_tpu_torch.exec.executor import run_plan, start_run
        from presto_tpu_torch.exec.streaming import _replace_node
        from presto_tpu_torch.parallel.wire import pages_to_columns
        from presto_tpu_torch.plan import nodes as N

        # single preallocated assembly (arrow buffers decode to
        # zero-copy views; one fill per column — no concat cascade)
        cols, total = pages_to_columns(buffers)
        if adapt is not None and agg is not None:
            agg = adapt.revised_final_agg(agg, total)
        # coordinator-stage input accounting: the stats tree's final
        # conservation link (last worker stage's output rows == the
        # coordinator's gathered partial rows)
        QS.add_input_rows("__partials__", total)
        if agg is not None:
            ctypes = DC.replace(agg,
                                step=N.AggStep.PARTIAL).output_types()
        else:
            ctypes = boundary.output_types()
        carrier = N.TableScan("__cluster__", "__partials__",
                              {s: s for s in ctypes}, dict(ctypes))
        if agg is not None:
            new_node: N.PlanNode = DC.replace(
                agg, source=carrier, step=N.AggStep.FINAL)
        else:
            new_node = carrier
        plan2 = _replace_node(plan, boundary, new_node)
        start_run(self.engine)
        carrier_input = self._carrier_input(carrier, cols, ctypes, total)
        self.last_distribution = {**meta, "partial_rows": total}
        return run_plan(self.engine, plan2,
                        {id(carrier): carrier_input})

    def _carrier_input(self, carrier, cols: dict, types: dict,
                       total: int):
        """The gathered worker results as the scan input of ``carrier``
        on the local engine's device: each column (and NULL mask) goes
        up once, uncached (it lives for one query)."""
        from presto_tpu_torch.exec import hostsync as HS
        from presto_tpu_torch.exec.executor import ScanInput

        def up(a):
            a = np.asarray(a)
            # decoded arrow pages are read-only views
            return HS.upload(a if a.flags.writeable else a.copy(),
                             self.engine.device, "cluster-partials")

        arrays: dict = {}
        dicts: dict = {}
        for s in types:
            col = cols[s]
            arrays[s] = up(col.data)
            if col.valid is not None:
                arrays[f"{s}$valid"] = up(col.valid)
            dicts[s] = col.dictionary
        return ScanInput(carrier, arrays, dicts, dict(types), total)

    def _execute_partial_fragments(self, plan, agg, workers,
                                   query_id: str | None = None):
        """Scan->aggregate plans ship the PARTIAL fragment (serialized
        plan IR, not SQL — the worker no longer re-plans) as one split
        per worker with binary columnar results; failed splits fail
        over to survivors (elastic recovery)."""
        import dataclasses as DC
        import uuid

        from presto_tpu_torch.exec.executor import run_plan, start_run
        from presto_tpu_torch.exec.streaming import _replace_node
        from presto_tpu_torch.parallel.wire import pages_to_columns
        from presto_tpu_torch.plan import nodes as N
        from presto_tpu_torch.plan.serde import fragment_to_dict

        partial = DC.replace(agg, step=N.AggStep.PARTIAL)
        types = partial.output_types()
        nshards = len(workers)
        frag = fragment_to_dict(partial)
        # task ids exist purely so worker TaskStats attribute to this
        # query (binary inline results carry no stats payload)
        qid = query_id or uuid.uuid4().hex[:8]
        wire_codec = self._wire_codec()
        payloads = [{"fragment": frag, "shard": i, "nshards": nshards,
                     "task_id": f"{qid}.partial.{i}",
                     "wire": wire_codec}
                    for i in range(nshards)]
        qr = QS.current_query()
        if qr is not None:
            qr.progress_plan({"partial": float(nshards)})
            qr.note_stage_dispatched("partial")
        try:
            results = self._dispatch_splits(payloads, workers)
        finally:
            self._collect_stage_stats(workers, qid, {})
        if qr is not None:
            qr.note_stage_completed("partial")

        cols, total = pages_to_columns(results)
        carrier = N.TableScan("__cluster__", "__partials__",
                              {s: s for s in types}, dict(types))
        final_agg = DC.replace(agg, source=carrier,
                               step=N.AggStep.FINAL)
        plan2 = _replace_node(plan, agg, final_agg)
        start_run(self.engine)
        carrier_input = self._carrier_input(carrier, cols, types, total)
        self.last_distribution = {"nshards": nshards,
                                  "partial_rows": total}
        return run_plan(self.engine, plan2,
                        {id(carrier): carrier_input})

    def _execute_general(self, plan, g,
                         workers: list[RemoteWorker],
                         query_id: str | None = None):
        """Run a generally-fragmented plan (parallel/fragmenter.py
        fragment_plan_general): stages dispatch in dependency order,
        one task per worker; partitioned stages bucket outputs into W
        buffers, broadcast/gather stages store one buffer; the
        coordinator pulls the last stage's partial-aggregate buffers
        and finishes (SqlQueryScheduler.schedule + stage linkage
        analog, execution/scheduler/SqlQueryScheduler.java:282-452)."""
        import uuid

        from presto_tpu_torch.plan.serde import fragment_to_dict

        # unique per ATTEMPT (a QUERY retry re-enters here and must
        # not collide with the failed attempt's buffers) but prefixed
        # by the protocol query id so cancel_query's prefix DELETE
        # reaches every attempt
        qid = (f"{query_id}.{uuid.uuid4().hex[:6]}" if query_id
               else uuid.uuid4().hex[:8])
        W = len(workers)
        wire_codec = self._wire_codec()
        nparts_of: dict[str, int] = {}
        readers_of = g.consumer_readers(W)

        sources_of = {
            st.name: {t: {"stage": p, "mode": m}
                      for t, (p, m) in st.sources.items()}
            for st in g.stages}
        qr = QS.current_query()
        if qr is not None:
            qr.progress_plan(self._progress_weights(g.stages))
        try:
            inline: list | None = None
            for st in g.stages:
                # host-side seam: a canceled/reaped query stops
                # dispatching further stages here
                CANCEL.checkpoint()
                if qr is not None:
                    qr.note_stage_dispatched(st.name)
                frag = fragment_to_dict(st.fragment)
                last = st.name == g.last_stage
                payloads = []
                for i in range(W):
                    sources = {}
                    for tname, (producer, mode) in st.sources.items():
                        tid = f"{qid}.{producer}"
                        if mode == "part":
                            # consumer i alone reads partition i
                            refs = [{"uri": w.uri, "task_id": tid,
                                     "part": i} for w in workers]
                        else:  # "all": broadcast read of every buffer
                            np_ = nparts_of[producer]
                            refs = [{"uri": w.uri, "task_id": tid,
                                     "part": p, "reader": i}
                                    for w in workers
                                    for p in range(np_)]
                        sources[tname] = refs
                    p: dict = {"fragment": frag,
                               "task_id": f"{qid}.{st.name}",
                               "shard": i, "nshards": W,
                               "wire": wire_codec}
                    if sources:
                        p["sources"] = sources
                    if st.partition_keys is not None:
                        p["partition"] = {"nparts": W,
                                          "keys": st.partition_keys}
                    elif not last:
                        p["store"] = True
                    if readers_of.get(st.name, 1) > 1:
                        p["readers"] = readers_of[st.name]
                    if not last:
                        # intermediate stages run ASYNC: the POST
                        # returns immediately and downstream consumers
                        # long-poll the paged buffers, so the whole
                        # stage DAG pipelines through the bounded data
                        # plane (reference all-at-once
                        # SqlQueryScheduler policy + paged
                        # TaskResource results)
                        p["async"] = True
                    # the LAST stage returns its partials inline: no
                    # coordinator pull phase, so a worker death after
                    # the final stage cannot strand the query
                    payloads.append(p)
                nparts_of[st.name] = (W if st.partition_keys is not None
                                      else 1)
                outs = self._run_stage(workers, payloads)
                if qr is not None:
                    qr.note_stage_completed(st.name)
                if last:
                    inline = outs
            assert inline is not None
            return self._finish_with_partials(
                plan, g.agg, g.boundary, inline,
                {"nshards": W, "mode": "fragments",
                 "stages": len(g.stages)})
        finally:
            self._collect_stage_stats(workers, qid, sources_of)
            for w in workers:
                try:
                    w.delete_task(qid)
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass

    def _execute_general_ft(self, plan, g, workers: list[RemoteWorker],
                            deadline: FTR.Deadline,
                            query_id: str | None = None):
        """retry_policy=TASK execution of the general stage DAG over
        the spooled exchange (the Trino fault-tolerant-execution
        analog). Differences from :meth:`_execute_general`:

        - stages dispatch SYNCHRONOUSLY (no ``async`` streaming):
          every task's success is known when its POST returns, so a
          failure re-dispatches just that task — the pipelining lost
          to the barrier is the same price Trino FTE pays for
          task-granular retryability;
        - task ids are attempt-versioned (``{qid}.{stage}.{shard}aN``)
          so a speculative/retried dispatch never collides with the
          failed attempt's buffer, and consumers are pointed at the
          exact surviving attempt;
        - a consumer failing with an ExchangeFetchError triggers
          exchange REPAIR: if the producer node died and spooling is
          on, the consumer is re-pointed at a surviving worker serving
          the producer's spooled pages (shared spool directory);
          otherwise only that producer task is recomputed — the
          "buffers on the dead node are lost" abort is gone.

        Retries are bounded by ``task_retry_attempts`` per task, slept
        with full-jitter backoff, charged against the query's retry
        deadline, counted in ``presto_tpu_task_retries_total`` and
        visible as ``task-retry`` spans."""
        import uuid

        from presto_tpu_torch.plan.serde import fragment_to_dict

        session = self.engine.session
        qid = query_id or uuid.uuid4().hex[:8]
        W = len(workers)
        wire_codec = self._wire_codec()
        task_backoff = FTR.backoff_from_session(
            session, int(session.get("task_retry_attempts")))
        spool_on = bool(session.get("exchange_spooling"))
        task_timeout = self._task_timeout()
        ctx = OT.current_context()
        # dispatch pool threads inherit neither contextvars nor the
        # thread-local cancel token; capture it for their checkpoints
        tok = CANCEL.current()
        qr = QS.current_query()  # retry accounting from pool threads

        readers_of = g.consumer_readers(W)
        stage_by_name = {st.name: st for st in g.stages}
        nparts_of: dict[str, int] = {}
        frag_of: dict[str, dict] = {}

        # shared retry state: placed[stage][shard] = (worker, task_id)
        # of the attempt whose output consumers should read
        state_lock = threading.Lock()
        placed: dict[str, dict[int, tuple[RemoteWorker, str]]] = {}
        attempts: dict[tuple[str, int], int] = {}
        retries = [0]
        # set once the walk has its inline results: speculation losers
        # still in flight must then stop retrying and — above all —
        # stop REPAIRING exchanges (a post-cleanup repair would re-run
        # a producer task and leak its buffers past the qid sweep)
        walk_done = [False]

        def live_pool() -> list[RemoteWorker]:
            pool = [w for w in workers if w.schedulable]
            if not pool:
                raise NoWorkersError("no schedulable workers remain")
            return pool

        def build_payload(st, shard: int, tid: str,
                          last: bool) -> dict:
            sources: dict = {}
            for tname, (producer, mode) in st.sources.items():
                with state_lock:
                    pl = dict(placed[producer])
                if mode == "part":
                    refs = [{"uri": pl[s][0].uri, "task_id": pl[s][1],
                             "part": shard} for s in sorted(pl)]
                elif mode == "own":
                    # split-semantics read of a materialized per-worker
                    # store (adaptive re-planning): consumer i alone
                    # reads producer i's buffers, so the union over
                    # consumers is the relation exactly once — an
                    # "all" read here would hand EVERY consumer the
                    # full store and duplicate rows downstream
                    np_ = nparts_of[producer]
                    refs = [{"uri": pl[shard][0].uri,
                             "task_id": pl[shard][1], "part": p}
                            for p in range(np_)]
                else:  # "all": broadcast read of every buffer
                    np_ = nparts_of[producer]
                    refs = [{"uri": pl[s][0].uri, "task_id": pl[s][1],
                             "part": p, "reader": shard}
                            for s in sorted(pl) for p in range(np_)]
                sources[tname] = refs
            p: dict = {"fragment": frag_of[st.name], "task_id": tid,
                       "shard": shard, "nshards": W,
                       "wire": wire_codec}
            if sources:
                p["sources"] = sources
            if st.partition_keys is not None:
                p["partition"] = {"nparts": W,
                                  "keys": st.partition_keys}
            elif not last:
                p["store"] = True
            if readers_of.get(st.name, 1) > 1:
                p["readers"] = readers_of[st.name]
            if spool_on and (st.partition_keys is not None
                             or not last):
                # buffered output spools (task ids here are per-shard
                # unique, so shared spool directories cannot collide)
                p["spool"] = True
            # no "async": the POST runs the fragment to completion so
            # this task's outcome is attributable to this task alone
            return p

        def repair_exchange(message: str) -> bool:
            """Consumer could not pull a producer's pages. Returns
            True when the exchange was repaired (re-point or re-run)
            and the consumer should retry; False when the failure is
            not an exchange failure (a real application error)."""
            if walk_done[0]:
                return False  # finished query: nothing left to repair
            hit = FTR.parse_exchange_failure(message)
            if hit is None:
                return False
            ptid, puri = hit
            m = re.match(
                rf"^{re.escape(qid)}\.(.+?)\.(\d+)(?:a\d+)?$", ptid)
            if m is None:
                return False
            pstage, pshard = m.group(1), int(m.group(2))
            with state_lock:
                cur = placed.get(pstage, {}).get(pshard)
            if cur is None:
                return False
            cur_w, cur_tid = cur
            if cur_tid != ptid:
                return True  # a concurrent consumer already repaired
            dead = cur_w.uri == puri and not cur_w.ping(
                timeout=self._ping_timeout())
            if spool_on and dead:
                # any surviving worker sharing the spool directory can
                # serve the dead producer's persisted pages under the
                # SAME task id — zero recomputation
                alt = [w for w in live_pool() if w.uri != puri]
                if alt:
                    with state_lock:
                        placed[pstage][pshard] = (
                            alt[pshard % len(alt)], ptid)
                    return True
            st = stage_by_name.get(pstage)
            if st is None:
                return False
            # recompute ONLY the failed producer task
            dispatch(st, pshard, last=False)
            return True

        def dispatch(st, shard: int, last: bool, arbiter=None,
                     speculative: bool = False):
            """Run one stage task to success (with the task-retry
            ladder). With an ``arbiter`` (speculative execution) the
            attempt races siblings: the first finisher publishes its
            placement; a loser cleans its own output up (exact-id
            DELETE) and returns None, and terminal failures are
            reported to the arbiter instead of raised (another attempt
            for the shard may still win)."""
            try:
                while True:
                    # reaped/canceled queries stop re-dispatching; the
                    # QueryCanceled propagates (not a node failure)
                    if tok is not None:
                        tok.check()
                    if walk_done[0] or (arbiter is not None
                                        and arbiter.has_winner(shard)):
                        return None
                    with state_lock:
                        n = attempts.get((st.name, shard), 0)
                        attempts[(st.name, shard)] = n + 1
                    tid = f"{qid}.{st.name}.{shard}" + (
                        f"a{n}" if n else "")
                    pool = live_pool()
                    w = pool[(shard + n) % len(pool)]
                    payload = build_payload(st, shard, tid, last)
                    err: Exception
                    try:
                        with OT.TRACER.attach(ctx):
                            out = w.post_task_any(payload,
                                                  timeout=task_timeout)
                        w.record(False)
                        if arbiter is not None:
                            def publish(w=w, tid=tid):
                                with state_lock:
                                    placed[st.name][shard] = (w, tid)

                            # placement publishes INSIDE the claim's
                            # critical section: all_won() must never
                            # release the walk before every winner's
                            # producer entry is in `placed`
                            if not arbiter.claim_win(shard, tid, out,
                                                     speculative,
                                                     on_win=publish):
                                # second finisher: drop the
                                # duplicate's buffers/spool (exact id
                                # — a losing primary's id prefixes
                                # the winner's)
                                w.delete_task(tid, exact=True)
                                return None
                            return out
                        with state_lock:
                            placed[st.name][shard] = (w, tid)
                        return out
                    except TaskError as te:
                        if arbiter is not None \
                                and (walk_done[0]
                                     or arbiter.has_winner(shard)):
                            # a lost speculation race, not a failure:
                            # no repair, no retry (a repair here would
                            # re-run a producer AFTER query cleanup)
                            return None
                        if not repair_exchange(str(te)):
                            raise  # deterministic application error
                        err = te
                        reason = "exchange-repair"
                    except FTR.DeadlineExceeded:
                        raise
                    except Exception as e:  # noqa: BLE001 - node failure
                        w.record(True)
                        w.record(True)  # fast-fail: over threshold
                        err = e
                        reason = f"node-failure:{type(e).__name__}"
                    if n + 1 >= task_backoff.attempts:
                        raise NoWorkersError(
                            f"task {st.name}.{shard} failed after "
                            f"{n + 1} attempts: {err}")
                    deadline.check(f"task {st.name}.{shard}")
                    _TASK_RETRIES.inc()
                    if qr is not None:
                        qr.note_task_retry()
                    with state_lock:
                        retries[0] += 1
                    delay = task_backoff.delay_s(n)
                    with OT.TRACER.attach(ctx), OT.TRACER.span(
                            "task-retry", task_id=tid, attempt=n,
                            reason=reason, delay_s=round(delay, 4),
                            error=f"{type(err).__name__}: "
                                  f"{str(err)[:200]}"):
                        time.sleep(delay)
            except BaseException as exc:
                if arbiter is None:
                    raise
                # speculative mode: a failed attempt only fails the
                # stage once NO attempt for the shard remains
                arbiter.record_failure(shard, exc)
                return None

        def run_stage(st, last: bool) -> list:
            """Dispatch one stage's W tasks. Without speculation this
            is the plain synchronous fan-out; with it, a straggler
            task past the policy threshold gets a duplicate attempt on
            another worker and the first finisher wins (the stage does
            NOT wait for losers)."""
            if not spec_policy.enabled or W < 2:
                with ThreadPoolExecutor(max_workers=W) as pool:
                    return list(pool.map(
                        lambda i: dispatch(st, i, last), range(W)))
            arb = SPEC.StageArbiter(W, spec_policy)
            # 2W slots: every shard may run a primary and a duplicate
            pool = ThreadPoolExecutor(
                max_workers=2 * W,
                thread_name_prefix="presto-tpu-speculate")
            try:
                for i in range(W):
                    pool.submit(dispatch, st, i, last, arb, False)
                while not arb.all_won():
                    dead = arb.failed_shard()
                    if dead is not None:
                        raise dead[1]
                    for shard in arb.stragglers():
                        arb.note_speculation(shard)
                        with OT.TRACER.attach(ctx):
                            OT.TRACER.instant_for(
                                qid, "speculative-dispatch",
                                create=True, stage=st.name,
                                shard=shard)
                        pool.submit(dispatch, st, shard, last, arb,
                                    True)
                    arb.wait_turn(0.05)
            finally:
                # losers may still be in flight: do not join them —
                # they clean up after themselves (arbiter loss path)
                # and the query-end prefix DELETE sweeps any residue
                pool.shutdown(wait=False)
            for shard in arb.speculation_summary()["speculated"]:
                QS.ADAPTIVE.note(
                    qid, st.name, "speculation",
                    detail=(f"shard {shard} winner "
                            f"{arb.winner_task_id(shard)}"),
                    old_strategy="primary",
                    new_strategy=("speculative"
                                  if arb.winner_was_speculative(shard)
                                  else "primary"))
            return arb.results()

        from presto_tpu_torch.ft import speculate as SPEC
        spec_policy = SPEC.SpeculationPolicy.from_session(session)
        adapt = None
        if bool(session.get("adaptive_replanning")):
            from presto_tpu_torch.parallel.adaptive import AdaptiveController
            try:
                adapt = AdaptiveController(self.engine, plan, g, qid, W)
            except Exception:  # noqa: BLE001 - adaptivity is optional
                adapt = None

        stages = list(g.stages)
        last_name = g.last_stage
        sources_of: dict[str, dict] = {}
        if qr is not None:
            qr.progress_plan(self._progress_weights(stages))
        try:
            inline: list | None = None
            idx = 0
            while idx < len(stages):
                st = stages[idx]
                CANCEL.checkpoint()
                if qr is not None:
                    qr.note_stage_dispatched(st.name)
                stage_by_name[st.name] = st
                sources_of[st.name] = {
                    t: {"stage": p, "mode": m}
                    for t, (p, m) in st.sources.items()}
                frag_of[st.name] = fragment_to_dict(st.fragment)
                nparts_of[st.name] = (W if st.partition_keys is not None
                                      else 1)
                with state_lock:
                    placed.setdefault(st.name, {})
                last = st.name == last_name
                outs = run_stage(st, last)
                if qr is not None:
                    qr.note_stage_completed(st.name)
                if last:
                    inline = outs
                elif adapt is not None and idx + 1 < len(stages):
                    # the within-query feedback loop: materially
                    # divergent stage actuals re-optimize and re-stage
                    # the not-yet-dispatched remainder
                    revised = adapt.observe(st, outs,
                                            stages[idx + 1:])
                    if revised is not None:
                        stages = stages[:idx + 1] + list(revised.stages)
                        last_name = revised.last_stage
                        # re-weight the progress plan for the revised
                        # remainder (the recorder's monotonic floor
                        # absorbs any shrink)
                        if qr is not None:
                            qr.progress_plan(
                                self._progress_weights(stages))
                        for st2 in revised.stages:
                            for _t, (prod, m) in st2.sources.items():
                                readers_of[prod] = max(
                                    readers_of.get(prod, 1),
                                    W if m == "all" else 1)
                idx += 1
            walk_done[0] = True
            assert inline is not None
            with state_lock:
                task_retries = retries[0]
            meta: dict = {"nshards": W, "mode": "fragments",
                          "stages": len(stages),
                          "retry_policy": "TASK",
                          "task_retries": task_retries}
            if adapt is not None and adapt.replans:
                meta["replans"] = adapt.replans
                meta["adaptive"] = adapt.summary()["decisions"]
                self.last_adaptive_explain = adapt.annotated_plan()
            return self._finish_with_partials(
                plan, g.agg, g.boundary, inline, meta, adapt=adapt)
        finally:
            # failed/canceled walks too: in-flight speculation losers
            # must not repair exchanges once cleanup starts
            walk_done[0] = True
            self._collect_stage_stats(workers, qid, sources_of)
            for w in workers:
                try:
                    w.delete_task(qid)
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass

    def _execute_fragmented(self, plan, fragged,
                            workers: list[RemoteWorker],
                            query_id: str | None = None):
        """Run a fragmented join plan: scan stages partition legs into
        worker buffers, join stages pull co-partitions and join, the
        coordinator finishes (FINAL agg + sort/limit). See
        parallel/fragmenter.py."""
        import dataclasses as DC
        import uuid

        from presto_tpu_torch.plan import nodes as N
        from presto_tpu_torch.plan.serde import fragment_to_dict

        # attempt-unique, query-id-prefixed (see _execute_general)
        qid = (f"{query_id}.{uuid.uuid4().hex[:6]}" if query_id
               else uuid.uuid4().hex[:8])
        W = len(workers)
        wire_codec = self._wire_codec()

        def exchange_scan(name: str, types: dict) -> N.TableScan:
            return N.TableScan("__exchange__", name,
                               {s: s for s in types}, dict(types))

        def run_stage(payloads: list[dict]) -> list:
            return self._run_stage(workers, payloads)

        qr = QS.current_query()
        if qr is not None:
            qr.progress_plan(self._progress_weights(
                list(fragged.scan_stages) + list(fragged.join_stages)))
        try:
            # -- scan stages: leg fragments partition into buffers -----
            stage_types: dict[str, dict] = {}
            for st in fragged.scan_stages:
                if qr is not None:
                    qr.note_stage_dispatched(st.name)
                stage_types[st.name] = st.fragment.output_types()
                frag = fragment_to_dict(st.fragment)
                run_stage([{
                    "fragment": frag,
                    "task_id": f"{qid}.{st.name}",
                    "shard": i, "nshards": W, "wire": wire_codec,
                    "partition": {"nparts": W,
                                  "keys": st.partition_keys},
                    "async": True,
                } for i in range(W)])
                if qr is not None:
                    # async dispatch: accepted = produced-or-producing;
                    # the consuming join stage gates actual completion
                    qr.note_stage_completed(st.name)

            # -- join stages -------------------------------------------
            inline_results: list[bytes] | None = None
            for js in fragged.join_stages:
                CANCEL.checkpoint()
                if qr is not None:
                    qr.note_stage_dispatched(js.name)
                probe_scan = exchange_scan("probe",
                                           stage_types[js.probe_name])
                build_scan = exchange_scan("build",
                                           stage_types[js.build_name])
                root: N.PlanNode = DC.replace(
                    js.join, left=probe_scan, right=build_scan)
                for up in js.upper:
                    root = DC.replace(up, source=root)
                if js.out_partition_keys is None and \
                        fragged.agg is not None:
                    root = DC.replace(fragged.agg, source=root,
                                      step=N.AggStep.PARTIAL)
                stage_types[js.name] = root.output_types()
                frag = fragment_to_dict(root)
                payloads = []
                for i in range(W):
                    sources = {
                        "probe": [
                            {"uri": w.uri,
                             "task_id": f"{qid}.{js.probe_name}",
                             "part": i} for w in workers],
                        "build": [
                            {"uri": w.uri,
                             "task_id": f"{qid}.{js.build_name}",
                             "part": i} for w in workers],
                    }
                    p: dict = {"fragment": frag, "sources": sources,
                               "task_id": f"{qid}.{js.name}",
                               "wire": wire_codec}
                    if js.out_partition_keys is not None:
                        p["partition"] = {
                            "nparts": W, "keys": js.out_partition_keys}
                        p["async"] = True
                    payloads.append(p)
                outs = run_stage(payloads)
                if qr is not None:
                    qr.note_stage_completed(js.name)
                if js.out_partition_keys is None:
                    inline_results = outs  # bytes per worker

            # -- coordinator: final over gathered worker results -------
            assert inline_results is not None
            return self._finish_with_partials(
                plan, fragged.agg, fragged.boundary, inline_results,
                {"nshards": W, "mode": "fragments",
                 "stages": len(fragged.scan_stages)
                 + len(fragged.join_stages)})
        finally:
            self._collect_stage_stats(workers, qid, {
                js.name: {
                    "probe": {"stage": js.probe_name, "mode": "part"},
                    "build": {"stage": js.build_name, "mode": "part"}}
                for js in fragged.join_stages})
            for w in workers:
                try:
                    w.delete_task(qid)
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass

    def _dispatch_splits(self, payloads: list[dict],
                         workers: list[RemoteWorker]) -> list[dict]:
        """Each split runs on its assigned worker; a failed worker's
        split retries on the surviving nodes (the elastic-recovery
        piece the reference lacks mid-query — failures there kill the
        query, SURVEY §5). retry_policy=NONE disables the cross-worker
        retry: the split fails the query loudly."""
        ctx = OT.current_context()  # pool threads don't inherit it
        timeout = self._task_timeout()
        failover = self._retry_policy() != "NONE"
        tok = CANCEL.current()  # nor the cancel token
        qr = QS.current_query()  # nor the stats recorder

        def run_one(i: int) -> dict:
            if tok is not None:
                tok.check()
            order = [workers[i % len(workers)]] + [
                w for j, w in enumerate(workers)
                if j != i % len(workers)]
            if not failover:
                order = order[:1]
            last_err: Exception | None = None
            tried = 0
            for w in order:
                if not w.alive:
                    continue
                tried += 1
                if tried > 1:
                    _TASK_RETRIES.inc()
                    if qr is not None:
                        qr.note_task_retry()
                try:
                    with OT.TRACER.attach(ctx):
                        out = w.post_task_any(payloads[i],
                                              timeout=timeout)
                    w.record(False)
                    return out
                except TaskError:
                    # application error: deterministic, the node is
                    # healthy — do not blacklist, do not retry
                    raise
                except Exception as e:  # noqa: BLE001 - node failure
                    w.record(True)
                    w.record(True)  # fast-fail: push over threshold
                    last_err = e
            raise NoWorkersError(
                f"split {i} failed on every live worker: {last_err}")

        with ThreadPoolExecutor(max_workers=len(payloads)) as pool:
            return list(pool.map(run_one, range(len(payloads))))
