"""Worker process: executes plan fragments over splits and exchanges
(the port of ``presto_tpu/parallel/worker.py``).

The multi-host analog of the reference worker runtime
(server/TaskResource.java:123 POST /v1/task + SqlTaskManager.updateTask
-> SqlTaskExecution.createSqlTaskExecution). Two task generations:

1. ``{"sql", "shard", "nshards"}`` — the round-2 contract: the worker
   re-plans the SQL over split-view catalogs and returns the PARTIAL
   aggregation states (kept for scan->aggregate queries).
2. ``{"fragment", ...}`` — serialized plan IR (plan/serde.py), the
   HttpRemoteTask.sendUpdate analog. A fragment may scan base catalogs
   (split by shard/nshards) and/or ``__exchange__`` tables fed by
   pulling peer workers' partition buffers (binary columnar wire,
   parallel/wire.py: Arrow IPC pages by default, framed npz fallback,
   negotiated per request via Accept + the payload's ``wire`` field —
   the ExchangeClient/OutputBuffer pair of the reference,
   TaskResource.java:261 results endpoints). The fragment's result
   either hash-partitions into this worker's buffer store for the
   next stage, or returns inline as binary columns.

Each worker's engines run on one device (``WorkerServer(device=...)``:
the GPU unless the caller asks for the CPU), so a fragment runs through
``exec/executor.run_plan`` and the CUDA kernels. A worker's tasks run
in its HTTP handler threads on the device's current stream.
``PRESTO_TPU_WORKER_MEMORY_BYTES`` caps each worker engine's memory
pool, whose bytes ``/v1/status`` and ``/metrics`` report; ``/metrics``
also refreshes the process gauges (``obs/procstats``), and
``/v1/profile/start`` / ``/v1/profile/stop`` wrap the tasks run between
them in a ``torch.profiler`` capture of this process (``obs/devprof``),
with the CUDA activity on a CUDA worker.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import os
import urllib.request

import numpy as np

from presto_tpu_torch.ft import retry as FTR
from presto_tpu_torch.ft.faults import FAULTS
from presto_tpu_torch.obs import qstats as QS
from presto_tpu_torch.obs import trace as OT
from presto_tpu_torch.obs.jsonlog import LOG
from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.server.httpbase import (HttpService, JsonHandler,
                                              urlopen as _urlopen)

# worker-side instruments (shared registry: every worker in a process
# contributes, labeled by node id)
_TASKS = REGISTRY.counter(
    "presto_tpu_worker_tasks_total",
    "tasks accepted by the worker task endpoint")
_TASK_FAILURES = REGISTRY.counter(
    "presto_tpu_worker_task_failures_total",
    "worker tasks that raised")
_EXCHANGE_PAGES = REGISTRY.counter(
    "presto_tpu_exchange_pages_total",
    "exchange buffer pages served to consumers")
_EXCHANGE_BYTES = REGISTRY.counter(
    "presto_tpu_exchange_bytes_total",
    "exchange buffer bytes served to consumers")
_FETCH_BYTES = REGISTRY.counter(
    "presto_tpu_exchange_fetch_bytes_total",
    "exchange bytes pulled from peer workers")
_TASKS_SHED = REGISTRY.counter(
    "presto_tpu_query_shed_total",
    "work rejected for overload protection (worker task-queue caps, "
    "coordinator queue-full), by site")
_TASK_DEPTH = REGISTRY.gauge(
    "presto_tpu_worker_task_queue_depth",
    "tasks currently running or admitted on the worker (the bounded "
    "intake that 503s when full)")


def execute_partial_task(engine_factory, sql: str, shard: int,
                         nshards: int) -> dict:
    """Run the partial-aggregate fragment of ``sql`` over split
    (shard, nshards); returns serialized state columns."""
    from presto_tpu_torch.exec.executor import (collect_scans, run_plan,
                                                start_run)
    from presto_tpu_torch.exec.streaming import _find_streamable
    from presto_tpu_torch.plan import nodes as N

    engine = engine_factory(shard, nshards)
    plan, _ = engine.plan_sql(sql)
    found = _find_streamable(plan)
    if found is None:
        raise ValueError("task SQL is not a partial-aggregatable shape")
    agg, _scan = found
    partial = dataclasses.replace(agg, step=N.AggStep.PARTIAL)
    start_run(engine)
    table = run_plan(engine, partial, collect_scans(partial, engine))

    live = (np.ones(table.nrows, bool) if table.mask is None
            else np.asarray(table.mask))
    cols = []
    for sym, col in table.columns.items():
        data = np.asarray(col.data)[live]
        if col.dictionary is not None:
            values = [str(col.dictionary[c]) for c in data]
        else:
            values = data.tolist()
        valid = (None if col.valid is None
                 else np.asarray(col.valid)[live].tolist())
        # physical dtype travels with the column: state columns' declared
        # types are nominal (checksum/approx sketches hold uint64), so
        # the coordinator must not reconstruct from the SQL type alone
        cols.append({"name": sym, "values": values, "valid": valid,
                     "dtype": (None if col.dictionary is not None
                               else str(data.dtype))})
    return {"columns": cols, "nrows": int(live.sum())}


class BufferConnector:
    """In-memory ``__exchange__`` catalog over pulled peer partitions."""

    name = "__exchange__"

    def __init__(self):
        self._tables: dict[str, tuple[dict, int]] = {}

    def add(self, name: str, cols: dict, nrows: int) -> None:
        self._tables[name] = (cols, nrows)

    def table_names(self):
        return list(self._tables)

    def table_schema(self, name: str):
        cols, _ = self._tables[name]
        return {c: col.dtype for c, col in cols.items()}

    def table(self, name: str):
        from presto_tpu_torch.block import Column, Table
        cols, nrows = self._tables[name]
        if nrows == 0:
            # one dead pad row: join/group kernels need length >= 1
            padded = {}
            for c, col in cols.items():
                data = np.asarray(col.data)
                padded[c] = Column(
                    col.dtype, np.zeros(1, dtype=data.dtype),
                    np.asarray([False]) if col.valid is not None
                    else None, col.dictionary)
            return Table(padded, 1, np.asarray([False]))
        return Table(cols, nrows, None)

    def row_count_estimate(self, name: str) -> int:
        return max(self._tables[name][1], 1)

    def ndv_estimates(self, name: str):
        return {}

    def column_range_estimates(self, name: str):
        return {}

    def unique_keys(self, name: str):
        return []

    def stats(self, name: str):
        from presto_tpu_torch.connectors.base import TableStats
        return TableStats(row_count=self._tables[name][1])


def _auth_headers(secret: str | None) -> dict:
    from presto_tpu_torch.parallel import auth as _auth
    if secret is None:
        secret = _auth.default_secret()
    if secret is None:
        return {}
    return {_auth.HEADER: _auth.make_token(secret)}


# worker-local transient-retry policy for single exchange page GETs: a
# blip (connection reset, proxy 503) retries here; a hard producer
# failure escalates as ExchangeFetchError for the coordinator's
# TASK-retry repair (spool re-point / producer re-run)
_FETCH_BACKOFF = FTR.BackoffPolicy(attempts=3, initial_delay_s=0.05,
                                   max_delay_s=1.0)


def _fetch_pages(ref: dict, timeout: float = 240.0,
                 secret: str | None = None) -> list[bytes]:
    """Pull one partition's pages with continuation tokens until the
    producer reports completion; requesting token T acknowledges every
    page below T on the producer, releasing its buffer bytes (reference
    operator/HttpPageBufferClient.java:321-411). Long-polls through
    not-yet-produced pages, so a consumer scheduled before its producer
    finishes simply waits on the data plane. Transient per-page
    failures retry locally (ft.retrying_call); anything else raises
    :class:`presto_tpu_torch.ft.ExchangeFetchError` naming the producer."""
    import time as _time

    from presto_tpu_torch.parallel import wire as _wire

    headers = _auth_headers(secret)
    # Accept negotiation: name the codecs THIS process decodes so a
    # producer holding pages in another codec transcodes before
    # serving (mixed-version clusters); current peers serve their
    # stored arrow pages untouched
    headers["Accept"] = _wire.accept_header()
    reader = int(ref.get("reader", 0))
    base = (f"{ref['uri']}/v1/task/{ref['task_id']}/results/"
            f"{ref['part']}")
    token = 0
    pages: list[bytes] = []
    deadline = _time.monotonic() + timeout
    with OT.TRACER.span("exchange-fetch", task_id=ref["task_id"],
                        part=int(ref["part"])) as sp:
        while True:
            fkey = f"{ref['task_id']}:{ref['part']}:{token}"
            FAULTS.delay("exchange-fetch-delay", key=fkey)
            req = urllib.request.Request(f"{base}/{token}/{reader}",
                                         headers=headers)

            def _get(req=req, fkey=fkey):
                if FAULTS.should_fire("exchange-fetch-drop", key=fkey):
                    raise ConnectionResetError(
                        "injected exchange-fetch drop")
                with _urlopen(req, timeout=60.0) as resp:
                    return (resp.read(),
                            int(resp.headers.get(
                                "X-PrestoTpu-Next-Token", token)),
                            resp.headers.get("X-PrestoTpu-Complete",
                                             "0") == "1")

            try:
                blob, nxt, complete = FTR.retrying_call(
                    _get, op="exchange-fetch", backoff=_FETCH_BACKOFF)
            except Exception as e:  # noqa: BLE001 - escalate w/ coords
                raise FTR.ExchangeFetchError(
                    str(ref["task_id"]), int(ref["part"]),
                    str(ref["uri"]),
                    f"{type(e).__name__}: {e}") from e
            if blob:
                pages.append(blob)
            if nxt == token and complete:
                nbytes = sum(len(p) for p in pages)
                _FETCH_BYTES.inc(nbytes)
                # per-task exchange accounting (obs/qstats.py), split
                # by wire codec: the fetch runs on the task's thread,
                # so the ambient recorder attributes pulled pages to
                # this task
                by_codec: dict[str, list[int]] = {}
                for p in pages:
                    c = by_codec.setdefault(
                        _wire.payload_codec(p), [0, 0])
                    c[0] += 1
                    c[1] += len(p)
                for codec, (np_, nb) in by_codec.items():
                    QS.note_exchange(np_, nb, codec=codec)
                if not by_codec:
                    QS.note_exchange(0, 0)
                if sp is not None:
                    sp.attrs["pages"] = len(pages)
                    sp.attrs["bytes"] = nbytes
                return pages
            token = nxt
            if _time.monotonic() > deadline:
                raise FTR.ExchangeFetchError(
                    str(ref["task_id"]), int(ref["part"]),
                    str(ref["uri"]),
                    f"fetch timed out after {timeout:.0f}s")


def execute_fragment_task(engine, req: dict, store: dict,
                          secret: str | None = None,
                          engine_lock=None) -> object:
    """Run one fragment task. Returns a dict (JSON response, buffered
    output) or bytes (inline binary result).

    ``engine_lock`` guards ONLY the engine-using section (the cached
    engine's __exchange__ catalog is per-worker state). Source fetching
    (long-polls upstream producers) and page emission (blocks on the
    bounded buffer) run OUTSIDE it — holding the lock there would
    deadlock a producer and its same-worker consumer against each
    other."""
    import contextlib

    from presto_tpu_torch.exec.executor import (collect_scans, run_plan,
                                                start_run)
    from presto_tpu_torch.parallel.exchange_host import (partition_ids,
                                                         slice_columns)
    from presto_tpu_torch.parallel.wire import (columns_to_bytes,
                                                pages_to_columns)
    from presto_tpu_torch.plan.serde import fragment_from_dict

    plan = fragment_from_dict(req["fragment"])
    # producer-side codec: the coordinator pins one per query in the
    # payload so a whole stage DAG stays consistent; absent (older
    # coordinator) the worker's own default applies
    codec = req.get("wire")
    sources = req.get("sources") or {}
    conn = None
    if sources:
        conn = BufferConnector()
        for tname, refs in sources.items():
            blobs: list = []
            for r in refs:
                blobs.extend(_fetch_pages(r, secret=secret))
            # single preallocated assembly: arrow pages decode to
            # zero-copy views and each column is filled into ONE
            # output array (the old per-page decode + concat copied
            # every byte twice)
            cols, nrows = pages_to_columns(blobs)
            # per-source input rows: the stage-rollup consistency
            # check (producer output rows == consumer input rows for
            # partitioned sources) reads these
            QS.add_input_rows(tname, nrows)
            conn.add(tname, cols, nrows)

    with (engine_lock if engine_lock is not None
          else contextlib.nullcontext()):
        if conn is not None:
            engine.catalogs["__exchange__"] = conn
        start_run(engine)
        table = run_plan(engine, plan, collect_scans(plan, engine))
    live = (np.ones(table.nrows, bool) if table.mask is None
            else np.asarray(table.mask))
    cols = slice_columns(table.columns, live)

    part = req.get("partition")
    if part is None and not req.get("store"):
        QS.set_output_rows(int(live.sum()))
        return columns_to_bytes(cols, codec=codec)

    # buffered output: pages of ~PAGE_BYTES each stream into the
    # task's bounded OutputBuffer. add() BLOCKS when unacked bytes
    # exceed the buffer capacity — the producer waits for the consumer
    # stage to drain (backpressure; see parallel/buffer.py)
    buf = store[req["task_id"]]
    if part is None:
        _emit_pages(buf, 0, cols, int(live.sum()), codec=codec)
    else:
        nparts = int(part["nparts"])
        ids = partition_ids(cols, part["keys"], nparts)
        for p in range(nparts):
            sel = ids == p
            _emit_pages(buf, p, slice_columns(cols, sel),
                        int(sel.sum()), codec=codec)
    buf.set_complete()
    QS.set_output_rows(sum(buf.rows()))
    return {"rows": buf.rows()}


PAGE_BYTES = int(os.environ.get(
    "PRESTO_TPU_EXCHANGE_PAGE_BYTES", 4 << 20))
BUFFER_BYTES = int(os.environ.get(
    "PRESTO_TPU_EXCHANGE_BUFFER_BYTES", 64 << 20))


def _emit_pages(buf, partition: int, cols: dict, nrows: int,
                codec: str | None = None) -> None:
    """Slice one partition's columns into ~PAGE_BYTES pages and stream
    them into the bounded buffer."""
    from presto_tpu_torch.parallel.exchange_host import slice_columns
    from presto_tpu_torch.parallel.wire import columns_to_bytes

    if nrows == 0:
        buf.add(partition, columns_to_bytes(cols, codec=codec), 0)
        return
    # size estimate includes amortized dictionary bytes so wide string
    # columns don't produce pages far beyond PAGE_BYTES
    row_bytes = max(1, sum(
        np.asarray(c.data).dtype.itemsize
        + (1 if c.valid is not None else 0)
        + (sum(len(str(x)) for x in c.dictionary) * 4 // max(nrows, 1)
           if c.dictionary is not None else 0)
        for c in cols.values()))
    rows_per_page = max(1, PAGE_BYTES // row_bytes)
    start = 0
    while start < nrows:
        stop = min(start + rows_per_page, nrows)
        if start == 0 and stop == nrows:
            page_cols = cols
        else:
            mask = np.zeros(nrows, bool)
            mask[start:stop] = True
            page_cols = _compact_dictionaries(
                slice_columns(cols, mask))
        buf.add(partition, columns_to_bytes(page_cols, codec=codec),
                stop - start)
        start = stop


def _compact_dictionaries(cols: dict) -> dict:
    """Per-page dictionary narrowing — shared with the streamed
    result path (parallel/wire.py, where the page codecs live)."""
    from presto_tpu_torch.parallel.wire import compact_page_dictionaries

    return compact_page_dictionaries(cols)


class WorkerServer(HttpService):
    """HTTP worker node (WorkerModule / TaskResource analog). Holds a
    base catalog set; each task re-wraps it in split views. Engines are
    cached per (shard, nshards) so the program cache and the device
    copies of the scanned columns survive across tasks of repeat
    queries. ``device`` is every engine's device: None means the GPU,
    and raises without CUDA, as ``Engine`` does; ``"cpu"`` runs the
    plain PyTorch versions of the kernels."""

    # NOTE on spool sharing: a spool directory may be shared between
    # workers (that is what lets a survivor serve a dead producer's
    # pages), which is safe because only retry_policy=TASK payloads
    # request spooling and their task ids are globally unique
    def __init__(self, catalogs: dict, host: str = "127.0.0.1",
                 port: int = 0, node_id: str = "worker",
                 shared_secret: str | None = None,
                 tls: tuple[str, str] | None = None,
                 spool_dir: str | None = None,
                 max_tasks: int | None = None, device=None):
        from presto_tpu_torch.engine import resolve_device
        from presto_tpu_torch.parallel import auth as _auth
        from presto_tpu_torch.parallel import wire as _wire
        # the page codec's pyarrow is imported on the thread that makes
        # the worker: imported first on a request thread of a process
        # that had called torch.set_num_threads, its arrow encode of
        # the task's result crashed the process (SIGSEGV)
        _wire._pyarrow()
        self.catalogs = catalogs
        self.device = resolve_device(device)
        self.node_id = node_id
        # overload backpressure: at most this many tasks running or
        # admitted at once; excess POSTs are shed with 503 +
        # Retry-After, which ft.retrying_call classifies transient so
        # the task/query retry layers rotate to another worker instead
        # of hammering this one (reference task.max-worker-threads +
        # the SqlTaskManager queue bound)
        self._max_tasks = (max_tasks if max_tasks is not None
                           else int(os.environ.get(
                               "PRESTO_TPU_WORKER_MAX_TASKS", "16")))
        self._active_tasks = 0
        self.shared_secret = (shared_secret
                              if shared_secret is not None
                              else _auth.default_secret())
        self.buffers: dict[str, object] = {}  # task -> OutputBuffer
        self.task_state: dict[str, dict] = {}
        # task id -> TaskStats snapshot (obs/qstats.py), served at
        # GET /v1/task/{id}/stats (exact id or prefix — the
        # coordinator pulls a whole query's tasks with one GET per
        # worker); bounded, cleared by prefix DELETE
        self.task_stats: dict[str, dict] = {}
        self._engines: dict[tuple, object] = {}
        self._lock = threading.Lock()
        # fragment tasks mutate the cached engine's __exchange__
        # catalog; serialize them (one task at a time per worker, the
        # single-device analog of task_concurrency=1)
        self._task_lock = threading.Lock()
        # lifecycle state: "active" accepts tasks; "shutting_down"
        # (PUT /v1/info/state, the reference's graceful-shutdown
        # protocol) rejects new tasks with 503 while running tasks
        # finish and existing buffers/spool keep serving
        self._state = "active"
        spool_dir = (spool_dir if spool_dir is not None
                     else os.environ.get("PRESTO_TPU_SPOOL_DIR"))
        if spool_dir:
            from presto_tpu_torch.ft.spool import TaskSpool
            self.spool: TaskSpool | None = TaskSpool(spool_dir)
        else:
            self.spool = None

        def engine_factory(shard: int, nshards: int):
            from presto_tpu_torch import Engine
            from presto_tpu_torch.connectors.split import SplitConnector

            with self._lock:
                e = self._engines.get((shard, nshards))
                if e is None:
                    e = Engine(device=self.device)
                    # worker-side memory governance: cap the runtime
                    # pool so concurrent fragment tasks cannot run the
                    # card out of memory
                    cap = int(os.environ.get(
                        "PRESTO_TPU_WORKER_MEMORY_BYTES", "0") or 0)
                    if cap:
                        e.memory_pool.capacity = cap
                    for name, conn in catalogs.items():
                        e.register_catalog(
                            name, SplitConnector(conn, shard, nshards))
                    self._engines[(shard, nshards)] = e
            return e

        outer = self

        class Handler(JsonHandler):
            def _authorized(self) -> bool:
                """Shared-secret check on every task/buffer endpoint
                (reference InternalAuthenticationManager). /v1/status
                and /metrics stay open: the failure detector pings the
                former, scrape collectors poll the latter, and both
                leak only aggregate sizes."""
                if outer.shared_secret is None \
                        or self.path in ("/v1/status", "/metrics"):
                    return True
                from presto_tpu_torch.parallel import auth as _auth
                tok = self.headers.get(_auth.HEADER)
                if _auth.check_token(outer.shared_secret, tok):
                    return True
                self._send_json(
                    {"error": "unauthorized internal request"}, 401)
                return False

            def do_GET(self):  # noqa: N802
                if not self._authorized():
                    return
                parts = self.path.strip("/").split("/")
                if self.path == "/metrics":
                    # worker-side gauges refresh at scrape time; the
                    # text body is the process-wide shared registry
                    from presto_tpu_torch.obs.procstats import (
                        update_process_gauges)
                    update_process_gauges(node=outer.node_id)
                    with outer._lock:
                        engines = list(outer._engines.values())
                    pools = [e.memory_pool.info() for e in engines]
                    g = REGISTRY.gauge(
                        "presto_tpu_worker_cached_engines",
                        "split-view engines cached on the worker")
                    g.set(len(engines), node=outer.node_id)
                    g = REGISTRY.gauge(
                        "presto_tpu_worker_open_buffers",
                        "task output buffers held by the worker")
                    g.set(len(outer.buffers), node=outer.node_id)
                    g = REGISTRY.gauge(
                        "presto_tpu_worker_program_cache_entries",
                        "compiled programs resident across the "
                        "worker's cached engines (exec/progcache.py)")
                    g.set(sum(len(e._program_cache) for e in engines),
                          node=outer.node_id)
                    g = REGISTRY.gauge(
                        "presto_tpu_memory_reserved_bytes",
                        "runtime memory pool reservation")
                    g.set(sum(p["reservedBytes"] for p in pools),
                          node=outer.node_id)
                    body = REGISTRY.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if len(parts) == 3 and parts[:2] == ["v1", "trace"]:
                    # per-trace span export for cross-process
                    # collection: a collector (or the coordinator)
                    # merges these into the query's unified trace
                    self._send_json({"spans": [
                        s.to_dict()
                        for s in OT.TRACER.spans(parts[2])]})
                    return
                if self.path == "/v1/status":
                    # snapshot under the lock engine_factory inserts
                    # under: a status poll racing a task POST must not
                    # iterate a mutating dict
                    with outer._lock:
                        engines = list(outer._engines.values())
                        active = outer._active_tasks
                    pools = [e.memory_pool.info() for e in engines]
                    self._send_json({
                        "nodeId": outer.node_id, "state": outer.state,
                        "activeTasks": active,
                        "memory": {
                            "reservedBytes": sum(
                                p["reservedBytes"] for p in pools),
                            "peakBytes": sum(
                                p["peakBytes"] for p in pools)}})
                    return
                if (len(parts) in (6, 7)
                        and parts[:2] == ["v1", "task"]
                        and parts[3] == "results"):
                    # paged: /v1/task/{tid}/results/{part}/{token}
                    # [/{reader}] — token T acknowledges the reader's
                    # pages < T (reference TaskResource.java:261-336).
                    # The spool (ft/spool.py) backs this endpoint: a
                    # missing buffer (dead/restarted producer, task
                    # deleted) or an already-released page (retried
                    # consumer re-reading from token 0) serves from
                    # the spooled copy instead of failing the query.
                    part_i = int(parts[4])
                    token_i = int(parts[5])
                    reader_i = int(parts[6]) if len(parts) == 7 else 0
                    from presto_tpu_torch.parallel import wire as _W
                    from presto_tpu_torch.parallel.buffer import TaskFailed
                    buf = outer.buffers.get(parts[2])
                    if buf is None:
                        sp = outer.spool_page(parts[2], part_i,
                                              token_i)
                        if sp is None:
                            self._send_json(
                                {"error": "no such buffer"}, 404)
                            return
                        blob, nxt, complete = sp
                    else:
                        try:
                            blob, nxt, complete = buf.page(
                                part_i, token_i, reader_i)
                        except TaskFailed as tf:
                            sp = outer.spool_page(parts[2], part_i,
                                                  token_i)
                            if sp is None:
                                self._send_json({"error": str(tf)},
                                                500)
                                return
                            blob, nxt, complete = sp
                    ctype = None
                    if blob:
                        # content negotiation: stored pages serve
                        # UNTOUCHED (mmap'd spool bytes included) when
                        # the consumer's Accept admits their codec; a
                        # consumer that cannot parse it (npz-only
                        # peer in a mixed-version cluster, or no
                        # Accept header at all = pre-arrow reader)
                        # gets a transcoded copy
                        codec = _W.payload_codec(blob)
                        accepted = _W.accepted_codecs(
                            self.headers.get("Accept"))
                        if codec not in accepted:
                            blob = _W.transcode(blob, accepted[0])
                            codec = accepted[0]
                        ctype = _W.CONTENT_TYPES[codec]
                        _EXCHANGE_PAGES.inc(node=outer.node_id)
                        _EXCHANGE_BYTES.inc(len(blob),
                                            node=outer.node_id,
                                            codec=codec)
                    self._send_bytes(blob or b"", content_type=ctype,
                                     extra_headers={
                        "X-PrestoTpu-Next-Token": str(nxt),
                        "X-PrestoTpu-Complete":
                            "1" if complete else "0"})
                    return
                if (len(parts) == 4 and parts[:2] == ["v1", "task"]
                        and parts[3] == "status"):
                    st = outer.task_state.get(parts[2])
                    if st is None:
                        self._send_json({"error": "no such task"}, 404)
                        return
                    self._send_json(st)
                    return
                if (len(parts) == 4 and parts[:2] == ["v1", "task"]
                        and parts[3] == "stats"):
                    # TaskStats by exact id or id prefix (a query's
                    # task ids share its query-id prefix, so the
                    # coordinator assembles StageStats with one GET
                    # per worker — reference TaskResource task info)
                    self._send_json(
                        {"tasks": outer.stats_for(parts[2])})
                    return
                self._send_json({"error": "not found"}, 404)

            def do_DELETE(self):  # noqa: N802
                if not self._authorized():
                    return
                path, _sep, query = self.path.partition("?")
                parts = path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "task"]:
                    # task-id prefix delete: one query's stages share
                    # a query-id prefix (ack/cleanup, the reference's
                    # explicit DELETE on drained buffers). ?exact=1
                    # deletes ONE task id verbatim — the speculation
                    # loser-cancel path, where a losing primary
                    # "...0" must not prefix-wipe its winning
                    # attempt-versioned duplicate "...0a1"
                    from urllib.parse import parse_qs
                    prefix = parts[2]
                    exact = parse_qs(query).get("exact") == ["1"]

                    def hit(tid: str) -> bool:
                        return (tid == prefix if exact
                                else tid.startswith(prefix))

                    for tid in list(outer.buffers):
                        if hit(tid):
                            buf = outer.buffers.pop(tid, None)
                            if buf is not None and not buf.complete:
                                # unblock a producer still waiting on
                                # a consumer that will never come
                                buf.fail("task deleted")
                    for tid in list(outer.task_state):
                        if hit(tid):
                            outer.task_state.pop(tid, None)
                    with outer._lock:
                        for tid in list(outer.task_stats):
                            if hit(tid):
                                outer.task_stats.pop(tid, None)
                    if outer.spool is not None:
                        if exact:
                            outer.spool.delete_exact(prefix)
                        else:
                            outer.spool.delete_prefix(prefix)
                    self._send_json({})
                    return
                self._send_json({"error": "not found"}, 404)

            def do_PUT(self):  # noqa: N802
                if not self._authorized():
                    return
                if self.path == "/v1/info/state":
                    # graceful drain (reference NodeState SHUTTING_DOWN
                    # over PUT /v1/info/state): stop ACCEPTING tasks,
                    # let running ones finish, keep serving buffers;
                    # the coordinator stops scheduling to this node.
                    # ACTIVE re-enables (tests + rolling restarts).
                    body = self._read_json()
                    state = (body.get("state")
                             if isinstance(body, dict) else body)
                    state = str(state or "").upper()
                    if state == "SHUTTING_DOWN":
                        outer.set_state("shutting_down")
                    elif state == "ACTIVE":
                        outer.set_state("active")
                    else:
                        self._send_json(
                            {"error": f"unknown state {state!r}"}, 400)
                        return
                    LOG.log("worker_state", node=outer.node_id,
                            state=outer.state)
                    self._send_json({"nodeId": outer.node_id,
                                     "state": outer.state})
                    return
                self._send_json({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                if not self._authorized():
                    return
                if self.path in ("/v1/profile/start",
                                 "/v1/profile/stop"):
                    # on-demand device profiler on THIS worker's
                    # process (obs/devprof.py): task execution between
                    # start and stop lands in the capture
                    from presto_tpu_torch.obs import devprof
                    if self.path.endswith("/start"):
                        res = devprof.start_capture(
                            f"worker-{outer.node_id}",
                            cuda=outer.device.type == "cuda")
                    else:
                        res = devprof.stop_capture()
                    self._send_json(res,
                                    503 if res.get("error") else 200)
                    return
                if self.path != "/v1/task":
                    self._send_json({"error": "not found"}, 404)
                    return
                req = self._read_json()
                fkey = (f"{outer.node_id}:"
                        f"{req.get('task_id') or ''}")
                if FAULTS.should_fire("worker-task-crash", key=fkey):
                    # simulate the worker dying mid-dispatch: the
                    # connection drops with no response, which the
                    # coordinator sees exactly like a crashed node
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self.connection.close()
                    return
                if FAULTS.should_fire("task-post-503", key=fkey):
                    self._send_json(
                        {"error": "injected service unavailable"}, 503)
                    return
                if not outer.accepting_tasks():
                    # draining: 503 is classified transient, so a
                    # retrying coordinator re-dispatches elsewhere
                    outer.shed_instant(self.headers, req, "drain")
                    self._send_json(
                        {"error": f"worker {outer.node_id} is "
                                  "shutting down"}, 503,
                        extra_headers={"Retry-After": "1"})
                    return
                if not outer.begin_task():
                    # task-queue cap: shed with 503 + Retry-After —
                    # transient by ft.retrying_call's contract, so the
                    # coordinator's retry layers rotate workers
                    # instead of hammering this one
                    _TASKS_SHED.inc(site="worker-task-queue",
                                    node=outer.node_id)
                    outer.shed_instant(self.headers, req,
                                       "worker-task-queue")
                    self._send_json(
                        {"error": f"worker {outer.node_id} task "
                                  f"queue is full "
                                  f"({outer._max_tasks} tasks)"}, 503,
                        extra_headers={"Retry-After": "1"})
                    return
                # the handler releases the task slot unless an async
                # worker thread took ownership of it; the try opens
                # IMMEDIATELY after the claim — any exception before
                # ownership transfer must reach the releasing finally
                release_slot = True
                try:
                    # propagated trace context: worker spans parent
                    # under the coordinator's task-dispatch span
                    ctx = OT.parse_context(
                        self.headers.get(OT.TRACE_HEADER))
                    kind = ("fragment" if "fragment" in req
                            else "partial")
                    _TASKS.inc(node=outer.node_id, kind=kind)
                    if "fragment" in req:
                        engine = engine_factory(
                            int(req.get("shard", 0)),
                            int(req.get("nshards", 1)))
                        tid = req.get("task_id")
                        buffered = bool(req.get("partition")
                                        or req.get("store"))
                        if buffered:
                            from presto_tpu_torch.parallel.buffer import (
                                OutputBuffer)
                            nparts = int(
                                (req.get("partition") or {}).get(
                                    "nparts", 1))
                            # async tasks get the BOUNDED buffer
                            # (consumers drain concurrently); a sync
                            # task must finish its POST before any
                            # consumer exists, so its cap is unbounded
                            cap = (BUFFER_BYTES if req.get("async")
                                   else 1 << 62)
                            # spooling is opt-in per task ("spool":
                            # true rides retry_policy=TASK payloads,
                            # whose task ids are per-shard unique):
                            # QUERY-mode stages share one task id
                            # across workers, which would collide in
                            # a shared spool directory
                            writer = None
                            if outer.spool is not None \
                                    and req.get("spool"):
                                try:
                                    writer = outer.spool.writer(tid)
                                except ValueError:
                                    writer = None  # unspoolable id
                            outer.buffers[tid] = OutputBuffer(
                                nparts, cap,
                                readers=int(req.get("readers", 1)),
                                spool=writer)
                        if req.get("async"):
                            outer.task_state[tid] = {
                                "state": "running"}

                            def run_async(engine=engine, req=req,
                                          tid=tid, ctx=ctx):
                                # re-attach the propagated context:
                                # this thread inherits no contextvars
                                rec = None
                                try:
                                    with OT.TRACER.attach(
                                            ctx, node=outer.node_id), \
                                        OT.TRACER.span(
                                            "worker-task",
                                            task_id=tid,
                                            kind="fragment",
                                            mode="async"), \
                                        QS.task(
                                            str(tid or ""),
                                            node=outer.node_id,
                                            shard=int(req.get(
                                                "shard", 0))) as rec:
                                        out = execute_fragment_task(
                                            engine, req,
                                            outer.buffers,
                                            secret=(
                                                outer.shared_secret),
                                            engine_lock=(
                                                outer._task_lock))
                                    outer.task_state[tid] = {
                                        "state": "finished", **out}
                                except Exception as exc:  # noqa: BLE001
                                    _TASK_FAILURES.inc(
                                        node=outer.node_id)
                                    LOG.log("task_failed",
                                            node=outer.node_id,
                                            task_id=tid,
                                            error=repr(exc)[:500])
                                    buf = outer.buffers.get(tid)
                                    if buf is not None:
                                        buf.fail(repr(exc))
                                    outer.task_state[tid] = {
                                        "state": "failed",
                                        "error": repr(exc)[:500]}
                                finally:
                                    if rec is not None:
                                        outer.store_task_stats(rec)
                                    # the async thread owns the task
                                    # slot claimed at intake
                                    outer.end_task()

                            # slot ownership passes to the task thread
                            # BEFORE it starts (a fast task must not
                            # race the handler's finally into a double
                            # release)
                            release_slot = False
                            thread = threading.Thread(target=run_async,
                                                      daemon=True)
                            try:
                                thread.start()
                            except Exception as exc:
                                # the thread never ran: run_async will
                                # not release the slot — take it back
                                # or overload shrinks intake forever
                                release_slot = True
                                outer.task_state[tid] = {
                                    "state": "failed",
                                    "error": repr(exc)[:200]}
                                raise
                            self._send_json({"taskId": tid,
                                             "state": "running"})
                            return
                        rec = None
                        try:
                            with OT.TRACER.attach(
                                    ctx, node=outer.node_id), \
                                    OT.TRACER.span(
                                        "worker-task",
                                        task_id=str(tid or ""),
                                        kind="fragment",
                                        shard=int(req.get(
                                            "shard", 0))), \
                                    QS.task(
                                        str(tid or ""),
                                        node=outer.node_id,
                                        shard=int(req.get(
                                            "shard", 0))) as rec:
                                out = execute_fragment_task(
                                    engine, req, outer.buffers,
                                    secret=outer.shared_secret,
                                    engine_lock=outer._task_lock)
                        finally:
                            if rec is not None:
                                outer.store_task_stats(rec)
                        if isinstance(out, bytes):
                            self._send_bytes(out)
                        else:
                            # TaskStats ride the task result
                            # (reference TaskInfo in the update
                            # response); binary results are covered
                            # by GET /v1/task/{id}/stats
                            self._send_json(
                                {**out, "stats": rec.snapshot()})
                        return
                    rec = None
                    try:
                        with OT.TRACER.attach(ctx,
                                              node=outer.node_id), \
                                OT.TRACER.span(
                                    "worker-task", kind="partial",
                                    shard=int(req["shard"])), \
                                QS.task(
                                    str(req.get("task_id") or ""),
                                    node=outer.node_id,
                                    shard=int(req["shard"])) as rec:
                            out = execute_partial_task(
                                engine_factory, req["sql"],
                                int(req["shard"]), int(req["nshards"]))
                            QS.set_output_rows(int(out["nrows"]))
                    finally:
                        if rec is not None and req.get("task_id"):
                            outer.store_task_stats(rec)
                    self._send_json(out)
                except Exception as e:  # noqa: BLE001 - to coordinator
                    _TASK_FAILURES.inc(node=outer.node_id)
                    LOG.log("task_failed", node=outer.node_id,
                            task_id=str(req.get("task_id") or ""),
                            error=f"{type(e).__name__}: {e}")
                    self._send_json(
                        {"error": f"{type(e).__name__}: {e}"}, 500)
                finally:
                    if release_slot:
                        outer.end_task()

        super().__init__(Handler, host, port, tls=tls)

    # -- lifecycle state (graceful drain) --------------------------------

    @property
    def state(self) -> str:
        # task POSTs read this concurrently with drain PUTs
        with self._lock:
            return self._state

    def set_state(self, state: str) -> None:
        with self._lock:
            self._state = state

    def accepting_tasks(self) -> bool:
        return self.state == "active"

    # -- overload backpressure (bounded task intake) ----------------------

    def begin_task(self) -> bool:
        """Claim a task slot; False = at the cap (caller sheds with
        503 + Retry-After). Async tasks hold their slot until their
        worker thread finishes, so the depth gauge counts real load."""
        with self._lock:
            if self._active_tasks >= self._max_tasks:
                return False
            self._active_tasks += 1
            depth = self._active_tasks
        _TASK_DEPTH.set(depth, node=self.node_id)
        return True

    def end_task(self) -> None:
        with self._lock:
            self._active_tasks -= 1
            depth = self._active_tasks
        _TASK_DEPTH.set(depth, node=self.node_id)

    # -- runtime task statistics (obs/qstats.py) --------------------------

    MAX_TASK_STATS = 512

    def store_task_stats(self, rec) -> None:
        """Keep a finished task's TaskStats snapshot for the stats
        endpoint (bounded FIFO; dicts preserve insertion order)."""
        snap = rec.snapshot()
        with self._lock:
            self.task_stats.pop(rec.task_id, None)
            self.task_stats[rec.task_id] = snap
            while len(self.task_stats) > self.MAX_TASK_STATS:
                self.task_stats.pop(next(iter(self.task_stats)))

    def stats_for(self, prefix: str) -> list[dict]:
        with self._lock:
            return [s for t, s in self.task_stats.items()
                    if t.startswith(prefix)]

    def shed_instant(self, headers, req: dict, site: str) -> None:
        """Mark a shed decision on the owning query's trace timeline
        (the trace id rides the task POST's X-Presto-TPU-Trace header)
        so the overload protections show up on the query timeline,
        not only in counters."""
        ctx = OT.parse_context(headers.get(OT.TRACE_HEADER))
        if ctx is not None:
            OT.TRACER.instant_for(
                ctx[0], "task-shed", create=True, site=site,
                node=self.node_id,
                task_id=str(req.get("task_id") or ""))

    def spool_page(self, task_id: str, partition: int, token: int):
        """(blob, next, complete) from the spool, or None when the
        task is not spooled here (caller decides how to fail)."""
        if self.spool is None:
            return None
        try:
            return self.spool.page(task_id, partition, token)
        except (FileNotFoundError, ValueError, OSError):
            return None
