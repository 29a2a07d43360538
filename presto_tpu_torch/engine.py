"""Engine: the in-process query runner of the port.

The port of ``presto_tpu/engine.py`` for the main path: parse ->
analyze -> logical plan -> optimize -> ``exec/executor.execute_plan``,
all in one process, on one device. ``Engine()`` runs on the GPU and
raises when CUDA is not available; the CPU is used only when the
caller passes ``device="cpu"``.

It runs queries, EXPLAIN and EXPLAIN ANALYZE of a query, SET SESSION,
SHOW CATALOGS / SESSION / TABLES / COLUMNS and DESCRIBE (the last three
rewritten to the ``information_schema`` catalog), PREPARE / EXECUTE
... USING / DEALLOCATE PREPARE, CREATE TABLE AS, INSERT, DELETE,
UPDATE, DROP TABLE and START TRANSACTION / COMMIT / ROLLBACK. An
EXECUTE resolves to the statement it names before anything else looks
at it, so a prepared statement runs exactly as the same statement sent
directly would. A statement runs under a cancellation scope (the
caller's ``cancel_token``, the session's ``query_max_run_time``
deadline at the executor's checkpoints and its
``query_max_planning_time`` at the planner's; ``exec/cancel.py``) and
under query monitoring (``events.monitored``: lifecycle events, the
history behind ``system.runtime.queries``, a ``query`` span inside an
open trace).

Every write checks ``access_control.check_can_write`` and snapshots
its connector into the open transaction, and every statement that may
change table data drops the engine's device copies of host arrays
(``invalidate_device_cache``): the memory connector mutates its arrays
in place, and the caches key on the host array's identity.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table, _decode_column, pad_object_lists
from presto_tpu_torch.connectors.base import Connector
from presto_tpu_torch.exec import hostsync as HS
from presto_tpu_torch.obs.trace import TRACER
from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES, Session


class _PerThread:
    """An engine attribute with one value per thread: the HTTP
    dispatcher runs several queries on one engine at once, and each
    query's records (its warnings, programs, kernel notes, backend and
    streamed blocks) belong to the thread that ran it. A thread that
    ran nothing reads ``default()``."""

    def __init__(self, default):
        self.default = default

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, engine, owner=None):
        if engine is None:
            return self
        try:
            return getattr(engine._query_tl, self.name)
        except AttributeError:
            return self.default()

    def __set__(self, engine, value):
        setattr(engine._query_tl, self.name, value)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device without CUDA raises: the
    engine never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch.Engine runs on CUDA, and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


class Engine:
    # per-thread records of the calling thread's last query: its
    # warnings, kernel notes by (program, node position), kernel
    # backend, programs (exec/executor.QueryRun) and the blocks it
    # streamed (0 when it did not stream)
    last_warnings = _PerThread(list)
    last_kernel_notes = _PerThread(dict)
    last_backend = _PerThread(lambda: None)
    last_run = _PerThread(lambda: None)
    last_streamed_blocks = _PerThread(int)

    def __init__(self, session: Session | None = None, device=None):
        from presto_tpu_torch.connectors.information_schema import (
            InformationSchemaConnector, SystemConnector)
        from presto_tpu_torch.events import EventListenerManager
        from presto_tpu_torch.security import AllowAllAccessControl
        from presto_tpu_torch.transaction import TransactionManager

        self.device = resolve_device(device)
        self.session = session or Session()
        self.catalogs: dict[str, Connector] = {}
        # table-level authorization, consulted by the planner at scans
        # and by every write
        self.access_control = AllowAllAccessControl()
        # session-scoped transactions over connector snapshots
        self.transactions = TransactionManager()
        # query lifecycle events and the history behind
        # system.runtime.queries
        self.events = EventListenerManager()
        # persisted query history + divergence-ledger persistence
        # (obs/qstats.py): finished-query profiles append to a bounded
        # JSONL under PRESTO_TPU_HISTORY_DIR and survive restarts,
        # backing system.query_history
        self.history = None
        hist_dir = os.environ.get("PRESTO_TPU_HISTORY_DIR")
        if hist_dir:
            from presto_tpu_torch.obs.qstats import DIVERGENCE, QueryHistory
            try:
                self.history = QueryHistory(hist_dir)
                self.events.add_listener(self.history.on_event)
                DIVERGENCE.attach_dir(hist_dir)
            except OSError:
                self.history = None  # unwritable dir: run without
        # host array id -> (host ref, device tensor): scan columns go to
        # the device once per (table, column); the strong host ref pins
        # the id so a recycled address cannot alias. The host bytes are
        # kept in a ledger, and the oldest copies are let go (FIFO) above
        # dev_cache_limit: a memory table re-encodes its VARCHAR columns
        # at every scan, so each scan brings a fresh codes array
        self._dev_cache: dict[int, tuple[np.ndarray, torch.Tensor]] = {}
        self._dev_cache_bytes = 0
        # guards the cache and its ledger: a cluster worker's HTTP
        # handler threads and a coordinator's finishing threads upload
        # into one engine at once
        self._dev_cache_lock = threading.Lock()
        self.dev_cache_limit = 8 << 30
        # host list column id -> (host ref, its padded 2-D layout)
        self._lists_cache: dict[int, tuple[np.ndarray, tuple]] = {}
        # a bucket-sharded scan's placement over a shard group (host
        # order, uploaded once): (partitioning column ids, mask id,
        # shards, device) -> (rows per shard, per-shard indices, host
        # table)
        self._shard_orders: dict[tuple, tuple] = {}
        # the last distributed query: its capacities by (node, kind),
        # its shard count and each node's distribution
        self.last_dist_meta: dict | None = None
        # run after every statement that may change table data
        self._invalidation_listeners: list = []
        # rows and writer tasks of the last write (_table_to_host)
        self.last_write: dict | None = None
        # backs the _PerThread records above
        self._query_tl = threading.local()
        # per-thread one-shot plan handoff (offer_preplanned /
        # take_preplanned): the HTTP admission layer plans a query to
        # size its memory reservation, and the execution path on the
        # same thread reuses that plan instead of planning twice
        self._preplanned_tl = threading.local()
        # the runtime memory ledger: each program reserves the bytes of
        # its input and output tensors (memory.py; capacity 0 means
        # unbounded, set memory_pool.capacity to enforce)
        from presto_tpu_torch.memory import MemoryPool
        self.memory_pool = MemoryPool()
        # what each program learned (exec/progcache.py): its meta in a
        # bounded LRU, and its successful capacity vector under the
        # same key, so a repeat query climbs no capacity ladder
        from presto_tpu_torch.exec.progcache import ProgramCache
        self._program_cache = ProgramCache()
        self._caps_memory: dict = {}
        # set by the spill driver when the last query ran
        # host-partitioned under its memory budget, and by grouped
        # execution (exec/spill.py)
        self.last_spill: dict | None = None
        self.last_grouped: dict | None = None
        self._in_spill = False
        # the engine's own catalogs (the reference's information_schema
        # and system connectors are engine-side, not plugins)
        self.catalogs["information_schema"] = \
            InformationSchemaConnector(self)
        self.catalogs["system"] = SystemConnector(self)

    def register_catalog(self, name: str, connector: Connector) -> None:
        self.catalogs[name] = connector

    def add_invalidation_listener(self, fn) -> None:
        """``fn()`` runs after every statement that may change table
        data (the same set that drops the device copies)."""
        self._invalidation_listeners.append(fn)

    def resident(self, a) -> torch.Tensor | None:
        """The device copy of a host scan array if the engine holds one."""
        with self._dev_cache_lock:
            hit = self._dev_cache.get(id(a))
        return hit[1] if hit is not None and hit[0] is a else None

    def device_array(self, a) -> torch.Tensor:
        """The device copy of a host scan array, uploaded once and kept
        until a write drops it or, above ``dev_cache_limit`` bytes, newer
        copies push it out (oldest first). A copy that a running program
        still holds lives on until its last reference goes. Thread-safe:
        the lookup and the insert hold ``_dev_cache_lock``, the upload
        runs outside it, and a thread that lost the race to publish
        returns the copy already published (its own upload is dropped),
        as the reference's ``device_array`` does."""
        dev = self.resident(a)
        if dev is not None:
            return dev
        host = np.asarray(a)
        if host.dtype == object:
            raise TypeError(
                "device_array takes numeric host arrays; an ARRAY column "
                "of host lists goes up padded (host_lists)")
        if not host.flags.writeable:
            host = host.copy()
        dev = HS.upload(host, self.device, "scan-column")
        with self._dev_cache_lock:
            hit = self._dev_cache.get(id(a))
            if hit is not None and hit[0] is a:
                return hit[1]  # raced: keep the published copy
            self._dev_cache[id(a)] = (a, dev)
            self._dev_cache_bytes += host.nbytes
            while (self._dev_cache_bytes > self.dev_cache_limit
                   and len(self._dev_cache) > 1):
                old, _ = self._dev_cache.pop(next(iter(self._dev_cache)))
                self._dev_cache_bytes -= np.asarray(old).nbytes
            return dev

    def invalidate_device_cache(self) -> None:
        """Drop every device copy of a host array: the scan columns and
        the padded ARRAY columns. The other caches keyed on a host
        array's identity need no purge: ``ops/hash.DictionaryHashes``
        and ``exec/progcache.dictionary_token`` key on string
        dictionaries, which a connector never mutates in place (a
        memory table's are made afresh at every scan, by
        ``block.column_from_numpy``)."""
        with self._dev_cache_lock:
            self._dev_cache.clear()
            self._dev_cache_bytes = 0
        self._lists_cache.clear()
        self._shard_orders.clear()

    def host_lists(self, element: T.DataType, a) -> tuple:
        """An ARRAY column of host lists (an object array) in the padded
        2-D device layout, (data, lengths, element mask, dictionary),
        made once per column; its arrays go up through device_array,
        so each is uploaded once too."""
        hit = self._lists_cache.get(id(a))
        if hit is not None and hit[0] is a:
            return hit[1]
        padded = pad_object_lists(element, np.asarray(a, dtype=object))
        self._lists_cache[id(a)] = (a, padded)
        return padded

    # -- SQL entry points ---------------------------------------------------

    def _parse(self, sql: str):
        from presto_tpu_torch.sql.parser import parse_statement
        from presto_tpu_torch.sql.rewrite import rewrite_statement
        return rewrite_statement(parse_statement(sql), self)

    def _collecting(self, run):
        from presto_tpu_torch import warnings as W
        W.push(wc := W.WarningCollector())
        try:
            return run()
        finally:
            self.last_warnings = wc.list()
            W.pop()

    def execute(self, sql: str, mesh=None, cancel_token=None
                ) -> list[tuple]:
        """Run SQL, return result rows as Python tuples. With ``mesh``
        (a ``parallel.group.ShardGroup``; the reference takes a device
        mesh) a query runs data-parallel over the group's shards: scans
        split over them, exchanges as the group's collectives.
        ``cancel_token`` (exec/cancel.CancelToken) interrupts the query
        at the planner's and the executor's checkpoints."""
        from presto_tpu_torch.events import monitored
        from presto_tpu_torch.sql import ast as A

        def run():
            text, stmt = self._parse_resolved(sql)
            with self._cancel_scope(cancel_token):
                if isinstance(stmt, A.QueryStatement):
                    return monitored(
                        self, text,
                        lambda: self._execute_query(
                            stmt.query, mesh).to_pylist())
                return monitored(
                    self, text, lambda: self._execute_statement(stmt, mesh))

        return self._collecting(run)

    def execute_table(self, sql: str, mesh=None, cancel_token=None
                      ) -> Table:
        """Run a SELECT, return the result as a host Table."""
        from presto_tpu_torch.events import monitored
        from presto_tpu_torch.sql import ast as A

        def run():
            text, stmt = self._parse_resolved(sql)
            if not isinstance(stmt, A.QueryStatement):
                raise ValueError("execute_table expects a SELECT query")
            preplanned = self.take_preplanned(text)
            with self._cancel_scope(cancel_token):
                return monitored(
                    self, text, lambda: self._execute_query(
                        stmt.query, mesh, preplanned=preplanned))

        return self._collecting(run)

    def _parse_resolved(self, sql: str):
        """(text, statement) of ``sql``; an EXECUTE becomes the statement
        it names, its literals spliced over the ``?`` markers of the
        prepared text (templates/prepared.py)."""
        from presto_tpu_torch.sql import ast as A
        from presto_tpu_torch.templates.prepared import resolve_execute
        stmt = self._parse(sql)
        if isinstance(stmt, A.ExecutePrepared):
            sql = resolve_execute(self.session.prepared_statements, stmt)
            stmt = self._parse(sql)
        return sql, stmt

    @contextlib.contextmanager
    def _cancel_scope(self, token):
        """Install the cancellation token, with the session's
        query_max_run_time deadline, for the duration of one query."""
        from presto_tpu_torch.exec import cancel as C

        limit = float(self.session.get("query_max_run_time") or 0)
        if token is None and limit > 0:
            token = C.CancelToken()
        if token is not None and limit > 0 and token.deadline is None:
            token.deadline = time.monotonic() + limit
        C.install(token)
        try:
            yield
        finally:
            C.install(None)

    def plan_sql(self, sql: str, enable_latemat: bool | None = None):
        """(plan, analysis) of ``sql``. ``enable_latemat`` overrides the
        session's late materialization (the cluster coordinator plans
        with it off: the fragmenter cannot stage its re-join)."""
        from presto_tpu_torch.plan.optimizer import optimize
        from presto_tpu_torch.plan.planner import LogicalPlanner
        from presto_tpu_torch.sql.analyzer import Analyzer
        from presto_tpu_torch.sql.parser import parse_statement
        t0 = time.monotonic()
        with TRACER.span("plan"):
            stmt = parse_statement(sql)
            analysis = Analyzer(self).analyze(stmt)
            self._planning_checkpoint(t0)
            plan = LogicalPlanner(self, analysis).plan(stmt)
            self._planning_checkpoint(t0)
            plan = optimize(plan, self, enable_latemat=enable_latemat)
            self._planning_checkpoint(t0)
        return plan, analysis

    def offer_preplanned(self, sql: str, plan) -> None:
        """Hand a plan just built for ``sql`` to this thread's next
        execution of the same statement (the admission layer plans to
        size its reservation; planning the same SQL again under the same
        session on the same thread would double the planning cost).
        One-shot: the next take_preplanned consumes it, and
        clear_preplanned drops it when the offering scope exits."""
        self._preplanned_tl.value = (sql, plan)

    def take_preplanned(self, sql: str):
        """Consume this thread's offered plan if it was made for
        ``sql``."""
        offered = getattr(self._preplanned_tl, "value", None)
        self._preplanned_tl.value = None
        if offered is not None and offered[0] == sql:
            return offered[1]
        return None

    def clear_preplanned(self) -> None:
        self._preplanned_tl.value = None

    def _planning_checkpoint(self, t0: float) -> None:
        """A seam of the planning phase: observe the cancellation token
        and enforce the session's ``query_max_planning_time`` (seconds
        since ``t0``; 0 means no limit)."""
        from presto_tpu_torch.exec import cancel as C

        C.checkpoint()
        limit = float(self.session.get("query_max_planning_time") or 0)
        if limit and time.monotonic() - t0 > limit:
            raise C.TimeLimitExceeded(
                f"query exceeded query_max_planning_time ({limit:g}s)")

    def explain(self, sql: str) -> str:
        from presto_tpu_torch.cost import explain_estimates
        from presto_tpu_torch.plan.printer import format_plan
        plan, _ = self.plan_sql(sql)
        return format_plan(plan, estimates=explain_estimates(plan, self))

    # -- internals ----------------------------------------------------------

    def _plan_query(self, query, preplanned=None):
        from presto_tpu_torch.plan.optimizer import optimize
        from presto_tpu_torch.plan.planner import LogicalPlanner
        from presto_tpu_torch.plan.sanity import validate_plan
        from presto_tpu_torch.sql import ast as A
        if preplanned is not None:
            # admission planned this exact SQL on this thread (plan_sql,
            # same session scope): only the validation remains
            validate_plan(preplanned)
            return preplanned
        t0 = time.monotonic()
        with TRACER.span("plan"):
            plan = LogicalPlanner(self, None).plan(A.QueryStatement(query))
            self._planning_checkpoint(t0)
            plan = optimize(plan, self)
            self._planning_checkpoint(t0)
            validate_plan(plan)
        return plan

    def _execute_query(self, query, mesh=None, preplanned=None) -> Table:
        """Plan and run a query: over the shard group ``mesh`` when one
        is given (no streaming, spill or segmentation there, as in the
        reference), else on the engine's device. Inside an open trace
        the run is an ``execute`` span beside ``plan``, carrying the
        route ``execute_part`` took."""
        self.last_spill = None
        plan = self._plan_query(query, preplanned=preplanned)
        with TRACER.span("execute") as sp:
            if mesh is not None:
                from presto_tpu_torch.parallel.executor import (
                    execute_plan_distributed)
                return execute_plan_distributed(self, plan, mesh)
            from presto_tpu_torch.exec.executor import execute_plan
            try:
                return execute_plan(self, plan)
            finally:
                if sp is not None:
                    sp.attrs["route"] = self.last_run.route

    def _execute_statement(self, stmt, mesh=None) -> list[tuple]:
        from presto_tpu_torch.sql import ast as A
        try:
            return self._execute_statement_inner(stmt, mesh)
        finally:
            # writes replace connector arrays, and COMMIT / ROLLBACK
            # swap snapshots in: no device copy of a replaced host
            # array may outlive them
            if isinstance(stmt, (A.CreateTableAs, A.InsertStatement,
                                 A.DeleteStatement, A.UpdateStatement,
                                 A.DropTable, A.CommitStatement,
                                 A.RollbackStatement)):
                self.invalidate_device_cache()
                for fn in list(self._invalidation_listeners):
                    fn()

    def _execute_statement_inner(self, stmt, mesh=None) -> list[tuple]:
        from presto_tpu_torch.plan.printer import format_plan
        from presto_tpu_torch.sql import ast as A

        if isinstance(stmt, A.ExplainStatement):
            if not isinstance(stmt.statement, A.QueryStatement):
                raise ValueError("EXPLAIN expects a query")
            plan = self._plan_query(stmt.statement.query)
            if stmt.analyze:
                from presto_tpu_torch.exec.profile import (
                    explain_analyze, explain_analyze_distributed)
                if mesh is not None:
                    return [(explain_analyze_distributed(self, plan,
                                                         mesh),)]
                return [(explain_analyze(self, plan),)]
            from presto_tpu_torch.cost import explain_estimates
            return [(format_plan(
                plan, estimates=explain_estimates(plan, self)),)]
        if isinstance(stmt, A.StartTransaction):
            self.transactions.begin()
            return []
        if isinstance(stmt, A.CommitStatement):
            self.transactions.commit()
            return []
        if isinstance(stmt, A.RollbackStatement):
            self.transactions.rollback()
            return []
        if isinstance(stmt, A.Prepare):
            self.session.prepared_statements[stmt.name] = stmt.sql
            return []
        if isinstance(stmt, A.Deallocate):
            if self.session.prepared_statements.pop(stmt.name,
                                                    None) is None:
                raise ValueError(
                    f"prepared statement not found: {stmt.name}")
            return []
        if isinstance(stmt, A.ShowCatalogs):
            return [(name,) for name in sorted(self.catalogs)]
        if isinstance(stmt, A.ShowSession):
            return [(name, str(self.session.get(name)), str(default),
                     typ.__name__, desc)
                    for name, (default, typ, desc) in sorted(
                        SYSTEM_SESSION_PROPERTIES.items())]
        if isinstance(stmt, A.SetSession):
            self.session.set(stmt.name, _literal_value(stmt.value))
            return []

        if isinstance(stmt, (A.CreateTableAs, A.InsertStatement,
                             A.DeleteStatement, A.UpdateStatement,
                             A.DropTable)):
            catalog, table = self._resolve_table(stmt.table)
            self.access_control.check_can_write(
                self.session.user, catalog, table)
            conn = self._connector(catalog)
            if isinstance(stmt, A.DropTable):
                if table not in conn.table_names():
                    if stmt.if_exists:
                        return []
                    raise ValueError(f"table {table} does not exist")
                self.transactions.touch(conn)
                conn.drop_table(table)
                return []
            self.transactions.touch(conn)
            return [(self._write(stmt, conn, table, mesh),)]

        raise NotImplementedError(
            f"statement {type(stmt).__name__} not supported")

    def _write(self, stmt, conn: Connector, table: str, mesh=None) -> int:
        """CREATE TABLE AS, INSERT, DELETE or UPDATE of ``table`` in
        ``conn``, authorized and snapshotted: the rows written. The
        queries behind it run over ``mesh`` when one is given."""
        from presto_tpu_torch.sql import ast as A

        if isinstance(stmt, A.CreateTableAs):
            result = self._execute_query(stmt.query, mesh)
            schema, data, valid = _table_to_host(result, self)
            return _stream_to_sink(conn.begin_write(table, schema),
                                   data, valid)
        if isinstance(stmt, A.InsertStatement):
            result = self._execute_query(stmt.query, mesh)
            _, data, valid = _table_to_host(result, self)
            names = stmt.columns or list(conn.table_schema(table))
            return _stream_to_sink(
                conn.begin_write(table, None),
                dict(zip(names, data.values())),
                dict(zip(names, valid.values())))
        if isinstance(stmt, A.DeleteStatement):
            # the predicate per row in table order, as a delete mask
            return conn.delete_rows(
                table, self._row_mask(stmt.table, stmt.where, mesh))
        # UPDATE: one scan computes the new values AND the WHERE mask,
        # so both come from the same row order
        target = conn.table_schema(table)
        items = []
        for col, expr in stmt.assignments:
            if col not in target:
                raise ValueError(f"unknown column {col}")
            items.append(A.SelectItem(
                A.CastExpression(expr, str(target[col])), col))
        pred = (A.BooleanLiteral(True) if stmt.where is None
                else A.FunctionCall(
                    "coalesce", (stmt.where, A.BooleanLiteral(False))))
        items.append(A.SelectItem(pred, "__pred__"))
        result = self._execute_query(A.Query(A.QuerySpec(
            tuple(items), False, A.TableRef(stmt.table))), mesh)
        _, data, valid = _table_to_host(result, self)
        mask = np.asarray(data["__pred__"], dtype=bool)
        return conn.update_rows(
            table, {col: data[col] for col, _ in stmt.assignments},
            {col: valid[col] for col, _ in stmt.assignments}, mask)

    def _row_mask(self, table_parts, where, mesh=None):
        """bool[n] in table row order: WHERE evaluates TRUE (NULL and
        FALSE rows are untouched, SQL DELETE/UPDATE semantics); None
        means every row. The projection over one scan keeps the
        table's order, its dead rows (and a shard group's padding)
        dropped by the result's mask."""
        from presto_tpu_torch.sql import ast as A

        if where is None:
            return None
        pred = A.FunctionCall(
            "coalesce", (where, A.BooleanLiteral(False)))
        result = self._execute_query(A.Query(A.QuerySpec(
            (A.SelectItem(pred, "__pred__"),), False,
            A.TableRef(table_parts))), mesh)
        col = next(iter(result.columns.values()))
        data = np.asarray(col.data, dtype=bool)
        if result.mask is not None:
            data = data[np.asarray(result.mask)]
        return data

    def _connector(self, catalog: str) -> Connector:
        conn = self.catalogs.get(catalog)
        if conn is None:
            raise ValueError(f"catalog '{catalog}' does not exist")
        return conn

    def _resolve_table(self, parts: tuple[str, ...]) -> tuple[str, str]:
        if len(parts) == 1:
            return self.session.catalog, parts[0]
        return parts[0], parts[-1]


def _literal_value(e):
    from presto_tpu_torch.sql import ast as A

    if isinstance(e, A.StringLiteral):
        return e.value
    if isinstance(e, A.NumericLiteral):
        return float(e.text) if "." in e.text else int(e.text)
    if isinstance(e, A.BooleanLiteral):
        return e.value
    if isinstance(e, A.Identifier):
        return e.name
    raise ValueError("SET SESSION value must be a literal")


# one writer task per this many result cells (rows x columns); the task
# count grows with the data written, up to WRITER_MAX_TASKS (the
# reference's scaled writers, applied to the write side's host work:
# reading and decoding the result columns)
WRITER_SCALING_CELLS = 1 << 20
WRITER_MAX_TASKS = 8


def _table_to_host(table: Table, engine=None):
    """Result Table -> (schema, host column arrays, validity masks) of
    its live rows. VARCHAR decodes to strings; other types keep their
    physical values (decimals stay scaled). A large result converts on
    a scaled pool of writer tasks, one column each; with ``engine``,
    ``engine.last_write`` records the rows and writer tasks."""
    mask = (np.ones(table.nrows, dtype=bool) if table.mask is None
            else np.asarray(table.mask))

    def convert(item):
        name, col = item
        raw = np.asarray(col.data)[mask]
        out = (_decode_column(col.dtype, raw, col.dictionary)
               if isinstance(col.dtype, T.VarcharType) else raw)
        v = None if col.valid is None else np.asarray(col.valid)[mask]
        return name, col.dtype, out, v

    cells = table.nrows * max(len(table.columns), 1)
    writers = min(WRITER_MAX_TASKS, max(1, cells // WRITER_SCALING_CELLS))
    items = list(table.columns.items())
    if writers > 1 and len(items) > 1:
        from concurrent.futures import ThreadPoolExecutor

        # context-free by design: convert() is host numpy only: no
        # span, checkpoint or session read happens on the writer threads
        with ThreadPoolExecutor(max_workers=writers) as pool:
            results = list(pool.map(convert, items))  # lint: disable=handoff
    else:
        writers = 1
        results = [convert(i) for i in items]
    if engine is not None:
        engine.last_write = {"writer_tasks": writers,
                             "rows": int(mask.sum())}
    schema = {name: dtype for name, dtype, _, _ in results}
    data = {name: out for name, _, out, _ in results}
    valid = {name: v for name, _, _, v in results}
    return schema, data, valid


# rows per page through a connector's write sink
WRITE_PAGE_ROWS = 1 << 20


def _stream_to_sink(sink, data: dict, valid: dict) -> int:
    """Feed a write's columns to a PageSink page by page and commit on
    finish (the reference's TableWriterOperator feeding a
    ConnectorPageSink). The sink is aborted on failure, so a connector
    never sees a partial commit. The default buffering sink would only
    concatenate the pages again, so it takes the whole arrays as one
    page; a connector's own sink takes pages of WRITE_PAGE_ROWS."""
    from presto_tpu_torch.connectors.base import _BufferingPageSink

    total = len(next(iter(data.values()), []))
    try:
        if isinstance(sink, _BufferingPageSink):
            sink.append_page(data, valid)
            return sink.finish()
        start = 0
        while True:
            stop = min(start + WRITE_PAGE_ROWS, total)
            sink.append_page(
                {c: a[start:stop] for c, a in data.items()},
                {c: None if v is None else v[start:stop]
                 for c, v in valid.items()})
            start = stop
            if start >= total:
                break
        return sink.finish()
    except Exception:
        sink.abort()
        raise
