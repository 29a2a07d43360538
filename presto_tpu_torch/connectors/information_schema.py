"""information_schema + system catalogs: engine metadata as tables (the
port of ``presto_tpu/connectors/information_schema.py``).

Analog of the reference's engine-side virtual catalogs
(connector/informationschema/InformationSchemaMetadata.java +
connector/system/* — NodeSystemTable, QuerySystemTable, and the
information_schema page sources). Both connectors reflect the LIVE
engine state on every scan: registering a catalog or running a query is
immediately visible in the next SELECT.
"""

from __future__ import annotations

import weakref

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table
from presto_tpu_torch.connectors.base import Connector, TableStats


def _make_table(schema: dict, rows: list[tuple]) -> Table:
    cols = {}
    for i, (name, dtype) in enumerate(schema.items()):
        vals = [r[i] for r in rows]
        if isinstance(dtype, T.VarcharType):
            cols[name] = np.array(vals, dtype=object)
        else:
            cols[name] = np.asarray(vals, dtype=dtype.physical_dtype)
    return Table.from_numpy(schema, cols)


class _ReflectiveConnector(Connector):
    """Shared plumbing: schemas are static, rows are produced fresh per
    scan from the engine."""

    SCHEMAS: dict[str, dict[str, T.DataType]] = {}

    def __init__(self, engine):
        # weak: the engine holds this connector among its catalogs, and
        # a strong reference back would make every engine a reference
        # cycle whose device copies only the cycle collector frees
        self._engine = weakref.ref(engine)

    @property
    def engine(self):
        return self._engine()

    def table_names(self) -> list[str]:
        return list(self.SCHEMAS)

    def table_schema(self, name: str):
        return self.SCHEMAS[name]

    def table(self, name: str) -> Table:
        return _make_table(self.SCHEMAS[name], self._rows(name))

    def row_count_estimate(self, name: str) -> int:
        return max(len(self._rows(name)), 1)

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self.row_count_estimate(name))

    def _rows(self, name: str) -> list[tuple]:
        raise NotImplementedError


class InformationSchemaConnector(_ReflectiveConnector):
    """Catalog `information_schema` (reference
    connector/informationschema; the 2-part name model plays the role
    of the per-catalog schema)."""

    name = "information_schema"

    SCHEMAS = {
        "schemata": {
            "catalog_name": T.VARCHAR, "schema_name": T.VARCHAR,
        },
        "tables": {
            "table_catalog": T.VARCHAR, "table_schema": T.VARCHAR,
            "table_name": T.VARCHAR, "table_type": T.VARCHAR,
        },
        "columns": {
            "table_catalog": T.VARCHAR, "table_schema": T.VARCHAR,
            "table_name": T.VARCHAR, "column_name": T.VARCHAR,
            "ordinal_position": T.BIGINT, "data_type": T.VARCHAR,
            "is_nullable": T.VARCHAR,
        },
    }

    def _user_catalogs(self):
        return {name: c for name, c in self.engine.catalogs.items()
                if not isinstance(c, _ReflectiveConnector)}

    def _rows(self, name: str) -> list[tuple]:
        if name == "schemata":
            return [(cat, "default")
                    for cat in sorted(self._user_catalogs())]
        if name == "tables":
            return [(cat, "default", t, "BASE TABLE")
                    for cat, conn in sorted(self._user_catalogs().items())
                    for t in sorted(conn.table_names())]
        if name == "columns":
            rows = []
            for cat, conn in sorted(self._user_catalogs().items()):
                for t in sorted(conn.table_names()):
                    for i, (col, dtype) in enumerate(
                            conn.table_schema(t).items()):
                        rows.append((cat, "default", t, col, i + 1,
                                     str(dtype), "YES"))
            return rows
        raise KeyError(name)


class SystemConnector(_ReflectiveConnector):
    """Catalog `system`: runtime tables (reference connector/system —
    NodeSystemTable, QuerySystemTable, the task/optimizer-runtime
    tables of the ``system.runtime`` schema, and a session-properties
    table mirroring the jdbc/metadata ones).

    The stats-backed tables (``tasks``, ``operator_stats``,
    ``plan_divergence``, ``adaptive_decisions``) read the live
    obs/qstats recorders, so a running query's tasks are visible to a
    concurrent ``SELECT * FROM system.tasks``. ``nodes`` lists the
    coordinator and, under a ``ClusterCoordinator``, every registered
    worker's heartbeat-observed state. ``query_history`` reads the
    engine's ``QueryHistory`` (``PRESTO_TPU_HISTORY_DIR``) and
    ``result_cache`` the serving layer's result cache
    (server/serving.py), empty without a coordinator server. The
    device-cost columns of ``operator_stats`` (``flops``, ``hbm_bytes``,
    ``intensity``, ``roofline``) are each program's counted cost
    (``obs/devprof``) split across its operators."""

    name = "system"

    SCHEMAS = {
        "nodes": {
            "node_id": T.VARCHAR, "http_uri": T.VARCHAR,
            "node_version": T.VARCHAR, "coordinator": T.VARCHAR,
            "state": T.VARCHAR, "active_tasks": T.BIGINT,
        },
        "queries": {
            "query_id": T.VARCHAR, "state": T.VARCHAR,
            "user": T.VARCHAR, "query": T.VARCHAR,
            "output_rows": T.BIGINT, "wall_ms": T.BIGINT,
            "error": T.VARCHAR,
        },
        "tasks": {
            "query_id": T.VARCHAR, "stage": T.VARCHAR,
            "task_id": T.VARCHAR, "node": T.VARCHAR,
            "state": T.VARCHAR, "shard": T.BIGINT,
            "input_rows": T.BIGINT, "output_rows": T.BIGINT,
            "exchange_pages": T.BIGINT, "exchange_bytes": T.BIGINT,
            "exchange_bytes_arrow": T.BIGINT,
            "exchange_bytes_npz": T.BIGINT,
            "spooled_pages": T.BIGINT, "programs": T.BIGINT,
            "compiles": T.BIGINT, "cache_hits": T.BIGINT,
            "template_hits": T.BIGINT, "retries": T.BIGINT,
            "compile_ms": T.BIGINT, "execute_ms": T.BIGINT,
            "wall_ms": T.BIGINT, "peak_memory_bytes": T.BIGINT,
        },
        "operator_stats": {
            "query_id": T.VARCHAR, "stage": T.VARCHAR,
            "task_id": T.VARCHAR, "plan_node_id": T.VARCHAR,
            "node_type": T.VARCHAR, "label": T.VARCHAR,
            "input_rows": T.BIGINT, "output_rows": T.BIGINT,
            "output_bytes": T.BIGINT, "est_rows": T.BIGINT,
            # per-operator kernel attribution: which backend:kernel
            # pairs the operator dispatched, and its share of the
            # program's execute wall
            "kernel": T.VARCHAR, "wall_ms": T.BIGINT,
            # device-cost attribution (obs/devprof): the program's
            # operations and device-memory bytes split across its plan
            # nodes, arithmetic intensity (flops/byte) and the roofline
            # ratio
            "flops": T.BIGINT, "hbm_bytes": T.BIGINT,
            "intensity": T.DOUBLE, "roofline": T.DOUBLE,
        },
        "plan_divergence": {
            "query_id": T.VARCHAR, "stage": T.VARCHAR,
            "plan_node_id": T.VARCHAR, "node_type": T.VARCHAR,
            "table_name": T.VARCHAR, "est_rows": T.BIGINT,
            "actual_rows": T.BIGINT, "ratio": T.DOUBLE,
        },
        # mid-query adaptive-execution audit (the cluster tier's
        # adaptive re-planning): every remainder re-plan, per-node strategy flip, capacity
        # re-bucket and speculative re-dispatch, with the est-vs-
        # actual rows that triggered it and the old -> new strategy
        "adaptive_decisions": {
            "query_id": T.VARCHAR, "stage": T.VARCHAR,
            "kind": T.VARCHAR, "node_type": T.VARCHAR,
            "detail": T.VARCHAR, "est_rows": T.BIGINT,
            "actual_rows": T.BIGINT, "old_strategy": T.VARCHAR,
            "new_strategy": T.VARCHAR,
        },
        "query_history": {
            "query_id": T.VARCHAR, "state": T.VARCHAR,
            "user": T.VARCHAR, "query": T.VARCHAR,
            "output_rows": T.BIGINT, "wall_ms": T.BIGINT,
            "create_time": T.DOUBLE, "error": T.VARCHAR,
        },
        "session_properties": {
            "name": T.VARCHAR, "value": T.VARCHAR,
            "default": T.VARCHAR, "type": T.VARCHAR,
            "description": T.VARCHAR,
        },
        # the serving result cache (server/serving.py), entry by
        # entry: which plan fingerprints are cached against which
        # table versions, and how hard each entry is working
        "result_cache": {
            "fingerprint": T.VARCHAR, "tables": T.VARCHAR,
            "rows": T.BIGINT, "bytes": T.BIGINT,
            "hits": T.BIGINT, "age_ms": T.BIGINT,
        },
    }

    def _rows(self, name: str) -> list[tuple]:
        if name == "nodes":
            return self._node_rows()
        if name == "queries":
            return [(e.query_id, e.state, e.user, e.sql,
                     e.output_rows, int(e.elapsed_ms), e.error or "")
                    for e in self.engine.events.history]
        if name == "tasks":
            return self._task_rows()
        if name == "operator_stats":
            return self._operator_rows()
        if name == "plan_divergence":
            from presto_tpu_torch.obs.qstats import DIVERGENCE
            return [(r["query_id"], r["stage"], r["plan_node_id"],
                     r["node_type"], r["table"], r["est_rows"],
                     r["actual_rows"], float(r["ratio"]))
                    for r in DIVERGENCE.records()]
        if name == "adaptive_decisions":
            from presto_tpu_torch.obs.qstats import ADAPTIVE
            return [(r["query_id"], r["stage"], r["kind"],
                     r["node_type"], r["detail"], r["est_rows"],
                     r["actual_rows"], r["old_strategy"],
                     r["new_strategy"])
                    for r in ADAPTIVE.records()]
        if name == "query_history":
            history = getattr(self.engine, "history", None)
            if history is None:
                return []
            return [(str(r.get("query_id") or ""),
                     str(r.get("state") or ""),
                     str(r.get("user") or ""),
                     str(r.get("query") or ""),
                     int(r.get("output_rows") or 0),
                     int(float(r.get("elapsed_ms") or 0)),
                     float(r.get("create_time") or 0.0),
                     str(r.get("error") or ""))
                    for r in history.records()]
        if name == "session_properties":
            from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES
            return [(n, str(self.engine.session.get(n)), str(d),
                     t.__name__, desc)
                    for n, (d, t, desc) in sorted(
                        SYSTEM_SESSION_PROPERTIES.items())]
        if name == "result_cache":
            serving = getattr(self.engine, "_serving_view", None)
            if serving is None:
                return []
            return serving.cache.snapshot()
        raise KeyError(name)

    def _node_rows(self) -> list[tuple]:
        """The coordinator plus every registered worker's
        heartbeat-observed state (alive / draining / dead / joining)
        and active task count."""
        rows = [("coordinator", "local://0", "presto-tpu", "true",
                 "active", 0)]
        cluster = getattr(self.engine, "_cluster_view", None)
        if cluster is None:
            return rows
        for w in list(cluster.workers):
            if w.state == "joining":
                # a joining node has no heartbeat history yet; its
                # decayed failure ratio must not label it dead
                state = "joining"
            elif not w.alive:
                state = "dead"
            elif w.state == "shutting_down":
                state = "draining"
            else:
                state = "active"
            rows.append((w.node_id or w.uri, w.uri, "presto-tpu",
                         "false", state, int(w.active_tasks)))
        return rows

    def _stage_tasks(self):
        """(query_id, stage, task dict) across every tracked query:
        remote stages first, then the coordinator-local stage."""
        from presto_tpu_torch.obs.qstats import STORE
        out = []
        for rec in STORE.recorders():
            snap = rec.snapshot()
            for stage in snap["stages"]:
                for t in stage["tasks"]:
                    out.append((snap["queryId"], stage["stage"], t))
        return out

    def _task_rows(self) -> list[tuple]:
        return [
            (qid, stage, t["taskId"], t["node"], t["state"],
             int(t["shard"]), int(t["inputRows"]),
             int(t["outputRows"]), int(t["exchangePages"]),
             int(t["exchangeBytes"]),
             int((t.get("exchangeBytesByCodec") or {})
                 .get("arrow", 0)),
             int((t.get("exchangeBytesByCodec") or {}).get("npz", 0)),
             int(t["spooledPages"]),
             int(t["programs"]), int(t["compiles"]),
             int(t["cacheHits"]), int(t["templateHits"]),
             int(t["retries"]), int(t["compileMillis"]),
             int(t["executeMillis"]), int(t["wallMillis"]),
             int(t["peakMemoryBytes"]))
            for qid, stage, t in self._stage_tasks()]

    def _operator_rows(self) -> list[tuple]:
        return [
            (qid, stage, t["taskId"], str(op["planNodeId"]),
             op["nodeType"], op["label"], int(op["inputRows"]),
             int(op["outputRows"]), int(op["outputBytes"]),
             int(op["estRows"]), str(op.get("kernel") or ""),
             int(op.get("wallMillis") or 0),
             int(op.get("flops") or 0), int(op.get("hbmBytes") or 0),
             float(op.get("intensity") or 0.0),
             float(op.get("roofline") or 0.0))
            for qid, stage, t in self._stage_tasks()
            for op in t["operators"]]
