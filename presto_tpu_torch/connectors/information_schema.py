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

    ``nodes`` (the one coordinator row), ``queries`` (from
    ``engine.events``), ``session_properties``, and ``result_cache``
    and ``query_history`` (empty, as the reference's are with no
    serving view and no history directory) give their rows. ``tasks``,
    ``operator_stats``, ``plan_divergence`` and
    ``adaptive_decisions`` read the reference's runtime-stats
    recorders (``obs/qstats``), which are not in the port yet (ROADMAP
    Queue 1 item 11): they keep their schemas, so DESCRIBE and
    ``information_schema.columns`` show them, but a scan of their rows
    raises ``NotImplementedError`` rather than return an empty table
    the reference would fill."""

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

    # the tables that read obs/qstats's recorders
    QSTATS_TABLES = ("tasks", "operator_stats", "plan_divergence",
                     "adaptive_decisions")

    def _rows(self, name: str) -> list[tuple]:
        if name == "nodes":
            return [("coordinator", "local://0", "presto-tpu", "true",
                     "active", 0)]
        if name == "queries":
            return [(e.query_id, e.state, e.user, e.sql,
                     e.output_rows, int(e.elapsed_ms), e.error or "")
                    for e in self.engine.events.history]
        if name in self.QSTATS_TABLES:
            raise NotImplementedError(
                f"system.runtime.{name} reads the runtime-stats "
                "recorders (obs/qstats), which are not ported to "
                "presto_tpu_torch yet (ROADMAP Queue 1 item 11)")
        if name in ("query_history", "result_cache"):
            # no history directory and no serving view in the port
            return []
        if name == "session_properties":
            from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES
            return [(n, str(self.engine.session.get(n)), str(d),
                     t.__name__, desc)
                    for n, (d, t, desc) in sorted(
                        SYSTEM_SESSION_PROPERTIES.items())]
        raise KeyError(name)
