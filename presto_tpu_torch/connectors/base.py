"""Connector SPI.

Minimal analog of the reference's connector contract
(spi/connector/ConnectorMetadata.java, ConnectorSplitManager,
ConnectorPageSourceProvider). v1 exposes whole tables as columnar batches;
split-granular streaming arrives with the block-streaming executor.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table


@dataclasses.dataclass
class TableStats:
    """Planner statistics, analog of spi/statistics/TableStatistics."""

    row_count: int
    # per-column distinct-value estimates (used to size hash tables)
    ndv: dict[str, int] = dataclasses.field(default_factory=dict)


class Connector:
    name: str = "connector"

    def table_names(self) -> list[str]:
        raise NotImplementedError

    def table_schema(self, name: str) -> Mapping[str, T.DataType]:
        raise NotImplementedError

    def table(self, name: str) -> Table:
        """Materialise the full table (host-side arrays)."""
        raise NotImplementedError

    def stats(self, name: str) -> TableStats:
        raise NotImplementedError

    def row_count_estimate(self, name: str) -> int:
        """Cheap row-count estimate for join ordering (must not force data
        generation; analog of spi ConnectorMetadata.getTableStatistics)."""
        return self.stats(name).row_count

    def ndv_estimates(self, name: str) -> dict[str, int]:
        """Cheap per-column distinct-value estimates used to size hash
        tables at plan time (must not force data generation; analog of
        the reference tpch connector's shipped column statistics,
        plugin/trino-tpch src/main/resources column stats JSON). Missing
        columns mean unknown."""
        return {}

    def column_range_estimates(
            self, name: str) -> dict[str, tuple[float, float]]:
        """Cheap per-column (min, max) physical-value estimates for
        range-predicate selectivity (must not force data generation;
        analog of spi/statistics ColumnStatistics range). Missing
        columns mean unknown."""
        return {}

    def unique_keys(self, name: str) -> list[tuple[str, ...]]:
        """Column sets known unique (primary keys). Lets the planner pick
        the single-match hash-join fast path (reference JoinNode's
        maySkipOutputDuplicates analog)."""
        return []

    def partitioning(self, name: str) -> tuple[str, ...] | None:
        """Connector-defined partitioning: the column set this table can
        be hash-bucketed on at the source (reference
        spi/connector/ConnectorNodePartitioningProvider +
        TpchBucketFunction). The distributed executor shards such scans
        by key hash instead of by row blocks, so joins/aggregations on
        those keys skip the FIXED_HASH exchange entirely."""
        return None

    def table_version(self, name: str) -> int | None:
        """Monotonic per-table data version for result caching. A
        connector whose tables can change under it must bump the
        version on every write; ``None`` (the default) declares the
        table's contents unversioned, which makes any query touching
        it ineligible for the result cache — stale hits are
        structurally impossible, not merely unlikely (analog of the
        reference's ConnectorMetadata.getTableHandle freshness
        contract used by materialized-view staleness checks)."""
        return None

    def apply_filter(self, name: str, conjuncts) -> str | None:
        """Offer pushable filter conjuncts
        (connectors/expression.ComparisonExpr). A connector that can
        skip provably-irrelevant data returns a DECORATED table name
        resolving to the constrained scan through table()/table_schema;
        None means no pushdown. The engine keeps the full filter above
        the scan, so acceptance is a superset guarantee, never exact
        evaluation (reference ConnectorMetadata.applyFilter +
        spi/expression/ConnectorExpression.java)."""
        return None

    def begin_write(self, name: str,
                    schema: "Mapping[str, T.DataType] | None" = None):
        """Streaming write: returns a PageSink accepting pages and
        committing on finish (reference
        spi/connector/ConnectorPageSink.java:22). ``schema`` set =
        CREATE TABLE AS (table materializes at finish); None = INSERT
        into an existing table. Default adapter buffers pages and
        commits through create_table/insert for connectors without a
        native sink."""
        return _BufferingPageSink(self, name, schema)

    def delete_rows(self, name: str, mask) -> int:
        """Delete rows where mask is true (None = all); returns the
        deleted count. Analog of spi row-level delete
        (ConnectorMetadata beginDelete + DeleteOperator)."""
        raise NotImplementedError(
            f"connector {self.name} does not support DELETE")

    def update_rows(self, name: str, values, valids, mask) -> int:
        """Assign values[col] on rows where mask is true (None = all);
        returns the updated count. Analog of spi UpdateOperator."""
        raise NotImplementedError(
            f"connector {self.name} does not support UPDATE")


class PageSink:
    """Streaming write target (spi/connector/ConnectorPageSink.java:22):
    append pages, then finish() commits atomically and returns the row
    count; abort() discards."""

    def append_page(self, data: "Mapping[str, object]",
                    valid: "Mapping[str, object | None]") -> None:
        raise NotImplementedError

    def finish(self) -> int:
        raise NotImplementedError

    def abort(self) -> None:
        pass


class _BufferingPageSink(PageSink):
    """Default adapter: accumulates pages host-side, commits whole via
    the connector's create_table/insert."""

    def __init__(self, connector: Connector, name: str, schema):
        import numpy as np
        self._np = np
        self.connector = connector
        self.name = name
        self.schema = dict(schema) if schema is not None else None
        self._pages: list = []
        self._rows = 0

    def append_page(self, data, valid) -> None:
        self._pages.append((dict(data), dict(valid)))
        self._rows += len(next(iter(data.values()), []))

    def finish(self) -> int:
        np = self._np
        if not self._pages:
            if self.schema is not None:
                self.connector.create_table(self.name, self.schema,
                                            {}, {})
            return 0
        cols = list(self._pages[0][0])
        if len(self._pages) == 1:
            data = {c: np.asarray(self._pages[0][0][c]) for c in cols}
        else:
            data = {c: np.concatenate(
                [np.asarray(p[0][c]) for p in self._pages])
                for c in cols}
        valid = {}
        for c in cols:
            vs = [p[1].get(c) for p in self._pages]
            if any(v is not None for v in vs):
                valid[c] = np.concatenate([
                    np.asarray(v) if v is not None
                    else np.ones(len(p[0][c]), bool)
                    for v, p in zip(vs, self._pages)])
            else:
                valid[c] = None
        if self.schema is not None:
            self.connector.create_table(self.name, self.schema, data,
                                        valid)
        else:
            self.connector.insert(self.name, data, valid)
        return self._rows
