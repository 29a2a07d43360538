"""Blackhole connector: /dev/null tables with synthetic scans (a copy
of ``presto_tpu/connectors/blackhole.py`` with its imports rewritten).

Analog of the reference's plugin/trino-blackhole (BlackHoleMetadata /
BlackHolePageSourceProvider): writes are accepted and discarded; scans
produce a configurable number of synthetic constant rows — used to
exercise writer paths and scan scheduling without storing data.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Table
from presto_tpu_torch.connectors.base import Connector, TableStats


class BlackholeConnector(Connector):
    name = "blackhole"

    def __init__(self, rows_per_table: int = 0,
                 page_processing_delay_s: float = 0.0):
        self.rows_per_table = rows_per_table
        # synthetic scan latency (reference pageProcessingDelay) —
        # makes deterministic slow queries for scheduler/admission tests
        self.page_processing_delay_s = page_processing_delay_s
        self._schemas: dict[str, dict[str, T.DataType]] = {}
        self._rows: dict[str, int] = {}
        self.rows_written: dict[str, int] = {}

    def create_table(self, name: str, schema: Mapping[str, T.DataType],
                     data=None, valid=None) -> None:
        self._schemas[name] = dict(schema)
        self.rows_written[name] = 0
        if data is not None:  # CTAS: row count recorded, data dropped
            n = len(next(iter(data.values()), []))
            self.rows_written[name] = n

    def set_split_count(self, name: str, rows: int) -> None:
        """Configure the synthetic row count a scan of ``name`` yields
        (the reference configures rows_per_page x pages_per_split)."""
        self._rows[name] = rows

    def insert(self, name: str, data, valid=None) -> None:
        self.rows_written[name] += len(next(iter(data.values()), []))

    def drop_table(self, name: str) -> None:
        self._schemas.pop(name, None)
        self._rows.pop(name, None)
        self.rows_written.pop(name, None)

    def delete_rows(self, name: str, mask) -> int:
        return 0  # nothing stored, nothing deleted

    def table_names(self) -> list[str]:
        return list(self._schemas)

    def table_schema(self, name: str):
        return self._schemas[name]

    def table(self, name: str) -> Table:
        if self.page_processing_delay_s:
            import time
            from presto_tpu_torch.exec.cancel import checkpoint
            # sleep in slices so a cancel lands mid-delay (the scan is
            # the cancellation seam, like Driver yield quanta)
            deadline = time.monotonic() + self.page_processing_delay_s
            while time.monotonic() < deadline:
                checkpoint()
                time.sleep(min(0.05, max(deadline - time.monotonic(), 0)))
            checkpoint()
        schema = self._schemas[name]
        n = self._rows.get(name, self.rows_per_table)
        cols = {}
        for c, dtype in schema.items():
            if isinstance(dtype, T.VarcharType):
                cols[c] = np.full(n, "", dtype=object)
            else:
                cols[c] = np.zeros(n, dtype=dtype.physical_dtype)
        return Table.from_numpy(schema, cols)

    def row_count_estimate(self, name: str) -> int:
        return max(self._rows.get(name, self.rows_per_table), 1)

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self.row_count_estimate(name))
