"""Row-range split view over another connector.

The multi-host analog of connector splits (split/SplitManager.java,
plugin/trino-tpch/.../TpchSplitManager.java:55 — dsdgen generates each
split's row range independently): a worker assigned split (shard,
nshards) sees every table of the base catalog restricted to its
contiguous row range, so workers scan disjoint row ranges of the same
deterministic tables without any coordinator data movement.
"""

from __future__ import annotations

import numpy as np

from presto_tpu_torch.block import Column, Table
from presto_tpu_torch.connectors.base import Connector, TableStats


class SplitConnector(Connector):
    name = "split"

    def __init__(self, base: Connector, shard: int, nshards: int):
        assert 0 <= shard < nshards
        self.base = base
        self.shard = shard
        self.nshards = nshards

    def _range(self, name: str, n: int) -> tuple[int, int]:
        per = -(-n // self.nshards)
        return min(self.shard * per, n), min((self.shard + 1) * per, n)

    def table_names(self) -> list[str]:
        return self.base.table_names()

    def table_schema(self, name: str):
        return self.base.table_schema(name)

    def table(self, name: str) -> Table:
        t = self.base.table(name)
        lo, hi = self._range(name, t.nrows)
        cols = {}
        for c, col in t.columns.items():
            cols[c] = Column(
                col.dtype, np.asarray(col.data)[lo:hi],
                None if col.valid is None
                else np.asarray(col.valid)[lo:hi],
                col.dictionary)
        # base tables carry no selection mask (connector contract)
        return Table(cols, hi - lo, None)

    def row_count_estimate(self, name: str) -> int:
        return max(1, self.base.row_count_estimate(name) // self.nshards)

    def ndv_estimates(self, name: str) -> dict[str, int]:
        return self.base.ndv_estimates(name)

    def unique_keys(self, name: str):
        return self.base.unique_keys(name)

    def column_range_estimates(self, name: str):
        # value ranges survive row splitting; without this forwarding
        # the dense-key join annotation (plan/dense.py) silently
        # disappears on workers
        return self.base.column_range_estimates(name)

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self.row_count_estimate(name))
