"""In-memory table connector.

Analog of the reference's plugin/trino-memory (MemoryPagesStore): tables
created/inserted at runtime, stored as host numpy columns plus optional
validity masks (NULL support matches spi Block.isNull).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import (Column, EncodedStrings, Table,
                                    column_from_numpy)
from presto_tpu_torch.connectors.base import Connector, TableStats


class MemoryConnector(Connector):
    name = "memory"

    def __init__(self) -> None:
        self._schemas: dict[str, dict[str, T.DataType]] = {}
        self._data: dict[str, dict[str, np.ndarray]] = {}
        self._valid: dict[str, dict[str, np.ndarray | None]] = {}
        # monotonic per-table write counters backing table_version();
        # bumped by every mutation INCLUDING drop (a re-created table
        # must not resurrect cached results for its predecessor)
        self._versions: dict[str, int] = {}

    def _bump(self, name: str) -> None:
        self._versions[name] = self._versions.get(name, 0) + 1

    def table_version(self, name: str) -> int | None:
        return self._versions.get(name, 0)

    def create_table(
        self, name: str, schema: Mapping[str, T.DataType],
        data: Mapping[str, np.ndarray] | None = None,
        valid: Mapping[str, np.ndarray | None] | None = None,
    ) -> None:
        self._schemas[name] = dict(schema)
        if data is None:
            data = {c: np.empty(0, dtype=object if isinstance(t, T.VarcharType)
                                else t.physical_dtype)
                    for c, t in schema.items()}
        self._data[name] = {c: np.asarray(v, dtype=object if isinstance(
            self._schemas[name][c], T.VarcharType) else None)
            for c, v in data.items()}
        self._valid[name] = {c: (None if valid is None else valid.get(c))
                             for c in schema}
        self._bump(name)

    def insert(self, name: str, data: Mapping[str, np.ndarray],
               valid: Mapping[str, np.ndarray | None] | None = None) -> None:
        for i, c in enumerate(self._schemas[name]):
            new = np.asarray(data[c])
            old_n = len(self._data[name][c])
            self._data[name][c] = np.concatenate(
                [self._data[name][c], new])
            new_valid = None if valid is None else valid.get(c)
            old_valid = self._valid[name].get(c)
            if new_valid is not None or old_valid is not None:
                if old_valid is None:
                    old_valid = np.ones(old_n, dtype=bool)
                if new_valid is None:
                    new_valid = np.ones(len(new), dtype=bool)
                self._valid[name][c] = np.concatenate(
                    [old_valid, new_valid])
        self._bump(name)

    def delete_rows(self, name: str, mask) -> int:
        n = len(next(iter(self._data[name].values()), []))
        if mask is None:
            mask = np.ones(n, dtype=bool)
        keep = ~np.asarray(mask)
        for c in self._schemas[name]:
            self._data[name][c] = self._data[name][c][keep]
            v = self._valid[name].get(c)
            if v is not None:
                self._valid[name][c] = v[keep]
        self._bump(name)
        return int(mask.sum())

    def update_rows(self, name: str, values, valids, mask) -> int:
        n = len(next(iter(self._data[name].values()), []))
        if mask is None:
            mask = np.ones(n, dtype=bool)
        m = np.asarray(mask)
        # new arrays, not writes into the scanned ones: a device copy
        # is keyed by its host array, and a concurrent scan that sees
        # the new version must not find the old contents there
        for c, new in values.items():
            is_str = isinstance(self._schemas[name][c], T.VarcharType)
            arr = self._data[name][c].copy()
            arr[m] = np.asarray(new, dtype=object if is_str else None)[m]
            self._data[name][c] = arr
            nv = None if valids is None else valids.get(c)
            old_v = self._valid[name].get(c)
            if nv is not None or old_v is not None:
                old_v = (np.ones(n, dtype=bool) if old_v is None
                         else old_v.copy())
                new_v = nv if nv is not None else np.ones(n, dtype=bool)
                old_v[m] = np.asarray(new_v)[m]
                self._valid[name][c] = old_v
        self._bump(name)
        return int(m.sum())

    def snapshot(self):
        """Deep copy of the store for transaction rollback
        (transaction.py copy-on-first-write)."""
        return (
            {t: dict(cols) for t, cols in self._schemas.items()},
            {t: {c: np.copy(a) for c, a in cols.items()}
             for t, cols in self._data.items()},
            {t: {c: None if v is None else np.copy(v)
                 for c, v in cols.items()}
             for t, cols in self._valid.items()},
        )

    def restore(self, snap) -> None:
        schemas, data, valid = snap
        touched = set(self._schemas) | set(schemas)
        self._schemas = {t: dict(cols) for t, cols in schemas.items()}
        self._data = {t: dict(cols) for t, cols in data.items()}
        self._valid = {t: dict(cols) for t, cols in valid.items()}
        # counters stay monotonic across rollback: restored contents
        # differ from the post-write state, so the version must move
        for t in touched:
            self._bump(t)

    def drop_table(self, name: str) -> None:
        self._schemas.pop(name, None)
        self._data.pop(name, None)
        self._valid.pop(name, None)
        self._bump(name)

    def table_names(self) -> list[str]:
        return list(self._schemas)

    def table_schema(self, name: str):
        return self._schemas[name]

    def table(self, name: str) -> Table:
        schema = self._schemas[name]
        cols: dict[str, Column] = {}
        n = 0
        for c, dtype in schema.items():
            col = column_from_numpy(dtype, self._data[name][c],
                                    self._valid[name].get(c))
            cols[c] = col
            n = len(col)
        return Table(cols, n)

    def stats(self, name: str) -> TableStats:
        n = len(next(iter(self._data[name].values()))) if self._data[name] else 0
        return TableStats(row_count=n)



def from_host_tables(tables: Mapping[str, Table],
                     connector: MemoryConnector | None = None
                     ) -> MemoryConnector:
    """Register host tables (as taken from any connector: numpy
    columns, and codes plus a sorted dictionary for strings) in a
    memory connector WITHOUT re-encoding, so the port computes over
    the very same arrays and dictionaries as the engine they came
    from. Column types are taken by name (``str(dtype)``), so tables
    of the reference package's type objects come across too."""
    conn = connector or MemoryConnector()
    for name, tbl in tables.items():
        schema = {c: T.parse_type(str(col.dtype))
                  for c, col in tbl.columns.items()}
        conn._schemas[name] = schema
        conn._data[name] = {
            c: (EncodedStrings(np.asarray(col.data), col.dictionary)
                if isinstance(schema[c], T.VarcharType)
                and col.dictionary is not None else np.asarray(col.data))
            for c, col in tbl.columns.items()}
        conn._valid[name] = {
            c: None if col.valid is None else np.asarray(col.valid)
            for c, col in tbl.columns.items()}
        conn._bump(name)
    return conn
