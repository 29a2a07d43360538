"""The system under test: the generated arrays handed to
``presto_tpu_torch`` through a connector of the benchmark's own, and
the port's engine over it.

:class:`ArrayConnector` declares what the port's ``TpchConnector`` and
``TpcdsConnector`` declare (primary keys, partitioning, a version for
read-only tables) and gives the planner the row counts, distinct
counts and ranges an ``ANALYZE`` would, computed from the arrays.
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import torch

from presto_tpu_torch import Engine
from presto_tpu_torch import types as T
from presto_tpu_torch.block import EncodedStrings, Table
from presto_tpu_torch.connectors.base import Connector, TableStats


def sql_type(name: str) -> T.DataType:
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", name)
    if m:
        return T.DecimalType(int(m.group(1)), int(m.group(2)))
    return {"bigint": T.BIGINT, "varchar": T.VARCHAR, "date": T.DATE}[name]


def generate(config: dict, seed: int) -> tuple[dict, object]:
    """Every table of ``config`` from ``seed``: ({table: {column:
    array}}, the generator module). The configuration names its
    generator: the class ``generator`` of ``datagen/<suite>.py``."""
    gen = importlib.import_module(f"datagen.{config['suite']}")
    data = getattr(gen, config["generator"])(config, int(seed) % (1 << 63))
    return data.tables(), gen


class ArrayConnector(Connector):
    """Read-only tables over host arrays."""

    def __init__(self, name: str, gen, data: dict, device, version):
        self.name = name
        self._schemas = {t: {c: sql_type(gen.SCHEMAS[t][c]) for c in cols}
                         for t, cols in data.items()}
        self._data = data
        self._keys = gen.UNIQUE_KEYS
        self._parts = gen.PARTITIONING
        self._version = version
        self._tables: dict[str, Table] = {}
        self._rows = {t: len(next(iter(cols.values())))
                      for t, cols in data.items()}
        self._ndv: dict = {}
        self._range: dict = {}
        for t, cols in data.items():
            self._ndv[t], self._range[t] = {}, {}
            for c, a in cols.items():
                ndv, lo, hi = _analyze(a, device)
                self._ndv[t][c] = ndv
                if not hasattr(a, "codes"):
                    self._range[t][c] = (lo, hi)

    def table_names(self) -> list[str]:
        return list(self._data)

    def table_schema(self, name: str):
        return self._schemas[name]

    def table(self, name: str) -> Table:
        if name not in self._tables:
            self._tables[name] = Table.from_numpy(self._schemas[name], {
                c: EncodedStrings(a.codes, a.dictionary)
                if hasattr(a, "codes") else a
                for c, a in self._data[name].items()})
        return self._tables[name]

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self._rows[name],
                          ndv=dict(self._ndv[name]))

    def row_count_estimate(self, name: str) -> int:
        return self._rows[name]

    def ndv_estimates(self, name: str) -> dict[str, int]:
        return dict(self._ndv[name])

    def column_range_estimates(self, name: str):
        return dict(self._range[name])

    def unique_keys(self, name: str) -> list[tuple[str, ...]]:
        have = self._data[name]
        return [k for k in self._keys.get(name, [])
                if all(c in have for c in k)]

    def partitioning(self, name: str):
        part = self._parts.get(name)
        return part if part and all(c in self._data[name]
                                    for c in part) else None

    def table_version(self, name: str):
        return self._version


def _analyze(a, device) -> tuple[int, int, int]:
    """(distinct values, min, max) of a column (a string column's
    codes), computed on ``device``."""
    codes = getattr(a, "codes", a)
    if len(codes) == 0:
        return 0, 0, 0
    t = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
    return (int(torch.unique(t).numel()), int(t.min()), int(t.max()))


def engine(config: dict, data: dict, gen, device=None) -> Engine:
    """The port's engine over the arrays, its catalog the default. The
    tables' version is the configuration's ``table_version``: what the
    port's own connector of the suite declares (0, or None for none)."""
    eng = Engine(device=device)
    conn = ArrayConnector(config["catalog"], gen, data, eng.device,
                          config["table_version"])
    eng.register_catalog(config["catalog"], conn)
    eng.session.catalog = config["catalog"]
    return eng
