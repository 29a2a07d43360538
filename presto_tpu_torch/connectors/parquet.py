"""Parquet catalog: tables backed by .parquet files on disk — the
engine's first non-synthetic data source (reference lib/trino-parquet
feeding the hive connector's page source; here the from-scratch reader
in formats/parquet.py feeds device columns through the standard
connector SPI).

Layout: a directory where each table is either ``<name>.parquet`` or a
subdirectory ``<name>/`` of part files (concatenated in sorted order —
the multi-file table layout hive-style writers produce).

The port of ``presto_tpu/connectors/parquet.py``. Its tables stay on the
host; a scan uploads their columns through ``exec/hostsync.upload`` as
it uploads every connector's. Planner statistics are the footers' row
counts alone, as the reference's: a file declares no keys.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.block import Column, Table, column_from_numpy
from presto_tpu_torch.connectors.base import Connector, TableStats
from presto_tpu_torch.formats.parquet import ParquetFile


class ParquetConnector(Connector):
    name = "parquet"

    def __init__(self, directory: str):
        self.directory = directory
        self._tables: dict[str, Table] = {}  # base-name tables
        # constrained ('#rg:' decorated) materializations, bounded:
        # every new filter constant mints a new token
        self._constrained: dict[str, Table] = {}
        self._pf_cache: dict[str, ParquetFile] = {}
        self._files: dict[str, list[str]] = {}
        for entry in sorted(os.listdir(directory)):
            full = os.path.join(directory, entry)
            if entry.endswith(".parquet") and os.path.isfile(full):
                self._files[entry[:-len(".parquet")]] = [full]
            elif os.path.isdir(full):
                parts = sorted(
                    os.path.join(full, f) for f in os.listdir(full)
                    if f.endswith(".parquet"))
                if parts:
                    self._files[entry] = parts

    def table_names(self) -> list[str]:
        return sorted(self._files)

    # decorated names: "<table>#rg:<file>=<g0>,<g1>;..." select a
    # row-group subset chosen by apply_filter (reference applyFilter
    # returning a constrained ConnectorTableHandle)
    @staticmethod
    def _parse_name(name: str):
        if "#rg:" not in name:
            return name, None
        base, spec = name.split("#rg:", 1)
        keep: dict[int, list[int]] = {}
        for part in spec.split(";"):
            if not part:
                continue
            fi, gs = part.split("=")
            keep[int(fi)] = ([int(g) for g in gs.split(",")]
                             if gs else [])
        return base, keep

    def _meta(self, name: str) -> list[ParquetFile]:
        base, _keep = self._parse_name(name)
        if base not in self._files:
            raise KeyError(f"no parquet table {base}")
        out = []
        for path in self._files[base]:
            pf = self._pf_cache.get(path)
            if pf is None:
                pf = self._pf_cache[path] = ParquetFile(path)
            out.append(pf)
        return out

    def apply_filter(self, name: str, conjuncts) -> str | None:
        """Row-group pruning from footer min/max statistics: keep only
        groups whose [min, max] can intersect every conjunct
        (reference parquet TupleDomainParquetPredicate +
        ConnectorMetadata.applyFilter). Returns a decorated table name,
        or None when nothing prunes."""
        from presto_tpu_torch.connectors.expression import ComparisonExpr

        base, _ = self._parse_name(name)
        files = self._meta(base)
        spec_parts = []
        pruned_any = False
        for fi, f in enumerate(files):
            ngroups = len(f.row_groups)
            keep = list(range(ngroups))
            stats_cache: dict[str, list] = {}
            for c in conjuncts:
                if not isinstance(c, ComparisonExpr):
                    continue
                v = c.constant.value
                if not isinstance(v, (int, float)):
                    continue
                col = c.column.column
                if col not in stats_cache:
                    try:
                        stats_cache[col] = f.column_stats(col)
                    except Exception:
                        stats_cache[col] = [None] * ngroups
                stats = stats_cache[col]
                kept = []
                for g in keep:
                    st = stats[g]
                    if st is None:
                        kept.append(g)
                        continue
                    mn, mx = st
                    ok = {"=": mn <= v <= mx, "<>": True,
                          "<": mn < v, "<=": mn <= v,
                          ">": mx > v, ">=": mx >= v}[c.op]
                    if ok:
                        kept.append(g)
                keep = kept
            if not keep and ngroups:
                # keep one group so the scan keeps a static shape; the
                # engine's filter above the scan drops its rows
                keep = [0]
            if len(keep) < ngroups:
                pruned_any = True
            spec_parts.append(
                f"{fi}=" + ",".join(str(g) for g in keep))
        if not pruned_any:
            return None
        return f"{base}#rg:" + ";".join(spec_parts)

    def table_schema(self, name: str) -> Mapping[str, T.DataType]:
        return self._meta(name)[0].schema()

    def row_count_estimate(self, name: str) -> int:
        # footers only — no data pages decode
        base, keep = self._parse_name(name)
        files = self._meta(base)
        if keep is None:
            return max(1, sum(f.num_rows for f in files))
        total = 0
        for fi, f in enumerate(files):
            for g in keep.get(fi, range(len(f.row_groups))):
                total += int(f.row_groups[g][3])
        return max(1, total)

    def stats(self, name: str) -> TableStats:
        return TableStats(row_count=self.row_count_estimate(name))

    def table(self, name: str) -> Table:
        cached = (self._tables.get(name)
                  or self._constrained.get(name))
        if cached is not None:
            return cached
        base, keep = self._parse_name(name)
        files = self._meta(base)
        schema = files[0].schema()
        cols: dict[str, Column] = {}
        for cname, dtype in schema.items():
            if isinstance(dtype, T.VarcharType):
                cols[cname] = _string_column(
                    dtype, [f.read_strings(
                        cname, None if keep is None else keep.get(fi))
                        for fi, f in enumerate(files)])
                continue
            vals_parts = []
            valid_parts = []
            any_null = False
            for fi, f in enumerate(files):
                v, ok = f.read_column(
                    cname, None if keep is None else keep.get(fi))
                vals_parts.append(v)
                valid_parts.append(
                    ok if ok is not None else np.ones(len(v), bool))
                any_null = any_null or ok is not None
            if len(vals_parts) == 1:
                vals = vals_parts[0]
            elif vals_parts and vals_parts[0].ndim == 2:
                vals = np.vstack(vals_parts)
            else:
                vals = np.concatenate(vals_parts)
            valid = (np.concatenate(valid_parts) if any_null else None)
            if isinstance(dtype, T.DecimalType) and dtype.is_long:
                cols[cname] = Column(dtype, vals, valid)
            else:
                cols[cname] = column_from_numpy(dtype, vals, valid)
        nrows = len(next(iter(cols.values())).data) if cols else 0
        tbl = Table(cols, nrows)
        if keep is None:
            self._tables[name] = tbl
        else:
            if len(self._constrained) >= 4:
                self._constrained.pop(next(iter(self._constrained)))
            self._constrained[name] = tbl
        return tbl


def _string_column(dtype: T.DataType, parts) -> Column:
    """A VARCHAR column from each file's ``ParquetFile.read_strings``:
    the codes and sorted dictionary that ``block.dictionary_encode``
    makes of the rows' values, with each row's value (a null row's
    ``None`` or ``b""`` fill included) read through the files'
    dictionaries rather than converted row by row."""
    dicts, codes, valids = [], [], []
    offset = 0
    for dictionary, c, valid in parts:
        dicts.append(np.asarray(dictionary, object))
        codes.append(np.where(c >= 0, c + offset, c))
        valids.append(valid if valid is not None
                      else np.ones(len(c), bool))
        offset += len(dictionary)
    # a null row's two fills (codes -2 and -1), then every file's
    # dictionary
    values = np.concatenate([np.array([b"", None], object)] + dicts)
    rows = np.concatenate(codes) + 2
    uniq, inverse = np.unique(values.astype("U"), return_inverse=True)
    inverse = inverse.reshape(-1)
    used = np.zeros(len(uniq), bool)
    used[inverse[rows]] = True
    remap = np.cumsum(used) - 1
    valid = np.concatenate(valids) if valids else None
    return Column(dtype, remap[inverse[rows]].astype(np.int32),
                  None if valid is None or valid.all() else valid,
                  uniq[used].astype(object))
