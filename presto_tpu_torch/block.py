"""Columnar data model: Column and Table.

The analog of the reference's Page/Block
(core/trino-spi/src/main/java/io/trino/spi/Page.java:33,
spi/block/Block.java:25). Differences, chosen for TPU execution:

- Struct-of-arrays: a Table is an ordered map of name -> Column where each
  column's values are one flat device array in HBM.
- Static shapes: instead of compacting after a filter (dynamic output
  cardinality breaks XLA), a Table carries a boolean selection ``mask``.
  Downstream kernels treat masked-off rows as absent. This replaces the
  reference's positions list in PageProcessor
  (operator/project/PageProcessor.java:54).
- Null handling: each Column may carry a ``valid`` bitmap (True = non-null),
  the analog of Block.isNull.
- Strings are dictionary codes (spi/block/DictionaryBlock.java:35 precedent)
  with the **sorted** host-side dictionary, so code order == collation order
  and device-side <, min, max, sort on codes are correct for any single
  dictionary.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Mapping

import numpy as np

from presto_tpu_torch import types as T


@dataclasses.dataclass
class Column:
    dtype: T.DataType
    data: object  # jnp.ndarray | np.ndarray, shape [N] physical values
    valid: object | None = None  # bool[N]; None means all valid
    dictionary: np.ndarray | None = None  # host-side str array for VARCHAR

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def with_data(self, data, valid=...) -> "Column":
        return Column(
            self.dtype,
            data,
            self.valid if valid is ... else valid,
            self.dictionary,
        )


@dataclasses.dataclass
class EncodedStrings:
    """A string column already in (codes, sorted dictionary) form.

    Generators that pick from bounded vocabularies emit this directly so
    large tables skip the O(n log n) object-array re-encode in
    dictionary_encode — the analog of the reference producing
    DictionaryBlocks at the source (spi/block/DictionaryBlock.java:35).
    ``dictionary`` must be lexicographically sorted (code order ==
    collation order, the engine-wide invariant)."""

    codes: np.ndarray  # int32 [n]
    dictionary: np.ndarray  # object [k], sorted

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def __getitem__(self, idx) -> "EncodedStrings":
        return EncodedStrings(self.codes[idx], self.dictionary)

    def decode(self) -> np.ndarray:
        return self.dictionary[self.codes]


def dictionary_encode(values: Iterable[str]) -> tuple[np.ndarray, np.ndarray]:
    """Encode strings to (codes int32, sorted dictionary).

    The dictionary is sorted so that code comparisons implement string
    collation on device.
    """
    arr = np.asarray(values, dtype=object)
    # np.unique on object arrays sorts lexicographically.
    dictionary, codes = np.unique(arr.astype("U"), return_inverse=True)
    return codes.astype(np.int32), dictionary.astype(object)


def column_from_numpy(
    dtype: T.DataType, values: np.ndarray, valid: np.ndarray | None = None
) -> Column:
    """Build a Column from host values. Strings are dictionary-encoded;
    decimals must already be scaled integers."""
    if isinstance(dtype, T.VarcharType):
        if isinstance(values, EncodedStrings):
            return Column(dtype, values.codes, valid, values.dictionary)
        codes, dictionary = dictionary_encode(values)
        return Column(dtype, codes, valid, dictionary)
    return Column(dtype, np.asarray(values, dtype=dtype.physical_dtype), valid)


@dataclasses.dataclass
class Table:
    """An ordered collection of equal-length Columns plus a selection mask.

    ``nrows`` is the physical array length; ``mask`` (bool[nrows] or None)
    selects the live rows. ``None`` means all rows live.
    """

    columns: dict[str, Column]
    nrows: int
    mask: object | None = None

    def column(self, name: str) -> Column:
        return self.columns[name]

    @property
    def names(self) -> list[str]:
        return list(self.columns.keys())

    def with_mask(self, mask) -> "Table":
        return Table(dict(self.columns), self.nrows, mask)

    def select(self, names: list[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.nrows, self.mask)

    @staticmethod
    def from_numpy(
        schema: Mapping[str, T.DataType], data: Mapping[str, np.ndarray]
    ) -> "Table":
        cols = {}
        n = None
        for name, dtype in schema.items():
            col = column_from_numpy(dtype, data[name])
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(f"column {name} length mismatch")
            cols[name] = col
        return Table(cols, n or 0)

    # ---- host-side result extraction -------------------------------------

    def to_pylist(self) -> list[tuple]:
        """Decode live rows to Python tuples (host side, for results/tests).
        Only the live rows are decoded: a result padded to a large
        capacity (an aggregate's table under a TopN) would otherwise pay
        a Python-level decode of every dead row."""
        live = (np.arange(self.nrows) if self.mask is None
                else np.flatnonzero(np.asarray(self.mask)))
        decoded = []
        valids = []
        for col in self.columns.values():
            data = np.asarray(col.data)[live]
            valid = None if col.valid is None else np.asarray(col.valid)[live]
            decoded.append(_decode_column(col.dtype, data, col.dictionary))
            valids.append(valid)
        return [
            tuple(
                None
                if valids[j] is not None and not valids[j][i]
                else decoded[j][i]
                for j in range(len(decoded))
            )
            for i in range(len(live))
        ]


def _decode_column(dtype: T.DataType, data: np.ndarray, dictionary):
    if isinstance(dtype, T.VarcharType):
        if dictionary is None:
            # host-materialized strings (varlen aggregates): already
            # decoded Python objects, no code indirection
            return data
        if not len(dictionary):
            return np.full(len(data), "", object)
        safe = np.clip(data, 0, len(dictionary) - 1)
        out = dictionary[safe]
        # Out-of-range codes (e.g. -1 padding from outer-join fill) -> "".
        out = np.where((data < 0) | (data >= len(dictionary)), "", out)
        return out
    if isinstance(dtype, T.DecimalType):
        if getattr(data, "ndim", 1) == 2:
            # LONG decimal limbs [n, 2] -> exact Python Decimals
            import decimal
            lo = data[:, 0].astype(np.uint64)
            hi = data[:, 1].astype(np.int64)
            out = np.empty(len(data), object)
            with decimal.localcontext() as ctx:
                ctx.prec = 50  # 38 digits + headroom for quantize
                q = decimal.Decimal(10) ** -dtype.scale
                for i in range(len(data)):
                    raw = int(hi[i]) * (1 << 64) + int(lo[i])
                    out[i] = (decimal.Decimal(raw) * q).quantize(q)
            return out
        return data.astype(np.float64) / dtype.unscale_factor
    if isinstance(dtype, T.DateType):
        epoch = np.datetime64("1970-01-01")
        return (epoch + data.astype("timedelta64[D]")).astype("datetime64[D]")
    if isinstance(dtype, T.TimestampType):
        epoch = np.datetime64("1970-01-01", "us")
        return epoch + data.astype("timedelta64[us]")
    if isinstance(dtype, T.TimeType):
        return data.astype("timedelta64[us]")
    if isinstance(dtype, T.BooleanType):
        return data.astype(bool)
    if isinstance(dtype, T.DoubleType):
        return data.astype(np.float64)
    return data


# --- ARRAY column bridging (host object lists <-> padded 2D device) --------


def pad_object_lists(element: T.DataType, data: np.ndarray):
    """Host object array of Python lists -> (data2d, lengths, emask,
    dictionary) in the fixed-capacity device layout (expr/compile.Val).
    NULL rows / NULL elements become dead padding. Vectorized: one pass
    over the flattened elements (the reference's per-element loop gives
    the same arrays)."""
    data = np.asarray(data, dtype=object).reshape(-1)
    n = len(data)
    present = ~np.equal(data, None)
    lens = np.zeros(n, np.int32)
    lens[present] = np.fromiter(map(len, data[present]), np.int64,
                                int(present.sum()))
    cap = max(int(lens.max()) if n else 1, 1)
    total = int(lens.sum())
    flat = np.empty(total, object)
    flat[:] = list(itertools.chain.from_iterable(data[present]))
    ok = ~np.equal(flat, None)
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    emask = np.zeros((n, cap), bool)
    emask[rows, cols] = ok
    if isinstance(element, T.VarcharType):
        vocab, codes = np.unique(flat[ok].astype(str), return_inverse=True)
        d2 = np.zeros((n, cap), np.int32)
        d2[rows[ok], cols[ok]] = codes
        return d2, lens, emask, vocab.astype(object)
    d2 = np.zeros((n, cap), element.physical_dtype)
    if ok.any():
        d2[rows[ok], cols[ok]] = np.asarray(list(flat[ok])).astype(
            element.physical_dtype)
    return d2, lens, emask, None


def lists_from_padded(element: T.DataType, data2d: np.ndarray,
                      lengths: np.ndarray, emask: np.ndarray | None,
                      dictionary) -> np.ndarray:
    """Inverse of pad_object_lists: decode to an object array of
    Python lists (NULL elements as None), one pass over the present
    elements."""
    n, cap = data2d.shape[:2]
    lengths = np.clip(np.asarray(lengths).astype(np.int64), 0, cap)
    within = np.arange(cap)[None, :] < lengths[:, None]
    flat = _decode_column(element, data2d[within], dictionary)
    vals = np.empty(len(flat), object)
    vals[:] = list(flat)
    if emask is not None:
        vals[~np.asarray(emask)[within]] = None
    values = vals.tolist()
    ends = np.cumsum(lengths).tolist()
    out = np.empty(n, object)
    for i, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
        out[i] = values[lo:hi]
    return out
