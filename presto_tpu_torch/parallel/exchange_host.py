"""Host-side hash partitioning for the multi-host exchange.

The cross-WORKER analog of the in-slice ICI repartition kernel
(parallel/exchange.py all_to_all): rows of a worker-local result are
bucketed by key hash into npartitions buffers that peer workers pull
over HTTP — the reference's PagePartitioner + OutputBuffer pair
(operator/PartitionedOutputOperator.java:417, execution/buffer/).
Pure numpy: every worker must bucket identically, and partition ids
must not depend on per-worker dictionary code assignments, so string
keys hash their CONTENT (same rule as ops/hash.hash_string_dictionary).
"""

from __future__ import annotations

import hashlib

import numpy as np

from presto_tpu_torch.block import Column

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        x = ((x ^ (x >> np.uint64(30)))
             * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        x = ((x ^ (x >> np.uint64(27)))
             * np.uint64(0x94D049BB133111EB)) & _MASK
        return x ^ (x >> np.uint64(31))


def _hash_column(col: Column) -> np.ndarray:
    data = np.asarray(col.data)
    if data.ndim == 2:
        # LONG decimal limb pairs [n, 2]: combine both limbs into one
        # row hash (mirrors the device-side _row_hash limb handling)
        lo_ = _splitmix64_np(data[:, 0].astype(np.int64)
                             .view(np.uint64))
        hi_ = _splitmix64_np(data[:, 1].astype(np.int64)
                             .view(np.uint64))
        with np.errstate(over="ignore"):
            h = _splitmix64_np(
                (lo_ * np.uint64(0x100000001B3)) & _MASK ^ hi_)
        if col.valid is not None:
            h = np.where(np.asarray(col.valid), h,
                         np.uint64(0x9E3779B97F4A7C15))
        return h
    if col.dictionary is not None:
        lut = np.empty(max(len(col.dictionary), 1), dtype=np.uint64)
        lut[0] = 0
        for i, s in enumerate(col.dictionary):
            d = hashlib.blake2b(str(s).encode(), digest_size=8).digest()
            lut[i] = np.frombuffer(d, dtype=np.uint64)[0]
        h = lut[np.clip(data, 0, len(lut) - 1)]
    else:
        h = _splitmix64_np(data.astype(np.int64).view(np.uint64))
    if col.valid is not None:
        h = np.where(np.asarray(col.valid), h,
                     np.uint64(0x9E3779B97F4A7C15))
    return h


def partition_ids(cols: dict[str, Column], keys: list[str],
                  nparts: int) -> np.ndarray:
    """Partition id per row from the combined key hash."""
    out = None
    for k in keys:
        h = _hash_column(cols[k])
        if out is None:
            out = h
        else:
            with np.errstate(over="ignore"):
                out = _splitmix64_np(
                    (out * np.uint64(0x100000001B3)) & _MASK ^ h)
    assert out is not None
    return (out % np.uint64(nparts)).astype(np.int64)


def slice_columns(cols: dict[str, Column],
                  mask: np.ndarray) -> dict[str, Column]:
    out = {}
    for name, c in cols.items():
        out[name] = Column(
            c.dtype, np.asarray(c.data)[mask],
            None if c.valid is None else np.asarray(c.valid)[mask],
            c.dictionary)
    return out
