"""The shape component of a plan template's cache key.

The reference pads every host scan to a pow2 row bucket
(``presto_tpu/templates/shapes.py``) so that an XLA executable, pinned
to its input shapes, serves a table that grows inside its bucket. The
port takes the key rule only: a scan array's row count enters the
program-cache key as its pow2 bucket, so a table that grows inside its
bucket keeps its cache entry and its remembered capacities. The
resident columns are not padded: eager torch reuses nothing by shape,
and padding lineitem at SF10 would add 12% to it.
"""

from __future__ import annotations

from presto_tpu_torch.ops.sizes import next_pow2


def scan_shape_key(scans, bucketing: bool) -> tuple:
    """(symbol, shape, dtype) of every array of every scan input, in
    scan order; with ``bucketing`` each row count (the leading
    dimension, and the table mask's) is its pow2 bucket."""

    def shape(a) -> tuple:
        dims = tuple(a.shape)
        if bucketing and dims:
            dims = (next_pow2(max(dims[0], 1)),) + dims[1:]
        return dims

    return tuple(
        (sym, shape(a), str(a.dtype))
        for scan in scans
        for sym, a in list(scan.arrays.items())
        + ([] if scan.live is None else [("__live__", scan.live)]))
