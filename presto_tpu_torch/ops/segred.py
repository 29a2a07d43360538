"""Segmented sums for the aggregate fold and merge — the port of
``presto_tpu/ops/segred.py``.

The reference's one-hot MXU limb path answers a TPU-only problem (no
native 64-bit scatter-add on v5e); the card has 64-bit atomics, so it
is not ported. What stays is the contract ``tests/test_segred.py``
pins: an integer or bool column sums per segment wrapping mod 2^64 (a
bool column counts as int64), the result keeps the data's integer
dtype, and segment ids outside ``[0, num_segments)`` drop.

Integer and bool sums go through the ``agg_sum`` kernel entry
(kernels/segagg.py); float sums reassociate, so they stay a plain
``index_add_`` on every backend, as the reference keeps them off its
Pallas kernel.
"""

from __future__ import annotations

import torch


def is_integer_like(dtype: torch.dtype) -> bool:
    return dtype == torch.bool or not (dtype.is_floating_point
                                       or dtype.is_complex)


def segment_sum(data, segment_ids, num_segments: int):
    from presto_tpu_torch import kernels as K
    if data.ndim == 1 and is_integer_like(data.dtype):
        return K.dispatch("agg_sum")(data, segment_ids, num_segments)
    K.note("torch:agg_sum")
    return float_segment_sum(data, segment_ids, num_segments)


def float_segment_sum(data, segment_ids, num_segments: int):
    """Per-segment float sum; out-of-range ids drop."""
    k = int(num_segments)
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < k)
    ids = torch.where(ok, ids, torch.full_like(ids, k))
    out = torch.zeros((k + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    out.index_add_(0, ids, data)
    return out[:k]
