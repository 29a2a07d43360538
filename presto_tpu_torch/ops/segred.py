"""Segmented reductions for the aggregate fold and merge — the port of
``presto_tpu/ops/segred.py``.

The reference's one-hot MXU limb path and its broadcast-compare
min/max answer a TPU-only problem (no native 64-bit scatter on v5e);
the card has 64-bit atomics, so they are not ported. What stays is
the contract ``tests/test_segred.py`` pins:

- sums: an integer or bool column sums per segment wrapping mod 2^64
  (a bool column counts as int64), and the result keeps the data's
  integer dtype;
- max/min: an empty segment holds the dtype's identity (its min for
  max, its max for min; -inf/+inf for floats);
- segment ids outside ``[0, num_segments)`` drop.

A 1-D integer column (bool too, for sums) goes through the kernel
entry (``agg_sum``, ``agg_max``, ``agg_min``: kernels/segagg.py).
Float columns reassociate under a sum and are kept off the kernels on
every backend, as the reference keeps them off its Pallas kernels.
"""

from __future__ import annotations

import torch


def is_integer_like(dtype: torch.dtype) -> bool:
    return dtype == torch.bool or not (dtype.is_floating_point
                                       or dtype.is_complex)


def _drop_ids(segment_ids, k: int):
    """int64 ids with every id outside [0, k) sent to the extra slot k."""
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < k)
    return torch.where(ok, ids, torch.full_like(ids, k))


def segment_sum(data, segment_ids, num_segments: int):
    from presto_tpu_torch import kernels as K
    if data.ndim == 1 and is_integer_like(data.dtype):
        return K.dispatch("agg_sum")(data, segment_ids, num_segments)
    K.note("torch:agg_sum")
    return float_segment_sum(data, segment_ids, num_segments)


def float_segment_sum(data, segment_ids, num_segments: int):
    """Per-segment float sum; out-of-range ids drop."""
    k = int(num_segments)
    ids = _drop_ids(segment_ids, k)
    out = torch.zeros((k + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    out = out.index_add(0, ids, data)
    return out[:k]


def _kernel_cmp(data) -> bool:
    return (data.ndim == 1 and data.dtype != torch.bool
            and is_integer_like(data.dtype))


def segment_max(data, segment_ids, num_segments: int):
    from presto_tpu_torch import kernels as K
    if _kernel_cmp(data):
        return K.dispatch("agg_max")(data, segment_ids, num_segments)
    K.note("torch:agg_max")
    return plain_segment_cmp(data, segment_ids, num_segments, True)


def segment_min(data, segment_ids, num_segments: int):
    from presto_tpu_torch import kernels as K
    if _kernel_cmp(data):
        return K.dispatch("agg_min")(data, segment_ids, num_segments)
    K.note("torch:agg_min")
    return plain_segment_cmp(data, segment_ids, num_segments, False)


def identity(dtype: torch.dtype, is_max: bool):
    """The value an empty segment holds."""
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def plain_segment_cmp(data, segment_ids, num_segments: int,
                      is_max: bool):
    """Per-segment max (or min) of a 1-D column by ``scatter_reduce``
    onto an output filled with the identity, an extra slot absorbing
    out-of-range ids."""
    k = int(num_segments)
    ids = _drop_ids(segment_ids, k)
    out = torch.full((k + 1,), identity(data.dtype, is_max),
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, ids, data, "amax" if is_max else "amin",
                             include_self=True)
    return out[:k]
