"""Segmented integer sum: the CUDA kernel and its plain version.

Port of ``segment_sum_pallas`` (presto_tpu/kernels/segagg.py:68);
the kernel is ``csrc/segment_sum.cu``, whose header says what bounds
it on the card and how it is laid out.

Contract (the reference's, pinned by tests/test_segred.py): per-segment
sum of an integer or bool column wrapping mod 2^64; a bool column
sums as int64; the result keeps the data's integer dtype (a
wrapping int64 total cast down); segment ids outside
``[0, num_segments)`` drop. Integer addition mod 2^64 is order-free,
so the kernel's atomics give the reference's bits in any order.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.kernels import build as B

_DTYPE_CODES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2,
                torch.int16: 3, torch.int32: 4, torch.int64: 5}


def _out_dtype(data: torch.Tensor) -> torch.dtype:
    return torch.int64 if data.dtype == torch.bool else data.dtype


def segment_sum_torch(data, segment_ids, num_segments: int):
    """Plain version: ``index_add_`` on int64 (wraps mod 2^64), an
    extra slot absorbing out-of-range ids."""
    from presto_tpu_torch import kernels as K
    K.note("torch:agg_sum")
    k = int(num_segments)
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < k)
    ids = torch.where(ok, ids, torch.full_like(ids, k))
    acc = torch.zeros(k + 1, dtype=torch.int64, device=data.device)
    acc.index_add_(0, ids, data.to(torch.int64))
    return acc[:k].to(_out_dtype(data))


def segment_sum_cuda(data, segment_ids, num_segments: int):
    """The ``segment_sum`` kernel on CUDA tensors; the plain version
    for tensors on the CPU."""
    if not data.is_cuda:
        return segment_sum_torch(data, segment_ids, num_segments)
    from presto_tpu_torch import kernels as K
    name = "segment_sum"
    B.require_cuda(name, data=data, segment_ids=segment_ids)
    B.require_dtype(name, "data", data, *_DTYPE_CODES)
    B.require_dtype(name, "segment_ids", segment_ids, torch.int32)
    if data.ndim != 1 or segment_ids.shape != data.shape:
        raise ValueError(f"{name}: data {tuple(data.shape)} and "
                         f"segment_ids {tuple(segment_ids.shape)} must "
                         "be equal 1-D shapes")
    k = int(num_segments)
    if not 0 <= k < (1 << 31):
        raise ValueError(f"{name}: num_segments {k} out of range")
    K.note("cuda:agg_sum")
    out = torch.zeros(k, dtype=torch.int64, device=data.device)
    n = data.shape[0]
    if n and k:
        lib = B.LIBRARY.get()
        rc = lib.pt_segment_sum(data.data_ptr(), _DTYPE_CODES[data.dtype],
                                segment_ids.data_ptr(), n, k,
                                out.data_ptr(), B.stream_handle(data.device))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return out.to(_out_dtype(data))
