"""Segmented integer sum, max and min: the CUDA kernels and their
plain versions.

Ports of ``segment_sum_pallas`` (presto_tpu/kernels/segagg.py:68) and
``_cmp_pallas`` (:118, behind ``segment_max_pallas`` and
``segment_min_pallas``); the kernels are ``csrc/segment_sum.cu`` and
``csrc/segment_cmp.cu``, whose headers say what bounds them on the
card and how they are laid out.

Contract (the reference's, pinned by tests/test_segred.py):

- sum: per-segment sum of an integer or bool column wrapping mod
  2^64; a bool column sums as int64; the result keeps the data's
  integer dtype (a wrapping int64 total cast down);
- max/min: per-segment extremum of an integer column (not bool); an
  empty segment holds the dtype's min (max) or max (min);
- segment ids outside ``[0, num_segments)`` drop.

Integer addition mod 2^64, max and min are order-free, so the
kernels' atomics give the reference's bits in any order.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.kernels import build as B
from presto_tpu_torch.ops import segred

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


def vector_span(data, segment_ids) -> tuple[int, int]:
    """The rows the ``segment_sum`` and ``segment_max``/``min`` kernels
    read four at a time:
    (vbeg, nvec) for rows [vbeg, vbeg + 4 * nvec). vbeg skips the rows
    before the first 16-byte boundary of the ids; the data must then be
    aligned at row vbeg to its four-row word (4 * itemsize bytes, at
    most 16), or every row takes scalar loads: (0, 0). A view at an
    offset (a sliced column) thus keeps vector loads when its data and
    ids are offset alike."""
    n = data.shape[0]
    ids_at = segment_ids.data_ptr()
    size = data.element_size()
    if ids_at % 4:
        return 0, 0
    head = (-ids_at % 16) // 4
    if head >= n or (data.data_ptr() + head * size) % min(4 * size, 16):
        return 0, 0
    return head, (n - head) // 4


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
        vbeg, nvec = vector_span(data, segment_ids)
        rc = lib.pt_segment_sum(data.data_ptr(), _DTYPE_CODES[data.dtype],
                                segment_ids.data_ptr(), n, k, vbeg, nvec,
                                out.data_ptr(), B.stream_handle(data.device))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return out.to(_out_dtype(data))


def segment_max_torch(data, segment_ids, num_segments: int):
    """Plain version: ``scatter_reduce_`` (amax) onto the identity."""
    from presto_tpu_torch import kernels as K
    K.note("torch:agg_max")
    return segred.plain_segment_cmp(data, segment_ids, num_segments, True)


def segment_min_torch(data, segment_ids, num_segments: int):
    """Plain version: ``scatter_reduce_`` (amin) onto the identity."""
    from presto_tpu_torch import kernels as K
    K.note("torch:agg_min")
    return segred.plain_segment_cmp(data, segment_ids, num_segments,
                                    False)


def _segment_cmp_cuda(data, segment_ids, num_segments: int,
                      is_max: bool):
    name = "segment_max" if is_max else "segment_min"
    B.require_cuda(name, data=data, segment_ids=segment_ids)
    B.require_dtype(name, "data", data,
                    *[d for d in _DTYPE_CODES if d != torch.bool])
    B.require_dtype(name, "segment_ids", segment_ids, torch.int32)
    if data.ndim != 1 or segment_ids.shape != data.shape:
        raise ValueError(f"{name}: data {tuple(data.shape)} and "
                         f"segment_ids {tuple(segment_ids.shape)} must "
                         "be equal 1-D shapes")
    k = int(num_segments)
    if not 0 <= k < (1 << 31):
        raise ValueError(f"{name}: num_segments {k} out of range")
    from presto_tpu_torch import kernels as K
    K.note("cuda:agg_max" if is_max else "cuda:agg_min")
    # the kernel allocates nothing: the wrapper fills the output with
    # the data dtype's identity, widened like the values (an empty
    # segment keeps it; a live value is never beyond it)
    out = torch.full((k,), segred.identity(data.dtype, is_max),
                     dtype=torch.int64, device=data.device)
    n = data.shape[0]
    if n and k:
        lib = B.LIBRARY.get()
        vbeg, nvec = vector_span(data, segment_ids)
        rc = lib.pt_segment_cmp(data.data_ptr(), _DTYPE_CODES[data.dtype],
                                segment_ids.data_ptr(), n, k,
                                int(is_max), vbeg, nvec, out.data_ptr(),
                                B.stream_handle(data.device))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return out.to(data.dtype)


def segment_max_cuda(data, segment_ids, num_segments: int):
    """The ``segment_max`` kernel on CUDA tensors; the plain version
    for tensors on the CPU."""
    if not data.is_cuda:
        return segment_max_torch(data, segment_ids, num_segments)
    return _segment_cmp_cuda(data, segment_ids, num_segments, True)


def segment_min_cuda(data, segment_ids, num_segments: int):
    """The ``segment_min`` kernel on CUDA tensors; the plain version
    for tensors on the CPU."""
    if not data.is_cuda:
        return segment_min_torch(data, segment_ids, num_segments)
    return _segment_cmp_cuda(data, segment_ids, num_segments, False)
