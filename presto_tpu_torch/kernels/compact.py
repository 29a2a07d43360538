"""Stable filter-compaction: the CUDA kernel and its plain version.

Port of ``filter_compact_pallas`` (presto_tpu/kernels/compact.py:84).
The kernel is ``csrc/compact.cu``, whose header says what bounds it on
the card and how the scan replaces the TPU kernel's running count.

Contract (the reference's): ``arrays`` (1-D [n] or 2-D [n, m] columns
of any dtype) compact to ``capacity`` rows keeping the rows where
``live``, in order; live rows past ``capacity`` drop. Rows past the
live count are dead either way (the caller's live mask kills them);
both versions here leave them zero, where the reference's XLA
fallback replicates its last row. The reference's VMEM gate
(``PALLAS_MAX_OUT_BYTES``) is gone: any size that fits in device
memory goes through the kernel.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.kernels import build as B


def _zeros_like_rows(a: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.zeros((capacity,) + tuple(a.shape[1:]), dtype=a.dtype,
                       device=a.device)


def filter_compact_torch(live, arrays: dict, capacity: int) -> dict:
    """Plain version: positions from a cumsum of the mask, then one
    index_copy per column into ``capacity`` rows plus a slot that
    absorbs dead and overflowing rows. No nonzero, so no host sync."""
    from presto_tpu_torch import kernels as K
    K.note("torch:compact")
    cap = int(capacity)
    pos = torch.cumsum(live.to(torch.int64), 0) - 1
    dest = torch.where(live & (pos < cap), pos, torch.full_like(pos, cap))
    out = {}
    for name, a in arrays.items():
        o = _zeros_like_rows(a, cap + 1)
        o.index_copy_(0, dest, a)
        out[name] = o[:cap]
    return out


def filter_compact_cuda(live, arrays: dict, capacity: int) -> dict:
    """The ``filter_compact`` kernel on CUDA tensors; the plain version
    for a mask on the CPU."""
    if not live.is_cuda:
        return filter_compact_torch(live, arrays, capacity)
    from presto_tpu_torch import kernels as K
    name = "filter_compact"
    B.require_cuda(name, live=live, **arrays)
    B.require_dtype(name, "live", live, torch.bool)
    n = live.shape[0]
    cap = int(capacity)
    if live.ndim != 1 or cap < 0:
        raise ValueError(f"{name}: live must be 1-D and capacity >= 0")
    for arg, a in arrays.items():
        if a.ndim not in (1, 2) or a.shape[0] != n:
            raise ValueError(f"{name}: {arg} has shape {tuple(a.shape)}; "
                             f"expected [{n}] or [{n}, m]")
    K.note("cuda:compact")
    out = {arg: _zeros_like_rows(a, cap) for arg, a in arrays.items()}
    if n == 0 or cap == 0 or not arrays:
        return out
    # one descriptor per column: source, destination, bytes per row
    desc = torch.tensor(
        [w for arg, a in arrays.items()
         for w in (a.data_ptr(), out[arg].data_ptr(),
                   a.element_size() * (a.shape[1] if a.ndim == 2 else 1))],
        dtype=torch.int64).to(live.device)
    lib = B.LIBRARY.get()
    ntiles = -(-n // B.LIBRARY.compact_tile_rows)
    counts = torch.empty(ntiles, dtype=torch.int32, device=live.device)
    offsets = torch.empty(ntiles, dtype=torch.int64, device=live.device)
    rc = lib.pt_filter_compact(live.data_ptr(), n, desc.data_ptr(),
                               len(arrays), cap, counts.data_ptr(),
                               offsets.data_ptr(),
                               B.stream_handle(live.device))
    B.check(rc, name)
    B.LAUNCHES.add(name)
    return out
