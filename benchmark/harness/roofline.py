"""Bytes each kernel entry of the port needs, counted from its
arguments alone, and the card's peaks.

Each input byte counts once and each output byte once, from the
launch's shapes and its live row counts: a dead row's values need not
be read, and neither hash-table slots nor capacity padding count, so
the count is the same whichever backend or design implements the
entry. A count that depends on live rows is a device scalar, summed on
the device and read after the window: no host sync inside it.

``BYTES[name](out, *args) -> (host_bytes, device_bytes)``, where
``name`` is a key of ``presto_tpu_torch.kernels.KERNELS``, ``args``
are that entry's arguments and ``out`` what it returned.
"""

from __future__ import annotations

import torch

# published peaks by torch.cuda.get_device_name(): NVIDIA's H100 SXM
# data sheet (80 GB of HBM3 at 3.35 TB/s), at the card's full 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def peak(device_name: str, what: str) -> float | None:
    return PEAKS.get(device_name, {}).get(what)


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _live(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int64)


def segment(out, data, segment_ids, num_segments):
    """agg_sum, agg_max, agg_min: every id read; the values of rows
    whose id is a segment; one result per segment written."""
    k = int(num_segments)
    width = 8 if data.dtype == torch.bool else data.element_size()
    in_range = _live((segment_ids >= 0) & (segment_ids < k))
    return (_size(segment_ids) + k * width,
            in_range * data.element_size())


def join(out, build_hash, build_live, probe_hash, probe_live, capacity,
         max_probes=0):
    """join_lookup: both live masks; the 64-bit hash of each live build
    and probe row; per probe row its build row (int32) and found flag."""
    nb, npr = build_live.shape[0], probe_live.shape[0]
    return (nb + npr + npr * 5,
            8 * (_live(build_live) + _live(probe_live)))


def walk(out, spine_live, walk, growth=1, max_probes=0):
    """multijoin: the spine's mask; each step's build mask and the
    hashes of its live build rows; each probe key's hash (and validity)
    for the rows that reach its step, counted as the spine's live rows
    at the first step and as the rows the walk keeps at later ones (a
    lower bound); per spine row one int32 gather a step and the final
    mask."""
    n = spine_live.shape[0]
    steps = len(walk.build_live)
    fixed = n + n * (4 * steps + 1) + sum(b.shape[0]
                                          for b in walk.build_live)
    first, kept = _live(spine_live), _live(out[1])
    dev = torch.zeros((), dtype=torch.int64, device=spine_live.device)
    for s, blive in enumerate(walk.build_live):
        dev = dev + 8 * walk.build_step.count(s) * _live(blive)
    for step, at in zip(walk.key_step, walk.key_valid_at):
        dev = dev + (first if step == 0 else kept) * (9 if at >= 0 else 8)
    return fixed, dev


def compact(out, live, arrays, capacity):
    """compact: the mask; each live row, up to the capacity, read once
    and written once in every column."""
    row = sum(a.element_size() * (a[0].numel() if a.ndim > 1 else 1)
              for a in arrays.values())
    kept = torch.clamp(_live(live), max=int(capacity))
    return live.shape[0], 2 * row * kept


BYTES = {"agg_sum": segment, "agg_max": segment, "agg_min": segment,
         "join_lookup": join, "multijoin": walk, "compact": compact}
