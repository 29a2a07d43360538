"""Segmented reductions over hash-sorted rows — the port of
``presto_tpu/ops/segscan.py``.

After the grouping sort (ops/hash.SortedGroups) the rows of one group
are contiguous, so a per-group sum is one cumsum plus boundary
gathers; no scatter touches a group table. The reference's order
scans (min/max, arg-extremum, broadcast_last) serve aggregates outside
this slice and are not ported yet.
"""

from __future__ import annotations

import torch


def _bcast(mask, ndim: int):
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def seg_sum(vals, sg):
    """Per-row running segmented sum; the value at a run's last row is
    the run total (integer sums wrap mod 2^64 like the reference)."""
    pref = torch.cumsum(vals, 0, dtype=None if vals.dtype == torch.bool
                        else vals.dtype)
    prev = pref[torch.clamp(sg.start - 1, min=0).to(torch.int64)]
    base = torch.where(_bcast(sg.start > 0, vals.ndim), prev,
                       torch.zeros_like(pref[:1]))
    return pref - base
