"""Segmented reductions over hash-sorted rows — the port of
``presto_tpu/ops/segscan.py``.

After the grouping sort (ops/hash.SortedGroups) the rows of one group
are contiguous, so a per-group sum is one cumsum plus boundary
gathers, and the order states (min/max, arg-extremum) are a
Hillis-Steele doubling scan gated by each row's run start; no scatter
touches a group table.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Runs:
    """Row runs given by each row's run start (the ``start`` field of
    ``ops/hash.SortedGroups``, which every scan here reads)."""

    start: torch.Tensor


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


def seg_scan(combine, leaves, sg):
    """Inclusive segmented scan by doubling: ``combine(prev, cur)``
    merges two tuples of per-row states elementwise. log2(n) rounds;
    round k merges each row with the row k earlier when that row is in
    the same run. Each round holds one shifted copy of every leaf (the
    reference's ``concatenate([leaf[:k], leaf[:-k]])``): rows before k
    take no shifted value, so the copy's head is never read."""
    n = leaves[0].shape[0]
    i = torch.arange(n, dtype=torch.int32, device=leaves[0].device)
    state = tuple(leaves)
    k = 1
    while k < n:
        take = (i - k) >= sg.start
        shifted = tuple(torch.cat([leaf[:k], leaf[:-k]]) for leaf in state)
        merged = combine(shifted, state)
        state = tuple(torch.where(_bcast(take, leaf.ndim), m, leaf)
                      for leaf, m in zip(state, merged))
        del shifted, merged
        k *= 2
    return state


def seg_max(vals, sg):
    return seg_scan(lambda a, b: (torch.maximum(a[0], b[0]),), (vals,),
                    sg)[0]


def seg_min(vals, sg):
    return seg_scan(lambda a, b: (torch.minimum(a[0], b[0]),), (vals,),
                    sg)[0]


def seg_argbest(best, payload, sg, maximize: bool):
    """Segmented arg-extremum carrying payload leaves: at each run's
    last row, ``best`` holds the run extremum and the payloads hold the
    winning row's values (the earliest row wins ties)."""
    def combine(a, b):
        take_prev = a[0] >= b[0] if maximize else a[0] <= b[0]
        return tuple(torch.where(_bcast(take_prev, x.ndim), x, y)
                     for x, y in zip(a, b))
    out = seg_scan(combine, (best,) + tuple(payload), sg)
    return out[0], out[1:]


def broadcast_last(vals, sg):
    """Each run's last-row value on every row of the run (the
    reference's reverse cummin over positions + gather). Each run's
    last position is scattered to its run id instead of a scan (see
    ops/hash._run_starts); dead rows, sorted after every run, take the
    last row as the reference's clipped suffix minimum does."""
    n = vals.shape[0]
    if n == 0:
        return vals
    dev = vals.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    rid = torch.clamp(torch.cumsum(sg.is_new.to(torch.int64), 0) - 1,
                      min=0)
    lastpos = torch.full((n + 1,), n - 1, dtype=torch.int64, device=dev)
    lastpos.scatter_(0, torch.where(sg.is_last, rid,
                                    torch.full_like(rid, n)), i)
    pos = torch.where(sg.live, lastpos[rid], torch.full_like(rid, n - 1))
    return vals[pos]
