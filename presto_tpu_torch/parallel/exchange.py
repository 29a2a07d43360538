"""Exchanges between the shards of a group: the port of
``presto_tpu/parallel/exchange.py``.

Each mirrors one of the reference's distribution modes:

- FIXED_HASH repartition -> bucket rows by partition into fixed-capacity
  per-destination buffers, then ``ShardGroup.all_to_all``;
- FIXED_BROADCAST and GATHER -> ``ShardGroup.all_gather``.

Collectives need equal shapes on every shard, so a repartition keeps
the reference's two-phase contract: rows go into ``[num_parts,
capacity]`` buckets with a validity mask, and a bucket that overflows
clears an ``ok`` flag (min-reduced over the group, the reference's
``pmin``); the executor's retry ladder grows the capacity.

Every function takes and returns one entry per local shard of the
group (``group.local`` order). Trailing axes ride along: a LONG
decimal's limbs ``[n, 2]``, an ARRAY's elements ``[n, cap]``, a
sketch's state.
"""

from __future__ import annotations

import torch


def bucket_by_partition(cols: dict, live, part_id, num_parts: int,
                        capacity: int):
    """Place rows into per-destination buckets of ``capacity`` rows.

    cols: name -> tensor [N, ...]; live: bool [N]; part_id: integer
    [N] in [0, num_parts). Returns (name -> [num_parts, capacity, ...],
    valid bool [num_parts, capacity], ok 0-d bool). A live row of
    partition p with rank r among p's live rows (in row order) lands at
    [p, r] when r < capacity; ``ok`` is false when some partition has
    more live rows than ``capacity``. Unfilled slots hold zeros, as the
    reference's do.

    The reference ranks rows with a cumsum over an [N, P] one-hot; a
    stable sort by partition gives the same ranks without that
    buffer (in int64, P times the rows). Each destination slot then
    gathers its source row."""
    n = part_id.shape[0]
    dev = part_id.device
    pid = torch.clamp(part_id.to(torch.int64), 0, num_parts - 1)
    # dead rows sort after every partition
    key = torch.where(live, pid, torch.full_like(pid, num_parts))
    order = torch.sort(key, stable=True).indices
    bounds = torch.searchsorted(
        key[order].contiguous(),
        torch.arange(num_parts + 1, dtype=torch.int64, device=dev))
    counts = bounds[1:] - bounds[:-1]  # live rows per partition
    ok = torch.all(counts <= capacity)
    r = torch.arange(capacity, dtype=torch.int64, device=dev)
    valid = r[None, :] < counts[:, None]  # [P, cap]
    out = {}
    if n == 0:
        for name, a in cols.items():
            out[name] = torch.zeros((num_parts, capacity) + a.shape[1:],
                                    dtype=a.dtype, device=dev)
        return out, valid, ok
    src = order[torch.clamp(bounds[:-1, None] + r[None, :], 0,
                            n - 1)].reshape(-1)
    for name, a in cols.items():
        g = a.index_select(0, src).reshape((num_parts, capacity)
                                           + a.shape[1:])
        mask = valid.reshape(valid.shape + (1,) * (a.dim() - 1))
        out[name] = g.masked_fill(~mask, 0)
    return out, valid, ok


def all_to_all_exchange(group, bucketed: list[dict], valid: list):
    """Exchange every shard's [P, capacity] buckets so shard p receives
    every shard's bucket p. Returns (per shard: name -> [P*capacity,
    ...], per shard valid [P*capacity])."""
    out: list[dict] = [{} for _ in bucketed]
    for name in bucketed[0]:
        for o, x in zip(out, group.all_to_all([b[name] for b in bucketed])):
            o[name] = x
    return out, group.all_to_all(valid)


def repartition(group, cols: list[dict], live: list, part_id: list,
                num_parts: int, capacity: int):
    """Hash-repartition rows over the group: bucket, then all_to_all.
    Returns (per shard cols [num_parts*capacity], per shard valid, per
    shard ok: false on every shard when any shard's bucket
    overflowed)."""
    parts = [bucket_by_partition(c, lv, p, num_parts, capacity)
             for c, lv, p in zip(cols, live, part_id)]
    ex, valid = all_to_all_exchange(group, [b for b, _v, _o in parts],
                                    [v for _b, v, _o in parts])
    ok = group.all_reduce([o.to(torch.int32) for _b, _v, o in parts],
                          "min")
    return ex, valid, [o > 0 for o in ok]


def broadcast_gather(group, cols: list[dict], live: list):
    """FIXED_BROADCAST / GATHER: every shard's rows to every shard.
    Returns (cols name -> [nshards*N, ...], valid [nshards*N]), held
    once: the gathered tensors are the same on every local shard."""
    out = {name: group.all_gather([c[name] for c in cols])[0]
           for name in cols[0]}
    return out, group.all_gather(list(live))[0]
