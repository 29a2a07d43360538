"""Shard groups: the seam between distributed execution and the
collectives it calls.

The reference traces each plan node's per-shard code once under
``shard_map`` and calls ``jax.lax`` collectives over the mesh axis. In
eager PyTorch there is no ``shard_map``: the sharded interpreter runs
each node once for every shard that this process holds, and calls a
collective of its :class:`ShardGroup` wherever the reference calls
``jax.lax``. Every collective takes a list of one tensor per local
shard (in the order of ``group.local``) and returns one per local
shard:

- ``all_to_all(xs)``: each shard gives ``[nshards, cap, ...]`` (one
  bucket per destination) and gets ``[nshards * cap, ...]``, every
  source's bucket for it in source order (``lax.all_to_all`` with
  split and concat axis 0);
- ``all_gather(xs)``: each shard gets every shard's rows, concatenated
  in shard order (``lax.all_gather`` then a reshape);
- ``all_reduce(xs, op)``: the elementwise sum, min or max over the
  shards (``psum``, ``pmin``, ``pmax``).

Two backends:

- :class:`LocalShardGroup` holds every shard in one process (the
  counterpart of a mesh of N devices in one process, which is what the
  reference's tests run on 8 virtual CPU devices); its collectives are
  ``torch.cat`` and reductions over a stack. A gathered or reduced
  result is one tensor, shared by every local shard.
- :class:`ProcessShardGroup` holds one shard per ``torch.distributed``
  rank; its collectives are ``all_to_all_single``, ``all_gather`` and
  ``all_reduce`` of the process group.

Both count their calls and bytes per kind in :data:`COLLECTIVES`. The
bytes of a call are what the whole group contributes (each shard's
input, summed over the shards), so the two backends count the same
query alike.
"""

from __future__ import annotations

import threading

import torch

REDUCE_OPS = ("sum", "min", "max")


class CollectiveCounts:
    """Collective calls and bytes per kind (all_to_all, all_gather,
    all_reduce)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self.calls.clear()
            self.bytes.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"calls": dict(self.calls), "bytes": dict(self.bytes)}


COLLECTIVES = CollectiveCounts()


class ShardGroup:
    """``nshards`` shards on ``device``; this process holds the shards
    ``local``."""

    nshards: int
    device: torch.device
    local: list[int]

    def _count(self, kind: str, xs: list) -> None:
        local = sum(x.numel() * x.element_size() for x in xs)
        COLLECTIVES.add(kind, local * self.nshards // len(xs))

    def all_to_all(self, xs: list) -> list:
        raise NotImplementedError

    def all_gather(self, xs: list) -> list:
        raise NotImplementedError

    def all_reduce(self, xs: list, op: str) -> list:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.nshards}, "
                f"{str(self.device)!r})")


def _reduce(stacked: torch.Tensor, op: str) -> torch.Tensor:
    if op not in REDUCE_OPS:
        raise ValueError(f"all_reduce op must be one of {REDUCE_OPS}")
    if stacked.dtype == torch.bool:
        if op == "sum":
            raise TypeError("sum over bool shards")
        return stacked.all(0) if op == "min" else stacked.any(0)
    if op == "sum":
        return stacked.sum(0, dtype=stacked.dtype)
    return stacked.amin(0) if op == "min" else stacked.amax(0)


class LocalShardGroup(ShardGroup):
    """Every one of ``nshards`` shards in this process, on ``device``."""

    def __init__(self, nshards: int, device="cuda"):
        if nshards < 1:
            raise ValueError("a shard group needs at least one shard")
        self.nshards = int(nshards)
        self.device = torch.device(device)
        self.local = list(range(self.nshards))

    def all_to_all(self, xs: list) -> list:
        self._count("all_to_all", xs)
        # destination s receives bucket s of every source, in source order
        return [torch.cat([x[s] for x in xs]) for s in range(self.nshards)]

    def all_gather(self, xs: list) -> list:
        self._count("all_gather", xs)
        out = torch.cat(xs)
        return [out] * len(xs)

    def all_reduce(self, xs: list, op: str) -> list:
        self._count("all_reduce", xs)
        out = _reduce(torch.stack(xs), op)
        return [out] * len(xs)


class ProcessShardGroup(ShardGroup):
    """One shard per rank of a ``torch.distributed`` process group: this
    process holds shard ``rank``, on ``device``.

    Tested with the gloo backend on CPU tensors, in several processes.
    NCCL needs a GPU per rank, and no machine this was built on had more
    than one: the NCCL path is untested, and nothing is claimed for it.
    The calls used (``all_to_all_single``, ``all_gather``,
    ``all_reduce``) exist in torch 2.11 and 2.13 alike."""

    def __init__(self, process_group=None, device="cpu"):
        import torch.distributed as dist
        self.pg = process_group
        self.nshards = dist.get_world_size(process_group)
        self.device = torch.device(device)
        self.local = [dist.get_rank(process_group)]

    def all_to_all(self, xs: list) -> list:
        import torch.distributed as dist
        self._count("all_to_all", xs)
        (x,) = xs
        x = x.reshape((-1,) + tuple(x.shape[2:])).contiguous()
        # bools travel as uint8, which every backend moves and reduces
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.pg)
        return [out.to(torch.bool) if x.dtype == torch.bool else out]

    def all_gather(self, xs: list) -> list:
        import torch.distributed as dist
        self._count("all_gather", xs)
        (x,) = xs
        x = x.contiguous()
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(self.nshards)]
        dist.all_gather(parts, wire, group=self.pg)
        out = torch.cat(parts)
        return [out.to(torch.bool) if x.dtype == torch.bool else out]

    def all_reduce(self, xs: list, op: str) -> list:
        import torch.distributed as dist
        if op not in REDUCE_OPS:
            raise ValueError(f"all_reduce op must be one of {REDUCE_OPS}")
        (x,) = xs
        if x.dtype == torch.bool and op == "sum":
            raise TypeError("sum over bool shards")
        self._count("all_reduce", xs)
        wire = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone()
        dist.all_reduce(wire, op={"sum": dist.ReduceOp.SUM,
                                  "min": dist.ReduceOp.MIN,
                                  "max": dist.ReduceOp.MAX}[op],
                        group=self.pg)
        return [wire.to(torch.bool) if x.dtype == torch.bool else wire]
