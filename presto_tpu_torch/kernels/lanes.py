"""The kernels' lane axis: every kernel entry callable under
``torch.func.vmap``.

A cross-query batch (``exec/batch.py``) runs one interpreter pass under
``torch.func.vmap`` over K stacked parameter vectors, as the reference
runs ``jax.vmap`` over its traced program; each Pallas kernel there
runs under JAX's batching rule, one launch for all K lanes. Here each
kernel entry is a ``torch.library.custom_op`` whose ``register_vmap``
rule folds the lane into what the kernel already keys on and calls the
kernel ONCE for all lanes, on the CUDA kernel or its plain version
alike (so the CPU tests hold the folding):

- ``segment_sum`` / ``segment_max`` / ``segment_min``: lane ``l``'s
  segment ``s`` is segment ``l * k + s`` of ``K * k`` (ids outside
  ``[0, k)`` still drop);
- ``join_lookup`` (``build_table`` + ``probe_table``): the lane is one
  more key of the row hash (``ops/hash.combine_hashes``, which keeps
  the EMPTY sentinel out), over a table of ``K * capacity`` slots; the
  build rows come back lane-local;
- ``multijoin``: the lane is one more key of every step, on the spine
  and on each build, so the walk runs once over ``K * width`` spine
  rows; a step that already has the walk kernel's most keys raises;
- ``compact``: each lane's rows are followed by ``capacity`` filler
  rows, of which lane ``l`` keeps ``capacity - live_l`` live, so one
  stable compaction into ``K * capacity`` rows puts each lane's live
  rows at the front of its own ``capacity`` rows, zeros after. A lane
  that overflows shifts the lanes after it; its ok flag is False then,
  and the capacity ladder runs the batch again.

Outside vmap the entries call the implementation directly: the serial
route launches exactly as it did. The ok flags come back unbatched (a
table shared by the lanes overflows for all of them).
"""

from __future__ import annotations

import torch
from torch import Tensor

from presto_tpu_torch.ops import hash as H

_NS = "presto_tpu_torch"


def _impl(name: str, backend: str):
    from presto_tpu_torch import kernels as K
    return lambda *args: K.run(name, backend, *args)


def _lanes(t: Tensor, dim, k: int) -> Tensor:
    """``t`` with its lane axis first, K wide (an unbatched tensor is
    repeated for every lane)."""
    if dim is None:
        return t.unsqueeze(0).expand((k,) + tuple(t.shape))
    return t.movedim(dim, 0)


def _flat(t: Tensor) -> Tensor:
    """Lanes folded into rows: [K, n, ...] -> [K * n, ...]."""
    return t.reshape((-1,) + tuple(t.shape[2:])).contiguous()


def _lane_ids(k: int, n: int, device) -> Tensor:
    """The lane of each folded row, [K, n]."""
    return torch.arange(k, device=device).unsqueeze(1).expand(k, n)


def _lane_key(k: int, n: int, device) -> Tensor:
    """The lane as a hash key column (ops/hash.hash_int_column), [K, n]."""
    return H.hash_int_column(_lane_ids(k, n, device))


# --- segment sum, max and min ---------------------------------------------


def _fold_segments(ids: Tensor, k: int) -> Tensor:
    """[K, n] segment ids -> folded int32 ids of K * k segments; an id
    outside [0, k) stays outside."""
    lanes = ids.shape[0]
    if lanes * k >= (1 << 31):
        raise ValueError(f"{lanes} lanes x {k} segments exceed the "
                         "kernels' int32 segment ids")
    ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < k)
    lane = _lane_ids(lanes, ids.shape[1], ids.device)
    return torch.where(ok, ids + lane * k,
                       torch.full_like(ids, -1)).to(torch.int32)


def _segment_out_dtype(data: Tensor) -> torch.dtype:
    return torch.int64 if data.dtype == torch.bool else data.dtype


def _segment_op(name: str, kernel: str):
    @torch.library.custom_op(f"{_NS}::{name}", mutates_args=())
    def op(data: Tensor, segment_ids: Tensor, num_segments: int,
           backend: str) -> Tensor:
        return _impl(kernel, backend)(data, segment_ids, num_segments)

    @op.register_fake
    def _(data, segment_ids, num_segments, backend):
        return data.new_empty((num_segments,),
                              dtype=_segment_out_dtype(data))

    @op.register_vmap
    def _(info, in_dims, data, segment_ids, num_segments, backend):
        lanes = info.batch_size
        data = _lanes(data, in_dims[0], lanes)
        ids = _fold_segments(_lanes(segment_ids, in_dims[1], lanes),
                             int(num_segments))
        out = op(_flat(data), _flat(ids), lanes * int(num_segments),
                 backend)
        return out.reshape(lanes, int(num_segments)), 0

    return op


segment_sum = _segment_op("segment_sum", "agg_sum")
segment_max = _segment_op("segment_max", "agg_max")
segment_min = _segment_op("segment_min", "agg_min")


# --- join lookup ------------------------------------------------------------


@torch.library.custom_op(f"{_NS}::join_lookup", mutates_args=())
def _join_lookup(build_hash: Tensor, build_live: Tensor, probe_hash: Tensor,
                 probe_live: Tensor, capacity: int, max_probes: int,
                 backend: str) -> tuple[Tensor, Tensor, Tensor]:
    row, found, ok = _impl("join_lookup", backend)(
        build_hash, build_live, probe_hash, probe_live, capacity,
        max_probes)
    return row.to(torch.int32), found, ok.reshape(())


@_join_lookup.register_fake
def _(build_hash, build_live, probe_hash, probe_live, capacity,
      max_probes, backend):
    n = probe_hash.shape[0]
    return (probe_hash.new_empty((n,), dtype=torch.int32),
            probe_hash.new_empty((n,), dtype=torch.bool),
            probe_hash.new_empty((), dtype=torch.bool))


@_join_lookup.register_vmap
def _(info, in_dims, build_hash, build_live, probe_hash, probe_live,
      capacity, max_probes, backend):
    lanes = info.batch_size
    bh, bl, ph, pl = (_lanes(t, d, lanes) for t, d in zip(
        (build_hash, build_live, probe_hash, probe_live), in_dims))
    nb, npr = bh.shape[1], ph.shape[1]
    bh = H.combine_hashes([bh, _lane_key(lanes, nb, bh.device)])
    ph = H.combine_hashes([ph, _lane_key(lanes, npr, ph.device)])
    row, found, ok = _join_lookup(_flat(bh), _flat(bl), _flat(ph),
                                  _flat(pl), lanes * int(capacity),
                                  max_probes, backend)
    row = row.reshape(lanes, npr).to(torch.int64)
    local = row - _lane_ids(lanes, npr, row.device) * nb
    row = torch.where(row >= 0, local, row).to(torch.int32)
    return (row, found.reshape(lanes, npr), ok), (0, 0, None)


def join_lookup(build_hash, build_live, probe_hash, probe_live,
                capacity: int, max_probes: int | None = None, *,
                backend: str):
    from presto_tpu_torch.kernels.hashjoin import MAX_PROBES
    return _join_lookup(build_hash, build_live, probe_hash, probe_live,
                        int(capacity), int(max_probes or MAX_PROBES),
                        backend)


# --- compaction -------------------------------------------------------------


@torch.library.custom_op(f"{_NS}::compact", mutates_args=())
def _compact(live: Tensor, arrays: list[Tensor], capacity: int,
             backend: str) -> list[Tensor]:
    out = _impl("compact", backend)(
        live, {str(i): a for i, a in enumerate(arrays)}, capacity)
    return [out[str(i)] for i in range(len(arrays))]


@_compact.register_fake
def _(live, arrays, capacity, backend):
    return [a.new_empty((capacity,) + tuple(a.shape[1:])) for a in arrays]


@_compact.register_vmap
def _(info, in_dims, live, arrays, capacity, backend):
    lanes = info.batch_size
    cap = int(capacity)
    live = _lanes(live, in_dims[0], lanes)
    arrays = [_lanes(a, d, lanes) for a, d in zip(arrays, in_dims[1])]
    # the filler rows: lane l keeps cap - live_l of its cap live, so
    # every lane that fits fills exactly cap output rows
    count = torch.clamp(live.to(torch.int64).sum(1), max=cap)
    filler = (torch.arange(cap, device=live.device).unsqueeze(0)
              < (cap - count).unsqueeze(1))
    live = torch.cat([live, filler], 1)
    arrays = [torch.cat([a, a.new_zeros((lanes, cap) + tuple(a.shape[2:]))],
                        1) for a in arrays]
    out = _compact(_flat(live), [_flat(a) for a in arrays], lanes * cap,
                   backend)
    return ([o.reshape((lanes, cap) + tuple(o.shape[1:])) for o in out],
            [0] * len(out))


def compact(live, arrays: dict, capacity: int, *, backend: str) -> dict:
    names = list(arrays)
    out = _compact(live, [arrays[n] for n in names], int(capacity),
                   backend)
    return dict(zip(names, out))


# --- the MultiJoin walk -----------------------------------------------------


@torch.library.custom_op(f"{_NS}::multijoin", mutates_args=())
def _multijoin(spine_live: Tensor, build_live: list[Tensor],
               build_hash: list[Tensor], build_step: list[int],
               key_hash: list[Tensor], key_valid: list[Tensor],
               key_step: list[int], key_source: list[int],
               key_valid_at: list[int], growth: int, max_probes: int,
               backend: str) -> tuple[Tensor, Tensor, Tensor]:
    from presto_tpu_torch.kernels.multijoin import Walk
    walk = Walk(list(build_live), list(build_hash), list(build_step),
                list(key_hash), list(key_valid), list(key_step),
                list(key_source), list(key_valid_at))
    gathers, alive, ok = _impl("multijoin", backend)(
        spine_live, walk, growth, max_probes)
    return gathers, alive, ok.reshape(())


@_multijoin.register_fake
def _(spine_live, build_live, build_hash, build_step, key_hash,
      key_valid, key_step, key_source, key_valid_at, growth, max_probes,
      backend):
    n = spine_live.shape[0]
    return (spine_live.new_empty((len(build_live), n), dtype=torch.int32),
            spine_live.new_empty((n,), dtype=torch.bool),
            spine_live.new_empty((), dtype=torch.bool))


@_multijoin.register_vmap
def _(info, in_dims, spine_live, build_live, build_hash, build_step,
      key_hash, key_valid, key_step, key_source, key_valid_at, growth,
      max_probes, backend):
    from presto_tpu_torch.kernels.build import MJ_MAX_KEYS
    lanes = info.batch_size
    dev = spine_live.device
    live = _lanes(spine_live, in_dims[0], lanes)
    width = live.shape[1]
    blive = [_lanes(t, d, lanes) for t, d in zip(build_live, in_dims[1])]
    rows = [t.shape[1] for t in blive]
    bhash = [_flat(_lanes(t, d, lanes))
             for t, d in zip(build_hash, in_dims[2])]
    khash = [_flat(_lanes(t, d, lanes))
             for t, d in zip(key_hash, in_dims[4])]
    kvalid = [_flat(_lanes(t, d, lanes))
              for t, d in zip(key_valid, in_dims[5])]
    bstep, kstep = list(build_step), list(key_step)
    ksource, kvat = list(key_source), list(key_valid_at)
    # the lane is one more key of every step: a build row's lane on the
    # build side, the spine row's lane on the probe side
    for step, n in enumerate(rows):
        if backend == "cuda" and kstep.count(step) >= MJ_MAX_KEYS:
            raise ValueError(
                f"multijoin: step {step} has {kstep.count(step)} keys; "
                f"the lane takes one more of the walk kernel's "
                f"{MJ_MAX_KEYS}")
        bhash.append(_flat(_lane_key(lanes, n, dev)))
        bstep.append(step)
        khash.append(_flat(_lane_key(lanes, width, dev)))
        kstep.append(step)
        ksource.append(-1)
        kvat.append(-1)
    gathers, alive, ok = _multijoin(
        _flat(live), [_flat(t) for t in blive], bhash, bstep, khash,
        kvalid, kstep, ksource, kvat, growth, max_probes, backend)
    gathers = gathers.reshape(len(rows), lanes, width).to(torch.int64)
    lane = _lane_ids(lanes, width, dev)
    local = torch.stack([
        torch.clamp(g - lane * n, 0, max(n - 1, 0))
        for g, n in zip(gathers, rows)]).to(torch.int32)
    return (local, alive.reshape(lanes, width), ok), (1, 0, None)


def multijoin(spine_live, walk, growth: int, max_probes: int, *,
              backend: str):
    return _multijoin(spine_live, walk.build_live, walk.build_hash,
                      walk.build_step, walk.key_hash, walk.key_valid,
                      walk.key_step, walk.key_source, walk.key_valid_at,
                      int(growth), int(max_probes), backend)


OPS = {
    "agg_sum": lambda d, s, k, *, backend: segment_sum(d, s, int(k),
                                                       backend),
    "agg_max": lambda d, s, k, *, backend: segment_max(d, s, int(k),
                                                       backend),
    "agg_min": lambda d, s, k, *, backend: segment_min(d, s, int(k),
                                                       backend),
    "join_lookup": join_lookup,
    "compact": compact,
    "multijoin": multijoin,
}
