"""The MultiJoin star-chain probe walk: the CUDA kernel and its plain
version.

Port of ``try_fused`` (presto_tpu/kernels/multijoin.py:59). The kernel
is ``csrc/multijoin.cu``, whose header says what bounds it on the card
and how it walks; its per-step tables come from the build_table kernel
(kernels/hashjoin.py).

Both versions take the spine's columns and live mask, the builds as
(cols, live, nrows), and the per-step criteria [(probe_sym,
build_sym)], and return (gathers: one int32 [width] build-row index per
step, live bool [width], ok 0-d bool). A probe key names a spine column
or a column of an EARLIER build (gathered at that step's match). Dead
rows gather build row 0, as the reference's ``clip(where(found, row,
-1))`` does.

- :func:`multijoin_cuda` returns None when the chain is not
  kernel-shaped (a 2-D LONG-decimal key, or a key that is not a plain
  spine or build column), exactly as ``try_fused`` declines; the
  caller then runs the plain walk. Value checks against 64-bit hash
  collisions run on the kernel's gathers, outside the kernel.
- :func:`multijoin_torch` is the plain version: the reference's inline
  walk of ``apply_multi_join``, one sorted lookup
  (sort_build_side + probe_runs) per step, verifying values per step.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch.kernels import build as B
from presto_tpu_torch.kernels import hashjoin as HJ
from presto_tpu_torch.ops import hash as H

_SPINE = -1


def take(data, idx):
    """``data[idx]`` along rows; an empty source yields zeros."""
    if data.shape[0] == 0:
        return torch.zeros((idx.shape[0],) + tuple(data.shape[1:]),
                           dtype=data.dtype, device=data.device)
    return data[idx.to(torch.int64)]


def _col_hash(v):
    """Per-column 64-bit key(s) of a Val (ops/hash contract); a LONG
    decimal contributes both limbs."""
    if v.is_string:
        return [H.hash_string_column(v.data, v.dictionary, v.valid)]
    if v.data.ndim == 2:
        return [H.hash_int_column(v.data[:, 0], v.valid),
                H.hash_int_column(v.data[:, 1], v.valid)]
    return [H.hash_int_column(v.data, v.valid)]


def _combined_hash(vals):
    return H.combine_hashes([h for v in vals for h in _col_hash(v)])


def _gathered(v, idx):
    """A Val's data, validity and dictionary at row indices ``idx``
    (None = the Val itself)."""
    if idx is None:
        return v
    return type(v)(v.dtype, take(v.data, idx),
                   None if v.valid is None else take(v.valid, idx),
                   v.dictionary)


def _resolve(spine_cols, builds, criteria):
    """Per step: [(probe Val source index, probe Val, build Val)] with
    the source -1 for the spine, else the earlier build step."""
    sources = {s: _SPINE for s in spine_cols}
    steps = []
    for si, ((bcols, _blive, _bn), crit) in enumerate(zip(builds, criteria)):
        keys = []
        for lk, rk in crit:
            src = sources.get(lk)
            if src is None or rk not in bcols:
                raise KeyError(f"multijoin key {lk} = {rk} not resolvable")
            v = spine_cols[lk] if src == _SPINE else builds[src][0][lk]
            keys.append((src, v, bcols[rk]))
        steps.append(keys)
        for sym in bcols:
            sources[sym] = si
    return steps


def _verify(keys, gathers, gather):
    """Value-compare matched non-string keys (64-bit collision
    defence; strings are content-hashed per dictionary)."""
    eq = None
    for src, v, bv in keys:
        if v.is_string or bv.is_string:
            continue
        ld = v.data if src == _SPINE else take(v.data, gathers[src])
        e = ld == take(bv.data, gather)
        if e.ndim == 2:
            e = e.all(dim=1)
        eq = e if eq is None else (eq & e)
    return eq


def _build_live(blive, keys):
    bl = blive
    for _src, _v, bv in keys:
        if bv.valid is not None:
            bl = bl & bv.valid
    return bl


def multijoin_torch(spine_cols: dict, spine_live, width: int,
                    builds: list, criteria: list, growth: int = 1,
                    max_probes: int = HJ.MAX_PROBES):
    """Plain version: the sequential sorted-probe walk."""
    from presto_tpu_torch import kernels as K
    K.note("torch:multijoin")
    steps = _resolve(spine_cols, builds, criteria)
    live = spine_live
    gathers: list = []
    for (bcols, blive, bn), keys in zip(builds, steps):
        probe_vals = [_gathered(v, None if src == _SPINE else gathers[src])
                      for src, v, _bv in keys]
        probe_live = live
        for pv in probe_vals:
            if pv.valid is not None:
                probe_live = probe_live & pv.valid
        build_live = _build_live(blive, keys)
        rh = _combined_hash([bv for _s, _v, bv in keys])
        ph = _combined_hash(probe_vals)
        _bsh, bsidx = H.sort_build_side(rh, build_live)
        lo, count, found = H.probe_runs(rh, build_live, ph, probe_live)
        last = torch.clamp(lo + count - 1, 0, max(bn - 1, 0))
        picked = take(bsidx, last)
        build_row = torch.where(found, picked, torch.full_like(picked, -1))
        gather = torch.clamp(build_row, 0, max(bn - 1, 0))
        verify = _verify(keys, gathers, gather)
        if verify is not None:
            found = found & verify
        gathers.append(gather)
        live = probe_live & found
    return gathers, live, torch.ones((), dtype=torch.bool,
                                     device=spine_live.device)


def _kernel_shaped(steps) -> bool:
    return all(v.data.ndim == 1 and bv.data.ndim == 1
               for keys in steps for _s, v, bv in keys)


def multijoin_walk(desc, k: int, spine_live, width: int,
                   max_probes: int = HJ.MAX_PROBES):
    """Launch the walk kernel over step descriptors ``desc`` (int64
    [k * MJ_STEP_WORDS] on the device, see :func:`step_descriptors`).
    Returns (gathers int32 [k, width], alive bool [width], ok bool
    [1])."""
    name = "multijoin_walk"
    B.require_cuda(name, desc=desc, spine_live=spine_live)
    B.require_dtype(name, "desc", desc, torch.int64)
    B.require_dtype(name, "spine_live", spine_live, torch.bool)
    if not 1 <= k <= B.MJ_MAX_STEPS or desc.shape != (k * B.MJ_STEP_WORDS,):
        raise ValueError(f"{name}: {k} steps, the kernel takes 1.."
                         f"{B.MJ_MAX_STEPS} with {B.MJ_STEP_WORDS} words each")
    if spine_live.shape != (width,):
        raise ValueError(f"{name}: spine_live must be [{width}]")
    dev = spine_live.device
    gathers = torch.empty((k, width), dtype=torch.int32, device=dev)
    alive = torch.empty(width, dtype=torch.bool, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    if width:
        lib = B.LIBRARY.get()
        rc = lib.pt_multijoin_walk(desc.data_ptr(), k, spine_live.data_ptr(),
                                   width, int(max_probes),
                                   gathers.data_ptr(), alive.data_ptr(),
                                   ok.data_ptr(), B.stream_handle(dev))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return gathers, alive, ok.to(torch.bool)


def step_descriptors(steps, builds, growth: int = 1,
                     max_probes: int = HJ.MAX_PROBES):
    """Build each step's table with the build_table kernel and pack the
    walk's step descriptors. Returns (desc int64 device tensor, the
    tensors the descriptors point at, the build ok flags); the caller
    keeps the tensors alive until the walk is queued."""
    if not 1 <= len(steps) <= B.MJ_MAX_STEPS:
        raise ValueError(f"multijoin_walk: {len(steps)} steps, the kernel "
                         f"takes 1..{B.MJ_MAX_STEPS}")
    if any(len(keys) > B.MJ_MAX_KEYS for keys in steps):
        raise ValueError("multijoin_walk: more than "
                         f"{B.MJ_MAX_KEYS} keys in a step")
    keep: list = []
    words = np.zeros(len(steps) * B.MJ_STEP_WORDS, dtype=np.int64)
    oks = []
    for si, ((_bcols, blive, bn), keys) in enumerate(zip(builds, steps)):
        cap = H.next_pow2(2 * max(bn, 1)) * max(int(growth), 1)
        rh = _combined_hash([bv for _s, _v, bv in keys])
        tkeys, trows, b_ok = HJ.build_table(
            rh, _build_live(blive, keys).contiguous(), cap, max_probes)
        oks.append(b_ok)
        keep += [tkeys, trows]
        base = si * B.MJ_STEP_WORDS
        words[base:base + 4] = (tkeys.data_ptr(), trows.data_ptr(),
                                tkeys.shape[0] - 1, len(keys))
        for j, (src, v, _bv) in enumerate(keys):
            (kh,) = _col_hash(v)
            kh = kh.contiguous()
            keep.append(kh)
            valid = 0
            if v.valid is not None:
                vt = v.valid.contiguous()
                keep.append(vt)
                valid = vt.data_ptr()
            words[base + 4 + 3 * j:base + 7 + 3 * j] = (
                src, kh.data_ptr(), valid)
    desc = torch.from_numpy(words).to(oks[0].device)
    return desc, keep, oks


def multijoin_cuda(spine_cols: dict, spine_live, width: int,
                   builds: list, criteria: list, growth: int = 1,
                   max_probes: int = HJ.MAX_PROBES):
    """The fused walk: per-step tables from the build_table kernel,
    then one multijoin_walk launch. None when the chain is not
    kernel-shaped; tensors on the CPU take the plain version."""
    if not spine_live.is_cuda:
        return multijoin_torch(spine_cols, spine_live, width, builds,
                               criteria, growth, max_probes)
    try:
        steps = _resolve(spine_cols, builds, criteria)
    except KeyError:
        return None
    if not _kernel_shaped(steps):
        return None
    desc, keep, oks = step_descriptors(steps, builds, growth, max_probes)
    gathers, alive, ok = multijoin_walk(desc, len(steps),
                                        spine_live.contiguous(), width,
                                        max_probes)
    del keep  # stream order keeps the buffers valid for the launch
    from presto_tpu_torch import kernels as K
    K.note("cuda:multijoin")
    ok_all = ok[0]
    for b_ok in oks:
        ok_all = ok_all & b_ok[0]
    rows = [gathers[si] for si in range(len(steps))]
    live = alive
    for si, keys in enumerate(steps):
        verify = _verify(keys, rows, rows[si])
        if verify is not None:
            live = live & verify
    return rows, live, ok_all
