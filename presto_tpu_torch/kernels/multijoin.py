"""The MultiJoin star-chain probe walk: the CUDA kernel and its plain
version.

Port of ``try_fused`` (presto_tpu/kernels/multijoin.py:59). The kernel
is ``csrc/multijoin.cu``, whose header says what bounds it on the card
and how it walks; its per-step tables come from the build_table kernel
(kernels/hashjoin.py), each an int64 [cap, 2] array of 16-byte slots
(key, row) that the walk reads with one load a slot. The step
descriptors are a ``build.MjDesc`` packed on the host and passed to
the kernel by value: no device copy, so a fused walk never waits on
the stream.

Both versions take the spine's columns and live mask, the builds as
(cols, live, nrows), and the per-step criteria [(probe_sym,
build_sym)], and return (gathers: one int32 [width] build-row index per
step, live bool [width], ok 0-d bool). A probe key names a spine column
or a column of an EARLIER build (gathered at that step's match). Dead
rows gather build row 0, as the reference's ``clip(where(found, row,
-1))`` does.

- :func:`walk_chain` is the entry the interpreter calls. A chain that
  is not kernel-shaped (a 2-D LONG-decimal key) runs the plain walk,
  as ``try_fused`` declines. Value checks against 64-bit hash
  collisions run on the kernel's gathers, outside the kernel.
- :func:`multijoin_torch` is the plain version: the reference's inline
  walk of ``apply_multi_join``, one sorted lookup
  (sort_build_side + probe_runs) per step, verifying values per step.

The kernel entry behind it (``kernels.dispatch("multijoin")``) takes the chain as flat hash columns, a :class:`Walk`
(:func:`walk_of`): :func:`walk_cuda` launches the kernels and
:func:`walk_torch` is its plain version; both leave the value checks to
the caller. The flat form is what the lane rule folds
(kernels/lanes.py).
"""

from __future__ import annotations

import ctypes
import dataclasses

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
    """Launch the walk kernel over the first ``k`` steps of ``desc`` (a
    :class:`build.MjDesc` from :func:`step_descriptors`, passed to the
    kernel by value). Returns (gathers int32 [k, width], alive bool
    [width], ok bool [1])."""
    name = "multijoin_walk"
    B.require_cuda(name, spine_live=spine_live)
    B.require_dtype(name, "spine_live", spine_live, torch.bool)
    if not isinstance(desc, B.MjDesc) or not 1 <= k <= B.MJ_MAX_STEPS:
        raise ValueError(f"{name}: {k} steps of a build.MjDesc, the kernel "
                         f"takes 1..{B.MJ_MAX_STEPS}")
    steps = desc.steps[:k]
    if not all(st.table and 1 <= st.nkeys <= B.MJ_MAX_KEYS
               for st in steps):
        raise ValueError(f"{name}: a step of desc has no table or keys")
    if spine_live.shape != (width,):
        raise ValueError(f"{name}: spine_live must be [{width}]")
    dev = spine_live.device
    gathers = torch.empty((k, width), dtype=torch.int32, device=dev)
    alive = torch.empty(width, dtype=torch.bool, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    if width:
        lib = B.LIBRARY.get()
        rc = lib.pt_multijoin_walk(
            ctypes.addressof(desc), k, spine_live.data_ptr(), width,
            int(max_probes), gathers.data_ptr(), alive.data_ptr(),
            ok.data_ptr(), B.stream_handle(dev))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return gathers, alive, ok.to(torch.bool)


def _check_limits(steps) -> None:
    """The chain fits the walk kernel: 1 to MJ_MAX_STEPS steps of 1 to
    MJ_MAX_KEYS keys each."""
    if not 1 <= len(steps) <= B.MJ_MAX_STEPS:
        raise ValueError(f"multijoin_walk: {len(steps)} steps, the kernel "
                         f"takes 1..{B.MJ_MAX_STEPS}")
    if any(not 1 <= len(keys) <= B.MJ_MAX_KEYS for keys in steps):
        raise ValueError("multijoin_walk: a step needs 1 to "
                         f"{B.MJ_MAX_KEYS} keys")


def _pack(keys, tables):
    """The walk's :class:`build.MjDesc` from ``keys``, one (step,
    source, hash column, validity or None) per probe key in step order,
    and each step's table."""
    desc = B.MjDesc()
    for si, (st, table) in enumerate(zip(desc.steps, tables)):
        st.table = table.data_ptr()
        st.mask = table.shape[0] - 1
        mine = [k for k in keys if k[0] == si]
        st.nkeys = len(mine)
        for key, (_si, src, kh, valid) in zip(st.keys, mine):
            key.source, key.hash = src, kh.data_ptr()
            if valid is not None:
                key.valid = valid.data_ptr()
    return desc


def descriptor(steps, tables) -> tuple:
    """Pack the walk's step descriptors (:class:`build.MjDesc`): per
    step its table's address, slot mask and key count, then per key its
    source (-1 for the spine, else the earlier step), the address of
    its 64-bit hash column and of its validity (0 when it has no
    nulls). Host work only: no library, no device copy. Returns (desc,
    the hash and validity tensors it points at)."""
    _check_limits(steps)
    keys = [(si, src, kh.contiguous(),
             None if v.valid is None else v.valid.contiguous())
            for si, step in enumerate(steps) for src, v, _bv in step
            for kh in _col_hash(v)]
    keep = [t for _si, _src, kh, valid in keys for t in (kh, valid)
            if t is not None]
    return _pack(keys, tables), keep


def step_descriptors(steps, builds, growth: int = 1,
                     max_probes: int = HJ.MAX_PROBES):
    """Build each step's table with the build_table kernel and pack the
    walk's step descriptors (:func:`descriptor`). Returns (desc, the
    tensors the descriptors point at, the build ok flags); the caller
    keeps the tensors alive until the walk is queued."""
    _check_limits(steps)  # before any build
    tables, oks = [], []
    for (_bcols, blive, bn), keys in zip(builds, steps):
        cap = H.next_pow2(2 * max(bn, 1)) * max(int(growth), 1)
        rh = _combined_hash([bv for _s, _v, bv in keys])
        table, b_ok = HJ.build_table(
            rh, _build_live(blive, keys).contiguous(), cap, max_probes)
        tables.append(table)
        oks.append(b_ok)
    desc, keep = descriptor(steps, tables)
    return desc, keep + tables, oks


@dataclasses.dataclass
class Walk:
    """A chain as flat hash columns. Per step: the build's live rows
    (its key columns' validity folded in); per build key hash column
    its step; per probe key hash column its step, its source (-1 the
    spine, else the earlier step whose match indexes it) and its
    validity (an index into ``key_valid``, -1 for none). A LONG-decimal
    key gives two hash columns on each side."""

    build_live: list
    build_hash: list
    build_step: list
    key_hash: list
    key_valid: list
    key_step: list
    key_source: list
    key_valid_at: list


def walk_of(steps, builds) -> Walk:
    """The flat :class:`Walk` of resolved ``steps`` over ``builds``."""
    w = Walk([], [], [], [], [], [], [], [])
    for si, ((_bcols, blive, _bn), keys) in enumerate(zip(builds, steps)):
        w.build_live.append(_build_live(blive, keys).contiguous())
        for src, v, bv in keys:
            for h in _col_hash(bv):
                w.build_hash.append(h.contiguous())
                w.build_step.append(si)
            for h in _col_hash(v):
                w.key_hash.append(h.contiguous())
                w.key_step.append(si)
                w.key_source.append(src)
                if v.valid is None:
                    w.key_valid_at.append(-1)
                else:
                    w.key_valid_at.append(len(w.key_valid))
                    w.key_valid.append(v.valid.contiguous())
    return w


def _step_hash(hashes, steps, si):
    return H.combine_hashes([h for h, s in zip(hashes, steps) if s == si])


def walk_torch(spine_live, walk: Walk, growth: int = 1,
               max_probes: int = HJ.MAX_PROBES):
    """Plain version of the flat walk: one sorted lookup per step.
    Returns (gathers int32 [steps, width], live bool [width], ok 0-d
    bool); dead rows gather build row 0."""
    from presto_tpu_torch import kernels as K
    K.note("torch:multijoin")
    live = spine_live
    gathers: list = []
    for si, blive in enumerate(walk.build_live):
        bn = blive.shape[0]
        probe_live = live
        cols = []
        for j, step in enumerate(walk.key_step):
            if step != si:
                continue
            src = walk.key_source[j]
            cols.append(walk.key_hash[j] if src < 0
                        else take(walk.key_hash[j], gathers[src]))
            at = walk.key_valid_at[j]
            if at >= 0:
                valid = walk.key_valid[at]
                probe_live = probe_live & (
                    valid if src < 0 else take(valid, gathers[src]))
        rh = _step_hash(walk.build_hash, walk.build_step, si)
        _bsh, bsidx = H.sort_build_side(rh, blive)
        lo, count, found = H.probe_runs(rh, blive,
                                        H.combine_hashes(cols), probe_live)
        picked = take(bsidx, torch.clamp(lo + count - 1, 0,
                                         max(bn - 1, 0)))
        gathers.append(torch.where(found, picked, torch.zeros_like(
            picked)).to(torch.int32))
        live = probe_live & found
    return (torch.stack(gathers), live,
            torch.ones((), dtype=torch.bool, device=spine_live.device))


def walk_cuda(spine_live, walk: Walk, growth: int = 1,
              max_probes: int = HJ.MAX_PROBES):
    """The flat walk on the card: per-step tables from the build_table
    kernel, then one multijoin_walk launch; the plain version for a
    mask on the CPU."""
    if not spine_live.is_cuda:
        return walk_torch(spine_live, walk, growth, max_probes)
    steps = len(walk.build_live)
    _check_limits([[None] * walk.key_step.count(si)
                   for si in range(steps)])
    tables, oks = [], []
    for si, blive in enumerate(walk.build_live):
        cap = H.next_pow2(2 * max(blive.shape[0], 1)) * max(int(growth), 1)
        table, b_ok = HJ.build_table(
            _step_hash(walk.build_hash, walk.build_step, si), blive, cap,
            max_probes)
        tables.append(table)
        oks.append(b_ok)
    desc = _pack([(si, src, kh, None if at < 0 else walk.key_valid[at])
                  for si, src, kh, at in zip(
                      walk.key_step, walk.key_source, walk.key_hash,
                      walk.key_valid_at)], tables)
    gathers, alive, ok = multijoin_walk(desc, steps, spine_live.contiguous(),
                                        spine_live.shape[0], max_probes)
    # stream order keeps the tables and hash columns valid for the launch
    from presto_tpu_torch import kernels as K
    K.note("cuda:multijoin")
    ok_all = ok[0]
    for b_ok in oks:
        ok_all = ok_all & b_ok[0]
    return gathers, alive, ok_all


def walk_chain(spine_cols: dict, spine_live, builds: list, criteria: list,
               growth: int = 1, max_probes: int = HJ.MAX_PROBES):
    """The walk as the interpreter runs it (exec/operators.apply_multi_
    join): the current backend's kernel entry (``kernels.dispatch
    ("multijoin")``) over the flat walk, then the value checks against
    64-bit hash collisions on its gathers. A chain the walk kernel does
    not take (a LONG-decimal key) runs the plain walk on every backend.
    Returns (gathers: a list of int32 [width], live, ok)."""
    from presto_tpu_torch import kernels as K
    steps = _resolve(spine_cols, builds, criteria)
    entry = K.dispatch("multijoin", None if _kernel_shaped(steps)
                       else "torch")
    gathers, live, ok = entry(spine_live.contiguous(),
                              walk_of(steps, builds), growth, max_probes)
    gathers = list(gathers)
    for si, keys in enumerate(steps):
        verify = _verify(keys, gathers, gathers[si])
        if verify is not None:
            live = live & verify
    return gathers, live, ok
