"""Hash-join build and probe: the CUDA kernels and their plain version.

Port of ``build_table`` (presto_tpu/kernels/hashjoin.py:59),
``probe_table`` (:151) and ``lookup_join_pallas`` (:247). The kernels
are ``csrc/hashjoin.cu``, whose header says what bounds them on the
card and how the table is laid out.

Semantics (the reference's, for both versions): ``found`` marks a
live probe row whose 64-bit combined hash matches a live build row;
on duplicate build keys the representative is the LARGEST build row
index; value verification against residual 64-bit collisions stays
with the caller (exec/operators._verify_keys). The kernels bound each
probe chain at ``max_probes`` and report a longer one through ``ok``,
so the executor's capacity ladder rebuilds larger. The plain version
is the reference's sorted path (``lookup_join_xla``): sort_build_side
+ probe_runs + the last row of each run, always ``ok``.

There is no size gate: a table takes any capacity that fits in device
memory, and an allocation that fails raises.
"""

from __future__ import annotations

import torch

from presto_tpu_torch.kernels import build as B
from presto_tpu_torch.ops import hash as H

MAX_PROBES = 256


def table_capacity(capacity: int) -> int:
    """The table's slot count: ``capacity`` rounded up to a power of
    two, at least 8 (the reference's rule)."""
    cap = max(int(capacity), 8)
    return cap if cap & (cap - 1) == 0 else H.next_pow2(cap)


def build_table(row_hash, live, capacity: int,
                max_probes: int = MAX_PROBES):
    """Insert the live rows into an open-addressing table. Returns
    (keys int64 [cap] (EMPTY = -1), rows int32 [cap] (-1 = empty;
    duplicates keep the max row index), ok bool [1])."""
    name = "build_table"
    B.require_cuda(name, row_hash=row_hash, live=live)
    B.require_dtype(name, "row_hash", row_hash, torch.int64)
    B.require_dtype(name, "live", live, torch.bool)
    if row_hash.ndim != 1 or live.shape != row_hash.shape:
        raise ValueError(f"{name}: row_hash and live must be equal 1-D "
                         "shapes")
    cap = table_capacity(capacity)
    if cap > (1 << 31):
        raise ValueError(f"{name}: capacity {cap} exceeds 2^31 slots")
    dev = row_hash.device
    keys = torch.full((cap,), H.EMPTY, dtype=torch.int64, device=dev)
    rows = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    n = row_hash.shape[0]
    if n:
        lib = B.LIBRARY.get()
        rc = lib.pt_build_table(row_hash.data_ptr(), live.data_ptr(), n,
                                keys.data_ptr(), rows.data_ptr(), cap,
                                int(max_probes), ok.data_ptr(),
                                B.stream_handle(dev))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return keys, rows, ok.to(torch.bool)


def probe_table(keys, rows, probe_hash, probe_live,
                max_probes: int = MAX_PROBES):
    """Look each live probe row up in a built table. Returns
    (build_row int32 [n] (-1 = no match), found bool [n], ok bool [1]
    — False when a chain hit ``max_probes`` undecided)."""
    name = "probe_table"
    B.require_cuda(name, keys=keys, rows=rows, probe_hash=probe_hash,
                   probe_live=probe_live)
    B.require_dtype(name, "keys", keys, torch.int64)
    B.require_dtype(name, "rows", rows, torch.int32)
    B.require_dtype(name, "probe_hash", probe_hash, torch.int64)
    B.require_dtype(name, "probe_live", probe_live, torch.bool)
    cap = keys.shape[0]
    if cap < 1 or cap & (cap - 1) or rows.shape != keys.shape:
        raise ValueError(f"{name}: table planes must share one power-of-"
                         "two length")
    if probe_hash.ndim != 1 or probe_live.shape != probe_hash.shape:
        raise ValueError(f"{name}: probe_hash and probe_live must be "
                         "equal 1-D shapes")
    dev = keys.device
    n = probe_hash.shape[0]
    build_row = torch.empty(n, dtype=torch.int32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    if n:
        lib = B.LIBRARY.get()
        rc = lib.pt_probe_table(keys.data_ptr(), rows.data_ptr(), cap,
                                probe_hash.data_ptr(), probe_live.data_ptr(),
                                n, int(max_probes), build_row.data_ptr(),
                                found.data_ptr(), ok.data_ptr(),
                                B.stream_handle(dev))
        B.check(rc, name)
        B.LAUNCHES.add(name)
    return build_row, found, ok.to(torch.bool)


def lookup_join_cuda(build_hash, build_live, probe_hash, probe_live,
                     capacity: int, max_probes: int = MAX_PROBES):
    """FK->PK join lookup through the build and probe kernels:
    (build_row int32 [n_probe] (-1 = none), found bool [n_probe], ok
    0-d bool). Tensors on the CPU take the plain version."""
    if not build_hash.is_cuda:
        return lookup_join_torch(build_hash, build_live, probe_hash,
                                 probe_live, capacity, max_probes)
    from presto_tpu_torch import kernels as K
    K.note("cuda:join_lookup")
    keys, rows, b_ok = build_table(build_hash, build_live, capacity,
                                   max_probes)
    build_row, found, p_ok = probe_table(keys, rows, probe_hash,
                                         probe_live, max_probes)
    return build_row, found, (b_ok & p_ok)[0]


def lookup_join_torch(build_hash, build_live, probe_hash, probe_live,
                      capacity: int, max_probes: int = MAX_PROBES):
    """Plain version: the sorted-merge lookup (the reference's
    ``lookup_join_xla``)."""
    from presto_tpu_torch import kernels as K
    K.note("torch:join_lookup")
    nb = build_hash.shape[0]
    _sh, bsidx = H.sort_build_side(build_hash, build_live)
    lo, count, found = H.probe_runs(build_hash, build_live,
                                    probe_hash, probe_live)
    last = torch.clamp(lo + count - 1, 0, max(nb - 1, 0)).to(torch.int64)
    picked = (bsidx[last] if nb else
              torch.zeros_like(lo))
    build_row = torch.where(found, picked, torch.full_like(picked, -1))
    return (build_row, found,
            torch.ones((), dtype=torch.bool, device=build_hash.device))
