"""Hashing, sort-based grouping and sorted join lookups on tensors.

The port of ``presto_tpu/ops/hash.py``. Every function returns the
same bits as the reference for the same inputs, so plans, group
orders and join matches agree row for row.

64-bit hashes are carried as int64 tensors holding the uint64 bit
pattern: torch's uint64 lacks addition, shifts, ordering and
searchsorted. Two rules follow from that representation:

- a logical right shift is ``(x >> k) & ((1 << (64 - k)) - 1)``
  (:func:`srl`);
- unsigned order is the signed order of ``x ^ INT64_MIN``
  (:func:`unsigned_key`), and every sort over hashes uses it, or group
  and probe orders would differ from the reference.

Multi-key stable sorts (``jax.lax.sort(..., num_keys=k)``) become
successive stable ``torch.sort`` passes, least significant key first
(:func:`lexsort`).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from presto_tpu_torch.ops.sizes import next_pow2  # noqa: F401 (re-export)

INT64_MIN = -(1 << 63)
# the EMPTY slot sentinel (uint64 all ones) as an int64 bit pattern
EMPTY = -1
# 0x9E3779B97F4A7C15 as a signed int64 bit pattern
PHI64 = 0x9E3779B97F4A7C15 - (1 << 64)
NULL_KEY_HASH = PHI64


class HashChainOverflow(RuntimeError):
    """The capacity retry ladder ran out of rungs: a hash table kept
    overflowing (a probe chain past ``max_probes`` or more groups than
    every capacity tried). Raised by the executor, never silently
    absorbed."""


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a uint64 bit pattern held in int64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def unsigned_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 whose signed order is the unsigned order of ``x``."""
    return x ^ INT64_MIN


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """A tensor torch.sort orders like jax.lax.sort orders ``x``: bool
    becomes uint8 (False < True); other dtypes sort natively."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort over ``keys`` (first key most
    significant), each key already in torch-sortable form. int64
    permutation."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        order = torch.sort(k[perm], stable=True).indices
        perm = perm[order]
    return perm


def grow_overflowed(capacities: dict, ok_keys, oks,
                    used_capacity: dict, growth: int = 4) -> int:
    """One rung of the capacity retry ladder: grow each failed key's
    capacity by ``growth``. Returns how many hash-table (not output)
    capacities overflowed."""
    overflowed = 0
    for key, okv in zip(ok_keys, oks):
        if not bool(okv):
            if key[1] in ("table", "final"):
                overflowed += 1
            capacities[key] = growth * used_capacity[key]
    return overflowed


def hash_int_column(data: torch.Tensor, valid=None) -> torch.Tensor:
    """Order-preserving identity key of an integer-like column: the
    value with its sign bit flipped. NULLs map to a fixed sentinel."""
    u = data.to(torch.int64) ^ INT64_MIN
    if valid is not None:
        u = torch.where(valid, u, torch.full_like(u, NULL_KEY_HASH))
    return u


class DictionaryHashes:
    """Content hashes of string dictionaries, cached per dictionary
    object and device. Holding the dictionary keeps its id stable, so
    a recycled address cannot alias."""

    def __init__(self, limit: int = 256):
        self.limit = limit
        self._host: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._dev: dict[tuple, tuple[np.ndarray, torch.Tensor]] = {}

    def host(self, dictionary: np.ndarray) -> np.ndarray:
        hit = self._host.get(id(dictionary))
        if hit is not None and hit[0] is dictionary:
            return hit[1]
        out = np.empty(len(dictionary), dtype=np.uint64)
        for i, s in enumerate(dictionary):
            d = hashlib.blake2b(str(s).encode(), digest_size=8).digest()
            out[i] = np.frombuffer(d, dtype=np.uint64)[0]
        if len(self._host) > self.limit:
            self._host.clear()
        self._host[id(dictionary)] = (dictionary, out)
        return out

    def device(self, dictionary: np.ndarray, device) -> torch.Tensor:
        key = (id(dictionary), str(device))
        hit = self._dev.get(key)
        if hit is not None and hit[0] is dictionary:
            return hit[1]
        lut = torch.from_numpy(
            self.host(dictionary).view(np.int64).copy()).to(device)
        if len(self._dev) > self.limit:
            self._dev.clear()
        self._dev[key] = (dictionary, lut)
        return lut


DICTIONARY_HASHES = DictionaryHashes()


def hash_string_dictionary(dictionary: np.ndarray) -> np.ndarray:
    """Stable 64-bit hash per dictionary entry (uint64, host)."""
    return DICTIONARY_HASHES.host(dictionary)


def hash_string_column(codes: torch.Tensor, dictionary: np.ndarray,
                       valid=None) -> torch.Tensor:
    if len(dictionary) == 0:
        h = torch.zeros(codes.shape, dtype=torch.int64,
                        device=codes.device)
    else:
        lut = DICTIONARY_HASHES.device(dictionary, codes.device)
        h = lut[torch.clamp(codes.to(torch.int64), 0,
                            len(dictionary) - 1)]
    if valid is not None:
        h = torch.where(valid, h, torch.full_like(h, NULL_KEY_HASH))
    return h


def combine_hashes(hashes: list[torch.Tensor]) -> torch.Tensor:
    """Combine per-column keys into one row key: ``acc * PHI64 ^ h``
    per extra column (int64 multiplication wraps mod 2^64 exactly like
    the reference's uint64), then the EMPTY sentinel is remapped."""
    out = hashes[0]
    for h in hashes[1:]:
        out = (out * PHI64) ^ h
    return torch.where(out == EMPTY, out - 1, out)


def _masked(row_hash: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return torch.where(live, row_hash, torch.full_like(row_hash, EMPTY))


def _first_flags(sh: torch.Tensor) -> torch.Tensor:
    """True at each sorted position whose value differs from the
    previous one (position 0 included)."""
    head = torch.ones(1, dtype=torch.bool, device=sh.device)
    return torch.cat([head, sh[1:] != sh[:-1]])


def _run_starts(is_new: torch.Tensor) -> torch.Tensor:
    """Per position, the position of its run's first row, 0 before the
    first run (the reference's ``clip(cummax(where(is_new, i, -1)), 0)``).
    Scattered from the run ids instead of a cummax: torch's CUDA cummax
    over one long row is a single-block scan (~120 ms at 75M rows on an
    H100, profile_port.py)."""
    n = is_new.shape[0]
    i = torch.arange(n, dtype=torch.int64, device=is_new.device)
    rid = torch.cumsum(is_new.to(torch.int64), 0) - 1
    firsts = torch.zeros(n + 1, dtype=torch.int64, device=is_new.device)
    firsts.scatter_(0, torch.where(is_new, rid, torch.full_like(rid, n)), i)
    start = firsts[torch.clamp(rid, min=0)]
    return torch.where(rid >= 0, start, torch.zeros_like(start)).to(
        torch.int32)


def _sorted_group_ids(row_hash, live):
    """Sort rows by hash; dense group ids in hash order. Returns (sh,
    sidx int32, gid_sorted int32, ngroups 0-d int32)."""
    h = _masked(row_hash, live)
    order = torch.sort(unsigned_key(h), stable=True).indices
    sh = h[order]
    is_new = _first_flags(sh) & (sh != EMPTY)
    gid_sorted = torch.cumsum(is_new.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    return (sh, order.to(torch.int32), gid_sorted,
            is_new.to(torch.int32).sum(dtype=torch.int32))


class SortedGroups:
    """Row grouping derived from one hash sort (the port of the
    reference's ``SortedGroups``; see its docstring for the fields).
    The first ``num_key_payloads`` payloads are secondary sort keys,
    so group identity is the exact key tuple, not the 64-bit hash."""

    __slots__ = ("sh", "sidx", "payloads", "live", "is_new", "is_last",
                 "start", "gidc", "ngroups")

    def __init__(self, row_hash, live, payloads=(), num_key_payloads=0):
        n = row_hash.shape[0]
        dev = row_hash.device
        h = _masked(row_hash, live)
        keys = [unsigned_key(h)] + [sort_key(p) for p in
                                    payloads[:num_key_payloads]]
        perm = lexsort(keys)
        sh = h[perm]
        key_cols = [p[perm] for p in payloads[:num_key_payloads]]
        self.payloads = tuple(key_cols) + tuple(
            p[perm] for p in payloads[num_key_payloads:])
        self.sh, self.sidx = sh, perm.to(torch.int32)
        self.live = sh != EMPTY
        differs = sh[1:] != sh[:-1]
        for kp in key_cols:
            differs = differs | (kp[1:] != kp[:-1])
        one = torch.ones(1, dtype=torch.bool, device=dev)
        self.is_new = torch.cat([one, differs]) & self.live
        self.is_last = torch.cat([differs, one]) & self.live
        self.start = _run_starts(self.is_new)
        gid = torch.cumsum(self.is_new.to(torch.int32), 0,
                           dtype=torch.int32) - 1
        self.ngroups = self.is_new.to(torch.int32).sum(dtype=torch.int32)
        self.gidc = torch.where(self.live, torch.clamp(gid, min=0),
                                torch.full_like(gid, n))

    def _compact(self, keep, columns, capacity: int):
        n = self.sh.shape[0]
        key = torch.where(keep, self.gidc, torch.full_like(self.gidc, n))
        perm = torch.sort(key, stable=True).indices
        res = []
        for col in columns:
            c = col[perm]
            if capacity <= n:
                res.append(c[:capacity])
            else:
                pad = torch.zeros((capacity - n,) + tuple(c.shape[1:]),
                                  dtype=c.dtype, device=c.device)
                res.append(torch.cat([c, pad]))
        occupied = (torch.arange(capacity, device=self.sh.device)
                    < torch.clamp(self.ngroups, max=capacity))
        return res, occupied

    def compact(self, columns, capacity: int):
        """Compact per-sorted-row arrays to [capacity], keeping each
        group's LAST row at its dense group id."""
        return self._compact(self.is_last, columns, capacity)

    def compact_first(self, columns, capacity: int):
        """Like compact but keeps each group's FIRST row."""
        return self._compact(self.is_new, columns, capacity)

    def slots(self):
        """Dense group id per ORIGINAL row (inverse permutation)."""
        n = self.sh.shape[0]
        safe = torch.clamp(self.gidc, 0, n - 1).to(torch.int32)
        out = torch.zeros(n, dtype=torch.int32, device=safe.device)
        return out.index_copy(0, self.sidx.to(torch.int64), safe)


def _dense_table(sh, gid_sorted, capacity: int):
    """Each group's hash at its dense slot; EMPTY past ngroups."""
    safe_gid = torch.clamp(gid_sorted, 0, capacity - 1).to(torch.int64)
    keep = (gid_sorted >= 0) & (sh != EMPTY) & (gid_sorted < capacity)
    dest = torch.where(keep, safe_gid, torch.full_like(safe_gid, capacity))
    table = torch.full((capacity + 1,), EMPTY, dtype=torch.int64,
                       device=sh.device)
    table = table.index_copy(0, dest, torch.where(
        keep, sh, torch.full_like(sh, EMPTY)))
    return table[:capacity]


def group_by_slots(row_hash, live, capacity: int, max_rounds: int = 64):
    """Assign each live row a dense slot (rows with equal hashes share
    one). Returns (slot int32 [N], table_hash [capacity] ascending with
    an EMPTY tail, ok 0-d bool: the group count fits ``capacity``)."""
    n = row_hash.shape[0]
    sh, sidx, gid_sorted, ngroups = _sorted_group_ids(row_hash, live)
    ok = ngroups <= capacity
    safe_gid = torch.clamp(gid_sorted, 0, capacity - 1)
    slot = torch.zeros(n, dtype=torch.int32, device=row_hash.device)
    slot = slot.index_copy(0, sidx.to(torch.int64), safe_gid)
    return slot, _dense_table(sh, gid_sorted, capacity), ok


def sort_build_side(row_hash, live):
    """Build side of a join as a sorted run structure: (sh sorted
    hashes with dead rows at the EMPTY tail, sidx int32)."""
    h = _masked(row_hash, live)
    order = torch.sort(unsigned_key(h), stable=True).indices
    return h[order], order.to(torch.int32)


def probe_runs(build_hash, build_live, probe_hash, probe_live):
    """Join probe by co-sorted merge: per PROBE row (lo, count, found),
    where matching build rows occupy build-sorted positions
    [lo, lo + count). Build and probe hashes sort together keyed by
    (hash, side) with builds first; the run bounds come from running
    build counts. The reference restores probe order with a sort keyed
    by (side, index); its keys are a permutation, so a scatter gives
    the same result."""
    nb = build_hash.shape[0]
    npr = probe_hash.shape[0]
    n = nb + npr
    dev = build_hash.device
    allh = torch.cat([_masked(build_hash, build_live),
                      _masked(probe_hash, probe_live)])
    side = torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                      torch.ones(npr, dtype=torch.int32, device=dev)])
    idx = torch.cat([torch.arange(nb, dtype=torch.int32, device=dev),
                     torch.arange(npr, dtype=torch.int32, device=dev)])
    perm = lexsort([unsigned_key(allh), side])
    sh, sside, sidx = allh[perm], side[perm], idx[perm]
    start = _run_starts(_first_flags(sh))
    is_build = ((sside == 0) & (sh != EMPTY)).to(torch.int32)
    builds_before = torch.cumsum(is_build, 0, dtype=torch.int32) - is_build
    lo = builds_before[start.to(torch.int64)]
    count = builds_before - lo
    dest = (sside.to(torch.int64) * nb + sidx.to(torch.int64))
    lo_o = torch.empty(n, dtype=torch.int32, device=dev).index_copy(
        0, dest, lo)
    cnt_o = torch.empty(n, dtype=torch.int32, device=dev).index_copy(
        0, dest, count)
    lo_p, cnt_p = lo_o[nb:], cnt_o[nb:]
    found = probe_live & (cnt_p > 0)
    return lo_p, torch.where(found, cnt_p, torch.zeros_like(cnt_p)), found


def expand_matches(lo, counts, build_sidx, probe_found, probe_live,
                   out_capacity: int, left_join: bool):
    """Expand probe rows into one output row per (probe, build) match:
    output position k finds the probe row whose match range covers it
    (searchsorted over the running match counts) and indexes into its
    run. Returns (probe_idx int32 [out_capacity], build_row int32
    (-1 = unmatched), out_live bool, ok 0-d bool: the matches fit)."""
    dev = lo.device
    counts = counts.to(torch.int64)
    zero = torch.zeros_like(counts)
    matches = torch.where(probe_found & probe_live, counts, zero)
    if left_join:
        per_probe = torch.where(probe_live, torch.clamp(matches, min=1),
                                zero)
    else:
        per_probe = matches
    csum = torch.cumsum(per_probe, 0)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        csum[:-1]])
    total = csum[-1]
    ok = total <= out_capacity
    k = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    probe_idx = torch.searchsorted(prefix, k, right=True) - 1
    safe_probe = torch.clamp(probe_idx, 0, per_probe.shape[0] - 1)
    j = k - prefix[safe_probe]
    matched = probe_found[safe_probe] & (j < matches[safe_probe])
    build_pos = torch.clamp(lo.to(torch.int64)[safe_probe] + j, 0,
                            build_sidx.shape[0] - 1)
    build_row = torch.where(matched, build_sidx[build_pos].to(torch.int64),
                            torch.full_like(k, -1))
    return (safe_probe.to(torch.int32), build_row.to(torch.int32),
            k < total, ok)
