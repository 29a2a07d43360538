"""The program cache's memory tier: a size-bounded LRU of what each
program learned, keyed like the reference's.

The port of ``presto_tpu/exec/progcache.py``, memory tier only. The
reference caches compiled XLA executables; eager PyTorch compiles
nothing, so an entry holds the program's ``meta``: the node keys of
its capacities, its output layout and its kernel notes. What makes a
repeat query cheap is the capacity memory beside the cache
(``engine._caps_memory``, keyed by the same base key): a program
starts from the capacity vector that succeeded last time instead of
climbing the ladder again (``exec/executor.prepare_plan``).

Key canonicalization follows the reference: capacities go to pow2
buckets (:func:`bucket_capacities`); the session component holds only
the properties the interpreter reads (:data:`TRACE_RELEVANT_PROPERTIES`,
resolved through ``Session.get``); dictionary contents take part
(:func:`dictionary_token`), since a program's meta carries the decode
dictionaries.

Left out (ROADMAP): the persistent AOT disk tier and its capacity
sidecar (no torch counterpart to serializing an executable),
``map_parallel`` (there is no compile to run in parallel) and
CUDA-graph capture.
"""

from __future__ import annotations

import functools
import hashlib
import threading

from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.ops.sizes import next_pow2

_HITS = REGISTRY.counter(
    "presto_tpu_program_cache_hits_total",
    "program cache hits, labeled tier=memory")
_MISSES = REGISTRY.counter(
    "presto_tpu_program_cache_misses_total",
    "program cache misses")
_EVICTIONS = REGISTRY.counter(
    "presto_tpu_program_cache_evictions_total",
    "LRU evictions from the in-memory program cache")
_ENTRIES_G = REGISTRY.gauge(
    "presto_tpu_program_cache_entries",
    "programs resident across every live in-process LRU "
    "(delta-accounted process total)")

# Session properties the interpreters read while a program runs: the
# session component of a cache key (the reference's list). Everything
# else acts at plan time (captured by the plan fingerprint) or on the
# host around the program.
TRACE_RELEVANT_PROPERTIES = (
    "broadcast_join_threshold_rows",
    "distributed_sort",
    "enable_dynamic_filtering",
    "groupby_table_size",
    "join_distribution_type",
    "join_salting",
    # the kernel backend picks the operator inner loops: cuda and torch
    # runs are different programs and must not share an entry
    "kernel_backend",
    "partial_aggregation",
    "partitioned_agg_min_groups",
    "skew_hot_key_threshold",
)

DEFAULT_MAX_ENTRIES = 64


def trace_session_key(session) -> tuple:
    """Session component of a cache key: only the properties the
    interpreter reads, resolved through Session.get so per-thread
    query overrides take part."""
    return tuple((name, repr(session.get(name)))
                 for name in TRACE_RELEVANT_PROPERTIES)


def bucket_capacities(capacities: dict) -> tuple:
    """Capacity-override vector canonicalized to pow2 buckets, sorted
    for key stability."""
    return tuple(sorted(
        (k, next_pow2(v)) for k, v in capacities.items()))


# dictionary content digests memoized by array identity (the strong
# ref pins the id); bounded so per-query derived dictionaries cannot
# leak
_DICT_TOKENS: dict[int, tuple] = {}
_DICT_TOKENS_MAX = 1024
_DICT_LOCK = threading.Lock()


def dictionary_token(arr) -> str | None:
    """Content digest of one dictionary array, or None. A program's
    meta carries the decode dictionaries, so dictionary CONTENT, not
    just shape, takes part in cache keys."""
    import numpy as np
    if arr is None:
        return None
    key = id(arr)
    with _DICT_LOCK:
        hit = _DICT_TOKENS.get(key)
        if hit is not None and hit[0] is arr:
            return hit[1]
    data = np.asarray(arr)
    h = hashlib.blake2b(digest_size=8)
    h.update(str(len(data)).encode())
    if data.dtype == object:
        # one join in C, not an update per entry (a dictionary of a
        # scale-10 table holds millions of strings)
        h.update("\0".join(map(str, data.tolist())).encode())
    else:
        h.update(np.ascontiguousarray(data).tobytes())
    digest = h.hexdigest()
    with _DICT_LOCK:
        if len(_DICT_TOKENS) >= _DICT_TOKENS_MAX:
            _DICT_TOKENS.clear()
        _DICT_TOKENS[key] = (arr, digest)
    return digest


def scan_dictionary_key(scans) -> tuple:
    """Key component covering every scanned dictionary's content."""
    return tuple(
        (i, sym, dictionary_token(d))
        for i, scan in enumerate(scans)
        for sym, d in scan.dictionaries.items() if d is not None)


@functools.lru_cache(maxsize=32)
def platform_fingerprint(device: str, backend: str) -> tuple:
    """What a program's meta is valid for: torch's version, the
    device's name and the resolved kernel backend."""
    import torch
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else device)
    return (torch.__version__, name, f"kernels-{backend}")


def backend_free(key):
    """A program-cache key without its kernel backend (the session's
    ``kernel_backend`` pair and the platform's ``kernels-<backend>``):
    the key of the program's device cost (obs/devprof.known_cost),
    which is counted the same on either backend (a kernel entry by its
    formula)."""
    if isinstance(key, str):
        return "kernels" if key.startswith("kernels-") else key
    if isinstance(key, tuple):
        return tuple(backend_free(k) for k in key
                     if not (isinstance(k, tuple) and len(k) == 2
                             and k[0] == "kernel_backend"))
    return key


class ProgramCache:
    """Bounded in-memory LRU of program meta."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES):
        self._lock = threading.Lock()
        # key -> meta; insertion order = LRU order
        self._entries: dict = {}
        self.max_entries = max(1, int(max_entries))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}

    def configure(self, session) -> None:
        """Refresh the entry bound from the session (SET SESSION
        program_cache_entries takes effect on the next query)."""
        limit = int(session.get("program_cache_entries") or 0)
        if limit <= 0:
            return
        with self._lock:
            self.max_entries = max(1, limit)
            self._trim()

    def lookup(self, key):
        """The meta stored under ``key``, or None; counts one hit or
        one miss."""
        with self._lock:
            meta = self._entries.pop(key, None)
            if meta is not None:
                self._entries[key] = meta  # re-append: most recent
                self.hits += 1
            else:
                self.misses += 1
        if meta is not None:
            _HITS.inc(tier="memory")
        else:
            _MISSES.inc()
        return meta

    def insert(self, key, meta) -> None:
        with self._lock:
            if self._entries.pop(key, None) is None:
                _ENTRIES_G.inc()
            self._entries[key] = meta
            self._trim()

    def _trim(self) -> None:
        """Evict LRU entries beyond the bound. Caller holds the lock."""
        while len(self._entries) > self.max_entries:
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
            _ENTRIES_G.dec()
            _EVICTIONS.inc()
