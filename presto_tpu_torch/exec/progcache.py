"""The program cache: a size-bounded LRU of what each program learned,
keyed like the reference's, over an optional persistent store.

The port of ``presto_tpu/exec/progcache.py``. The reference caches
compiled XLA executables; eager PyTorch compiles nothing, so an entry
holds the program's ``meta``: its output layout, the node keys of its
ok flags and capacities, its kernel notes and its device cost
(``obs/devprof``). What makes a repeat query cheap is the capacity
memory beside the cache (``engine._caps_memory``, keyed by the same
base key): a program starts from the capacity vector that succeeded
last time instead of climbing the ladder again
(``exec/executor.prepare_plan``).

The persistent store (``PRESTO_TPU_PROGRAM_CACHE_DIR``, bounded by
``PRESTO_TPU_PROGRAM_CACHE_DISK_BYTES``) carries both across engines,
processes and workers sharing the directory: each successful program's
meta, with its counted cost, as a plain JSON entry named by
:func:`entry_digest` of its key and :func:`platform_fingerprint`, and
the reference's ``.caps.json`` sidecar of the successful capacity
vector (``[pos, kind, cap]`` rows) under the base key. A fresh engine
reads the sidecar, starts at that vector (no rung) and finds its
entry, whose cost spares the first pass its count. Writes are atomic
(a tmp file, then ``os.replace``); past the budget the oldest files
go. An entry that is corrupt, of another format or stored under
another key counts a load error and a miss and is unlinked: the
ladder runs as without the store, and rows never depend on it. Entries
hold no pickle: nothing in a shared directory runs code on load.

Key canonicalization follows the reference: capacities go to pow2
buckets (:func:`bucket_capacities`); the session component holds only
the properties the interpreter reads (:data:`TRACE_RELEVANT_PROPERTIES`,
resolved through ``Session.get``); dictionary contents take part
(:func:`dictionary_token`), since a program's meta carries the decode
dictionaries.

Left out (ROADMAP): the reference's serialized executables (eager
PyTorch has none to store), ``map_parallel`` (there is no compile to
run in parallel) and CUDA-graph capture.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import threading

from presto_tpu_torch.obs.metrics import REGISTRY
from presto_tpu_torch.ops.sizes import next_pow2

ENV_DIR = "PRESTO_TPU_PROGRAM_CACHE_DIR"

_HITS = REGISTRY.counter(
    "presto_tpu_program_cache_hits_total",
    "program cache hits, labeled tier=memory|disk")
_MISSES = REGISTRY.counter(
    "presto_tpu_program_cache_misses_total",
    "program cache misses")
_DISK_ERRORS = REGISTRY.counter(
    "presto_tpu_program_cache_disk_errors_total",
    "persistent-store failures (the ladder runs as without the store), "
    "labeled op=load|store")
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

# Ambient reads the tracekey provenance analysis (lint/tracekey.py)
# sees inside a program's pass that are DELIBERATELY not part of the
# key, each with the soundness argument. Ids are the rule's finding ids
# (``session:<prop>``, ``env:<NAME>``, ``global:<relpath>:<NAME>``,
# ``key:<prop>``); an entry that stops matching a finding becomes a
# ``stale-exemption`` finding itself, so this registry cannot rot into
# a blanket waiver.
TRACE_KEY_EXEMPT = {
    "global:presto_tpu_torch/expr/compile.py:_DATE_FORMAT_CACHE":
        "pure memoization keyed by the date_format literal: the LUT "
        "is a content-only function of the format string, which is "
        "structural (never hoisted by templates/analysis.py) and so "
        "participates in the plan fingerprint",
    "env:CUDA_HOME":
        "kernels/build.nvcc_path picks the compiler that builds the "
        "kernels' shared library, only when no library for the "
        "current sources and NVCC_FLAGS exists yet (its file name is "
        "their digest); every nvcc builds the same sm_90a kernels "
        "from them, and a cache entry holds capacities, a layout and "
        "kernel notes, never code",
    "env:CUDA_PATH":
        "read beside CUDA_HOME by kernels/build.nvcc_path, as a "
        "fallback name for the same toolkit directory: the same "
        "argument holds",
}

DEFAULT_MAX_ENTRIES = 64
# the persistent store's budget: past it the oldest files are pruned
# (after each entry written); the store gathers entries across schema,
# scale, session and platform variations forever otherwise
DISK_BYTES_LIMIT = int(os.environ.get(
    "PRESTO_TPU_PROGRAM_CACHE_DISK_BYTES", 32 << 30))


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


# the stored entries' format: it takes part in the platform
# fingerprint, so an entry of another format lands at another digest
# (a clean miss), and each entry carries it too (an entry of another
# format found at this digest is a load error and a miss). "meta1":
# JSON meta with the program's counted device cost
PROGRAM_FORMAT = "meta1"


@functools.lru_cache(maxsize=32)
def platform_fingerprint(device: str, backend: str) -> tuple:
    """What a program's meta is valid for: torch's and CUDA's versions,
    the device's name and count, the stored entries' format and the
    resolved kernel backend."""
    import torch
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    return (torch.__version__, torch.version.cuda,
            torch.cuda.get_device_name(dev) if cuda else device,
            torch.cuda.device_count() if cuda else 1,
            PROGRAM_FORMAT, f"kernels-{backend}")


def entry_digest(key, fingerprint) -> str:
    """Content address of one (key, platform fingerprint) pair in the
    persistent store."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((key, fingerprint)).encode())
    return h.hexdigest()


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


def _meta_to_json(meta: dict) -> dict:
    """A program's meta as plain JSON: dtypes as strings, tuple keys as
    rows."""
    return {"out": [[sym, str(dtype), bool(valid)]
                    for sym, dtype, valid in meta["out"]],
            "ok_keys": [list(k) for k in meta["ok_keys"]],
            "used_capacity": [[*k, int(cap)]
                              for k, cap in meta["used_capacity"].items()],
            "kernels": [[pos, list(tags)]
                        for pos, tags in meta["kernels"].items()],
            "cost": meta.get("cost")}


def _meta_from_json(doc: dict) -> dict:
    """The inverse of :func:`_meta_to_json` (dtypes stay strings);
    raises on a malformed entry."""
    return {"out": [(str(sym), str(dtype), bool(valid))
                    for sym, dtype, valid in doc["out"]],
            "ok_keys": [(int(pos), str(kind))
                        for pos, kind in doc["ok_keys"]],
            "used_capacity": {(int(pos), str(kind)): int(cap)
                              for pos, kind, cap in doc["used_capacity"]},
            "kernels": {int(pos): [str(t) for t in tags]
                        for pos, tags in doc["kernels"]},
            "cost": (None if doc["cost"] is None
                     else {str(k): v for k, v in doc["cost"].items()})}


class ProgramCache:
    """Bounded in-memory LRU of program meta over an optional
    persistent store (``disk_dir``; from ``PRESTO_TPU_PROGRAM_CACHE_DIR``
    when None)."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 disk_dir: str | None = None):
        self._lock = threading.Lock()
        # key -> meta; insertion order = LRU order
        self._entries: dict = {}
        self.max_entries = max(1, int(max_entries))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        if disk_dir is None:
            disk_dir = os.environ.get(ENV_DIR) or None
        self.disk_dir = disk_dir

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "disk_dir": self.disk_dir}

    def configure(self, session) -> None:
        """Refresh the entry bound from the session (SET SESSION
        program_cache_entries takes effect on the next query)."""
        limit = int(session.get("program_cache_entries") or 0)
        if limit <= 0:
            return
        with self._lock:
            self.max_entries = max(1, limit)
            self._trim()

    def lookup(self, key, fingerprint: tuple | None = None):
        """The meta stored under ``key``, or None: the memory tier
        first, then the store (an entry read there is promoted into
        memory). Counts one hit, labeled by tier, or one miss."""
        with self._lock:
            meta = self._entries.pop(key, None)
            if meta is not None:
                self._entries[key] = meta  # re-append: most recent
                self.hits += 1
        if meta is not None:
            _HITS.inc(tier="memory")
            return meta
        meta = self._disk_load(key, fingerprint)
        if meta is None:
            with self._lock:
                self.misses += 1
            _MISSES.inc()
            return None
        with self._lock:
            self.hits += 1
        self._remember(key, meta)
        _HITS.inc(tier="disk")
        return meta

    def insert(self, key, meta, fingerprint: tuple | None = None) -> None:
        """Keep a program's meta, and write it to the store when there
        is one. The ladders insert only the rung that succeeded, so
        every insert persists (the reference's ``persist=False`` rungs
        have no counterpart here)."""
        if self.disk_dir:
            self._disk_store(key, meta, fingerprint)
        self._remember(key, meta)

    def discard(self, key, fingerprint: tuple | None = None) -> None:
        """Drop one entry from both tiers without counting an eviction:
        a program whose remembered vector overflowed on new data of
        the same shape grows past it, and its sidecar then names the
        new vector, so the old entry is never looked up again."""
        with self._lock:
            if self._entries.pop(key, None) is not None:
                _ENTRIES_G.dec()
        if self.disk_dir:
            self._unlink(self._path(entry_digest(key, fingerprint),
                                    ".prog.json"))

    def _remember(self, key, meta) -> None:
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

    # -- the persistent store ------------------------------------------------

    def _path(self, digest: str, suffix: str) -> str:
        return os.path.join(self.disk_dir, digest + suffix)

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass  # another process got there first

    def _write(self, path: str, doc) -> None:
        """Write ``doc`` as JSON to ``path`` atomically: concurrent
        writers in other processes and threads race only to replace
        the file with the same content."""
        os.makedirs(self.disk_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def _disk_load(self, key, fingerprint) -> dict | None:
        """The meta stored under ``key``, or None when the store has no
        such entry. An entry that cannot be read, is of another format
        or was stored under another key counts a load error and is
        unlinked (the next success writes it again)."""
        if not self.disk_dir:
            return None
        path = self._path(entry_digest(key, fingerprint), ".prog.json")
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc["format"] != PROGRAM_FORMAT or doc["key"] != repr(key):
                raise ValueError("stale entry or digest collision")
            meta = _meta_from_json(doc["meta"])
        except FileNotFoundError:
            return None
        except Exception:  # noqa: BLE001 - a bad entry is a miss
            _DISK_ERRORS.inc(op="load")
            self._unlink(path)
            return None
        return meta

    def _disk_store(self, key, meta, fingerprint) -> None:
        """Write one entry, then prune the store to its budget. A
        failure is counted and the query goes on."""
        try:
            self._write(
                self._path(entry_digest(key, fingerprint), ".prog.json"),
                {"format": PROGRAM_FORMAT, "key": repr(key),
                 "meta": _meta_to_json(meta)})
        except Exception:  # noqa: BLE001 - never fail the query
            _DISK_ERRORS.inc(op="store")
            return
        self._prune_disk()

    def _prune_disk(self) -> None:
        """Best-effort budget: drop the oldest files (by mtime) past
        DISK_BYTES_LIMIT. Concurrent processes may race to unlink the
        same file; losing is fine."""
        try:
            files, total = [], 0
            with os.scandir(self.disk_dir) as it:
                for de in it:
                    if de.name.endswith((".prog.json", ".caps.json")):
                        st = de.stat()
                        files.append((st.st_mtime, st.st_size, de.path))
                        total += st.st_size
            for _mtime, size, path in sorted(files):
                if total <= DISK_BYTES_LIMIT:
                    break
                self._unlink(path)
                total -= size
        except OSError:
            pass

    # -- the capacity sidecar ------------------------------------------------

    def load_caps(self, base_key, fingerprint: tuple | None = None) -> dict:
        """The successful capacity vector stored for a program, so a
        fresh engine skips the ladder; {} when there is none. A sidecar
        that cannot be read counts a load error and is unlinked."""
        if not self.disk_dir:
            return {}
        path = self._path(entry_digest(base_key, fingerprint),
                          ".caps.json")
        try:
            with open(path, encoding="utf-8") as f:
                rows = json.load(f)
            return {(int(pos), str(kind)): int(cap)
                    for pos, kind, cap in rows}
        except FileNotFoundError:
            return {}
        except Exception:  # noqa: BLE001 - a bad sidecar = no caps
            _DISK_ERRORS.inc(op="load")
            self._unlink(path)
            return {}

    def store_caps(self, base_key, caps: dict,
                   fingerprint: tuple | None = None) -> None:
        """Write a program's successful capacity vector as the
        reference's ``[pos, kind, cap]`` rows."""
        if not self.disk_dir or not caps:
            return
        try:
            self._write(
                self._path(entry_digest(base_key, fingerprint),
                           ".caps.json"),
                [[int(pos), str(kind), int(cap)]
                 for (pos, kind), cap in sorted(caps.items())])
        except Exception:  # noqa: BLE001 - the sidecar is best-effort
            _DISK_ERRORS.inc(op="store")
