"""Spooled exchange: task output pages persisted for fault tolerance.

The analog of Trino's fault-tolerant spooling exchange (the
``exchange.base-directories`` filesystem exchange behind
``retry-policy=TASK``): a worker running a buffered fragment task
writes every page it emits into a worker-local spool directory
(atomic tmp+rename, the progcache discipline) alongside the in-memory
OutputBuffer.

Arrow pages persist as Arrow IPC **files** (``p*.arrow``): the
producer's already-encoded batch is re-framed with the IPC file footer
— the buffers are referenced, never value-decoded — and consumers are
served straight off ``mmap`` (pyarrow ``memory_map``): exchange
REPAIR, retried consumers, and stats replay stream spooled bytes from
the page cache with ZERO deserialization and zero heap copies on the
serving worker (PAPERS.md 2204.03032: columnar IPC saturates the link
once serde leaves the path). npz pages (``p*.page``, the
mixed-version fallback) are mmap-served verbatim the same way.

The spool serves through the EXISTING exchange HTTP surface: the
worker results endpoint falls back to the spool when the in-memory
buffer is gone (evicted, task deleted, or the page already freed by a
prior reader's acks), so a TASK retry can re-fetch a dead producer's
pages from any worker sharing the spool directory instead of aborting
the query ("buffers on the dead node are lost") or recomputing the
task.

Layout: ``{dir}/{task_id}/p{partition}.{index:06d}.arrow`` (or
``.page``) plus a ``COMPLETE.json`` marker carrying per-partition page
counts and row counts; a task without the marker is not served (a
half-spooled failed attempt must never feed a consumer — stale
attempts are additionally unreachable because retries get fresh
attempt-versioned task ids).
"""

from __future__ import annotations

import json
import mmap as _mmap
import os
import re
import shutil
import threading

from presto_tpu_torch.obs.metrics import REGISTRY

_SPOOLED_PAGES = REGISTRY.counter(
    "presto_tpu_spooled_pages_total",
    "task output pages persisted to the exchange spool (ft/spool.py)")
_SPOOL_SERVED = REGISTRY.counter(
    "presto_tpu_spool_served_pages_total",
    "exchange pages served from the spool instead of a live buffer")
_SPOOL_MMAP = REGISTRY.counter(
    "presto_tpu_spool_mmap_served_pages_total",
    "spooled pages served zero-copy off an mmap of the page cache "
    "(no deserialize, no heap copy on the serving worker)")

_TASK_ID_RE = re.compile(r"^[A-Za-z0-9._\-]+$")

COMPLETE_MARKER = "COMPLETE.json"


def _safe(task_id: str) -> str:
    if not _TASK_ID_RE.match(task_id):
        raise ValueError(f"unspoolable task id {task_id!r}")
    return task_id


def _mmap_bytes(path: str):
    """A read-only memoryview over the file's mapping: the HTTP
    handler writes it to the socket straight off the page cache (no
    heap copy, no deserialize); the view keeps the map alive."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return memoryview(b"")
        mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    return memoryview(mm)


class TaskSpool:
    """One worker's spool directory (may be shared between workers —
    any worker with the directory can serve any spooled task)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    # -- producer side ---------------------------------------------------

    def writer(self, task_id: str) -> "SpoolWriter":
        return SpoolWriter(self, _safe(task_id))

    # -- consumer side ---------------------------------------------------

    def _task_dir(self, task_id: str) -> str:
        return os.path.join(self.directory, _safe(task_id))

    def complete_meta(self, task_id: str) -> dict | None:
        """The completion marker, or None when the task is absent or
        was never completed (do not serve half-spooled output)."""
        try:
            with open(os.path.join(self._task_dir(task_id),
                                   COMPLETE_MARKER),
                      encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _page_path(self, task_id: str, partition: int,
                   token: int) -> str:
        base = os.path.join(self._task_dir(task_id),
                            f"p{partition}.{token:06d}")
        arrow = f"{base}.arrow"
        if os.path.exists(arrow):
            return arrow
        return f"{base}.page"

    def page(self, task_id: str, partition: int,
             token: int) -> tuple[memoryview | None, int, bool]:
        """Same (blob, next_token, complete) contract as
        OutputBuffer.page, served off a read-only mmap of the page file
        (zero deserialization — arrow pages go to the socket in their
        IPC file form, which any current reader parses zero-copy).
        Raises FileNotFoundError when the task is not spooled (caller
        404s)."""
        meta = self.complete_meta(task_id)
        if meta is None:
            raise FileNotFoundError(task_id)
        npages = int(meta["pages"].get(str(partition), 0))
        if token >= npages:
            return None, token, True
        blob = _mmap_bytes(self._page_path(task_id, partition, token))
        _SPOOL_SERVED.inc()
        _SPOOL_MMAP.inc()
        return blob, token + 1, False

    def replay_columns(self, task_id: str, partition: int):
        """Decode one spooled partition into ({name: Column}, rows):
        the REPAIR/stats-replay convenience over the mmap'd pages —
        arrow page files parse into zero-copy views of the page cache,
        so a replay costs no deserialization beyond the final
        assembly."""
        from presto_tpu_torch.parallel.wire import pages_to_columns
        meta = self.complete_meta(task_id)
        if meta is None:
            raise FileNotFoundError(task_id)
        blobs = []
        for token in range(int(meta["pages"].get(str(partition), 0))):
            blobs.append(_mmap_bytes(
                self._page_path(task_id, partition, token)))
            _SPOOL_SERVED.inc()
            _SPOOL_MMAP.inc()
        return pages_to_columns(blobs)

    def rows(self, task_id: str) -> list[int] | None:
        meta = self.complete_meta(task_id)
        return None if meta is None else list(meta["rows"])

    # -- lifecycle -------------------------------------------------------

    def delete_prefix(self, prefix: str) -> None:
        """Drop every spooled task whose id starts with ``prefix``
        (query cleanup: one query's tasks share the query-id prefix)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if name.startswith(prefix):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def delete_exact(self, task_id: str) -> None:
        """Drop exactly one spooled task (the speculation loser-cancel
        path: a losing primary's id is a PREFIX of its winning
        attempt-versioned duplicate, so prefix deletion would wipe the
        winner's pages too)."""
        shutil.rmtree(self._task_dir(task_id), ignore_errors=True)


class SpoolWriter:
    """Per-task page writer. Page indices are assigned here (the
    buffer's emit loop is single-threaded per task, but partitions
    interleave); writes are atomic tmp+rename so a concurrently
    crashing worker never leaves a torn page for a peer to serve."""

    def __init__(self, spool: TaskSpool, task_id: str):
        self.spool = spool
        self.task_id = task_id
        self.dir = os.path.join(spool.directory, task_id)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}
        os.makedirs(self.dir, exist_ok=True)

    def write(self, partition: int, blob: bytes) -> None:
        """Persist one already-encoded page. Arrow stream pages are
        RE-FRAMED (not re-encoded: the batch buffers are referenced
        verbatim) into the IPC file form mmap serving wants; npz pages
        write as-is."""
        from presto_tpu_torch.parallel import wire
        body = wire.arrow_file_bytes(blob)
        suffix = ".arrow"
        if body is None:
            body, suffix = blob, ".page"
        with self._lock:
            index = self._counts.get(partition, 0)
            self._counts[partition] = index + 1
        path = os.path.join(self.dir,
                            f"p{partition}.{index:06d}{suffix}")
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(body)
        os.replace(tmp, path)
        _SPOOLED_PAGES.inc()

    def complete(self, rows: list[int]) -> None:
        with self._lock:
            pages = {str(p): n for p, n in self._counts.items()}
        marker = os.path.join(self.dir, COMPLETE_MARKER)
        tmp = f"{marker}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"pages": pages, "rows": list(rows)}, f)
        os.replace(tmp, marker)

    def abort(self) -> None:
        """Drop a failed attempt's pages — they must never be served."""
        shutil.rmtree(self.dir, ignore_errors=True)
