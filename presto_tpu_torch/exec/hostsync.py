"""The designated host/device transfer boundary — the port of
``presto_tpu/exec/hostsync.py``.

Every deliberate device->host read on the execute path goes through
this module: ``fetch``, one batched copy of an arbitrary tree of
tensors. Each call counts
one sync against its call site in :data:`SYNCS`, so a run can show
that a query syncs a bounded, constant number of times, and the bytes
it brought back in ``presto_tpu_fetch_bytes_total``. No operator reads
a tensor on the host.

Every host->device copy of host data on the execute path goes through
``upload``: it pins the array and copies it without blocking, so the
host does not wait for the stream to drain (a copy from pageable
memory does), and counts it against its call site in :data:`UPLOADS`
and its bytes in ``presto_tpu_upload_bytes_total``.

Inside an open trace (obs/trace.py) each fetch and each counted upload
is a span, ``fetch`` or ``upload``, with its ``site`` and ``bytes``.

The ``device-sync`` lint (lint/devicesync.py) enforces the boundary
statically: any host-blocking sync on the execute path OUTSIDE this
module is a finding. Deliberate exceptions are declared in
``DEVICE_SYNC_EXEMPT`` below (id -> justification) and carry the same
staleness discipline as ``exec/progcache.TRACE_KEY_EXEMPT``: an entry
that matches no finding is itself a finding.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

import numpy as np
import torch

from presto_tpu_torch.obs.metrics import REGISTRY, Counter
from presto_tpu_torch.obs.trace import TRACER


class SyncCounter:
    """Transfers per call site, and their bytes per site in a registry
    counter (``/metrics`` serves it, labelled by ``site``)."""

    def __init__(self, bytes_counter: Counter):
        self._lock = threading.Lock()
        self.by_site: dict[str, int] = {}
        self.bytes = bytes_counter

    def inc(self, site: str, nbytes: int = 0) -> None:
        with self._lock:
            self.by_site[site] = self.by_site.get(site, 0) + 1
        self.bytes.inc(nbytes, site=site)

    def total(self) -> int:
        with self._lock:
            return sum(self.by_site.values())

    def bytes_total(self) -> int:
        return int(self.bytes.total())


SYNCS = SyncCounter(REGISTRY.counter(
    "presto_tpu_fetch_bytes_total",
    "bytes hostsync.fetch copied from the device to the host, by site"))
# host->device copies, none of them a sync
UPLOADS = SyncCounter(REGISTRY.counter(
    "presto_tpu_upload_bytes_total",
    "bytes hostsync.upload copied from the host to the device, by site"))

# Deliberate syncs OUTSIDE the boundary, id -> justification. Id form:
# "<relpath>:<dotted.unit.path>:<kind>" where kind names the sync
# (synchronize | asarray | item | tolist | cpu | numpy | to_cpu | int |
# float | bool). Stale entries (matching no finding) are findings. The
# reference's entries (its EXPLAIN ANALYZE measurement syncs, its cost
# harvest's floats) have no counterpart: the port's EXPLAIN ANALYZE
# times each program up to its counted fetch, and its cost counts
# (obs/devprof) are host numbers.
DEVICE_SYNC_EXEMPT: dict[str, str] = {}

# the upload memo of a shared_uploads() scope, or None
_SHARED: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "presto_tpu_torch_shared_uploads", default=None)
# the sites whose uploads a shared_uploads() scope shares, and the
# largest array it keys by content
SHARED_SITES = ("literal", "dictionary-lut")
SHARED_MAX_BYTES = 1 << 22


@contextlib.contextmanager
def shared_uploads():
    """Within this scope, an upload of a literal or a dictionary lookup
    whose bytes (dtype, shape, device) were uploaded already returns the
    earlier tensor, uncounted. The shards of a group compile the same
    expressions once each, and only read what those uploads made."""
    tok = _SHARED.set({})
    try:
        yield
    finally:
        _SHARED.reset(tok)


def _to_host(tree, copied: list):
    """``tree`` with each tensor replaced by its numpy copy; the bytes
    of each copy are appended to ``copied``."""
    if isinstance(tree, torch.Tensor):
        out = tree.detach().cpu().numpy()
        copied.append(out.nbytes)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(x, copied) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v, copied) for k, v in tree.items()}
    return tree


def fetch(tree, site: str):
    """One device->host transfer of a tree of tensors (lists, tuples
    and dicts); host leaves pass through unchanged and count no bytes.
    """
    copied: list[int] = []
    with TRACER.span("fetch", site=site) as sp:
        out = _to_host(tree, copied)
    nbytes = sum(copied)
    SYNCS.inc(site, nbytes)
    if sp is not None:
        sp.attrs["bytes"] = nbytes
    return out


def upload(array, device, site: str) -> torch.Tensor:
    """A device tensor holding the host ``array``: on a CUDA device a
    pinned, non-blocking copy (the pinned buffer is held by PyTorch's
    host allocator until the copy has run); on the CPU a copy too, so
    that a write to the host array (an UPDATE of a memory table runs in
    place) never reaches a query that already scans it, as on the card.
    Counts one upload and its bytes against ``site``; an upload that a
    ``shared_uploads`` scope serves from its memo counts nothing. The
    tensor keeps
    the array's shape: a 0-d array (a scalar literal) stays 0-d, so the
    operators' scalar broadcasts see it as a scalar."""
    memo = _SHARED.get()
    if memo is not None and site in SHARED_SITES:
        a = np.require(array, requirements="C")
        if a.dtype != object and a.nbytes <= SHARED_MAX_BYTES:
            key = (site, str(device), a.dtype.str, a.shape, a.tobytes())
            hit = memo.get(key)
            if hit is None:
                hit = memo[key] = _upload(a, device, site)
            return hit
    return _upload(array, device, site)


def _upload(array, device, site: str) -> torch.Tensor:
    device = torch.device(device)
    on_card = device.type == "cuda"
    # a read-only array (a dictionary memo's remap) is copied once on
    # the card too: torch tensors over numpy memory must be writable
    host = (np.require(array, requirements="CW") if on_card
            else np.array(array, order="C", copy=True))
    UPLOADS.inc(site, host.nbytes)
    with TRACER.span("upload", site=site, bytes=host.nbytes):
        if not on_card:
            return torch.from_numpy(host)
        return torch.from_numpy(host).pin_memory().to(device,
                                                      non_blocking=True)
