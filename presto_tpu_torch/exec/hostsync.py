"""The designated host/device transfer boundary — the port of
``presto_tpu/exec/hostsync.py``.

Every deliberate device->host read on the execute path goes through
this module: ``fetch``, one batched copy of an arbitrary tree of
tensors. Each call counts
one sync against its call site in :data:`SYNCS`, so a run can show
that a query syncs a bounded, constant number of times. No operator
reads a tensor on the host.

Every host->device copy of host data on the execute path goes through
``upload``: it pins the array and copies it without blocking, so the
host does not wait for the stream to drain (a copy from pageable
memory does), and counts it against its call site in :data:`UPLOADS`.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class SyncCounter:
    """Transfers per call site."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_site: dict[str, int] = {}

    def inc(self, site: str) -> None:
        with self._lock:
            self.by_site[site] = self.by_site.get(site, 0) + 1

    def total(self) -> int:
        with self._lock:
            return sum(self.by_site.values())


SYNCS = SyncCounter()
UPLOADS = SyncCounter()  # host->device copies, none of them a sync


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def fetch(tree, site: str):
    """One device->host transfer of a tree of tensors (lists, tuples
    and dicts); host leaves pass through unchanged."""
    SYNCS.inc(site)
    return _to_host(tree)


def upload(array, device, site: str) -> torch.Tensor:
    """A device tensor holding the host ``array``: on a CUDA device a
    pinned, non-blocking copy (the pinned buffer is held by PyTorch's
    host allocator until the copy has run); on the CPU the array itself
    as a tensor. Counts one upload against ``site``. The tensor keeps
    the array's shape: a 0-d array (a scalar literal) stays 0-d, so the
    operators' scalar broadcasts see it as a scalar."""
    UPLOADS.inc(site)
    host = torch.from_numpy(np.require(array, requirements="C"))
    device = torch.device(device)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
