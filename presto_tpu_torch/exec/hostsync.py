"""The designated device-to-host synchronization boundary — the port
of ``presto_tpu/exec/hostsync.py``.

Every deliberate device->host read on the execute path goes through
this module: ``fetch``, one batched copy of an arbitrary tree of
tensors. Each call counts
one sync against its call site in :data:`SYNCS`, so a run can show
that a query syncs a bounded, constant number of times. No operator
reads a tensor on the host.
"""

from __future__ import annotations

import threading

import torch


class SyncCounter:
    """Host syncs per call site."""

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

