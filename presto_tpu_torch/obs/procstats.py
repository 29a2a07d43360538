"""Process self-telemetry gauges, refreshed at ``/metrics`` scrape time
on the coordinator AND the workers: RSS, thread count, and process
uptime read from ``/proc/self`` (no external deps — the reference gets
these for free from the JVM's OperatingSystemMXBean/ThreadMXBean over
JMX). Non-Linux hosts fall back to ``threading.active_count`` and skip
RSS rather than fail the scrape."""

from __future__ import annotations

import threading
import time

from presto_tpu_torch.obs.metrics import REGISTRY

_START = time.time()

_RSS = REGISTRY.gauge(
    "presto_tpu_process_rss_bytes",
    "resident set size of the serving process (/proc/self/status "
    "VmRSS)")
_THREADS = REGISTRY.gauge(
    "presto_tpu_process_threads",
    "live threads in the serving process (/proc/self/status Threads)")
_UPTIME = REGISTRY.gauge(
    "presto_tpu_process_uptime_seconds",
    "seconds since this process imported the engine")


def read_proc_self() -> tuple[int, int]:
    """(rss_bytes, threads) from /proc/self/status; raises OSError off
    Linux."""
    rss = 0
    threads = 0
    with open("/proc/self/status", encoding="ascii",
              errors="replace") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024  # kB
            elif line.startswith("Threads:"):
                threads = int(line.split()[1])
    return rss, threads


def update_process_gauges(node: str) -> None:
    """Refresh the process gauges for ``node``'s scrape (several server
    roles in one process label the same numbers per node, matching the
    rest of the registry's node-labeled gauges)."""
    try:
        rss, threads = read_proc_self()
    except OSError:
        rss, threads = 0, threading.active_count()
    if rss:
        _RSS.set(rss, node=node)
    _THREADS.set(threads or threading.active_count(), node=node)
    _UPTIME.set(time.time() - _START, node=node)
