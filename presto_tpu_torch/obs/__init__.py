"""Observability of the port: the thread-safe metrics registry
(``obs.metrics``, a copy of ``presto_tpu/obs/metrics.py``). The program
cache and the plan templates count their hits, misses and evictions
through it."""
