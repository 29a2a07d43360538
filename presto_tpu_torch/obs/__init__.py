"""Observability of the port: the thread-safe metrics registry
(``obs.metrics``), the span tracer (``obs.trace``) and the structured
JSON log (``obs.jsonlog``), copies of ``presto_tpu/obs``'s. The program
cache and the plan templates count their hits, misses and evictions
through the registry; ``events.monitored`` opens each traced query's
``query`` span and logs every query's completion."""
