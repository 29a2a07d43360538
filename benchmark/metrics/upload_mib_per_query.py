"""Bytes the port copied to the device through ``hostsync.upload``, in
MiB a query: the ``bytes`` of its ``upload`` spans (each the amount
that call added to ``UPLOADS.bytes_total()``) over the window's last
256 queries, not the whole window: the traces the port's tracer still
holds (``harness/spans.py``). Nothing off the card, for a program
without these spans, where the tracer does not hold one trace for each
of those queries, or where it dropped a span."""

from harness import spans


def read(run):
    t = spans.window(run)
    return None if t is None else t["upload_bytes"] / 2**20 / t["queries"]
