"""The executor's own host time: milliseconds of each ``execute`` span
not covered by the union of the ``pass`` and ``fetch`` spans inside it
(routing, cache keys, capacity bookkeeping, carriers, uploads, result
demux) a query, over the window's last 256 queries, not the whole
window: the traces the port's tracer still holds
(``harness/spans.py``). Nothing off the card, for a program without
these spans, where the tracer does not hold one trace for each of
those queries, or where it dropped a span."""

from harness import spans


def read(run):
    t = spans.window(run)
    return None if t is None else 1e3 * t["execute_self_s"] / t["queries"]
