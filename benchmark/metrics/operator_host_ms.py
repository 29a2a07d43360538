"""The host's walk of the plan: milliseconds of the port's ``pass``
spans (one interpreter pass of a program: torch-op dispatch and the
operators' host work, such as a dictionary union) a query, over the
window's last 256 queries, not the whole window: the traces the port's
tracer still holds (``harness/spans.py``). Nothing off the card, for a
program without these spans, where the tracer does not hold one trace
for each of those queries, or where it dropped a span."""

from harness import spans


def read(run):
    t = spans.window(run)
    return None if t is None else 1e3 * t["pass_s"] / t["queries"]
