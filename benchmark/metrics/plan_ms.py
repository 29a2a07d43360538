"""The engine's own ``plan`` spans (obs/trace.TRACER): their
milliseconds in the traced window over its queries."""


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    return 1e3 * t.plan_s / t.queries
