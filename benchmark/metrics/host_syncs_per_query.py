"""The change in ``exec/hostsync.SYNCS.total()`` over the traced
window, over its queries."""


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    return t.syncs / t.queries
