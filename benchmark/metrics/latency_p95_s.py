"""The 95th percentile of every query's latency in the window, from
the client's call to ``Engine.execute`` until its rows are back on the
host (nearest rank)."""

import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
