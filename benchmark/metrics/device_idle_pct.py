"""The share of the traced window in which the card ran no kernel and
no copy: one less the union of the CUDA activity in the profiler's
trace over the window's length."""


def read(run):
    t = run.trace
    if t is None or t.busy_s is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
