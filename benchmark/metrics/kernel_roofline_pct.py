"""The kernels' share of their memory roofline: over every launch of a
kernel entry in the traced window, the bytes it needs
(harness/roofline.py) at the card's HBM rate, over the launches'
device seconds: the sum of the device activity each entry launched, in
the profiler's trace (harness/record.split). Nothing where no kernel
launched, the trace could not be split or the card's peak is not in
the table."""


def read(run):
    t = run.trace
    if t is None or t.launch_s <= 0 or not t.hbm_bytes_per_s:
        return None
    return 100.0 * (t.launch_bytes / t.hbm_bytes_per_s) / t.launch_s
