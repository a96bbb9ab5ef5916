"""Share of the traced window in which no operation ran on the device:
100 x (1 - the union of the device activities over the window), the
window running from the end of the spin kernel that opens the trace to
the start of the one that closes it."""

from benchmark.lib import trace as tr


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    w0, w1 = rec.trace.window
    if w1 <= w0:
        return None
    return 100.0 * (1.0 - tr.busy_us(rec.trace.device) / (w1 - w0))
