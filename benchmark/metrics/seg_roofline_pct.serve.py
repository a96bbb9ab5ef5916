"""K1 / K2 share of their roofline in the traced window: the sum of each
launch's least time (its bytes at the HBM peak, lib/counts.py) over the
device time of the segment_sum_* and gns_gather_* kernels the profiler
recorded there. The launches are those the benchmark's wrapper noted in
the traced requests, or, for a captured training step, the step's
launches once for each replayed step."""

from benchmark.lib import counts
from benchmark.lib import trace as tr


def _least(launches):
    distinct = {}
    total = 0.0
    for ln in launches:
        if ln.kernel == "K1":
            nbytes = counts.k1_bytes(ln.s, ln.rows, ln.n, ln.d, ln.elem)
        else:
            key = id(ln.ids)
            if key not in distinct:
                ids = ln.ids.long()
                distinct[key] = int(ids[ids >= 0].unique().numel())
            nbytes = counts.k2_bytes(ln.s, distinct[key], ln.rows, ln.d, ln.elem)
        total += counts.least_seconds(nbytes)
    return total


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.launches:
        return None
    device = tr.kernel_seconds(rec.trace, tr.K1_KERNELS, tr.K2_KERNELS)
    if device <= 0:
        return None
    return 100.0 * _least(rec.launches) / device
