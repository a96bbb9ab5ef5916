"""Share of the traced window's device-idle time that falls inside the
epoch calls: 100 x the idle gaps whose middles lie under a program root
"train.epoch" mapped onto the trace (lib/program_spans.py), over all idle
gaps of the window. The rest lies between epoch calls: the per-epoch loss
read and the caller. None where the device's activity is off its launch
(program_spans.device_aligned): the device's clock drifted from the host's.

Under the profiler this reads the tracing's own cost, not the program's:
traced, a CUDA graph's replay is traced kernel by kernel and its host call
takes milliseconds (about 0.1 ms untraced), so the idle it adds lies inside
the epoch calls. It shows where a traced run's idle time lies; it is no
reading of the untraced idle share that train_edges_per_s feels, which has
to be measured without per-kernel tracing of the replay (CUDA events per
epoch against the epoch's wall time)."""

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "train":
        return None
    m = ps.mapped(rec.trace, "epoch")
    if m is None or not ps.device_aligned(rec.trace, m, "epoch"):
        return None
    gaps = ps.idle_intervals(rec.trace)
    total = sum(hi - lo for lo, hi in gaps)
    if total <= 0:
        return None
    inside = sum(hi - lo for lo, hi in gaps if ps.inside(m.roots, (lo + hi) / 2))
    return 100.0 * inside / total
