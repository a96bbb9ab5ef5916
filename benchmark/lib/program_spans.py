"""The program's own spans (gns_torch/utils/profiling.py `recorded()`) on
a traced run's clock.

The program stamps its spans in unix ns, the clock of the profiler's
events; the benchmark's Trace (lib/trace.py) keeps its times in us after
the trace's start, which it does not keep. Each of the benchmark's labels
"request" / "epoch" encloses one call of predict / an epoch call, whose
program root (serve.predict / train.epoch) lies inside it. `mapped` pairs
the host's labels, in order, with the last as many program roots (a
profiling retry leaves earlier roots behind), takes the median offset of
their starts, and maps every span of the paired roots' units onto the
trace's clock. Starts, not ends: a label starts a fixed few tens of us
before its root (the benchmark's span entering), but ends after the call's
frame is torn down, which frees a request's batch (about 1.3 ms on the H100
host) and sometimes runs the collector. So the mapped spans sit early by
that fixed entry, tens of us. `mapped` returns None where the program
recorded nothing (a program without the tracer) or any paired root then
lies outside its label by more than TOLERANCE_US: a broken mapping shows as
a missing reading, not a wrong one. The host's spans and labels share one
clock; the device's activity is stamped by the profiler on another, mapped
onto the host's, so a reader that sets program spans against device
activity also asks `device_aligned`.
"""

from __future__ import annotations

import bisect
import statistics
from typing import NamedTuple, Optional

from benchmark.lib import trace as tr

TOLERANCE_US = 50.0
ROOTS = {"request": "serve.predict", "epoch": "train.epoch"}
# the spans inside which a unit launches its first device work (serve.graph
# only on an index build): none of its device activity starts before the
# earliest of them
LAUNCHING = {"request": ("serve.graph", "serve.upload"),
             "epoch": ("train.capture", "train.copy_in", "train.step")}
# On the H100 the profiler's device timestamps sit up to 11 us off its host
# ones (kernels stamped before the runtime calls that launched them) and
# drift from them by up to 75 us a second, over windows of about a second;
# one traced serving run of twelve read each later request's first kernel
# 0.6-2.9 ms before its upload began, 3 ms a second. The idle gaps a reader
# sorts under program spans are milliseconds long.
DEVICE_TOLERANCE_US = 200.0


class Mapped(NamedTuple):
    spans: list  # (start_us, end_us, name, unit) of the paired units, on the trace's clock
    roots: list  # (start_us, end_us) of each paired root, in the labels' order
    labels: list  # (start_us, end_us) of each label, in order
    units: int  # requests or epochs paired


def program_record():
    """The program's recorded spans and counts, or None where the program
    has no tracer."""
    try:
        from gns_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded()


def mapped(trace, label: str, record=None) -> Optional[Mapped]:
    """The program's spans under the trace's `label`s on the trace's clock
    (see the module's doc); record: the program's record (default: read
    from the program)."""
    if trace is None:
        return None
    record = program_record() if record is None else record
    if record is None:
        return None
    labels = host_labels(trace, label)
    roots = sorted((s for s in record.spans if s.parent == 0 and s.name == ROOTS[label]),
                   key=lambda s: s.start_ns)
    if not labels or len(roots) < len(labels):
        return None
    roots = roots[-len(labels):]
    ref = roots[0].start_ns  # times relative to it keep float64's precision

    def us(ns):
        return (ns - ref) / 1e3

    offset = statistics.median(lo - us(s.start_ns) for (lo, _), s in zip(labels, roots))
    spans_on = [(us(s.start_ns) + offset, us(s.end_ns) + offset) for s in roots]
    if any(a < lo - TOLERANCE_US or b > hi + TOLERANCE_US
           for (a, b), (lo, hi) in zip(spans_on, labels)):
        return None
    units = {s.unit for s in roots}
    spans = sorted((us(s.start_ns) + offset, us(s.end_ns) + offset, s.name, s.unit)
                   for s in record.spans if s.unit in units)
    return Mapped(spans, spans_on, labels, len(labels))


def device_aligned(trace, m: Mapped, label: str) -> bool:
    """Whether the trace's device activity sits where the host launched
    and awaited it, on `m`'s mapping, to DEVICE_TOLERANCE_US: what starts
    from one label's start to the next one's starts no earlier than the
    unit's first launching span (LAUNCHING), and ends before the next label
    starts (the unit's call, or the loss read after an epoch, waited for
    it)."""
    units = [unit for _, _, name, unit in m.spans if name == ROOTS[label]]
    launch = {}
    for a, _, name, unit in m.spans:
        if name in LAUNCHING[label]:
            launch[unit] = min(launch.get(unit, a), a)
    starts = [a for a, _, _ in trace.device]  # Trace keeps them sorted
    bounds = [lo for lo, _ in m.labels] + [float("inf")]
    for i, unit in enumerate(units):
        acts = trace.device[bisect.bisect_left(starts, bounds[i]):
                            bisect.bisect_left(starts, bounds[i + 1])]
        if not acts:
            continue
        if unit in launch and acts[0][0] < launch[unit] - DEVICE_TOLERANCE_US:
            return False
        if max(b for _, b, _ in acts) > bounds[i + 1] + DEVICE_TOLERANCE_US:
            return False
    return True


def host_labels(trace, label: str) -> list:
    """(start_us, end_us) of the host's `label` spans, in order. The trace
    also holds each label as the device shows it, from the first device
    activity launched inside it to the last one's end, which starts inside
    the host's label; the host's labels of one name never overlap one
    another. So the host's are the chain from the earliest, each the next
    label to start after the last one taken has ended."""
    chain = []
    for lo, hi in sorted((lo, hi) for lo, hi, name in trace.labels if name == label):
        if not chain or lo >= chain[-1][1]:
            chain.append((lo, hi))
    return chain


def ms_per_unit(m: Optional[Mapped], name: str) -> Optional[float]:
    """Host ms per paired unit in spans named `name`."""
    if m is None:
        return None
    return sum(b - a for a, b, n, _ in m.spans if n == name) / 1e3 / m.units


def idle_intervals(trace) -> list:
    """(start_us, end_us) of every idle gap of the traced window."""
    w0, w1 = trace.window
    edges = [w0] + [x for iv in tr.union(trace.device) for x in iv] + [w1]
    return [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]


def inside(intervals: list, t: float) -> bool:
    """Whether t lies in one of the sorted, disjoint (start, end) intervals."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]
