"""What a traced run (--trace 1) records, all from the benchmark's side:

  * host spans around the program's calls (`Spans`, `wrap`): seconds per
    span name, and a profiler label of the same name;
  * K1 / K2 launches (`Launches`): a wrapper around the two launch
    wrappers of gns_torch/ops/segment_kernels.py that notes each launch's
    shape while it is armed, or, for a captured training step, while the
    step is being captured;
  * one profiler trace of a whole number of requests or epochs
    (`profile`), opened and closed by a spin kernel that is not counted:
    the device activities, the host spans in progress, the traced window
    and the union of the device's busy intervals.

Nothing here is imported or installed in a run with --trace 0.
"""

from __future__ import annotations

import collections
import functools
import time
from contextlib import contextmanager
from typing import Callable, List, NamedTuple

import torch

SPIN_CYCLES = 20_000  # the spin kernel that opens and closes a trace
K1_KERNELS, K2_KERNELS = "segment_sum_", "gns_gather_"


class Spans:
    """Host seconds per span name, each span also a profiler label."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)

    @contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0


def wrap(module, attr: str, wrapper_of: Callable):
    """Replace module.attr by wrapper_of(original), which takes the
    original's attributes (a launch wrapper's `launches` count, which the
    program adds to through the module's name); returns the undo, which
    hands the attributes back."""
    original = getattr(module, attr)
    wrapper = functools.update_wrapper(wrapper_of(original), original)

    def undo():
        original.__dict__.update((k, v) for k, v in wrapper.__dict__.items()
                                 if not k.startswith("__"))
        setattr(module, attr, original)

    setattr(module, attr, wrapper)
    return undo


def in_span(spans: Spans, name: str):
    def wrapper_of(fn):
        def wrapped(*args, **kwargs):
            with spans(name):
                return fn(*args, **kwargs)
        return wrapped
    return wrapper_of


class Launch(NamedTuple):
    kernel: str  # "K1" or "K2"
    s: int
    rows: int  # K1: kept rows summed; K2: gathered rows out
    n: int  # K1: segments; K2: rows of the data gathered from
    d: int
    elem: int
    ids: object  # K2: the ids tensor (distinct rows counted after the run)


class Launches:
    """Notes K1 / K2 launches. armed: note every launch; capture_only:
    note only launches made while a CUDA graph is being captured."""

    def __init__(self, kern):
        self.kern = kern
        self.armed = False
        self.capture_only = False
        self.seen: List[Launch] = []
        self._undo = []

    def _note(self, launch: Launch):
        if self.armed or (self.capture_only and torch.cuda.is_current_stream_capturing()):
            self.seen.append(launch)

    def install(self):
        def k1_of(fn):
            def k1(data, order, indptr, num_segments):
                s, _, d = data.shape
                self._note(Launch("K1", s, order.numel(), num_segments, d,
                                  data.element_size(), None))
                return fn(data, order, indptr, num_segments)
            return k1

        def k2_of(fn):
            def k2(data, ids, masked=False):
                s, r, d = data.shape
                self._note(Launch("K2", s, ids.numel(), r, d, data.element_size(), ids))
                return fn(data, ids, masked)
            return k2

        self._undo = [wrap(self.kern, "segment_sum_cuda", k1_of),
                      wrap(self.kern, "gather_cuda", k2_of)]
        return self

    def uninstall(self):
        for undo in self._undo:
            undo()
        self._undo = []


class Trace(NamedTuple):
    device: list  # (start_us, end_us, name) of every device activity, spins left out
    labels: list  # (start_us, end_us, name) of the benchmark's host spans
    window: tuple  # (start_us, end_us): from the opening spin's end to the closing spin's start
    units: int  # requests or epochs traced


def profile(run_unit: Callable[[], None], units: int, complete: Callable[[list], bool],
            before: Callable[[], None] = lambda: None, attempts: int = 3) -> Trace:
    """Trace `units` calls of run_unit under the profiler (host spans and
    device activity), calling before() ahead of each attempt. A trace
    whose device activity fails complete(activity) is taken again, up to
    `attempts` times; the last is returned either way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    trace = None
    for _ in range(attempts):
        before()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(units):
                run_unit()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        device, spins, labels = [], [], []
        for ev in prof.events():
            lo, hi = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA and ev.name not in LABELS:
                # (a host span's label also shows on the device's timeline:
                # it is no device activity)
                if "spin_kernel" in ev.name:
                    spins.append((lo, hi))
                elif hi > lo:
                    device.append((lo, hi, ev.name))
            elif ev.name in LABELS:
                labels.append((lo, hi, ev.name))
        device.sort()
        spins.sort()
        window = (spins[0][1], spins[-1][0]) if len(spins) >= 2 else (
            (device[0][0], device[-1][1]) if device else (0.0, 0.0))
        device = [a for a in device if window[0] <= a[0] and a[1] <= window[1]]
        trace = Trace(device, labels, window, units)
        if len(spins) >= 2 and device and complete(device):
            break
    return trace


# the host spans that label the device's idle gaps
LABELS = ("request", "pack", "forward", "decode", "epoch", "loss read")


def union(device: list) -> list:
    """The merged busy intervals of (start, end, name) activities."""
    merged = []
    for lo, hi, _ in sorted(device):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def busy_us(device: list) -> float:
    return sum(hi - lo for lo, hi in union(device))


def idle_gaps(trace: Trace) -> list:
    """(label, seconds) of every idle gap of the window, longest first: the
    label is the innermost benchmark span in progress at the gap's middle
    ("host" where none is)."""
    w0, w1 = trace.window
    edges = [w0] + [x for iv in union(trace.device) for x in iv] + [w1]
    gaps = []
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi <= lo:
            continue
        mid = (lo + hi) / 2
        around = [(s, name) for s, e, name in trace.labels if s <= mid <= e]
        gaps.append((max(around)[1] if around else "host", (hi - lo) / 1e6))
    return sorted(gaps, key=lambda g: -g[1])


def device_ops(trace: Trace) -> list:
    """(name, seconds) of device time by activity name, largest first."""
    total = collections.defaultdict(float)
    for lo, hi, name in trace.device:
        total[name] += (hi - lo) / 1e6
    return sorted(total.items(), key=lambda x: -x[1])


def kernel_seconds(trace: Trace, *patterns: str) -> float:
    return sum(hi - lo for lo, hi, name in trace.device
               if any(p in name for p in patterns)) / 1e6


def count_kernels(device: list, *patterns: str) -> int:
    return sum(1 for *_, name in device if any(p in name for p in patterns))
