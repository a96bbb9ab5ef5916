"""Profiling and observability (port of gns_tpu/utils/profiling.py).

The program's tracer: host spans and counters that the serving and training
paths record around the calls where their work happens, a torch.profiler
trace that puts them on one timeline with the device's kernels, and a NaN
guard. The reference's only instrumentation is perf_counter around
inference (GNS/evaluate.py:33-36).

Spans and counters record only while `recording()` is open or a
torch.profiler session is recording; otherwise a span is one flag check
and a shared do-nothing context. They are host-only: no profiler
annotation, no CUDA event, no synchronise, so they neither add device
activity to a trace nor disturb a CUDA graph being captured. Each span
records its name, its start and end on the profiler's clock (time.time_ns,
unix ns), its parent span and its unit: the id of the root span that
caused it (one per GNSPredictor.predict call, one per epoch call). The
last RING spans and counts are kept in memory.

Spans of the serving path (serve.py, utils/prepare.py):

    serve.predict    the root, one per predict call
      pack.prepare   batch_from_cases' pass over the cases: natively
                     (utils/native.py pack_batch) each table's address and
                     shape, any table converted to float64; else the
                     per-grid prepare_case calls
      pack.stack     the grids into one padded batch: natively the C call
                     that converts and pads (counter pack.native_batches,
                     one a batch); else _stack_to_batch
      pack.topology  extract_shared_topology and is_dense
      serve.graph    the index sets (counter serve.index_builds on a build)
      serve.upload   batch_tensors: the batch copied to the device
      serve.forward  gns_forward, host side: the kernels queued
        model.step   one of the K correction steps (models/gns.py
                     run_steps), host side; a single-phi step adds one to
                     counter model.single_phi_sums
      serve.readback v, theta and last_loss to the host (waits for the device)
      serve.decode   align_slack_angle, one call a request (counter
                     serve.batched_decodes)

and of the training epoch (train/trainer.py make_epoch_step):

    train.epoch      the root, one per epoch call
      train.capture  a CUDA graph captured (counter train.captures)
      train.copy_in  a batch copied into the graph's static inputs
      train.replay   CUDAGraph.replay
      train.step     an eager update step (no shared topology, or the CPU)

with K model.step spans inside each train.step. A capture's forwards (its
warm-ups and the captured one) record no model.step span, since they are
the capture's set-up; each of them adds K to model.single_phi_sums, as it
builds the aggregations. A replay runs no Python and records neither.

A request's or an epoch's breakdown:

    from gns_torch.utils import profiling

    with profiling.recording():
        predictor.predict(cases)
    rec = profiling.recorded()
    rec.seconds()   # {"serve.predict": ..., "pack.prepare": ..., ...}
    rec.counted()   # {"serve.index_builds": 0}

and on one timeline with the device's kernels (Chrome / Perfetto):

    with profiling.trace("build/torch_trace"):
        predictor.predict(cases)

writes trace.json with the program's spans on a track of their own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 65_536  # spans (and, apart, counts) kept in memory

DEFAULT_TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_trace",
)
TRACE_PID = 0x6E5  # the trace.json process whose track holds the program's spans


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(): the clock of the profiler's events
    end_ns: int
    id: int
    parent: int  # the enclosing span's id; 0 for a root
    unit: int  # the root's id: every span one root caused shares it


class Count(NamedTuple):
    name: str
    t_ns: int
    n: int
    unit: int  # the unit of the innermost open span; 0 where none was open


class Recorded(NamedTuple):
    """What the tracer holds: spans in the order they ended, counts in the
    order they were made."""

    spans: List[Span]
    counts: List[Count]

    def seconds(self, unit: Optional[int] = None) -> Dict[str, float]:
        """Seconds per span name, of one unit or of all."""
        out = collections.defaultdict(float)
        for s in self.spans:
            if unit is None or s.unit == unit:
                out[s.name] += (s.end_ns - s.start_ns) / 1e9
        return dict(out)

    def counted(self, unit: Optional[int] = None) -> Dict[str, int]:
        """Each counter's total, of one unit or of all."""
        out = collections.defaultdict(int)
        for c in self.counts:
            if unit is None or c.unit == unit:
                out[c.name] += c.n
        return dict(out)


class _Off:
    """The context a span is while nothing records: shared, does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "id", "parent", "unit", "start")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        stack = self.tracer._stack()
        self.id = next(self.tracer._ids)
        self.parent, self.unit = (stack[-1].id, stack[-1].unit) if stack else (0, self.id)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.tracer._stack().pop()
        self.tracer._spans.append(
            Span(self.name, self.start, end, self.id, self.parent, self.unit))
        return False


class Tracer:
    """Spans and counts in bounded rings of `ring` entries each. The
    module's functions use one process-wide tracer; a test may make its
    own."""

    def __init__(self, ring: int = RING):
        self._spans = collections.deque(maxlen=ring)
        self._counts = collections.deque(maxlen=ring)
        self._ids = itertools.count(1)
        self._local = threading.local()  # .open: this thread's open spans
        self._depth = 0  # open recording() blocks
        self._lock = threading.Lock()  # guards _depth

    def _stack(self) -> list:
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open

    def span(self, name: str, outside: Optional[str] = None):
        """A context manager timing the block as span `name`, if anything
        records when it is entered and, given `outside`, no span of that
        name is open on this thread."""
        if self._depth or _autograd_profiler._is_profiler_enabled:
            if outside is None or all(s.name != outside for s in self._stack()):
                return _Span(self, name)
        return _OFF

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name`, if anything records."""
        if self._depth or _autograd_profiler._is_profiler_enabled:
            stack = self._stack()
            self._counts.append(Count(name, time.time_ns(), n, stack[-1].unit if stack else 0))

    @contextlib.contextmanager
    def recording(self):
        """Record spans and counts inside the block. The outermost block
        starts a fresh record."""
        with self._lock:
            if not self._depth:
                self._spans.clear()
                self._counts.clear()
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1

    def recorded(self) -> Recorded:
        return Recorded(list(self._spans), list(self._counts))


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
recording = _TRACER.recording
recorded = _TRACER.recorded


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    and write a Chrome / Perfetto trace to `log_dir`/trace.json, with the
    program's spans of the session as complete events on a track of their
    own ("gns_torch spans") and its counts as counter events, on the
    profiler's clock. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_program_track(path, recorded(), prof.profiler.kineto_results.trace_start_ns())


def _add_program_track(path: str, rec: Recorded, start_ns: int) -> None:
    """Append to the Chrome trace at `path` the spans and counts recorded
    from start_ns on. The file's "ts" are microseconds after its
    baseTimeNanoseconds (absolute where it has none), on the clock of
    time.time_ns."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": TRACE_PID,
                   "args": {"name": "gns_torch spans"}})
    for s in sorted(rec.spans, key=lambda s: s.start_ns):
        if s.start_ns >= start_ns:
            events.append({"ph": "X", "cat": "gns_torch", "name": s.name, "pid": TRACE_PID,
                           "tid": 1, "ts": (s.start_ns - base) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": {"id": s.id, "parent": s.parent, "unit": s.unit}})
    totals = collections.defaultdict(int)
    for c in rec.counts:
        if c.t_ns >= start_ns:
            totals[c.name] += c.n
            events.append({"ph": "C", "name": c.name, "pid": TRACE_PID, "ts": (c.t_ns - base) / 1e3,
                           "args": {c.name: totals[c.name]}})
    with open(path, "w") as f:
        json.dump(doc, f)


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError if any tensor in `tree` (a tensor, a
    module's state_dict, or nested dicts / lists / tuples of tensors or
    arrays) holds a NaN or an Inf; the message names its path."""
    import numpy as np

    def walk(node, path):
        if isinstance(node, torch.nn.Module):
            node = node.state_dict()
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}[{i}]")
        elif node is not None:
            yield path, node

    for path, leaf in walk(tree, ""):
        if torch.is_tensor(leaf):
            ok = bool(torch.isfinite(leaf).all()) if leaf.is_floating_point() else True
        else:
            ok = bool(np.all(np.isfinite(np.asarray(leaf))))
        if not ok:
            raise FloatingPointError(f"non-finite values in {name}{path}")
