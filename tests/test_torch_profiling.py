"""gns_torch's profiling module (utils/profiling.py) on the CPU: the
tracer's spans and counts (off by default; on inside `recording()` or a
torch.profiler session; nesting, units, the ring's bound; host-only), the
trace exporter's program track on the profiler's clock, and the NaN
guard."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gns_torch.utils import profiling


def test_spans_are_off_by_default():
    before = profiling.recorded()
    with profiling.span("off.outer"):
        with profiling.span("off.inner"):
            profiling.count("off.count")
    after = profiling.recorded()
    assert after == before
    # off, a span is one shared do-nothing context: nothing is allocated
    assert profiling.span("a") is profiling.span("b")


def test_spans_record_inside_recording():
    with profiling.recording():
        with profiling.span("rec.outer"):
            time.sleep(0.001)
            profiling.count("rec.count", 3)
        profiling.count("rec.count")
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["rec.outer"]
    span = rec.spans[0]
    assert span.end_ns - span.start_ns >= 1_000_000 and span.parent == 0 and span.unit == span.id
    assert rec.counted() == {"rec.count": 4}
    assert rec.counted(span.unit) == {"rec.count": 3}  # the second count had no open span
    assert rec.seconds()["rec.outer"] == pytest.approx((span.end_ns - span.start_ns) / 1e9)
    with profiling.span("rec.after"):
        pass
    assert profiling.recorded() == rec  # closed: nothing more records
    with profiling.recording():
        pass
    assert profiling.recorded().spans == []  # the outermost block starts a fresh record


def test_spans_record_under_the_profiler():
    with profiling.recording():  # a fresh record
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("prof.outer"):
            torch.ones(8).sum()
            profiling.count("prof.count")
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["prof.outer"]
    assert rec.counted() == {"prof.count": 1}
    # host-only: the span is no profiler event (no annotation, no device work)
    assert not [e for e in prof.events() if e.name.startswith("prof.")]


def test_span_tree_nests_and_shares_one_unit_per_root():
    with profiling.recording():
        for _ in range(2):
            with profiling.span("tree.root"):
                with profiling.span("tree.a"):
                    with profiling.span("tree.a1"):
                        profiling.count("tree.count")
                with profiling.span("tree.b"):
                    pass
    rec = profiling.recorded()
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["tree.root", "tree.root"]
    assert roots[0].unit != roots[1].unit
    for s in rec.spans:
        if s.parent:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.unit == parent.unit
    names = {(by_id[s.parent].name if s.parent else None, s.name) for s in rec.spans}
    assert names == {(None, "tree.root"), ("tree.root", "tree.a"), ("tree.a", "tree.a1"),
                     ("tree.root", "tree.b")}
    assert [rec.counted(r.unit) for r in roots] == [{"tree.count": 1}] * 2


def test_span_outside_a_named_span_is_not_kept():
    """span(name, outside=x) records as a span does, except while a span x
    is open on the thread; off, it is the shared do-nothing context."""
    assert profiling.span("quiet", outside="loud") is profiling.span("a")
    with profiling.recording():
        with profiling.span("quiet", outside="loud"):
            pass
        with profiling.span("loud"):
            with profiling.span("mid"):
                with profiling.span("quiet", outside="loud"):
                    profiling.count("quiet.count")
    rec = profiling.recorded()
    assert sorted(s.name for s in rec.spans) == ["loud", "mid", "quiet"]
    assert rec.counted() == {"quiet.count": 1}


def test_ring_is_bounded():
    tracer = profiling.Tracer(ring=8)
    with tracer.recording():
        for i in range(20):
            with tracer.span(f"ring.{i}"):
                tracer.count("ring.count")
    rec = tracer.recorded()
    assert [s.name for s in rec.spans] == [f"ring.{i}" for i in range(12, 20)]
    assert len(rec.counts) == 8
    assert profiling.RING == 65_536


def test_spans_of_threads_nest_apart():
    import threading

    tracer = profiling.Tracer()
    ready = threading.Barrier(2, timeout=10)

    def worker(tag):
        with tracer.span(f"thread.{tag}"):
            ready.wait()
            with tracer.span(f"thread.{tag}.child"):
                ready.wait()

    with tracer.recording():
        threads = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in tracer.recorded().spans}
    for tag in "ab":
        assert spans[f"thread.{tag}.child"].parent == spans[f"thread.{tag}"].id


def test_trace_json_puts_program_spans_on_the_profilers_clock(tmp_path):
    """A program span around a record_function("probe") block encloses the
    probe's event in trace.json to 50 us; counts appear as counter events."""
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.span("clock.outer"):
            with record_function("probe"):
                time.sleep(0.002)
            profiling.count("clock.count", 2)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    probe = [e for e in events if e.get("name") == "probe" and e.get("ph") == "X"]
    outer = [e for e in events if e.get("name") == "clock.outer"]
    assert len(probe) == 1 and len(outer) == 1
    p, o = probe[0], outer[0]
    assert o["pid"] == profiling.TRACE_PID and o["ph"] == "X" and o["cat"] == "gns_torch"
    assert o["ts"] <= p["ts"] + 50 and p["ts"] + p["dur"] <= o["ts"] + o["dur"] + 50
    assert p["dur"] >= 2000
    counter = [e for e in events if e.get("name") == "clock.count"]
    assert len(counter) == 1 and counter[0]["ph"] == "C" and counter[0]["args"] == {
        "clock.count": 2}
    assert counter[0]["pid"] == profiling.TRACE_PID


def test_profiler_flag_is_read_where_the_tracer_reads_it():
    """The tracer decides by torch.autograd.profiler._is_profiler_enabled:
    False outside a session, True inside."""
    import torch.autograd.profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert profiling.span("flag") is not profiling.span("flag")


def test_time_step_trace_and_assert_finite(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as d:
        torch.ones(4).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    profiling.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), torch.arange(3)]})
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]"):
        profiling.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), torch.tensor([np.nan])]})
    model = torch.nn.Linear(2, 2)
    profiling.assert_finite(model, "model")
    with torch.no_grad():
        model.bias.fill_(float("inf"))
    with pytest.raises(FloatingPointError, match="model"):
        profiling.assert_finite(model, "model")


@pytest.mark.parametrize("multiple_phi", [False, True])
def test_model_steps_and_single_phi_sums(multiple_phi):
    """A forward records one model.step span for each of its K steps, and a
    single-phi one counts K model.single_phi_sums (a multi-phi one none):
    in predict, inside serve.forward, and in an eager update step; with
    nothing recording, neither is kept."""
    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.serve import GNSPredictor
    from gns_torch.train import trainer
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    cfg = GNSConfig(K=3, latent_dim=4, hidden_dim=3, multiple_phi=multiple_phi)
    sums = 0 if multiple_phi else cfg.K
    model = GNS(cfg, seed=0, device="cpu")
    pred = GNSPredictor(model, cfg, batch_size=4, align_slack=False, device="cpu")
    cases = list(generate_cases(14, 3, seed=31))
    before = profiling.recorded()
    pred.predict(cases)
    assert profiling.recorded() == before
    with profiling.recording():
        pred.predict(cases)
    rec = profiling.recorded()
    forward = next(s for s in rec.spans if s.name == "serve.forward")
    steps = [s for s in rec.spans if s.name == "model.step"]
    assert len(steps) == cfg.K and all(s.parent == forward.id for s in steps)
    assert rec.counted().get("model.single_phi_sums", 0) == sums

    data = batch_from_cases(cases)
    state = trainer.init_train_state(0, cfg, device="cpu")
    epoch = trainer.make_epoch_step(cfg, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, 2), "cpu")  # two update steps
    with profiling.recording():
        epoch(state, stacked)
    rec = profiling.recorded()
    assert [s.name for s in rec.spans].count("model.step") == 2 * cfg.K
    assert rec.counted().get("model.single_phi_sums", 0) == 2 * sums
