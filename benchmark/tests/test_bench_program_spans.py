"""The program's spans on a traced run's clock (lib/program_spans.py), its
check of the device's activity, and the five readers of them, on
synthetic traces on the CPU; on the card, the
captured epoch's spans and a traced serving window whose spans map onto
its trace."""

import time

import pytest

from benchmark import harness
from benchmark.lib import program_spans as ps
from benchmark.lib import trace as tr
from gns_torch.utils.profiling import Count, Recorded, Span

T0 = 1_790_000_000_000_000_000  # unix ns of the synthetic trace's start
SERVE_READERS = ("prepare_ms.serve", "stack_ms.serve", "upload_ms.serve", "wait_ms.serve")


def _span(name, lo_us, hi_us, sid, parent, unit):
    return Span(name, T0 + int(lo_us * 1e3), T0 + int(hi_us * 1e3), sid, parent, unit)


def _requests(n, skew_us=0.0, first=0):
    """n requests of 1000 us each from `first` us on: the trace's "request"
    labels from each root's start to 10 us past its end, and each root with
    prepare (200 us), stack (100), upload (50), forward (30) and readback
    (400) inside it; skew_us moves the last root."""
    labels, spans = [], []
    for i in range(n):
        lo = first + 2000 * i
        labels.append((lo, lo + 1010, "request"))
        labels.append((lo + 5, lo + 300, "pack"))
        root = 100 * (i + 1)
        shift = skew_us if i == n - 1 else 0.0
        spans.append(_span("serve.predict", lo + shift, lo + 1000 + shift, root, 0, root))
        t = lo + shift
        for k, (name, dur) in enumerate((("pack.prepare", 200), ("pack.stack", 100),
                                         ("serve.upload", 50), ("serve.forward", 30),
                                         ("serve.readback", 400))):
            spans.append(_span(name, t + 10, t + 10 + dur, root + k + 1, root, root))
            t += dur
    return labels, spans


def _record(kind, trace, units=1):
    return harness.Record(kind=kind, e2e={}, attempted=1, failed=0, checks={},
                          memory_peak_bytes=0, units=units, trace=trace)


def _device_labels(labels):
    """The device's view of each host label: from 300 us after its start to
    20 us before its end (the kernels launched inside it)."""
    return [(lo + 300, hi - 20, name) for lo, hi, name in labels]


def test_mapping_pairs_the_labels_with_the_last_roots():
    labels, spans = _requests(3)
    labels += _device_labels(labels)
    # an earlier profiling attempt's root, left behind, and a root of no label
    stale = _span("serve.predict", -90_000, -89_000, 1, 0, 1)
    record = Recorded([stale] + spans, [])
    # the trace's clock starts 5 ms after T0: every label sits 5000 us earlier
    trace = tr.Trace([], [(lo - 5000, hi - 5000, n) for lo, hi, n in labels], (0, 10_000), 3)
    m = ps.mapped(trace, "request", record)
    assert m is not None and m.units == 3
    assert [x for r in m.roots for x in r] == pytest.approx(
        [-5000.0, -4000.0, -3000.0, -2000.0, -1000.0, 0.0])
    assert {s[3] for s in m.spans} == {100, 200, 300}  # the stale unit is left out
    assert ps.ms_per_unit(m, "pack.prepare") == pytest.approx(0.2)
    assert ps.ms_per_unit(m, "serve.readback") == pytest.approx(0.4)


@pytest.mark.parametrize("skew_us, ok", [(0.0, True), (40.0, True), (120.0, False)])
def test_mapping_refuses_a_root_outside_its_label(skew_us, ok):
    """A root that lands outside its label by more than 50 us once the
    median offset is applied gives no mapping: a missing reading."""
    labels, spans = _requests(3, skew_us=skew_us)
    trace = tr.Trace([], labels + _device_labels(labels), (0, 10_000), 3)
    assert (ps.mapped(trace, "request", Recorded(spans, [])) is not None) is ok


def test_no_program_spans_no_mapping(monkeypatch):
    labels, spans = _requests(2)
    trace = tr.Trace([], labels, (0, 10_000), 2)
    assert ps.mapped(trace, "request", Recorded([], [])) is None  # nothing recorded
    assert ps.mapped(trace, "request", Recorded(spans[:6], [])) is None  # fewer roots than labels
    assert ps.mapped(None, "request", Recorded(spans, [])) is None  # untraced
    monkeypatch.setattr(ps, "program_record", lambda: None)  # a program without the tracer
    assert ps.mapped(trace, "request") is None
    for name in SERVE_READERS:
        assert harness.reader(name)(_record("serve", trace)) is None


def test_serve_readers(monkeypatch):
    labels, spans = _requests(4)
    trace = tr.Trace([(320, 360, "k")], labels, (0, 10_000), 4)
    monkeypatch.setattr(ps, "program_record", lambda: Recorded(spans, [Count("x", T0, 1, 100)]))
    rec = _record("serve", trace, units=4)
    read = {n: harness.reader(n)(rec) for n in SERVE_READERS}
    assert read == pytest.approx({"prepare_ms.serve": 0.2, "stack_ms.serve": 0.1,
                                  "upload_ms.serve": 0.05, "wait_ms.serve": 0.4})
    assert harness.reader("idle_in_epoch_pct.train")(rec) is None  # a serve record


@pytest.mark.parametrize("device, ok", [
    ([(320, 360, "k"), (2320, 2700, "k")], True),  # each request's kernels inside it
    ([(140, 360, "k")], True),  # 170 us before its upload starts (310 us): within 200 us
    ([(100, 360, "k")], False),  # 210 us before it
    ([(2320, 2700, "k"), (4320, 5950, "k")], True),  # the last request's: no next label
    ([(320, 2150, "k")], True),  # the first request's ends 150 us into the next
    ([(320, 2250, "k")], False),  # 250 us into it: the host did not wait for it
])
def test_device_check_refuses_activity_off_its_launch(device, ok):
    """Device activity that starts before its unit's first launching span
    (serve.upload here) or ends after the next label starts, each by more
    than 200 us, fails the device check: the device's clock has drifted
    from the host's, so its idle gaps cannot be put under program spans.
    The host's spans still map."""
    labels, spans = _requests(3)
    trace = tr.Trace(sorted(device), labels, (0, 10_000), 3)
    m = ps.mapped(trace, "request", Recorded(spans, []))
    assert m is not None and ps.device_aligned(trace, m, "request") is ok


def test_idle_in_epoch_reader(monkeypatch):
    """Two epochs of 1000 us, each a copy-in (100 / 200 us) then a replay
    that keeps the device busy, and a loss read between them on the device
    from 1500 to 2000 us. Idle inside the epochs: the copy-ins, 300 us;
    outside: 1000-1500 and 3000-3100, 600 us. A replay whose kernels read
    as starting 250 us before the copy-in that launched them reads nothing."""
    epochs = [(0, 1000), (2000, 3000)]
    labels = [(lo, hi + 5, "epoch") for lo, hi in epochs]
    # the device's view of each epoch label: from its first kernel on, past
    # the host's call (the host runs ahead) to the loss read's
    labels += [(lo + 100, hi + 900, "epoch") for lo, hi in epochs]
    spans, device = [], [(1500, 2000, "loss read")]
    for i, (lo, hi) in enumerate(epochs):
        root = 10 * (i + 1)
        copy = 100 * (i + 1)
        spans.append(_span("train.epoch", lo, hi, root, 0, root))
        spans.append(_span("train.copy_in", lo, lo + copy, root + 1, root, root))
        spans.append(_span("train.replay", lo + copy, hi, root + 2, root, root))
        device.append((lo + copy, hi, "kernel"))
    trace = tr.Trace(sorted(device), labels, (0, 3100), 2)
    monkeypatch.setattr(ps, "program_record", lambda: Recorded(spans, []))
    rec = _record("train", trace, units=2)
    assert harness.reader("idle_in_epoch_pct.train")(rec) == pytest.approx(100 * 300 / 900)
    for name in SERVE_READERS:
        assert harness.reader(name)(rec) is None  # a train record
    early = sorted(device[:2] + [(1750, 3000, "kernel")])  # the second epoch's, 250 us early
    rec = _record("train", tr.Trace(early, labels, (0, 3100), 2), units=2)
    assert harness.reader("idle_in_epoch_pct.train")(rec) is None


@pytest.mark.card
def test_captured_epoch_spans(card):
    """On the card the epoch replays a captured step: the first epoch call
    records train.capture and one train.captures, and train.copy_in /
    train.replay once per batch; the next call captures nothing."""
    import torch

    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.train import trainer
    from gns_torch.utils import profiling
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    cfg = GNSConfig(case_nr=14, K=2, latent_dim=8, hidden_dim=8, multiple_phi=True, batch_size=8)
    data = batch_from_cases(list(generate_cases(14, 31, seed=0)))
    state = trainer.init_train_state(0, cfg, device=card)
    epoch = trainer.make_epoch_step(cfg, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, 8), card)
    with profiling.recording():
        for _ in range(2):
            _, metrics = epoch(state, stacked)
            float(metrics["last_loss"].mean())
    rec = profiling.recorded()
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["train.epoch"] * 2
    names = [[s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
              if s.unit == r.unit and s is not r] for r in roots]
    assert names[0] == ["train.capture"] + ["train.copy_in", "train.replay"] * 4
    assert names[1] == ["train.copy_in", "train.replay"] * 4
    assert [rec.counted(r.unit).get("train.captures", 0) for r in roots] == [1, 0]
    assert torch.isfinite(metrics["loss"]).all()


@pytest.mark.card
def test_traced_serve_window_maps_onto_its_trace(card):
    """A traced serving window on the card at a small size (case14, K=2,
    conftest's SMALL_TRAFFIC): every paired root lies inside its label, the
    four serving readers read finite values, and no device activity of a
    traced request starts before its serve.upload span (to 20 us)."""
    from benchmark.tests.conftest import SMALL_TRAFFIC, cells
    from gns_torch.utils import cases as port_cases

    cell = cells("serve")[0]
    entry = harness.cell_of(harness.spec(), cell)
    config = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
    config["gns"].update(K=2, case_nr=14)
    ctx = harness.Context(cell=cell, config=config,
                          traffic=dict(SMALL_TRAFFIC["serve"], traced_requests=3),
                          limits=harness.load_json(harness.HERE, "limits", cell + ".json"),
                          seed=2**31 + 7, seconds=3.0, trace=True, device="cuda",
                          t0=time.perf_counter(), base_case=port_cases.load_case(14))
    rec = harness.run_cell(ctx)
    assert rec.correct and rec.trace is not None
    m = ps.mapped(rec.trace, "request")
    assert m is not None and m.units == 3
    for name in SERVE_READERS:
        value = harness.reader(name)(rec)
        assert value is not None and value >= 0, name
    uploads = sorted(a for a, _, name, _ in m.spans if name == "serve.upload")
    for (lo, _), upload in zip(m.labels, uploads):
        early = [a for a, _, _ in rec.trace.device if lo <= a < upload - 20]
        assert not early, (upload, early[:3])
