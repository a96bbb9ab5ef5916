"""The single-phi cells (drivers/serve_1phi.py, train_1phi.py) on the CPU at
small sizes: the rest of a run (case14 and case30, the configuration's own
K=30 latent 10 hidden 10 and its seeding, 8 grids a batch; the look for a
card is skipped) must come out correct within the cell's limits, which the
card's readings set; the reference with bfloat16 products in the
program's place must not, nor the faults control_1phi.py plants in the
reference. The same limits must fail on faults planted in the program:
quirk Q1 dropped (the phi sum broadcast to every latent column), half of
each batch left out of the loss, an update step that leaves the state
unchanged. And the readers of the two per-layer metrics the single-phi
cells brought, on synthetic records."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.control_1phi import controls
from benchmark.lib import counts, counts_1phi
from benchmark.lib import program_spans as ps
from benchmark.lib import trace as tr
from gns_torch.utils.profiling import Recorded, Span

SMALL_TRAFFIC = {
    "serve_1phi": {"driver": "serve_1phi", "pool": 24, "request": 8, "batch": 8,
                   "warmup_requests": 1, "traced_requests": 1},
    "train_1phi": {"driver": "train_1phi", "dataset": 32, "batch": 8, "traced_epochs": 1,
                   "job_epochs": 2},
}
SERVE, TRAIN = "c300-k30l10-serve-b1024", "c300-k30l10-train-b256"


def _run(cell, case_nr=14, seed=2**31 + 99):
    from gns_torch.utils import cases as port_cases

    entry = harness.cell_of(harness.spec(), cell)
    config = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
    config["gns"].update(case_nr=case_nr)
    driver = harness.load_json(harness.HERE, "traffic", entry["traffic"] + ".json")["driver"]
    ctx = harness.Context(cell=cell, config=config, traffic=dict(SMALL_TRAFFIC[driver]),
                          limits=harness.load_json(harness.HERE, "limits", cell + ".json"),
                          seed=seed, seconds=0.2, trace=False, device="cpu",
                          t0=time.perf_counter(), base_case=port_cases.load_case(case_nr))
    return ctx, harness.run_cell(ctx)


def _fails(gaps, limits):
    return any(not gaps[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("case_nr", [14, 30])
@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_port_matches_reference(cell, case_nr):
    ctx, rec = _run(cell, case_nr)
    assert ctx.model()["K"] == 30 and not ctx.model()["multiple_phi"]
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.correct, rec.checks
    out = controls(ctx, rec)
    assert _fails(out["bf16"], ctx.limits), out["bf16"]
    assert set(out["faults"]) == ({"q1"} if cell == SERVE else {"q1", "half_batch", "unchanged"})
    for name, fault in out["faults"].items():
        assert _fails(fault, ctx.limits), (name, fault)


def _drop_q1(monkeypatch):
    """The program's Q1 aggregation with the phi sum in every latent
    column, as the paper reads it."""
    from gns_torch.models import gns
    from gns_torch.ops.segment import segment_sum

    def broadcast(data_col, index, latent_dim):
        return segment_sum(data_col[..., 0], index)[..., None].expand(
            data_col.shape[0], index.n, latent_dim).contiguous()
    monkeypatch.setattr(gns, "broadcast_col0_segment_sum", broadcast)


@pytest.mark.parametrize("cell, fault", [(SERVE, "q1"), (TRAIN, "q1"), (TRAIN, "half_batch"),
                                         (TRAIN, "unchanged")])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from gns_torch.train import trainer
    from gns_torch.utils.prepare import GridBatch

    if fault == "q1":
        _drop_q1(monkeypatch)
    elif fault == "unchanged":
        def core_of(cfg, optimizer, method, dense, grads_fn=None):
            def core(state, batch, graph, *extra):
                loss, last, _ = trainer.loss_and_grads(state.model, cfg, batch, graph, method,
                                                       dense)
                return loss, last
            return core
        monkeypatch.setattr(trainer, "_update_core", core_of)
    else:
        whole = trainer.loss_and_grads

        def half(model, cfg, batch, graph, method="auto", dense=False):
            rows = batch.buses.shape[0] // 2
            return whole(model, cfg, GridBatch(*(a[:rows] for a in batch)), graph, method, dense)
        monkeypatch.setattr(trainer, "loss_and_grads", half)
    _, rec = _run(cell)
    assert rec.attempted > 0 and rec.failed == 0
    assert not rec.correct, rec.checks
    if fault == "unchanged":
        assert rec.checks["change_gap"]["value"] == pytest.approx(1.0)


def test_a_new_job_starts_from_the_seeded_state():
    """new_job puts the parameters, Adam's state and the step count back
    where they started, in the tensors the epoch call already holds: the
    epoch after it gives the first epoch's losses again, bit for bit."""
    from benchmark.drivers.serve_1phi import seed_weights
    from benchmark.drivers.train_1phi import new_job
    from benchmark.reference import grids
    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.train import trainer
    from gns_torch.utils import cases as port_cases
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    entry = harness.cell_of(harness.spec(), TRAIN)
    config = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
    config["gns"].update(K=3, case_nr=14)
    ctx = harness.Context(cell=TRAIN, config=config, traffic={}, limits={}, seed=2**32 + 1,
                          seconds=0.0, trace=False, device="cpu", t0=0.0)
    cfg = harness.gns_config(ctx)
    data = batch_from_cases(grids.make_cases(port_cases.load_case(14), 16, 3))
    model = GNS(cfg, 0, "cpu")
    start = list(seed_weights(ctx, model, "cpu").values())
    optimizer = trainer.make_optimizer(cfg)
    state = trainer.TrainState(model, optimizer.init(model.parameters()),
                               torch.zeros((), dtype=torch.int32))
    tensors = [id(t) for t in trainer._state_tensors(state)]
    epoch = trainer.make_epoch_step(cfg, optimizer, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, 8), "cpu")
    first = epoch(state, stacked)[1]["loss"]
    second = epoch(state, stacked)[1]["loss"]
    assert not torch.equal(first, second) and int(state.step) == 4
    new_job(state, start)
    assert [id(t) for t in trainer._state_tensors(state)] == tensors
    assert torch.equal(epoch(state, stacked)[1]["loss"], first) and int(state.step) == 2


def test_seeding_scales_the_update_heads_output_layer():
    """seed_weights: harness.seed_weights, then linear4 of L_theta, L_v and
    L_m times correction_scale; every other leaf as harness seeds it."""
    from benchmark.drivers.serve_1phi import seed_weights
    from gns_torch.models.gns import GNS

    entry = harness.cell_of(harness.spec(), SERVE)
    config = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
    ctx = harness.Context(cell=SERVE, config=config, traffic={}, limits={}, seed=2**33 + 5,
                          seconds=0.0, trace=False, device="cpu", t0=0.0)
    cfg = harness.gns_config(ctx)
    plain = harness.seed_weights(GNS(cfg, 0, "cpu"), ctx.seed, "cpu")
    scaled = seed_weights(ctx, GNS(cfg, 0, "cpu"), "cpu")
    assert plain.keys() == scaled.keys() and len(plain) == 4 * 6 * cfg.K
    assert sum(t.numel() for t in scaled.values()) == config["parameters"] == 44_790
    for name, t in scaled.items():
        head = name.split(".")[0]
        factor = config["correction_scale"] if head != "phi" and ".linear4." in name else 1.0
        assert torch.equal(t, plain[name] * factor), name


def test_forward_flops_by_hand():
    # K30 L10 H10, one phi, at 300 buses and 411 lines: per line 15*10 +
    # 10*10 + 10*1 = 260 MACs; per bus 2 x (24*10 + 100 + 10) + (240 + 100 +
    # 100) = 1140; 30 steps, 2 FLOP a MAC
    model = {"K": 30, "latent_dim": 10, "hidden_dim": 10}
    assert counts_1phi.forward_flops(model, 300, 411) == 2 * 30 * (411 * 260 + 300 * 1140) \
        == 26_931_600
    assert counts_1phi.train_step_flops(model, 300, 411, 256) == 3 * 256 * 26_931_600
    # one phi head in place of three: fewer FLOPs than the multi-phi count
    assert counts_1phi.forward_flops(model, 300, 411) < counts.forward_flops(model, 300, 411)


T0 = 1_790_000_000_000_000_000  # unix ns of the synthetic trace's start


def _record(kind, **kw):
    base = dict(kind=kind, e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0)
    base.update(kw)
    return harness.Record(**base)


def test_step_enqueue_reader(monkeypatch):
    """The median over requests of each request's mean model.step span:
    request 1's steps 10 and 30 us (mean 20), request 2's 50 us alone,
    request 3's 40 us: median 40 us."""
    read = harness.reader("step_enqueue_ms.serve")
    labels, spans = [], []
    steps = {1: (10, 30), 2: (50,), 3: (40,)}
    for i, durations in steps.items():
        lo = 2000 * i
        labels.append((lo, lo + 1010, "request"))
        root = 100 * i

        def span(name, a, b, sid, parent):
            return Span(name, T0 + int(a * 1e3), T0 + int(b * 1e3), sid, parent, root)
        spans.append(span("serve.predict", lo, lo + 1000, root, 0))
        spans.append(span("serve.forward", lo + 100, lo + 900, root + 1, root))
        t = lo + 110
        for k, d in enumerate(durations):
            spans.append(span("model.step", t, t + d, root + 2 + k, root + 1))
            t += d + 5
    trace = tr.Trace([], labels, (0, 10_000), 3)
    monkeypatch.setattr(ps, "program_record", lambda: Recorded(spans, []))
    assert read(_record("serve", trace=trace, units=3)) == pytest.approx(0.040)
    assert read(_record("train", trace=trace, units=3)) is None
    # a program without the span (the parent of the change that added it)
    no_steps = Recorded([s for s in spans if s.name != "model.step"], [])
    monkeypatch.setattr(ps, "program_record", lambda: no_steps)
    assert read(_record("serve", trace=trace, units=3)) is None


def test_kernels_per_step_reader():
    """Kernels, not copies or fills, over the traced epochs' steps: 2
    traced epochs of 4 steps (12 steps over 3 epochs in the run)."""
    read = harness.reader("kernels_per_step.train")
    device = ([(i, i + 1, "void segment_sum_warp<...>") for i in range(0, 40, 2)]
              + [(100, 101, "Memcpy DtoD (Device -> Device)"), (102, 103, "Memset (Device)")])
    trace = tr.Trace(device, [], (0, 200), 2)
    assert read(_record("train", trace=trace, attempted=12, units=3)) == pytest.approx(20 / 8)
    assert read(_record("serve", trace=trace, attempted=12, units=3)) is None
    assert read(_record("train", trace=None, attempted=12, units=3)) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_cell_and_its_control_on_the_card(cell, card):
    """On the card, at the cell's own size, on three seeds: a short window
    of the cell's driver comes out correct, and the TF32 control and every
    fault of control_1phi.controls fail at least one of its limits."""
    entry = harness.cell_of(harness.spec(), cell)
    for seed in (2**31 + 17, 2**31 + 18, 2**31 + 19):
        ctx = harness.Context(
            cell=cell, config=harness.load_json(harness.HERE, "configs", entry["config"] + ".json"),
            traffic=harness.load_json(harness.HERE, "traffic", entry["traffic"] + ".json"),
            limits=harness.load_json(harness.HERE, "limits", cell + ".json"), seed=seed,
            seconds=1.0, trace=False, device="cuda", t0=time.perf_counter())
        rec = harness.run_cell(ctx)
        assert rec.correct, (seed, rec.checks)
        out = controls(ctx, rec)
        assert _fails(out["control"], ctx.limits), (seed, out["control"])
        for name, fault in out["faults"].items():
            assert _fails(fault, ctx.limits), (seed, name, fault)
