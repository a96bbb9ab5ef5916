"""The outage-aware textbook cell (drivers/train_n1.py) on the CPU at small
sizes: the rest of a run (case14 and the IEEE case118, the configuration's
own K=4 latent 20 hidden 10, its seeding and its N-1 draw, 8 grids a
batch; the look for a card is skipped) must come out correct within the
cell's limits, which the card's readings set; the reference with bfloat16
products in the program's place must not, nor the faults control_n1.py
plants in the reference. The same limits must fail on faults planted in
the program: raw line features in place of admittance inputs, a clip that
passes the gradient through, half of each batch left out of the loss, an
update step that leaves the state unchanged. Also the seeding, the draw,
and the reader of eager_refreshes_per_step.train."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control_n1 import controls
from benchmark.drivers import train_n1
from benchmark.reference import grids, grids_118

CELL = "c118-k4l20n1-train-b128"
SMALL_TRAFFIC = {"driver": "train_n1", "dataset": 32, "batch": 8, "outage_prob": 0.7,
                 "traced_epochs": 1, "job_epochs": 2}


def _config():
    entry = harness.cell_of(harness.spec(), CELL)
    return harness.load_json(harness.HERE, "configs", entry["config"] + ".json")


def _run(case_nr=118, seed=2**31 + 99, **gns):
    from gns_torch.utils import cases as port_cases

    config = _config()
    config["gns"].update(case_nr=case_nr, **gns)
    ctx = harness.Context(cell=CELL, config=config, traffic=dict(SMALL_TRAFFIC),
                          limits=harness.load_json(harness.HERE, "limits", CELL + ".json"),
                          seed=seed, seconds=0.2, trace=False, device="cpu",
                          t0=time.perf_counter(), base_case=port_cases.load_case(case_nr))
    return ctx, harness.run_cell(ctx)


def _fails(gaps, limits):
    return any(not gaps[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("case_nr", [14, 118])
def test_port_matches_reference(case_nr):
    ctx, rec = _run(case_nr)
    assert ctx.model()["K"] == 4 and not ctx.model()["reference_parity"]
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.correct, rec.checks
    out = controls(ctx, rec)
    assert _fails(out["bf16"], ctx.limits), out["bf16"]
    assert set(out["faults"]) == {"admittance", "clip", "half_batch", "unchanged"}
    for name, fault in out["faults"].items():
        assert _fails(fault, ctx.limits), (name, fault)


@pytest.mark.parametrize("fault", ["admittance", "clip", "half_batch", "unchanged"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    from gns_torch.train import trainer
    from gns_torch.utils.prepare import GridBatch

    gns = {}
    if fault == "admittance":
        gns = {"admittance_inputs": False}
    elif fault == "clip":
        monkeypatch.setattr(trainer, "_clip_by_global_norm", lambda grads, *a, **k: grads)
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
    _, rec = _run(**gns)
    assert rec.attempted > 0
    assert not rec.correct, rec.checks
    if fault == "unchanged":
        assert rec.checks["change_gap"]["value"] == pytest.approx(1.0)


def test_seeding_scales_the_update_heads_output_layer():
    """seed_weights: harness.seed_weights, then linear4 of L_theta, L_v and
    L_m times init_correction_scale, as the port's GNS init scales them;
    every other leaf as harness seeds it."""
    from gns_torch.models.gns import GNS

    config = _config()
    ctx = harness.Context(cell=CELL, config=config, traffic={}, limits={}, seed=2**33 + 5,
                          seconds=0.0, trace=False, device="cpu", t0=0.0)
    cfg = harness.gns_config(ctx)
    plain = harness.seed_weights(GNS(cfg, 0, "cpu"), ctx.seed, "cpu")
    scaled = train_n1.seed_weights(ctx, GNS(cfg, 0, "cpu"), "cpu")
    scale = config["gns"]["init_correction_scale"]
    # six heads of three layers a correction step
    assert plain.keys() == scaled.keys() and len(plain) == 6 * 6 * cfg.K
    assert sum(t.numel() for t in scaled.values()) == config["parameters"] == 14_768
    for name, t in scaled.items():
        factor = scale if name.startswith("L_") and ".linear4." in name else 1.0
        assert torch.equal(t, plain[name] * factor), name


def test_the_draw_is_seeded_and_reads_the_augmentation():
    """n1_cases: the same seed draws the same grids; each is the reference's
    augmentation of case118 (grids.make_cases) with at most one branch
    outaged; about 70% are outaged, none on a bridge."""
    base = grids_118.case118()
    a, b = (grids_118.n1_cases(base, 64, 2**40 + 9, 0.7) for _ in range(2))
    plain = grids.make_cases(base, 64, 2**40 + 9)
    bridges = set(grids_118.bridges(base).tolist())
    hit = 0
    for x, y, p in zip(a, b, plain):
        assert x["outaged"] == y["outaged"] and np.array_equal(x["branch"], y["branch"])
        changed = np.flatnonzero((x["branch"] != p["branch"]).any(axis=1))
        assert changed.tolist() == ([x["outaged"]] if x["outaged"] >= 0 else [])
        assert x["outaged"] not in bridges
        hit += x["outaged"] >= 0
    assert 0.5 < hit / 64 < 0.9


def test_eager_refreshes_reader():
    read = harness.reader("eager_refreshes_per_step.train")

    def record(kind, detail):
        return harness.Record(kind=kind, e2e={}, attempted=1, failed=0, checks={},
                              memory_peak_bytes=0, detail=detail)
    assert read(record("train", {"eager_refreshes_per_step": 4.0})) == 4.0
    assert read(record("train", {"eager_refreshes_per_step": None})) is None
    assert read(record("train", {})) is None
    assert read(record("serve", {"eager_refreshes_per_step": 4.0})) is None


@pytest.mark.card
def test_cell_and_its_control_on_the_card(card):
    """On the card, at the cell's own size, on three seeds: a short window
    of the cell's driver comes out correct with every step finite, and the
    TF32 control and every fault of control_n1.controls fail at least one
    of its limits."""
    entry = harness.cell_of(harness.spec(), CELL)
    for seed in (2**31 + 17, 2**32 + 18, 2**33 + 19):
        ctx = harness.Context(
            cell=CELL, config=harness.load_json(harness.HERE, "configs", entry["config"] + ".json"),
            traffic=harness.load_json(harness.HERE, "traffic", entry["traffic"] + ".json"),
            limits=harness.load_json(harness.HERE, "limits", CELL + ".json"), seed=seed,
            seconds=1.0, trace=False, device="cuda", t0=time.perf_counter())
        rec = harness.run_cell(ctx)
        assert rec.failed == 0 and rec.correct, (seed, rec.checks)
        out = controls(ctx, rec)
        assert _fails(out["control"], ctx.limits), (seed, out["control"])
        for name, fault in out["faults"].items():
            assert _fails(fault, ctx.limits), (seed, name, fault)
