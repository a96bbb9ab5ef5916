"""The outage-aware GNS with textbook AC physics (reference_parity False,
the paper-mode options of the shipped 118-n1 recipe, admittance inputs,
Adam behind a global-norm clip and a linear warm-up) of gns_torch against
the benchmark's plain reference for it (benchmark/reference/gns_ref_n1.py)
on the CPU.

Seeded weights as the benchmark seeds them (torch.nn.Linear's default),
at case14 and the IEEE case118, on intact grids and on grids with one
branch outaged (r = x = 1e6, b = 0): the forward (v, theta, the losses),
the gradient, nine clipped, warmed-up Adam steps through make_epoch_step,
and GNSPredictor.predict. At these weights the K=4 map amplifies its
inputs (case118's v reaches hundreds), so float32's rounding is measured,
not assumed: every gap from the float64 reference is held to a multiple of
the float32 reference's own widest gap on the same grids. Also the frozen
case118 table, the N-1 draw, and the two counters this configuration is
watched by (model.eager_refreshes, optim.global_norm_clips).
"""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import train_n1
from benchmark.reference import gns_ref, gns_ref_n1, grids, grids_118
from gns_torch.models.gns import GNS, batch_tensors, gns_forward, step_params
from gns_torch.physics.common import build_graph
from gns_torch.serve import GNSPredictor
from gns_torch.train import trainer
from gns_torch.utils import cases as port_cases
from gns_torch.utils import profiling
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

CELL = "c118-k4l20n1-train-b128"
CONFIG = harness.load_json(harness.HERE, "configs", "gns-k4-l20-h10-n1-c118.json")
MODEL = {k: CONFIG["gns"][k] for k in ("K", "latent_dim", "hidden_dim", "gamma",
                                        "leaky_relu_slope", "v_anchor")}
BATCH = 8
# Gaps from float64 in units of the float32 reference's own widest gap on
# the same grids (the gradient: its median leaf's gap of norms in units of
# the float32 reference's median leaf, as the benchmark compares). Read over
# these four cells at three weight seeds and two grid seeds each: at most
# 1.48 (v), 1.73 (theta), 1.67 (the losses), the same through predict; the
# gradient 8.75 (then 4.77), where the float32 reference's own median leaf
# happens to lie close to float64's.
UNITS, GRAD_UNITS = 8.0, 25.0


def _cfg(**kw) -> GNSConfig:
    return GNSConfig(**dict(CONFIG["gns"], **kw))


def _cases(case_nr, outaged, count=BATCH, seed=2**33 + 7):
    base = port_cases.load_case(case_nr)
    if outaged:
        return grids_118.n1_cases(base, count, seed, prob=1.0)
    return grids.make_cases(base, count, seed)


def _weights(cfg, seed=2**31 + 5):
    model = GNS(cfg, 0, "cpu")
    return model, harness.seed_weights(model, seed, "cpu")


def _reference(weights, cases, dtype, **kw):
    arrays = gns_ref_n1.stack_cases(cases)
    block = tuple(torch.as_tensor(a) for a in arrays)
    block = tuple(a.to(dtype) for a in block[:3]) + block[3:]
    return gns_ref_n1.forward({k: w.to(dtype) for k, w in weights.items()}, MODEL, block, **kw)


def _gap(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().max())


def _port_forward(model, cfg, cases, grad=False):
    data = batch_from_cases(cases, paper_shunts=not cfg.true_shunts)
    graph = build_graph(data.buses, data.lines, data.generators,
                        extract_shared_topology(data), "cpu")
    with torch.set_grad_enabled(grad):
        return gns_forward(step_params(model, cfg), cfg, batch_tensors(data, "cpu"), graph,
                           dense=data.is_dense())


CELLS = [(14, False), (14, True), (118, False), (118, True)]


@pytest.mark.parametrize("case_nr, outaged", CELLS)
def test_forward_matches_reference(case_nr, outaged):
    cfg = _cfg()
    model, weights = _weights(cfg)
    cases = _cases(case_nr, outaged)
    out = _port_forward(model, cfg, cases)
    r32, r64 = (_reference(weights, cases, dt) for dt in (torch.float32, torch.float64))
    for name, port in (("v", out.v), ("theta", out.theta), ("total_loss", out.total_loss),
                       ("last_loss", out.last_loss)):
        own = _gap(r32[name], r64[name])
        assert torch.isfinite(port).all(), name
        assert _gap(port, r64[name]) <= UNITS * own + 1e-30, (name, _gap(port, r64[name]), own)
    # the other physics would not pass: raw features, or the parity refresh's
    r_raw = _reference(weights, cases, torch.float64, admittance=False)
    assert not _gap(out.total_loss, r_raw["total_loss"]) <= UNITS * _gap(
        r32["total_loss"], r64["total_loss"])


@pytest.mark.parametrize("case_nr, outaged", CELLS)
def test_gradients_match_reference(case_nr, outaged):
    cfg = _cfg()
    model, weights = _weights(cfg)
    cases = _cases(case_nr, outaged)
    names = [n for n, _ in model.named_parameters()]
    loss = _port_forward(model, cfg, cases, grad=True).total_loss.mean()
    port = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    ref = {}
    for dt in (torch.float32, torch.float64):
        w = {k: t.to(dt).requires_grad_(True) for k, t in weights.items()}
        total = _reference(w, cases, dt)["total_loss"].mean()
        ref[dt] = dict(zip(w, torch.autograd.grad(total, list(w.values()), allow_unused=True)))
        ref[dt] = {k: torch.zeros_like(w[k]) if g is None else g for k, g in ref[dt].items()}
    own = gns_ref.leaf_gaps(ref[torch.float32], ref[torch.float64])
    mine = gns_ref.leaf_gaps(port, ref[torch.float64])

    def median(gaps):
        return sorted(gaps.values())[len(gaps) // 2]
    assert median(mine) <= GRAD_UNITS * median(own) + 1e-30, (median(mine), median(own))


def _small_run(case_nr, outaged, seed=2**31 + 99, **gns):
    """The rest of a run of the cell's driver on the CPU: `case_nr` in place
    of case118 unless 118, 64 grids in batches of 8 (nine compared steps:
    batch 0, then the epoch's eight)."""
    config = dict(CONFIG, gns=dict(CONFIG["gns"], case_nr=case_nr, **gns))
    traffic = {"driver": "train_n1", "dataset": 64, "batch": BATCH,
               "outage_prob": 1.0 if outaged else 0.0, "traced_epochs": 1, "job_epochs": 2}
    ctx = harness.Context(cell=CELL, config=config, traffic=traffic,
                          limits=harness.load_json(harness.HERE, "limits", CELL + ".json"),
                          seed=seed, seconds=0.2, trace=False, device="cpu",
                          t0=time.perf_counter(), base_case=port_cases.load_case(case_nr))
    return ctx, harness.run_cell(ctx)


@pytest.mark.parametrize("case_nr, outaged", CELLS)
def test_nine_clipped_warmed_up_steps_match_reference(case_nr, outaged):
    """make_epoch_step's nine steps (the driver's own calls) against the
    reference's: within the cell's limits, with the clip at work (the
    first gradient, as Adam's first moment holds it, has a global norm of
    1) and step 1 moving only the moments."""
    ctx, rec = _small_run(case_nr, outaged)
    assert len(rec.detail["program"]["losses"]) == 9 and rec.failed == 0
    assert rec.correct, rec.checks
    assert _norm(rec.detail["program"]["grad"]) == pytest.approx(1.0, rel=1e-5)
    losses = rec.detail["program"]["losses"]
    assert losses[0] == losses[1]  # step 2 reads batch 0 again, from unmoved weights
    outaged_lines = [c["outaged"] for c in rec.detail["cases"]]
    assert all(i >= 0 for i in outaged_lines) if outaged else all(i < 0 for i in outaged_lines)


def test_steps_at_a_gradient_past_float32s_squares():
    """At the shipped recipe's init (scale 1.0) seed 2**31 + 100's first
    gradient has a global norm past 1.8e19, whose float32 squares overflow:
    a clip that summed them in float32 zeroed every update. The program's
    clipped first gradient has norm 1 and matches the reference's within
    the cell's grad_gap, and its nine steps move the state as far as the
    float32 reference's do (there float32's own rounding, amplified by the
    untrained map, takes both far from float64's change)."""
    ctx, rec = _small_run(118, True, 2**31 + 100, init_correction_scale=1.0)
    program, r32 = rec.detail["program"], rec.detail["reference"]
    raw = train_n1.reference_steps(ctx, rec.detail["cases"], rec.detail["weights"],
                                   clip=False)["grad"]
    assert torch.isinf(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(raw.values())))))
    assert _norm(program["grad"]) == pytest.approx(1.0, rel=1e-5)
    assert rec.failed == 0 and rec.checks["grad_gap"]["value"] <= rec.checks["grad_gap"]["limit"]
    assert 0.5 < _norm(program["change"]) / _norm(r32["change"]) < 2.0


def _norm(leaves):
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in leaves.values())))


@pytest.mark.parametrize("fault", ["admittance", "clip"])
def test_planted_fault_fails_the_limits(fault, monkeypatch):
    """The program with the raw line features, or with its clip passing
    the gradient through, against the sound reference: not correct
    (case118 with outaged lines)."""
    change = {}
    if fault == "admittance":
        change = {"admittance_inputs": False}
    else:
        monkeypatch.setattr(trainer, "_clip_by_global_norm", lambda grads, *a, **k: grads)
    _, rec = _small_run(118, True, **change)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("scale", [1e-2, 1e3, 1e25])
def test_clip_takes_a_norm_past_float32s_squares(scale):
    """The clip's global norm is taken in float64: a gradient whose float32
    squares overflow (an untrained K=4 map over case118's stiff branches
    gives global norms up to about 1e30) is scaled to norm 1 as the
    reference's clip scales it, not zeroed by g / inf; one under the clip
    passes unchanged."""
    gen = torch.Generator().manual_seed(3)
    grads = [scale * torch.randn(shape, generator=gen) for shape in ((20, 25), (10,), (1, 10))]
    plain = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    assert bool(torch.isinf(plain)) == (scale > 1e19)
    optimizer = trainer.make_optimizer(_cfg())
    state = optimizer.init([torch.zeros_like(g) for g in grads])
    _, state = optimizer.update(grads, state)
    want = gns_ref_n1.clip_by_global_norm(dict(enumerate(grads)), 1.0)
    for mu, g in zip(state["mu"], want.values()):
        torch.testing.assert_close(mu / (1 - trainer.ADAM_B1), g, rtol=1e-6, atol=0)
    norm = torch.sqrt(sum((mu.double() ** 2).sum() for mu in state["mu"])) / (1 - trainer.ADAM_B1)
    assert float(norm) == pytest.approx(min(1.0, float(plain) if scale < 1e19 else 1.0), rel=1e-6)


@pytest.mark.parametrize("case_nr, outaged", CELLS)
def test_predict_matches_reference(case_nr, outaged):
    cfg = _cfg()
    model, weights = _weights(cfg)
    cases = _cases(case_nr, outaged)
    got = GNSPredictor(model, cfg, batch_size=BATCH, device="cpu").predict(cases)
    slack = grids.slack_angles(cases)
    r32, r64 = (_reference(weights, cases, dt) for dt in (torch.float32, torch.float64))
    for name in ("v", "theta", "last_loss"):
        want32, want64 = r32[name], r64[name]
        if name == "theta":
            want32, want64 = (gns_ref.decode_theta(t, slack) for t in (want32, want64))
        own = _gap(want32, want64)
        assert _gap(got[name], want64) <= UNITS * own + 1e-30, (name, _gap(got[name], want64), own)


def test_frozen_case118_is_the_ports():
    mine, port = grids_118.case118(), port_cases._case118()
    assert mine.keys() == port.keys() and mine["baseMVA"] == port["baseMVA"]
    for key in ("bus", "gen", "branch", "gencost"):
        assert mine[key].dtype == port[key].dtype and np.array_equal(mine[key], port[key]), key


@pytest.mark.parametrize("prob", [0.7, 1.0])
def test_n1_draw_never_outages_a_bridge(prob):
    base = grids_118.case118()
    bridges = set(grids_118.bridges(base).tolist())
    # the islanding outages of case118 (docs/N1_SCREEN.md: 9 of 186)
    assert len(bridges) == 9
    for i in bridges:
        assert not grids_118._connected(118, _ends(grids_118.outage(base, i)))
    cases = grids_118.n1_cases(base, 400, 2**35 + 3, prob)
    plain = grids.make_cases(base, 400, 2**35 + 3)
    hit = [c["outaged"] for c in cases if c["outaged"] >= 0]
    assert not set(hit) & bridges and len(set(hit)) > 100
    assert abs(len(hit) / 400 - prob) < 0.08
    for c, p in zip(cases, plain):
        i = c["outaged"]
        br = c["branch"].copy()
        if i >= 0:
            assert br[i, 10] == 0 and br[i, 2] == br[i, 3] == 1e6 and br[i, 4] == 0
            br[i] = p["branch"][i]
        assert np.array_equal(br, p["branch"]) and np.array_equal(c["bus"], p["bus"])


def _ends(case):
    live = case["branch"][:, 10] != 0
    return (case["branch"][live, :2] - 1).astype(int)


@pytest.mark.parametrize("grad_clip, k", [(1.0, 4), (0.0, 4), (1.0, 2)])
def test_counters_of_the_textbook_step(grad_clip, k):
    """One eager update step counts one step built, K eager refreshes and,
    with the clip, one global-norm clip; nothing is counted outside
    recording()."""
    cfg = _cfg(grad_clip=grad_clip, K=k)
    data = batch_from_cases(_cases(14, True), paper_shunts=False)
    state = trainer.init_train_state(0, cfg, device="cpu")
    step = trainer.make_train_step(cfg, topo=extract_shared_topology(data), dense=True)
    with profiling.recording():
        step(state, data)
        counted = profiling.recorded().counted()
    assert counted.get("model.eager_refreshes") == k
    assert counted.get("train.steps_built") == 1
    assert counted.get("optim.global_norm_clips", 0) == (1 if grad_clip else 0)
    assert counted.get("model.fused_refreshes", 0) == 0
    step(state, data)
    assert profiling.recorded().counted() == counted


@pytest.mark.parametrize("counted, want", [
    ({"model.eager_refreshes": 12, "train.steps_built": 3, "train.captures": 1}, 4.0),
    ({"model.eager_refreshes": 4, "train.steps_built": 1}, 4.0),
    ({"train.captures": 1}, None),
])
def test_eager_refreshes_per_step_of_the_driver(counted, want):
    """The driver's reading: eager refreshes over the steps the program
    says it built; a program without the counters gives none."""
    assert train_n1.eager_refreshes_per_step(counted) == want
