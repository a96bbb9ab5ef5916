"""The single-phi GNS (quirk Q1: one scalar message per line, summed into
latent column 0) of gns_torch against the benchmark's plain single-phi
reference (benchmark/reference/gns_ref_1phi.py) on the CPU.

Seeded weights as the benchmark seeds them: torch.nn.Linear's default,
then the output layer of L_theta, L_v and L_m times 0.1 (without it a
30-step parity model's forward leaves float range on most seeds). At
case14 and case30, the reference's own K=30 latent 10 hidden 10 and a
small K=3 latent 4 hidden 3: GNSPredictor.predict's v, theta (slack gauge)
and last_loss, and five update steps through make_epoch_step (the
losses, the first gradient, the change), each against the reference in
float64. The port's single-phi goldens hold against the reference too.
"""

import glob
import os

import numpy as np
import pytest
import torch

from benchmark.reference import gns_ref_1phi as ref
from benchmark.reference import grids
from gns_torch.models.gns import GNS, batch_tensors
from gns_torch.serve import GNSPredictor
from gns_torch.train import trainer
from gns_torch.utils import cases as port_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, batch_from_cases, extract_shared_topology
from tests.conftest import GOLDEN_DIR, load_golden

SHAPES = {"K30_L10_H10": (30, 10, 10), "K3_L4_H3": (3, 4, 3)}
CORRECTION_SCALE = 0.1  # the benchmark's seeding (configs/gns-k30-l10-h10-1phi-c300.json)
BATCH = 8

# Tolerances against the float64 reference. float32's rounding, carried
# through K steps of MLPs and trigonometry, reads at most 4.5e-7 on v, 4e-8
# on theta and 4e-7 relative on last_loss over these four cells (the
# float32 reference's own gaps are the same size); the reference with
# bfloat16 products reads 1e-3 and more, far outside.
V_TOL, THETA_TOL, LOSS_RTOL = 4e-6, 4e-6, 4e-6
# Training: five steps' mean losses read at most 1.6e-6 relative. The
# gradient and the change are compared as the benchmark does, by the median
# leaf's gap of norms (gns_ref.leaf_gaps): a leaf such as L_theta's last
# bias has a gradient that is zero but for rounding (a global angle shift
# leaves the loss unchanged), so its elements are noise, and Adam moves
# each element by up to lr whatever its gradient's size. Read: the first
# gradient at most 2.7e-7, the change 7.5e-6 (the float32 reference's own
# change 7e-7).
STEP_LOSS_RTOL, GRAD_TOL, CHANGE_TOL = 2e-5, 4e-6, 6e-5


def _cfg(shape, case_nr):
    k, latent, hidden = SHAPES[shape]
    return GNSConfig(K=k, latent_dim=latent, hidden_dim=hidden, multiple_phi=False, gamma=0.9,
                     leaky_relu_slope=0.01, reference_parity=True, compute_dtype="float32",
                     case_nr=case_nr, learning_rate=1e-3)


def _model(cfg, seed):
    model = GNS(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        for head in ref.UPDATES:
            for block in getattr(model, head):
                block.linear4.weight.mul_(CORRECTION_SCALE)
                block.linear4.bias.mul_(CORRECTION_SCALE)
    return model


def _ref_model(cfg):
    return {"K": cfg.K, "latent_dim": cfg.latent_dim, "gamma": cfg.gamma,
            "leaky_relu_slope": cfg.leaky_relu_slope}


def _block(cases, dtype):
    arrays = tuple(torch.as_tensor(a) for a in grids.stack_cases(cases))
    return tuple(a.to(dtype) for a in arrays[:3]) + arrays[3:]


def _weights(model, dtype):
    return {k: p.detach().to(dtype) for k, p in model.named_parameters()}


def _answers(cfg, model, cases, dtype, mm_dtype=None):
    res = ref.forward(_weights(model, dtype), _ref_model(cfg), _block(cases, dtype), mm_dtype)
    theta = ref.decode_theta(res["theta"], grids.slack_angles(cases))
    return {"v": res["v"].double().numpy(), "theta": theta.double().numpy(),
            "last_loss": res["last_loss"].double().numpy()}


def _gaps(out, want):
    return {"v": float(np.abs(out["v"] - want["v"]).max()),
            "theta": float(np.abs(out["theta"] - want["theta"]).max()),
            "last_loss": float((np.abs(out["last_loss"] - want["last_loss"])
                                / np.abs(want["last_loss"])).max())}


LIMITS = {"v": V_TOL, "theta": THETA_TOL, "last_loss": LOSS_RTOL}


@pytest.mark.parametrize("case_nr", [14, 30])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_predict_matches_reference(shape, case_nr):
    cfg = _cfg(shape, case_nr)
    model = _model(cfg, seed=5)
    cases = grids.make_cases(port_cases.load_case(case_nr), BATCH, 123)
    out = GNSPredictor(model, cfg, batch_size=BATCH, device="cpu").predict(cases)
    want = _answers(cfg, model, cases, torch.float64)
    gaps = _gaps(out, want)
    assert all(gaps[k] <= LIMITS[k] for k in LIMITS), gaps
    # the tolerances are tight enough that bfloat16 products fail them
    bf16 = _gaps(_answers(cfg, model, cases, torch.float32, torch.bfloat16), want)
    assert any(bf16[k] > LIMITS[k] for k in LIMITS), bf16


def _median(gaps):
    return sorted(gaps.values())[len(gaps) // 2]


@pytest.mark.parametrize("case_nr", [14, 30])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_five_train_steps_match_reference(shape, case_nr):
    """Five steps as the benchmark's training cell takes them: one epoch
    call over the first batch (its gradient read from Adam's first moment),
    then one over four batches, the first of them again."""
    cfg = _cfg(shape, case_nr)
    model = _model(cfg, seed=7)
    start = _weights(model, torch.float64)
    cases = grids.make_cases(port_cases.load_case(case_nr), 4 * BATCH, 99)
    data = batch_from_cases(cases)
    optimizer = trainer.make_optimizer(cfg)
    state = trainer.TrainState(model, optimizer.init(model.parameters()),
                               torch.zeros((), dtype=torch.int32))
    epoch = trainer.make_epoch_step(cfg, optimizer, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, BATCH), "cpu")
    _, first = epoch(state, GridBatch(*(a[0:1] for a in stacked)))
    grad = {n: mu / (1 - trainer.ADAM_B1)
            for (n, _), mu in zip(model.named_parameters(), state.opt_state["mu"])}
    _, rest = epoch(state, stacked)
    losses = torch.cat([first["loss"], rest["loss"]]).tolist()
    change = {n: p.detach().double() - start[n] for n, p in model.named_parameters()}

    blocks = [_block(cases[i * BATCH:(i + 1) * BATCH], torch.float64) for i in (0, 0, 1, 2, 3)]
    optim = {"lr": cfg.lr, "grad_clip": cfg.grad_clip, "warmup_steps": cfg.warmup_steps}
    want, want_grad, last, _ = ref.train_steps(start, _ref_model(cfg), optim, blocks)
    assert all(np.isfinite(losses))
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, want)) <= STEP_LOSS_RTOL
    assert _median(ref.leaf_gaps(grad, want_grad)) <= GRAD_TOL
    assert _median(ref.leaf_gaps(change, {k: last[k] - start[k] for k in last})) <= CHANGE_TOL


SINGLE_PHI_GOLDENS = sorted(os.path.basename(p)[:-4] for p in
                            glob.glob(os.path.join(GOLDEN_DIR, "singlephi_K6_L20_H10_*.npz")))


@pytest.mark.parametrize("name", SINGLE_PHI_GOLDENS)
def test_goldens_hold_against_reference(name):
    """The original reference's recorded single-phi forward (K=6, latent
    20, hidden 10, one grid of case14) from its own state_dict, within
    tests/test_torch_model.py's golden tolerances."""
    g = load_golden(name)
    weights = {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd.")}
    buses, lines, gens = (torch.from_numpy(g[k])[None]
                          for k in ("buses", "lines", "generators"))
    ids = (lines[0, :, 0], lines[0, :, 1], gens[0, :, 0])
    src, dst, gen_bus = (a.long() - 1 for a in ids)
    model = {"K": 6, "latent_dim": 20, "gamma": 0.9, "leaky_relu_slope": 0.01}
    out = ref.forward(weights, model, (buses, lines, gens, src, dst, gen_bus))
    np.testing.assert_allclose(out["v"][0].numpy(), g["v"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out["theta"][0].numpy(), g["theta"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(out["total_loss"][0]), g["total_loss"], rtol=5e-4)
    np.testing.assert_allclose(float(out["last_loss"][0]), g["last_loss"], rtol=5e-4)


def test_q1_is_what_the_reference_keeps():
    """Dropping quirk Q1 (the phi sum in every latent column) moves the
    reference's answer far outside the tolerances above: the comparison
    sees the quirk."""
    cfg = _cfg("K3_L4_H3", 14)
    model = _model(cfg, seed=5)
    cases = grids.make_cases(port_cases.load_case(14), BATCH, 123)
    weights, block = _weights(model, torch.float64), _block(cases, torch.float64)
    kept = ref.forward(weights, _ref_model(cfg), block)
    dropped = ref.forward(weights, _ref_model(cfg), block, q1=False)
    assert float((kept["v"] - dropped["v"]).abs().max()) > 100 * V_TOL
