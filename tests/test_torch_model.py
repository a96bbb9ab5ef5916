"""gns_torch model against the reference goldens and against gns_tpu.

Goldens (tests/golden/*.npz): per-step activations of the original torch
reference, each with its own state_dict; the checks and tolerances are
those of tests/test_parity.py. gns_tpu comparisons carry the same weights
over with module_from_jax_params; tolerance rtol/atol 2e-4 because float32
trig chains compound over the K steps (SURVEY.md §7.4)."""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.models.import_torch import params_from_state_dict as j_params_from_sd
from gns_torch.models.convert import (
    module_from_jax_params,
    params_from_state_dict,
    state_dict_from_params,
)
from gns_torch.models.gns import GNS, batch_tensors, gns_forward_batch
from gns_torch.ops.segment import SegmentIndex, broadcast_col0_segment_sum, segment_sum
from gns_torch.physics.common import build_graph
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import _stack_to_batch, batch_from_cases, extract_shared_topology
from tests.conftest import GOLDEN_DIR, load_golden

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield

GOLDENS = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz")))
CONFIGS = {
    "multiphi_K4_L20_H10": GNSConfig(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True),
    "singlephi_K6_L20_H10": GNSConfig(K=6, latent_dim=20, hidden_dim=10, multiple_phi=False),
}
TOL = dict(rtol=2e-4, atol=2e-4)


def _golden_model(g, cfg, k=None):
    """The golden's weights in a module; k < K keeps the first k steps."""
    k = cfg.K if k is None else k
    sd = {}
    for key in g.files:
        if key.startswith("sd."):
            step = key[3:].split(".")[1]
            if int(step) < k:
                sd[key[3:]] = torch.from_numpy(g[key])
    model = GNS(cfg.replace(K=k), device="cpu")
    model.load_state_dict(sd)
    return model, cfg.replace(K=k)


def _run(model, cfg, g):
    batch = _stack_to_batch([(g["buses"], g["lines"], g["generators"])])
    out = gns_forward_batch(model, cfg, batch, dense=True)
    return type(out)(*(x[0].numpy() for x in out))


def test_golden_fixture_set():
    assert len(GOLDENS) == 12


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_parity(name):
    """tests/test_parity.py's checks on every fixture: final outputs, the
    first step, every prefix depth, and (where recorded) the step-0
    network input."""
    g = load_golden(name)
    cfg = next(c for tag, c in CONFIGS.items() if name.startswith(tag))
    cross_case = "_case" in name
    model, _ = _golden_model(g, cfg)
    out = _run(model, cfg, g)
    np.testing.assert_allclose(out.v, g["v"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.theta, g["theta"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.total_loss, g["total_loss"], rtol=5e-4)
    np.testing.assert_allclose(out.last_loss, g["last_loss"], rtol=5e-4)
    dp_rtol = 2e-3 if cross_case else 1e-3
    np.testing.assert_allclose(out.delta_p, g["delta_p"][-1], rtol=dp_rtol, atol=5e-5)
    np.testing.assert_allclose(out.delta_q, g["delta_q"][-1], rtol=1e-3, atol=5e-5)

    m1, c1 = _golden_model(g, cfg, 1)
    o1 = _run(m1, c1, g)
    np.testing.assert_allclose(o1.delta_p, g["delta_p"][0], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(o1.delta_q, g["delta_q"][0], rtol=2e-4, atol=1e-5)
    for k in range(2, cfg.K + 1):
        mk, ck = _golden_model(g, cfg, k)
        np.testing.assert_allclose(_run(mk, ck, g).delta_p, g["delta_p"][k - 1],
                                   rtol=2e-3, atol=2e-5)

    if "L_theta_in" in g.files:
        _check_network_input_step0(g, cfg, model)


def _check_network_input_step0(g, cfg, model):
    """The exact (N, 4 + 2 latent) input of step 0's L_theta head, rebuilt
    from the port's pieces (as tests/test_parity.py:114 does for gns_tpu)."""
    buses, lines, gens = (torch.from_numpy(g[k])[None] for k in ("buses", "lines", "generators"))
    n = buses.shape[1]
    gen_idx = SegmentIndex(g["generators"][:, 0].astype(np.int32) - 1, n)
    dst = SegmentIndex(g["lines"][:, 1].astype(np.int32) - 1, n)
    v = segment_sum(gens[..., 4], gen_idx)
    v = torch.where(v == 0, torch.ones_like(v), v)
    dp = segment_sum(gens[..., 6], gen_idx) - buses[..., 2] - buses[..., 4] * v**2
    dq = segment_sum(gens[..., 5], gen_idx) - buses[..., 3] + buses[..., 5] * v**2
    m = torch.zeros((1, n, cfg.latent_dim))
    edge_in = torch.cat([m[:, dst.ids.long()], lines[..., 2:7]], dim=-1)
    if cfg.multiple_phi:
        phi_sum = segment_sum(model.phi_theta[0](edge_in), dst)
    else:
        phi_sum = broadcast_col0_segment_sum(model.phi[0](edge_in), dst, cfg.latent_dim)
        assert torch.all(phi_sum[..., 1:] == 0)  # quirk Q1
    net_in = torch.cat([v[..., None], torch.zeros_like(v)[..., None], dp[..., None],
                        dq[..., None], m, phi_sum], dim=-1)
    np.testing.assert_allclose(net_in[0].numpy(), g["L_theta_in"][0], rtol=1e-5, atol=1e-6)


def _compare_with_jax(cfg, cases, dense, seed=0):
    params = init_gns_params(jax.random.key(seed), cfg)
    params_np = jax.tree.map(np.asarray, params)
    model = module_from_jax_params(params_np, cfg, device="cpu")
    batch = batch_from_cases(cases, paper_shunts=not cfg.true_shunts)
    topo = extract_shared_topology(batch) if dense else None
    ref = j_forward_batch(params, cfg, batch, method="scatter", topo=topo, dense=dense)
    out = gns_forward_batch(model, cfg, batch, topo=topo, dense=dense)
    for name in ("v", "theta", "total_loss", "last_loss", "delta_p", "delta_q"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    return model, batch, topo, out


def test_case300_matches_gns_tpu_forward_batch():
    """The slice's configuration (K4 / L20 / H10, multiple phi, reference
    parity, float32) on case300: a dense shared-topology batch, then the
    same grids through the masked per-sample path."""
    cfg = GNSConfig(K=4, latent_dim=20, hidden_dim=10)
    cases = list(generate_cases(300, 2, seed=4))
    _compare_with_jax(cfg, cases, dense=True)
    _compare_with_jax(cfg, cases, dense=False)


PAPER = dict(reference_parity=False, qg_gen_only=True, dispatch="setpoint_slack",
             true_shunts=True, slack_anchor=0.1, v_anchor=0.1, admittance_inputs=True)


@pytest.mark.parametrize("variant", ["fold_f32", "paper_multi", "paper_single", "parity_single"])
def test_variants_match_gns_tpu(variant):
    """Fold-on float32, paper mode with every option, single phi in both
    modes; mixed-size padded requests for the paper variants."""
    mixed = [*generate_cases(9, 1, seed=21), *generate_cases(14, 1, seed=22)]
    same = list(generate_cases(14, 2, seed=23))
    cfg = {
        "fold_f32": GNSConfig(K=3, latent_dim=8, hidden_dim=6, fold_output="on"),
        "paper_multi": GNSConfig(K=3, latent_dim=8, hidden_dim=6,
                                 init_correction_scale=0.5, **PAPER),
        "paper_single": GNSConfig(K=3, latent_dim=8, hidden_dim=6, multiple_phi=False,
                                  **PAPER),
        "parity_single": GNSConfig(K=3, latent_dim=8, hidden_dim=6, multiple_phi=False),
    }[variant]
    _compare_with_jax(cfg, mixed if variant.startswith("paper") else same,
                      dense=not variant.startswith("paper"))


@pytest.mark.parametrize("multiple_phi", [True, False])
def test_fused_and_unfused_heads_agree(multiple_phi):
    cfg = GNSConfig(K=3, latent_dim=8, hidden_dim=6, multiple_phi=multiple_phi)
    model = GNS(cfg, seed=3, device="cpu")
    batch = batch_from_cases(list(generate_cases(30, 2, seed=5)))
    topo = extract_shared_topology(batch)
    a = gns_forward_batch(model, cfg, batch, topo=topo, dense=True)
    b = gns_forward_batch(model, cfg.replace(fused_heads=False), batch, topo=topo, dense=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    for x, y in zip(a, model(batch_tensors(batch, "cpu"), graph, dense=True)):
        assert torch.equal(x, y)  # the module call is the same forward


def test_module_layout_and_weight_carry_over(monkeypatch):
    cfg = GNSConfig(K=2, latent_dim=8, hidden_dim=6)
    params = jax.tree.map(np.asarray, init_gns_params(jax.random.key(1), cfg))
    model = module_from_jax_params(params, cfg, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(sd) == set(state_dict_from_params(params, cfg))
    assert "phi_v.1.linear4.weight" in sd and sd["phi_v.0.linear1.weight"].shape == (6, 13)
    back = params_from_state_dict(sd, cfg)
    ref = j_params_from_sd(sd, cfg)
    for mod in params:
        for leaf in params[mod]:
            np.testing.assert_array_equal(back[mod][leaf], params[mod][leaf])
            np.testing.assert_array_equal(back[mod][leaf], ref[mod][leaf])
    # fresh init: torch-default bounds, seeded, and the parity guard
    a, b = GNS(cfg, seed=7, device="cpu"), GNS(cfg, seed=7, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y)
        fan_in = a.state_dict()[k.replace("bias", "weight")].shape[1]
        assert x.abs().max() <= 1.0 / np.sqrt(fan_in)
    with pytest.raises(ValueError):
        GNS(cfg.replace(init_correction_scale=0.1), device="cpu")
    small = GNS(cfg.replace(reference_parity=False, init_correction_scale=0.1), seed=7,
                device="cpu")
    torch.testing.assert_close(small.L_m[0].linear4.weight, 0.1 * a.L_m[0].linear4.weight)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNS(cfg)  # the default device is the card; never a silent CPU run
