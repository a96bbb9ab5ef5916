"""gns_torch's hybrid solver (eval/hybrid.py) against gns_tpu's, on the CPU.

Both packages run the shipped 14-sup checkpoint (gns_tpu reads it into its
parameters, the port into the GNS module), and a small model of gns_tpu's
init_gns_params carried across with module_from_jax_params. Tolerances:
  * the fused hybrid against gns_tpu's: the prediction at
    tests/test_torch_serve.py's bounds (v rtol 2e-5 / atol 1e-5; theta
    1e-3 degrees), the solution at v 2e-5 / theta 2e-3 degrees, per-grid
    counts and fallbacks equal (Newton tail; the fast-decoupled tail's
    counts are not compared, see tests/test_torch_fdpf.py);
  * against the port's flat solve: v 1e-4 (tests/test_solve_ac.py);
  * fused against the two-step predictor pipeline: test_hybrid.py's bounds
    (v rtol 1e-5 / atol 1e-6, theta 1e-4 degrees, solution 2e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from gns_tpu.eval import hybrid as j_hybrid
from gns_tpu.models import pretrained as j_pretrained
from gns_tpu.models.gns import init_gns_params
from gns_tpu.utils.config import GNSConfig as JConfig
from gns_torch.eval import hybrid
from gns_torch.eval.nr_batched import solve_batched
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.pretrained import load_pretrained
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig

torch.set_num_threads(2)


def _feasible(n, seed=31415):
    return list(generate_cases(14, n, seed=seed, feasible_only=True))[1:]


@pytest.fixture(scope="module")
def sup():
    model, cfg = load_pretrained("14-sup", device="cpu")
    params, j_cfg = j_pretrained.load_pretrained("14-sup")
    return model, cfg, params, j_cfg


@pytest.mark.parametrize("solver", ["nr", "fdpf"])
def test_hybrid_matches_gns_tpu_and_the_flat_solve(sup, solver):
    model, cfg, params, j_cfg = sup
    cases = _feasible(8)
    max_iter = 60 if solver == "fdpf" else 20
    got = hybrid.hybrid_solve(model, cfg, cases, return_prediction=True, solver=solver,
                              max_iter=max_iter)
    want = j_hybrid.hybrid_solve(params, j_cfg, cases, return_prediction=True, solver=solver,
                                 max_iter=max_iter)
    np.testing.assert_allclose(got["gns_v"], want["gns_v"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got["gns_theta_deg"], want["gns_theta_deg"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert got["converged"].all() and got["fallback_grids"] == want["fallback_grids"] == 0
    np.testing.assert_allclose(got["v"], want["v"], atol=2e-5)
    np.testing.assert_allclose(got["theta_deg"], want["theta_deg"], atol=2e-3)
    if solver == "nr":
        np.testing.assert_array_equal(got["iterations_per_grid"], want["iterations_per_grid"])
    flat = solve_batched(cases, device="cpu")
    np.testing.assert_allclose(got["v"], flat["v"], atol=1e-4)
    assert got["iterations"] <= flat["iterations"] or solver == "fdpf"


def test_fused_hybrid_matches_predictor_pipeline(sup):
    """The fused path (device-side prepare, forward, decode, seeding,
    Newton) gives the prediction and the fixed point of GNSPredictor ->
    solve_batched(warm_start=...)."""
    model, cfg, _, _ = sup
    cases = _feasible(6)
    fused = hybrid.hybrid_solve(model, cfg, cases, return_prediction=True)
    legacy = hybrid.hybrid_solve(model, cfg, cases, return_prediction=True, fused=False)
    assert fused["converged"].all() and legacy["converged"].all()
    np.testing.assert_allclose(fused["gns_v"], legacy["gns_v"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused["gns_theta_deg"], legacy["gns_theta_deg"], atol=1e-4)
    np.testing.assert_allclose(fused["v"], legacy["v"], atol=2e-5)
    assert fused["iterations"] == legacy["iterations"]


def test_fused_hybrid_pads_the_last_chunk(sup):
    """7 grids in chunks of 3: the last chunk is padded to 3 and trimmed;
    every grid is solved."""
    model, cfg, _, _ = sup
    cases = _feasible(7)
    out = hybrid.hybrid_solve(model, cfg, cases, chunk_size=3)
    flat = solve_batched(cases, device="cpu")
    assert out["v"].shape == (7, 14) and out["converged"].shape == (7,)
    assert len(out["iterations_per_chunk"]) == 3
    np.testing.assert_allclose(out["v"], flat["v"], atol=5e-4)


def test_bad_warm_start_falls_back_to_flat():
    """An untrained small model's prediction leaves Newton's basin on these
    grids in both packages; every such grid is re-solved flat and spliced
    in, so the result equals the flat solve."""
    cfg = GNSConfig(K=2, latent_dim=8, hidden_dim=8, reference_parity=True)
    params = init_gns_params(jax.random.key(0), JConfig(**dataclasses.asdict(cfg)))
    model = module_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    cases = _feasible(6)
    got = hybrid.hybrid_solve(model, cfg, cases)
    want = j_hybrid.hybrid_solve(params, JConfig(**dataclasses.asdict(cfg)), cases)
    assert got["fallback_grids"] == want["fallback_grids"] > 0
    assert got["converged"].all()
    flat = solve_batched(cases, device="cpu")
    np.testing.assert_allclose(got["v"], flat["v"], atol=1e-6)
    assert got["fallback_iterations"] == flat["iterations"]


def test_hybrid_argument_errors(sup):
    model, cfg, _, _ = sup
    cases = _feasible(2)
    with pytest.raises(ValueError, match="solver"):
        hybrid.hybrid_solve(model, cfg, cases, solver="qr")
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        hybrid.hybrid_solve(model, cfg, cases, mesh=object())
