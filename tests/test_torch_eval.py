"""gns_torch's evaluation path against gns_tpu's, on the CPU: the
Newton-Raphson oracle, feasible sampling, the per-grid GNS run, the metrics,
the plot and the CLI.

Parameters are gns_tpu's init_gns_params carried over with
module_from_jax_params, so both packages run the same weights. Tolerances:
  * newton_raphson_pf: 1e-12 on vm and va (the same float64 algorithm, the
    same scipy sparse LU); success and the iteration count exactly;
  * generate_cases(feasible_only=True): equal array for array (the same
    numpy stream and the same accept / reject decisions);
  * run_gns: v, theta, last_loss and line flows at tests/test_torch_serve.py's
    bounds (rtol 2e-5, atol 1e-5);
  * compute_metrics on identical inputs: rtol 1e-12 (the same numpy code).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from gns_tpu.eval import harness as j_harness
from gns_tpu.eval.newton_raphson import newton_raphson_pf as j_newton_raphson_pf
from gns_tpu.models.gns import init_gns_params
from gns_tpu.utils import augment as j_augment
from gns_tpu.utils.config import GNSConfig as JConfig
from gns_torch.eval import harness
from gns_torch.eval.__main__ import main as eval_main
from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.models.convert import module_from_jax_params
from gns_torch.utils import cases as case_tables
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig

torch.set_num_threads(1)

CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, reference_parity=False)
J_CFG = JConfig(**dataclasses.asdict(CFG))
RUN_TOL = dict(rtol=2e-5, atol=1e-5)  # tests/test_torch_serve.py TOL


@pytest.fixture(scope="module")
def models():
    params = init_gns_params(jax.random.key(0), J_CFG)
    return params, module_from_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


@pytest.mark.parametrize("case", [9, 14, 30, 118, 300])
def test_newton_raphson_matches_gns_tpu(case):
    """The port's NR oracle on the base case equals gns_tpu's: vm, va to
    1e-12, success and iterations exactly, and the solved bus / gen arrays."""
    base = case_tables.load_case(case)
    got, want = newton_raphson_pf(base), j_newton_raphson_pf(base)
    assert got.success == want.success and got.iterations == want.iterations
    assert got.success
    np.testing.assert_allclose(got.vm, want.vm, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.va_deg, want.va_deg, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.bus, want.bus, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.gen, want.gen, rtol=1e-12, atol=1e-12)


def test_feasible_cases_match_gns_tpu():
    """generate_cases(30, 8, seed=3, feasible_only=True) equals gns_tpu's
    array for array, and every case is NR-feasible."""
    got = list(generate_cases(30, 8, seed=3, feasible_only=True))
    want = list(j_augment.generate_cases(30, 8, seed=3, feasible_only=True))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
        assert newton_raphson_pf(g).success


def test_feasible_sampling_raises_when_nothing_converges():
    with pytest.raises(RuntimeError, match="no NR-feasible augmentation"):
        list(generate_cases(300, 1, seed=0, feasible_only=True, max_tries_per_case=1, scale=5.0))


@pytest.mark.parametrize("case, n", [(14, 8), (30, 4)])
def test_run_gns_matches_gns_tpu(models, case, n):
    """run_gns with the same weights on n grids: v, theta (slack-aligned),
    last_loss and the line flows against gns_tpu's run_gns."""
    params, model = models
    cases = list(generate_cases(case, n - 1, seed=5))
    got = harness.run_gns(model, CFG, cases)
    want = j_harness.run_gns(params, J_CFG, cases, method="scatter")
    assert got.keys() == want.keys()
    for key in ("v", "theta", "last_loss", "line_flow"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **RUN_TOL)
    assert got["time"].shape == (n,) and np.all(got["time"] > 0)


def _metric_inputs(converged):
    rng = np.random.default_rng(4)
    s, n, e = 6, 9, 11
    nr = {"time": rng.uniform(1e-3, 2e-3, s).astype(np.float32),
          "v": (1 + 0.05 * rng.standard_normal((s, n))).astype(np.float32),
          "theta_deg": (5 * rng.standard_normal((s, n))).astype(np.float32),
          "line_flow": rng.standard_normal((s, e)).astype(np.float32),
          "converged": np.asarray(converged)}
    nr["theta_deg"][:, 0] = 0.0  # a slack angle of 0: an infinite percent error, left out
    gns = {"time": rng.uniform(1e-3, 2e-3, s).astype(np.float32),
           "v": nr["v"] + (0.01 * rng.standard_normal((s, n))).astype(np.float32),
           "theta": (np.deg2rad(nr["theta_deg"])
                     + 0.01 * rng.standard_normal((s, n))).astype(np.float32),
           "last_loss": rng.uniform(0, 1e-3, s).astype(np.float32),
           "line_flow": nr["line_flow"] + (0.1 * rng.standard_normal((s, e))).astype(np.float32)}
    return nr, gns


@pytest.mark.parametrize("converged", [[True] * 6, [True, False, True, True, False, True]])
def test_compute_metrics_matches_gns_tpu(converged):
    """Every key of gns_tpu's metric dict, on identical inputs, with and
    without non-converged oracle grids (which both drop)."""
    nr, gns = _metric_inputs(converged)
    got = harness.compute_metrics(nr, gns)
    want = j_harness.compute_metrics(nr, gns)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
    assert got["nr_converged_frac"] == np.mean(converged)
    with pytest.raises(ValueError):
        harness.compute_metrics({**nr, "converged": np.zeros(6, bool)}, gns)


def test_nr_oracle_matches_and_batched_raises(monkeypatch):
    """The scipy oracle equals gns_tpu's; the batched backend runs on the
    card by default, so without one it raises (its results are held in
    test_batched_nr_oracle_matches_gns_tpu)."""
    cases = list(generate_cases(14, 3, seed=8))
    got, want = harness.run_nr_oracle(cases), j_harness.run_nr_oracle(cases)
    for key in ("v", "theta_deg", "line_flow", "converged"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.run_nr_oracle(cases, backend="batched")
    with pytest.raises(ValueError):
        harness.run_nr_oracle(cases, backend="bogus")


def test_evaluate_writes_the_plot(models, tmp_path):
    """evaluate(): NR and the GNS on the same 4 grids, gns_tpu's metric
    keys, and the per-bus error plot written where asked."""
    _, model = models
    cases = list(generate_cases(14, 3, seed=6))
    path = tmp_path / "plots" / "per_bus.png"
    m = harness.evaluate(model, CFG, cases, plot_path=str(path), verbose=False)
    assert path.exists() and path.stat().st_size > 0 and m["plot"] == str(path)
    nr = j_harness.run_nr_oracle(cases)
    assert set(m) - {"plot"} == set(j_harness.compute_metrics(nr, harness.run_gns(model, CFG,
                                                                                    cases)))
    assert m["nr_converged_frac"] == 1.0 and np.isfinite(m["v_mse"])


def test_eval_cli_on_the_cpu(tmp_path):
    """python -m gns_torch.eval --cpu on 4 generated feasible grids with the
    shipped case14 checkpoint: the metrics JSON and the plot, and the same
    metrics as evaluate() with the same model on the same grids."""
    out, plot = tmp_path / "m.json", tmp_path / "p.png"
    m = eval_main(["--case", "14", "--samples", "4", "--from-base-case", "--feasible-only",
                   "--seed", "7", "--checkpoint", "pretrained", "--cpu",
                   "--plot", str(plot), "--json-out", str(out)])
    assert plot.exists()
    saved = json.loads(out.read_text())
    assert saved["nr_converged_frac"] == 1.0 and saved["v_mse"] == m["v_mse"]
    from gns_torch.models.pretrained import load_pretrained

    model, cfg = load_pretrained(14, device="cpu")
    cases = list(generate_cases(14, 3, seed=7, feasible_only=True))
    again = harness.evaluate(model, cfg, cases, verbose=False)
    for key in ("v_mse", "theta_mse", "alf_pct_median", "last_loss_mean"):
        assert again[key] == saved[key], key


def test_batched_nr_oracle_matches_gns_tpu():
    """run_nr_oracle(backend="batched") on the CPU: gns_tpu's dict
    contract, its values (v 2e-5, theta 2e-3 degrees), and agreement with
    the scipy backend at tests/test_eval.py's bounds (line flows, which
    carry the float32 angles, at rtol / atol 1e-3)."""
    cases = list(generate_cases(30, 6, seed=3, feasible_only=True))[1:]
    got = harness.run_nr_oracle(cases, backend="batched", device="cpu")
    want = j_harness.run_nr_oracle(cases, backend="batched")
    scipy = harness.run_nr_oracle(cases)
    assert got.keys() == want.keys()
    assert got["converged"].all() and got["time"].shape == (6,) and (got["time"] > 0).all()
    assert got["v"].shape == (6, 30) and got["line_flow"].shape == want["line_flow"].shape
    np.testing.assert_array_equal(got["converged"], want["converged"])
    for ref in (want, scipy):
        np.testing.assert_allclose(got["v"], ref["v"], atol=2e-5)
        np.testing.assert_allclose(got["theta_deg"], ref["theta_deg"], atol=2e-3)
    np.testing.assert_allclose(got["line_flow"], scipy["line_flow"], rtol=1e-3, atol=1e-3)
