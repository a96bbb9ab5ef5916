"""gns_torch's fast-decoupled solver (eval/fdpf.py) against gns_tpu's, the
float64 oracle and the port's Newton solver, on the CPU.

Tolerances:
  * calc_injections against gns_tpu: rtol 1e-5, atol 1e-5 p.u. (the K1
    sums at the buses add in another order than gns_tpu's incidence
    matmul); against the dense trig-kernel formula: atol 2e-4
    (tests/test_fdpf.py's bound);
  * solve_batched_fdpf against the oracle: v 3e-5, theta 3e-3 degrees
    (tests/test_fdpf.py's bounds), and against gns_tpu the same bounds with
    equal converged masks. Per-grid counts are not compared: geometric
    convergence puts the mismatch a few 1e-6 from tol at the deciding
    iteration, where the two packages' roundings can fall on either side;
  * XB / BX on case118 against the port's Newton: v 3e-5;
  * warm start: the flat fixed point within 5e-5, at most 2 pairs a grid.
"""

import numpy as np
import pytest
import torch

from gns_tpu.eval import fdpf as j_fdpf
from gns_torch.eval import fdpf
from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.eval.nr_batched import build_nr_batch, solve_batched
from gns_torch.utils.augment import generate_cases

torch.set_num_threads(2)


def test_injections_match_gns_tpu_and_the_dense_formula():
    """The edge-list injections (one K2 gather and one K1 sum over the
    branch ends) equal gns_tpu's and the dense (S, N, N) formula the Newton
    solver uses, on perturbed grids (taps, shifts, shunts, status)."""
    cases = list(generate_cases(30, 4, seed=11))[1:]
    p, q = fdpf.calc_injections(cases, device="cpu")
    jp, jq = j_fdpf.calc_injections(cases)
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q, jq, rtol=1e-5, atol=1e-5)
    nb = build_nr_batch(cases)
    vm = np.stack([np.asarray(c["bus"])[:, 7] for c in cases]).astype(np.float32)
    va = np.deg2rad(np.stack([np.asarray(c["bus"])[:, 8] for c in cases])).astype(np.float32)
    cosmk = np.cos(va[:, :, None] - va[:, None, :])
    sinmk = np.sin(va[:, :, None] - va[:, None, :])
    a1 = nb.gmat * cosmk + nb.bmat * sinmk
    a2 = nb.gmat * sinmk - nb.bmat * cosmk
    np.testing.assert_allclose(p, vm * np.einsum("snk,sk->sn", a1, vm), atol=2e-4)
    np.testing.assert_allclose(q, vm * np.einsum("snk,sk->sn", a2, vm), atol=2e-4)


def test_fdpf_matches_oracle_and_gns_tpu():
    cases = list(generate_cases(30, 6, seed=3, feasible_only=True))[1:]
    res = fdpf.solve_batched_fdpf(cases, chunk_size=4, device="cpu")
    want = j_fdpf.solve_batched_fdpf(cases, chunk_size=4)
    assert res["converged"].all() and res["method"] == "fdpf"
    np.testing.assert_array_equal(res["converged"], want["converged"])
    np.testing.assert_allclose(res["v"], want["v"], atol=3e-5)
    np.testing.assert_allclose(res["theta_deg"], want["theta_deg"], atol=3e-3)
    assert len(res["iterations_per_chunk"]) == 2
    for i, c in enumerate(cases):
        ref = newton_raphson_pf(c)
        assert ref.success
        np.testing.assert_allclose(res["v"][i], ref.vm, atol=3e-5)
        np.testing.assert_allclose(res["theta_deg"][i], ref.va_deg, atol=3e-3)


@pytest.mark.parametrize("alg", ["XB", "BX"])
def test_fdpf_converges_stiff_case118(alg):
    """Both Stott-Alsac variants converge on the stiff case118 despite the
    float32 B inverses, to the Newton fixed point."""
    cases = list(generate_cases(118, 3, seed=5, feasible_only=True))[1:]
    res = fdpf.solve_batched_fdpf(cases, alg=alg, device="cpu")
    assert res["converged"].all()
    nr = solve_batched(cases, device="cpu")
    np.testing.assert_allclose(res["v"], nr["v"], atol=3e-5)


def test_fdpf_warm_start_same_fixed_point_fewer_iterations():
    cases = list(generate_cases(30, 4, seed=7, feasible_only=True))[1:]
    flat = fdpf.solve_batched_fdpf(cases, device="cpu")
    assert flat["converged"].all()
    warm = fdpf.solve_batched_fdpf(cases, warm_start=(flat["v"], np.deg2rad(flat["theta_deg"])),
                                   device="cpu")
    assert warm["converged"].all()
    np.testing.assert_allclose(warm["v"], flat["v"], atol=5e-5)
    assert (warm["iterations_per_grid"] <= 2).all()
    assert warm["iterations"] < flat["iterations"]


def test_fdpf_bad_arguments_raise():
    cases = list(generate_cases(14, 2, seed=0))[1:]
    with pytest.raises(ValueError):
        fdpf.solve_batched_fdpf(cases, alg="ZZ", device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        fdpf.solve_batched_fdpf(cases, mesh=object(), device="cpu")
