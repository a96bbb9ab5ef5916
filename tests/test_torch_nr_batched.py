"""gns_torch's batched Newton-Raphson solver (eval/nr_batched.py) against
gns_tpu's and the float64 oracle, on the CPU.

Tolerances:
  * solve_batched against gns_tpu and against newton_raphson_pf: v 2e-5,
    theta 2e-3 degrees (tests/test_eval.py:209-226's bounds); converged
    masks, lock-step counts per chunk and per-grid counts equal;
  * the device assembly against the host complex128 Ybus: rtol 2e-5,
    atol 2e-4 (tests/test_hybrid.py:107's bounds); the host paths of both
    packages are the same numpy code and compare equal;
  * compaction against lock-step, solve_mixed against per-topology solves:
    test_hybrid.py's bounds (v 2e-5, theta 2e-3; 1e-6 for the same solve).
The stall gate, compaction and solve_mixed checks are port-only (the
lock-step solve they rest on is held to gns_tpu in the first test).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gns_tpu.eval import nr_batched as j_nr
from gns_torch.eval import nr_batched as nr
from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.utils.augment import generate_cases

torch.set_num_threads(2)


def _feasible(case_nr, n, seed=31415):
    return list(generate_cases(case_nr, n, seed=seed, feasible_only=True))[1:]


@pytest.fixture(scope="module")
def case30():
    return list(generate_cases(30, 6, seed=3, feasible_only=True))[1:]


@pytest.fixture(scope="module")
def solved(case30):
    """The port's solve and gns_tpu's on the same six grids, chunks of 4."""
    return (nr.solve_batched(case30, chunk_size=4, device="cpu"),
            j_nr.solve_batched(case30, chunk_size=4))


def test_solve_batched_matches_gns_tpu(solved):
    got, want = solved
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert got["converged"].all()
    assert got["iterations_per_chunk"] == want["iterations_per_chunk"]
    assert got["iterations"] == want["iterations"]
    np.testing.assert_array_equal(got["iterations_per_grid"], want["iterations_per_grid"])
    np.testing.assert_array_equal(got["stalled"], want["stalled"])
    np.testing.assert_allclose(got["v"], want["v"], atol=2e-5)
    np.testing.assert_allclose(got["theta_deg"], want["theta_deg"], atol=2e-3)
    # one exit test per loop iteration and one fetch per chunk
    assert got["host_syncs"] == sum(it + 1 for it in got["iterations_per_chunk"]) + 2


def test_solve_batched_matches_the_oracle(case30, solved):
    got, _ = solved
    for i, c in enumerate(case30):
        ref = newton_raphson_pf(c)
        assert ref.success
        np.testing.assert_allclose(got["v"][i], ref.vm, atol=2e-5)
        np.testing.assert_allclose(got["theta_deg"][i], ref.va_deg, atol=2e-3)


def test_device_assembly_matches_host_complex_path():
    """_assemble_gb (K1 over the admittance pattern, then one store)
    reproduces the host complex128 Ybus across taps, phase shifts, line
    charging, shunts and out-of-service branches; the host path equals
    gns_tpu's."""
    cases = list(generate_cases(30, 5, seed=77))[1:]
    for c in cases:
        c["branch"] = np.asarray(c["branch"], float).copy()
    cases[0]["branch"][3, 9] = 7.5  # shift degrees
    cases[1]["branch"][5, 10] = 0.0  # status off
    bus, branch, gen, base = nr.stack_cases(cases)
    host = nr.build_nr_batch_stacked(bus, branch, gen, base)
    j_host = j_nr.build_nr_batch_stacked(bus, branch, gen, base)
    for a, b in zip(host, j_host):
        np.testing.assert_array_equal(a, b)
    f = branch[0, :, 0].astype(np.int64) - 1
    t = branch[0, :, 1].astype(np.int64) - 1
    pattern = nr.admittance_pattern(f, t, bus.shape[1], "cpu")
    assert pattern.index.edges == 4 * len(f) + bus.shape[1]
    assert len(np.unique(pattern.slots.numpy())) == pattern.slots.numel()
    g, b = nr._assemble_gb(*(torch.as_tensor(a, dtype=torch.float32) for a in (bus, branch, base)),
                           pattern, has_status=True)
    np.testing.assert_allclose(g.numpy(), host.gmat, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(b.numpy(), host.bmat, rtol=2e-5, atol=2e-4)
    j_g, j_b = j_nr._assemble_gb(
        jnp.asarray(bus, jnp.float32), jnp.asarray(branch, jnp.float32),
        jnp.asarray(base, jnp.float32), jnp.asarray(f.astype(np.int32)),
        jnp.asarray(t.astype(np.int32)), has_status=True,
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(j_b), rtol=2e-5, atol=2e-4)


def test_stall_gate_converges_stiff_case118():
    """The authentic case118's stiff 345 kV branches put the float32
    mismatch floor near tol; the stalled-at-floor gate accepts those grids
    at their attainable iterate, and the iterate matches the oracle."""
    cases = _feasible(118, 32)
    out = nr.solve_batched(cases, tol=3e-5, device="cpu")
    assert out["converged"].all()
    assert out["iterations"] < 10
    np.testing.assert_array_equal(out["stalled"], out["converged"] & (out["mismatch"] >= 3e-5))
    np.testing.assert_allclose(out["v"][0], newton_raphson_pf(cases[0]).vm, atol=2e-5)


def test_compaction_matches_lockstep():
    """compact_after: the same fixed points and flags as lock-step; the
    stragglers continue from their iterates in a power-of-2 sub-batch."""
    cases = _feasible(30, 12)
    lock = nr.solve_batched(cases, tol=3e-5, device="cpu")
    comp = nr.solve_batched(cases, tol=3e-5, compact_after=3, device="cpu")
    assert lock["converged"].all() and comp["converged"].all()
    np.testing.assert_allclose(comp["v"], lock["v"], atol=2e-5)
    np.testing.assert_allclose(comp["theta_deg"], lock["theta_deg"], atol=2e-3)
    assert comp["iterations_per_grid"].min() <= lock["iterations"]
    assert (comp["iterations_per_grid"] <= comp["iterations"]).all()


def test_solve_mixed_groups_heterogeneous_topologies():
    """solve_mixed: a shuffled mix of case9 / case14 / case30 grids solves
    in per-topology groups and comes back in request order, equal to the
    per-case solves; method="fdpf" reaches the same fixed points."""
    c9, c14, c30 = _feasible(9, 3, seed=1), _feasible(14, 3, seed=2), _feasible(30, 3, seed=3)
    mixed = [c9[0], c30[0], c14[0], c14[1], c9[1], c30[1], c14[2], c9[2], c30[2]]
    out = nr.solve_mixed(mixed, device="cpu")
    assert out["n_groups"] == 3 and out["converged"].all()
    assert out["v"].shape == (9, 30)
    ref9 = nr.solve_batched(c9, device="cpu")
    ref30 = nr.solve_batched(c30, device="cpu")
    np.testing.assert_allclose(out["v"][0, :9], ref9["v"][0], atol=1e-6)
    np.testing.assert_allclose(out["v"][5, :30], ref30["v"][1], atol=1e-6)
    assert np.isnan(out["v"][0, 9:]).all()
    assert out["n_bus"].tolist() == [9, 30, 14, 14, 9, 30, 14, 9, 30]
    fd = nr.solve_mixed(mixed, method="fdpf", device="cpu")
    assert fd["converged"].all() and fd["n_groups"] == 3
    np.testing.assert_allclose(fd["v"][0, :9], ref9["v"][0], atol=5e-5)


def test_singular_member_reports_non_converged():
    """A grid whose Jacobian is singular (bus 26 of case30 islanded: its
    only branch out of service) is reported non-converged, with no
    exception (lu_factor_ex does not check); the other grids' results
    equal those of the batch without it."""
    cases = _feasible(30, 4, seed=5)
    bad = {**cases[1], "branch": np.asarray(cases[1]["branch"], float).copy()}
    br = bad["branch"]
    only = np.flatnonzero((br[:, 0] == 26) | (br[:, 1] == 26))
    assert only.size == 1
    br[only, 10] = 0.0
    batch = [cases[0], bad, *cases[2:]]
    out = nr.solve_batched(batch, device="cpu")
    assert out["converged"].tolist() == [True, False, True, True]
    assert out["iterations"] == 20  # the singular member runs to max_iter
    alone = nr.solve_batched([cases[0], *cases[2:]], device="cpu")
    keep = [0, 2, 3]
    np.testing.assert_array_equal(out["iterations_per_grid"][keep], alone["iterations_per_grid"])
    np.testing.assert_allclose(out["v"][keep], alone["v"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["theta_deg"][keep], alone["theta_deg"], rtol=0, atol=1e-5)


def test_resolve_compact_after_measures_rtt():
    rtt = nr.measured_dispatch_rtt("cpu")
    assert rtt > 0
    assert nr.resolve_compact_after(5, device="cpu") == 5
    assert nr.resolve_compact_after(0, device="cpu") == 0
    assert nr.resolve_compact_after("auto", rtt_breakeven=rtt * 2, device="cpu") == 3
    assert nr.resolve_compact_after("auto", rtt_breakeven=rtt / 2, device="cpu") == 0


def test_warm_start_from_solution_and_mesh(case30, solved):
    """Seeding with the solve's own fixed point converges in at most one
    iteration to the same solution; the slack keeps its input angle. An
    object that is not a mesh with a "dp" axis raises the mesh error."""
    flat, _ = solved
    warm = nr.solve_batched(case30, warm_start=(flat["v"], np.deg2rad(flat["theta_deg"])),
                            device="cpu")
    assert warm["converged"].all() and warm["iterations"] <= 1
    np.testing.assert_allclose(warm["v"], flat["v"], atol=2e-5)
    np.testing.assert_allclose(warm["theta_deg"], flat["theta_deg"], atol=2e-3)
    for i, c in enumerate(case30):
        slack = int(np.flatnonzero(np.asarray(c["bus"])[:, 1] == 3)[0])
        assert abs(warm["theta_deg"][i, slack] - c["bus"][slack, 8]) < 1e-6
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        nr.solve_batched(case30, mesh=object(), device="cpu")
