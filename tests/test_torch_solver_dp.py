"""gns_torch's data-parallel solvers, screens and predictor
(parallel/solver_dp.py) on a 4-rank gloo mesh on the CPU, against the
port's single-process run and against gns_tpu's sharded run on the
simulated 8-device mesh (tests/conftest.py).

One spawn (tests/torch_parallel_ranks.py job_solver) runs every case;
the tests read its saved results. Every rank must return the same whole
result.

Tolerances:
  * against the single-process port: gns_tpu's own sharded-vs-single
    bounds (tests/test_solver_dp.py:49-54): converged flags equal, v atol
    2e-6, theta atol 2e-4 degrees; iteration counts (lock-step, per chunk
    and per grid) equal; predictor v rtol 2e-5 / atol 1e-6 (:133);
  * against gns_tpu's sharded run: the cross-package bounds of
    tests/test_torch_nr_batched.py for Newton (v 2e-5, theta 2e-3 degrees,
    converged flags and iteration counts equal) and of
    tests/test_torch_fdpf.py for the fast-decoupled arms (v 3e-5, theta
    3e-3 degrees, converged flags equal; counts not compared, as there).
"""

import numpy as np
import pytest
import torch

from gns_tpu.eval import contingency as j_cont
from gns_tpu.eval import dcpf as j_dcpf
from gns_tpu.eval import fdpf as j_fdpf
from gns_tpu.eval import nr_batched as j_nr
from gns_tpu.eval import solve as j_solve
from gns_tpu.models.gns import init_gns_params
from gns_tpu.parallel.solver_dp import solver_mesh as j_solver_mesh
from gns_tpu.serve import GNSPredictor as JPredictor
from gns_torch.eval import contingency, dcpf, fdpf, hybrid, n2, nr_batched, solve
from gns_torch.models.convert import module_from_jax_params
from gns_torch.parallel import solver_dp
from gns_torch.serve import GNSPredictor
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.cases import load_case
from gns_torch.utils.config import GNSConfig
from torch_parallel_ranks import run_world

import jax

torch.set_num_threads(2)

WORLD = 4
CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, multiple_phi=True, seed=0)
V_DP, TH_DP = 2e-6, 2e-4  # sharded vs single (tests/test_solver_dp.py)
V_X, TH_X = 2e-5, 2e-3  # the port vs gns_tpu (tests/test_torch_nr_batched.py)


@pytest.fixture(scope="module")
def inputs():
    params = jax.tree.map(np.asarray, init_gns_params(jax.random.key(0), CFG))
    return dict(
        # 12 grids: one chunk of 12 over 4 ranks, and chunks of 5 (padded to 8)
        grids14=list(generate_cases(14, 12, seed=77, feasible_only=True))[:12],
        mixed=(list(generate_cases(14, 5, seed=3, feasible_only=True))[:5]
               + list(generate_cases(30, 5, seed=4, feasible_only=True))[:5]),
        case14=load_case(14), cfg=CFG, params=params,
    )


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_world("solver", WORLD, tmp_path_factory.mktemp("solver_dp"), inputs)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process runs of the same calls."""
    grids, case = inputs["grids14"], inputs["case14"]
    model = module_from_jax_params(inputs["params"], CFG, device="cpu")
    cpu = dict(device="cpu")
    return {
        "nr": nr_batched.solve_batched(grids, **cpu),
        "nr5": nr_batched.solve_batched(grids, chunk_size=5, **cpu),
        "nr_compact": nr_batched.solve_batched(grids, compact_after=1, **cpu),
        "fdpf": fdpf.solve_batched_fdpf(grids, **cpu),
        "dc": dcpf.solve_batched_dc(grids, **cpu),
        "ac": solve.solve_ac(grids, **cpu),
        "mixed": nr_batched.solve_mixed(inputs["mixed"], method="auto", **cpu),
        "hybrid": hybrid.hybrid_solve(model, CFG, grids),
        "screen": contingency.screen_n1(case, gen_outages=True, **cpu),
        "ranked": contingency.screen_n1_ranked(case, model, CFG, top_k=8, **cpu),
        "n2": n2.screen_n2(case, chunk_size=64, **cpu),
        "n2_ranked": n2.screen_n2_ranked(case, model, CFG, top_k=16, chunk_size=64, **cpu),
        "pred": GNSPredictor(model, CFG, batch_size=8, **cpu).predict(grids),
    }


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """gns_tpu's sharded runs on its 8-device mesh (12 grids: not a
    multiple of 8, so its pad-and-trim path runs too)."""
    mesh = j_solver_mesh()
    grids = inputs["grids14"]
    return {
        "nr": j_nr.solve_batched(grids, mesh=mesh),
        "fdpf": j_fdpf.solve_batched_fdpf(grids, mesh=mesh),
        "dc": j_dcpf.solve_batched_dc(grids, mesh=mesh),
        "ac": j_solve.solve_ac(grids, mesh=mesh),
        "screen": j_cont.screen_n1(inputs["case14"], gen_outages=True, mesh=mesh),
        "pred": JPredictor(inputs["params"], CFG, batch_size=16, mesh=mesh).predict(grids),
    }


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for other in ranks[1:]:
        for k, a in first.items():
            b = other[key][k]
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{key}.{k}")
            else:
                assert a == b, f"{key}.{k}"


def _hold(got, want, v_tol, th_tol, counts=True):
    np.testing.assert_array_equal(got["converged"], want["converged"])
    ok = want["converged"]
    np.testing.assert_allclose(got["v"][ok], want["v"][ok], rtol=0, atol=v_tol)
    np.testing.assert_allclose(got["theta_deg"][ok], want["theta_deg"][ok], rtol=0, atol=th_tol)
    if counts:
        assert got["iterations"] == want["iterations"]
        np.testing.assert_array_equal(got["iterations_per_grid"], want["iterations_per_grid"])


SOLVES = ("nr", "nr5", "nr_compact", "fdpf", "ac", "hybrid")


@pytest.mark.parametrize("key", SOLVES)
def test_sharded_solve_equals_single_process(ranks, single, key):
    _same_on_every_rank(ranks, key)
    got, want = ranks[0][key], single[key]
    _hold(got, want, V_DP, TH_DP)
    assert got["iterations_per_chunk"] == want["iterations_per_chunk"]
    np.testing.assert_array_equal(got["stalled"], want["stalled"])
    for k in ("warm_start", "method", "compact_after", "fallback_grids"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("key", ("nr", "fdpf", "ac"))
def test_sharded_solve_matches_gns_tpu(ranks, jax_sharded, key):
    got, want = ranks[0][key], jax_sharded[key]
    if key == "nr":
        _hold(got, want, V_X, TH_X)
    else:
        _hold(got, want, 3e-5, 3e-3, counts=False)


def test_padded_rows(ranks):
    assert list(ranks[0]["padded"]) == [12, 16, 4, 12]
    assert solver_dp.padded_rows(12, None) == 12
    np.testing.assert_array_equal(solver_dp.pad_rows(np.arange(3), 5), [0, 1, 2, 2, 2])
    with pytest.raises(ValueError, match="exceeds"):
        solver_dp.pad_rows(np.arange(3), 2)
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        solver_dp.dp_size(object())
    # without a mesh: the whole array, on the device asked for
    arr = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(solver_dp.put_dp(None, arr, device="cpu").numpy(), arr)
    tree = solver_dp.put_repl(None, {"a": arr, "b": [arr[0]]}, device="cpu")
    assert torch.is_tensor(tree["a"]) and torch.is_tensor(tree["b"][0])


class _Mesh:
    """The part of a DeviceMesh that put_dp / put_repl read: a 2-rank "dp"
    axis of `device_type`, seen from dp rank 1."""

    mesh_dim_names = ("dp",)

    def __init__(self, device_type):
        self.device_type = device_type

    def size(self, dim=None):
        return 2

    def get_local_rank(self, name):
        return 1


def test_put_dp_places_on_the_mesh_device(monkeypatch):
    """Without a device argument the rows go to the mesh's device: the
    current card on a "cuda" mesh (never the CPU), the card without a
    mesh."""
    arr = np.arange(8.0).reshape(4, 2)
    got = solver_dp.put_dp(_Mesh("meta"), arr)
    assert got.device.type == "meta" and got.shape == (2, 2)
    assert solver_dp.put_repl(_Mesh("meta"), {"a": arr})["a"].device.type == "meta"
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert solver_dp.mesh_device(_Mesh("cuda")) == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            solver_dp.put_dp(_Mesh("cuda"), arr)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver_dp.put_dp(None, arr)
    np.testing.assert_array_equal(solver_dp.put_dp(_Mesh("cuda"), arr, device="cpu").numpy(),
                                  arr[2:])


def test_exit_test_is_one_all_reduce_per_iteration(ranks):
    """Collectives of a sharded Newton solve, as the code gives them: one
    all-reduce (MIN) of the exit test per loop pass (the host syncs less
    one fetch per chunk), one all-gather of the packed result per chunk,
    one broadcast of compact_after's resolution."""
    for key in ("nr", "nr5", "fdpf"):
        got, coll = ranks[0][key], ranks[0][f"{key}_coll"]
        chunks = len(got["iterations_per_chunk"])
        want = {"all_reduce": got["host_syncs"] - chunks, "all_gather": chunks}
        if key != "fdpf":
            want["broadcast"] = 1
        assert coll == want, key
    # the chunks of 5 run the same iteration counts as one chunk of 12
    assert ranks[0]["nr5"]["iterations"] == ranks[0]["nr"]["iterations"]


def test_dc_sharded(ranks, single, jax_sharded):
    _same_on_every_rank(ranks, "dc")
    got = ranks[0]["dc"]
    for want, tol in ((single["dc"], 1.0), (jax_sharded["dc"], 10.0)):
        np.testing.assert_allclose(got["theta_deg"], want["theta_deg"], rtol=0, atol=2e-4 * tol)
        np.testing.assert_allclose(got["pf_mw"], want["pf_mw"], rtol=0, atol=2e-3 * tol)
        np.testing.assert_allclose(got["p_slack_mw"], want["p_slack_mw"], rtol=0, atol=2e-3 * tol)


def test_solve_mixed_sharded(ranks, single):
    got, want = ranks[0]["mixed"], single["mixed"]
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_array_equal(got["iterations_per_grid"], want["iterations_per_grid"])
    mask = np.isfinite(want["v"])
    np.testing.assert_allclose(got["v"][mask], want["v"][mask], atol=V_DP)


@pytest.mark.parametrize("key", ("screen", "n2"))
def test_screen_sharded_same_verdicts(ranks, single, key):
    _same_on_every_rank(ranks, key)
    got, want = ranks[0][key], single[key]
    for k in ("converged", "v_violations", "flow_violations", "worst", "iterations_per_grid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    conv = want["converged"]
    np.testing.assert_allclose(got["v"][conv], want["v"][conv], atol=V_DP)
    np.testing.assert_allclose(got["theta_deg"][conv], want["theta_deg"][conv], atol=TH_DP)


def test_screen_n1_matches_gns_tpu_sharded(ranks, jax_sharded):
    got, want = ranks[0]["screen"], jax_sharded["screen"]
    for k in ("converged", "v_violations", "worst"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    conv = want["converged"]
    np.testing.assert_allclose(got["v"][conv], want["v"][conv], atol=V_X)


def test_n2_collectives(ranks):
    """screen_n2 over 4 ranks: 190 case14 pairs in chunks of 64 (the last
    padded to 64 and each split 16 a rank), one all-gather per chunk."""
    got, coll = ranks[0]["n2"], ranks[0]["n2_coll"]
    chunks = len(got["iterations_per_chunk"])
    assert chunks == 3
    assert coll == {"all_reduce": got["host_syncs"] - chunks, "all_gather": chunks}


@pytest.mark.parametrize("key", ("ranked", "n2_ranked"))
def test_ranked_screens_sharded(ranks, single, key):
    got, want = ranks[0][key], single[key]
    for k in ("islanded", "verified_idx", "converged", "iterations_per_grid", "worst"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pv = "pred_v"
    np.testing.assert_allclose(got[pv], want[pv], rtol=2e-5, atol=1e-6)
    conv = want["converged"]
    np.testing.assert_allclose(got["v"][conv], want["v"][conv], atol=V_DP)


def test_predictor_sharded(ranks, single, jax_sharded):
    _same_on_every_rank(ranks, "pred")
    got = ranks[0]["pred"]
    np.testing.assert_allclose(got["v"], single["pred"]["v"], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["theta"], single["pred"]["theta"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got["last_loss"], single["pred"]["last_loss"], rtol=2e-5)
    # gns_tpu's sharded predictor, at tests/test_torch_serve.py's bounds
    np.testing.assert_allclose(got["v"], jax_sharded["pred"]["v"], rtol=2e-5, atol=1e-5)
    # 12 requests in batches of 8 over 4 ranks: one all-gather per batch
    assert ranks[0]["pred_coll"] == {"all_gather": 2}
    assert "must divide the mesh's dp axis (4)" in ranks[0]["pred_error"]
