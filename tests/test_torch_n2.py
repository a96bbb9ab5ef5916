"""gns_torch's N-2 screens (eval/n2.py) against gns_tpu's, on the CPU, with
the same case dicts and the same shipped checkpoint loaded into both
packages.

Tolerances:
  * the host functions (n2_pairs, n2_islanding_pairs, n2_branch_loading)
    are the same numpy code: equal, bit for bit;
  * verdicts (converged, islanded, worst, violation counts, verified_idx)
    equal on every pair;
  * solved states at v 2e-5 and theta 2e-3 degrees (tests/test_eval.py's
    Newton bounds), except theta on the balanced-island class: case14's
    pair (4-7, 7-9) islands buses {7, 8} with zero load and a Pg=0
    condenser, so Newton "converges" there at a singular Jacobian with an
    arbitrary island angle (gns_tpu/eval/n2.py:78-85); it is the one pair
    named below, and its v still holds;
  * per-pair iteration counts equal, or one apart where the run that
    stopped first accepted the pair at its tol gate's edge (mismatch >=
    tol / 2: chip_smoke.py's SOLVE_EDGE rule); on case118, whose float32
    mismatch floor sits at tol, counts may differ wherever either run
    accepted the pair at that floor (mismatch >= tol / 2), by at most 2;
  * device-built variants against explicit variant dicts through the
    port's solve_ac: equal verdicts, v within 1e-6 (tests/test_n2.py's);
  * GNS predictions at tests/test_torch_serve.py's bounds (v rtol 2e-5 /
    atol 1e-5, theta 1e-3 degrees); severities within 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

from gns_tpu.eval import n2 as j_n2
from gns_tpu.models import pretrained as j_pretrained
from gns_torch.eval import n2
from gns_torch.eval.solve import solve_ac
from gns_torch.models.pretrained import load_pretrained
from gns_torch.utils.cases import load_case

torch.set_num_threads(2)

V_TOL, TH_TOL, EDGE = 2e-5, 2e-3, 0.5
BALANCED_ISLAND = (7, 14)  # case14 branch rows 4-7 and 7-9


@pytest.fixture(scope="module")
def case14():
    return load_case(14)


@pytest.fixture(scope="module")
def n1_models():
    model, cfg = load_pretrained("14-n1", device="cpu")
    params, j_cfg = j_pretrained.load_pretrained("14-n1")
    return model, cfg, params, j_cfg


def _variants(case, pairs):
    out = []
    for a, b in pairs:
        v = copy.deepcopy(case)
        v["branch"] = np.asarray(v["branch"], np.float64).copy()
        v["branch"][[a, b], 10] = 0.0
        out.append(v)
    return out


def _floor_counts(got, want, conv, tol=3e-5):
    """Indices whose per-pair counts differ, and those of them accepted at
    the float32 floor (mismatch >= EDGE x tol) in either run."""
    a, b = got["iterations_per_grid"], want["iterations_per_grid"]
    diff = np.flatnonzero(a != b)
    floor = conv[diff] & (np.maximum(got["mismatch"], want["mismatch"])[diff] >= EDGE * tol)
    return diff, diff[floor]


def _hold(got, want, pairs, tol=3e-5):
    for key in ("converged", "islanded", "v_violations", "flow_violations", "worst"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ok = want["converged"]
    np.testing.assert_allclose(got["v"][ok], want["v"][ok], rtol=0, atol=V_TOL)
    balanced = np.array([tuple(p) == BALANCED_ISLAND for p in pairs])
    both = ok & ~balanced
    np.testing.assert_allclose(got["theta_deg"][both], want["theta_deg"][both], rtol=0,
                               atol=TH_TOL)
    diff = np.flatnonzero(got["iterations_per_grid"] != want["iterations_per_grid"])
    for g in diff:
        a, b = int(got["iterations_per_grid"][g]), int(want["iterations_per_grid"][g])
        first = got if a < b else want
        assert abs(a - b) == 1 and ok[g] and first["mismatch"][g] >= EDGE * tol, (g, a, b)


@pytest.mark.parametrize("case_nr", [14, 118])
def test_pairs_and_islanding_match_gns_tpu(case_nr):
    case = load_case(case_nr)
    pairs = n2.n2_pairs(case)
    np.testing.assert_array_equal(pairs, j_n2.n2_pairs(case))
    e = np.asarray(case["branch"]).shape[0]
    assert pairs.shape == (e * (e - 1) // 2, 2) and pairs.dtype == np.int32
    isl = n2.n2_islanding_pairs(case, pairs)
    np.testing.assert_array_equal(isl, j_n2.n2_islanding_pairs(case, pairs))
    if case_nr == 118:
        assert pairs.shape[0] == 17205 and int(isl.sum()) == 1703


@pytest.mark.parametrize("method", ["fdpf", "nr"])
def test_device_built_variants_equal_explicit_variants(case14, method):
    """The status zeros written into the repeated branch stack give what
    explicit double-outage case dicts give through solve_ac."""
    pairs = n2.n2_pairs(case14)
    sel = pairs[np.random.default_rng(0).choice(pairs.shape[0], 24, replace=False)]
    rep = n2.screen_n2(case14, sel, method=method, device="cpu")
    ref = solve_ac(_variants(case14, sel), warm_start="flat", method=method,
                   fallback_flat=False, chunk_size=len(sel), compact_after=0, device="cpu")
    np.testing.assert_array_equal(rep["converged"], ref["converged"])
    ok = ref["converged"]
    np.testing.assert_allclose(rep["v"][ok], ref["v"][ok], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rep["iterations_per_grid"], ref["iterations_per_grid"])


@pytest.mark.parametrize("method", ["fdpf", "nr"])
def test_screen_n2_matches_gns_tpu(case14, method):
    """All 190 pairs of case14 in chunks of 64 (the last padded): verdicts
    equal on every pair. Structurally islanded pairs are non-converged,
    except the balanced island under Newton in both packages."""
    pairs = n2.n2_pairs(case14)
    got = n2.screen_n2(case14, pairs, method=method, chunk_size=64, device="cpu")
    want = j_n2.screen_n2(case14, pairs, method=method, chunk_size=64)
    _hold(got, want, pairs)
    assert got["method"] == method and len(got["iterations_per_chunk"]) == 3
    converged_islands = {tuple(p) for p in pairs[got["islanded"] & got["converged"]]}
    assert converged_islands == ({BALANCED_ISLAND} if method == "nr" else set())
    assert got["host_syncs"] > 3


def test_screen_n2_case118_at_the_float32_floor():
    """The first 512 pairs of the authentic case118: verdicts and states as
    above. Its stiff branches put float32's mismatch floor (about 2.5e-5)
    at tol, so a converged pair's mismatch wanders around tol from one
    iteration to the next and rounding decides which iteration accepts it:
    per-pair counts may then differ, but only where either run accepted
    the pair at that floor (mismatch >= tol / 2; chip_smoke.py
    hold_counts)."""
    case = load_case(118)
    pairs = n2.n2_pairs(case)[:512]
    got = n2.screen_n2(case, pairs, device="cpu")
    want = j_n2.screen_n2(case, pairs)
    for key in ("converged", "islanded", "v_violations", "worst"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ok = want["converged"]
    np.testing.assert_allclose(got["v"][ok], want["v"][ok], rtol=0, atol=V_TOL)
    np.testing.assert_allclose(got["theta_deg"][ok], want["theta_deg"][ok], rtol=0, atol=TH_TOL)
    diff, at_floor = _floor_counts(got, want, ok)
    np.testing.assert_array_equal(diff, at_floor)
    assert (np.abs(got["iterations_per_grid"] - want["iterations_per_grid"]) <= 2).all()


def test_warm_start_reaches_the_same_fixed_point(case14):
    pairs = n2.n2_pairs(case14)
    pairs = pairs[~n2.n2_islanding_pairs(case14, pairs)][:32]
    flat = n2.screen_n2(case14, pairs, device="cpu")
    n = np.asarray(case14["bus"]).shape[0]
    rng = np.random.default_rng(1)
    warm = (1.0 + 0.02 * rng.standard_normal((32, n)).astype(np.float32),
            0.05 * rng.standard_normal((32, n)).astype(np.float32))
    got = n2.screen_n2(case14, pairs, warm_start=warm, device="cpu")
    want = j_n2.screen_n2(case14, pairs, warm_start=warm)
    np.testing.assert_array_equal(got["converged"], flat["converged"])
    assert flat["converged"].all()
    np.testing.assert_allclose(got["v"], flat["v"], rtol=0, atol=5e-5)
    _hold(got, want, pairs)


@pytest.mark.parametrize("score", ["depth", "rms"])
def test_screen_n2_ranked_matches_gns_tpu(case14, n1_models, score):
    model, cfg, params, j_cfg = n1_models
    pairs = n2.n2_pairs(case14)
    got = n2.screen_n2_ranked(case14, model, cfg, pairs, top_k=16, score=score, chunk_size=64,
                              device="cpu")
    want = j_n2.screen_n2_ranked(case14, params, j_cfg, pairs, top_k=16, score=score,
                                 chunk_size=64)
    for key in ("islanded", "verified_idx", "converged", "v_violations", "flow_violations",
                "worst"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_solves"] == want["n_solves"] == 16
    fin = np.isfinite(want["severity"])
    np.testing.assert_array_equal(np.isfinite(got["severity"]), fin)
    np.testing.assert_allclose(got["severity"][fin], want["severity"][fin], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["pred_v"], want["pred_v"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(np.rad2deg(got["pred_theta"]), np.rad2deg(want["pred_theta"]),
                               rtol=0, atol=1e-3)
    vi = got["verified_idx"]
    assert not got["islanded"][vi].any()
    ok = want["converged"]
    np.testing.assert_allclose(got["v"][ok], want["v"][ok], rtol=0, atol=V_TOL)


def test_n2_flow_screening_case30():
    """case30's published ratings: every converged pair inherits the base
    overload, non-converged pairs count 0, and the pairwise loadings equal
    gns_tpu's and the explicit variants' ac_branch_loading."""
    from gns_torch.eval.contingency import ac_branch_loading

    case = load_case(30)
    pairs = n2.n2_pairs(case)
    got = n2.screen_n2(case, pairs, device="cpu")
    want = j_n2.screen_n2(case, pairs)
    _hold(got, want, pairs)
    conv = got["converged"]
    assert (got["flow_violations"][conv] >= 1).all()
    assert (got["flow_violations"][~conv] == 0).all()
    sel = np.flatnonzero(conv)[:12]
    fast = n2.n2_branch_loading(case, pairs[sel], got["v"][sel], got["theta_deg"][sel])
    np.testing.assert_array_equal(
        fast, j_n2.n2_branch_loading(case, pairs[sel], got["v"][sel], got["theta_deg"][sel]))
    slow = ac_branch_loading(_variants(case, pairs[sel]), got["v"][sel], got["theta_deg"][sel])
    np.testing.assert_allclose(fast, slow, rtol=1e-12, atol=1e-9)


def test_n2_errors(case14, n1_models, monkeypatch):
    model, cfg = n1_models[:2]
    no_status = dict(case14, branch=np.asarray(case14["branch"])[:, :10])
    with pytest.raises(ValueError, match="N-2 islanding needs a branch status column"):
        n2.n2_islanding_pairs(no_status, n2.n2_pairs(case14))
    with pytest.raises(ValueError, match="status column"):
        n2.screen_n2(no_status, n2.n2_pairs(case14), device="cpu")
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        n2.screen_n2(case14, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        n2.screen_n2_ranked(case14, model, cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="method"):
        n2.screen_n2(case14, method="dc", device="cpu")
    with pytest.raises(ValueError, match="score"):
        n2.screen_n2_ranked(case14, model, cfg, score="max", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        n2.screen_n2(case14)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        n2.screen_n2_ranked(case14, model, cfg)
