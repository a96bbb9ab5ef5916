"""gns_torch's N-1 screens (eval/contingency.py) against gns_tpu's, on the
CPU, with the same case dicts and the same shipped checkpoints loaded into
both packages.

Tolerances:
  * the host functions (n1_variants, find_bridges, ac_branch_flows,
    ac_branch_loading, flow_violations) are the same float64 numpy code:
    equal, bit for bit;
  * verdicts (converged, worst, v_violations, flow_violations, islanded,
    verified_idx, per-grid iteration counts) equal;
  * solved states at v 2e-5 and theta 2e-3 degrees (tests/test_eval.py's
    Newton bounds, which chip_smoke.py's SOLVE_CARD_VS_CPU also keeps);
  * GNS predictions at tests/test_torch_serve.py's bounds (v rtol 2e-5 /
    atol 1e-5, theta 1e-3 degrees); severities within 1e-5, the serving
    bound on v (an rms of v differences).
"""

import numpy as np
import pytest
import torch

from gns_tpu.eval import contingency as j_cont
from gns_tpu.models import pretrained as j_pretrained
from gns_torch.eval import contingency, dcpf
from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.models.pretrained import load_pretrained
from gns_torch.utils.cases import load_case

torch.set_num_threads(2)

V_TOL, TH_TOL = 2e-5, 2e-3


def _hold(got, want, keys=("converged", "v_violations", "flow_violations", "worst")):
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ok = want["converged"]
    np.testing.assert_allclose(got["v"][ok], want["v"][ok], rtol=0, atol=V_TOL)
    np.testing.assert_allclose(got["theta_deg"][ok], want["theta_deg"][ok], rtol=0, atol=TH_TOL)


@pytest.mark.parametrize("flags", [
    dict(), dict(branch_outages=False, gen_outages=True),
    dict(gen_outages=True, encode_impedance=True),
    dict(branch_outages=False, gen_outages=True, gen_pq_conversion=False),
])
def test_n1_variants_match_gns_tpu(flags):
    case = load_case(14)
    got = contingency.n1_variants(case, **flags)
    want = j_cont.n1_variants(case, **flags)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["outage"] == w["outage"]
        for key in ("bus", "branch", "gen"):
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
    if flags.get("gen_outages") and flags.get("gen_pq_conversion", True):
        # case14's non-slack PV buses each hold one generator: every gen
        # outage converts its bus to PQ
        assert all((np.asarray(v["bus"])[:, 1] == 2).sum() == 3 for v in got
                   if v["outage"][0] == "gen")


@pytest.mark.parametrize("case_nr", [9, 14, 30, 118, 300])
def test_find_bridges_matches_gns_tpu(case_nr):
    case = load_case(case_nr)
    got = contingency.find_bridges(case)
    np.testing.assert_array_equal(got, j_cont.find_bridges(case))
    assert dcpf.find_bridges is contingency.find_bridges
    if case_nr == 118:
        assert got.size == 9


def test_ac_branch_flows_match_gns_tpu_and_published_losses():
    """Re(S_f + S_t) summed over branches is case30's published 17.557 MW
    of series losses; flows, loadings and violation counts equal gns_tpu's
    on a set of variants with NaN (non-converged) rows."""
    case = load_case(30)
    r = newton_raphson_pf(case)
    assert r.success
    sf, st = contingency.ac_branch_flows([case], r.vm[None, :], r.va_deg[None, :])
    assert abs(float(np.real(sf + st).sum()) - 17.557) < 0.01
    variants = contingency.n1_variants(case)[:6]
    v = np.repeat(r.vm[None, :], 6, 0).astype(np.float32)
    th = np.repeat(r.va_deg[None, :], 6, 0).astype(np.float32)
    v[2] = np.nan
    for got, want in zip(contingency.ac_branch_flows(variants, v, th),
                         j_cont.ac_branch_flows(variants, v, th)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(contingency.ac_branch_loading(variants, v, th),
                                  j_cont.ac_branch_loading(variants, v, th))
    for got, want in zip(contingency.flow_violations(variants, v, th),
                         j_cont.flow_violations(variants, v, th)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["auto", "nr"])
@pytest.mark.parametrize("warm", ["base", "flat"])
def test_screen_n1_matches_gns_tpu(method, warm):
    """case14, 20 branch + 4 generator outages: the bridge outage that
    islands bus 8 is the one non-converged variant in both packages."""
    case = load_case(14)
    got = contingency.screen_n1(case, gen_outages=True, method=method, warm=warm, device="cpu")
    want = j_cont.screen_n1(case, gen_outages=True, method=method, warm=warm)
    assert got["outages"] == want["outages"] and len(got["outages"]) == 24
    _hold(got, want)
    np.testing.assert_array_equal(got["iterations_per_grid"], want["iterations_per_grid"])
    nonconv = {got["outages"][i][1] for i in np.flatnonzero(~got["converged"])}
    assert nonconv == set(contingency.find_bridges(case).tolist())
    assert got["host_syncs"] > 0
    assert (got["mismatch"][got["converged"]] < 3e-4).all()  # tol, or the stall cap


def test_screen_n1_gns_warm_matches_gns_tpu():
    """GNS-warm-started through the fused hybrid (14-sup in both
    packages): the same verdicts and fixed points."""
    case = load_case(14)
    model, cfg = load_pretrained("14-sup", device="cpu")
    params, j_cfg = j_pretrained.load_pretrained("14-sup")
    got = contingency.screen_n1(case, params=model, cfg=cfg, device="cpu")
    want = j_cont.screen_n1(case, params=params, cfg=j_cfg)
    _hold(got, want)


def test_screen_n1_ranked_matches_gns_tpu():
    """14-n1 in both packages, top_k=8 of 24: the islanding outage is
    flagged structurally and never verified; predictions, severities, the
    verified set and its solves agree."""
    case = load_case(14)
    model, cfg = load_pretrained("14-n1", device="cpu")
    params, j_cfg = j_pretrained.load_pretrained("14-n1")
    got = contingency.screen_n1_ranked(case, model, cfg, gen_outages=True, top_k=8, device="cpu")
    want = j_cont.screen_n1_ranked(case, params, j_cfg, gen_outages=True, top_k=8)
    for key in ("islanded", "order", "verified_idx", "worst"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_newton_solves"] == want["n_newton_solves"] == 8
    fin = np.isfinite(want["severity"])
    np.testing.assert_array_equal(np.isfinite(got["severity"]), fin)
    np.testing.assert_allclose(got["severity"][fin], want["severity"][fin], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["pred_v"], want["pred_v"], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got["pred_theta_deg"], want["pred_theta_deg"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["pred_violation_pu"], want["pred_violation_pu"], rtol=0,
                               atol=1e-5)
    _hold(got, want)
    isl = np.flatnonzero(got["islanded"])
    assert isl.size == 1 and isl[0] not in got["verified_idx"] and got["order"][0] == isl[0]


def test_screen_n1_flow_violations_case30():
    """case30 publishes real ratings and its base point already overloads
    branch 1-2: every converged variant inherits a violation, the bridges
    are the non-converged set, an outaged branch loads 0."""
    case = load_case(30)
    got = contingency.screen_n1(case, device="cpu")
    want = j_cont.screen_n1(case)
    _hold(got, want)
    np.testing.assert_allclose(got["max_loading_frac"], want["max_loading_frac"], rtol=1e-4)
    conv = got["converged"]
    assert (got["flow_violations"][conv] >= 1).all()
    assert set(np.flatnonzero(~conv).tolist()) == set(contingency.find_bridges(case).tolist())
    loading = got["branch_loading_mva"]
    assert all(loading[i, i] < 1e-6 for i in np.flatnonzero(conv))


def test_screen_errors(monkeypatch):
    case = load_case(14)
    no_status = dict(case, branch=np.asarray(case["branch"])[:, :10])
    with pytest.raises(ValueError, match="status column"):
        contingency.n1_variants(no_status)
    with pytest.raises(ValueError, match="status column"):
        contingency.screen_n1(no_status, device="cpu")
    model, cfg = load_pretrained("14-n1", device="cpu")
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        contingency.screen_n1(case, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        contingency.screen_n1_ranked(case, model, cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="warm"):
        contingency.screen_n1(case, warm="gns", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contingency.screen_n1(case)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contingency.screen_n1_ranked(case, model, cfg)
