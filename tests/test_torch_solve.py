"""gns_torch's solver surface (eval/solve.py solve_ac) against gns_tpu's, on
the CPU: the arm and method resolution, equal fixed points across arms,
the fallback and the argument checks.

Tolerances: the flat arms against gns_tpu's at v 2e-5 (Newton) and 3e-5
(fast-decoupled); arms against each other at tests/test_solve_ac.py's
bounds (5e-5 prev, 1e-4 across methods, 5e-4 gns).
"""

import numpy as np
import pytest
import torch

from gns_tpu.eval import solve as j_solve
from gns_torch.eval import nr_batched
from gns_torch.eval import solve
from gns_torch.models.pretrained import load_pretrained
from gns_torch.utils.augment import generate_cases

torch.set_num_threads(2)


def _cases(n=6, case=14, seed=5):
    return list(generate_cases(case, n - 1, seed=seed))


def test_gns_warm_policy_is_rtt_and_size_aware(monkeypatch):
    """auto's gns arm: from 100 buses up when a round trip costs more than
    the 5 ms break-even, always when it costs less."""
    c14 = _cases(2)
    c118 = list(generate_cases(118, 1, seed=0))
    monkeypatch.setattr(nr_batched, "measured_dispatch_rtt", lambda device="cuda": 0.033)
    assert not solve._gns_warm_pays(c14, "cpu")
    assert solve._gns_warm_pays(c118, "cpu")
    monkeypatch.setattr(nr_batched, "measured_dispatch_rtt", lambda device="cuda": 1e-4)
    assert solve._gns_warm_pays(c14, "cpu")


@pytest.mark.parametrize("method", ["auto", "nr"])
def test_flat_arm_matches_gns_tpu(method):
    cases = _cases()
    got = solve.solve_ac(cases, method=method, device="cpu")
    want = j_solve.solve_ac(cases, method=method)
    for key in ("warm_start", "method", "compact_after", "fallback_grids"):
        assert got[key] == want[key], key
    assert got["warm_start"] == "flat" and got["method"] == ("fdpf" if method == "auto" else "nr")
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["v"], want["v"], atol=3e-5 if method == "auto" else 2e-5)


def test_arms_reach_one_fixed_point():
    """prev (from a result dict and from a tuple), flat, gns and both
    methods: the same fixed point; auto picks prev when given, gns under
    Newton when the model is given and pays, flat under fdpf."""
    model, cfg = load_pretrained("14-sup", device="cpu")
    cases = _cases()
    flat = solve.solve_ac(cases, device="cpu")
    nr = solve.solve_ac(cases, method="nr", device="cpu")
    np.testing.assert_allclose(flat["v"], nr["v"], atol=1e-4)
    warm = solve.solve_ac(cases, prev=flat, device="cpu")
    assert warm["warm_start"] == "prev" and warm["converged"].all()
    np.testing.assert_allclose(warm["v"], flat["v"], atol=5e-5)
    assert (warm["iterations_per_grid"] <= flat["iterations_per_grid"]).all()
    tup = solve.solve_ac(cases, prev=(flat["v"], np.deg2rad(flat["theta_deg"])), device="cpu")
    np.testing.assert_array_equal(tup["v"], warm["v"])
    auto = solve.solve_ac(cases, params=model, cfg=cfg, device="cpu")
    assert auto["warm_start"] == "flat" and auto["method"] == "fdpf"
    auto_nr = solve.solve_ac(cases, params=model, cfg=cfg, method="nr", device="cpu")
    assert auto_nr["warm_start"] == "gns" and auto_nr["converged"].all()
    np.testing.assert_allclose(auto_nr["v"], flat["v"], atol=5e-4)
    forced = solve.solve_ac(cases, params=model, cfg=cfg, warm_start="gns", device="cpu")
    assert forced["warm_start"] == "gns" and forced["method"] == "fdpf"
    np.testing.assert_allclose(forced["v"], nr["v"], atol=1e-4)
    both = solve.solve_ac(cases, params=model, cfg=cfg, prev=flat, device="cpu")
    assert both["warm_start"] == "prev"


def test_prev_fallback_rescues_divergent_warm_start():
    """A near-collapsed previous solution leaves Newton's basin; the flat
    fallback re-solves those grids, as in gns_tpu."""
    cases = _cases()
    n = np.asarray(cases[0]["bus"]).shape[0]
    bad_prev = (np.full((len(cases), n), 0.05, np.float32), np.zeros((len(cases), n), np.float32))
    out = solve.solve_ac(cases, prev=bad_prev, warm_start="prev", device="cpu")
    want = j_solve.solve_ac(cases, prev=bad_prev, warm_start="prev")
    assert out["converged"].all() and out["fallback_grids"] == want["fallback_grids"] > 0
    flat = solve.solve_ac(cases, device="cpu")
    np.testing.assert_allclose(out["v"], flat["v"], atol=5e-5)
    assert out["iterations_per_grid"].max() > flat["iterations_per_grid"].max()


def test_validation_errors():
    cases = _cases(3)
    with pytest.raises(ValueError):
        solve.solve_ac(cases, warm_start="gns", device="cpu")  # no model
    with pytest.raises(ValueError):
        solve.solve_ac(cases, warm_start="prev", device="cpu")  # no prev
    with pytest.raises(ValueError):
        solve.solve_ac(cases, warm_start="nope", device="cpu")
    with pytest.raises(ValueError):
        solve.solve_ac(cases, method="qr", device="cpu")
    with pytest.raises(ValueError):
        solve.solve_ac(cases, warm_start="prev", device="cpu",
                       prev=(np.ones((2, 14), np.float32), np.zeros((2, 14), np.float32)))
    with pytest.raises(ValueError, match="solver mesh needs a 'dp' axis"):
        solve.solve_ac(cases, mesh=object(), device="cpu")
