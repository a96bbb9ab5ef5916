"""gns_torch's DC power flow (eval/dcpf.py) against gns_tpu's and the
float64 oracle, on the CPU.

Tolerances: solve_batched_dc against gns_tpu at atol 1e-5 in per unit:
angles in radians, flows and the slack injection divided by baseMVA,
relative to the largest value where that exceeds 1 p.u. (float32 sums
in another order). lodf_matrix and find_bridges are the same float64
numpy code and compare equal; dc_outage_severity's scores, built on the
float32 DC flows, at rtol 1e-4 / atol 1e-3 MW. The DC-limit check keeps
tests/test_dcpf.py's 2e-3 degrees.
"""

import copy

import numpy as np
import pytest
import torch

from gns_tpu.eval import dcpf as j_dcpf
from gns_tpu.eval.contingency import find_bridges as j_find_bridges
from gns_torch.eval import dcpf
from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.utils.cases import load_case

torch.set_num_threads(2)


def _close_pu(got, want, base):
    got, want = np.asarray(got, np.float64) / base, np.asarray(want, np.float64) / base
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("case_nr", [14, 30, 118])
def test_dc_and_lodf_match_gns_tpu(case_nr):
    case = load_case(case_nr)
    shifted = copy.deepcopy(case)
    shifted["branch"] = np.asarray(shifted["branch"], float).copy()
    shifted["branch"][0, 9] = 3.0  # a phase shifter on branch 0
    got = dcpf.solve_batched_dc([case, shifted], device="cpu")
    want = j_dcpf.solve_batched_dc([case, shifted])
    np.testing.assert_allclose(np.deg2rad(got["theta_deg"]), np.deg2rad(want["theta_deg"]),
                               rtol=0, atol=1e-5)
    base = case["baseMVA"]
    _close_pu(got["pf_mw"], want["pf_mw"], base)
    _close_pu(got["p_slack_mw"], want["p_slack_mw"], base)
    assert not np.allclose(got["pf_mw"][0, 0], got["pf_mw"][1, 0])
    np.testing.assert_array_equal(dcpf.find_bridges(case), j_find_bridges(case))
    np.testing.assert_array_equal(dcpf.lodf_matrix(case), j_dcpf.lodf_matrix(case))


def test_dc_exact_in_dc_limit():
    """case14 pushed into the DC regime (lossless, no charging or shunts,
    unit set-points, loads scaled down): the AC solution is the DC one up
    to O(theta^2)."""
    case = copy.deepcopy(load_case(14))
    bus = np.asarray(case["bus"], float)
    br = np.asarray(case["branch"], float)
    gen = np.asarray(case["gen"], float)
    br[:, 2] = br[:, 4] = 0.0
    bus[:, 4] = bus[:, 5] = 0.0
    bus[:, 7] = gen[:, 5] = 1.0
    bus[:, 2] *= 1e-2
    bus[:, 3] *= 1e-2
    gen[:, 1] *= 1e-2
    case["bus"], case["branch"], case["gen"] = bus, br, gen
    ref = newton_raphson_pf(case)
    assert ref.success
    dc = dcpf.solve_batched_dc([case], device="cpu")
    np.testing.assert_allclose(dc["theta_deg"][0], ref.va_deg, atol=2e-3)


def test_dc_outage_severity_matches_gns_tpu():
    """Every single-branch outage's scores equal gns_tpu's, and the
    islanded set is the structural bridge set."""
    for case_nr in (14, 30):
        case = load_case(case_nr)
        got = dcpf.dc_outage_severity(case, device="cpu")
        want = j_dcpf.dc_outage_severity(case)
        np.testing.assert_array_equal(got["islanded"], want["islanded"])
        assert set(np.flatnonzero(got["islanded"])) == set(dcpf.find_bridges(case).tolist())
        for key in ("max_shift_mw", "overload_mw"):
            fin = np.isfinite(want[key])
            np.testing.assert_array_equal(np.isfinite(got[key]), fin)
            np.testing.assert_allclose(got[key][fin], want[key][fin], rtol=1e-4, atol=1e-3)


def test_lodf_near_singular_denominator_is_divided_through():
    """gns_tpu's behaviour, kept (an open question of the reference): a
    branch that is not a bridge only because of a parallel path of huge
    reactance has |1 - self-PTDF| = x / (x + 1e7), far below the 1e-6 at
    which a bridge's is taken as 1; its LODF column is divided through and
    finite (its small entries carry float64 rounding of O(1) relative
    size), not flagged as islanding."""
    case = copy.deepcopy(load_case(14))
    br = np.asarray(case["branch"], float)
    spur = int(dcpf.find_bridges(case)[0])
    extra = br[spur].copy()
    extra[3] = 1e7  # a parallel branch of huge reactance
    case["branch"] = np.vstack([br, extra])
    assert spur not in dcpf.find_bridges(case).tolist()
    assert br[spur, 3] / (br[spur, 3] + 1e7) < 1e-6
    got = dcpf.lodf_matrix(case)
    np.testing.assert_array_equal(got, j_dcpf.lodf_matrix(case))
    assert np.isfinite(got[:, spur]).all()
    # the outage moves the spur's whole flow onto the parallel branch
    np.testing.assert_allclose(got[-1, spur], 1.0, atol=1e-6)
