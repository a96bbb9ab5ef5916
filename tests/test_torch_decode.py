"""The serving decode (eval/harness.py align_slack_angle) over a whole
request against gns_tpu's per-grid decode, grid by grid: bit-equal on
generated and hand-edited bus tables, on padded mixed-size batches, and
through GNSPredictor.predict."""

import copy

import numpy as np
import pytest
import torch

from gns_tpu.eval.harness import align_slack_angle as per_grid
from gns_torch.eval.harness import align_slack_angle
from gns_torch.models.gns import GNS
from gns_torch.serve import GNSPredictor
from gns_torch.utils import profiling
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases
from gns_torch.utils.schema import BUS, BUS_TYPE_PV, BUS_TYPE_SLACK

torch.set_num_threads(1)

CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, reference_parity=False)


def _loop(theta, cases):
    """The decode as predict ran it before: one call a grid."""
    return np.stack([per_grid(t, c) for t, c in zip(theta, cases)])


def _theta(cases, dtype=np.float32, seed=0):
    n = max(len(c["bus"]) for c in cases)
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(len(cases), n)) + 3.0).astype(dtype)


def _edited(case_nr, edit):
    """case_nr's base case with its bus table edited in place by edit."""
    case = copy.deepcopy(next(generate_cases(case_nr, 0)))
    bus = np.array(case["bus"], dtype=np.float64)
    edit(bus)
    case["bus"] = bus
    return case


def _slack_last(bus):
    bus[bus[:, 1] == BUS_TYPE_SLACK, 1] = BUS_TYPE_PV
    bus[-1, 1], bus[-1, 8] = BUS_TYPE_SLACK, -12.5


def _two_slacks(bus):
    bus[7, 1], bus[7, 8] = BUS_TYPE_SLACK, 40.0  # after case14's own slack (row 0)


def _no_slack(bus):
    bus[bus[:, 1] == BUS_TYPE_SLACK, 1] = BUS_TYPE_PV


def _as_lists(case):
    case = copy.deepcopy(case)
    case["bus"] = np.asarray(case["bus"]).tolist()
    return case


TABLES = {
    "case9": lambda: list(generate_cases(9, 4, seed=61)),
    "case14": lambda: list(generate_cases(14, 4, seed=62)),
    "case30": lambda: list(generate_cases(30, 4, seed=63)),
    "slack_last": lambda: [_edited(14, _slack_last), *generate_cases(14, 2, seed=64)],
    "two_slacks": lambda: [*generate_cases(14, 1, seed=65), _edited(14, _two_slacks)],
    "no_slack": lambda: [_edited(14, _no_slack), *generate_cases(14, 2, seed=66)],
    "list_of_lists": lambda: [_as_lists(c) for c in generate_cases(9, 2, seed=67)],
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_batched_decode_equals_per_grid(table, dtype):
    """One call over the block, with the packed bus types or without, is
    bit-equal to the per-grid decode; so is the single-grid form."""
    cases = TABLES[table]()
    theta = _theta(cases, dtype)
    want = _loop(theta, cases)
    batch = batch_from_cases(cases)
    packed = align_slack_angle(theta, cases, batch.buses[..., BUS["type"]], batch.n_bus)
    assert packed.dtype == theta.dtype
    assert np.array_equal(packed, want)
    assert np.array_equal(align_slack_angle(theta, cases), want)
    for t, c, w in zip(theta, cases, want):
        assert np.array_equal(align_slack_angle(t, c), w)


def test_decode_rules():
    """The first slack row wins, a grid without one keeps its angles, and
    the slack's angle is pinned to its Va."""
    cases = [_edited(14, _two_slacks), _edited(14, _no_slack), _edited(14, _slack_last)]
    theta = _theta(cases)
    out = align_slack_angle(theta, cases)
    assert out[0, 0] == np.float32(np.deg2rad(cases[0]["bus"][0, 8])) and out[0, 7] != out[0, 0]
    assert np.array_equal(out[1], theta[1])
    assert out[2, -1] == np.float32(np.deg2rad(-12.5))


def test_padding_rows_never_count():
    """A padded mixed-size batch whose padding rows hold the slack type:
    rows at or past n_bus are not searched."""
    cases = [*generate_cases(9, 1, seed=71), *generate_cases(14, 1, seed=72),
             _edited(9, _no_slack)]
    theta = _theta(cases)
    batch = batch_from_cases(cases)
    types = batch.buses[..., BUS["type"]].copy()
    assert types.shape == theta.shape and list(batch.n_bus) == [9, 9, 14, 14, 9]
    for r, n in enumerate(batch.n_bus):
        types[r, n:] = BUS_TYPE_SLACK
    out = align_slack_angle(theta, cases, types, batch.n_bus)
    assert np.array_equal(out, _loop(theta, cases))
    assert np.array_equal(out[-1], theta[-1])


@pytest.fixture(scope="module")
def predictor():
    return GNSPredictor(GNS(CFG, seed=0, device="cpu"), CFG, batch_size=8, device="cpu")


@pytest.mark.parametrize("n_req", [3, 8, 20, 37])
def test_predict_decode_equals_per_grid(predictor, n_req):
    """predict's theta (one decode over the request, chunks of 8, the last
    one padded) is bit-equal to its raw theta decoded grid by grid."""
    cases = list(generate_cases(9, n_req - 1, seed=80 + n_req))
    predictor.align_slack = False
    raw = predictor.predict(cases)
    predictor.align_slack = True
    out = predictor.predict(cases)
    assert out["theta"].shape == (n_req, 9)
    assert np.array_equal(out["theta"], _loop(raw["theta"], cases))
    assert np.array_equal(out["v"], raw["v"])


def test_predict_mixed_size_decode_equals_per_grid():
    """A mixed-size request: padded bus rows stay out of the slack search."""
    pred = GNSPredictor(GNS(CFG, seed=0, device="cpu"), CFG, batch_size=4, device="cpu")
    c9, c14 = list(generate_cases(9, 2, seed=91)), list(generate_cases(14, 2, seed=92))
    cases = [c9[0], c14[0], c9[1], c14[1], c9[2], c14[2]]
    out = pred.predict(cases)
    pred.align_slack = False
    assert np.array_equal(out["theta"], _loop(pred.predict(cases)["theta"], cases))


@pytest.mark.parametrize("align", [True, False])
def test_batched_decodes_counted(predictor, align):
    """serve.batched_decodes: one a predict call that decodes, however many
    chunks the request has; none without the decode."""
    cases = list(generate_cases(9, 19, seed=95))
    predictor.align_slack = align
    with profiling.recording():
        predictor.predict(cases)
        predictor.predict(cases[:5])
    rec = profiling.recorded()
    units = [s.unit for s in rec.spans if s.name == "serve.predict"]
    want = 1 if align else 0
    assert [rec.counted(u).get("serve.batched_decodes", 0) for u in units] == [want, want]
    predictor.align_slack = True
