"""On the card, at each cell's own size, on three seeds: a short window of
the cell's driver comes out correct, and the control, the reference
computed in TF32 (the precision below the configuration's float32 with
TF32 off), fails at least one of the cell's limits; for training, so do the
reference with half of each batch left out and a state that never
changes (control.controls). `python -m pytest
benchmark/tests -m card` on a machine with an NVIDIA GPU."""

import time

import pytest

from benchmark import harness
from benchmark.control import controls

SEEDS = (2**31 + 17, 2**31 + 18, 2**31 + 19)


def _ctx(cell, seed):
    entry = harness.cell_of(harness.spec(), cell)
    return harness.Context(
        cell=cell, config=harness.load_json(harness.HERE, "configs", entry["config"] + ".json"),
        traffic=harness.load_json(harness.HERE, "traffic", entry["traffic"] + ".json"),
        limits=harness.load_json(harness.HERE, "limits", cell + ".json"), seed=seed,
        seconds=1.0, trace=False, device="cuda", t0=time.perf_counter())


def _fails(gaps, limits):
    return any(not gaps[k] <= limits[k] for k in limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.spec()["workloads"]])
def test_cell_and_its_control(cell, card):
    for seed in SEEDS:
        ctx = _ctx(cell, seed)
        rec = harness.run_cell(ctx)
        assert rec.correct, (seed, rec.checks)
        out = controls(ctx, rec)
        assert _fails(out["control"], ctx.limits), (seed, out["control"])
        for name, fault in out.get("faults", {}).items():
            assert _fails(fault, ctx.limits), (seed, name, fault)
