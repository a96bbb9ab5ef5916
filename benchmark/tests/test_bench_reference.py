"""The port against the benchmark's plain reference on the CPU at small
sizes: each cell's driver and comparison (case14 and case30, K=2, the
cell's head layout, 8 grids a batch) must come out correct within the
cell's limits, which the card's readings set; the reference with
bfloat16 products in the program's place must not, nor, for training,
the reference with half of each batch left out or a state that never
changes."""

import numpy as np
import pytest
import torch

from benchmark.control import controls
from benchmark.reference import gns_ref, grids
from benchmark.tests.conftest import cells


def _fails(gaps, limits):
    return any(not gaps[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("case_nr", [14, 30])
@pytest.mark.parametrize("cell", cells())
def test_port_matches_reference(cell, case_nr, small_run):
    ctx, rec = small_run(cell, case_nr)
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.correct, rec.checks
    out = controls(ctx, rec)
    assert _fails(out["bf16"], ctx.limits), out["bf16"]
    for name, fault in out.get("faults", {}).items():
        assert _fails(fault, ctx.limits), (name, fault)


def test_generator_is_the_ports():
    """The frozen case300 generator and augmentation draw what the port's
    generate_cases draws for the same stream."""
    from gns_torch.utils import augment, cases as port_cases

    base = grids.synthetic_case300()
    port = port_cases.load_case(300)
    for key in ("bus", "gen", "branch"):
        assert np.array_equal(base[key], port[key])
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        a, b = grids.augment_case(base, rng_a), augment.augment_case(port, rng_b)
        for key in ("bus", "gen", "branch"):
            assert np.array_equal(a[key], b[key])


def test_prepare_is_the_ports():
    from gns_torch.utils.prepare import prepare_case

    for case in grids.make_cases(grids.synthetic_case300(), 2, 11):
        for mine, theirs in zip(grids.prepare_case(case), prepare_case(case)):
            assert np.array_equal(mine, theirs)


def test_leaf_gaps():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    prog = {"a": torch.ones(4) * 1.5, "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    gaps = gns_ref.leaf_gaps(prog, ref)
    # median leaf norm 2 (of 0, 2, 4): a's gap 1 / max(2, 2)
    assert gaps == pytest.approx({"a": 0.5, "b": 0.0, "c": 0.0})
    assert "a" not in gns_ref.leaf_gaps(prog, ref, skip={"a"})
