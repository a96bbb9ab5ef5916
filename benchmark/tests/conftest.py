"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the checkout. Tests that need the card carry the `card` marker and
ask for the `card` fixture, which skips them where torch sees no CUDA
device; the decision is made inside the fixture, never at import."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each driver's traffic at a size the CPU runs in a second
SMALL_TRAFFIC = {
    "serve": {"driver": "serve", "pool": 24, "request": 8, "batch": 8, "warmup_requests": 1,
              "traced_requests": 1},
    "train": {"driver": "train", "dataset": 32, "batch": 8, "traced_epochs": 1},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture
def small_run():
    """run(cell, case_nr=14) -> (ctx, record): the rest of a run of `cell`
    on the CPU at a small size (its configuration at K=2 on a built-in
    case, its driver with SMALL_TRAFFIC, its limits; the look for a card is
    skipped)."""
    from benchmark import harness

    def run(cell, case_nr=14, seed=2**31 + 99):
        from gns_torch.utils import cases as port_cases

        entry = harness.cell_of(harness.spec(), cell)
        config = harness.load_json(harness.HERE, "configs", entry["config"] + ".json")
        config["gns"].update(K=2, case_nr=case_nr)
        driver = harness.load_json(harness.HERE, "traffic", entry["traffic"] + ".json")["driver"]
        ctx = harness.Context(cell=cell, config=config, traffic=dict(SMALL_TRAFFIC[driver]),
                              limits=harness.load_json(harness.HERE, "limits", cell + ".json"),
                              seed=seed, seconds=0.5, trace=False, device="cpu",
                              t0=time.perf_counter(), base_case=port_cases.load_case(case_nr))
        return ctx, harness.run_cell(ctx)
    return run


def cells(driver=None):
    """The names of BENCHMARK.json's cells, those whose traffic `driver`
    drives where one is given."""
    from benchmark import harness

    return [w["name"] for w in harness.spec()["workloads"] if driver is None or harness.load_json(
        harness.HERE, "traffic", w["traffic"] + ".json")["driver"] == driver]
