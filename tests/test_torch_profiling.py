"""gns_torch's profiling module (utils/profiling.py) and its bench entry
point (python -m gns_torch.bench), on the CPU.

The roofline's counts are checked against the arithmetic written out by
hand for a small batch (4 case14 grids: N=14, E=20, G=5), in both of its
branches; the bench CLI runs the plain path at case14, K=2, batch 4, 2
steps, and must print one JSON line with bench.py's keys.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gns_torch.utils import profiling
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "achieved_tflops", "mfu_bf16",
              "hbm_bw_util"}


@pytest.fixture(scope="module")
def batch():
    b = batch_from_cases(list(generate_cases(14, 3, seed=0)))
    assert (b.buses.shape, b.lines.shape, b.generators.shape) == ((4, 14, 6), (4, 20, 7), (4, 5, 7))
    return b


def test_roofline_counts_unfolded(batch):
    """float32 parity, three phi heads of width L=8 (H=8, K=2): the phi and
    L MLPs and the trig term x K x S, tripled for the backward; the
    segment-sum's 24 columns x 20 edges adds once (its backward is a
    gather); bytes: the state and the segment-sum's rows, ids and sums."""
    cfg = GNSConfig(case_nr=14, K=2, latent_dim=8, hidden_dim=8, multiple_phi=True,
                    reference_parity=True)
    assert not cfg.resolved_fold_output
    rl = profiling.train_step_roofline(cfg, batch, sec=1e-3)
    phi = 3 * 2 * 20 * (13 * 8 + 8 * 8 + 8 * 8)  # 3 heads, E rows, in 13 = L + 5
    upd = 2 * (2 * 14 * (20 * 8 + 64 + 8 * 1)) + 2 * 14 * (20 * 8 + 64 + 8 * 8)  # in 4 + 2L
    trig = 40 * 20
    adds = 20 * 24  # one add per edge per aggregated column (3 x L)
    assert rl.flops == (phi + upd + trig) * 2 * 4 * 3 + adds * 2 * 4
    state = 4 * 4 * (14 * (6 + 2 + 8) + 20 * 7 + 5 * 7)
    agg = 20 * 24 * 4 + 20 * 4 + 15 * 4 + 14 * 24 * 4  # rows, CSR ids, indptr, sums
    assert rl.hbm_bytes == (state + 4 * agg) * 2 * 2
    assert rl.flops == 1196544 and rl.hbm_bytes == 80000


def test_roofline_counts_folded(batch):
    """bfloat16, the paper physics, fold on: phi runs layers 1-2 (width 3H
    = 24), the segment-sum aggregates 24 bf16 columns, L's first layer
    takes [base | agg | deg]."""
    cfg = GNSConfig(case_nr=14, K=2, latent_dim=8, hidden_dim=8, multiple_phi=True,
                    compute_dtype="bfloat16", reference_parity=False)
    assert cfg.resolved_fold_output
    rl = profiling.train_step_roofline(cfg, batch, sec=1e-3)
    phi = 2 * 20 * (13 * 24 + 24 * 24)
    upd = 2 * 14 * ((12 + 24 + 1) * 24 + 24 * 24 + 24 * (2 + 8))
    trig = 40 * 20
    adds = 20 * 24
    assert rl.flops == (phi + upd + trig) * 2 * 4 * 3 + adds * 2 * 4 == 2020608
    state = 4 * 4 * (14 * 16 + 20 * 7 + 5 * 7)
    agg = 20 * 24 * 2 + 20 * 4 + 15 * 4 + 14 * 24 * 4
    assert rl.hbm_bytes == (state + 4 * agg) * 2 * 2 == 64640
    fwd = profiling.train_step_roofline(cfg, batch, sec=1e-3, fwd_only=True)
    assert fwd.flops == (phi + upd + trig) * 8 + adds * 8 and fwd.hbm_bytes == rl.hbm_bytes / 2


def test_roofline_reads_the_h100_peaks():
    rl = profiling.Roofline(flops=989e12, hbm_bytes=3.35e12, sec=2.0)
    assert rl.achieved_tflops == pytest.approx(494.5)
    assert rl.mfu_bf16 == pytest.approx(0.5)
    assert rl.hbm_bound_frac == pytest.approx(0.5)
    assert "of H100 peak" in rl.summary()


def test_time_step_trace_and_assert_finite(tmp_path):
    calls = []
    sec = profiling.time_step(lambda x: calls.append(x), 1, iters=3, warmup=2)
    assert sec >= 0 and len(calls) == 5
    with profiling.trace(str(tmp_path / "t")) as d:
        torch.ones(4).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    profiling.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), torch.arange(3)]})
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]"):
        profiling.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), torch.tensor([np.nan])]})
    model = torch.nn.Linear(2, 2)
    profiling.assert_finite(model, "model")
    with torch.no_grad():
        model.bias.fill_(float("inf"))
    with pytest.raises(FloatingPointError, match="model"):
        profiling.assert_finite(model, "model")


def test_bench_cli_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "gns_torch.bench", "--cpu", "--case", "14", "--K", "2",
         "--batch", "4", "--inner-steps", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "train_edges_per_sec_case14_K2_b4" and line["unit"] == "edges/s"
    assert line["value"] > 0 and line["vs_baseline"] is None  # not the baseline's case300 K4
    for key in ("achieved_tflops", "mfu_bf16", "hbm_bw_util"):
        assert np.isfinite(line[key]) and line[key] >= 0
