"""Profiling and observability (port of gns_tpu/utils/profiling.py).

A torch.profiler trace capture, a synchronised step timer, a roofline
estimate of one training step against the H100's peaks, and a NaN guard.
The reference's only instrumentation is perf_counter around inference
(GNS/evaluate.py:33-36).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

# NVIDIA H100 SXM peaks (data sheet, dense, at its 700 W limit), used for
# speed-of-light estimates.
H100_PEAK_BF16_TFLOPS = 989.0  # tensor cores
H100_PEAK_F32_TFLOPS = 67.0  # outside the tensor cores
H100_HBM_GBPS = 3350.0

DEFAULT_TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_trace",
)


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    and write a Chrome / Perfetto trace to `log_dir`/trace.json. Yields
    the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_step(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean wall seconds per call of fn(*args): `warmup` calls, then
    `iters` timed calls closed by a device synchronise (CUDA work is
    asynchronous)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


@dataclass
class Roofline:
    flops: float  # per step
    hbm_bytes: float  # per step
    sec: float  # measured

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.sec / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.hbm_bytes / self.sec / 1e9

    @property
    def hbm_bound_frac(self) -> float:
        """Fraction of the H100's memory rate achieved."""
        return self.achieved_gbps / H100_HBM_GBPS

    @property
    def mfu_bf16(self) -> float:
        """Model FLOP utilization against the H100's bf16 tensor-core peak."""
        return self.achieved_tflops / H100_PEAK_BF16_TFLOPS

    def summary(self) -> str:
        return (
            f"{self.sec*1e6:.0f} us/step | {self.achieved_tflops:.2f} TFLOP/s | "
            f"{self.achieved_gbps:.0f} GB/s HBM ({self.hbm_bound_frac*100:.0f}% of H100 peak)"
        )


def train_step_roofline(cfg, batch, sec: float, fwd_only: bool = False) -> Roofline:
    """Analytic FLOP / byte estimate of one GNS train step on `batch`.

    Counts the dominant terms: the per-K-step MLP matmuls on E and N rows
    and the trig physics messages, with the backward counted as 2x the
    forward's (the standard estimate), and the aggregation at the buses.

    The aggregation is counted as the work a segment-sum does: one add per
    edge per aggregated column (3H columns with the aggregate-then-project
    fold, 3L with multiple phi heads, 1 with the single phi head), reading
    each edge's row and its CSR id once and writing each bus's row once,
    in both branches. Its backward is a gather of the same bytes and no
    adds. gns_tpu counts the TPU's one-hot (N, E) contraction here, 2*N*E
    multiply-adds per column, which bench.py puts at about 69% of the
    step's FLOPs; K1 on the card never does that work, so a count of it
    would report a utilization made of work the H100 does not do.
    """
    s, n, _ = batch.buses.shape
    e = batch.lines.shape[1]
    L, H, K = cfg.latent_dim, cfg.hidden_dim, cfg.K
    phi_in, upd_in = cfg.phi_in_dim, cfg.update_in_dim

    def mlp(rows, din, dout):
        return 2 * rows * (din * H + H * H + H * dout)

    n_phi = 3 if cfg.multiple_phi else 1
    if cfg.resolved_fold_output and cfg.multiple_phi and cfg.fused_heads:
        # aggregate-then-project fold: phi runs layers 1-2 only (fused trio
        # width 3H), the aggregation sums 3H columns, and L's first layer
        # consumes [base | agg3H | deg] (see models/gns.py)
        h3 = 3 * H
        base = 4 + L
        phi_flops = 2 * e * (phi_in * h3 + h3 * h3)
        upd_flops = 2 * n * ((base + h3 + 1) * h3 + h3 * h3 + h3 * (2 + L))
        agg_cols = h3
    else:
        phi_flops = n_phi * mlp(e, phi_in, L if cfg.multiple_phi else 1)
        upd_flops = mlp(n, upd_in, 1) * 2 + mlp(n, upd_in, L)
        agg_cols = n_phi * L if cfg.multiple_phi else 1
    agg_adds = e * agg_cols  # one add per edge per column
    elt = 2 if cfg.compute_dtype == "bfloat16" else 4  # the aggregated rows' type
    agg_bytes = e * agg_cols * elt + e * 4 + (n + 1) * 4 + n * agg_cols * 4
    trig_flops = 40 * e  # physics messages, ~10 trig ops x amortized cost
    dense_flops = (phi_flops + upd_flops + trig_flops) * K * s
    total_flops = dense_flops * (1 if fwd_only else 3) + agg_adds * K * s

    state_bytes = 4 * s * (n * (6 + 2 + L) + e * 7 + batch.generators.shape[1] * 7)
    hbm = (state_bytes + agg_bytes * s) * K * (1 if fwd_only else 2)  # rough per-step traffic
    return Roofline(flops=float(total_flops), hbm_bytes=float(hbm), sec=sec)


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError if any tensor in `tree` (a tensor, a
    module's state_dict, or nested dicts / lists / tuples of tensors or
    arrays) holds a NaN or an Inf; the message names its path."""
    import numpy as np

    def walk(node, path):
        if isinstance(node, torch.nn.Module):
            node = node.state_dict()
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}[{i}]")
        elif node is not None:
            yield path, node

    for path, leaf in walk(tree, ""):
        if torch.is_tensor(leaf):
            ok = bool(torch.isfinite(leaf).all()) if leaf.is_floating_point() else True
        else:
            ok = bool(np.all(np.isfinite(np.asarray(leaf))))
        if not ok:
            raise FloatingPointError(f"non-finite values in {name}{path}")
