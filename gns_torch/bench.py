"""Benchmark: training throughput (train edges/s) at case300, K=4, the
BASELINE.json headline metric, for gns_torch (the counterpart of the
repository's bench.py, which measures gns_tpu).

    python -m gns_torch.bench            # on the card
    python -m gns_torch.bench --cpu      # the plain path, eager steps

Measures the full training step (forward, backward, optimizer) over a
batch of augmented case300 grids (generate_cases(300, batch - 1, seed=0),
one shared topology) from GNS(cfg, seed=0). Each timed window is one call
of train/trainer.py make_epoch_step over --inner-steps steps: on the card
one update captured in a CUDA graph and replayed per step; on the CPU a
loop of eager steps. A window is closed by reading its last loss on the
host, which waits for the device. The first window (the capture and its
warm-up steps) is not timed; the reading is the fastest of --repeats
windows over the step count. train edges/s = batch x lines x K per step
over the step's time (bench.py:137).

`vs_baseline` compares against the PyTorch reference measured on a host
CPU with its own sequential-sample loop (BASELINE_MEASURED.json).
`achieved_tflops`, `mfu_bf16` and `hbm_bw_util` come from
utils/profiling.py train_step_roofline against the H100's peaks; its
aggregation term counts the adds and bytes of a segment-sum (the work K1
does), not a one-hot (N, E) matrix product.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "edges/s", "vs_baseline": N,
   "achieved_tflops": N, "mfu_bf16": N, "hbm_bw_util": N}
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gns_torch.bench")
    p.add_argument("--case", type=int, default=300)
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--latent", type=int, default=20)
    p.add_argument("--hidden", type=int, default=10)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--inner-steps", type=int, default=512,
                   help="update steps per timed window (one make_epoch_step call)")
    p.add_argument("--repeats", type=int, default=2,
                   help="timed windows (each inner-steps long); min taken")
    p.add_argument("--method", default="auto", help="segment-sum / gather method")
    # bf16 MLP compute is the default, as in bench.py (parameters and
    # physics stay float32); --compute-dtype float32 for parity numerics
    p.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--remat", default="auto", choices=["auto", "on", "off"],
                   help="recompute each K step in the backward (auto: off)")
    p.add_argument("--roofline", action="store_true",
                   help="print a speed-of-light line to stderr after the JSON")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch path on the CPU (the card by default)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from gns_torch.train.trainer import init_train_state, make_epoch_step
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.device import resolve_device
    from gns_torch.utils.prepare import GridBatch, batch_from_cases, extract_shared_topology
    from gns_torch.utils.profiling import train_step_roofline

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = GNSConfig(
        case_nr=args.case, K=args.K, latent_dim=args.latent, hidden_dim=args.hidden,
        multiple_phi=True, batch_size=args.batch, compute_dtype=args.compute_dtype,
        remat={"auto": "auto", "on": True, "off": False}[args.remat],
        reference_parity=(args.compute_dtype == "float32"),
    )
    if cfg.compute_dtype == "float32":  # float32 means float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = batch_from_cases(list(generate_cases(args.case, args.batch - 1, seed=0)))
    n_edges = batch.lines.shape[1]
    topo = extract_shared_topology(batch)
    dense = batch.is_dense()  # unpadded: the mask-free path (exact)
    on_device = GridBatch(*(torch.as_tensor(a, device=device) for a in batch))
    xs = GridBatch(*(a.unsqueeze(0).expand((args.inner_steps,) + tuple(a.shape))
                     for a in on_device))

    state = init_train_state(0, cfg, device=device)
    step = make_epoch_step(cfg, method=args.method, topo=topo, dense=dense)

    # warm-up: the capture and one whole window, waited for by a host read
    state, metrics = step(state, xs)
    float(metrics["loss"][-1])
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state, metrics = step(state, xs)
        loss = float(metrics["loss"][-1])  # a host read waits for the device
        best = min(best, time.perf_counter() - t0)
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    dt = best / args.inner_steps
    edges_per_s = args.batch * n_edges * args.K / dt

    vs_baseline = None
    baseline_path = os.path.join(REPO, "BASELINE_MEASURED.json")
    if os.path.exists(baseline_path) and args.case == 300 and args.K == 4:
        with open(baseline_path) as f:
            vs_baseline = edges_per_s / json.load(f)["edges_per_sec"]

    rl = train_step_roofline(cfg, batch, dt)
    line = {
        "metric": f"train_edges_per_sec_case{args.case}_K{args.K}_b{args.batch}",
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(vs_baseline, 3) if vs_baseline else None,
        "achieved_tflops": round(rl.achieved_tflops, 2),
        "mfu_bf16": round(rl.mfu_bf16, 4),
        "hbm_bw_util": round(rl.hbm_bound_frac, 4),
    }
    print(json.dumps(line), flush=True)
    if args.roofline:
        print(f"# roofline ({device.type}): {rl.summary()}", file=sys.stderr)
    return line


if __name__ == "__main__":
    main()
