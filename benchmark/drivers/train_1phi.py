"""Training epochs of the single-phi GNS (a configuration with
`multiple_phi` false): drivers/train.py's dataset, epochs, metrics and
traced part, with the configuration's own seeding (drivers/serve_1phi.py
seed_weights) and its own reference.

A dataset of `dataset` seeded grids in batches of `batch`, one call of the
port's make_epoch_step over stack_epoch(data, batch) per epoch and one
host read of last_loss.mean() per epoch, until the window's seconds have
passed; in training jobs of `job_epochs` epochs, each from the seeded
weights with Adam's state at zero (`new_job`). A job is as long
as the reference's default training run (GNS/main.py: 101 epochs of 256
samples in batches of 128, 202 update steps): past about 580 steps the
published recipe (Adam at lr 1e-3, no clip) drives the 30-step map out of
float range on some seeds, the plain reference as well as the program and
in float64 as well as float32, within two or three steps of a loss still
near its floor.

  train_edges_per_s  steps x batch x lines x K completed in the window over
                     the window; the window is whole epochs, each closed
                     by its host read
  setup_s            process start to the first timed epoch

Set-up drives the state through its first five steps with the window's
own call and feed, as drivers/train.py does; a step whose loss is not
finite is failed. Compared once the window has closed, against
reference/gns_ref_1phi.py's same five steps in float64, as drivers/train.py
compares (`compare`): step 1's mean loss, the later steps' mean losses
and the first gradient in units of the float32 reference's own gaps, and
the median leaf's change.

Traced (--trace 1): as drivers/train.py, with the FLOPs of
lib/counts_1phi.py.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.drivers.serve_1phi import seed_weights
from benchmark.drivers.train import compare, compared_batches
from benchmark.harness import Context, Record, gns_config, reference_model


def reference_steps(ctx: Context, cases, weights, mm_dtype=None, rows=None, dtype=None,
                    lr=None, q1: bool = True) -> dict:
    """The single-phi reference's compared update steps from `weights`,
    one per batch of `cases` in the order of compared_batches, on the
    context's device, in `dtype` (float32 by default); `lr` in place of
    the configuration's (0: a state that never changes); rows: the first
    `rows` grids of each batch alone (a fault); q1=False: the reference
    without quirk Q1 (a fault)."""
    import torch

    from benchmark.reference import gns_ref_1phi, grids

    dtype = dtype or torch.float32
    b = ctx.traffic["batch"]
    blocks = {}
    for i in set(compared_batches(ctx.traffic)):
        arrays = grids.stack_cases(cases[i * b:(i + 1) * b])
        block = tuple(torch.as_tensor(a, device=ctx.device) for a in arrays)
        blocks[i] = tuple(a.to(dtype) for a in block[:3]) + block[3:]
    m = ctx.model()
    optim = {"lr": m["learning_rate"] if lr is None else lr, "grad_clip": m["grad_clip"],
             "warmup_steps": m["warmup_steps"]}
    w = {k: t.to(ctx.device, dtype) for k, t in weights.items()}
    losses, first, last, per_grid = gns_ref_1phi.train_steps(
        w, reference_model(ctx), optim, [blocks[i] for i in compared_batches(ctx.traffic)],
        mm_dtype, rows, q1)
    return {"losses": losses, "grad": first, "change": {k: last[k] - w[k] for k in w},
            "grid_losses": per_grid}


def new_job(state, start_weights) -> None:
    """Start a training job: the parameters back to `start_weights` (in
    the order of model.parameters()), Adam's moments, its count and the
    step count to zero, all in place, since a captured step reads and
    writes these tensors."""
    import torch

    moments = [t for v in state.opt_state.values() for t in (v if isinstance(v, list) else [v])]
    with torch.no_grad():
        torch._foreach_copy_(list(state.model.parameters()), start_weights)
        torch._foreach_zero_(moments + [state.step])


def run(ctx: Context) -> Record:
    import torch

    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.ops import segment_kernels
    from gns_torch.train import trainer
    from gns_torch.utils.prepare import GridBatch, batch_from_cases, extract_shared_topology

    from benchmark.lib import counts_1phi
    from benchmark.reference import grids

    t = ctx.traffic
    cfg = gns_config(ctx)
    if cfg.optimizer != "adam":
        raise ValueError("the training check reads Adam's first moment")
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    bs = t["batch"]
    cases = grids.make_cases(ctx.grid(), t["dataset"], ctx.seed)

    launches = spans = None
    if ctx.trace:
        from benchmark.lib import trace as tr

        spans = tr.Spans()
        launches = tr.Launches(segment_kernels).install()
        launches.capture_only = True

    data = batch_from_cases(cases)
    model = GNS(cfg, seed=0, device=device)
    weights = seed_weights(ctx, model, device)
    optimizer = trainer.make_optimizer(cfg)
    state = trainer.TrainState(model, optimizer.init(model.parameters()),
                               torch.zeros((), dtype=torch.int32, device=device))
    epoch = trainer.make_epoch_step(cfg, optimizer, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, bs), device)
    names = [n for n, _ in model.named_parameters()]

    # step 1 through the window's own call, then steps 2-5 as one whole epoch
    _, first = epoch(state, GridBatch(*(a[0:1] for a in stacked)))
    grad = {n: (mu / (1 - trainer.ADAM_B1)).clone()
            for n, mu in zip(names, state.opt_state["mu"])}
    _, metrics = epoch(state, stacked)
    float(metrics["last_loss"].mean())
    change = {n: p.detach() - weights[n] for n, p in model.named_parameters()}
    program = {"losses": torch.cat([first["loss"], metrics["loss"]]).tolist(),
               "grad": grad, "change": change}
    if launches is not None:
        launches.capture_only = False
    if cuda:
        torch.cuda.synchronize()

    losses = []
    n_batches = stacked.buses.shape[0]
    start_weights = [weights[n] for n in names]

    def one_epoch():
        if len(losses) % t["job_epochs"] == 0:
            new_job(state, start_weights)
        if spans is None:
            _, metrics = epoch(state, stacked)
            float(metrics["last_loss"].mean())
        else:
            with spans("epoch"):
                _, metrics = epoch(state, stacked)
            with spans("loss read"):
                float(metrics["last_loss"].mean())
        losses.append(metrics["loss"])

    trace = None
    traced_s = traced_epochs = 0  # the profiled epochs, with the reading of their trace
    start = time.perf_counter()
    setup_s = start - ctx.t0
    while time.perf_counter() - start < ctx.seconds:
        if ctx.trace and trace is None and time.perf_counter() - start >= ctx.seconds / 3:
            from benchmark.lib import trace as tr

            per_step = len(launches.seen)
            n = t["traced_epochs"]
            first, t_prof = len(losses), time.perf_counter()
            trace = tr.profile(
                one_epoch, n,
                lambda acts: tr.count_kernels(acts, tr.K1_KERNELS, tr.K2_KERNELS)
                == per_step * n * n_batches)
            traced_s, traced_epochs = time.perf_counter() - t_prof, len(losses) - first
        else:
            one_epoch()
    window_s = time.perf_counter() - start
    if launches is not None:
        launches.uninstall()

    epochs = len(losses)
    steps = epochs * n_batches
    all_losses = torch.cat(losses).cpu().numpy()
    failed = int((~np.isfinite(all_losses)).sum())
    model_cfg = ctx.model()
    n_bus, n_line = stacked.buses.shape[2], stacked.lines.shape[2]
    traced_launches = []
    if launches is not None and trace is not None:
        traced_launches = list(launches.seen) * (trace.units * n_batches)
    rec = Record(
        kind="train",
        e2e={"train_edges_per_s": steps * bs * n_line * model_cfg["K"] / window_s,
             "setup_s": setup_s},
        attempted=steps, failed=failed, checks={},
        memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
        window_s=window_s - traced_s,
        flops=(steps - traced_epochs * n_batches) * counts_1phi.train_step_flops(
            model_cfg, n_bus, n_line, bs),
        spans=spans, units=epochs, launches=traced_launches, trace=trace,
    )
    del state, model, epoch, stacked, metrics, optimizer
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref32 = reference_steps(ctx, cases, weights)
    ref64 = reference_steps(ctx, cases, weights, dtype=torch.float64)
    rec.checks = {name: {"value": value, "limit": ctx.limits[name]}
                  for name, value in compare(program, ref32, ref64).items()}
    rec.detail = {"program": program, "reference": ref32, "reference64": ref64,
                  "weights": weights}
    return rec
