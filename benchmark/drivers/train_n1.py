"""Training epochs of the outage-aware GNS with textbook AC physics (a
configuration with `reference_parity` false) over the IEEE 118-bus case:
drivers/train.py's epochs, metrics, traced part and comparison, with the
configuration's own grid, outage draw, shunts and reference.

A dataset of `dataset` seeded N-1 grids (reference/grids_118.py
n1_cases: the reference's augmentation at scale 1.0, then with
probability `outage_prob` one in-service non-bridge branch outaged) in
batches of `batch`, one call of the port's make_epoch_step over
stack_epoch(data, batch) per epoch and one host read of last_loss.mean()
per epoch, until the window's seconds have passed; in training jobs of
`job_epochs` epochs (the recipe's 400), each from the seeded weights with
Adam's state and the step count at zero (drivers/train_1phi.py new_job).

  train_edges_per_s  steps x batch x lines x K completed in the window over
                     the window; the window is whole epochs, each closed
                     by its host read
  setup_s            process start to the first timed epoch

Set-up drives the state through its first steps with the window's own
call and feed, as drivers/train.py does: one call over the first batch
(the capture and step 1; the first gradient, clipped, read from Adam's
first moment), then one call over the whole epoch (steps 2 to
1 + dataset / batch). A step whose loss is not finite is failed.
Compared once the window has closed, against reference/gns_ref_n1.py's
same steps in float32 and float64, as drivers/train.py compares
(`compare`).

Weights: torch.nn.Linear's distribution from --seed (harness.seed_weights),
then the update heads' output layers times the configuration's
init_correction_scale, as the port's GNS init scales them
(`seed_weights`).

Traced (--trace 1): as drivers/train.py, and the program's counter
model.eager_refreshes over its counter train.steps_built, the update steps
the set-up's first call built (the capture's warm-ups and the captured step
on the card, the one eager step on the CPU), recorded under the program's
`recording()`; a program without the counters gives no reading.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import harness
from benchmark.drivers.train import compare, compared_batches
from benchmark.drivers.train_1phi import new_job
from benchmark.harness import Context, Record, gns_config


def base_grid(ctx: Context) -> dict:
    """The grid the traffic perturbs: the configuration's (its "grid",
    "ieee_case118"), unless a test passes a smaller one."""
    if ctx.base_case is not None:
        return ctx.base_case
    from benchmark.reference import grids_118

    return {"ieee_case118": grids_118.case118}[ctx.config["grid"]]()


def make_cases(ctx: Context):
    from benchmark.reference import grids_118

    t = ctx.traffic
    return grids_118.n1_cases(base_grid(ctx), t["dataset"], ctx.seed, t["outage_prob"])


def seed_weights(ctx: Context, model, device) -> dict:
    """The configuration's weights in `model`, from the context's seed:
    harness.seed_weights, then linear4's weight and bias of L_theta, L_v
    and L_m times the configuration's init_correction_scale (the port's
    models/gns.py GNS scales the same leaves). Returns a copy by
    state_dict name, which the reference is given."""
    import torch

    from benchmark.reference.gns_ref import UPDATES

    harness.seed_weights(model, ctx.seed, device)
    scale = ctx.model().get("init_correction_scale", 1.0)
    with torch.no_grad():
        for head, _, _ in UPDATES:
            for block in getattr(model, head):
                block.linear4.weight.mul_(scale)
                block.linear4.bias.mul_(scale)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def reference_model(ctx: Context) -> dict:
    m = ctx.model()
    return {k: m[k] for k in ("K", "latent_dim", "hidden_dim", "gamma", "leaky_relu_slope",
                              "v_anchor")}


def reference_steps(ctx: Context, cases, weights, mm_dtype=None, rows=None, dtype=None,
                    lr=None, admittance: bool = True, clip: bool = True) -> dict:
    """The reference's compared update steps from `weights`, one per batch
    of `cases` in the order of compared_batches, on the context's device,
    in `dtype` (float32 by default); `lr` in place of the configuration's
    (0: a state that never changes); rows, admittance=False, clip=False:
    the faults of gns_ref_n1.train_steps."""
    import torch

    from benchmark.reference import gns_ref_n1

    dtype = dtype or torch.float32
    b = ctx.traffic["batch"]
    blocks = {}
    for i in set(compared_batches(ctx.traffic)):
        arrays = gns_ref_n1.stack_cases(cases[i * b:(i + 1) * b])
        block = tuple(torch.as_tensor(a, device=ctx.device) for a in arrays)
        blocks[i] = tuple(a.to(dtype) for a in block[:3]) + block[3:]
    m = ctx.model()
    optim = {"lr": m["learning_rate"] if lr is None else lr, "grad_clip": m["grad_clip"],
             "warmup_steps": m["warmup_steps"]}
    w = {k: t.to(ctx.device, dtype) for k, t in weights.items()}
    losses, first, last, per_grid = gns_ref_n1.train_steps(
        w, reference_model(ctx), optim, [blocks[i] for i in compared_batches(ctx.traffic)],
        mm_dtype, rows, admittance, clip)
    return {"losses": losses, "grad": first, "change": {k: last[k] - w[k] for k in w},
            "grid_losses": per_grid}


def eager_refreshes_per_step(counted: dict):
    """model.eager_refreshes over the update steps the recorded call built
    (the program's train.steps_built: a capture's warm-ups and the
    captured step on the card, one eager step on the CPU); None where the
    program has no such counters."""
    if "model.eager_refreshes" not in counted or not counted.get("train.steps_built"):
        return None
    return counted["model.eager_refreshes"] / counted["train.steps_built"]


def run(ctx: Context) -> Record:
    import torch

    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.ops import segment_kernels
    from gns_torch.train import trainer
    from gns_torch.utils import profiling
    from gns_torch.utils.prepare import GridBatch, batch_from_cases, extract_shared_topology

    from benchmark.lib import counts

    t = ctx.traffic
    cfg = gns_config(ctx)
    if cfg.optimizer != "adam":
        raise ValueError("the training check reads Adam's first moment")
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bs = t["batch"]
    cases = make_cases(ctx)

    launches = spans = None
    if ctx.trace:
        from benchmark.lib import trace as tr

        spans = tr.Spans()
        launches = tr.Launches(segment_kernels).install()
        launches.capture_only = True

    data = batch_from_cases(cases, paper_shunts=not cfg.true_shunts)
    model = GNS(cfg, seed=0, device=device)
    weights = seed_weights(ctx, model, device)
    optimizer = trainer.make_optimizer(cfg)
    state = trainer.TrainState(model, optimizer.init(model.parameters()),
                               torch.zeros((), dtype=torch.int32, device=device))
    epoch = trainer.make_epoch_step(cfg, optimizer, topo=extract_shared_topology(data),
                                    dense=data.is_dense())
    stacked = batch_tensors(trainer.stack_epoch(data, bs), device)
    names = [n for n, _ in model.named_parameters()]

    # step 1 through the window's own call, then one whole epoch
    eager_per_step = None
    if ctx.trace:
        with profiling.recording():
            _, first = epoch(state, GridBatch(*(a[0:1] for a in stacked)))
        eager_per_step = eager_refreshes_per_step(profiling.recorded().counted())
    else:
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
        flops=(steps - traced_epochs * n_batches) * counts.train_step_flops(
            model_cfg, n_bus, n_line, bs),
        spans=spans, units=epochs, launches=traced_launches, trace=trace,
    )
    del state, model, epoch, stacked, metrics, optimizer
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref32 = reference_steps(ctx, cases, weights)
    ref64 = reference_steps(ctx, cases, weights, dtype=torch.float64)
    rec.checks = {name: {"value": value, "limit": ctx.limits[name]}
                  for name, value in compare(program, ref32, ref64).items()}
    rec.detail = {"program": program, "reference": ref32, "reference64": ref64,
                  "weights": weights, "cases": cases, "eager_refreshes_per_step": eager_per_step}
    return rec
