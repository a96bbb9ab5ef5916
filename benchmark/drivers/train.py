"""Training epochs: a dataset of `dataset` seeded grids in batches of
`batch`, one call of the port's make_epoch_step over stack_epoch(data,
batch) per epoch and one host read of last_loss.mean() per epoch, as the
port's train() drives it, until the window's seconds have passed.

  train_edges_per_s  steps x batch x lines x K completed in the window over
                     the window; the window is whole epochs, each closed
                     by its host read
  setup_s            process start to the first timed epoch

Set-up builds one training state from the seed and drives it through its
first steps with the window's own call and feed: one call over the first
batch (the capture and step 1; the first gradient is read from Adam's
first moment), then one call over the whole epoch (steps 2 to 5, the
window's own call; the parameters are read after it). Step 2 takes the
first batch's grids again, as a second epoch's first step does; steps 3
to 5 take the other batches. Those five steps are what the reference
follows. A step whose loss is not finite is failed.

Compared once the window has closed (limits/<cell>.json), against the
reference's same five steps in float64 (`compare`): step 1's mean loss,
the largest gap of the later steps' mean losses and the first gradient
(the median leaf), each in units of the float32 reference's own gap from
float64 at that seed and step, and the parameters' change after the five
steps (the median leaf); each leaf as its gap of norms over the larger of
its reference norm and the median leaf's (gns_ref.leaf_gaps). The change
leaves out the leaves whose reference gradient is under a thousandth of
the median leaf's: Adam moves those by rounding alone.

Traced (--trace 1): spans around each epoch call and its host read, K1 /
K2 launches noted while the step is captured (the captured step's
launches count once per replayed step), and one profiler trace of
`traced_epochs` whole epochs from a third of the window on.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark.harness import Context, Record, gns_config, reference_model, seed_weights

CHANGE_FLOOR = 1e-3  # of the median leaf's first gradient: leaves Adam moves by rounding


def compared_batches(traffic: dict) -> list:
    """The batch of each compared step: the first alone, then the whole
    epoch."""
    return [0] + list(range(traffic["dataset"] // traffic["batch"]))


def compare(program: dict, ref32: dict, ref64: dict, detail: bool = False) -> dict:
    """program and the references: {"losses" (each compared step), "grad"
    (leaf -> first gradient), "change" (leaf -> parameter change after the
    last step)}; the references also {"grid_losses"}: each grid's loss in
    each step.

    loss_gap: step 1's mean loss, its relative gap from float64, in units
    of the float32 reference's widest relative gap of one grid's loss from
    float64 in that step; steps_loss_gap: the largest of the same over the
    later steps. grad_gap: the median leaf's gap of norms of the first
    gradient from float64 (gns_ref.leaf_gaps), in units of the float32
    reference's own median leaf. A seed's weights can make the K-step map
    sensitive, which scales every rounding gap alike (a dozen seeds of an
    8-step model read 7.9e-7 to 1.8e-4 for the worst leaf's raw gap of the
    program's first gradient from the float32 reference's, the TF32
    control 1.4e-3 to 3.1e-2); the units keep what float32 itself owes at
    that seed and step out of the number.

    change_gap: the median leaf's gap of norms of the change after the
    last step from float64, over the leaves whose float64 gradient is at
    least CHANGE_FLOOR of the median leaf's.

    Median leaves: a leaf can hold hidden units whose gradient is zero but
    for rounding (an update head's unit that is active at every bus sees
    only the sum of the angle gradient, which a global angle shift makes
    zero). Such an element of the first gradient is noise whose size
    depends on the order of the adds, so the worst leaf's ratio swings
    from seed to seed (0.04 to 19.9 over two dozen seeds); and Adam's first
    updates are about +-lr on every element whatever its gradient's size,
    so the element moves by up to lr either way, on any two float32 sides
    alike. The later steps' losses carry that noise, on the float32
    reference as on the program, hence each step's own units. detail adds
    the raw readings, none of them compared.
    """
    import torch

    from benchmark.reference.gns_ref import leaf_gaps

    def rel(a, b):
        return abs(a - b) / abs(b)

    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref64["grad"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    skip = {k for k, v in norms.items() if v < CHANGE_FLOOR * median}
    own_loss = [float(((a.double() - b.double()).abs() / b.double().abs()).max())
                for a, b in zip(ref32["grid_losses"], ref64["grid_losses"])]
    steps = [rel(a, b) / max(own, 1e-30)
             for a, b, own in zip(program["losses"], ref64["losses"], own_loss)]

    def median_leaf(gaps):
        return sorted(gaps.values())[len(gaps) // 2]

    grads, own_grads = leaf_gaps(program["grad"], ref64["grad"]), leaf_gaps(ref32["grad"],
                                                                            ref64["grad"])
    change = leaf_gaps(program["change"], ref64["change"], skip)
    out = {"loss_gap": steps[0], "steps_loss_gap": max(steps[1:]),
           "grad_gap": median_leaf(grads) / max(median_leaf(own_grads), 1e-30),
           "change_gap": median_leaf(change)}
    if detail:
        worst, worst_grad = max(change, key=change.get), max(grads, key=grads.get)
        out.update(loss_steps=[rel(a, b) for a, b in zip(program["losses"], ref64["losses"])],
                   own_loss=own_loss, steps=steps, grad_median=median_leaf(grads),
                   own_grad_median=median_leaf(own_grads),
                   grad_worst=grads[worst_grad] / max(max(own_grads.values()), 1e-30),
                   grad_worst_leaf=worst_grad,
                   own_grad_worst_leaf=max(own_grads, key=own_grads.get), change_worst=change[worst], change_worst_leaf=worst, skipped=sorted(skip))
    return out


def reference_steps(ctx: Context, cases, weights, mm_dtype=None, rows=None, dtype=None,
                    lr=None) -> dict:
    """The reference's compared update steps from `weights`, one per batch
    of `cases` in the order of compared_batches, on the context's device,
    in `dtype` (float32 by default); `lr` in place of the configuration's
    (0: a state that never changes)."""
    import torch

    from benchmark.reference import gns_ref, grids

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
    losses, first, last, per_grid = gns_ref.train_steps(
        w, reference_model(ctx), optim, [blocks[i] for i in compared_batches(ctx.traffic)],
        mm_dtype, rows)
    return {"losses": losses, "grad": first, "change": {k: last[k] - w[k] for k in w},
            "grid_losses": per_grid}


def run(ctx: Context) -> Record:
    import torch

    from gns_torch.models.gns import GNS, batch_tensors
    from gns_torch.ops import segment_kernels
    from gns_torch.train import trainer
    from gns_torch.utils.prepare import GridBatch, batch_from_cases, extract_shared_topology

    from benchmark.lib import counts
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
    weights = seed_weights(model, ctx.seed, device)
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

    def one_epoch():
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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref32 = reference_steps(ctx, cases, weights)
    ref64 = reference_steps(ctx, cases, weights, dtype=torch.float64)
    rec.checks = {name: {"value": value, "limit": ctx.limits[name]}
                  for name, value in compare(program, ref32, ref64).items()}
    rec.detail = {"program": program, "reference": ref32, "reference64": ref64}
    return rec
