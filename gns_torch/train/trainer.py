"""Training driver: the update step, the device-side epoch, and the
reference's training loop (port of gns_tpu/train/trainer.py).

One update step is: the K-step forward over a batch (models/gns.py), the
mean `total_loss`, its gradients by `torch.autograd.grad` (on the card the
backward of every K1 segment-sum launches K2 and the backward of every K2
gather launches K1, ops/segment.py), then the optimizer, all on the
device. The optimizer is functional like optax's GradientTransformation
(`init(params)` / `update(grads, state, params)`), written with
torch._foreach_* ops, and reproduces optax's formulas; every piece of its
state is a device tensor, the step count included, so a CUDA graph can
capture the whole update.

gns_tpu's epoch is one `lax.scan` of update steps per dispatch, to remove
the per-batch host dispatch. The port's counterpart on CUDA captures one
update step in a `torch.cuda.graph` and replays it once per batch after
copying the batch into the graph's static inputs; the host syncs once per
epoch. A graph replays fixed index sets, so batches without a shared
topology (a padded mixed-case dataset, which gns_tpu scans with topo=None)
take the same update step eagerly, batch by batch, still on K1/K2 on the
card, with each batch's index sets built once. On the CPU the same step
runs in a Python loop.

Early stopping, best-checkpoint and divergence semantics follow the
reference driver (GNS/main.py:235-309) as gns_tpu's `train` does.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from gns_torch.models.gns import GNS, batch_tensors, gns_forward, step_params
from gns_torch.ops.segment import check_method
from gns_torch.physics.common import GraphCache, host_array
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, extract_shared_topology
from gns_torch.utils.profiling import count, span

# optax.adam's and optax.adagrad's defaults (gns_tpu calls both with them)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7
# update steps run before a capture, on a side stream (their effect on the
# state is undone before the first replay)
CAPTURE_WARMUP = 2


class GradientTransformation(NamedTuple):
    """optax's interface: init(params) -> state; update(grads, state,
    params) -> (updates, new state). params, grads and updates are lists of
    tensors in one order; the state is a dict of device tensors."""

    init: Callable
    update: Callable


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         sq_norm: Optional[Callable] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: select(norm < max_norm, g, g / norm *
    max_norm), with no epsilon on the norm (torch's clip_grad_norm_ adds
    1e-6). The select is written as a divisor and a factor that are 1 where
    the norm is below max_norm, so g / 1 * 1 returns g exactly. sq_norm:
    grads -> the squared global norm, for gradients sharded over processes
    (parallel/tensor_parallel.py, pipeline.py); None for local ones."""
    if sq_norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        norm = torch.sqrt(sq_norm(grads))
    below = norm < max_norm
    one = torch.ones_like(norm)
    divisor = torch.where(below, one, norm)
    factor = torch.where(below, one, torch.full_like(norm, max_norm))
    return torch._foreach_mul(torch._foreach_div(grads, divisor), factor)


def make_optimizer(cfg: GNSConfig, sq_norm: Optional[Callable] = None) -> GradientTransformation:
    """Adam (lr 1e-3) or Adagrad (lr 1e-2) as gns_tpu builds them with
    optax (reference GNS/main.py:238-243), optionally behind
    clip_by_global_norm(cfg.grad_clip) and with a linear warmup of the step
    size over cfg.warmup_steps.

    The formulas are optax's, which torch.optim's differ from:
      * adam: mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu;
        update = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps), t the
        count after this update (eps outside the root, eps_root 0);
      * adagrad: the accumulator starts at 0.1 and update =
        where(sum > 0, rsqrt(sum + 1e-7), 0) g (torch.optim.Adagrad starts
        at 0 with eps 1e-10 outside the root);
      * warmup: optax.linear_schedule(0, lr, warmup_steps) reads the count
        before this update, so the first update's step size is 0 while
        Adam's moments still advance.
    The step size multiplies the update last, negated. sq_norm: the
    squared global norm of a sharded gradient list, for the clip (see
    _clip_by_global_norm).
    """
    if cfg.optimizer not in ("adam", "adagrad"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    adam = cfg.optimizer == "adam"
    lr, warmup, clip = cfg.lr, cfg.warmup_steps, cfg.grad_clip

    def init(params) -> Dict:
        params = list(params)
        state = {"count": torch.zeros((), dtype=torch.int32, device=params[0].device)}
        if adam:
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        else:
            state["sum_of_squares"] = [torch.full_like(p, ADAGRAD_INIT) for p in params]
        return state

    def update(grads, state, params=None):
        g = list(grads)
        if clip > 0:
            g = _clip_by_global_norm(g, clip, sq_norm)
        count = state["count"]
        count_inc = count + 1
        if adam:
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - ADAM_B1),
                                    torch._foreach_mul(state["mu"], ADAM_B1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2),
                                    torch._foreach_mul(state["nu"], ADAM_B2))
            mu_hat = torch._foreach_div(mu, 1 - torch.pow(ADAM_B1, count_inc))
            nu_hat = torch._foreach_div(nu, 1 - torch.pow(ADAM_B2, count_inc))
            updates = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
            new = {"count": count_inc, "mu": list(mu), "nu": list(nu)}
        else:
            sums = torch._foreach_add(torch._foreach_mul(g, g), state["sum_of_squares"])
            inv = [torch.where(t > 0, torch.rsqrt(t + ADAGRAD_EPS), 0.0) for t in sums]
            updates = torch._foreach_mul(inv, g)
            new = {"count": count_inc, "sum_of_squares": list(sums)}
        if warmup > 0:
            frac = 1 - torch.clamp(count, 0, warmup) / warmup
            step_size = -1 * ((0.0 - lr) * frac + lr)
        else:
            step_size = -lr
        return list(torch._foreach_mul(updates, step_size)), new

    return GradientTransformation(init, update)


class TrainState(NamedTuple):
    """The GNS module (its parameters are the trained state), the
    optimizer's state and the count of update steps, all on one device.
    An update changes all three in place."""

    model: GNS
    opt_state: Dict
    step: torch.Tensor


def init_train_state(seed: int, cfg: GNSConfig, optimizer: Optional[GradientTransformation] = None,
                     device="cuda") -> TrainState:
    model = GNS(cfg, seed=seed, device=device)
    optimizer = optimizer or make_optimizer(cfg)
    dev = next(model.parameters()).device
    return TrainState(model, optimizer.init(model.parameters()),
                      torch.zeros((), dtype=torch.int32, device=dev))


def state_to(state: TrainState, device) -> TrainState:
    """A copy of `state` on `device` (the best-state snapshots are CPU
    copies)."""
    cfg = state.model.cfg
    model = GNS(cfg, device=device)
    with torch.no_grad():
        for mine, theirs in zip(model.parameters(), state.model.parameters()):
            mine.copy_(theirs)
    dev = next(model.parameters()).device
    opt = {k: ([t.detach().to(dev, copy=True) for t in v] if isinstance(v, list)
               else v.detach().to(dev, copy=True))
           for k, v in state.opt_state.items()}
    return TrainState(model, opt, state.step.detach().to(dev, copy=True))


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    out = list(state.model.parameters())
    for v in state.opt_state.values():
        out.extend(v if isinstance(v, list) else [v])
    return out + [state.step]


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def loss_and_grads(model: GNS, cfg: GNSConfig, batch: GridBatch, graph, method: str = "auto",
                   dense: bool = False):
    """(mean total_loss, mean last_loss, gradients of the first in the
    order of model.parameters()), the losses detached. batch: device
    tensors (models/gns.py batch_tensors); graph: its index sets."""
    params = list(model.parameters())
    with torch.enable_grad():
        out = gns_forward(step_params(model, cfg), cfg, batch, graph, dense=dense, method=method)
        loss = out.total_loss.mean()
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), out.last_loss.detach().mean(), list(grads)


def _update_core(cfg, optimizer, method, dense, grads_fn=None):
    """The update step on device tensors: forward, backward, optimizer,
    written into the state in place. No host sync and no host-to-device
    copy, so a CUDA graph can capture it.

    grads_fn(model, batch, graph, *extra) -> (metric, metric, gradients in
    the order of model.parameters()), the metrics detached; default
    loss_and_grads (mean total_loss, mean last_loss). The core returns the
    two metrics. `method` is checked here by name (ops/segment.py
    check_method), and against the device at each forward."""
    check_method(method)
    if grads_fn is None:
        def grads_fn(model, batch, graph):
            return loss_and_grads(model, cfg, batch, graph, method, dense)

    def core(state: TrainState, batch: GridBatch, graph, *extra):
        loss, last, grads = grads_fn(state.model, batch, graph, *extra)
        params = list(state.model.parameters())
        with torch.no_grad():
            updates, new = optimizer.update(grads, state.opt_state, params)
            torch._foreach_add_(params, updates)  # optax.apply_updates: p + u
            for key, value in new.items():
                if isinstance(value, list):
                    torch._foreach_copy_(state.opt_state[key], value)
                else:
                    state.opt_state[key].copy_(value)
            state.step.add_(1)
        return loss, last

    return core


def _on(batch: GridBatch, device: torch.device) -> GridBatch:
    """The batch as tensors on `device` (a no-op for tensors already there)."""
    if all(torch.is_tensor(a) and a.device == device for a in batch):
        return batch
    return batch_tensors(GridBatch(*(host_array(a) for a in batch)), device)


def make_train_step(
    cfg: GNSConfig,
    optimizer: Optional[GradientTransformation] = None,
    method: str = "auto",
    topo=None,
    dense: bool = False,
) -> Callable:
    """The eager update step: (TrainState, GridBatch) -> (TrainState,
    metrics), the state updated in place.

    metrics = {loss, last_loss}: the batch's mean discounted training loss
    and mean undiscounted final-step residual (the reference's early-stop
    signal, main.py:283-285), as device tensors.

    topo: the batches' shared GridTopology, or None to build the index sets
    from each batch's own ids (the batch must then be host data or tensors
    the host can read). dense: the batches are unpadded
    (GridBatch.is_dense()), so the masks are skipped (exact).
    """
    core = _update_core(cfg, optimizer or make_optimizer(cfg), method, dense)
    graphs = GraphCache()

    def step_fn(state: TrainState, batch: GridBatch):
        device = _device(state)
        graph = graphs(batch.buses, batch.lines, batch.generators, topo, device)
        loss, last = core(state, _on(batch, device), graph)
        return state, {"loss": loss, "last_loss": last}

    return step_fn


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # the static inputs the graph reads: the batch's arrays, then any extra
    loss: torch.Tensor  # the static outputs it writes
    last_loss: torch.Tensor


_NB = len(GridBatch._fields)


def _capture(core, state: TrainState, graph, sample: tuple) -> _Captured:
    """Capture one update step of `state` in a CUDA graph. sample: one
    batch's arrays (GridBatch order) followed by any extra inputs of the
    core.

    Capture needs warm-up iterations on a side stream first. The warm-ups
    and the capture itself each run the update once, so the parameters,
    the optimizer state and the step are saved before them and restored
    after: the first replay is the epoch's first step. An error in the
    capture raises."""
    static = tuple(a.clone() for a in sample)
    args = (GridBatch(*static[:_NB]), graph, *static[_NB:])
    tensors = _state_tensors(state)
    saved = [t.detach().clone() for t in tensors]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP):
            core(state, *args)
    torch.cuda.current_stream().wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        loss, last = core(state, *args)
    with torch.no_grad():
        torch._foreach_copy_(tensors, saved)
    return _Captured(cuda_graph, static, loss, last)


def make_epoch_step(
    cfg: GNSConfig,
    optimizer: Optional[GradientTransformation] = None,
    method: str = "auto",
    topo=None,
    dense: bool = False,
) -> Callable:
    """The device-side epoch: fn(TrainState, GridBatch with leading
    (n_batches, batch, ...) axes) -> (TrainState, {loss (n_batches,),
    last_loss (n_batches,)}), the state updated in place.

    On CUDA with one shared topology (topo) the update step is captured
    once per state and batch shape in a CUDA graph and replayed once per
    batch after the batch is copied into the graph's static inputs; each
    step's losses are copied into (n,) device tensors, and nothing waits
    for the device (the caller reads the losses once per epoch). A graph
    replays fixed index sets, so without a shared topology (topo=None) the
    step runs eagerly per batch, on the card as on the CPU, with each
    batch's index sets built once per stacked dataset. On the CPU the step
    always runs in a Python loop. Every way, the result equals a loop of
    make_train_step. The shared topology's index sets come from the
    epoch's own GraphCache (physics/common.py), one Graph per device and
    shape.
    """
    return _epoch_fn(_update_core(cfg, optimizer or make_optimizer(cfg), method, dense), topo)


def _epoch_fn(core, topo) -> Callable:
    """make_epoch_step's epoch around an update core (see there); shared
    with train/supervised.py, whose batches carry their labels beside the
    GridBatch (core(state, batch, graph, *extra))."""
    graphs = GraphCache()
    captured = {}
    per_batch = {}  # without a shared topology: the last stacked data's index sets

    def epoch_fn(state: TrainState, batches: GridBatch, *extra):
        with span("train.epoch"):
            return run_epoch(state, batches, *extra)

    def run_epoch(state: TrainState, batches: GridBatch, *extra):
        device = _device(state)
        n = batches.buses.shape[0]
        if device.type != "cuda" or topo is None:
            if topo is None and per_batch.get("of") is not batches:
                per_batch["of"] = batches  # held, so it is not freed and its id reused
                per_batch["graphs"] = [graphs(batches.buses[i], batches.lines[i],
                                              batches.generators[i], None, device)
                                       for i in range(n)]
            losses, lasts = [], []
            for i in range(n):
                batch = GridBatch(*(a[i] for a in batches))
                graph = (per_batch["graphs"][i] if topo is None
                         else graphs(batch.buses, batch.lines, batch.generators, topo, device))
                with span("train.step"):
                    loss, last = core(state, _on(batch, device), graph, *(x[i] for x in extra))
                losses.append(loss)
                lasts.append(last)
            return state, {"loss": torch.stack(losses), "last_loss": torch.stack(lasts)}
        xs = _on(batches, device)
        flat = (*xs, *extra)
        sample = tuple(a[0] for a in flat)
        key = (tuple(t.data_ptr() for t in _state_tensors(state)),
               tuple((a.shape, a.dtype) for a in sample))
        if key not in captured:
            captured.clear()  # a graph holds its state's tensors and its memory pool
            with span("train.capture"):
                captured[key] = _capture(core, state, graphs(*sample[:3], topo, device), sample)
            count("train.captures")
        cap = captured[key]
        losses = xs.buses.new_empty((n,))
        lasts = xs.buses.new_empty((n,))
        for i in range(n):
            with span("train.copy_in"):
                for dst, src in zip(cap.inputs, flat):
                    dst.copy_(src[i])
            with span("train.replay"):
                cap.graph.replay()
            losses[i].copy_(cap.loss)
            lasts[i].copy_(cap.last_loss)
        return state, {"loss": losses, "last_loss": lasts}

    return epoch_fn


def stack_epoch(data: GridBatch, batch_size: int) -> GridBatch:
    """Reshape a GridBatch (S, ...) into (S//bs, bs, ...) for
    make_epoch_step. Trailing remainder grids are dropped (the reference
    drops them too via its range step, GNS/main.py:276)."""
    n_batches = data.batch_size // batch_size
    s = n_batches * batch_size
    return GridBatch(*(a[:s].reshape((n_batches, batch_size) + tuple(a.shape[1:])) for a in data))


def make_eval_step(cfg: GNSConfig, method: str = "auto", topo=None, dense: bool = False) -> Callable:
    """Inference: (model, GridBatch) -> batched GNSOutput, without
    gradients."""
    graphs = GraphCache()

    def fn(model: GNS, batch: GridBatch):
        device = next(model.parameters()).device
        with torch.no_grad():
            graph = graphs(batch.buses, batch.lines, batch.generators, topo, device)
            return gns_forward(step_params(model, cfg), cfg, _on(batch, device), graph,
                               dense=dense, method=method)

    return fn


def _loop(cfg: GNSConfig, state: TrainState, run_epoch: Callable, log_fn, checkpoint_fn):
    """The reference's epoch loop around run_epoch() -> (epoch loss, extra
    history fields): early stop after early_stop_patience + 1 non-improving
    epochs (GNS/main.py:296-304), checkpoint_fn(best_state, epoch, loss) on
    every improvement (main.py:306-309), a stop on a NaN/Inf loss with the
    last good state. The best state is a CPU copy, taken before the first
    step and at every improvement."""
    best_loss = float("inf")
    best_state = state_to(state, "cpu")
    increase_counter = 0
    history = []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        epoch_final_loss, extra = run_epoch()
        dt = time.perf_counter() - t0
        diverged = not math.isfinite(epoch_final_loss)
        # 'diverged' is on every row so the CSV logger (whose columns are
        # fixed by the first row) records it
        row = {"epoch": epoch, "final_loss": epoch_final_loss, "sec": dt, **extra,
               "diverged": diverged}
        history.append(row)
        if log_fn:
            log_fn(row)
        if diverged:
            break
        if epoch_final_loss >= best_loss:
            increase_counter += 1
            if increase_counter > cfg.early_stop_patience:
                break
        else:
            best_loss = epoch_final_loss
            best_state = state_to(state, "cpu")
            increase_counter = 0
            if checkpoint_fn:
                checkpoint_fn(best_state, epoch, best_loss)
    return best_state, history


def train(
    cfg: GNSConfig,
    data: GridBatch,
    seed: Optional[int] = None,
    method: str = "auto",
    log_fn: Optional[Callable] = None,
    checkpoint_fn: Optional[Callable] = None,
    state: Optional[TrainState] = None,
    device="cuda",
):
    """Full training run with the reference's semantics (see _loop).

    Epochs over `data` (a host GridBatch) in batch_size chunks, one
    make_epoch_step call per epoch (on the card a replayed CUDA graph, or,
    for a dataset without a shared topology, eager steps); a new state is
    made from
    seed (default cfg.seed) on `device` unless `state` is given, which is
    then trained in place on its own device. Returns (best_state, history),
    best_state a CPU copy.
    """
    if state is None:
        state = init_train_state(cfg.seed if seed is None else seed, cfg, device=device)
    bs = min(cfg.batch_size, data.batch_size)
    epoch_step = make_epoch_step(cfg, method=method, topo=extract_shared_topology(data),
                                 dense=data.is_dense())
    stacked = _on(stack_epoch(data, bs), _device(state))

    def run_epoch():
        _, metrics = epoch_step(state, stacked)
        return float(metrics["last_loss"].mean()), {}

    return _loop(cfg, state, run_epoch, log_fn, checkpoint_fn)


def train_multi(
    cfg: GNSConfig,
    datasets,
    seed: Optional[int] = None,
    method: str = "auto",
    log_fn: Optional[Callable] = None,
    checkpoint_fn: Optional[Callable] = None,
    state: Optional[TrainState] = None,
    device="cuda",
):
    """Train ONE model over several datasets (e.g. one GridBatch per
    MATPOWER case) with a shared state. Each dataset keeps its own shapes
    and shared topology, so nothing is padded to the largest case; one
    epoch runs one make_epoch_step per group. Early stop and the best
    checkpoint track the mean of the groups' epoch losses; history rows
    carry the per-group losses under "group_losses"."""
    if state is None:
        state = init_train_state(cfg.seed if seed is None else seed, cfg, device=device)
    groups = []
    for data in datasets:
        bs = min(cfg.batch_size, data.batch_size)
        groups.append((
            make_epoch_step(cfg, method=method, topo=extract_shared_topology(data),
                            dense=data.is_dense()),
            _on(stack_epoch(data, bs), _device(state)),
        ))

    def run_epoch():
        group_losses = []
        for step, stacked in groups:
            _, metrics = step(state, stacked)
            group_losses.append(float(metrics["last_loss"].mean()))
        return sum(group_losses) / len(group_losses), {"group_losses": group_losses}

    return _loop(cfg, state, run_epoch, log_fn, checkpoint_fn)
