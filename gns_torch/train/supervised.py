"""Supervised fine-tuning against Newton-Raphson oracle labels (port of
gns_tpu/train/supervised.py).

The reference trains unsupervised on the physics residual only
(GNS/main.py:198) and uses Newton-Raphson for evaluation only
(GNS/evaluate.py:25-40). Here the oracle labels the training grids and the
model is trained toward its solution:

    loss = sup + w_physics * physics_total
    sup  = mean_buses[(v - v*)^2 + (theta_c - theta_c*)^2]

where * are the NR labels and theta_c is the per-grid mean-centred angle
(the network's angle gauge is unidentified, so raw-angle supervision would
fight an unobservable degree of freedom). The physics term keeps the
iterates on the power-flow manifold between labelled points; w_physics=0
is pure supervision. Training grids must be NR-feasible (generate them
with feasible_only=True) so that every grid has a label.

The update step is the trainer's (train/trainer.py): forward, backward and
the optimizer on the device, K1/K2 forward and backward on the card. On
the card with a shared topology the epoch replays one captured CUDA graph
per batch, the labels copied into static inputs beside the batch; without
one it runs the eager step per batch.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gns_torch.models.gns import gns_forward, step_params
from gns_torch.physics.common import GraphCache
from gns_torch.train.trainer import (
    GradientTransformation,
    TrainState,
    _device,
    _epoch_fn,
    _on,
    _update_core,
    init_train_state,
    make_optimizer,
    stack_epoch,
    state_to,
)
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, extract_shared_topology


class NRLabels(NamedTuple):
    """Oracle solutions aligned with a GridBatch, padded to its bus dim
    (numpy on the host, or tensors once moved to a device)."""

    v: np.ndarray  # (S, N) p.u.
    theta: np.ndarray  # (S, N) radians


def nr_labels(cases: List[dict], n_pad: Optional[int] = None,
              backend: str = "scipy") -> NRLabels:
    """Solve every case and stack (v, theta_rad), zero-padded to n_pad.

    Raises if any case fails to converge: label sets must be generated
    with feasible_only=True.
    """
    from gns_torch.eval.harness import run_nr_oracle

    res = run_nr_oracle(cases, backend=backend)
    if not np.asarray(res["converged"]).all():
        bad = int((~np.asarray(res["converged"])).sum())
        raise ValueError(
            f"{bad}/{len(cases)} label grids did not converge; generate "
            "training cases with feasible_only=True"
        )
    v = np.asarray(res["v"], np.float32)
    th = np.deg2rad(np.asarray(res["theta_deg"], np.float32))
    if n_pad is not None and v.shape[1] < n_pad:
        pad = ((0, 0), (0, n_pad - v.shape[1]))
        v = np.pad(v, pad)
        th = np.pad(th, pad)
    return NRLabels(v, th)


def _labels_on(labels: NRLabels, device) -> NRLabels:
    return NRLabels(*(torch.as_tensor(a, device=device) for a in labels))


def _centered(theta, mask, n_real):
    mean = (theta * mask).sum(1, keepdim=True) / n_real[:, None]
    return (theta - mean) * mask


def supervised_loss_and_grads(model, cfg: GNSConfig, batch: GridBatch, graph, v_labels,
                              theta_labels, w_physics: float, method: str = "auto",
                              dense: bool = False):
    """(sup, mean total_loss, gradients of sup + w_physics * mean total_loss
    in the order of model.parameters()), the losses detached. batch and the
    labels: device tensors; graph: the batch's index sets."""
    params = list(model.parameters())
    with torch.enable_grad():
        out = gns_forward(step_params(model, cfg), cfg, batch, graph, dense=dense, method=method)
        mask = batch.bus_mask
        n_real = batch.n_bus.to(mask.dtype)
        v_err = ((out.v - v_labels) ** 2 * mask).sum(1) / n_real
        th_err = ((_centered(out.theta, mask, n_real) - _centered(theta_labels, mask, n_real)) ** 2
                  * mask).sum(1) / n_real
        sup = (v_err + th_err).mean()
        physics = out.total_loss.mean()
        grads = torch.autograd.grad(sup + w_physics * physics, params)
    return sup.detach(), physics.detach(), list(grads)


def _supervised_core(cfg: GNSConfig, w_physics: float, optimizer, method: str, dense: bool):
    """The trainer's update core (train/trainer.py _update_core) on the
    supervised loss: core(state, batch, graph, v_labels, theta_labels) ->
    (sup, physics), device tensors."""

    def grads_fn(model, batch: GridBatch, graph, v_lab, th_lab):
        return supervised_loss_and_grads(model, cfg, batch, graph, v_lab, th_lab, w_physics,
                                         method, dense)

    return _update_core(cfg, optimizer or make_optimizer(cfg), method, dense, grads_fn)


def make_supervised_train_step(
    cfg: GNSConfig,
    w_physics: float,
    optimizer: Optional[GradientTransformation] = None,
    method: str = "auto",
    topo=None,
    dense: bool = False,
) -> Callable:
    """The eager supervised update step (make_train_step's counterpart):
    (TrainState, GridBatch, NRLabels of the batch) -> (TrainState, {"sup",
    "physics"} device tensors), the state updated in place."""
    core = _supervised_core(cfg, w_physics, optimizer, method, dense)
    graphs = GraphCache()

    def step_fn(state: TrainState, batch: GridBatch, labels: NRLabels):
        device = _device(state)
        graph = graphs(batch.buses, batch.lines, batch.generators, topo, device)
        sup, physics = core(state, _on(batch, device), graph, *_labels_on(labels, device))
        return state, {"sup": sup, "physics": physics}

    return step_fn


def make_supervised_epoch_step(
    cfg: GNSConfig,
    w_physics: float,
    optimizer: Optional[GradientTransformation] = None,
    method: str = "auto",
    topo=None,
    dense: bool = False,
) -> Callable:
    """The epoch over (stacked GridBatch, stacked NRLabels on the state's
    device): fn(TrainState, batches, labels) -> (TrainState, {"sup":
    (n_batches,), "physics": (n_batches,)}), the state updated in place.
    Its schedule is make_epoch_step's (train/trainer.py): a replayed CUDA
    graph per batch on the card with a shared topology (topo), eager steps
    without one or on the CPU.
    """
    run = _epoch_fn(_supervised_core(cfg, w_physics, optimizer, method, dense), topo)

    def epoch_fn(state: TrainState, batches: GridBatch, labels: NRLabels):
        _, metrics = run(state, batches, labels.v, labels.theta)
        return state, {"sup": metrics["loss"], "physics": metrics["last_loss"]}

    return epoch_fn


def stack_labels(labels: NRLabels, batch_size: int) -> NRLabels:
    """Reshape (S, N) labels into (S//bs, bs, N), mirroring stack_epoch."""
    n_batches = labels.v.shape[0] // batch_size
    s = n_batches * batch_size
    return NRLabels(*(a[:s].reshape((n_batches, batch_size) + tuple(a.shape[1:]))
                      for a in labels))


def _epochs(cfg: GNSConfig, state: TrainState, run_epoch: Callable, log_fn):
    """gns_tpu's supervised epoch loop around run_epoch() -> (sup, extra
    history fields): a stop on a NaN/Inf sup, early stop after
    early_stop_patience + 1 non-improving epochs, the best state a CPU copy
    (taken before the first step and at every improvement)."""
    best_metric = float("inf")
    best_state = state_to(state, "cpu")
    bad = 0
    history = []
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        sup, extra = run_epoch()
        dt = time.perf_counter() - t0
        diverged = not math.isfinite(sup)
        history.append({"epoch": epoch, "sup": sup, **extra, "sec": dt, "diverged": diverged})
        if log_fn:
            log_fn(history[-1])
        if diverged:
            break
        if sup >= best_metric:
            bad += 1
            if bad > cfg.early_stop_patience:
                break
        else:
            best_metric = sup
            best_state = state_to(state, "cpu")
            bad = 0
    return best_state, history


def train_supervised(
    cfg: GNSConfig,
    data: GridBatch,
    labels: NRLabels,
    w_physics: float = 0.1,
    seed: Optional[int] = None,
    method: str = "auto",
    log_fn: Optional[Callable] = None,
    state: Optional[TrainState] = None,
    device="cuda",
) -> Tuple[TrainState, list]:
    """Supervised training run; early stop on the supervised metric.

    Mirrors trainer.train's epoch / early-stop / divergence semantics (the
    reference's driver shape, GNS/main.py:274-309) with the supervised loss
    as the monitored quantity. A new state is made from seed (default
    cfg.seed) on `device` unless `state` is given, which is then trained in
    place on its own device. Returns (best_state, history), best_state a
    CPU copy.
    """
    if state is None:
        state = init_train_state(cfg.seed if seed is None else seed, cfg, device=device)
    dev = _device(state)
    bs = min(cfg.batch_size, data.batch_size)
    epoch_step = make_supervised_epoch_step(cfg, w_physics, method=method,
                                            topo=extract_shared_topology(data),
                                            dense=data.is_dense())
    batches = _on(stack_epoch(data, bs), dev)
    stacked = _labels_on(stack_labels(labels, bs), dev)

    def run_epoch():
        _, metrics = epoch_step(state, batches, stacked)
        return float(metrics["sup"].mean()), {"physics": float(metrics["physics"].mean())}

    return _epochs(cfg, state, run_epoch, log_fn)


def train_supervised_multi(
    cfg: GNSConfig,
    datasets,
    label_sets,
    w_physics: float = 0.1,
    seed: Optional[int] = None,
    method: str = "auto",
    log_fn: Optional[Callable] = None,
    state: Optional[TrainState] = None,
    device="cuda",
) -> Tuple[TrainState, list]:
    """Supervised fine-tuning of ONE model over several cases at once (the
    supervised counterpart of trainer.train_multi): each case keeps its own
    (GridBatch, NRLabels) group with its own shapes and shared topology,
    one epoch step per group per epoch, shared parameters throughout. Early
    stop and the best state track the mean of the groups' supervised
    metrics; history rows carry them under "group_sups"."""
    if state is None:
        state = init_train_state(cfg.seed if seed is None else seed, cfg, device=device)
    dev = _device(state)
    groups = []
    for data, labels in zip(datasets, label_sets):
        bs = min(cfg.batch_size, data.batch_size)
        groups.append((
            make_supervised_epoch_step(cfg, w_physics, method=method,
                                       topo=extract_shared_topology(data),
                                       dense=data.is_dense()),
            _on(stack_epoch(data, bs), dev),
            _labels_on(stack_labels(labels, bs), dev),
        ))

    def run_epoch():
        sups, physs = [], []
        for step, batches, stacked in groups:
            _, metrics = step(state, batches, stacked)
            sups.append(float(metrics["sup"].mean()))
            physs.append(float(metrics["physics"].mean()))
        return sum(sups) / len(sups), {"group_sups": sups, "physics": sum(physs) / len(physs)}

    return _epochs(cfg, state, run_epoch, log_fn)
