"""Tensor parallelism: the MLPs' hidden units split over a `tp` axis (port
of gns_tpu/parallel/tensor_parallel.py).

The Megatron layout of every LearningBlock (torch's (out, in) layout; in
gns_tpu's (in, out) layout the same split reads w1 by hidden columns, w2
by hidden rows):

  linear1.weight (H, din)   column-parallel: this rank's hidden units
  linear1.bias   (H,)       with them
  linear2.weight (H, H)     row-parallel: the same units as INPUT columns
  linear2.bias, linear4.*   replicated

gns_tpu commits these shardings and GSPMD inserts the all-reduce after
the row-parallel matmul. The port holds each rank's slices in a module of
its own (`shard_params_tp`) and writes the collectives out
(models/gns.py _mlp): the replicated input passes Megatron's "f" (the
identity forward, its gradient all-reduced over tp in the backward,
before it flows back into node state), the second layer's partial product
Megatron's "g" (an all-reduce forward, the identity backward), then its
bias and activation. Any partition of the hidden units is exact, since the
activation is elementwise; what matters is that w1's rows and w2's columns
are split the same way, which holds inside the fused heads too (each
head's slices are fused, models/gns.py _fuse).

Gradients under f / g: every rank computes the same loss from replicated
state, unscaled; the sharded leaves' gradients are this rank's own, and
the replicated leaves' gradients are already whole on every rank, so over
tp nothing is summed. Over dp (rows of the batch) every gradient is summed
once per step. The clip's global norm (cfg.grad_clip) all-reduces the
sharded leaves' squared norms over tp and counts each replicated leaf once.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from gns_torch.models.gns import GNS, gns_forward, step_params
from gns_torch.ops import collectives
from gns_torch.parallel.sharding import _Local, axis_coord, axis_group
from gns_torch.parallel.solver_dp import mesh_device
from gns_torch.train.trainer import TrainState, _update_core, make_optimizer, sq_sum64
from gns_torch.utils.config import GNSConfig

# the dimension of each LearningBlock parameter split over tp (None: replicated)
_TP_DIM = {"linear1.weight": 0, "linear1.bias": 0, "linear2.weight": 1,
           "linear2.bias": None, "linear4.weight": None, "linear4.bias": None}


def tp_param_shardings(model: GNS, mesh=None, tp: str = "tp") -> Dict[str, Optional[int]]:
    """{parameter name: the dimension split over tp, or None}, for every
    parameter of a GNS module, as the module docstring lays them out."""
    return {name: _TP_DIM[".".join(name.split(".")[-2:])] for name, _ in model.named_parameters()}


def shard_params_tp(model: GNS, mesh, tp: str = "tp") -> GNS:
    """A copy of `model` holding only this rank's tp slices (a contiguous
    block of each block's hidden units), on this rank's device."""
    idx, size = axis_coord(mesh, tp)
    hid = model.cfg.hidden_dim
    if hid % size:
        raise ValueError(f"hidden_dim {hid} does not divide the tp axis ({size})")
    step = hid // size
    part = slice(idx * step, (idx + 1) * step)
    local = copy.deepcopy(model)
    dims = tp_param_shardings(model, mesh, tp)
    with torch.no_grad():
        for name, param in list(local.named_parameters()):
            dim = dims[name]
            if dim is None:
                continue
            owner = local.get_submodule(name.rsplit(".", 1)[0])
            value = param[part] if dim == 0 else param[:, part]
            setattr(owner, name.rsplit(".", 1)[1], nn.Parameter(value.contiguous().clone()))
    return local.to(mesh_device(mesh))


def tp_init_train_state(seed: int, cfg: GNSConfig, mesh, optimizer=None, tp: str = "tp"
                        ) -> TrainState:
    """TrainState with TP-sharded parameters: the module GNS(cfg, seed)
    builds (the same weights on every rank), cut to this rank's slices;
    the optimizer's moments mirror the local parameters."""
    optimizer = optimizer or make_optimizer(cfg)
    model = shard_params_tp(GNS(cfg, seed=seed, device="cpu"), mesh, tp)
    dev = mesh_device(mesh)
    return TrainState(model, optimizer.init(model.parameters()),
                      torch.zeros((), dtype=torch.int32, device=dev))


def tp_sq_norm(model: GNS, mesh, tp: str = "tp"):
    """grads -> the squared global norm of a TP gradient list in
    model.parameters() order, in float64 (trainer.sq_sum64): the sharded
    leaves' squares summed over tp (one all-reduce), each replicated leaf
    counted once."""
    dims = tp_param_shardings(model, mesh, tp)
    sharded = [dims[name] is not None for name, _ in model.named_parameters()]
    group = axis_group(mesh, tp)

    def sq_norm(grads):
        part = sq_sum64([g for g, s in zip(grads, sharded) if s])
        collectives.all_reduce_(part, group)
        return part + sq_sum64([g for g, s in zip(grads, sharded) if not s])

    return sq_norm


def make_tp_train_step(cfg: GNSConfig, mesh, optimizer=None, method: str = "auto",
                       dp: Optional[str] = "dp", tp: str = "tp", topo=None):
    """The update step on a (dp, tp) mesh (or a ("tp",) one: pass
    dp=None): rows of the whole batch over dp, hidden units over tp (the
    state from tp_init_train_state). (TrainState, whole GridBatch) ->
    (TrainState, {loss, last_loss}), updated in place; the metrics are the
    global batch's means. Without `optimizer`, cfg.grad_clip clips by the
    true global norm (tp_sq_norm); a given optimizer's clip sees only this
    rank's gradients."""
    names = tuple(mesh.mesh_dim_names)
    dp = dp if dp in names else None
    local = _Local(cfg, mesh, dp, None, topo, method)
    tp_group = axis_group(mesh, tp)
    state_opt = {}

    def grads_fn(model, tensors, graph, dense, rows):
        params = list(model.parameters())
        with torch.enable_grad():
            out = gns_forward(step_params(model, cfg), cfg, tensors, graph, dense=dense,
                              method=method, tp_group=tp_group)
            grads = torch.autograd.grad(out.total_loss.sum() / rows, params)
        metrics = torch.stack([out.total_loss.sum(), out.last_loss.sum()]).detach() / rows
        if local.dp_group is None:
            return metrics[0], metrics[1], list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
        collectives.all_reduce_(flat, local.dp_group)
        parts = torch.split(flat[:-2], [g.numel() for g in grads])
        return flat[-2], flat[-1], [p.view_as(g) for p, g in zip(parts, grads)]

    def step_fn(state: TrainState, batch):
        if "core" not in state_opt:
            opt = optimizer or make_optimizer(cfg, sq_norm=tp_sq_norm(state.model, mesh, tp))
            state_opt["core"] = _update_core(cfg, opt, method, False, grads_fn=grads_fn)
        tensors, graph, dense, rows = local(batch)
        loss, last = state_opt["core"](state, tensors, graph, dense, rows)
        return state, {"loss": loss, "last_loss": last}

    return step_fn
