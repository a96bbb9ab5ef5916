"""Sharded batches, parameters and the train / eval step on a (dp, gp)
mesh (port of gns_tpu/parallel/sharding.py).

GridBatch layout, as gns_tpu lays it out:
  buses / bus_mask / n_bus     rows over dp                bus state per sample
  lines / line_mask            rows over dp, lines over gp the edge partition
  generators / gen_mask        rows over dp
  parameters                   replicated on every rank

gns_tpu commits these layouts and XLA's partitioner inserts the
collectives. The port is one process per device, so each rank holds its
block (`shard_batch`) and the collectives are written out:

  * gp > 1: the forward goes through models/gns.py's edge_group, so every
    edge -> bus aggregation is a local partial sum and an all-reduce over
    gp (the boundary exchange of parallel/edge_partition.py, whose module
    docstring states the gradient rule used here too). Reference-parity
    mode also runs here, as it does under XLA's partitioned gathers: quirk
    Q2 reads per-line arrays at bus ids, so those arrays are all-gathered
    over gp before they are read (models/gns.py gns_machinery).
  * the loss is the mean over the global batch: each rank's objective is
    its rows' total_loss sum over (global rows * gp size), and the
    gradients (with the two metrics riding along) are summed by ONE
    all-reduce over every mesh axis per step, since the parameters are
    replicated on all of them.

The update itself is the single-process trainer's (train/trainer.py),
eager. No CUDA graph is captured around a collective.

Every rank is handed the WHOLE batch (the caller's host GridBatch) and
returns the whole result: the eval step all-gathers the outputs over dp.
Meshes must list their ranks in ascending order along each axis
(parallel/mesh.py builds them so), so a group's rank order is the order
of its blocks.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from gns_torch.models.gns import GNSOutput, batch_tensors, gns_forward, step_params
from gns_torch.ops import collectives
from gns_torch.parallel.solver_dp import mesh_device
from gns_torch.physics.common import GraphCache
from gns_torch.train.trainer import TrainState, _state_tensors, _update_core, make_optimizer
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, GridTopology

_GROUPS: Dict[tuple, tuple] = {}


def _axes(spec) -> tuple:
    if spec is None:
        return ()
    return (spec,) if isinstance(spec, str) else tuple(spec)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_coord(mesh, spec):
    """(index, size) of this rank along the named axes taken together
    (row-major over them, as a PartitionSpec entry ("dcn", "dp") reads);
    (0, 1) for no axis."""
    names, coord = _names(mesh), mesh.get_coordinate()
    idx, size = 0, 1
    for a in _axes(spec):
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {names})")
        d = names.index(a)
        idx, size = idx * mesh.size(d) + coord[d], size * mesh.size(d)
    return idx, size


def axis_group(mesh, spec):
    """The process group of this rank along the named axes taken together
    (None for no axis). A single axis is the mesh's own group; a tuple is
    built once per mesh with torch.distributed.new_group, which every
    rank of the world calls for every group, in the same order."""
    axes = _axes(spec)
    if not axes:
        return None
    if len(axes) == 1:
        axis_coord(mesh, axes)
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = _names(mesh)
        axis_coord(mesh, axes)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, prod(mesh.size(d) for d in dims))
        mine = None
        for row in rows.tolist():
            group = dist.new_group(row)
            if dist.get_rank() in row:
                mine = group
        _GROUPS[key] = (mesh, mine)  # the mesh is kept so its id is not reused
    return _GROUPS[key][1]


def batch_sharding(mesh, dp="dp", gp: Optional[str] = "gp") -> GridBatch:
    """Per-field placements of a GridBatch on `mesh`: for each field, the
    axis (or axes) each dimension is split over, None for a whole
    dimension (the PartitionSpecs of gns_tpu's layout). dp may be one axis
    name or a tuple, e.g. ("dcn", "dp") on a hybrid mesh."""
    for spec in (dp, gp):
        axis_coord(mesh, spec)
    return GridBatch(
        buses=(dp, None, None),
        lines=(dp, gp, None),
        generators=(dp, None, None),
        bus_mask=(dp, None),
        line_mask=(dp, gp),
        gen_mask=(dp, None),
        n_bus=(dp,),
    )


def _block(a, dim: int, spec, mesh):
    idx, size = axis_coord(mesh, spec)
    n = a.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of size {n} does not divide {_axes(spec)} ({size})")
    step = n // size
    return a[(slice(None),) * dim + (slice(idx * step, (idx + 1) * step),)]


def shard_batch(batch: GridBatch, mesh, dp="dp", gp: Optional[str] = "gp") -> GridBatch:
    """This rank's block of a whole GridBatch under batch_sharding's
    layout (numpy in, numpy out; tensors are sliced alike). Pads nothing:
    the batch size must divide the dp axes and the line count the gp axis
    (pad the batch / bucket beforehand otherwise)."""
    out = []
    for a, spec in zip(batch, batch_sharding(mesh, dp, gp)):
        if a is not None:
            for dim, s in enumerate(spec):
                if s is not None:
                    a = _block(a, dim, s, mesh)
        out.append(a)
    return GridBatch(*out)


def replicate(tree, mesh):
    """Make every rank of `mesh` hold the first rank's values, in place: a
    TrainState (parameters, optimizer state, step), a module or a list of
    tensors. Returns `tree`."""
    if isinstance(tree, TrainState):
        tensors = _state_tensors(tree)
    elif isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters())
    else:
        tensors = list(tree)
    group = axis_group(mesh, _names(mesh))
    with torch.no_grad():
        for t in tensors:
            collectives.broadcast_(t, 0, group)
    return tree


class _Local:
    """One rank's view of the whole host batch on a mesh: its block, the
    Graph of that block and the groups the forward and the step reduce
    over. Graphs of a shared topology are kept in a GraphCache."""

    def __init__(self, cfg, mesh, dp, gp, topo, method):
        self.cfg, self.mesh, self.dp, self.gp = cfg, mesh, dp, gp
        self.topo, self.method = topo, method
        batch_sharding(mesh, dp, gp)  # validates the axis names
        self.device = mesh_device(mesh)
        self.gp_group = axis_group(mesh, gp) if axis_coord(mesh, gp)[1] > 1 else None
        self.gp_size = axis_coord(mesh, gp)[1]
        self.dp_group = axis_group(mesh, dp)
        self.all_group = axis_group(mesh, _names(mesh))
        self.graphs = GraphCache()

    def __call__(self, batch: GridBatch):
        """(local tensors, graph, dense, global rows) of a whole batch."""
        host = host_batch(batch)
        local = shard_batch(host, self.mesh, self.dp, self.gp)
        e_all = host.lines.shape[1]
        topo = self.topo
        if topo is not None and self.gp_size > 1:
            idx, size = axis_coord(self.mesh, self.gp)
            step = e_all // size
            part = slice(idx * step, (idx + 1) * step)
            topo = GridTopology(topo.src[part], topo.dst[part], topo.gen_idx)
        graph = self.graphs(local.buses, local.lines, local.generators, topo, self.device,
                            line_rows=e_all)
        return batch_tensors(local, self.device), graph, host.is_dense(), host.buses.shape[0]

    def forward(self, steps, tensors, graph, dense):
        return gns_forward(steps, self.cfg, tensors, graph, dense=dense, method=self.method,
                           edge_group=self.gp_group)


def make_sharded_train_step(
    cfg: GNSConfig,
    mesh,
    optimizer=None,
    method: str = "auto",
    dp="dp",
    gp: Optional[str] = "gp",
    topo: Optional[GridTopology] = None,
):
    """The update step on `mesh`: (TrainState, whole GridBatch) ->
    (TrainState, {loss, last_loss}), the state (replicated, see
    `replicate`) updated in place on every rank; the metrics are the
    global batch's means, as device tensors. topo: the batches' shared
    GridTopology, or None to index each batch's own ids."""
    optimizer = optimizer or make_optimizer(cfg)
    return _sharded_step(cfg, mesh, optimizer, method, dp, gp, topo)


def _sharded_step(cfg, mesh, optimizer, method, dp, gp, topo):
    local = _Local(cfg, mesh, dp, gp, topo, method)

    def grads_fn(model, tensors, graph, dense, rows):
        params = list(model.parameters())
        with torch.enable_grad():
            out = local.forward(step_params(model, cfg), tensors, graph, dense)
            scale = 1.0 / (rows * local.gp_size)
            grads = torch.autograd.grad(out.total_loss.sum() * scale, params)
        metrics = torch.stack([out.total_loss.sum(), out.last_loss.sum()]).detach() * scale
        # one all-reduce per step: every gradient and the two metrics
        flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
        collectives.all_reduce_(flat, local.all_group)
        sizes = [g.numel() for g in grads]
        parts = torch.split(flat[:-2], sizes)
        grads = [p.view_as(g) for p, g in zip(parts, grads)]
        return flat[-2], flat[-1], grads

    core = _update_core(cfg, optimizer, method, False, grads_fn=grads_fn)

    def step_fn(state: TrainState, batch: GridBatch):
        tensors, graph, dense, rows = local(batch)
        loss, last = core(state, tensors, graph, dense, rows)
        return state, {"loss": loss, "last_loss": last}

    return step_fn


def make_sharded_eval_step(
    cfg: GNSConfig,
    mesh,
    method: str = "auto",
    dp="dp",
    gp: Optional[str] = "gp",
    topo: Optional[GridTopology] = None,
):
    """fn(model, whole GridBatch) -> GNSOutput of the whole batch on every
    rank: each rank's forward over its block (its lines over gp), then
    one all-gather of the outputs over dp."""
    return _sharded_eval(cfg, mesh, method, dp, gp, topo)


def _sharded_eval(cfg, mesh, method, dp, gp, topo):
    local = _Local(cfg, mesh, dp, gp, topo, method)

    def fn(model, batch: GridBatch) -> GNSOutput:
        tensors, graph, dense, _ = local(batch)
        with torch.no_grad():
            out = local.forward(step_params(model, cfg), tensors, graph, dense)
            if local.dp_group is None:
                return out
            n = out.v.shape[1]
            packed = torch.cat([out.v, out.theta, out.delta_p, out.delta_q,
                                out.total_loss[:, None], out.last_loss[:, None]], dim=1)
            full = torch.cat(collectives.all_gather_list(packed, local.dp_group))
        return GNSOutput(v=full[:, :n], theta=full[:, n:2 * n], total_loss=full[:, 4 * n],
                         last_loss=full[:, 4 * n + 1], delta_p=full[:, 2 * n:3 * n],
                         delta_q=full[:, 3 * n:4 * n])

    return fn


def host_batch(batch: GridBatch) -> GridBatch:
    """A GridBatch of numpy arrays (tensors copied to the host)."""
    return GridBatch(*(a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
                       for a in batch))
