"""Pipeline parallelism over the K correction steps, forward and training
(port of gns_tpu/parallel/pipeline.py).

The K steps carry distinct weights (reference GNS/main.py:124-134, 154),
natural stage boundaries. Stage s of S (its coordinate on the `pp` mesh
axis, one process each) owns steps s*K/S .. (s+1)*K/S - 1, with their
discounts gamma^(K - k) at the global k, and streams microbatches of grids
through GPipe's schedule, built from models/gns.py's gns_machinery
(init / step / finalize):

  forward: at tick t, stage s works on microbatch j = t - s (bubble ticks
  idle). Stage 0 starts from the microbatch's init carry, every other
  stage receives the carry (v, theta, m, delta_p, delta_q, total_loss; one
  packed tensor, a few KB per grid) from stage s - 1, runs its K/S steps
  and sends the carry on; the last stage finalizes (v clamp, last_loss).
  Outputs are broadcast from the last stage to every stage.

  training: after all forwards, the backward runs microbatch by
  microbatch in reverse. The last stage starts from its microbatch's loss
  (the mean total_loss over the whole batch); every other stage receives
  the gradient of its output carry from stage s + 1 and runs
  torch.autograd.backward on that carry (recomputed from the stored input
  carry under torch.utils.checkpoint when remat=True, GPipe's recompute);
  each stage but the first sends its input carry's gradient to stage
  s - 1. The parameter gradients land on the stage's own leaves, so the
  optimizer update is stage-local: no parameter collective at all.

Point-to-point is torch.distributed send / recv (ops/collectives.py:
staged through the host for CUDA tensors under gloo, which has no CUDA
point-to-point path). Every rank holds the whole module and the whole
batch; a stage reads and updates only its own steps' weights
(`gather_stage_params` broadcasts each stage's steps to every rank).
Numerics are those of gns_forward / the single-process step: the same
machinery runs, only the placement differs.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gns_torch.models.gns import GNSOutput, batch_tensors, gns_machinery, run_steps, step_params
from gns_torch.ops import collectives
from gns_torch.parallel.sharding import axis_coord, axis_group, host_batch
from gns_torch.parallel.solver_dp import mesh_device
from gns_torch.physics.common import build_graph
from gns_torch.train.trainer import TrainState, make_optimizer, sq_sum64
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, extract_shared_topology


def _check_stages(cfg: GNSConfig, mesh, pp: str) -> int:
    n_stages = axis_coord(mesh, pp)[1]
    if cfg.K % n_stages != 0:
        raise ValueError(f"K={cfg.K} not divisible by {n_stages} stages")
    return n_stages


def stage_param_indices(model, cfg: GNSConfig, stage: int, n_stages: int):
    """Positions in list(model.parameters()) of the weights of stage
    `stage`'s steps (names "<head>.<k>.<layer>.<weight|bias>")."""
    k_local = cfg.K // n_stages
    lo, hi = stage * k_local, (stage + 1) * k_local
    return [i for i, (name, _) in enumerate(model.named_parameters())
            if lo <= int(name.split(".")[1]) < hi]


def _pack(carry):
    v, theta, m, dp, dq, tl = carry
    return torch.cat([v, theta, dp, dq, tl[:, None], m.reshape(m.shape[0], -1)], dim=1)


def _unpack(flat, n: int, latent: int):
    s = flat.shape[0]
    return (flat[:, :n], flat[:, n:2 * n], flat[:, 4 * n + 1:].reshape(s, n, latent),
            flat[:, 2 * n:3 * n], flat[:, 3 * n:4 * n], flat[:, 4 * n])


class _Pipeline:
    """One stage's GPipe schedule over the microbatches of a whole batch."""

    def __init__(self, cfg, mesh, microbatch, pp, method, remat):
        self.cfg, self.mesh, self.microbatch = cfg, mesh, microbatch
        self.method, self.remat = method, remat
        self.n_stages = _check_stages(cfg, mesh, pp)
        self.stage = axis_coord(mesh, pp)[0]
        self.group = axis_group(mesh, pp)
        self.device = mesh_device(mesh)
        self.k_local = cfg.K // self.n_stages

    def _micro(self, batch: GridBatch):
        host = host_batch(batch)
        bsz = host.buses.shape[0]
        if bsz % self.microbatch:
            # flooring the microbatch count would silently DROP the
            # remainder grids from the loss and the gradients
            raise ValueError(f"batch size {bsz} not divisible by microbatch={self.microbatch}")
        topo = extract_shared_topology(host)
        dense = host.is_dense()
        graph = None
        micro = []
        for j in range(bsz // self.microbatch):
            mb = host[j * self.microbatch:(j + 1) * self.microbatch]
            if graph is None or topo is None:
                graph = build_graph(mb.buses, mb.lines, mb.generators, topo, self.device)
            micro.append((batch_tensors(mb, self.device), graph, dense))
        return micro, bsz, host.buses.shape[1]

    def run(self, model, batch: GridBatch, train: bool):
        """The forward schedule. Returns (the finalized outputs per
        microbatch on the last stage, else None; the stored (input flat
        carry, output flat carry) per microbatch when training; batch
        size)."""
        cfg, s, n_stages = self.cfg, self.stage, self.n_stages
        micro, bsz, n = self._micro(batch)
        lo = s * self.k_local
        width = 4 * n + 1 + n * cfg.latent_dim
        outs, stored = [None] * len(micro), [None] * len(micro)
        for t in range(len(micro) + n_stages - 1):
            j = t - s
            if not 0 <= j < len(micro):
                continue  # a bubble tick
            tensors, graph, dense = micro[j]
            # the stage's fused weights, per microbatch: each microbatch's
            # backward runs (and frees) its own graph through them
            steps = step_params(model, cfg, range(lo, lo + self.k_local))
            init, step, finalize, discounts = gns_machinery(
                cfg, tensors, graph, dense=dense, method=self.method)
            disc = discounts[lo:lo + self.k_local]
            if s == 0:
                cin = _pack(init)
            else:
                like = tensors.buses.new_empty((self.microbatch, width))
                cin = collectives.recv(like, s - 1, self.group)
                if train:
                    cin.requires_grad_(True)

            def stage_fn(flat, step=step, disc=disc, steps=steps):
                carry = _unpack(flat, n, cfg.latent_dim)
                return _pack(run_steps(step, carry, steps, disc, remat=False))

            with torch.set_grad_enabled(train):
                if train and self.remat:
                    cout = checkpoint(stage_fn, cin, use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    cout = stage_fn(cin)
                if s < n_stages - 1:
                    collectives.send(cout, s + 1, self.group)
                else:
                    outs[j] = finalize(_unpack(cout, n, cfg.latent_dim))
            if train:
                stored[j] = (cin, cout)
        return outs, stored, bsz

    def broadcast_outputs(self, outs, bsz: int, n: int) -> GNSOutput:
        """The last stage's outputs of the whole batch on every stage."""
        if self.stage == self.n_stages - 1:
            buf = torch.cat([torch.cat([o.v, o.theta, o.delta_p, o.delta_q,
                                        o.total_loss[:, None], o.last_loss[:, None]], dim=1)
                             for o in outs])
        else:
            buf = torch.zeros((bsz, 4 * n + 2), device=self.device)
        collectives.broadcast_(buf, self.n_stages - 1, self.group)
        return GNSOutput(v=buf[:, :n], theta=buf[:, n:2 * n], total_loss=buf[:, 4 * n],
                         last_loss=buf[:, 4 * n + 1], delta_p=buf[:, 2 * n:3 * n],
                         delta_q=buf[:, 3 * n:4 * n])


def make_pipelined_forward(
    cfg: GNSConfig,
    mesh,
    microbatch: int = 1,
    pp: str = "pp",
    method: str = "auto",
):
    """fn(model, whole GridBatch) -> GNSOutput of the whole batch on every
    stage, the K steps pipelined over the `pp` axis. Requires
    cfg.K % S == 0 and batch_size % microbatch == 0."""
    pipe = _Pipeline(cfg, mesh, microbatch, pp, method, remat=False)

    def fn(model, batch: GridBatch) -> GNSOutput:
        with torch.no_grad():
            outs, _, bsz = pipe.run(model, batch, train=False)
            return pipe.broadcast_outputs(outs, bsz, batch.buses.shape[1])

    return fn


def pp_sq_norm(mesh, pp: str = "pp"):
    """grads -> the squared global norm of the stage-local gradients, in
    float64 (trainer.sq_sum64): one all-reduce of the local squares over
    pp."""
    group = axis_group(mesh, pp)

    def sq_norm(grads):
        return collectives.all_reduce_(sq_sum64(grads), group)

    return sq_norm


def make_pipelined_train_step(
    cfg: GNSConfig,
    mesh,
    optimizer=None,
    microbatch: int = 1,
    pp: str = "pp",
    method: str = "auto",
    remat: bool = True,
):
    """Pipeline-parallel training step: (TrainState, whole GridBatch) ->
    (TrainState, {loss, last_loss}), the PP sibling of
    trainer.make_train_step (the same numerics, stage-sharded placement).
    Each stage updates only its own steps' weights and their optimizer
    state, in place; the metrics (the batch's means) come from the last
    stage to every stage. Without `optimizer`, cfg.grad_clip clips by the
    norm over every stage's gradients (pp_sq_norm)."""
    pipe = _Pipeline(cfg, mesh, microbatch, pp, method, remat)
    optimizer = optimizer or make_optimizer(cfg, sq_norm=pp_sq_norm(mesh, pp))
    s, n_stages = pipe.stage, pipe.n_stages

    def step_fn(state: TrainState, batch: GridBatch):
        model = state.model
        params = list(model.parameters())
        idx = stage_param_indices(model, cfg, s, n_stages)
        mine = [params[i] for i in idx]
        outs, stored, bsz = pipe.run(model, batch, train=True)
        for j in reversed(range(len(stored))):
            cin, cout = stored[j]
            inputs = mine + ([cin] if s > 0 else [])
            if s == n_stages - 1:
                torch.autograd.backward(outs[j].total_loss.sum() / bsz, inputs=inputs)
            else:
                g = collectives.recv(cout.detach(), s + 1, pipe.group)
                torch.autograd.backward(cout, grad_tensors=g, inputs=inputs)
            if s > 0:
                grad = cin.grad if cin.grad is not None else torch.zeros_like(cin)
                collectives.send(grad, s - 1, pipe.group)
        if s == n_stages - 1:
            metrics = torch.stack([torch.cat([o.total_loss for o in outs]).mean(),
                                   torch.cat([o.last_loss for o in outs]).mean()]).detach()
        else:
            metrics = torch.zeros(2, device=pipe.device)
        collectives.broadcast_(metrics, n_stages - 1, pipe.group)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in mine]
        sub = {k: ([v[i] for i in idx] if isinstance(v, list) else v)
               for k, v in state.opt_state.items()}
        with torch.no_grad():
            updates, new = optimizer.update(grads, sub, mine)
            torch._foreach_add_(mine, updates)
            for key, value in new.items():
                if isinstance(value, list):
                    torch._foreach_copy_(sub[key], value)
                else:
                    state.opt_state[key].copy_(value)
            state.step.add_(1)
        for p in mine:
            p.grad = None
        return state, {"loss": metrics[0], "last_loss": metrics[1]}

    return step_fn


def gather_stage_params(model, cfg: GNSConfig, mesh, pp: str = "pp"):
    """Broadcast each stage's steps' weights from the stage that owns them,
    so every rank holds the whole trained module (in place; returns it).
    One broadcast per stage."""
    n_stages = _check_stages(cfg, mesh, pp)
    group = axis_group(mesh, pp)
    params = list(model.parameters())
    with torch.no_grad():
        for st in range(n_stages):
            mine = [params[i] for i in stage_param_indices(model, cfg, st, n_stages)]
            flat = torch.cat([p.reshape(-1) for p in mine])
            collectives.broadcast_(flat, st, group)
            torch._foreach_copy_(mine, [f.view_as(p) for f, p in
                                        zip(torch.split(flat, [p.numel() for p in mine]), mine)])
    return model

