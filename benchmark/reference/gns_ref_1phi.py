"""A plain single-phi Graph Neural Solver, the benchmark's reference for the
configurations with `multiple_phi` false: float32 as they state it,
float64 as the yardstick of float32's rounding.

Written from the equations of the original PyTorch reference (Donon et
al.'s GNS as LeonOrou/OPF-Graph-Neural-Solver codes it, GNS/main.py:107-202,
the GNS class's defaults: K=30, latent 10, hidden 10, gamma 0.9, one phi)
in its parity numerics, with nothing of the program: no kernel, no fused
heads, no cached index, no graph capture. One block of grids that share a
topology is one call; aggregations are index_add_. The physics, the
dispatch, the decode, the optimizer and the leaf comparison are
reference/gns_ref.py's, imported.

  state init   as gns_ref.py: v = the generators' vg summed at their bus
               (1 where none), theta = 0, m = 0, (dp, dq) from the
               set-points;
  step k       edge_in = [m[dst], r, x, b, tau, shift]; one phi head
               (5 + latent -> hidden -> hidden -> 1) on every line, its
               output summed at dst into column 0 of an (n, latent) zero
               buffer (quirk Q1, main.py:169-170: the other columns stay
               0); L_theta, L_v and L_m each read [v, theta, dp, dq, m,
               that buffer]; theta += L_theta, v += L_v at buses without a
               generator, m += L_m; then gns_ref.py's physics refresh;
               loss += gamma^(K-k) * mean(dp^2 + dq^2);
  finalize     last_loss = mean(dp^2 + dq^2), v = max(v, 0).

Departures from GNS/main.py, each also gns_ref.py's: a batch dimension
over grids of one topology (the reference runs one grid at a time), the
loss summed per grid and averaged over the batch, Adam with optax's
formulas, and float64 beside float32. `q1=False` drops quirk Q1 (the
phi sum in every latent column): a fault, never the reference. Leaves are
named as the reference's state_dict names them (`phi.0.linear1.weight`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference.gns_ref import Adam, _mlp, _physics, _sum_at, decode_theta, leaf_gaps

__all__ = ["forward", "train_steps", "decode_theta", "leaf_gaps", "UPDATES"]

UPDATES = ("L_theta", "L_v", "L_m")


def forward(weights: Dict[str, torch.Tensor], model: Dict, grids, mm_dtype=None,
            q1: bool = True):
    """The K-step single-phi forward of one block, in the type of `grids`:
    (buses (S, N, 6), lines (S, E, 7), gens (S, G, 7), src, dst, gen_bus)
    tensors on one device; model: {"K", "latent_dim", "gamma",
    "leaky_relu_slope"}. mm_dtype: the type of the MLP products (default
    the grids' type; bfloat16 for a control). q1: write the phi sum into
    latent column 0 alone, as the reference does (False: a fault).
    Returns {v, theta, total_loss, last_loss}."""
    buses, lines, gens, src, dst, gen_bus = grids
    mm_dtype = mm_dtype or buses.dtype
    s, n = buses.shape[:2]
    k_steps, latent = model["K"], model["latent_dim"]
    gamma, slope = model["gamma"], model["leaky_relu_slope"]

    at_bus = _sum_at(torch.stack([gens[..., 4], gens[..., 6], gens[..., 5],
                                  torch.ones_like(gens[..., 0])], -1), gen_bus, n)
    v = torch.where(at_bus[..., 0] == 0, torch.ones_like(at_bus[..., 0]), at_bus[..., 0])
    is_gen = at_bus[..., 3] > 0
    v2 = v * v
    dp = at_bus[..., 1] - buses[..., 2] - buses[..., 4] * v2
    dq = at_bus[..., 2] - buses[..., 3] + buses[..., 5] * v2
    theta = buses.new_zeros((s, n))
    m = buses.new_zeros((s, n, latent))
    feats = lines[..., 2:7]
    total = buses.new_zeros((s,))
    for k in range(k_steps):
        edge_in = torch.cat([m[:, dst], feats], dim=-1)
        phi_sum = _sum_at(_mlp(weights, f"phi.{k}", edge_in, slope, mm_dtype), dst, n)
        if q1:  # phi_sum (S, N, 1) into column 0 of the buffer
            phi_sum = torch.cat([phi_sum, phi_sum.new_zeros((s, n, latent - 1))], -1)
        else:
            phi_sum = phi_sum.expand(s, n, latent)
        node_in = torch.cat([v[..., None], theta[..., None], dp[..., None], dq[..., None], m,
                             phi_sum], -1)
        up = {h: _mlp(weights, f"{h}.{k}", node_in, slope, mm_dtype) for h in UPDATES}
        theta = theta + up["L_theta"][..., 0]
        v = torch.where(is_gen, v, v + up["L_v"][..., 0])
        m = m + up["L_m"]
        dp, dq = _physics(v, theta, buses, lines, gens, src, dst, gen_bus)
        total = total + gamma ** (k_steps - k) * (dp * dp + dq * dq).sum(-1) / n
    last = (dp * dp + dq * dq).sum(-1) / n
    return {"v": torch.clamp_min(v, 0.0), "theta": theta, "total_loss": total, "last_loss": last}


def train_steps(weights: Dict[str, torch.Tensor], model: Dict, optim: Dict, batches: List,
                mm_dtype=None, rows: Optional[int] = None, q1: bool = True):
    """Adam steps from `weights` (copied), one per block of `batches`, in
    the type of the weights and batches, as gns_ref.train_steps takes
    them. optim: {"lr", "grad_clip", "warmup_steps"}. rows: take only the
    first `rows` grids of each block into the loss (a fault). Returns (the
    mean discounted loss of each step, the gradient of the first step, the
    parameters after the last step, each grid's discounted loss in each
    step)."""
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    adam = Adam(params, optim["lr"], optim["grad_clip"], optim["warmup_steps"])
    losses, first, per_grid = [], None, []
    for grids in batches:
        if rows is not None:
            grids = tuple(a[:rows] for a in grids[:3]) + tuple(grids[3:])
        total = forward(params, model, grids, mm_dtype, q1)["total_loss"]
        per_grid.append(total.detach().clone())
        loss = total.mean()
        # the last step's L_m reaches no loss: its gradient is 0
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}, per_grid
