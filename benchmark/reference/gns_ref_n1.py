"""A plain outage-aware Graph Neural Solver with textbook AC physics, the
benchmark's reference for the configurations with `reference_parity`
false: float32 as they state it, float64 as the yardstick of float32's
rounding.

Written from the published equations, with nothing of the program: no
kernel, no fused heads, no cached index, no graph capture. The model is
Donon et al.'s GNS ("Neural Networks for Power Flow: Graph Neural
Solver"; LeonOrou/OPF-Graph-Neural-Solver codes it, GNS/main.py) with
multiple phi heads; the physics are the textbook AC power-flow equations
with MATPOWER's pi-model branch (its manual, section 3.2), written in
complex arithmetic; the optimizer is optax's Adam behind
clip_by_global_norm and a linear warm-up. One block of grids that share a
topology is one call; aggregations are index_add_.

  features     admittance inputs (g, b_series, b, tau, shift), g =
               r / (r^2 + x^2), b_series = -x / (r^2 + x^2): an outaged
               line (r = x = 1e6, b = 0) reads as about 0;
  state init   v = the generators' vg summed at their bus (1 where none),
               theta = 0, m = 0; dp = Pg - Pd - Gs v^2 at the set-points,
               0 at the slack bus; dq = Qg - Qd + Bs v^2;
  step k       edge_in = [m[dst], features]; each phi head's output
               summed at dst; L_theta, L_v, L_m each read [v, theta, dp,
               dq, m] and its own phi sum; theta += L_theta, v += L_v at
               buses without a generator (PV freeze), m += L_m; then the
               physics: with V = v e^{j theta}, y_s = 1 / (r + j x) and
               the tap a = tau e^{j shift}, each branch's currents
               I_f = (y_s + j b/2) / tau^2 V_f - y_s / conj(a) V_t and
               I_t = -y_s / a V_f + (y_s + j b/2) V_t, its flows S_f = V_f
               conj(I_f), S_t = V_t conj(I_t); each bus's outflow S_out
               the sum of its branches' S_f and S_t; generators at their
               set-points, dp = Pg - Pd - Gs v^2 - Re S_out, 0 at the
               slack bus, which takes up the imbalance; Qg balances the
               bus at generator buses and is 0 elsewhere, dq = Qg - Qd +
               Bs v^2 - Im S_out; Gs / Bs each case's own;
               loss += gamma^(K-k) * (mean(dp^2 + dq^2) + v_anchor *
               sum over non-generator buses of (v - 1)^2 / N);
  finalize     last_loss = mean(dp^2 + dq^2), v = max(v, 0).

Departures from the paper: a batch dimension over grids of one topology
(the reference runs one grid at a time) and the loss summed per grid and
averaged over the batch; the reference's PV freeze and state
initialisation (GNS/main.py:141-186), which the paper leaves open; the
slack bus takes up the active imbalance in place of the paper's scalar
redispatch (eqs. (20)-(21)); the v tie-breaker term (v_anchor), which the
paper has not, divided by every bus of the grid. The optimizer is Adam
with optax's formulas, behind optax's clip_by_global_norm (no epsilon;
the norm summed in float64, since a float32 sum of squares overflows past
a norm of about 1.8e19, which this map's untrained gradients pass, and
g / inf is no clip) and linear_schedule(0, lr, warmup),
which reads the count before the update: step 1 moves only the moments.
`admittance=False` feeds raw (r, x, b, tau, shift) and `clip=False` drops
the clip: faults, never the reference. Leaves are named as the
reference's state_dict names them (`phi_v.0.linear1.weight`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.gns_ref import PHI, UPDATES, Adam, _mlp, _sum_at, leaf_gaps

__all__ = ["forward", "train_steps", "stack_cases", "clip_by_global_norm", "leaf_gaps"]

SLACK = 3  # MATPOWER's bus type of the reference bus


def prepare_case(case: Dict):
    """(buses (N, 6), lines (E, 7), gens (G, 7)) float32 of one case dict
    with its own shunts: buses (bus_i, type, Pd, Qd, Gs, Bs), powers over
    baseMVA; lines (f_bus, t_bus, r, x, b, tau, shift), tau 0 -> 1, shift
    in radians; gens (bus_i, Pmax, Pmin, Pg_set, vg, qg, Pg)."""
    base = np.float32(case["baseMVA"])
    bus = np.asarray(case["bus"], dtype=np.float32)
    buses = bus[:, :6].copy()
    buses[:, 2:6] /= base
    br = np.asarray(case["branch"], dtype=np.float32)
    tau = np.where(br[:, 8] == 0, np.float32(1.0), br[:, 8])
    lines = np.stack([br[:, 0], br[:, 1], br[:, 2], br[:, 3], br[:, 4], tau,
                      np.deg2rad(br[:, 9])], axis=1).astype(np.float32)
    g = np.asarray(case["gen"], dtype=np.float32)
    gens = np.stack([g[:, 0], g[:, 8] / base, g[:, 9] / base, g[:, 1] / base, g[:, 5],
                     g[:, 2] / base, g[:, 1] / base], axis=1).astype(np.float32)
    return buses, lines, gens


def stack_cases(cases: List[Dict]):
    """Stacked (S, ...) float32 arrays of cases that share one topology,
    with the 0-based (src, dst, gen_bus) index arrays; raises if the
    topologies differ."""
    triples = [prepare_case(c) for c in cases]
    buses, lines, gens = (np.stack([t[i] for t in triples]) for i in range(3))
    ids = (lines[:, :, 0], lines[:, :, 1], gens[:, :, 0])
    if not all((a == a[:1]).all() for a in ids):
        raise ValueError("the reference takes blocks of grids with one shared topology")
    src, dst, gen_bus = (a[0].astype(np.int64) - 1 for a in ids)
    return buses, lines, gens, src, dst, gen_bus


def features(lines, admittance: bool = True):
    """The message MLPs' line features (S, E, 5)."""
    if not admittance:
        return lines[..., 2:7]
    r, x = lines[..., 2], lines[..., 3]
    z2 = r * r + x * x
    return torch.stack([r / z2, -x / z2, lines[..., 4], lines[..., 5], lines[..., 6]], -1)


def _physics(v, theta, buses, lines, gens, src, dst, gen_bus, is_gen, slack):
    """The textbook mismatches (dp, dq), each (S, N), at (v, theta)."""
    n = buses.shape[1]
    r, x, b = lines[..., 2], lines[..., 3], lines[..., 4]
    tau, shift = lines[..., 5], lines[..., 6]
    volt = torch.complex(v * torch.cos(theta), v * torch.sin(theta))
    v_f, v_t = volt[:, src], volt[:, dst]
    y_s = 1.0 / torch.complex(r, x)
    y_sh = y_s + torch.complex(torch.zeros_like(b), b / 2.0)
    tap = torch.complex(tau * torch.cos(shift), tau * torch.sin(shift))
    i_f = y_sh / (tau * tau) * v_f - y_s / tap.conj() * v_t
    i_t = -y_s / tap * v_f + y_sh * v_t
    s_out = _sum_at(v_f * i_f.conj(), src, n) + _sum_at(v_t * i_t.conj(), dst, n)
    v2 = v * v
    pd, qd, gs, bs = buses[..., 2], buses[..., 3], buses[..., 4], buses[..., 5]
    pg = _sum_at(gens[..., 3], gen_bus, n)
    dp = torch.where(slack, torch.zeros_like(v), pg - pd - gs * v2 - s_out.real)
    qg = torch.where(is_gen, qd - bs * v2 + s_out.imag, torch.zeros_like(v))
    dq = qg - qd + bs * v2 - s_out.imag
    return dp, dq


def forward(weights: Dict[str, torch.Tensor], model: Dict, grids, mm_dtype=None,
            admittance: bool = True):
    """The K-step forward of one block, in the type of `grids`: (buses (S,
    N, 6), lines (S, E, 7), gens (S, G, 7), src, dst, gen_bus) tensors on one
    device; model: {"K", "latent_dim", "gamma", "leaky_relu_slope",
    "v_anchor"}. mm_dtype: the type of the MLP products (default the
    grids' type; bfloat16 for a control). admittance=False: raw line
    features (a fault). Returns {v, theta, total_loss, last_loss}."""
    buses, lines, gens, src, dst, gen_bus = grids
    mm_dtype = mm_dtype or buses.dtype
    s, n = buses.shape[:2]
    k_steps, latent = model["K"], model["latent_dim"]
    gamma, slope, anchor = model["gamma"], model["leaky_relu_slope"], model["v_anchor"]

    at_bus = _sum_at(torch.stack([gens[..., 4], gens[..., 6], gens[..., 5],
                                  torch.ones_like(gens[..., 0])], -1), gen_bus, n)
    v = torch.where(at_bus[..., 0] == 0, torch.ones_like(at_bus[..., 0]), at_bus[..., 0])
    is_gen = at_bus[..., 3] > 0
    slack = buses[..., 1] == SLACK
    v2 = v * v
    dp = torch.where(slack, torch.zeros_like(v), at_bus[..., 1] - buses[..., 2] - buses[..., 4] * v2)
    dq = at_bus[..., 2] - buses[..., 3] + buses[..., 5] * v2
    theta = buses.new_zeros((s, n))
    m = buses.new_zeros((s, n, latent))
    feats = features(lines, admittance)
    load = (~is_gen).to(buses.dtype)
    total = buses.new_zeros((s,))
    for k in range(k_steps):
        edge_in = torch.cat([m[:, dst], feats], dim=-1)
        sums = {h: _sum_at(_mlp(weights, f"{h}.{k}", edge_in, slope, mm_dtype), dst, n)
                for h in PHI}
        base = torch.cat([v[..., None], theta[..., None], dp[..., None], dq[..., None], m], -1)
        up = {h: _mlp(weights, f"{h}.{k}", torch.cat([base, sums[phi]], -1), slope, mm_dtype)
              for h, phi, _ in UPDATES}
        theta = theta + up["L_theta"][..., 0]
        v = torch.where(is_gen, v, v + up["L_v"][..., 0])
        m = m + up["L_m"]
        dp, dq = _physics(v, theta, buses, lines, gens, src, dst, gen_bus, is_gen, slack)
        step = (dp * dp + dq * dq).sum(-1) / n + anchor * (load * (v - 1.0) ** 2).sum(-1) / n
        total = total + gamma ** (k_steps - k) * step
    last = (dp * dp + dq * dq).sum(-1) / n
    return {"v": torch.clamp_min(v, 0.0), "theta": theta, "total_loss": total, "last_loss": last}


def clip_by_global_norm(grads: Dict[str, torch.Tensor], clip: float) -> Dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: g where the global norm is under `clip`,
    else g / norm * clip; the norm summed in float64."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm < clip:
        return grads
    return {k: g / norm.to(g.dtype) * clip for k, g in grads.items()}


def train_steps(weights: Dict[str, torch.Tensor], model: Dict, optim: Dict, batches: List,
                mm_dtype=None, rows: Optional[int] = None, admittance: bool = True,
                clip: bool = True):
    """Adam steps from `weights` (copied), one per block of `batches`, in
    the type of the weights and batches. optim: {"lr", "grad_clip",
    "warmup_steps"}. rows: take only the first `rows` grids of each block
    into the loss (a fault); admittance=False, clip=False: the faults of
    the module's doc. Returns (the mean discounted loss of each step, the
    first step's gradient as the optimizer takes it, clipped, the
    parameters after the last step, each grid's discounted loss in each
    step)."""
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    adam = Adam(params, optim["lr"], 0.0, optim["warmup_steps"])
    losses, first, per_grid = [], None, []
    for grids in batches:
        if rows is not None:
            grids = tuple(a[:rows] for a in grids[:3]) + tuple(grids[3:])
        total = forward(params, model, grids, mm_dtype, admittance)["total_loss"]
        per_grid.append(total.detach().clone())
        loss = total.mean()
        # the last step's phi_m and L_m reach no loss: their gradient is 0
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if clip and optim["grad_clip"] > 0:
            grads = clip_by_global_norm(grads, optim["grad_clip"])
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}, per_grid
