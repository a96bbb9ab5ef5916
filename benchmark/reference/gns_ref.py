"""A plain Graph Neural Solver, the benchmark's reference: float32 as the
configurations state it, float64 as the yardstick of float32's rounding.

Written from the equations of the original PyTorch reference (Donon et
al.'s GNS as LeonOrou/OPF-Graph-Neural-Solver codes it, GNS/main.py) in
its parity numerics, quirks included, with nothing of the program: no
kernel, no fused heads, no cached index, no graph capture. One block of
grids that share a topology is one call; aggregations are index_add_.

  state init   v = the generators' vg summed at their bus (1 where none),
               theta = 0, m = 0, (dp, dq) from the set-points;
  step k       edge_in = [m[dst], r, x, b, tau, shift]; each phi head's
               output summed at dst; L_theta, L_v, L_m each read [v,
               theta, dp, dq, m] and its own phi sum; theta += L_theta,
               v += L_v at buses without a generator, m += L_m; then the
               global active compensation and the local power imbalance
               (per-line arrays read at bus ids: quirk Q2; the to-side
               reactive message uses sin: Q4; the cancelling reactive
               residual kept: Q8); loss += gamma^(K-k) * mean(dp^2 + dq^2);
  finalize     last_loss = mean(dp^2 + dq^2), v = max(v, 0).

The decode puts theta into the slack bus's gauge. The optimizer is Adam
with optax's formulas (eps outside the root, bias corrections by the
count after the update), behind an optional global-norm clip and a linear
warm-up of the step size. Leaves are named as the reference's state_dict
names them (`phi_v.0.linear1.weight`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.nn import functional as F

PHI = ("phi_v", "phi_theta", "phi_m")
# (update head, the phi head whose sum it reads, its output width or None
# for the latent width)
UPDATES = (("L_theta", "phi_theta", 1), ("L_v", "phi_v", 1), ("L_m", "phi_m", None))


def _mlp(w: Dict[str, torch.Tensor], prefix: str, x, slope: float, mm_dtype):
    def lin(h, layer):
        return F.linear(h.to(mm_dtype), w[f"{prefix}.{layer}.weight"].to(mm_dtype),
                        w[f"{prefix}.{layer}.bias"].to(mm_dtype))

    h = F.leaky_relu(lin(x, "linear1"), slope)
    h = F.leaky_relu(lin(h, "linear2"), slope)
    return lin(h, "linear4").to(x.dtype)


def _sum_at(x, idx, n):
    """Per-grid sums of the rows x (S, E, ...) at the segments idx (E,)."""
    out = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    return out.index_add_(1, idx, x)


def _dispatch(p_global, gens):
    """The scalar lambda redispatch (paper eqs. (20)-(21)) -> Pg (S, G)."""
    pg_set, pmin, pmax = gens[..., 3], gens[..., 2], gens[..., 1]
    s_set, s_min, s_max = pg_set.sum(-1), pmin.sum(-1), pmax.sum(-1)
    lam_lo = (p_global - s_min) / (2.0 * (s_set - s_min))
    lam_hi = (p_global - 2.0 * s_set + s_max) / (2.0 * (s_max - s_set))
    lam = torch.where(p_global < s_set, lam_lo, lam_hi)[:, None]
    return torch.where(lam < 0.5, pmin + 2.0 * (pg_set - pmin) * lam,
                       2.0 * pg_set - pmax + 2.0 * (pmax - pg_set) * lam)


def _physics(v, theta, buses, lines, gens, src, dst, gen_bus):
    """Compensation then imbalance at (v, theta): (dp, dq), each (S, N)."""
    n = buses.shape[1]
    r, x = lines[..., 2], lines[..., 3]
    y = 1.0 / torch.sqrt(r * r + x * x)
    b, tau, shift = lines[..., 4], lines[..., 5], lines[..., 6]
    v_s, v_d = v[:, src], v[:, dst]
    th_s, th_d = theta[:, src], theta[:, dst]
    delta = th_s - th_d
    # Q2: the per-line arrays read at the lines' bus ids
    y_s, tau_s, sh_s, b_s, d_s = y[:, src], tau[:, src], shift[:, src], b[:, src], delta[:, src]
    y_d, tau_d, sh_d, b_d = y[:, dst], tau[:, dst], shift[:, dst], b[:, dst]
    dj_d = -delta[:, dst]

    joule = torch.abs(
        v_s * v_d * y_s / tau_s
        * (torch.sin(th_s - th_d - d_s - sh_s) + torch.sin(th_d - th_s - d_s + sh_s))
        + (v_s / tau_s**2) * y_s * torch.sin(d_s)
        + v_d**2 * y_s * torch.sin(d_s)
    )
    v2 = v * v
    pd, qd, gs, bs = buses[..., 2], buses[..., 3], buses[..., 4], buses[..., 5]
    pg = _dispatch(pd.sum(-1) + (v2 * gs).sum(-1) + joule.sum(-1), gens)

    q_from = (-v_s * v_d * y_s / tau_s * torch.cos(th_s - th_d - d_s - sh_s)
              + (v_s / tau_s) ** 2 * (y_s * torch.cos(d_s) - b_s / 2.0))
    q_to = (-v_d * v_s * y_d / tau_d * torch.cos(th_d - th_s - dj_d - sh_d)
            + v_d**2 * (y_d * torch.sin(dj_d) - b_d / 2.0))  # Q4
    q_sum = _sum_at(q_from, dst, n) + _sum_at(q_to, src, n)
    qg = qd - bs * v2 - q_sum

    p_from = (v_s * v_d * y_s / tau_s * torch.sin(th_s - th_d - d_s - sh_s)
              + (v_s / tau_s) ** 2 * y_s * torch.sin(d_s))
    p_to = (v_d * v_s * y_d / tau_d * torch.sin(th_d - th_s - dj_d - sh_d)
            + v_d**2 * y_d * torch.sin(dj_d))
    p_sum = _sum_at(p_from, dst, n) + _sum_at(p_to, src, n)
    dp = _sum_at(pg, gen_bus, n) - pd - gs * v2 + p_sum
    dq = (qg - qd + bs * v2) + q_sum  # Q8: zero but for rounding
    return dp, dq


def forward(weights: Dict[str, torch.Tensor], model: Dict, grids, mm_dtype=None):
    """The K-step forward of one block, in the type of `grids`: (buses (S,
    N, 6), lines (S, E, 7), gens (S, G, 7), src, dst, gen_bus) tensors on one
    device; model: {"K", "latent_dim", "gamma", "leaky_relu_slope"}.
    mm_dtype: the type of the MLP products (default the grids' type;
    bfloat16 for a control). Returns {v, theta, total_loss, last_loss}."""
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
        sums = {h: _sum_at(_mlp(weights, f"{h}.{k}", edge_in, slope, mm_dtype), dst, n)
                for h in PHI}
        base = torch.cat([v[..., None], theta[..., None], dp[..., None], dq[..., None], m], -1)
        up = {h: _mlp(weights, f"{h}.{k}", torch.cat([base, sums[phi]], -1), slope, mm_dtype)
              for h, phi, _ in UPDATES}
        theta = theta + up["L_theta"][..., 0]
        v = torch.where(is_gen, v, v + up["L_v"][..., 0])
        m = m + up["L_m"]
        dp, dq = _physics(v, theta, buses, lines, gens, src, dst, gen_bus)
        total = total + gamma ** (k_steps - k) * (dp * dp + dq * dq).sum(-1) / n
    last = (dp * dp + dq * dq).sum(-1) / n
    return {"v": torch.clamp_min(v, 0.0), "theta": theta, "total_loss": total, "last_loss": last}


def decode_theta(theta, slack):
    """theta (S, N) in the slack bus's gauge: slack = [(bus index, angle in
    radians)] per grid, index -1 for a grid without one (left as it is)."""
    idx = torch.tensor([max(i, 0) for i, _ in slack], device=theta.device)
    ang = torch.tensor([a for _, a in slack], dtype=theta.dtype, device=theta.device)
    has = torch.tensor([i >= 0 for i, _ in slack], device=theta.device)
    shift = theta.gather(1, idx[:, None])[:, 0] - ang
    return theta - torch.where(has, shift, torch.zeros_like(shift))[:, None]


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) behind optax's
    clip_by_global_norm (no epsilon on the norm) when clip > 0, with the
    step size ramped linearly from 0 over `warmup` updates (the ramp reads
    the count before the update)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, clip: float = 0.0,
                 warmup: int = 0):
        self.lr, self.clip, self.warmup = lr, clip, warmup
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Update params in place from grads."""
        if self.clip > 0:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            if norm >= self.clip:
                grads = {k: g / norm.to(g.dtype) * self.clip for k, g in grads.items()}
        step_size = self.lr
        if self.warmup > 0:
            step_size = self.lr * min(self.count, self.warmup) / self.warmup
        self.count += 1
        c1, c2 = 1 - self.B1 ** self.count, 1 - self.B2 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                self.mu[k] = (1 - self.B1) * g + self.B1 * self.mu[k]
                self.nu[k] = (1 - self.B2) * g * g + self.B2 * self.nu[k]
                update = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.EPS)
                params[k] -= step_size * update


def train_steps(weights: Dict[str, torch.Tensor], model: Dict, optim: Dict, batches: List,
                mm_dtype=None, rows: Optional[int] = None):
    """Adam steps from `weights` (copied), one per block of `batches`, in
    the type of the weights and batches.
    optim: {"lr", "grad_clip", "warmup_steps"}. rows: take only the first
    `rows` grids of each block into the loss (a fault's check: half of the
    batch left out). Returns (the mean discounted loss of each step, the
    gradient of the first step, the parameters after the last step, each
    grid's discounted loss in each step)."""
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    adam = Adam(params, optim["lr"], optim["grad_clip"], optim["warmup_steps"])
    losses, first, per_grid = [], None, []
    for grids in batches:
        if rows is not None:
            grids = tuple(a[:rows] for a in grids[:3]) + tuple(grids[3:])
        total = forward(params, model, grids, mm_dtype)["total_loss"]
        per_grid.append(total.detach().clone())
        loss = total.mean()
        # the last step's phi_m and L_m reach no loss: their gradient is 0
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}, per_grid


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              skip=()) -> Dict[str, float]:
    """Each leaf's gap of norms, |‖a‖ - ‖b‖|, over the larger of the
    reference leaf's norm and the median leaf's norm; leaves in `skip` are
    left out."""
    norms = {k: float(torch.linalg.vector_norm(r.double())) for k, r in reference.items()}
    median = sorted(norms.values())[len(norms) // 2]
    gaps = {}
    for k in reference:
        if k in skip:
            continue
        a = float(torch.linalg.vector_norm(program[k].double()))
        gap = abs(a - norms[k]) / max(norms[k], median)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps
