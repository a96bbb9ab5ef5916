"""The GNS model: K learned correction steps over the bus-branch graph.

Port of gns_tpu/models/gns.py (reference GNS/main.py:107-202). The JAX
package vmaps a single-grid forward and scans over stacked per-step
weights; here the batch dimension is written out and a Python loop runs
the K steps. Every aggregation and gather goes through ops/segment.py,
so on the card each one is a K1 or K2 launch; where fused_refresh_applies
(among its conditions: on the card, no gradient wanted), each step's
physics refresh and loss are instead one launch of the fused refresh
(ops/refresh.py).

Per-step semantics (the activation-parity contract, SURVEY.md §2.2):
  state init: m = 0 (S, N, latent); theta = 0; v = scatter-add of the
    generators' vg onto buses, 1.0 where no generator (co-located
    generators sum their vg: quirk Q3, main.py:146); delta_p / delta_q
    from the generator set-points.
  step k:
    edge_in = concat(m[dst], line feats r, x, b, tau, shift) — the message
    uses the destination bus's own latent (main.py:153-155);
    phi MLP(s) -> masked segment-sum at dst; node_in = concat(v, theta,
    delta_p, delta_q, m, phi_sum); theta += L_theta; v += L_v at
    non-generator buses only (PV freeze, main.py:184); m += L_m; physics
    refresh; total_loss += gamma^(K-k) * sum(dp^2 + dq^2) / N.
  finalize: last_loss = the undiscounted final residual; v = max(v, 0).

With multiple_phi=False, quirk Q1 applies: phi outputs (E, 1) and only
latent column 0 of phi_sum is written (main.py:169-170).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from gns_torch.models.blocks import LearningBlock
from gns_torch.ops import refresh
from gns_torch.ops.collectives import all_reduce_sum, copy_to_tp, reduce_from_tp
from gns_torch.ops.refresh import refresh_cuda, refresh_inputs
from gns_torch.ops.segment import (
    GATHER_METHODS,
    broadcast_col0_segment_sum,
    check_method,
    gather,
    segment_sum,
)
from gns_torch.physics.common import Graph, build_graph, edge_geometry
from gns_torch.physics.fused import physics_refresh, q2_geometry
from gns_torch.utils import profiling
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device
from gns_torch.utils.prepare import GridBatch
from gns_torch.utils.schema import BUS, BUS_TYPE_SLACK, GEN


class GNSOutput(NamedTuple):
    v: torch.Tensor  # (S, N)
    theta: torch.Tensor  # (S, N)
    total_loss: torch.Tensor  # (S,)
    last_loss: torch.Tensor  # (S,)
    delta_p: torch.Tensor  # (S, N) final active mismatch
    delta_q: torch.Tensor  # (S, N) final reactive mismatch


# Head orders of the fused layout. L_theta consumes phi_theta's aggregate,
# L_v phi_v's, L_m phi_m's (reference GNS/main.py:165-167).
PHI_HEADS = ("phi_v", "phi_theta", "phi_m")
L_HEADS = ("L_theta", "L_v", "L_m")
_L_TO_PHI_BLOCK = (1, 0, 2)  # phi block index consumed by each L head

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def head_dims(cfg: GNSConfig):
    """(name, dim_in, dim_out) of every head, in the reference's order."""
    if cfg.multiple_phi:
        heads = [(h, cfg.phi_in_dim, cfg.latent_dim) for h in PHI_HEADS]
    else:
        heads = [("phi", cfg.phi_in_dim, 1)]
    return heads + [
        ("L_theta", cfg.update_in_dim, 1),
        ("L_v", cfg.update_in_dim, 1),
        ("L_m", cfg.update_in_dim, cfg.latent_dim),
    ]


class GNS(nn.Module):
    """The K-step model's weights: one ModuleList of K LearningBlocks per
    head, so `state_dict()` keys equal the reference's
    (`phi_v.{k}.linear1.weight`, ...) and a shipped .pth loads with
    `load_state_dict`. Fresh weights use torch.nn.Linear's default init
    drawn from a torch.Generator seeded with `seed`."""

    def __init__(self, cfg: GNSConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        for name, din, dout in head_dims(cfg):
            blocks = nn.ModuleList(
                LearningBlock(din, cfg.hidden_dim, dout, cfg.leaky_relu_slope)
                for _ in range(cfg.K)
            )
            for b in blocks:
                b.reset_parameters(gen)
            setattr(self, name, blocks)
        s = cfg.init_correction_scale
        if s != 1.0:
            if cfg.reference_parity:
                raise ValueError(
                    "init_correction_scale requires reference_parity=False "
                    "(the reference's init has no such knob)"
                )
            # start near identity: small per-step corrections (deep K on
            # stiff networks has a NaN forward at the default init)
            with torch.no_grad():
                for name in L_HEADS:
                    for b in getattr(self, name):
                        b.linear4.weight.mul_(s)
                        b.linear4.bias.mul_(s)
        self.to(dev)

    def forward(self, batch: GridBatch, graph: Graph, dense: bool = False,
                method: str = "auto") -> GNSOutput:
        """Batch of device tensors (batch_tensors) and its Graph."""
        return gns_forward(step_params(self, self.cfg), self.cfg, batch, graph,
                           dense=dense, method=method)


def _block(b: LearningBlock) -> Dict[str, torch.Tensor]:
    return {
        "w1": b.linear1.weight, "b1": b.linear1.bias,
        "w2": b.linear2.weight, "b2": b.linear2.bias,
        "w4": b.linear4.weight, "b4": b.linear4.bias,
    }


def _fuse(heads: Dict[str, Dict[str, torch.Tensor]], cfg: GNSConfig):
    """Fold one step's per-head MLPs into block MLPs (weights in torch's
    (out, in) layout).

    The three phi heads see the same edge input (main.py:155-159): their
    first layers concatenate into one (3H, in) layer, the others become
    block-diagonal. The three L heads share node_base and differ in which
    phi aggregate they append, which block-structures their first layer
    over [node_base | phi_v | phi_theta | phi_m]. Output columns:
    [theta_up, v_up, m_up]. Zero blocks add exact zeros, so this equals
    the unfused path up to float reassociation.

    With cfg.resolved_fold_output (aggregate-then-project), phi's output
    layer moves into L's first layer, since the aggregation is linear:
        agg((H2 W4^T + b4) * mask) W1a^T
          == agg(H2 * mask) (W1a W4)^T + deg * (W1a b4)
    where deg is the masked in-degree, an extra node feature. Returns
    "phi_hidden" (layers 1-2) in place of "phi_fused" then.
    """
    lat = cfg.latent_dim
    # the weights' own hidden width: a tensor-parallel rank holds a slice
    # of each head's hidden units (parallel/tensor_parallel.py)
    hid = heads[L_HEADS[0]]["w1"].shape[0]
    base = 4 + lat  # node_base width: v, theta, delta_p, delta_q, m
    fold = cfg.resolved_fold_output and cfg.multiple_phi
    fused = {}
    if cfg.multiple_phi:
        ps = [heads[h] for h in PHI_HEADS]
        phi = {
            "w1": torch.cat([p["w1"] for p in ps]),
            "b1": torch.cat([p["b1"] for p in ps]),
            "w2": torch.block_diag(*(p["w2"] for p in ps)),
            "b2": torch.cat([p["b2"] for p in ps]),
        }
        phi_w4 = torch.block_diag(*(p["w4"] for p in ps))  # (3L, 3H)
        phi_b4 = torch.cat([p["b4"] for p in ps])  # (3L,)
        if fold:
            fused["phi_hidden"] = phi
        else:
            fused["phi_fused"] = dict(phi, w4=phi_w4, b4=phi_b4)
    else:
        fused["phi"] = heads["phi"]
    ls = [heads[h] for h in L_HEADS]
    if cfg.multiple_phi:
        w1 = ls[0]["w1"].new_zeros((3 * hid, base + 3 * lat))
        for i, (p, blk) in enumerate(zip(ls, _L_TO_PHI_BLOCK)):
            rows = slice(i * hid, (i + 1) * hid)
            w1[rows, :base] = p["w1"][:, :base]
            w1[rows, base + blk * lat: base + (blk + 1) * lat] = p["w1"][:, base:]
        if fold:
            # the folded weights are products of float32 weights; take
            # them in float64 so no matmul precision mode can degrade them
            w1a = w1[:, base:].double()  # (3H, 3L) aggregate-input block
            w1 = torch.cat(
                [
                    w1[:, :base],
                    (w1a @ phi_w4.double()).to(w1.dtype),
                    (w1a @ phi_b4.double()).to(w1.dtype)[:, None],  # deg column
                ],
                dim=1,
            )
    else:
        w1 = torch.cat([p["w1"] for p in ls])  # single phi: one shared input
    fused["L_fused"] = {
        "w1": w1,
        "b1": torch.cat([p["b1"] for p in ls]),
        "w2": torch.block_diag(*(p["w2"] for p in ls)),
        "b2": torch.cat([p["b2"] for p in ls]),
        "w4": torch.block_diag(*(p["w4"] for p in ls)),
        "b4": torch.cat([p["b4"] for p in ls]),
    }
    return fused


def step_params(model: GNS, cfg: GNSConfig, ks=None) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Per-step weights as the forward consumes them: fused when
    cfg.fused_heads, cast to cfg.compute_dtype. Depends only on the
    weights, so a server computes it once (serve.py). ks: the steps to
    take (default all K; a pipeline stage takes its own run)."""
    cdt = _DTYPES[cfg.compute_dtype]
    steps = []
    for k in (range(cfg.K) if ks is None else ks):
        heads = {name: _block(getattr(model, name)[k]) for name, _, _ in head_dims(cfg)}
        if cfg.fused_heads:
            heads = _fuse(heads, cfg)
        steps.append({h: {n: t.to(cdt) for n, t in p.items()} for h, p in heads.items()})
    return steps


def _mlp(p, x, slope: float, hidden_only: bool = False, tp_group=None):
    """The LearningBlock MLP on per-head (or fused) weights p. Under a
    tensor-parallel group, w1 / b1 hold this rank's hidden units and w2 the
    matching input columns: the input is marked replicated (its gradient
    all-reduced in the backward) and the second layer's partial product is
    all-reduced before its bias (parallel/tensor_parallel.py)."""
    if tp_group is None:
        h = F.leaky_relu(F.linear(x, p["w1"], p["b1"]), slope)
        h = F.leaky_relu(F.linear(h, p["w2"], p["b2"]), slope)
    else:
        h = F.leaky_relu(F.linear(copy_to_tp(x, tp_group), p["w1"], p["b1"]), slope)
        h = F.leaky_relu(reduce_from_tp(F.linear(h, p["w2"]), tp_group) + p["b2"], slope)
    return h if hidden_only else F.linear(h, p["w4"], p["b4"])


def batch_tensors(batch: GridBatch, device) -> GridBatch:
    """Move a numpy GridBatch to `device` as tensors."""
    return GridBatch(*(torch.as_tensor(a, device=device) for a in batch))


def fused_refresh_applies(cfg: GNSConfig, buses: torch.Tensor, graph: Graph,
                          edge_group=None) -> bool:
    """Whether a forward's correction steps take the fused refresh kernel
    (ops/refresh.py, one launch a step) over the eager physics_refresh and
    loss, from what the forward can observe: its batch on a CUDA device in
    float32 (the state's dtype), no gradient wanted (the kernel has no
    backward), reference-parity physics (cfg.reference_parity, the
    kernel's one mode), lines not partitioned (edge_group None), one
    topology for the batch (the Graph's ids shared, SegmentIndex.batch
    None, or per-sample ids of one grid, as the eval harness builds) and a
    grid that fits the kernel's block. Everything else (the CPU,
    training, paper mode, edge partitions, mixed-size requests) takes the
    eager refresh."""
    n, e, g = buses.shape[1], graph.src.edges, graph.gen.edges
    return (buses.is_cuda and buses.dtype == torch.float32 and not torch.is_grad_enabled()
            and cfg.reference_parity and edge_group is None and graph.src.batch in (None, 1)
            and refresh.fits(n, e, g))


def gns_machinery(
    cfg: GNSConfig,
    batch: GridBatch,
    graph: Graph,
    dense: bool = False,
    method: str = "auto",
    edge_group=None,
    tp_group=None,
):
    """Factor the K-step loop into (init_carry, step, finalize, discounts)
    for one batch, as gns_tpu/models/gns.py gns_machinery does.

    `gns_forward` runs them in one loop; the pipeline executor
    (parallel/pipeline.py) runs contiguous runs of steps in different
    processes, passing the carry between stages. The carry is (v, theta,
    m, delta_p, delta_q, total_loss); `step(p, disc, *carry)` advances one
    correction step with that step's weights p (an entry of step_params)
    and discount disc (discounts[k], gamma^(K-k)); `finalize(carry)`
    applies the v >= 0 clamp and computes last_loss (main.py:199-202).

    edge_group: the process group over which the batch's LINES are
    partitioned (parallel/edge_partition.py), or None. Bus and generator
    state is replicated over it; each rank holds its own slice of lines
    and the Graph of that slice (bus ids global). Every edge -> bus
    aggregation is then a local partial sum followed by an all-reduce over
    the group (ops/collectives.py all_reduce_sum), at gns_tpu's psum sites.
    In reference-parity mode quirk Q2 reads per-line arrays at bus ids,
    which a line slice does not hold, so those arrays are all-gathered
    over the group before they are read (the counterpart of XLA's
    partitioned gathers; the Graph's src_rows / dst_rows must then index
    the whole line set). parallel/edge_partition.py rejects parity mode,
    as gns_tpu's does; parallel/sharding.py runs it.

    tp_group: the tensor-parallel group (parallel/tensor_parallel.py): the
    step weights hold this rank's hidden units; each MLP's second layer is
    a partial sum all-reduced over the group (Megatron's "g") and its
    input is marked replicated (Megatron's "f").
    """
    if cfg.reference_parity and (
        cfg.qg_gen_only or cfg.dispatch != "lambda" or cfg.slack_anchor
        or cfg.v_anchor or cfg.true_shunts or cfg.admittance_inputs
    ):
        raise ValueError(
            "qg_gen_only / dispatch='setpoint_slack' / slack_anchor / "
            "v_anchor / true_shunts / admittance_inputs are paper-mode "
            "options: set reference_parity=False (utils/config.py)"
        )
    cdt = _DTYPES[cfg.compute_dtype]
    slope = cfg.leaky_relu_slope
    # gns_tpu's method names (ops/segment.py check_method); "degree" names a
    # lowering of the physics refresh (physics/fused.py), and every sum and
    # gather of the forward runs on K1 / K2 on the card, the plain twins on
    # the CPU
    check_method(method, batch.buses.device)
    check_method(cfg.gather_method, names=GATHER_METHODS)

    def psum(x):
        return all_reduce_sum(x, edge_group)

    def mlp(p, x, keep_dtype=False, hidden_only=False):
        out = _mlp(p, x.to(cdt), slope, hidden_only, tp_group)
        return out if keep_dtype else out.float()

    buses, lines, gens = batch.buses, batch.lines, batch.generators
    s, n = buses.shape[0], buses.shape[1]
    latent = cfg.latent_dim
    f32 = buses.dtype
    if dense:
        bm = lm = gm = None
        # a fill on the device, not a copy from the host: the training step
        # runs this forward inside a CUDA graph capture, where such a copy
        # is illegal
        n_real = buses.new_full((), float(n))
    else:
        bm, lm, gm = batch.bus_mask, batch.line_mask, batch.gen_mask
        n_real = batch.n_bus.to(f32)

    # --- state init (main.py:141-153): one (S, G, 4) aggregation for
    # vg / Pg / qg / generator count. Q3: co-located generators sum vg.
    gm1 = gm if gm is not None else gens.new_ones(gens.shape[:2])
    agg0 = segment_sum(
        torch.stack(
            [gens[..., GEN["vg"]] * gm1, gens[..., GEN["Pg"]] * gm1,
             gens[..., GEN["qg"]] * gm1, gm1],
            dim=-1,
        ),
        graph.gen,
    )
    v, pg_bus, qg_bus = agg0[..., 0], agg0[..., 1], agg0[..., 2]
    v = torch.where(v == 0, torch.ones_like(v), v)
    v2 = v * v
    delta_p = pg_bus - buses[..., 2] - buses[..., 4] * v2
    delta_q = qg_bus - buses[..., 3] + buses[..., 5] * v2
    m = buses.new_zeros((s, n, latent))
    theta = buses.new_zeros((s, n))

    line_feats = lines[..., 2:7]
    if cfg.admittance_inputs:
        # an out-of-service line (r = x = 1e6) becomes a well-scaled 0
        r_l, x_l = lines[..., 2], lines[..., 3]
        denom = r_l * r_l + x_l * x_l
        line_feats = torch.stack(
            [r_l / denom, -x_l / denom, lines[..., 4], lines[..., 5], lines[..., 6]],
            dim=-1,
        )
    is_gen = agg0[..., 3] > 0  # PV freeze: buses hosting a real generator

    gen_bus_mask = is_gen.to(f32) if cfg.qg_gen_only else None
    slack_mask = None
    if cfg.dispatch == "setpoint_slack":
        slack_mask = (buses[..., BUS["type"]] == BUS_TYPE_SLACK).to(f32)
        delta_p = delta_p * (1.0 - slack_mask)
    anchor_mask = None
    if cfg.slack_anchor:
        anchor_mask = (buses[..., BUS["type"]] == BUS_TYPE_SLACK).to(f32)
        if bm is not None:
            anchor_mask = anchor_mask * bm
    v_anchor_mask = None
    if cfg.v_anchor:
        v_anchor_mask = 1.0 - is_gen.to(f32)
        if bm is not None:
            v_anchor_mask = v_anchor_mask * bm
    lm_col = lm[..., None] if lm is not None else None

    def line_masked(x):
        return x if lm_col is None else x * lm_col.to(x.dtype)

    # per-step discounts gamma^(K-k), k = 0..K-1 (main.py:198)
    discounts = torch.pow(
        cfg.gamma, cfg.K - torch.arange(cfg.K, dtype=f32, device=buses.device)
    )

    deg_col = None
    if cfg.resolved_fold_output and cfg.multiple_phi and cfg.fused_heads:
        deg_lm = lm if lm is not None else lines.new_ones(lines.shape[:2])
        deg_col = psum(segment_sum(deg_lm, graph.dst))[..., None]

    # the fused refresh's inputs, or the eager refresh's step-invariant edge
    # geometry and quirk-Q2 gathers: chosen once a forward
    fused = geom = q2 = None
    if fused_refresh_applies(cfg, buses, graph, edge_group):
        fused = refresh_inputs(buses, lines, gens, graph, bm, lm, gm, n_real)
    else:
        geom = edge_geometry(lines)
        q2 = q2_geometry(geom, graph, edge_group) if cfg.reference_parity else None

    def residual_sums(dp, dq):
        sq = dp * dp + dq * dq
        if bm is not None:
            sq = sq * bm
        return sq.sum(-1) / n_real

    def single_phi_sum(p, edge_in):
        profiling.count("model.single_phi_sums")
        phi_out = mlp(p, edge_in)
        if cfg.reference_parity:
            return psum(broadcast_col0_segment_sum(
                line_masked(phi_out), graph.dst, latent
            ))
        # paper-correct: the scalar message broadcast across latent
        agg = psum(segment_sum(line_masked(phi_out)[..., 0], graph.dst))
        return agg[..., None].expand(s, n, latent)

    def step(p, disc, v, theta, m, delta_p, delta_q, total_loss):
        edge_in = torch.cat([gather(m, graph.dst), line_feats], dim=-1)
        node_base = torch.cat(
            [v[..., None], theta[..., None], delta_p[..., None], delta_q[..., None], m],
            dim=-1,
        )
        if "L_fused" in p:
            if "phi_hidden" in p:
                # aggregate-then-project: aggregate the (E, 3H) hidden
                # activation; deg_col carries phi's output bias
                h2 = mlp(p["phi_hidden"], edge_in, keep_dtype=True, hidden_only=True)
                agg = psum(segment_sum(line_masked(h2), graph.dst))
                node_in = torch.cat([node_base, agg, deg_col], dim=-1)
            elif cfg.multiple_phi:
                phi_out = mlp(p["phi_fused"], edge_in, keep_dtype=True)
                agg = psum(segment_sum(line_masked(phi_out), graph.dst))
                node_in = torch.cat([node_base, agg], dim=-1)
            else:
                node_in = torch.cat([node_base, single_phi_sum(p["phi"], edge_in)], dim=-1)
            out = mlp(p["L_fused"], node_in)
            theta_up, v_up, m_up = out[..., 0], out[..., 1], out[..., 2:]
        else:
            if cfg.multiple_phi:
                def agg_phi(name):
                    phi_out = mlp(p[name], edge_in, keep_dtype=True)
                    return psum(segment_sum(line_masked(phi_out), graph.dst))

                in_v = torch.cat([node_base, agg_phi("phi_v")], dim=-1)
                in_theta = torch.cat([node_base, agg_phi("phi_theta")], dim=-1)
                in_m = torch.cat([node_base, agg_phi("phi_m")], dim=-1)
            else:
                in_v = in_theta = in_m = torch.cat(
                    [node_base, single_phi_sum(p["phi"], edge_in).float()], dim=-1
                )
            theta_up = mlp(p["L_theta"], in_theta)[..., 0]
            v_up = mlp(p["L_v"], in_v)[..., 0]
            m_up = mlp(p["L_m"], in_m)

        theta = theta + theta_up
        v = torch.where(is_gen, v, v + v_up)  # PV freeze (main.py:184-186)
        m = m + m_up

        if fused is not None:  # the refresh and the loss in one launch
            profiling.count("model.fused_refreshes")
            delta_p, delta_q, total_loss = refresh_cuda(fused, v, theta, disc, total_loss)
            return v, theta, m, delta_p, delta_q, total_loss
        profiling.count("model.eager_refreshes")
        _, _, delta_p, delta_q = physics_refresh(
            v, theta, buses, lines, gens, graph,
            reference_parity=cfg.reference_parity,
            bus_mask=bm, line_mask=lm, gen_mask=gm, method=method,
            qg_gen_only=cfg.qg_gen_only, dispatch=cfg.dispatch,
            gen_bus_mask=gen_bus_mask, slack_mask=slack_mask,
            geom=geom, q2=q2, edge_group=edge_group,
        )
        step_loss = residual_sums(delta_p, delta_q)
        if anchor_mask is not None:
            step_loss = step_loss + cfg.slack_anchor * (anchor_mask * theta * theta).sum(-1) / n_real
        if v_anchor_mask is not None:
            dv = v - 1.0
            step_loss = step_loss + cfg.v_anchor * (v_anchor_mask * dv * dv).sum(-1) / n_real
        return v, theta, m, delta_p, delta_q, total_loss + disc * step_loss

    init = (v, theta, m, delta_p, delta_q, buses.new_zeros((s,)))

    def finalize(carry) -> GNSOutput:
        v, theta, m, delta_p, delta_q, total_loss = carry
        last_loss = residual_sums(delta_p, delta_q)
        v = torch.clamp_min(v, 0.0)  # clamp (main.py:201)
        return GNSOutput(v, theta, total_loss, last_loss, delta_p, delta_q)

    return init, step, finalize, discounts


def run_steps(step, carry, steps, discounts, remat: bool):
    """Advance `carry` through step(p, disc, *carry) for each (p, disc) of
    zip(steps, discounts). remat: each step keeps only its inputs for the
    backward and recomputes its activations there, as gns_tpu wraps its
    scan body in jax.checkpoint (no randomness, so no generator state to
    keep). Each step is a program span "model.step": its host time, the
    step's work queued (run, on the CPU); none inside a train.capture."""
    for p, disc in zip(steps, discounts):
        with profiling.span("model.step", outside="train.capture"):
            if remat:
                carry = checkpoint(step, p, disc, *carry, use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                carry = step(p, disc, *carry)
    return carry


def gns_forward(
    steps,
    cfg: GNSConfig,
    batch: GridBatch,
    graph: Graph,
    dense: bool = False,
    method: str = "auto",
    edge_group=None,
    tp_group=None,
) -> GNSOutput:
    """Run K correction steps on a batch of device tensors.

    steps: step_params(model, cfg). graph: build_graph of the same batch.
    dense: the batch is unpadded (GridBatch.is_dense on host data); the
    masks are then ignored, which is exact since x * 1 == x.
    edge_group / tp_group: see gns_machinery (the
    parallel layer's partitions); None for the single-process forward.
    """
    if len(steps) != cfg.K:
        raise ValueError(f"{len(steps)} step weights for K={cfg.K}")
    init, step, finalize, discounts = gns_machinery(
        cfg, batch, graph, dense=dense, method=method, edge_group=edge_group,
        tp_group=tp_group,
    )
    remat = cfg.resolved_remat and torch.is_grad_enabled()
    return finalize(run_steps(step, init, steps, discounts, remat))


def gns_forward_batch(
    model: GNS,
    cfg: GNSConfig,
    batch: GridBatch,
    method: str = "auto",
    topo=None,
    dense: bool = False,
) -> GNSOutput:
    """Forward over a host (numpy) GridBatch on the model's device.

    topo: the batch's shared GridTopology (utils/prepare.py
    extract_shared_topology), or None for per-sample indices.
    """
    device = next(model.parameters()).device
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, device)
    return gns_forward(step_params(model, cfg), cfg, batch_tensors(batch, device),
                       graph, dense=dense, method=method)
