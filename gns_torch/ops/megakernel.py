"""K4: the whole serving forward of a batch of grids in one CUDA launch, and
its plain twin.

Port of gns_tpu/ops/pallas_megakernel.py `megakernel_forward_batch`: state
init, K x (edge MLP, aggregation, node MLP, PV freeze, reference-parity
physics refresh with the quirk-Q2 gathers and the lambda dispatch), the
discounted loss and the v clamp, one grid per block
(gns_torch/csrc/megakernel.cu). Serving only, for multiple_phi +
reference_parity (every shipped K4/L20/H10 checkpoint) and a shared
topology.

  megakernel_forward_batch(model, cfg, batch, topo) -> GNSOutput
      on the model's device, from a host (numpy) GridBatch and its shared
      GridTopology; one K4 launch on the card, the plain twin on the CPU.
  megakernel_forward_plain(model, cfg, batch, topo) -> GNSOutput
      the plain twin on the model's device.

Numerics are the TPU kernel's: the MLPs take bf16 operands with float32
accumulation (weights cast to bf16, biases kept float32, as `_mlp_bf16`
:74-85 does), and the physics is float32. Where the TPU kernel gathered and
summed through 0/1 incidence matmuls split into hi + lo bf16 halves
(`_oh_dot_exact`, exact only to about 2^-16 relative), both the kernel and
the twin index directly and sum exactly in float32, in CSR order.

The twin transcribes `_kernel` (:88-247) in batched torch ops: a bf16
operand is `x.to(torch.bfloat16).float()` feeding a float32 matmul (a bf16
product is exact in float32), and every gather / sum is gather_plain /
segment_sum_plain. It is used on the CPU and by chip_smoke.py, and by
nothing on the card's path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from gns_torch.models.gns import GNS, GNSOutput, batch_tensors, step_params
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.segment import SegmentIndex
from gns_torch.physics.common import build_graph
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch
from gns_torch.utils.schema import GEN

_LAYERS = ("w1", "w2", "w4")
_BIASES = ("b1", "b2", "b4")


class MegakernelInputs(NamedTuple):
    """Everything one launch reads, on one device."""

    buses: torch.Tensor  # (S, N, 6)
    lines: torch.Tensor  # (S, E, 7)
    gens: torch.Tensor  # (S, G, 7)
    bus_mask: torch.Tensor  # (S, N)
    line_mask: torch.Tensor  # (S, E)
    gen_mask: torch.Tensor  # (S, G)
    src: SegmentIndex  # bus ids (E,) into N, with the CSR by src
    dst: SegmentIndex  # bus ids (E,) into N, with the CSR by dst
    gen: SegmentIndex  # generator bus ids (G,) into N, with their CSR
    srcq: torch.Tensor  # (E,) int32: src bus ids used as line rows (Q2), clipped to [0, E)
    dstq: torch.Tensor  # (E,) int32: the same for dst
    wpack: torch.Tensor  # (K, kW) bfloat16: per step phi w1 w2 w4, L w1 w2 w4, (out, in)
    bpack: torch.Tensor  # (K, kB) float32: their biases
    steps: List[Dict[str, Dict[str, torch.Tensor]]]  # views of the packs, per step
    discounts: torch.Tensor  # (K,) float32: gamma^(K - k)
    latent: int
    hidden: int
    slope: float


def _check_config(cfg: GNSConfig, topo) -> None:
    if not (cfg.multiple_phi and cfg.reference_parity):
        raise ValueError("megakernel supports multiple_phi=True + reference_parity=True")
    if topo is None:
        raise ValueError("megakernel requires a shared GridTopology")


def megakernel_inputs(model: GNS, cfg: GNSConfig, batch: GridBatch, topo) -> MegakernelInputs:
    """The launch's inputs on the model's device: the batch, the index sets
    of the shared topology and the stacked fused weights of
    step_params(fused_heads=True, fold_output="off", compute_dtype="float32"),
    weights cast to bf16 and biases float32."""
    _check_config(cfg, topo)
    device = next(model.parameters()).device
    fcfg = cfg.replace(fused_heads=True, fold_output="off", compute_dtype="float32")
    with torch.no_grad():
        steps = step_params(model, fcfg)
    latent, hidden = cfg.latent_dim, cfg.hidden_dim
    sizes = {  # (out, in) of each layer: phi w1 w2 w4, then L w1 w2 w4
        "phi_fused": ((3 * hidden, latent + 5), (3 * hidden, 3 * hidden), (3 * latent, 3 * hidden)),
        "L_fused": ((3 * hidden, 4 + 4 * latent), (3 * hidden, 3 * hidden), (2 + latent, 3 * hidden)),
    }
    wrows, brows = [], []
    for st in steps:
        wrows.append(torch.cat([st[h][w].reshape(-1) for h in sizes for w in _LAYERS]))
        brows.append(torch.cat([st[h][b].reshape(-1) for h in sizes for b in _BIASES]))
    wpack = torch.stack(wrows).to(torch.bfloat16).contiguous()
    bpack = torch.stack(brows).float().contiguous()

    views = []
    for k in range(cfg.K):
        wo = bo = 0
        step = {}
        for h, shapes in sizes.items():
            step[h] = {}
            for w, b, (o, i) in zip(_LAYERS, _BIASES, shapes):
                step[h][w] = wpack[k, wo:wo + o * i].view(o, i)
                step[h][b] = bpack[k, bo:bo + o]
                wo, bo = wo + o * i, bo + o
        views.append(step)

    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, device)
    for name in ("src", "dst", "gen"):
        if not getattr(graph, name).in_range:
            raise ValueError(f"megakernel: {name} ids outside [0, {batch.buses.shape[1]})")
    e = batch.lines.shape[1]
    # Q2 gathers index per-line arrays by bus id, clipped as
    # pallas_megakernel.py:296 does (a no-op while E >= N)
    q2 = [torch.as_tensor(np.clip(np.asarray(ids), 0, e - 1).astype(np.int32), device=device)
          for ids in (topo.src, topo.dst)]
    bt = batch_tensors(batch, device)
    gamma = float(cfg.gamma)
    discounts = torch.tensor([gamma ** (cfg.K - k) for k in range(cfg.K)],
                             dtype=torch.float32, device=device)
    return MegakernelInputs(
        bt.buses, bt.lines, bt.generators, bt.bus_mask, bt.line_mask, bt.gen_mask,
        graph.src, graph.dst, graph.gen, q2[0], q2[1], wpack, bpack, views, discounts,
        latent, hidden, float(cfg.leaky_relu_slope),
    )


def _library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kern.library("megakernel", {
        "gns_megakernel": ([p] * 24 + [ll, i, i, i, i, i, i, f, p], i),
        "gns_megakernel_shared_bytes": ([i, i, i, i, i], ll),
        "gns_megakernel_step_sizes": ([i, i, i], ll),
    })


def megakernel_cuda(inp: MegakernelInputs) -> Tuple[torch.Tensor, ...]:
    """One launch of K4. Returns v, theta, delta_p, delta_q (S, N) and the
    (total, last) loss (S, 2), float32 on the card."""
    dev = inp.buses.device
    kern._check_cuda("buses", inp.buses, (torch.float32,), 3)
    for name in ("lines", "gens"):
        kern._check_cuda(name, getattr(inp, name), (torch.float32,), 3, dev)
    for name in ("bus_mask", "line_mask", "gen_mask"):
        kern._check_cuda(name, getattr(inp, name), (torch.float32,), 2, dev)
    s, n, _ = inp.buses.shape
    e, g = inp.lines.shape[1], inp.gens.shape[1]
    k = inp.wpack.shape[0]
    if inp.lines.shape != (s, e, 7) or inp.gens.shape != (s, g, 7):
        raise ValueError("lines / gens do not match the batch")
    if (inp.bus_mask.shape, inp.line_mask.shape, inp.gen_mask.shape) != ((s, n), (s, e), (s, g)):
        raise ValueError("masks do not match the batch")
    ints = [inp.src.ids, inp.dst.ids, inp.srcq, inp.dstq, inp.dst.order, inp.dst.indptr,
            inp.src.order, inp.src.indptr, inp.gen.order, inp.gen.indptr]
    for t in ints:
        kern._check_cuda("index", t, (torch.int32,), 1, dev)
    if (inp.src.n, inp.dst.n, inp.gen.n, inp.src.edges, inp.gen.edges) != (n, n, n, e, g):
        raise ValueError("index sets do not match the batch")
    lib = _library()
    kern._check_cuda("wpack", inp.wpack, (torch.bfloat16,), 2, dev)
    kern._check_cuda("bpack", inp.bpack, (torch.float32,), 2, dev)
    kern._check_cuda("discounts", inp.discounts, (torch.float32,), 1, dev)
    want = (lib.gns_megakernel_step_sizes(inp.latent, inp.hidden, 0),
            lib.gns_megakernel_step_sizes(inp.latent, inp.hidden, 1))
    if want[0] < 0:
        raise ValueError(f"K4 is not built for latent {inp.latent}, hidden {inp.hidden}")
    if (inp.wpack.shape[1], inp.bpack.shape[1]) != want or inp.bpack.shape[0] != k \
            or inp.discounts.numel() != k:
        raise ValueError(f"weight packs {tuple(inp.wpack.shape)} / {tuple(inp.bpack.shape)} "
                         f"do not match K={k} steps of {want}")
    shared = lib.gns_megakernel_shared_bytes(n, e, g, inp.latent, inp.hidden)
    if shared > kern.MAX_SHARED_BYTES:
        raise ValueError(f"a grid of N={n}, E={e}, G={g} needs {shared} bytes of shared "
                         f"memory, more than the {kern.MAX_SHARED_BYTES} a block can hold")
    outs = [torch.empty((s, n), dtype=torch.float32, device=dev) for _ in range(4)]
    loss = torch.empty((s, 2), dtype=torch.float32, device=dev)
    rc = lib.gns_megakernel(
        inp.buses.data_ptr(), inp.lines.data_ptr(), inp.gens.data_ptr(),
        inp.bus_mask.data_ptr(), inp.line_mask.data_ptr(), inp.gen_mask.data_ptr(),
        *(t.data_ptr() for t in ints), inp.wpack.data_ptr(), inp.bpack.data_ptr(),
        inp.discounts.data_ptr(), *(o.data_ptr() for o in outs), loss.data_ptr(),
        s, n, e, g, k, inp.latent, inp.hidden, inp.slope, kern._stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"K4 megakernel launch failed: cudaError {rc}")
    megakernel_cuda.launches += 1
    return (*outs, loss)


megakernel_cuda.launches = 0


def megakernel_plain(inp: MegakernelInputs) -> Tuple[torch.Tensor, ...]:
    """K4's plain twin, a transcription of pallas_megakernel.py `_kernel` in
    batched torch ops. Same return as megakernel_cuda."""
    slope = inp.slope

    def bf(x):
        return x.to(torch.bfloat16).float()

    def lrelu(h):
        return torch.where(h >= 0, h, slope * h)

    def mlp(x, p):
        h = lrelu(bf(x) @ p["w1"].float().t() + p["b1"])
        h = lrelu(bf(h) @ p["w2"].float().t() + p["b2"])
        return bf(h) @ p["w4"].float().t() + p["b4"]

    def gather(x, ids):  # (S, R) or (S, R, D) rows picked by ids
        if x.dim() == 2:
            return kern.gather_plain(x[..., None], ids)[..., 0]
        return kern.gather_plain(x, ids)

    def segsum(x, index: SegmentIndex):  # (S, E[, D]) -> (S, N[, D]), CSR order
        if x.dim() == 2:
            return kern.segment_sum_plain(x[..., None], index.order, index.indptr, index.n)[..., 0]
        return kern.segment_sum_plain(x, index.order, index.indptr, index.n)

    buses, lines, gens = inp.buses, inp.lines, inp.gens
    bm, lm, gm = inp.bus_mask, inp.line_mask, inp.gen_mask
    s, n = bm.shape
    latent = inp.latent

    # line geometry and the K-invariant Q2 gathers
    r, x = lines[..., 2], lines[..., 3]
    z2 = r * r + x * x
    y = 1.0 / torch.sqrt(z2)
    line_feats = lines[..., 2:7]
    statq = torch.stack([y, lines[..., 5], lines[..., 6], lines[..., 4]], dim=-1)
    y_s, tau_s, sh_s, b_s = gather(statq, inp.srcq).unbind(-1)
    y_d, tau_d, sh_d, b_d = gather(statq, inp.dstq).unbind(-1)

    # state init
    ginit = torch.stack([gens[..., GEN["vg"]] * gm, gens[..., GEN["Pg"]] * gm,
                         gens[..., GEN["qg"]] * gm, gm], dim=-1)
    agg0 = segsum(ginit, inp.gen)
    v = torch.where(agg0[..., 0] == 0, torch.ones_like(agg0[..., 0]), agg0[..., 0])
    is_gen = agg0[..., 3] > 0
    pd, qd, gs, bs = buses[..., 2], buses[..., 3], buses[..., 4], buses[..., 5]
    v2 = v * v
    delta_p = agg0[..., 1] - pd - gs * v2
    delta_q = agg0[..., 2] - qd + bs * v2
    theta = torch.zeros_like(v)
    m = torch.zeros((s, n, latent), dtype=torch.float32, device=v.device)
    n_real = bm.sum(-1)

    pg_set = gens[..., GEN["Pg_set"]] * gm
    pmin = gens[..., GEN["Pmin"]] * gm
    pmax = gens[..., GEN["Pmax"]] * gm
    s_set, s_min, s_max = pg_set.sum(-1), pmin.sum(-1), pmax.sum(-1)

    total_loss = torch.zeros_like(n_real)
    lm_col = lm[..., None]
    for k, step in enumerate(inp.steps):
        edge_in = torch.cat([gather(bf(m), inp.dst.ids), line_feats], dim=-1)
        phi_out = mlp(edge_in, step["phi_fused"])
        agg = segsum(phi_out * lm_col, inp.dst)
        node_in = torch.cat([v[..., None], theta[..., None], delta_p[..., None],
                             delta_q[..., None], m, agg], dim=-1)
        out = mlp(node_in, step["L_fused"])
        theta = theta + out[..., 0]
        v = torch.where(is_gen, v, v + out[..., 1])  # PV freeze (main.py:184)
        m = m + out[..., 2:]

        # reference-parity physics refresh
        v2 = v * v
        vth = torch.stack([v, theta], dim=-1)
        at_src, at_dst = gather(vth, inp.src.ids), gather(vth, inp.dst.ids)
        v_s, v_d = at_src[..., 0], at_dst[..., 0]
        th_sd = at_src[..., 1] - at_dst[..., 1]
        d_s = gather(th_sd, inp.srcq)  # Q2: delta[src]
        dj_d = -gather(th_sd, inp.dstq)  # Q2: (-delta)[dst]
        ang_s = th_sd - d_s - sh_s
        ang_d = -th_sd - dj_d - sh_d
        sin_ds, cos_ds = torch.sin(d_s), torch.cos(d_s)
        sin_djd = torch.sin(dj_d)
        vv_s = v_s * v_d * y_s / tau_s
        vv_d = v_d * v_s * y_d / tau_d
        # second term uses v_s/tau^2, not (v_s/tau)^2 (author quirk)
        msg_joule = torch.abs(
            vv_s * (torch.sin(ang_s) + torch.sin(-th_sd - d_s + sh_s))
            + (v_s / (tau_s * tau_s)) * y_s * sin_ds
            + (v_d * v_d) * y_s * sin_ds
        )
        p_joule = (msg_joule * lm).sum(-1)
        qs = v_s / tau_s
        p_from = vv_s * torch.sin(ang_s) + (qs * qs) * y_s * sin_ds
        p_to = vv_d * torch.sin(ang_d) + (v_d * v_d) * y_d * sin_djd
        q_from = -vv_s * torch.cos(ang_s) + (qs * qs) * (y_s * cos_ds - b_s / 2.0)
        q_to = -vv_d * torch.cos(ang_d) + (v_d * v_d) * (y_d * sin_djd - b_d / 2.0)
        agg_dst = segsum(torch.stack([p_from, q_from], dim=-1) * lm_col, inp.dst)
        agg_src = segsum(torch.stack([p_to, q_to], dim=-1) * lm_col, inp.src)
        p_sum = agg_dst[..., 0] + agg_src[..., 0]
        q_sum = agg_dst[..., 1] + agg_src[..., 1]

        p_global = (pd * bm + v2 * bm * gs).sum(-1) + p_joule
        lam_lo = (p_global - s_min) / (2.0 * (s_set - s_min))
        lam_hi = (p_global - 2.0 * s_set + s_max) / (2.0 * (s_max - s_set))
        lam = torch.where(p_global < s_set, lam_lo, lam_hi)[:, None]
        pg_lo = pmin + 2.0 * (pg_set - pmin) * lam
        pg_hi = 2.0 * pg_set - pmax + 2.0 * (pmax - pg_set) * lam
        pg_new = torch.where(lam < 0.5, pg_lo, pg_hi) * gm

        qg_new = (qd - bs * v2) - q_sum
        pg_bus = segsum(pg_new, inp.gen)
        delta_p = (pg_bus - pd - gs * v2 + p_sum) * bm
        delta_q = ((qg_new - qd + bs * v2) + q_sum) * bm
        total_loss = total_loss + inp.discounts[k] * ((delta_p * delta_p + delta_q * delta_q)
                                                      * bm).sum(-1) / n_real

    last_loss = ((delta_p * delta_p + delta_q * delta_q) * bm).sum(-1) / n_real
    v = torch.clamp_min(v, 0.0)  # clamp (main.py:201)
    return v, theta, delta_p, delta_q, torch.stack([total_loss, last_loss], dim=-1)


def _output(res) -> GNSOutput:
    v, theta, dp, dq, loss = res
    return GNSOutput(v=v, theta=theta, total_loss=loss[:, 0], last_loss=loss[:, 1],
                     delta_p=dp, delta_q=dq)


def megakernel_forward_batch(model: GNS, cfg: GNSConfig, batch: GridBatch, topo) -> GNSOutput:
    """The whole batched forward in one K4 launch, on the model's device.

    Requires multiple_phi=True, reference_parity=True and the batch's shared
    GridTopology (ValueError otherwise). On a CPU model it runs the plain
    twin; on the card it launches K4 and nothing else computes the forward."""
    inp = megakernel_inputs(model, cfg, batch, topo)
    if inp.buses.is_cuda:
        return _output(megakernel_cuda(inp))
    return _output(megakernel_plain(inp))


def megakernel_forward_plain(model: GNS, cfg: GNSConfig, batch: GridBatch, topo) -> GNSOutput:
    """K4's plain twin on the model's device (same contract)."""
    return _output(megakernel_plain(megakernel_inputs(model, cfg, batch, topo)))
