"""K4: the whole serving forward of a batch of grids in one CUDA launch, and
its plain twin.

Port of gns_tpu/ops/pallas_megakernel.py `megakernel_forward_batch`: state
init, K x (edge MLP, aggregation, node MLP, PV freeze, reference-parity
physics refresh with the quirk-Q2 gathers and the lambda dispatch), the
discounted loss and the v clamp, one grid per block
(gns_torch/csrc/megakernel.cu). Serving only, for multiple_phi +
reference_parity (every shipped K4/L20/H10 checkpoint, and the K8/L40/H10
`300-deep`) and a shared topology. The kernel takes every (latent, hidden)
of at least (1, 1) (ops/segment_kernels.py check_width refuses a width
below 1, or one whose 32-bit offsets would overflow), each width a library
of its own built at the first call that needs it; the plain twin takes
any width. One grid is one block, under the first of four plans the
library finds a grid fits (megakernel_occupancy, gns_megakernel_plan:
megakernel.cu's Layout, the one source of the bytes): 0, the step's
weight tiles, the three heads' scratch and the state rows in shared memory
(at (40, 10) a case300 grid takes 193,664 of a block's 232,448 bytes); 1,
the tiles read from L2 and one head's scratch at a time; 2, as 1 with the
grid's state rows in a global workspace that the wrapper allocates; 3, in
the kernel's pass instance only (H > 128 or L > 146, where the wide
instance's registers or warps' scratch would outgrow their bounds; its
layers run their n-tiles in passes), as 2 with the warps' scratch and the
biases in the workspace too. Every grid of case9 to case300 fits at every
width; one that fits no plan raises with its bytes.

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
nothing on the card's path. The kernel runs the MLPs per head on the
tensor cores, so its dot products add in another order than the twin's.

What the kernel reads beside the batch is laid out here, in Python, so the
CPU tests reach it:
  pack_step_weights   each step's fused weights as per-head, zero-padded
                      16 x 8 bf16 B-operand tiles in mma lane order (the
                      layout megakernel.cu's Dims describes: hidden units
                      padded to whole 16-wide k-tiles, m and each
                      aggregate block to column pairs), and the biases
                      padded the same way; packed once per model (the CPU
                      twin's path packs too, so it takes the same widths);
  schedule_items      (ops/segment.py, at ROWS = 16) the work items of its
                      edge and node stages (runs of at most 16 buses whose
                      lines fill at most 16 dst-CSR rows, or one bus with
                      more) and each row's bus with a last-row flag.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from gns_torch.models.gns import GNS, GNSOutput, batch_tensors, step_params
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.segment import SegmentIndex, schedule_items
from gns_torch.physics.common import build_graph
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch
from gns_torch.utils.schema import GEN


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
    items: torch.Tensor  # (T, 4) int32: work items (first bus, end bus, first row, end row)
    row_bus: torch.Tensor  # (E,) int32: per dst-CSR row, bus << 1 | last row of its bus
    dst_pos: torch.Tensor  # (E,) int32: each line's row in the dst CSR
    src_pos: torch.Tensor  # (E,) int32: each line's row in the src CSR
    gen_pos: torch.Tensor  # (G,) int32: each generator's row in the generator CSR
    wpack: torch.Tensor  # (K, tiles x 128) bfloat16: pack_step_weights' tiles
    bpack: torch.Tensor  # (K, biases) float32: the padded biases
    steps: List[Dict[str, Dict[str, torch.Tensor]]]  # fused bf16 weights, f32 biases, per step
    discounts: torch.Tensor  # (K,) float32: gamma^(K - k)
    latent: int
    hidden: int
    slope: float


def _check_config(cfg: GNSConfig, topo) -> None:
    if not (cfg.multiple_phi and cfg.reference_parity):
        raise ValueError("megakernel supports multiple_phi=True + reference_parity=True")
    if topo is None:
        raise ValueError("megakernel requires a shared GridTopology")


ROWS = 16  # rows of an mma tile: dst-CSR rows and buses per work item
_PHI_L_BLOCK = (1, 0, 2)  # phi aggregate block read by L_theta, L_v, L_m


def _fused_shapes(latent: int, hidden: int):
    """(head, layer, (out, in)) of the fused layout, in pack order."""
    return [("phi_fused", "w1", (3 * hidden, latent + 5)), ("phi_fused", "w2", (3 * hidden, 3 * hidden)),
            ("phi_fused", "w4", (3 * latent, 3 * hidden)), ("L_fused", "w1", (3 * hidden, 4 + 4 * latent)),
            ("L_fused", "w2", (3 * hidden, 3 * hidden)), ("L_fused", "w4", (2 + latent, 3 * hidden))]


def _sel(first: int, valid: int, offset: int, width: int) -> List[int]:
    """first + offset + j for j < width while offset + j < valid, else -1."""
    return [first + offset + j if offset + j < valid else -1 for j in range(width)]


class TileDims(NamedTuple):
    """megakernel.cu's Dims<L, H>: the padded widths, tile counts and the
    first tile and bias of each layer in one step's pack."""

    le: int  # m and each aggregate block, padded to column pairs
    hp: int  # a head's hidden width, padded to 16-wide k-tiles
    kh: int  # k-tiles of a hidden layer as an input
    nh: int  # n-tiles of a hidden layer
    lp: int  # a phi head's output, padded to 8
    nl: int
    kp: int  # k-tiles of phi's first layer (le + 5 inputs)
    nbw: int  # a bus's state row: v, theta, dp, dq, m (le)
    kl: int  # k-tiles of an L head's first layer (nbw + le inputs)
    tiles: Tuple[int, ...]  # first tile of phi w1, w2, w4, L w1, w2, w4; the count
    biases: Tuple[int, ...]  # first bias of the same; the count


def tile_dims(latent: int, hidden: int) -> TileDims:
    if latent < 1 or hidden < 1:
        raise ValueError(f"K4 takes latent and hidden of at least 1, got ({latent}, {hidden})")
    le, hp, lp = latent + latent % 2, -(-hidden // 16) * 16, -(-latent // 8) * 8
    kh, nh, nl = hp // 16, hp // 8, lp // 8
    nbw = 4 + le
    kp, kl = -(-(le + 5) // 16), -(-(nbw + le) // 16)
    counts = [3 * nh * kp, 3 * nh * kh, 3 * nl * kh, 3 * nh * kl, 3 * nh * kh, (2 + nl) * kh]
    bias = [3 * hp, 3 * hp, 3 * lp, 3 * hp, 3 * hp, 16 + lp]
    return TileDims(le, hp, kh, nh, lp, nl, kp, nbw, kl, tuple(np.cumsum([0] + counts).tolist()),
                    tuple(np.cumsum([0] + bias).tolist()))


def _tile_plan(latent: int, hidden: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where each slot of one step's pack comes from: (tiles x 128,) indices
    into the flat fused weights (the layers of _fused_shapes, each (out, in)
    row-major, concatenated) and (biases,) indices into the flat fused
    biases; -1 is padding (zero).

    A tile is the B operand (16 k x 8 n) of one mma.sync m16n8k16: lane l
    holds (n, k) = (l // 4, 2 (l % 4) + {0, 1, 8, 9}), B[k, n] = W[n, k]. The
    tiles and biases are in the order megakernel.cu's Dims gives them
    (tile_dims): phi w1 (n-tile major, k-tile minor; each head's hidden
    padded to whole 16-wide k-tiles; its input m padded to column pairs,
    then the five line features), phi w2 and w4 per head (n-tile major,
    k-tile minor over the hidden units), L w1 per head (its own inputs: v,
    theta, dp, dq, m and its phi aggregate block, each of m and the block
    padded to column pairs, the whole to 16k), L w2 per head, L w4
    (L_theta, L_v one n-tile each, then L_m)."""
    d = tile_dims(latent, hidden)
    lat, hid = latent, hidden
    shapes = [sh for _, _, sh in _fused_shapes(lat, hid)]
    offs = np.cumsum([0] + [o * i for o, i in shapes])
    lane = np.arange(32)
    nn = np.repeat((lane // 4)[:, None], 4, axis=1)
    kk = np.stack([2 * (lane % 4) + dk for dk in (0, 1, 8, 9)], axis=1)
    tiles = []

    def tile(layer, rows, cols):
        r, c = np.asarray(rows)[nn], np.asarray(cols)[kk]
        tiles.append(np.where((r >= 0) & (c >= 0), offs[layer] + r * shapes[layer][1] + c, -1))

    def phi_in(c):  # the kernel's phi input column c -> the fused input column
        return c if c < lat else lat + c - d.le if d.le <= c < d.le + 5 else -1

    def l_in(c, blk):  # the kernel's L-head input column c -> the fused input column
        if c < 4 + lat:
            return c
        if d.nbw <= c < d.nbw + lat:
            return 4 + lat + blk * lat + c - d.nbw
        return -1

    for nt in range(3 * d.nh):  # phi w1: every head reads the whole edge input
        head, part = divmod(nt, d.nh)
        for kt in range(d.kp):
            tile(0, _sel(head * hid, hid, part * 8, 8), [phi_in(kt * 16 + j) for j in range(16)])
    for layer in (1, 2):  # phi w2, w4 per head
        for h in range(3):
            width, first = (hid, h * hid) if layer == 1 else (lat, h * lat)
            for nt in range(d.nh if layer == 1 else d.nl):
                for kt in range(d.kh):
                    tile(layer, _sel(first, width, nt * 8, 8), _sel(h * hid, hid, kt * 16, 16))
    for h, blk in enumerate(_PHI_L_BLOCK):  # L w1: the head's own inputs only
        for nt in range(d.nh):
            for kt in range(d.kl):
                tile(3, _sel(h * hid, hid, nt * 8, 8), [l_in(kt * 16 + j, blk) for j in range(16)])
    for h in range(3):  # L w2
        for nt in range(d.nh):
            for kt in range(d.kh):
                tile(4, _sel(h * hid, hid, nt * 8, 8), _sel(h * hid, hid, kt * 16, 16))
    for row, first in ((0, 0), (1, hid)):  # L w4: L_theta, L_v, then L_m
        for kt in range(d.kh):
            tile(5, [row] + [-1] * 7, _sel(first, hid, kt * 16, 16))
    for nt in range(d.nl):
        for kt in range(d.kh):
            tile(5, _sel(2, lat, nt * 8, 8), _sel(2 * hid, hid, kt * 16, 16))

    nb = [3 * hid, 3 * hid, 3 * lat, 3 * hid, 3 * hid, 2 + lat]
    bo = np.cumsum([0] + nb)
    bias = []
    for layer in (0, 1):
        bias += [i for h in range(3) for i in _sel(bo[layer] + h * hid, hid, 0, d.hp)]
    bias += [i for h in range(3) for i in _sel(bo[2] + h * lat, lat, 0, d.lp)]
    for layer in (3, 4):
        bias += [i for h in range(3) for i in _sel(bo[layer] + h * hid, hid, 0, d.hp)]
    bias += [bo[5]] + [-1] * 7 + [bo[5] + 1] + [-1] * 7 + _sel(bo[5] + 2, lat, 0, d.lp)
    return np.concatenate(tiles).reshape(-1), np.asarray(bias, np.int64)


def pack_step_weights(steps, latent: int, hidden: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each step's fused weights (step_params' fused float32 layout) as the
    kernel's tiles: (K, tiles x 128) bf16 and (K, biases) float32 padded
    biases, on the weights' device."""
    widx, bidx = _tile_plan(latent, hidden)
    shapes = _fused_shapes(latent, hidden)
    wrows, brows = [], []
    for st in steps:
        flat_w = torch.cat([st[h][w].reshape(-1) for h, w, _ in shapes]).to(torch.bfloat16)
        flat_b = torch.cat([st[h]["b" + w[1:]].reshape(-1) for h, w, _ in shapes]).float()
        for flat, idx, rows in ((flat_w, widx, wrows), (flat_b, bidx, brows)):
            pick = torch.as_tensor(np.clip(idx, 0, None), device=flat.device)
            keep = torch.as_tensor(idx >= 0, device=flat.device)
            rows.append(torch.where(keep, flat[pick], torch.zeros((), dtype=flat.dtype,
                                                                  device=flat.device)))
    return torch.stack(wrows).contiguous(), torch.stack(brows).contiguous()


# model -> (signature, (wpack, bpack, steps)): the packs are built once per
# model and kept on its device while its weights stay the same
_PACKS: "weakref.WeakKeyDictionary[GNS, tuple]" = weakref.WeakKeyDictionary()


def _packed(model: GNS, cfg: GNSConfig):
    sig = (cfg.K, cfg.latent_dim, cfg.hidden_dim,
           tuple((p.data_ptr(), p._version, str(p.device)) for p in model.parameters()))
    hit = _PACKS.get(model)
    if hit is not None and hit[0] == sig:
        return hit[1]
    fcfg = cfg.replace(fused_heads=True, fold_output="off", compute_dtype="float32")
    with torch.no_grad():
        fused = step_params(model, fcfg)
        wpack, bpack = pack_step_weights(fused, cfg.latent_dim, cfg.hidden_dim)
    steps = [{h: {n: t.to(torch.bfloat16) if n.startswith("w") else t.float()
                  for n, t in layers.items()} for h, layers in st.items()} for st in fused]
    _PACKS[model] = (sig, (wpack, bpack, steps))
    return wpack, bpack, steps


def megakernel_inputs(model: GNS, cfg: GNSConfig, batch: GridBatch, topo) -> MegakernelInputs:
    """The launch's inputs on the model's device: the batch, the index sets
    of the shared topology with the work items and CSR row maps, and the weights of
    step_params(fused_heads=True, fold_output="off", compute_dtype="float32")
    tile-packed for the kernel (once per model) and, for the twin, as fused
    bf16 weights and float32 biases."""
    _check_config(cfg, topo)
    device = next(model.parameters()).device
    wpack, bpack, steps = _packed(model, cfg)

    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, device)
    for name in ("src", "dst", "gen"):
        if not getattr(graph, name).in_range:
            raise ValueError(f"megakernel: {name} ids outside [0, {batch.buses.shape[1]})")
    e = batch.lines.shape[1]
    # Q2 gathers index per-line arrays by bus id, clipped as
    # pallas_megakernel.py:296 does (a no-op while E >= N)
    q2 = [torch.as_tensor(np.clip(np.asarray(ids), 0, e - 1).astype(np.int32), device=device)
          for ids in (topo.src, topo.dst)]
    items, row_bus = schedule_items(graph.dst.indptr.cpu().numpy(), ROWS)
    pos = []
    for index in (graph.dst, graph.src, graph.gen):  # the inverse of each CSR's order
        order = index.order.cpu().numpy()
        inv = np.empty(order.size, np.int32)
        inv[order] = np.arange(order.size, dtype=np.int32)
        pos.append(torch.as_tensor(inv, device=device))
    bt = batch_tensors(batch, device)
    gamma = float(cfg.gamma)
    discounts = torch.tensor([gamma ** (cfg.K - k) for k in range(cfg.K)],
                             dtype=torch.float32, device=device)
    return MegakernelInputs(
        bt.buses, bt.lines, bt.generators, bt.bus_mask, bt.line_mask, bt.gen_mask,
        graph.src, graph.dst, graph.gen, q2[0], q2[1],
        torch.as_tensor(items, device=device).contiguous(),
        torch.as_tensor(row_bus, device=device), *pos, wpack, bpack, steps, discounts,
        cfg.latent_dim, cfg.hidden_dim, float(cfg.leaky_relu_slope),
    )


STAGES = ("inputs and state init", "step weights",
          "edge and node stages (phi heads, aggregate, L heads)", "physics refresh and loss")


class K4Plan(NamedTuple):
    """How K4 holds one grid (megakernel.cu gns_megakernel_plan)."""

    plan: int  # 0 to 3 (the module docstring), -1 where none holds the grid
    shared_bytes: int  # per block (of the last plan where none holds the grid)
    blocks_per_grid: int
    workspace_bytes: int  # per grid, in global memory (plans 2 and 3)
    grids_per_sm: int  # resident, cudaOccupancyMaxActiveBlocksPerMultiprocessor (0 if none)

    @property
    def tiles(self) -> str:
        """Where a step's weight tiles sit: "shared" memory or read from "L2"."""
        return "shared" if self.plan == 0 else "L2"


def _plan(n: int, e: int, g: int, latent: int, hidden: int, want: int) -> Tuple[int, int, int, int]:
    """(plan, shared bytes a block, blocks a grid, workspace bytes a grid)
    from the width's library, with `want` as gns_megakernel_plan takes it."""
    out = (ctypes.c_longlong * 4)()
    rc = kern.function("gns_megakernel_plan", (latent, hidden))(n, e, g, latent, hidden, want,
                                                                ctypes.addressof(out))
    if rc == -2:
        raise RuntimeError(f"K4's library for latent {latent}, hidden {hidden} is built for "
                           f"another width")
    return tuple(out)


def megakernel_cuda(inp: MegakernelInputs, clocks: torch.Tensor = None,
                    plan: int = -1) -> Tuple[torch.Tensor, ...]:
    """One launch of K4. Returns v, theta, delta_p, delta_q (S, N) and the
    (total, last) loss (S, 2), float32 on the card. With `clocks`, an
    (S, len(STAGES)) int64 tensor on the card, the kernel also records each
    grid's SM clock cycles per stage (chip_smoke.py reads them). `plan`:
    -1, the library's plan for the grid; 0 to 3 runs that plan, which must
    hold the grid (chip_smoke.py holds the plans to each other). Plans 2
    and 3 take a workspace, allocated here."""
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
            inp.src.indptr, inp.gen.order, inp.gen.indptr, inp.dst_pos, inp.src_pos, inp.gen_pos,
            inp.items.view(-1), inp.row_bus]
    for t in ints:
        kern._check_cuda("index", t, (torch.int32,), 1, dev)
    if (inp.src.n, inp.dst.n, inp.gen.n, inp.src.edges, inp.gen.edges) != (n, n, n, e, g):
        raise ValueError("index sets do not match the batch")
    if (inp.dst.order.numel(), inp.src.order.numel(), inp.gen.order.numel(), inp.dst_pos.numel(),
            inp.src_pos.numel(), inp.gen_pos.numel(), inp.row_bus.numel()) != (e, e, g, e, e, g, e):
        raise ValueError("the CSRs and their row maps do not cover the lines and generators")
    if inp.items.dim() != 2 or inp.items.shape[1] != 4 or inp.items.data_ptr() % 16:
        raise ValueError("work items must be a 16-byte aligned (T, 4) int32 tensor")
    kern._check_cuda("wpack", inp.wpack, (torch.bfloat16,), 2, dev)
    kern._check_cuda("bpack", inp.bpack, (torch.float32,), 2, dev)
    if inp.wpack.data_ptr() % 16 or inp.bpack.data_ptr() % 16:
        raise ValueError("wpack / bpack must be 16-byte aligned (the kernel copies them as 16-byte words)")
    kern._check_cuda("discounts", inp.discounts, (torch.float32,), 1, dev)
    if not 0.0 <= inp.slope <= 1.0:
        raise ValueError(f"K4 takes a LeakyReLU slope in [0, 1], got {inp.slope}")
    kern.check_width(inp.latent, inp.hidden, s * n, s * e)
    width = (inp.latent, inp.hidden)
    step_sizes = kern.function("gns_megakernel_step_sizes", width)
    want = (step_sizes(inp.latent, inp.hidden, 0), step_sizes(inp.latent, inp.hidden, 1))
    if want[0] < 0:
        raise RuntimeError(f"K4's library for latent {inp.latent}, hidden {inp.hidden} is built "
                           f"for another width")
    if (inp.wpack.shape[1], inp.bpack.shape[1]) != want or inp.bpack.shape[0] != k \
            or inp.discounts.numel() != k:
        raise ValueError(f"weight packs {tuple(inp.wpack.shape)} / {tuple(inp.bpack.shape)} "
                         f"do not match K={k} steps of {want}")
    chosen, shared, _, ws_bytes = _plan(n, e, g, inp.latent, inp.hidden, plan)
    if chosen < 0:
        which = "no plan" if plan < 0 else f"plan {plan}"
        raise ValueError(f"a grid of N={n}, E={e}, G={g} at latent {inp.latent}, hidden "
                         f"{inp.hidden} fits {which} of K4: it needs {shared} bytes of shared "
                         f"memory, more than the {kern.MAX_SHARED_BYTES} a block can hold")
    if clocks is not None:
        kern._check_cuda("clocks", clocks, (torch.int64,), 2, dev)
        if clocks.shape != (s, len(STAGES)):
            raise ValueError(f"clocks must be ({s}, {len(STAGES)}), got {tuple(clocks.shape)}")
    outs = [torch.empty((s, n), dtype=torch.float32, device=dev) for _ in range(4)]
    loss = torch.empty((s, 2), dtype=torch.float32, device=dev)
    ws = torch.empty((s * ws_bytes // 4,), dtype=torch.float32, device=dev) if ws_bytes else None
    rc = kern.function("gns_megakernel", width)(
        inp.buses.data_ptr(), inp.lines.data_ptr(), inp.gens.data_ptr(),
        inp.bus_mask.data_ptr(), inp.line_mask.data_ptr(), inp.gen_mask.data_ptr(),
        *(t.data_ptr() for t in ints), inp.items.shape[0],
        inp.wpack.data_ptr(), inp.bpack.data_ptr(),
        inp.discounts.data_ptr(), *(o.data_ptr() for o in outs), loss.data_ptr(),
        None if clocks is None else clocks.data_ptr(), None if ws is None else ws.data_ptr(),
        s, n, e, g, k, inp.latent, inp.hidden, inp.slope, chosen, kern._stream_of(dev.index),
    )
    if rc != 0:
        raise RuntimeError(f"K4 megakernel launch failed: cudaError {rc}")
    megakernel_cuda.launches += 1
    return (*outs, loss)


megakernel_cuda.launches = 0


def megakernel_occupancy(inp: MegakernelInputs, plan: int = -1) -> K4Plan:
    """How K4 holds a grid of this batch's size under `plan` (-1: the
    library's choice), from the width's library: the plan, shared bytes a
    block, blocks and workspace bytes a grid, grids resident per SM."""
    kern.check_width(inp.latent, inp.hidden)
    n, e, g = inp.buses.shape[1], inp.lines.shape[1], inp.gens.shape[1]
    width = (inp.latent, inp.hidden)
    per_sm = kern.function("gns_megakernel_blocks_per_sm", width)(n, e, g, *width, plan)
    return K4Plan(*_plan(n, e, g, *width, plan), per_sm)


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
