"""K3: the fused edge stage of one correction step (gather + three phi MLPs +
masked segment-sum), its CUDA kernel and its plain twin.

Port of gns_tpu/ops/pallas_fused.py `fused_edge_stage`. For each sample s:

    edge_in = concat(m[s, dst], feats[s])             # (E, L + 5)
    for head in (phi_v, phi_theta, phi_m):
        x = Linear-LReLU-Linear-LReLU-Linear(edge_in) * line_mask[s]
        sum_head[s] = segment-sum of x at dst         # (N, L)

  fused_edge_stage(m, feats, line_mask, index, heads, slope)
      -> (sum_phi_v, sum_phi_theta, sum_phi_m), each (S, N, L) float32

m (S, N, L), feats (S, E, 5), line_mask (S, E), all float32; index a
SegmentIndex over the dst ids (E,), shared by the batch; heads
{phi_v, phi_theta, phi_m}, each {w1, b1, w2, b2, w4, b4} in torch's
(out, in) layout, as models/gns.py `_block` gives them.

On a CUDA tensor the forward is one launch of the kernel in
gns_torch/csrc/fused_edge.cu (`fused_edge_cuda`), in exact float32: no TF32
and no bf16 operands. The kernel is built for (L, H) = (20, 10) and (40,
10), the shipped checkpoints' widths; another width raises. What the kernel reads beside the inputs is laid out
here, in Python, so the CPU tests reach it:
  pack_weights    the 18 weights as one vector, each matrix transposed
                  with its rows padded to 16-byte words (pack_index);
  _schedule       its warps' work items over the dst CSR (ops/segment.py
                  schedule_items at ROWS = 64: runs of whole buses in at
                  most 64 rows, or one bus with more) and each row's bus,
                  made once per SegmentIndex.
The compiled Pallas kernel truncated its operands to bf16
(pallas_fused.py:22-28); that was Mosaic's doing and is not copied.
The backward recomputes the edge stage from the saved inputs through the
port's unfused ops (K2 gather, F.linear, LeakyReLU, K1 segment-sum) and
lets autograd take it back, as gns_tpu's `_bwd` recomputes through XLA; on
the card that runs K1/K2, never a plain twin. On a CPU tensor the function
is its plain twin `fused_edge_stage_plain` (gather_plain, F.linear,
segment_sum_plain), which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from gns_torch.models.gns import PHI_HEADS
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.segment import SegmentIndex, gather, schedule_items, segment_sum

_PARAMS = ("w1", "b1", "w2", "b2", "w4", "b4")
ROWS = 64  # fused_edge.cu kRows: dst-CSR rows per warp tile, two per lane


def _weights(heads: Dict[str, Dict[str, torch.Tensor]]):
    """The 18 weight tensors in kernel order: per head w1 b1 w2 b2 w4 b4."""
    return [heads[h][n] for h in PHI_HEADS for n in _PARAMS]


def _round4(x: int) -> int:
    return -(-x // 4) * 4


@functools.lru_cache(maxsize=None)
def pack_index(latent: int, hidden: int) -> np.ndarray:
    """The kernel's weight layout (fused_edge.cu Pack) as indices into the
    18 weights flattened and concatenated in `_weights` order, -1 where it
    pads with zeros: per head w1, w2 and w4 transposed to (in, out) with
    each row padded to a multiple of 4 floats, each bias padded the same
    way after its matrix, so the weights of four consecutive outputs for
    one input are one 16-byte word."""
    f = latent + 5
    idx, off = [], 0
    for _ in PHI_HEADS:
        for rows, cols in ((hidden, f), (hidden, hidden), (latent, hidden)):  # (out, in)
            pad = _round4(rows)
            for i in range(cols):
                idx += [off + j * cols + i for j in range(rows)] + [-1] * (pad - rows)
            off += rows * cols
            idx += list(range(off, off + rows)) + [-1] * (pad - rows)  # the bias
            off += rows
    return np.asarray(idx, np.int64)


_PACK_INDEX = {}  # (latent, hidden, device) -> pack_index there, its -1 at the zero slot


def pack_weights(weights, latent: int, hidden: int) -> torch.Tensor:
    """The 18 weights as the kernel reads them: one float32 vector in
    pack_index's layout, zeros in the padding."""
    flat = torch.cat([w.reshape(-1) for w in weights] + [weights[0].new_zeros(1)])
    key = (latent, hidden, flat.device)
    idx = _PACK_INDEX.get(key)
    if idx is None:
        host = pack_index(latent, hidden)
        idx = _PACK_INDEX[key] = torch.as_tensor(np.where(host < 0, flat.numel() - 1, host),
                                                 device=flat.device)
    return flat.index_select(0, idx)


_SCHEDULES: "weakref.WeakKeyDictionary[SegmentIndex, tuple]" = weakref.WeakKeyDictionary()


def _schedule(index: SegmentIndex):
    """K3's work items over the index's CSR (schedule_items at ROWS) as a
    (T, 4) int32 tensor and its row_bus (E,), on the index's device, made
    once per index."""
    hit = _SCHEDULES.get(index)
    if hit is None:
        items, row_bus = schedule_items(index.indptr.cpu().numpy(), ROWS)
        dev = index.indptr.device
        hit = _SCHEDULES[index] = (torch.as_tensor(items, device=dev).contiguous(),
                                   torch.as_tensor(row_bus, device=dev))
    return hit


def _check_index(index: SegmentIndex, m: torch.Tensor, feats: torch.Tensor):
    if index.batch is not None:
        raise ValueError("the fused edge stage takes dst ids shared by the batch, shape (E,)")
    if not index.in_range:
        raise ValueError(f"dst ids outside [0, {index.n})")
    if m.shape[1] != index.n or feats.shape[1] != index.edges:
        raise ValueError(f"m {tuple(m.shape)} / feats {tuple(feats.shape)} do not fit "
                         f"an index of {index.edges} edges into {index.n} buses")


def _weight_shapes(latent: int, hidden: int):
    return [(hidden, latent + 5), (hidden,), (hidden, hidden), (hidden,), (latent, hidden),
            (latent,)] * 3


CLOCK_PHASES = ("inputs", "MLPs", "sums and stores", "units")


def fused_edge_cuda(m, feats, line_mask, index: SegmentIndex, weights, slope: float,
                    clocks: torch.Tensor = None):
    """One launch of K3 on CUDA tensors. weights: the 18 tensors of
    `_weights`, float32 on the same device. Returns the three (S, N, L)
    float32 sums. With `clocks`, an int64 (warps, len(CLOCK_PHASES))
    tensor on the card with a row for every warp the grid can hold
    (fused_edge_occupancy), the launch takes the kernel's instrumented
    instance, whose warps also record their SM cycles per phase and their
    unit counts there (chip_smoke.py reads them); without, the kernel
    reads no clock."""
    kern._check_cuda("m", m, (torch.float32,), 3)
    kern._check_cuda("feats", feats, (torch.float32,), 3, m.device)
    kern._check_cuda("line_mask", line_mask, (torch.float32,), 2, m.device)
    _check_index(index, m, feats)
    s, n, latent = m.shape
    e = index.edges
    hidden = weights[0].shape[0]
    if feats.shape != (s, e, 5) or line_mask.shape != (s, e):
        raise ValueError(f"feats {tuple(feats.shape)} / line_mask {tuple(line_mask.shape)} "
                         f"do not match ({s}, {e}, 5) / ({s}, {e})")
    dev = m.get_device()
    shapes = _weight_shapes(latent, hidden)
    if not (len(weights) == len(shapes) and all(
            w.is_cuda and w.dtype == torch.float32 and w.is_contiguous() and w.get_device() == dev
            and w.shape == shape for w, shape in zip(weights, shapes))):
        for w, shape in zip(weights, shapes):  # name what is wrong
            kern._check_cuda("weight", w, (torch.float32,), len(shape), m.device)
            if tuple(w.shape) != shape:
                raise ValueError(f"weight of shape {tuple(w.shape)}, want {shape}")
        raise ValueError(f"{len(weights)} weights, want {len(shapes)}")
    for t in (index.ids, index.order, index.indptr):
        kern._check_cuda("index", t, (torch.int32,), 1, m.device)
    floats = kern.function("gns_fused_edge_weight_floats")(latent, hidden)
    if floats < 0:
        raise ValueError(f"K3 is not built for latent {latent}, hidden {hidden}")
    packed = pack_weights(weights, latent, hidden)
    if packed.numel() != floats:
        raise ValueError(f"packed weights hold {packed.numel()} floats, the kernel reads {floats}")
    items, row_bus = _schedule(index)
    outs = [m.new_empty((s, n, latent)) for _ in range(3)]
    if clocks is not None:
        kern._check_cuda("clocks", clocks, (torch.int64,), 2, m.device)
        _, per_sm, threads, sms = fused_edge_occupancy(latent, hidden)
        if clocks.shape != (per_sm * sms * threads // 32, len(CLOCK_PHASES)):
            raise ValueError(f"clocks must be ({per_sm * sms * threads // 32}, {len(CLOCK_PHASES)}), "
                             f"got {tuple(clocks.shape)}")
    if any(t.data_ptr() % 16 for t in (packed, items, *outs)):
        raise ValueError("K3's packed weights, work items and outputs must be 16-byte aligned")
    rc = kern.function("gns_fused_edge")(
        m.data_ptr(), feats.data_ptr(), line_mask.data_ptr(), index.order.data_ptr(),
        index.indptr.data_ptr(), items.data_ptr(), row_bus.data_ptr(), packed.data_ptr(),
        *(o.data_ptr() for o in outs), s, n, e, items.shape[0], latent, hidden,
        float(slope), None if clocks is None else clocks.data_ptr(), kern._stream_of(dev),
    )
    if rc != 0:
        raise RuntimeError(f"K3 fused edge stage launch failed: cudaError {rc}")
    fused_edge_cuda.launches += 1
    return tuple(outs)


fused_edge_cuda.launches = 0


def fused_edge_occupancy(latent: int = 20, hidden: int = 10) -> Tuple[int, int, int, int]:
    """(shared bytes per block, blocks resident per SM, threads per block,
    SMs) of K3 on the current device, from the kernel library."""
    out = (ctypes.c_int * 4)()
    rc = kern.function("gns_fused_edge_occupancy")(latent, hidden, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"K3 occupancy query failed: cudaError {rc}")
    return tuple(out)


def _edge_stage(m, feats, line_mask, weights, slope, gather_m, segsum):
    """The edge stage in unfused ops; gather_m(m) -> (S, E, L) and
    segsum(x (S, E, L)) -> (S, N, L) are the graph primitives to use."""
    edge_in = torch.cat([gather_m(m), feats], dim=-1)
    outs = []
    for h in range(3):
        w1, b1, w2, b2, w4, b4 = weights[6 * h: 6 * h + 6]
        x = F.leaky_relu(F.linear(edge_in, w1, b1), slope)
        x = F.leaky_relu(F.linear(x, w2, b2), slope)
        x = F.linear(x, w4, b4) * line_mask[..., None]
        outs.append(segsum(x))
    return tuple(outs)


def fused_edge_stage_plain(m, feats, line_mask, index: SegmentIndex,
                           heads: Dict[str, Dict[str, torch.Tensor]], slope: float = 0.01):
    """K3's plain twin: gather_plain, F.linear and segment_sum_plain (the
    same CSR order of adds as the kernel). Differentiable by autograd."""
    _check_index(index, m, feats)
    return _edge_stage(
        m, feats, line_mask, _weights(heads), slope,
        lambda x: kern.gather_plain(x, index.ids),
        lambda x: kern.segment_sum_plain(x, index.order, index.indptr, index.n),
    )


class _FusedEdgeK3(torch.autograd.Function):
    """K3 forward; the backward recomputes through K2 / F.linear / K1."""

    @staticmethod
    def forward(ctx, slope, index, m, feats, line_mask, *weights):
        ctx.slope, ctx.index = slope, index
        ctx.save_for_backward(m, feats, line_mask, *weights)
        return fused_edge_cuda(m, feats, line_mask, index, list(weights), slope)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        m, feats, line_mask, *weights = inputs
        index = ctx.index
        with torch.enable_grad():
            outs = _edge_stage(
                m, feats, line_mask, weights, ctx.slope,
                lambda x: gather(x, index), lambda x: segment_sum(x, index),
            )
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return (None, None, *(next(got) if t.requires_grad else None for t in inputs))


def fused_edge_stage(m, feats, line_mask, index: SegmentIndex,
                     heads: Dict[str, Dict[str, torch.Tensor]],
                     slope: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum_phi_v, sum_phi_theta, sum_phi_m), each (S, N, L) float32: one
    K3 launch on CUDA tensors (autograd backward through K1/K2), the plain
    twin on CPU tensors."""
    if m.is_cuda:
        return _FusedEdgeK3.apply(slope, index, m.contiguous(), feats.contiguous(),
                                  line_mask.contiguous(),
                                  *(w.contiguous() for w in _weights(heads)))
    if m.device.type != "cpu":
        raise ValueError(f"unsupported device {m.device}: gns_torch runs on cuda or cpu")
    return fused_edge_stage_plain(m, feats, line_mask, index, heads, slope)
