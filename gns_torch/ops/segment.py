"""Edge aggregation primitives: segment-sum (edge -> bus) and gather (bus -> edge).

The one dispatch point of the port's graph primitives (counterpart of
gns_tpu/ops/segment.py). Data is always batched: (S, E) or (S, E, D).

  * On a CPU tensor every method name of the JAX package ('scatter',
    'onehot', 'hybrid', 'take', 'auto', 'pallas') computes the plain
    version (ops/segment_kernels.py segment_sum_plain / gather_plain);
    autograd differentiates it.
  * On a CUDA tensor 'auto' (and 'pallas', so that existing configs carry
    over) launches K1 / K2; any other method raises. There is no fallback:
    a CUDA tensor reaches a kernel or an error.

The kernels take 1-D data as (S, E, 1). A segment-sum of bfloat16 data
returns float32 (the kernel accumulates in float32, as the JAX 'onehot' /
'hybrid' lowerings do); a gather keeps the data's dtype.

Indices come as a SegmentIndex, built once per topology on the host: the
ids, the CSR-by-segment the kernel walks, and a range check. Ids outside
[0, n) are dropped by segment-sum (as jax.ops.segment_sum drops them), and
their gradient is 0: on the card K1's backward is then a masked K2 launch
that writes zero rows for them. A gather through an index with such ids
raises. Per-sample topologies (a mixed-size request) are flattened to one
(S*E,) index offset by s*n, so they still run as one kernel launch over a
(1, S*E, D) view.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gns_torch.ops import segment_kernels as kern

SEGMENT_METHODS = ("auto", "scatter", "onehot", "hybrid", "pallas")
GATHER_METHODS = ("auto", "take", "onehot", "hybrid", "pallas")
_KERNEL_METHODS = ("auto", "pallas")


class SegmentIndex:
    """Host-checked segment ids with the CSR that K1 walks.

    ids: (E,) shared by the batch, or (S, E) per sample. n: the number of
    segments (bus count for a segment-sum; row count of the gathered data
    for a gather). Built on the host with numpy, then moved to `device`.
    """

    def __init__(self, ids, n: int, device="cpu"):
        ids = np.asarray(ids).astype(np.int64)
        if ids.ndim not in (1, 2):
            raise ValueError(f"ids must be (E,) or (S, E), got shape {ids.shape}")
        self.n = int(n)
        self.edges = ids.shape[-1]
        self.batch: Optional[int] = ids.shape[0] if ids.ndim == 2 else None
        valid = (ids >= 0) & (ids < self.n)
        self.in_range = bool(valid.all())
        if self.batch is not None:
            # flatten: sample s's ids move to [s*n, (s+1)*n); dropped ids
            # stay out of range of the flat segment count
            ids = np.where(valid, ids + self.n * np.arange(self.batch)[:, None], -1)
            ids = ids.reshape(-1)
            valid = valid.reshape(-1)
        self.rows = self.n * (self.batch or 1)  # segments of the flat index
        kept = np.flatnonzero(valid)
        order = kept[np.argsort(ids[kept], kind="stable")]
        indptr = np.zeros(self.rows + 1, np.int64)
        np.cumsum(np.bincount(ids[kept], minlength=self.rows), out=indptr[1:])
        if max(self.rows, ids.size) >= 2**31:
            raise ValueError("index too large for int32 kernel offsets")
        dev = torch.device(device)
        self.ids = torch.as_tensor(np.where(valid, ids, 0).astype(np.int32), device=dev)
        # the ids with every dropped one as -1, for K1's backward (a masked
        # K2 launch); None where no id was dropped
        self.masked_ids = None if self.in_range else torch.as_tensor(
            np.where(valid, ids, -1).astype(np.int32), device=dev)
        self.order = torch.as_tensor(order.astype(np.int32), device=dev)
        self.indptr = torch.as_tensor(indptr.astype(np.int32), device=dev)

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        """(S, L, D) -> the (S', L', D) view the kernel consumes."""
        if self.batch is None:
            return x
        if x.shape[0] != self.batch:
            raise ValueError(f"index built for batch {self.batch}, data has {x.shape[0]}")
        return x.reshape(1, -1, x.shape[-1])


def _check_method(method: str, allowed, x: torch.Tensor) -> None:
    if method not in allowed:
        raise ValueError(f"unknown method {method!r}; expected one of {allowed}")
    if x.is_cuda:
        if method not in _KERNEL_METHODS:
            raise ValueError(
                f"method {method!r} has no CUDA lowering; CUDA tensors go to "
                f"the kernels with method 'auto' (or 'pallas')"
            )
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}: gns_torch runs on cuda or cpu")


class _SegmentSumK1(torch.autograd.Function):
    """K1 forward; backward launches K2 (the adjoint), as
    gns_tpu/ops/pallas_segment.py:109-125 does on the TPU. A dropped id's
    gradient is a zero row (a masked K2 launch)."""

    @staticmethod
    def forward(ctx, x, index: SegmentIndex):
        ctx.index, ctx.dtype = index, x.dtype
        return kern.segment_sum_cuda(x, index.order, index.indptr, index.rows)

    @staticmethod
    def backward(ctx, g):
        idx = ctx.index
        ids = idx.ids if idx.in_range else idx.masked_ids
        return kern.gather_cuda(g.contiguous(), ids, masked=not idx.in_range).to(ctx.dtype), None


class _GatherK2(torch.autograd.Function):
    """K2 forward; backward launches K1 over the same index."""

    @staticmethod
    def forward(ctx, x, index: SegmentIndex):
        ctx.index, ctx.dtype = index, x.dtype
        return kern.gather_cuda(x, index.ids)

    @staticmethod
    def backward(ctx, g):
        idx = ctx.index
        out = kern.segment_sum_cuda(g.contiguous(), idx.order, idx.indptr, idx.rows)
        return out.to(ctx.dtype), None


def segment_sum(data: torch.Tensor, index: SegmentIndex, method: str = "auto"):
    """Sum `data` (S, E) or (S, E, D) into index.n buckets per sample ->
    (S, n) or (S, n, D). float32 for float32 or bfloat16 data."""
    _check_method(method, SEGMENT_METHODS, data)
    squeeze = data.dim() == 2
    x = data.unsqueeze(-1) if squeeze else data
    if x.shape[1] != index.edges:
        raise ValueError(f"data has {x.shape[1]} edges, index {index.edges}")
    s = x.shape[0]
    x = index._flat(x.contiguous())
    if x.is_cuda:
        out = _SegmentSumK1.apply(x, index)
    else:
        out = kern.segment_sum_plain(x, index.order, index.indptr, index.rows)
    out = out.reshape(s, index.n, x.shape[-1])
    return out[..., 0] if squeeze else out


def gather(data: torch.Tensor, index: SegmentIndex, method: str = "auto"):
    """Row gather data[s, ids[e]] for data (S, n) or (S, n, D) ->
    (S, E) or (S, E, D), in the data's dtype."""
    _check_method(method, GATHER_METHODS, data)
    if not index.in_range:
        raise ValueError(f"gather index has ids outside [0, {index.n})")
    squeeze = data.dim() == 2
    x = data.unsqueeze(-1) if squeeze else data
    if x.shape[1] != index.n:
        raise ValueError(f"data has {x.shape[1]} rows, index gathers from {index.n}")
    s = x.shape[0]
    x = index._flat(x.contiguous())
    if x.is_cuda:
        out = _GatherK2.apply(x, index)
    else:
        out = kern.gather_plain(x, index.ids)
    out = out.reshape(s, index.edges, x.shape[-1])
    return out[..., 0] if squeeze else out


def broadcast_col0_segment_sum(data_col, index: SegmentIndex, latent_dim: int,
                               method: str = "auto"):
    """Reference quirk Q1: scatter an (S, E, 1) message into an
    (S, n, latent) buffer of which only column 0 is written
    (reference GNS/main.py:169-170, SURVEY.md §2.4-Q1)."""
    col0 = segment_sum(data_col[..., 0], index, method=method)
    out = torch.zeros(
        (data_col.shape[0], index.n, latent_dim),
        dtype=data_col.dtype, device=data_col.device,
    )
    out[..., 0] = col0.to(data_col.dtype)
    return out


def schedule_items(indptr, rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Work items over a CSR by segment (indptr (N + 1,)) for a kernel whose
    warp holds whole segments: a (T, 4) int32 table of (first segment, end
    segment, first CSR row, end row), each item a run of at most `rows`
    segments whose rows fill at most `rows` CSR rows, unless one segment
    has more (it is then an item of its own, over several tiles); and per
    CSR row (E,) its segment << 1 | 1 on the segment's last row. K3 reads it
    at ops/fused.py ROWS = 64 over the dst CSR, K4 at ops/megakernel.py
    ROWS = 16."""
    indptr = np.asarray(indptr, np.int64)
    n = len(indptr) - 1
    bounds = [0]
    for b in range(n):
        first = bounds[-1]
        if b > first and (indptr[b + 1] - indptr[first] > rows or b + 1 - first > rows):
            bounds.append(b)
    if n > bounds[-1]:
        bounds.append(n)
    bounds = np.asarray(bounds, np.int64)
    counts = np.diff(indptr)
    seg = np.repeat(np.arange(n), counts)
    last = np.zeros(int(indptr[-1]), np.int64)
    last[indptr[1:][counts > 0] - 1] = 1
    items = np.stack([bounds[:-1], bounds[1:], indptr[bounds[:-1]], indptr[bounds[1:]]], axis=1)
    return items.astype(np.int32), (seg * 2 + last).astype(np.int32)
