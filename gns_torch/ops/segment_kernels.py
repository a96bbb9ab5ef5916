"""K1 (segment-sum) and K2 (row gather): the CUDA kernels and their plain twins.

The kernels are in gns_torch/csrc/segment.cu; that file's header says
which TPU kernels they replace, what bounds them and how. This module
builds the source with nvcc at first use (into build/torch_kernels/ under
the checkout, keyed by the source's hash), loads the library with ctypes,
and wraps each entry point:

  segment_sum_cuda(data, order, indptr, n)  K1: (S, E, D) f32/bf16 -> (S, n, D) f32
  gather_cuda(data, ids)                    K2: (S, R, D) -> (S, E, D), same dtype

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates the output with torch.empty, launches on
torch.cuda.current_stream(), raises if the launch reports an error, and
adds one to its `launches` count per launch.

The plain twins (`segment_sum_plain`: index_add_, `gather_plain`:
index_select) take the same arguments and compute the same function. The
CPU path of ops/segment.py runs them, and chip_smoke.py holds the kernels
against them on the card; nothing on the card's main path calls them.

Index contract (established on the host by ops/segment.py SegmentIndex):
`order` lists the kept edges grouped by segment, in edge order within a
segment (a stable sort), `indptr` (n + 1,) delimits the groups, and every
gather id lies in [0, R).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "segment.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None  # the loaded library, once built


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of gns_torch are built from source at first use"
    )


def build_kernels() -> dict:
    """Compile csrc/segment.cu unless this source's library exists.

    Returns {"path", "seconds", "log"}: seconds is 0.0 and log empty when
    the library was already built.
    """
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libgns_segment_{digest}.so")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{log}")
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernels()["path"])
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gns_segment_sum.argtypes = [p, i, p, p, p, ll, ll, ll, ll, p]
        lib.gns_segment_sum.restype = i
        lib.gns_gather.argtypes = [p, p, p, ll, ll, ll, ll, p]
        lib.gns_gather.restype = i
        _lib = lib
    return _lib


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, data on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def segment_sum_cuda(data: torch.Tensor, order: torch.Tensor,
                     indptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K1: out[s, n, :] = sum of data[s, order[indptr[n]:indptr[n+1]], :],
    accumulated in f32 in edge order. Returns float32 (S, num_segments, D)."""
    _check_cuda("data", data, (torch.float32, torch.bfloat16), 3)
    _check_cuda("order", order, (torch.int32,), 1, data.device)
    _check_cuda("indptr", indptr, (torch.int32,), 1, data.device)
    if indptr.numel() != num_segments + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, want {num_segments + 1}")
    s, e, d = data.shape
    out = torch.empty((s, num_segments, d), dtype=torch.float32, device=data.device)
    if out.numel() == 0:
        return out
    rc = _library().gns_segment_sum(
        data.data_ptr(), 0 if data.dtype == torch.float32 else 1,
        order.data_ptr(), indptr.data_ptr(), out.data_ptr(),
        s, e, num_segments, d, _stream(data.device),
    )
    if rc != 0:
        raise RuntimeError(f"K1 segment-sum launch failed: cudaError {rc}")
    segment_sum_cuda.launches += 1
    return out


def gather_cuda(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K2: out[s, e, :] = data[s, ids[e], :]. ids must lie in
    [0, data.shape[1]) (checked on the host by SegmentIndex)."""
    _check_cuda("data", data, (torch.float32, torch.bfloat16), 3)
    _check_cuda("ids", ids, (torch.int32,), 1, data.device)
    s, r, d = data.shape
    e = ids.numel()
    out = torch.empty((s, e, d), dtype=data.dtype, device=data.device)
    if out.numel() == 0:
        return out
    rc = _library().gns_gather(
        data.data_ptr(), ids.data_ptr(), out.data_ptr(),
        s, r, e, d * data.element_size(), _stream(data.device),
    )
    if rc != 0:
        raise RuntimeError(f"K2 gather launch failed: cudaError {rc}")
    gather_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0
gather_cuda.launches = 0

KERNELS = {"K1": segment_sum_cuda, "K2": gather_cuda}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def segment_sum_plain(data: torch.Tensor, order: torch.Tensor,
                      indptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K1's plain twin: index_add_ over the same CSR, in the same order of
    adds (per segment, edges in edge order), accumulated in float32."""
    counts = (indptr[1:] - indptr[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(num_segments, device=data.device), counts
    )
    rows = data.float().index_select(1, order.long())
    out = torch.zeros(
        (data.shape[0], num_segments, data.shape[2]),
        dtype=torch.float32, device=data.device,
    )
    return out.index_add(1, seg, rows)


def gather_plain(data: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K2's plain twin: index_select along the row axis."""
    return data.index_select(1, ids.long())
