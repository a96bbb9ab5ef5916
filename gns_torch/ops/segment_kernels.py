"""K1 (segment-sum) and K2 (row gather): the CUDA kernels and their plain twins,
and the build of every CUDA source of the port.

The kernels are in gns_torch/csrc/segment.cu; that file's header says
which TPU kernels they replace, what bounds them and how. This module
builds each source of SOURCES (segment.cu here, fused_edge.cu for K3 in
ops/fused.py, megakernel.cu for K4 in ops/megakernel.py) with nvcc at
first use, into build/torch_kernels/ under the checkout keyed by the
source's and flags' hash, loads the library with ctypes, and wraps K1/K2:

  segment_sum_cuda(data, order, indptr, n)  K1: (S, E, D) f32/bf16 -> (S, n, D) f32
  gather_cuda(data, ids, masked=False)      K2: (S, R, D) -> (S, E, D), same dtype

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates the output with new_empty, launches on the
device's current stream, raises if the launch reports an error, and adds
one to its `launches` count per launch. At D <= 4 a launch moves a few MB
and its time is the host's, so the launch path is kept lean: every C
function is resolved and typed once, when its library loads (SIGNATURES,
`function`); the checks are one combined test, with `_check_cuda` run
only to name what failed; and the stream handle comes from PyTorch's raw
accessor of the current stream, read anew on every call.

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
# Every CUDA source of the port, by library name. Each builds into its own
# shared library with a plain C interface.
SOURCES = {
    name: os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    for name in ("segment", "fused_edge", "megakernel")
}
# Flags of one source beside NVCC_FLAGS. K4's physics must round after every
# float32 operation, as its plain twin does, so nvcc may not contract a
# multiply and an add into an FMA there (its products run on mma).
EXTRA_FLAGS = {"megakernel": ["--fmad=false"]}
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

MAX_SHARED_BYTES = 232448  # 227 KB: the most shared memory an H100 block may use

_libs = {}  # library name -> loaded ctypes.CDLL


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


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgns_{name}_{digest}.so")


def build_kernels(names=None) -> dict:
    """Compile each named source (default: all of SOURCES) unless its
    library, keyed by the hash of the source and the flags, exists. One
    nvcc per source, all started together.

    Returns {name: {"path", "seconds", "log"}}: nvcc's output (ptxas's
    register and spill report) is kept beside the library, so a library
    that was already built comes with its build's log and 0.0 seconds.
    """
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    info, running = {}, {}
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            log = ""
            if os.path.exists(f"{path}.log"):
                with open(f"{path}.log") as f:
                    log = f.read()
            info[name] = {"path": path, "seconds": 0.0, "log": log}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {SOURCES[name]}:\n{log}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
        info[name] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Every C function of every library: (argtypes, restype), set once when the
# library loads. Pointers and the stream are c_void_p (a Python int), so
# ctypes does not cut them to 32 bits.
SIGNATURES = {
    "segment": {
        "gns_segment_sum": ([_p, _i, _p, _p, _p, _ll, _ll, _ll, _ll, _p], _i),
        "gns_gather": ([_p, _p, _p, _ll, _ll, _ll, _ll, _i, _p], _i),
        "gns_gather_plan": ([_ll, _ll, _ll, _p, _p, _p], _i),
    },
    "fused_edge": {
        "gns_fused_edge": ([_p] * 11 + [_ll, _i, _i, _i, _i, _i, _f, _p, _p], _i),
        "gns_fused_edge_weight_floats": ([_i, _i], _i),
        "gns_fused_edge_occupancy": ([_i, _i, _p], _i),
    },
    "megakernel": {
        "gns_megakernel": ([_p] * 20 + [_i] + [_p] * 9 + [_ll, _i, _i, _i, _i, _i, _i, _f, _p], _i),
        "gns_megakernel_shared_bytes": ([_i, _i, _i, _i, _i], _ll),
        "gns_megakernel_blocks_per_sm": ([_i, _i, _i, _i, _i], _i),
        "gns_megakernel_step_sizes": ([_i, _i, _i], _ll),
    },
}
_LIBRARY_OF = {fn: name for name, fns in SIGNATURES.items() for fn in fns}
_fns = {}  # C function name -> its bound ctypes function, resolved once


def library(name: str):
    """The loaded library of SOURCES[name], built at first use, with every
    C function of SIGNATURES[name] resolved and typed once."""
    if name not in _libs:
        lib = ctypes.CDLL(build_kernels([name])[name]["path"])
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            bound = getattr(lib, fn)
            bound.argtypes, bound.restype = argtypes, restype
            _fns[fn] = bound
        _libs[name] = lib
    return _libs[name]


def function(fn: str):
    """The bound C function `fn` of its library (loaded at first use)."""
    bound = _fns.get(fn)
    if bound is None:
        library(_LIBRARY_OF[fn])
        bound = _fns[fn]
    return bound


def _check_cuda(name: str, t: torch.Tensor, dtypes, ndim: int, device=None):
    """Raises unless t is a contiguous CUDA tensor of one of `dtypes`, with
    `ndim` dimensions, on `device` (a torch.device) if given."""
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


# The raw handle of the current stream of a device index, as a Python int:
# PyTorch's own accessor where the build has it (it reads the current stream
# on every call, as torch.cuda.current_stream does, without building a
# Stream object), else the public API.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_of(index: int) -> int:
    """The current stream's handle on CUDA device `index`."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


_DATA_DTYPES = (torch.float32, torch.bfloat16)
_INT32 = (torch.int32,)


def segment_sum_cuda(data: torch.Tensor, order: torch.Tensor,
                     indptr: torch.Tensor, num_segments: int) -> torch.Tensor:
    """K1: out[s, n, :] = sum of data[s, order[indptr[n]:indptr[n+1]], :],
    accumulated in f32 in edge order. Returns float32 (S, num_segments, D)."""
    dev = data.get_device()
    if not (data.is_cuda and data.dtype in _DATA_DTYPES and data.dim() == 3
            and data.is_contiguous() and order.is_cuda and order.dtype == torch.int32
            and order.dim() == 1 and order.is_contiguous() and order.get_device() == dev
            and indptr.is_cuda and indptr.dtype == torch.int32 and indptr.dim() == 1
            and indptr.is_contiguous() and indptr.get_device() == dev):
        _check_cuda("data", data, _DATA_DTYPES, 3)
        _check_cuda("order", order, _INT32, 1, data.device)
        _check_cuda("indptr", indptr, _INT32, 1, data.device)
    if indptr.numel() != num_segments + 1:
        raise ValueError(f"indptr has {indptr.numel()} entries, want {num_segments + 1}")
    s, e, d = data.shape
    out = data.new_empty((s, num_segments, d), dtype=torch.float32)
    if s * num_segments * d == 0:
        return out
    rc = function("gns_segment_sum")(
        data.data_ptr(), 0 if data.dtype == torch.float32 else 1,
        order.data_ptr(), indptr.data_ptr(), out.data_ptr(),
        s, e, num_segments, d, _stream_of(dev),
    )
    if rc != 0:
        raise RuntimeError(f"K1 segment-sum launch failed: cudaError {rc}")
    segment_sum_cuda.launches += 1
    return out


def gather_cuda(data: torch.Tensor, ids: torch.Tensor, masked: bool = False) -> torch.Tensor:
    """K2: out[s, e, :] = data[s, ids[e], :]. ids must lie in
    [0, data.shape[1]) (checked on the host by SegmentIndex); with
    `masked`, an id may also be -1, and its row of out is zero (K1's
    backward over an index with dropped ids)."""
    dev = data.get_device()
    if not (data.is_cuda and data.dtype in _DATA_DTYPES and data.dim() == 3
            and data.is_contiguous() and ids.is_cuda and ids.dtype == torch.int32
            and ids.dim() == 1 and ids.is_contiguous() and ids.get_device() == dev):
        _check_cuda("data", data, _DATA_DTYPES, 3)
        _check_cuda("ids", ids, _INT32, 1, data.device)
    s, r, d = data.shape
    e = ids.shape[0]
    out = data.new_empty((s, e, d))
    if s * e * d == 0:
        return out
    rc = function("gns_gather")(
        data.data_ptr(), ids.data_ptr(), out.data_ptr(),
        s, r, e, d * data.element_size(), 1 if masked else 0, _stream_of(dev),
    )
    if rc != 0:
        raise RuntimeError(f"K2 gather launch failed: cudaError {rc}")
    gather_cuda.launches += 1
    return out


segment_sum_cuda.launches = 0
gather_cuda.launches = 0


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


def gather_plain(data: torch.Tensor, ids: torch.Tensor, masked: bool = False) -> torch.Tensor:
    """K2's plain twin: index_select along the row axis; with `masked`,
    rows whose id is -1 are zero."""
    if not masked:
        return data.index_select(1, ids.long())
    ids = ids.long()
    out = data.index_select(1, ids.clamp_min(0))
    return torch.where((ids >= 0)[None, :, None], out, torch.zeros((), dtype=data.dtype,
                                                                    device=data.device))


# K2's launch plan, mirrored from csrc/segment.cu gather_plan (the same
# constants); chip_smoke.py checks the two agree at every shape it runs.
_NARROW_THREADS, _CHUNKS_PER_THREAD = 256, 2
_WIDE_THREADS, _WIDE_WORDS_PER_THREAD, _MAX_TILE_EDGES, _MAX_GRID_Y = 256, 4, 1024, 65535
PLAN_FIELDS = ("variant", "unit", "units_per_row", "grid_x", "grid_y", "per", "magic")


def gather_plan(s: int, e: int, row_bytes: int, data_ptr: int, out_ptr: int) -> dict:
    """How K2 covers a gather of rows of row_bytes into (s, e, row_bytes):
    variant 0 (rows of 2-16 bytes that are not one aligned 8- or 16-byte
    word, written as 16-byte chunks of several rows) or 1 (one aligned 8-
    or 16-byte word, or wider rows); the unit it moves in bytes and the
    units per row; the grid; per (16-byte chunks per block for 0, edges per
    tile for 1); and, for 1 with several units per row, the multiplier
    whose high word divides by the units per row."""
    align = data_ptr | out_ptr
    plan = dict(variant=1, unit=2, units_per_row=0, grid_x=0, grid_y=min(s, _MAX_GRID_Y),
                per=0, magic=0)
    if row_bytes <= 16 and not (row_bytes in (8, 16) and align % row_bytes == 0):
        plan["variant"] = 0
        plan["unit"] = 4 if row_bytes % 4 == 0 and align % 4 == 0 else 2
        plan["units_per_row"] = w = row_bytes // plan["unit"]
        c = 16 // plan["unit"]
        chunks = -(-(e * w) // c) + 1
        plan["per"] = _NARROW_THREADS * _CHUNKS_PER_THREAD
        plan["grid_x"] = -(-chunks // plan["per"])
        return plan
    for unit in (16, 8, 4, 2):
        if row_bytes % unit == 0 and align % unit == 0:
            plan["unit"] = unit
            break
    plan["units_per_row"] = w = row_bytes // plan["unit"]
    most = min(max(_WIDE_THREADS * _WIDE_WORDS_PER_THREAD // w, 1), _MAX_TILE_EDGES)
    tiles = -(-e // most)
    plan["per"] = -(-e // tiles)
    plan["grid_x"] = -(-e // plan["per"])
    plan["magic"] = 0 if w == 1 else (1 << 32) // w + 1
    return plan


def gather_plan_cuda(s: int, e: int, row_bytes: int, data_ptr: int, out_ptr: int) -> dict:
    """The plan K2's library computes for the same arguments (needs the built
    library, not a card)."""
    buf = (ctypes.c_int * len(PLAN_FIELDS))()
    function("gns_gather_plan")(s, e, row_bytes, data_ptr, out_ptr, ctypes.addressof(buf))
    plan = dict(zip(PLAN_FIELDS, buf))
    plan["magic"] &= 0xFFFFFFFF
    return plan
