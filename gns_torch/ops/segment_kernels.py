"""K1 (segment-sum) and K2 (row gather): the CUDA kernels and their plain twins,
and the build of every CUDA source of the port.

The kernels are in gns_torch/csrc/segment.cu; that file's header says
which TPU kernels they replace, what bounds them and how. This module
builds each source of SOURCES (segment.cu here, fused_edge.cu for K3 in
ops/fused.py, megakernel.cu for K4 in ops/megakernel.py) with nvcc at
first use, into build/torch_kernels/ under the checkout (build_libraries,
which also builds the host packer of utils/native.py there), loads the
library with ctypes, and wraps K1/K2:

  segment_sum_cuda(data, order, indptr, n)  K1: (S, E, D) f32/bf16 -> (S, n, D) f32
  gather_cuda(data, ids, masked=False)      K2: (S, R, D) -> (S, E, D), same dtype

K3 and K4 are built once per (latent, hidden) width (WIDTHED): the width
and the blocks per SM its __launch_bounds__ asks for reach the template as
-D macros (`_flags`), and each width is a library of its own. A library's
key is the hash of its source, its flags and what the host resolves them
to: `nvcc --version` for the CUDA sources, the C++ compiler's `--version`
and the target `-march=native` names for the host packer (`host_probe`,
each probe run once per process).

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
import functools
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

_libs = {}  # library name, or (name, width) for K3 / K4 -> loaded ctypes.CDLL


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


# K3 and K4 are built per (latent, hidden) width, for every width gns_tpu's
# kernels take: any latent and hidden of at least 1, short of where the
# kernels' 32-bit index arithmetic would overflow (check_width). Their
# plain twins take any width.
WIDTHED = ("fused_edge", "megakernel")
INDEX_LIMIT = 1 << 31  # where a 32-bit index overflows


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def k3_pack_floats(latent: int, hidden: int) -> int:
    """Floats of K3's three packed heads (fused_edge.cu Pack, ops/fused.py
    pack_index): per layer the (in, out) matrix and the bias, each row
    padded to 4 floats."""
    f, hp, lp = latent + 5, _round4(hidden), _round4(latent)
    return 3 * ((f + 1) * hp + (hidden + 1) * hp + (hidden + 1) * lp)


@functools.lru_cache(maxsize=None)
def _width_sizes(latent: int, hidden: int):
    """What K3 and K4 index with 32 bits at a width: (what, elements)."""
    from gns_torch.ops.megakernel import tile_dims  # it imports this module

    return (("K3's packed weights", k3_pack_floats(latent, hidden)),
            ("K4's packed step", tile_dims(latent, hidden).tiles[-1] * 128))


def check_width(latent: int, hidden: int, *extents: int) -> None:
    """Raises unless the CUDA kernels K3 and K4 take (latent, hidden): each
    at least 1, with the weight packs' 32-bit offsets (K3's packed floats,
    K4's step of bf16 tiles) under 2^31; and each of `extents` (a launch's
    S x N and S x E rows) times latent under 2^31, as K1 (segment.cu
    gns_segment_sum) refuses E x D or N x D at 2^31. Checked before any
    build or launch."""
    if latent < 1 or hidden < 1:
        raise ValueError(f"K3 and K4 take latent and hidden of at least 1, got "
                         f"({latent}, {hidden})")
    sizes = _width_sizes(latent, hidden)
    for rows in extents:
        if rows * latent >= INDEX_LIMIT:
            sizes += ((f"{rows} rows x latent {latent}", rows * latent),)
    for what, size in sizes:
        if size >= INDEX_LIMIT:
            raise ValueError(f"K3 and K4 index with 32 bits: {what} at (latent, hidden) = "
                             f"({latent}, {hidden}) is {size} elements, 2^31 or more")


# K3 keeps a lane's two edges' inputs and hidden activations, 2 (L + 5) +
# 4 H floats, in registers while they stay within (33, 24)'s 172, the
# widest width measured with no spill (198 registers at 2 blocks per SM);
# past it, the tile's inputs and activations sit in each warp's scratch
# and a row's outputs are split over lanes (fused_edge.cu's wide design):
# in shared memory while a block's four warps' scratch fits one block,
# past that in a global workspace (the workspace design).
K3_REGISTER_FLOATS = 172
K3_WARPS = 4  # warps per block, every design
K3_DESIGNS = {"registers": 64, "wide": 16, "workspace": 16}  # design -> rows per warp tile


def k3_warp_floats(latent: int, hidden: int) -> int:
    """One warp's scratch in the wide and workspace designs, in floats
    (fused_edge.cu WideLayout kWarp): a 16-row tile's inputs and two
    layers' activations, a hub bus's sums, the row masks and pointers."""
    f, hl = latent + 5, max(hidden, latent)
    return _round4(16 * (f + hl + hidden) + _round4(3 * latent) + 16 + 17)


@functools.lru_cache(maxsize=None)
def k3_design(latent: int, hidden: int) -> str:
    """K3's design at this width: "registers" (two edges a lane, 64-row
    tiles) within K3_REGISTER_FLOATS, else "wide" (16-row tiles, scratch
    in shared memory) while K3_WARPS warps' scratch fits a block, else
    "workspace" (the wide design's scratch in global memory)."""
    if 2 * (latent + 5) + 4 * hidden <= K3_REGISTER_FLOATS:
        return "registers"
    if K3_WARPS * k3_warp_floats(latent, hidden) * 4 <= MAX_SHARED_BYTES:
        return "wide"
    return "workspace"


def k3_rows(latent: int, hidden: int) -> int:
    """dst-CSR rows per warp tile of K3's design at this width: 64 for the
    register design (two rows a lane), 16 for the wide and workspace ones
    (its -DGNS_ROWS, and the rows of its work items, ops/fused.py
    _schedule)."""
    return K3_DESIGNS[k3_design(latent, hidden)]


def k3_block_bytes(latent: int, hidden: int) -> int:
    """Shared bytes a block of K3's design takes (fused_edge.cu
    block_bytes): the register design's packed weights, staging rows, hub
    sums and row pointers; the wide design's four warps' scratch; none for
    the workspace design."""
    design = k3_design(latent, hidden)
    if design == "registers":
        rows = K3_DESIGNS[design]
        return 4 * (k3_pack_floats(latent, hidden) + K3_WARPS * rows * _round4(latent)
                    + K3_WARPS * 3 * latent + K3_WARPS * (rows + 1))
    if design == "wide":
        return K3_WARPS * k3_warp_floats(latent, hidden) * 4
    return 0


def min_blocks(name: str, latent: int, hidden: int) -> int:
    """Blocks per SM the width's __launch_bounds__ asks for, which caps
    its registers a thread (65,536 / (threads x blocks), at most 255).
    K3 (128 threads), register design: 3 (170 registers) while a lane's
    two edges' inputs and hidden activations, 2 (L + 5) + 4 H floats, stay
    within the (20, 10) instance's 90 and L <= 25, else 2 (255). ptxas's
    registers grow with L about three times as fast as with H: at 90
    floats (30, 5) spills at 3 where (24, 8) does not. Wide design: 4 (128
    registers); its lanes hold 8 x 4 accumulators and loop over inputs and
    64-column passes (109-119 registers up to (282, 282)), and shared
    memory, not registers, sets its blocks per SM. Workspace design: 3
    (170 registers): at 4 its global addressing spilled 20-84 bytes at
    (512, 64), (512, 512), (283, 283) and (1, 1024), at 3 none (135-151
    registers). python3 probe_k3_blocks.py prints ptxas's registers and
    spills at 2, at 3 and at the choice for chip_smoke's widths, the
    rules' boundaries and wide ends. K4 (256 threads): 2 grids (128
    registers) up to latent 20 with one k-tile of hidden units, else 1;
    the asked blocks are those of its plan-0 instance (megakernel.cu), its
    wide instance asks for 1."""
    if name == "fused_edge":
        design = k3_design(latent, hidden)
        if design != "registers":
            return 4 if design == "wide" else 3
        return 3 if 2 * (latent + 5) + 4 * hidden <= 90 and latent <= 25 else 2
    return 2 if latent <= 20 and hidden <= 16 else 1


def _flags(name: str, width=None, blocks: int | None = None):
    """nvcc's flags for a source; for K3 / K4 those of one width, with
    `blocks` (default: min_blocks) as its blocks per SM."""
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    if name not in WIDTHED:
        return flags
    if width is None:
        raise ValueError(f"{name} is built per (latent, hidden) width: give one")
    latent, hidden = width
    check_width(latent, hidden)
    if blocks is None:
        blocks = min_blocks(name, latent, hidden)
    flags = flags + [f"-DGNS_LATENT={latent}", f"-DGNS_HIDDEN={hidden}",
                     f"-DGNS_MIN_BLOCKS={blocks}"]
    if name == "fused_edge":
        flags.append(f"-DGNS_ROWS={k3_rows(latent, hidden)}")
        if k3_design(latent, hidden) == "workspace":
            flags.append("-DGNS_WORKSPACE=1")
    return flags


_PROBES = {}  # argv -> its output: each host probe runs once per process


def _run(argv) -> str:
    """The output (stdout, then stderr) of argv, or why it did not run."""
    try:
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{argv[0]}: {exc}"
    return proc.stdout + proc.stderr


def host_probe(*argv: str) -> str:
    """The output of argv, run once per process and kept."""
    out = _PROBES.get(argv)
    if out is None:
        out = _PROBES[argv] = _run(list(argv))
    return out


def nvcc_host() -> str:
    """What the CUDA libraries' key sees of the host: `nvcc --version`."""
    try:
        tool = _nvcc()
    except RuntimeError:
        return "no nvcc"  # the build raises
    return host_probe(tool, "--version")


def cxx_host(cxx: str) -> str:
    """What the host packer's key sees of the host: the compiler's
    `--version` and the target -march=native resolves to, GCC's -march=
    line of `-march=native -Q --help=target` (a compiler that prints none
    is keyed by its version alone)."""
    march = [" ".join(line.split()) for line in
             host_probe(cxx, "-march=native", "-Q", "--help=target").splitlines()
             if line.strip().startswith("-march=")]
    return "\n".join([host_probe(cxx, "--version"), *march])


def _library_path(name: str, source: str | None = None, key: str | None = None,
                  width=None) -> str:
    """The library of a source under BUILD_DIR, keyed by the hash of the
    source and `key` (default: its nvcc flags at `width` and nvcc_host());
    a width's library names it."""
    source = SOURCES[name] if source is None else source
    if key is None:
        key = " ".join(_flags(name, width)) + "\n" + nvcc_host()
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + key.encode()).hexdigest()[:16]
    tag = "" if width is None else "_L{}_H{}".format(*width)
    return os.path.join(BUILD_DIR, f"libgns_{name}{tag}_{digest}.so")


def build_libraries(jobs: dict) -> dict:
    """Compile each library of `jobs`, {name: (path, command)}, unless its
    path exists: command(out) is the argv that compiles the source into
    `out`, called only for a build. All builds start together; each writes
    a temporary file of its own, moved onto the path when it is done, so
    processes that build the same library at once never read half of one.

    Returns {name: {"path", "seconds", "log"}}: the compiler's output is
    kept beside the library, so a library that was already built comes
    with its build's log and 0.0 seconds. Raises RuntimeError, with the
    compiler's output, if a build fails or its compiler cannot be run.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    info, running, failed = {}, {}, []
    for name, (path, command) in jobs.items():
        if os.path.exists(path):
            log = ""
            if os.path.exists(f"{path}.log"):
                with open(f"{path}.log") as f:
                    log = f.read()
            info[name] = {"path": path, "seconds": 0.0, "log": log}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        argv = command(tmp)
        try:
            proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except OSError as exc:
            failed.append(f"cannot run {argv[0]} to build {name}: {exc}")
            continue
        running[name] = (proc, path, tmp, argv, time.perf_counter())
    for name, (proc, path, tmp, argv, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(argv[0])} failed ({proc.returncode}) building "
                          f"{name}: {' '.join(argv)}\n{log}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
        info[name] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


def build_kernels(libs=None) -> dict:
    """Compile each library of `libs` with nvcc unless it exists: a list of
    source names (segment) and (name, (latent, hidden)) pairs (K3 / K4,
    one library per width); default, every source that needs no width.
    One nvcc per library, all started together (build_libraries); returns
    build_libraries' info keyed as `libs` names them. The log kept beside a
    library is nvcc's, ptxas's register and spill report included."""
    libs = [n for n in SOURCES if n not in WIDTHED] if libs is None else list(libs)
    jobs = {}
    for lib in libs:
        name, width = (lib, None) if isinstance(lib, str) else lib
        jobs[lib] = (_library_path(name, width=width),
                     lambda out, name=name, width=width: [_nvcc(), *_flags(name, width), "-o",
                                                          out, SOURCES[name]])
    return build_libraries(jobs)


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
        "gns_fused_edge": ([_p] * 11 + [_ll, _i, _i, _i, _i, _i, _f, _p, _p, _p], _i),
        "gns_fused_edge_weight_floats": ([_i, _i], _i),
        "gns_fused_edge_occupancy": ([_i, _i, _p], _i),
    },
    "megakernel": {
        "gns_megakernel": ([_p] * 20 + [_i] + [_p] * 10 + [_ll, _i, _i, _i, _i, _i, _i, _f, _i, _p],
                           _i),
        "gns_megakernel_plan": ([_i, _i, _i, _i, _i, _i, _p], _i),
        "gns_megakernel_blocks_per_sm": ([_i, _i, _i, _i, _i, _i], _i),
        "gns_megakernel_step_sizes": ([_i, _i, _i], _ll),
    },
}
_LIBRARY_OF = {fn: name for name, fns in SIGNATURES.items() for fn in fns}
# C function name (or (name, width) for K3 / K4) -> its bound ctypes
# function, resolved once when its library loads
_fns = {}


def library(name: str, width=None):
    """The loaded library of SOURCES[name] (at `width` for K3 / K4), built
    at first use, with every C function of SIGNATURES[name] resolved and
    typed once."""
    lib_key = name if width is None else (name, tuple(width))
    if lib_key not in _libs:
        lib = ctypes.CDLL(build_kernels([lib_key])[lib_key]["path"])
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            bound = getattr(lib, fn)
            bound.argtypes, bound.restype = argtypes, restype
            _fns[fn if width is None else (fn, tuple(width))] = bound
        _libs[lib_key] = lib
    return _libs[lib_key]


def function(fn: str, width=None):
    """The bound C function `fn` of its library (at `width`, a (latent,
    hidden) tuple, for K3 / K4), loaded at first use."""
    bound = _fns.get(fn if width is None else (fn, width))
    if bound is None:
        library(_LIBRARY_OF[fn], width)
        bound = _fns[fn if width is None else (fn, tuple(width))]
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
