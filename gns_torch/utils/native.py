"""ctypes bindings for the host data-loader, gns_torch/csrc/gridpack.cpp
(the port of gns_tpu/utils/native.py).

The C++ packer performs prepare_case's transform and the bucket padding of
_stack_to_batch (utils/prepare.py), multithreaded across grids, and the
CSR edge sort. `pack_batch` reads each case's float64 tables where they
lie (no staging copy) and is the path of prepare.py batch_from_cases
wherever a host compiler exists. prepare.py's numpy path stays the
reference: `pack_batch` is bit-equal to it (tests/test_torch_native.py).

The library is built at first use with the host C++ compiler ($CXX, else
c++ or g++) and native/Makefile's flags into build/torch_kernels/, keyed
by the hash of the source, the compiler, the flags and what the host
resolves them to: the compiler's version and the target -march=native
names (ops/segment_kernels.py cxx_host, build_libraries). The committed
native/libgridpack.so of the JAX package is never loaded: it was built
with -march=native on another machine.

  pack_batch(cases, ...)  raises RuntimeError, with the compiler's output,
                          when the library cannot be built; it never packs
                          with numpy instead. ValueError on a table the
                          packer cannot read, naming the case.
  csr_by_dst(lines, n)    keeps its numpy path when the library cannot be
                          built, as gns_tpu's does when its library is
                          missing.
  HAVE_NATIVE             a host C++ compiler is on the PATH (or named by
                          $CXX), so the library can be built.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from gns_torch.ops import segment_kernels as kern
from gns_torch.utils import profiling
from gns_torch.utils.prepare import GridBatch

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "gridpack.cpp")
# native/Makefile's flags. ISO -std=c++17 (not gnu++17) and no -ffast-math
# keep GCC at -ffp-contract=off: an FMA contraction would round otherwise
# than numpy, and the packer would stop being bit-equal to prepare_case.
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_libs = {}  # $CXX as set when the library was loaded -> the loaded ctypes.CDLL


def compiler() -> Optional[str]:
    """The host C++ compiler: $CXX, else c++, else g++ (None if none is
    found). A $CXX that names no program is returned as given, so that the
    build reports it."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shutil.which(cxx) or cxx
    return shutil.which("c++") or shutil.which("g++")


HAVE_NATIVE = compiler() is not None


def library_path(cxx: str) -> str:
    """Where the library built by `cxx` lives: keyed by the source, the
    compiler, CXX_FLAGS and what the host resolves them to (its version
    and -march=native's target, ops/segment_kernels.py cxx_host)."""
    return kern._library_path("gridpack", SOURCE, " ".join([cxx, *CXX_FLAGS]) + "\n"
                              + kern.cxx_host(cxx))


def build_packer() -> dict:
    """Build the library unless it exists; returns {"path", "seconds",
    "log", "compiler", "flags"} (seconds 0.0 for a library already built).
    Raises RuntimeError, with the compiler's output, if it cannot be
    built."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler ($CXX, c++, g++): gns_torch/csrc/gridpack.cpp "
                           "is built at first use")
    path = library_path(cxx)
    info = kern.build_libraries(
        {"gridpack": (path, lambda out: [cxx, *CXX_FLAGS, "-o", out, SOURCE])})["gridpack"]
    info.update(compiler=cxx, flags=list(CXX_FLAGS))
    return info


def load():
    """The library, built at first use, with its C functions typed.
    Keyed by $CXX as set, so a call finds a loaded library without
    searching the PATH for the compiler again."""
    key = os.environ.get("CXX", "")
    lib = _libs.get(key)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build_packer()["path"])
    i64, i32, f32, f64 = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    )
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.gridpack_prepare_cases.restype = ctypes.c_int
    lib.gridpack_prepare_cases.argtypes = [
        p64, p64, p64,  # tables, rows, cols
        f64,  # base_mva
        i64, ctypes.c_int,  # s, paper_shunts
        i64, i64, i64,  # pad_n, pad_e, pad_g
        f32, f32, f32,  # buses, lines, gens
        f32, f32, f32,  # masks
        i32, p64,  # n_bus_out, bad
        ctypes.c_int,  # n_threads
    ]
    lib.gridpack_csr_by_dst.restype = ctypes.c_int
    lib.gridpack_csr_by_dst.argtypes = [f32, i64, i64, i32, i32]
    _libs[key] = lib
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


TABLES = ("bus", "branch", "gen")
_F64 = np.dtype(np.float64)
_NO_BYTES = ctypes.c_char * 0  # from_buffer gives a writable array's address at half t.ctypes' cost
_REFUSED = {3: "a table narrower than the columns the packer reads (bus 6, branch 10, gen 10)",
            4: "a table of negative size or without data"}


def _address(t: np.ndarray) -> int:
    return ctypes.addressof(_NO_BYTES.from_buffer(t)) if t.flags.writeable else t.ctypes.data


def pack_batch(
    cases: List[dict],
    pad_sizes: Optional[Tuple[int, int, int]] = None,
    paper_shunts: bool = True,
    n_threads: Optional[int] = None,
) -> GridBatch:
    """The native equivalent of prepare_case + _stack_to_batch
    (utils/prepare.py), bit for bit: a GridBatch of fresh numpy arrays.
    Each case's bus / branch / gen table is read where it lies when it is
    a 2-D C-contiguous float64 array, else converted to one for this call.
    pad_sizes: (N, E, G) at least the grids' largest; E >= N is enforced.

    Records the spans pack.prepare (the pass over the cases) and
    pack.stack (the C call that converts and pads) and counts
    pack.native_batches. Raises RuntimeError if the library cannot be
    built, ValueError on pad sizes below the data or a table it cannot
    read."""
    lib = load()
    if not cases:
        raise ValueError("no cases to pack")
    s = len(cases)
    with profiling.span("pack.prepare"):
        tables, addr, dims = [], [], []  # tables: each one read, alive until the call returns
        for i, c in enumerate(cases):
            for key in TABLES:
                t = c[key]
                if (type(t) is not np.ndarray or t.dtype is not _F64 or t.ndim != 2
                        or not t.flags.c_contiguous):
                    t = np.ascontiguousarray(np.asarray(t, np.float64))
                    if t.ndim != 2:
                        raise ValueError(f"case {i}: its {key} table is not 2-D")
                tables.append(t)
                addr.append(_address(t))
                dims += t.shape
        addr = np.array(addr, np.int64)
        dims = np.array(dims, np.int64).reshape(s, 3, 2)
        rows, cols = np.ascontiguousarray(dims[..., 0]), np.ascontiguousarray(dims[..., 1])
        base = np.array([c["baseMVA"] for c in cases], np.float64)

    with profiling.span("pack.stack"):
        n, e, g = (int(x) for x in rows.max(axis=0))
        pad_n, pad_e, pad_g = (n, e, g) if pad_sizes is None else pad_sizes
        if pad_n < n or pad_e < e or pad_g < g:  # _stack_to_batch's check and words
            raise ValueError(f"pad_sizes {pad_sizes} smaller than data ({n},{e},{g})")
        pad_e = max(pad_e, pad_n)  # E >= N invariant
        buses = np.empty((s, pad_n, 6), np.float32)
        lines = np.empty((s, pad_e, 7), np.float32)
        gens = np.empty((s, pad_g, 7), np.float32)
        bus_mask = np.empty((s, pad_n), np.float32)
        line_mask = np.empty((s, pad_e), np.float32)
        gen_mask = np.empty((s, pad_g), np.float32)
        n_bus = np.empty((s,), np.int32)
        bad = np.full((1,), -1, np.int64)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        i64 = ctypes.c_int64
        rc = lib.gridpack_prepare_cases(
            _ptr(addr, i64), _ptr(rows, i64), _ptr(cols, i64),
            _ptr(base, ctypes.c_double),
            s, int(paper_shunts),
            pad_n, pad_e, pad_g,
            _ptr(buses, ctypes.c_float), _ptr(lines, ctypes.c_float),
            _ptr(gens, ctypes.c_float),
            _ptr(bus_mask, ctypes.c_float), _ptr(line_mask, ctypes.c_float),
            _ptr(gen_mask, ctypes.c_float),
            _ptr(n_bus, ctypes.c_int32), _ptr(bad, i64),
            n_threads,
        )
    if rc in _REFUSED:
        raise ValueError(f"case {int(bad[0])}: {_REFUSED[rc]}")
    if rc != 0:
        raise RuntimeError(f"gridpack_prepare_cases failed with code {rc}")
    profiling.count("pack.native_batches")
    return GridBatch(buses, lines, gens, bus_mask, line_mask, gen_mask, n_bus)


def csr_by_dst_numpy(lines: np.ndarray, n_bus: int):
    """csr_by_dst's numpy path (a stable argsort by destination bus)."""
    dst = np.asarray(lines, np.float32)[:, 1].astype(np.int32) - 1
    order = np.argsort(dst, kind="stable").astype(np.int32)
    indptr = np.zeros(n_bus + 1, np.int32)
    np.add.at(indptr, dst + 1, 1)
    return order, np.cumsum(indptr, dtype=np.int32)


def csr_by_dst(lines: np.ndarray, n_bus: int):
    """Edge permutation sorted by destination bus (stable) and the CSR
    indptr. lines: one prepared (E, 7) float32 array. Returns (order (E,)
    int32, indptr (N + 1,) int32); the numpy path when the library cannot
    be built."""
    lines = np.ascontiguousarray(lines, np.float32)
    try:
        lib = load()
    except RuntimeError:
        return csr_by_dst_numpy(lines, n_bus)
    e = lines.shape[0]
    order = np.empty((e,), np.int32)
    indptr = np.empty((n_bus + 1,), np.int32)
    rc = lib.gridpack_csr_by_dst(
        _ptr(lines, ctypes.c_float), e, n_bus,
        _ptr(order, ctypes.c_int32), _ptr(indptr, ctypes.c_int32),
    )
    if rc != 0:
        raise RuntimeError(f"gridpack_csr_by_dst failed with code {rc}")
    return order, indptr
