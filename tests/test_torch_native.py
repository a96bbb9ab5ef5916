"""gns_torch's host packer (utils/native.py over csrc/gridpack.cpp, built
at first use with the host C++ compiler), directly and as batch_from_cases
and GNSPredictor.predict take it, against the port's numpy path
(prepare_case + _stack_to_batch) and gns_tpu's packer
(gns_tpu/utils/native.py over the committed native/libgridpack.so): the
same arrays, bit for bit."""

import ctypes
import mmap
import os

import numpy as np
import pytest

from gns_tpu.utils import native as j_native
from gns_torch.models.gns import GNS
from gns_torch.ops import segment_kernels as kern
from gns_torch.serve import GNSPredictor
from gns_torch.utils import native, profiling
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.cases import load_case
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import _stack_to_batch, batch_from_cases, prepare_case


def _assert_batch_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=f"field {name} differs")


def _tables_as(form, cases):
    """The cases with each table passed through `form`."""
    return [{**c, **{k: form(np.asarray(c[k], np.float64)) for k in native.TABLES}}
            for c in cases]


def _column_view(t):
    """A view of `t` inside a wider array: rows strided past its columns."""
    wide = np.zeros((t.shape[0], t.shape[1] + 3))
    wide[:, 1:-2] = t
    return wide[:, 1:-2]


def _read_only(t):
    t = t.copy()
    t.setflags(write=False)
    return t


PACKS = {
    "case9": (lambda: list(generate_cases(9, 5, seed=21)), {}),
    "one_grid": (lambda: list(generate_cases(300, 0)), {}),
    "case14": (lambda: list(generate_cases(14, 5, seed=21)), {}),
    "case300": (lambda: list(generate_cases(300, 5, seed=21)), {}),
    "mixed": (lambda: [load_case(9), load_case(14), load_case(30)], {}),
    "mixed_pad_sizes": (lambda: [load_case(9), load_case(14), load_case(30)],
                        dict(pad_sizes=(40, 48, 8))),
    "pad_e_below_n": (lambda: list(generate_cases(14, 2, seed=3)), dict(pad_sizes=(24, 20, 6))),
    "true_shunts": (lambda: list(generate_cases(14, 3, seed=4)), dict(paper_shunts=False)),
    "true_shunts_mixed": (lambda: [load_case(9), load_case(300)], dict(paper_shunts=False)),
    # tables that are not C-contiguous float64 arrays are converted, each alone
    "tables_list": (lambda: _tables_as(np.ndarray.tolist, generate_cases(14, 3, seed=6)), {}),
    "tables_float32": (lambda: _tables_as(lambda t: t.astype(np.float32),
                                          generate_cases(30, 3, seed=7)), {}),
    "tables_column_view": (lambda: _tables_as(_column_view, generate_cases(9, 3, seed=8)),
                           dict(pad_sizes=(12, 12, 4))),
    "tables_mixed_forms": (lambda: [*_tables_as(np.ndarray.tolist, generate_cases(9, 1, seed=9)),
                                    *_tables_as(_read_only, generate_cases(14, 1, seed=9))], {}),
}


@pytest.mark.parametrize("entry", ["pack_batch", "batch_from_cases"])
@pytest.mark.parametrize("pack", sorted(PACKS))
def test_pack_batch_bit_equal(pack, entry):
    """pack_batch, and batch_from_cases on its native path, against
    _stack_to_batch([prepare_case(c) ...]) and gns_tpu's pack_batch, every
    field bit for bit."""
    make, kw = PACKS[pack]
    cases = make()
    ref = _stack_to_batch([prepare_case(c, paper_shunts=kw.get("paper_shunts", True))
                           for c in cases], kw.get("pad_sizes"))
    if entry == "pack_batch":
        out = native.pack_batch(cases, **kw)
    else:
        with profiling.recording():
            out = batch_from_cases(cases, **kw)
        assert profiling.recorded().counted() == {"pack.native_batches": 1}
    assert type(out).__name__ == "GridBatch"
    _assert_batch_equal(ref, out)
    arrays = [{**c, **{k: np.asarray(c[k]) for k in native.TABLES}} for c in cases]
    _assert_batch_equal(j_native.pack_batch(arrays, **kw), out)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_pack_batch_threads(n_threads):
    """Any thread count gives the same bits, into fresh arrays each call."""
    cases = list(generate_cases(30, 9, seed=5))
    first = native.pack_batch(cases)
    again = native.pack_batch(cases, n_threads=n_threads)
    _assert_batch_equal(first, again)
    assert not any(np.shares_memory(a, b) for a, b in zip(first, again))


def _before_unreadable_page(table):
    """A float64 copy of `table` whose last byte is the last one before a
    page this process may not read: a read past the table faults."""
    table = np.ascontiguousarray(table, np.float64)
    pages = -(-table.nbytes // mmap.PAGESIZE)
    buf = mmap.mmap(-1, (pages + 1) * mmap.PAGESIZE)
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    guard = ctypes.addressof(ctypes.c_char.from_buffer(buf)) + pages * mmap.PAGESIZE
    assert libc.mprotect(guard, mmap.PAGESIZE, 0) == 0, ctypes.get_errno()  # PROT_NONE
    out = np.frombuffer(buf, np.float64, table.size, pages * mmap.PAGESIZE - table.nbytes)
    out = out.reshape(table.shape)
    out[...] = table
    return out  # keeps buf mapped while it lives


def test_tables_read_within_their_bounds():
    """Tables of exactly the columns the packer reads (bus 6, branch 10,
    gen 10), each ending at an unreadable page, pack bit-equal to the numpy
    path: the packer reads nothing past a table."""
    cases = [{**c, **{k: _before_unreadable_page(c[k][:, :w])
                      for k, w in zip(native.TABLES, (6, 10, 10))}}
             for c in generate_cases(14, 2, seed=9)]
    _assert_batch_equal(_stack_to_batch([prepare_case(c) for c in cases]),
                        native.pack_batch(cases))


@pytest.mark.parametrize("key,width", [("bus", 5), ("branch", 9), ("gen", 9)])
def test_narrow_table_refused(key, width):
    """A table narrower than the columns the packer reads is refused with
    its case's index, before a read past it: it ends at an unreadable page,
    so a read of its missing column would fault."""
    cases = list(generate_cases(14, 3, seed=9))
    cases[2] = {**cases[2], key: _before_unreadable_page(cases[2][key][:, :width])}
    with pytest.raises(ValueError, match=r"case 2: a table narrower than the columns"):
        native.pack_batch(cases)


@pytest.mark.parametrize("pads", [(4, 20, 5), (30, 10, 5)])
def test_pad_sizes_below_the_data_refused(pads):
    """Pad sizes below the data raise as _stack_to_batch does, E below the
    data too where N would pad it past."""
    cases = list(generate_cases(14, 1, seed=9))
    for pack in (lambda: _stack_to_batch([prepare_case(c) for c in cases], pads),
                 lambda: native.pack_batch(cases, pad_sizes=pads)):
        with pytest.raises(ValueError, match=r"pad_sizes .* smaller than data \(14,20,5\)"):
            pack()


@pytest.mark.parametrize("case_nr", [14, 30])
def test_predict_packs_natively_bit_equal(case_nr, monkeypatch):
    """GNSPredictor.predict returns the same v, theta and last_loss, bit for
    bit, with the native packer and with the numpy path. Recorded, each
    batch of a request records pack.prepare and pack.stack, and
    pack.native_batches counts one a batch on the native path, none on
    the numpy path."""
    cfg = GNSConfig(K=2, latent_dim=8, hidden_dim=8)
    pred = GNSPredictor(GNS(cfg, seed=0, device="cpu"), cfg, batch_size=4, device="cpu")
    cases = list(generate_cases(case_nr, 5, seed=12))  # 6 grids: two batches
    out = {}
    for have in (True, False):
        monkeypatch.setattr(native, "HAVE_NATIVE", have)
        with profiling.recording():
            out[have] = pred.predict(cases)
        rec = profiling.recorded()
        names = [s.name for s in rec.spans]
        assert names.count("pack.prepare") == names.count("pack.stack") == 2
        assert rec.counted().get("pack.native_batches", 0) == (2 if have else 0)
    for k in ("v", "theta", "last_loss"):
        np.testing.assert_array_equal(out[True][k], out[False][k], err_msg=k)


@pytest.mark.parametrize("case_nr", [14, 300])
def test_csr_by_dst_matches_gns_tpu(case_nr):
    """csr_by_dst equals gns_tpu's and its own numpy path: a stable sort by
    destination bus and its CSR."""
    buses, lines, _ = prepare_case(load_case(case_nr))
    n = buses.shape[0]
    order, indptr = native.csr_by_dst(lines, n)
    assert order.dtype == indptr.dtype == np.int32
    j_order, j_indptr = j_native.csr_by_dst(lines, n)
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(indptr, j_indptr)
    np_order, np_indptr = native.csr_by_dst_numpy(lines, n)
    np.testing.assert_array_equal(order, np_order)
    np.testing.assert_array_equal(indptr, np_indptr)
    dst = lines[:, 1].astype(np.int32) - 1
    assert np.all(np.diff(dst[order]) >= 0)


def test_built_from_the_port_source_into_build_dir():
    """The library is the port's own build of csrc/gridpack.cpp under
    build/torch_kernels/, never the JAX package's committed .so; a second
    build compiles nothing."""
    first = native.build_packer()
    assert os.path.dirname(first["path"]) == kern.BUILD_DIR
    assert os.path.basename(first["path"]).startswith("libgns_gridpack_")
    assert native.SOURCE.endswith(os.path.join("gns_torch", "csrc", "gridpack.cpp"))
    assert "-std=c++17" in first["flags"] and "-ffast-math" not in first["flags"]
    again = native.build_packer()
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    lib = ctypes.CDLL(first["path"])
    for sym in ("gridpack_prepare_cases", "gridpack_csr_by_dst"):
        assert hasattr(lib, sym)


def test_build_key_sees_the_host(monkeypatch):
    """A library's key sees what the host resolves its build to, from
    probes that run once per process: two -march=native targets give two
    packer paths, two `nvcc --version` outputs two paths of every CUDA
    library, the same probes the same paths, and two widths two K3 and two
    K4 paths."""
    host = {"march": "cooperlake", "nvcc": "Cuda compilation tools, release 12.4, V12.4.131"}
    runs = []

    def probe(argv):  # the host, as the probes read it
        runs.append(tuple(argv))
        if argv[1:] == ["--version"]:
            return host["nvcc"] if argv[0].endswith("nvcc") else "g++ (GCC) 13.2.0"
        if "--help=target" in argv:
            return (f"  -march=                     \t\t{host['march']}\n"
                    "  Known valid arguments for -march= option:\n")
        return ""

    monkeypatch.setattr(kern, "_run", probe)
    monkeypatch.setattr(kern, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    libs = [("segment", None), ("fused_edge", (20, 10)), ("megakernel", (20, 10))]

    def paths():
        monkeypatch.setattr(kern, "_PROBES", {})  # a new process
        runs.clear()
        out = [native.library_path("/usr/bin/g++")]
        out += [kern._library_path(name, width=width) for name, width in libs]
        probes = len(runs)
        assert out == [native.library_path("/usr/bin/g++")] + [
            kern._library_path(name, width=width) for name, width in libs]
        assert len(runs) == probes == len(set(runs)) == 3  # each probe once per process
        return out

    first = paths()
    assert paths() == first  # one probe, one path
    host["march"] = "sapphirerapids"
    other_cpu = paths()
    assert other_cpu[0] != first[0] and other_cpu[1:] == first[1:]
    host["nvcc"] = "Cuda compilation tools, release 12.8, V12.8.93"
    other_nvcc = paths()
    assert other_nvcc[0] == other_cpu[0]
    assert all(a != b for a, b in zip(other_nvcc[1:], other_cpu[1:]))
    for name in ("fused_edge", "megakernel"):
        narrow, default = (kern._library_path(name, width=w) for w in ((8, 8), (10, 10)))
        assert narrow != default and "_L8_H8_" in narrow and "_L10_H10_" in default


def test_bad_compiler_raises(tmp_path, monkeypatch):
    """A $CXX that cannot build the library makes pack_batch raise with the
    compiler's output; it never packs with numpy. csr_by_dst keeps its
    numpy path."""
    bad = tmp_path / "badcxx"
    bad.write_text("#!/bin/sh\necho 'badcxx: cannot compile this'\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setattr(kern, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(bad))
    cases = list(generate_cases(9, 2, seed=1))
    with pytest.raises(RuntimeError, match="cannot compile this"):
        native.pack_batch(cases)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.pack_batch(cases)
    buses, lines, _ = prepare_case(load_case(14))
    order, indptr = native.csr_by_dst(lines, buses.shape[0])
    np_order, np_indptr = native.csr_by_dst_numpy(lines, buses.shape[0])
    np.testing.assert_array_equal(order, np_order)
    np.testing.assert_array_equal(indptr, np_indptr)
