"""gns_torch's host packer (utils/native.py over csrc/gridpack.cpp, built
at first use with the host C++ compiler) against the port's numpy path
(prepare_case + _stack_to_batch) and gns_tpu's packer
(gns_tpu/utils/native.py over the committed native/libgridpack.so): the
same arrays, bit for bit."""

import os

import numpy as np
import pytest

from gns_tpu.utils import native as j_native
from gns_torch.ops import segment_kernels as kern
from gns_torch.utils import native
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.cases import load_case
from gns_torch.utils.prepare import _stack_to_batch, prepare_case


def _assert_batch_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=f"field {name} differs")


PACKS = {
    "case9": (lambda: list(generate_cases(9, 5, seed=21)), {}),
    "case14": (lambda: list(generate_cases(14, 5, seed=21)), {}),
    "case300": (lambda: list(generate_cases(300, 5, seed=21)), {}),
    "mixed": (lambda: [load_case(9), load_case(14), load_case(30)], {}),
    "mixed_pad_sizes": (lambda: [load_case(9), load_case(14), load_case(30)],
                        dict(pad_sizes=(40, 48, 8))),
    "pad_e_below_n": (lambda: list(generate_cases(14, 2, seed=3)), dict(pad_sizes=(24, 20, 6))),
    "true_shunts": (lambda: list(generate_cases(14, 3, seed=4)), dict(paper_shunts=False)),
    "true_shunts_mixed": (lambda: [load_case(9), load_case(300)], dict(paper_shunts=False)),
}


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_pack_batch_bit_equal(pack):
    """pack_batch against _stack_to_batch([prepare_case(c) ...]) and
    gns_tpu's pack_batch, every field bit for bit."""
    make, kw = PACKS[pack]
    cases = make()
    ref = _stack_to_batch([prepare_case(c, paper_shunts=kw.get("paper_shunts", True))
                           for c in cases], kw.get("pad_sizes"))
    out = native.pack_batch(cases, **kw)
    assert type(out).__name__ == "GridBatch"
    _assert_batch_equal(ref, out)
    _assert_batch_equal(j_native.pack_batch(cases, **kw), out)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_pack_batch_threads(n_threads):
    cases = list(generate_cases(30, 9, seed=5))
    _assert_batch_equal(native.pack_batch(cases), native.pack_batch(cases, n_threads=n_threads))


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
    src = open(native.SOURCE).read()
    for sym in ("gridpack_prepare_batch", "gridpack_csr_by_dst"):
        assert sym in src


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
