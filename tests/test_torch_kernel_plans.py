"""gns_torch K2 and K3 host-side plans on the CPU, each against its plain
twin: K2's launch plan (ops/segment_kernels.py gather_plan, the mirror of
csrc/segment.cu gather_plan), K3's work items over the dst CSR
(ops/fused.py _schedule, the call its wrapper makes), an emulation of K3's
per-item order of adds,
and K3's repacked weights (pack_weights / pack_index).

The CUDA kernels run only on the card, where chip_smoke.py checks that the
library's plan equals gather_plan and holds both kernels against their
plain twins; here the same index arithmetic is emulated in numpy."""

import os
import re

import numpy as np
import pytest
import torch

import jax

from gns_tpu.models.blocks import init_learning_block
from gns_torch.models.convert import heads_from_jax
from gns_torch.ops import fused
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.segment import SegmentIndex
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.prepare import base_case_batch, batch_from_cases, extract_shared_topology

torch.set_num_threads(1)


def _dst(case):
    """(dst ids, bus count) of a case grid, or a made-up index whose bus 5
    has 70 in-edges (a work item over several tiles) beside buses with
    none."""
    if case == "hub":
        rng = np.random.default_rng(3)
        dst = np.concatenate([np.full(70, 5), rng.integers(0, 30, 60)])
        rng.shuffle(dst)
        return dst, 32
    batch = batch_from_cases(list(generate_cases(case, 1, seed=0)))
    return extract_shared_topology(batch).dst, batch.buses.shape[1]


# ---- K2: the launch plan covers every output unit exactly once ----------

def _emulate_gather_plan(ids, r, row_bytes, s, data_ptr, out_ptr):
    """For each output unit of an (s, E, row_bytes) gather, which source unit
    (sample, row, unit of row) the kernel's plan copies into it (-1 where
    the id is -1: a masked launch writes a zero there), and how often it is
    written; built from gather_plan the way the kernel walks it."""
    e = ids.size
    p = kern.gather_plan(s, e, row_bytes, data_ptr, out_ptr)
    w, unit = p["units_per_row"], p["unit"]
    assert w * unit == row_bytes
    units = e * w
    src = np.full((s, units), -1, np.int64)
    writes = np.zeros((s, units), np.int64)
    if p["variant"] == 0:
        c = 16 // unit
        for si in range(s):
            dst_addr = out_ptr + si * units * unit
            head = (dst_addr % 16) // unit
            chunks = (head + units + c - 1) // c
            assert chunks <= p["grid_x"] * p["per"]  # the grid reaches the last chunk
            for bx in range(p["grid_x"]):
                for k in range(bx * p["per"], min(chunks, (bx + 1) * p["per"])):
                    h0 = k * c - head
                    full = h0 >= 0 and h0 + c <= units
                    if full:
                        assert (dst_addr + h0 * unit) % 16 == 0  # one 16-byte store
                    for q in range(c):
                        h = h0 + q
                        if 0 <= h < units:
                            row, col = divmod(h, w)
                            src[si, h] = (si * r + ids[row]) * w + col if ids[row] >= 0 else -1
                            writes[si, h] += 1
    else:
        magic = p["magic"]
        assert p["per"] <= 1024 and (magic == 0) == (w == 1)
        for bx in range(p["grid_x"]):
            e0 = bx * p["per"]
            n = min(p["per"], e - e0)
            f = np.arange(n * w, dtype=np.uint64)
            row = f.astype(np.int64) if w == 1 else \
                ((f * np.uint64(magic)) >> np.uint64(32)).astype(np.int64)
            assert np.array_equal(row, np.arange(n * w) // w)  # the multiply-high divides exactly
            col = np.arange(n * w) - row * w
            for si in range(s):
                np.add.at(writes[si], (e0 + row) * w + col, 1)
                src[si, (e0 + row) * w + col] = np.where(
                    ids[e0 + row] >= 0, (si * r + ids[e0 + row]) * w + col, -1)
    assert p["grid_y"] == min(s, 65535)
    return p, src, writes


K2_SHAPES = [  # (D, dtype bytes, index)
    (1, 4, "dst"), (2, 4, "dst"), (4, 4, "dst"), (20, 4, "dst"), (1, 4, "src_rows"),
    (4, 4, "src_rows"), (2, 2, "dst"), (8, 2, "dst"), (20, 2, "dst"), (60, 4, "dst"),
    (1, 4, "flat"), (4, 4, "flat"), (5, 4, "dst"),
]


def _k2_ids(which):
    """(ids, rows of the table, samples) of a K2 plan test's index."""
    dst, n = _dst(300)
    if which == "dst":
        return dst, n, 3
    if which == "src_rows":
        topo_src = extract_shared_topology(base_case_batch(300)).src
        return np.clip(topo_src, 0, len(dst) - 1), len(dst), 3
    # a flattened per-sample index: one sample, a table of 3 * n rows
    flat = SegmentIndex(np.tile(dst, (3, 1)), n)
    return flat.ids.numpy(), flat.rows, 1


@pytest.mark.parametrize("d, esz, which", K2_SHAPES)
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_k2_plan_covers_every_output_row_once(d, esz, which, shift):
    """At D in {1, 2, 4, 20} float32 and {2, 8} bfloat16 (and the other
    shapes chip_smoke checks), with the data pointer 0 to 3 elements off a
    16-byte word: every unit of the output is written exactly once, with
    the unit of the row that out[s, e] = data[s, ids[e]] names, and the
    variant is the one the shape and alignment pick."""
    ids, r, s = _k2_ids(which)
    row_bytes = d * esz
    data_ptr, out_ptr = 0x7F0000000000 + shift * esz, 0x7F0000100000
    p, src, writes = _emulate_gather_plan(np.asarray(ids), r, row_bytes, s, data_ptr, out_ptr)
    assert np.all(writes == 1)
    want = (np.arange(s)[:, None] * r + np.asarray(ids)[None, :]).astype(np.int64)
    w = p["units_per_row"]
    want = (want[..., None] * w + np.arange(w)).reshape(s, -1)
    assert np.array_equal(src, want)
    align = data_ptr | out_ptr
    if row_bytes > 16 or (row_bytes in (8, 16) and align % row_bytes == 0):
        assert p["variant"] == 1
        assert p["unit"] == max(u for u in (2, 4, 8, 16) if row_bytes % u == 0 and align % u == 0)
    else:
        assert p["variant"] == 0
        assert p["unit"] == (4 if row_bytes % 4 == 0 and align % 4 == 0 else 2)


@pytest.mark.parametrize("d, esz, which", K2_SHAPES)
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_k2_masked_plan_writes_zero_rows(d, esz, which, shift):
    """A masked launch (K1's backward over an index with dropped ids) takes
    the same plan: with every seventh id -1, every output unit is still
    written once, a dropped id's units are zero, the others copy their
    row's unit, and the result equals gather_plain(masked=True) exactly."""
    ids, r, s = _k2_ids(which)
    ids = np.where(np.arange(len(ids)) % 7 == 3, -1, ids)
    data_ptr, out_ptr = 0x7F0000000000 + shift * esz, 0x7F0000100000
    p, src, writes = _emulate_gather_plan(ids, r, d * esz, s, data_ptr, out_ptr)
    assert p == kern.gather_plan(s, len(ids), d * esz, data_ptr, out_ptr)
    assert np.all(writes == 1)
    w = p["units_per_row"]
    units = np.arange(1, s * r * w + 1, dtype=np.float64).reshape(s, r, w)  # unit i holds i + 1
    got = np.where(src >= 0, units.reshape(-1)[np.maximum(src, 0)], 0.0)
    want = kern.gather_plain(torch.from_numpy(units), torch.as_tensor(ids, dtype=torch.int32),
                             masked=True)
    assert np.array_equal(got, want.reshape(s, -1).numpy())
    assert np.all(got.reshape(s, len(ids), w)[:, ids < 0] == 0)


def test_launch_path_signatures_cover_every_c_function():
    """Every extern "C" function of every source is typed once, in
    SIGNATURES, with as many argument types as its C parameter list."""
    for name, path in kern.SOURCES.items():
        src = open(path).read()
        c_part = src[src.index('extern "C" {'):]
        found = {}
        for m in re.finditer(r"^(?:int|long long) (gns_\w+)\(([^)]*)\)", c_part, re.M):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
        assert set(found) == set(kern.SIGNATURES[name]), name
        for fn, count in found.items():
            assert len(kern.SIGNATURES[name][fn][0]) == count, fn
    assert os.path.basename(kern.SOURCES["segment"]) == "segment.cu"


def test_build_log_kept_beside_the_library(tmp_path, monkeypatch):
    """A library built once comes back from later builds with its first
    build's nvcc log (ptxas's register and spill report), unbuilt again."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n'
                    'echo "ptxas info    : Used 42 registers, 0 bytes spill stores"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(kern, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kern, "BUILD_DIR", str(tmp_path / "build"))
    first = kern.build_kernels(["segment"])["segment"]
    assert "Used 42 registers" in first["log"] and os.path.exists(first["path"])
    fake.write_text("#!/bin/sh\nexit 1\n")  # a second build would fail
    again = kern.build_kernels(["segment"])["segment"]
    assert again == {"path": first["path"], "seconds": 0.0, "log": first["log"]}


# ---- K3: schedule, order of adds, weight layout --------------------------

def _check_schedule(case, rows_per_tile):
    dst, n = _dst(case)
    index = SegmentIndex(dst, n)
    indptr, order = index.indptr.numpy(), index.order.numpy()
    items, row_bus = (t.numpy() for t in fused._schedule(index, rows_per_tile))
    bounds = np.append(items[:, 0], items[-1, 1])
    assert np.array_equal(items[:, 2:], np.stack([indptr[bounds[:-1]], indptr[bounds[1:]]], 1))
    assert bounds[0] == 0 and bounds[-1] == n and np.all(np.diff(bounds) > 0)
    rows = indptr[bounds[1:]] - indptr[bounds[:-1]]
    buses = np.diff(bounds)
    assert np.all(((rows <= rows_per_tile) & (buses <= rows_per_tile)) | (buses == 1))
    # the items' row ranges tile [0, E) in order, and each row's bus is its own
    covered = np.concatenate([np.arange(indptr[b0], indptr[b1])
                              for b0, b1 in zip(bounds[:-1], bounds[1:])])
    assert np.array_equal(covered, np.arange(len(dst)))
    assert np.array_equal(row_bus >> 1, np.asarray(dst)[order])
    last = np.zeros(len(dst), bool)
    last[indptr[1:][np.diff(indptr) > 0] - 1] = True
    assert np.array_equal(row_bus & 1, last.astype(np.int32))
    if case == "hub":
        assert rows.max() > rows_per_tile and buses[rows.argmax()] == 1


@pytest.mark.parametrize("case", [14, 30, 300, "hub"])
def test_k3_schedule_covers_the_dst_csr(case):
    """K3's work items cover every dst-CSR row exactly once, in CSR order,
    each bus in one item; an item holds at most 64 rows (two per lane) and
    64 buses, unless it is a single bus with more rows."""
    _check_schedule(case, fused.ROWS)


@pytest.mark.parametrize("case", [14, 30, 300, "hub"])
def test_k3_wide_schedule_covers_the_dst_csr(case):
    """The same for the wide design's work items (segment_kernels.k3_rows
    16 past (33, 24)'s register footprint): at most 16 rows and 16 buses
    an item, or one bus with more; made apart from the 64-row ones."""
    _check_schedule(case, fused.WIDE_ROWS)
    index = SegmentIndex(*_dst(case))
    assert fused._schedule(index, fused.WIDE_ROWS)[0] is fused._schedule(index, fused.WIDE_ROWS)[0]
    assert fused._schedule(index)[0].shape[0] <= fused._schedule(index, fused.WIDE_ROWS)[0].shape[0]
    assert kern.k3_rows(33, 24) == fused.ROWS and kern.k3_rows(34, 24) == fused.WIDE_ROWS
    assert kern.k3_rows(20, 10) == kern.k3_rows(40, 10) == fused.ROWS
    assert {kern.k3_rows(*w) for w in ((64, 32), (97, 40), (128, 128))} == {fused.WIDE_ROWS}


def _k3_aggregate(x, index: SegmentIndex, rows_per_tile=fused.ROWS):
    """fused_edge.cu's sums, emulated: per item, a one-tile item stages its
    rows and each bus's lanes add the bus's rows in row order from 0.0f;
    a hub item adds its tiles' rows in order, carrying the sum across
    tiles. float32 throughout, as the kernel (either design: the register
    one at 64 rows, a lane a bus; the wide one at 16, a lane a column)."""
    items, _ = fused._schedule(index, rows_per_tile)
    order, indptr = index.order.numpy(), index.indptr.numpy()
    out = torch.zeros((x.shape[0], index.n, x.shape[2]), dtype=torch.float32)
    for b0, b1, r0, r1 in items.tolist():
        if r1 - r0 <= rows_per_tile:
            buf = x[:, order[r0:r1]]
            for b in range(b0, b1):
                acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32)
                for r in range(indptr[b] - r0, indptr[b + 1] - r0):
                    acc = acc + buf[:, r]
                out[:, b] = acc
        else:
            acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32)
            for t in range(r0, r1, rows_per_tile):
                buf = x[:, order[t:min(t + rows_per_tile, r1)]]
                for k in range(buf.shape[1]):
                    acc = acc + buf[:, k]
            out[:, b0] = acc
    return out


@pytest.mark.parametrize("case", [14, 30, 300, "hub"])
def test_k3_order_of_adds_equals_segment_sum(case):
    """The kernel's per-item order of adds gives segment_sum_plain's sums
    bit for bit, a 70-edge hub bus and buses with no edge included."""
    dst, n = _dst(case)
    index = SegmentIndex(dst, n)
    x = torch.as_tensor(np.random.default_rng(11).standard_normal((3, len(dst), 20)),
                        dtype=torch.float32)
    assert torch.equal(_k3_aggregate(x, index),
                       kern.segment_sum_plain(x, index.order, index.indptr, index.n))


@pytest.mark.parametrize("case", [14, 30, 300, "hub"])
def test_k3_wide_order_of_adds_equals_segment_sum(case):
    """The same for the wide design's 16-row items at an odd width past 32
    columns (97: a lane sums columns c, c + 32, c + 64 and c + 96 < 97)."""
    dst, n = _dst(case)
    index = SegmentIndex(dst, n)
    x = torch.as_tensor(np.random.default_rng(12).standard_normal((2, len(dst), 97)),
                        dtype=torch.float32)
    assert torch.equal(_k3_aggregate(x, index, fused.WIDE_ROWS),
                       kern.segment_sum_plain(x, index.order, index.indptr, index.n))


@pytest.mark.parametrize("latent, hidden", [(20, 10), (8, 8), (12, 6), (40, 10), (10, 10),
                                            (33, 24), (97, 40), (128, 128), (256, 256), (512, 64)])
def test_k3_packed_weights_unpack_exactly(latent, hidden):
    """pack_weights lays the 18 weights out as fused_edge.cu's Pack reads
    them: per head w1, b1, w2, b2, w4, b4, each matrix transposed to (in,
    out) and every row padded with zeros to a multiple of 4 floats (so each
    starts on a 16-byte word); unpacking gives _weights(heads) exactly."""
    sp = {h: jax.tree.map(np.asarray, init_learning_block(jax.random.key(i), latent + 5, hidden,
                                                          latent))
          for i, h in enumerate(fused.PHI_HEADS)}
    heads = heads_from_jax(sp, device="cpu")
    packed = fused.pack_weights(fused._weights(heads), latent, hidden)
    r4 = lambda v: -(-v // 4) * 4  # noqa: E731
    f = latent + 5
    size = (f + 1) * r4(hidden) + (hidden + 1) * r4(hidden) + (hidden + 1) * r4(latent)
    assert packed.dtype == torch.float32 and packed.shape == (3 * size,)
    off = 0
    for h in fused.PHI_HEADS:
        for wn, bn in (("w1", "b1"), ("w2", "b2"), ("w4", "b4")):
            w, b = heads[h][wn], heads[h][bn]
            out, inp = w.shape
            block = packed[off:off + (inp + 1) * r4(out)].view(inp + 1, r4(out))
            assert off % 4 == 0
            assert torch.equal(block[:inp, :out], w.t()) and torch.equal(block[inp, :out], b)
            assert torch.all(block[:, out:] == 0)
            off += (inp + 1) * r4(out)
    assert off == packed.numel() == kern.k3_pack_floats(latent, hidden)
    idx = fused.pack_index(latent, hidden)
    assert np.array_equal(np.sort(idx[idx >= 0]), np.arange(sum(w.numel() for w in
                                                                   fused._weights(heads))))


# ---- K3: the design at each width fits a block --------------------------

GRID = (1, 2, 7, 8, 10, 20, 24, 33, 40, 41, 64, 97, 128, 129, 136, 160, 200, 256, 300, 384, 511,
        512)


@pytest.mark.parametrize("latent", GRID)
def test_designs_fit_a_block_at_every_width(latent):
    """At every (latent, hidden) of GRID x GRID, up to (512, 512), K3's
    design (segment_kernels.k3_design: the register design up to 172
    register floats, the wide one while four warps' scratch fits a block,
    else the workspace, which takes no shared memory) takes at most a
    block's 232,448 bytes, and the width passes check_width at case300's
    S x N and S x E for S = 1024. K4's plans are its library's answer
    (megakernel.cu Layout, gns_megakernel_plan), with no copy in Python:
    chip_smoke.py holds that a case300 grid fits one at each of its
    widths."""
    for hidden in GRID:
        design = kern.k3_design(latent, hidden)
        block = kern.k3_block_bytes(latent, hidden)
        assert block <= kern.MAX_SHARED_BYTES, (latent, hidden, design, block)
        assert (design == "registers") == (2 * (latent + 5) + 4 * hidden <= kern.K3_REGISTER_FLOATS)
        assert (design == "workspace") == (block == 0)
        wide = kern.K3_WARPS * kern.k3_warp_floats(latent, hidden) * 4
        if design != "registers":
            assert (design == "wide") == (wide <= kern.MAX_SHARED_BYTES) and block in (0, wide)
        assert kern.k3_rows(latent, hidden) == (fused.ROWS if design == "registers" else fused.WIDE_ROWS)
        assert kern.min_blocks("fused_edge", latent, hidden) == {
            "wide": 4, "workspace": 3}.get(design, kern.min_blocks("fused_edge", latent, hidden))
        assert kern.min_blocks("fused_edge", latent, hidden) in (2, 3, 4)
        kern.check_width(latent, hidden, 1024 * 300, 1024 * 411)


def test_k4_step_offsets_are_checked():
    """check_width counts K4's packed step from megakernel.tile_dims (16 x
    8 bf16 tiles a step): at (40000, 4000) the step holds 2,176,448,000
    elements, past 2^31, while K3's packed weights (1,008,204,000 floats)
    are not, so the refusal names K4's step; at (12000, 12000) K4's step
    (2,737,344,000) is refused first too."""
    from gns_torch.ops import megakernel as mk

    for latent, hidden in ((40000, 4000), (12000, 12000)):
        tiles = mk.tile_dims(latent, hidden).tiles[-1]
        assert tiles * 128 >= kern.INDEX_LIMIT > kern.k3_pack_floats(latent, hidden)
        with pytest.raises(ValueError, match=f"K4's packed step at .* is {tiles * 128} elements"):
            kern.check_width(latent, hidden)
    kern.check_width(60000, 1)  # both packs under 2^31
    assert mk.tile_dims(60000, 1).tiles[-1] * 128 < kern.INDEX_LIMIT
