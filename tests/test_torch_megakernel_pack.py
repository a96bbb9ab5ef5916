"""gns_torch K4's operand layout on the CPU: the tile-packed weights, a torch
emulation of the kernel's per-head padded tile products, and the dst-CSR
work items of its in-kernel aggregate.

The CUDA kernel (gns_torch/csrc/megakernel.cu) runs only on the card; what
it reads is laid out by gns_torch/ops/megakernel.py, which these tests
reach. The weights are gns_tpu's `init_gns_params` carried across with
module_from_jax_params.

Tolerance of the tile products: the emulation multiplies the same bf16
operands as the twin's dense-layout `mlp`, per head and zero-padded, in
float32; only the order of the adds differs, so each output agrees within
1e-6 of the sum of its terms' magnitudes (float32 rounding over <= 48
adds)."""

import numpy as np
import pytest
import torch

import jax

from gns_tpu.models.gns import init_gns_params
from gns_tpu.utils.config import GNSConfig as JConfig
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.gns import step_params
from gns_torch.ops import megakernel as mk
from gns_torch.ops.segment import SegmentIndex, schedule_items
from gns_torch.ops.segment_kernels import segment_sum_plain
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import base_case_batch, batch_from_cases, extract_shared_topology

torch.set_num_threads(1)
LAT, HID = 20, 10
# tile offsets (phi w1, w2, w4, L w1, w2, w4, count) and padded bias offsets
# (the same, then the count) of megakernel.cu's Dims<L, H>, by (L, H)
DIMS = {
    (20, 10): ((0, 12, 18, 27, 45, 51, 56), (0, 48, 96, 168, 216, 264, 304)),
    (40, 10): ((0, 18, 24, 39, 75, 81, 88), (0, 48, 96, 216, 264, 312, 368)),
}
RTOL = 1e-6


def _cfgs(lat, hid):
    kw = dict(K=4, latent_dim=lat, hidden_dim=hid, multiple_phi=True, reference_parity=True)
    return GNSConfig(**kw), JConfig(**kw)


CFG, JCFG = _cfgs(LAT, HID)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _packs(seed=0, lat=LAT, hid=HID):
    cfg, jcfg = _cfgs(lat, hid)
    params = init_gns_params(jax.random.key(seed), jcfg)
    model = module_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    fused = step_params(model, cfg.replace(fused_heads=True, fold_output="off"))
    wpack, bpack = mk.pack_step_weights(fused, lat, hid)
    return fused, wpack, bpack


def _b(tiles, t):
    """Tile t (32 lanes x 4 bf16) as the (16 k, 8 n) float32 B operand."""
    lane = torch.arange(32)
    out = torch.zeros(16, 8)
    for q, dk in enumerate((0, 1, 8, 9)):
        out[2 * (lane % 4) + dk, lane // 4] = tiles[t, :, q].float()
    return out


def _unpack(wrow, brow, lat=LAT, hid=HID):
    """One step's tiles and padded biases back to the fused layout
    {"phi_fused": {w1, b1, ...}, "L_fused": {...}}: bf16 weights, float32
    biases, zero wherever no tile slot lands (the block-diagonal zeros)."""
    widx, bidx = mk._tile_plan(lat, hid)
    shapes = mk._fused_shapes(lat, hid)
    flat = {}
    for idx, row, n, dtype in ((widx, wrow, sum(o * i for _, _, (o, i) in shapes), torch.bfloat16),
                               (bidx, brow, sum(o for _, _, (o, _) in shapes), torch.float32)):
        flat[dtype] = torch.zeros(n, dtype=dtype)
        keep = idx >= 0
        flat[dtype][torch.as_tensor(idx[keep])] = row[torch.as_tensor(keep)]
    steps, wo, bo = {"phi_fused": {}, "L_fused": {}}, 0, 0
    for head, w, (o, i) in shapes:
        steps[head][w] = flat[torch.bfloat16][wo:wo + o * i].view(o, i)
        steps[head]["b" + w[1:]] = flat[torch.float32][bo:bo + o]
        wo, bo = wo + o * i, bo + o
    return steps


def _bf(x):
    return x.to(torch.bfloat16).float()


def _close(got, want, x, w):
    """|got - want| <= RTOL * (|x| @ |w|^T) + tiny: float32 rounding of a
    sum of products, relative to the sum of their magnitudes."""
    scale = x.abs() @ w.float().abs().t()
    assert torch.all((got - want).abs() <= RTOL * scale + 1e-30), float((got - want).abs().max())


def _check_unpack(seed, lat, hid):
    """Unpacking the tiles gives step_params' bf16 fused weights exactly,
    and the slots hold each of the heads' own weights once."""
    (_, _, _, _, _, _, n_tiles), (*_, n_bias) = DIMS[(lat, hid)]
    fused, wpack, bpack = _packs(seed, lat, hid)
    assert wpack.shape == (CFG.K, n_tiles * 128) and bpack.shape == (CFG.K, n_bias)
    for k, st in enumerate(fused):
        back = _unpack(wpack[k], bpack[k], lat, hid)
        for head in ("phi_fused", "L_fused"):
            for n, t in st[head].items():
                want = t.to(torch.bfloat16) if n.startswith("w") else t
                assert torch.equal(back[head][n], want), (k, head, n)
    widx, bidx = mk._tile_plan(lat, hid)
    kept = widx[widx >= 0]
    per_edge = 3 * (hid * (lat + 5) + hid * hid + lat * hid)
    per_bus = 3 * hid * (4 + 2 * lat) + 3 * hid * hid + hid * (2 + lat)
    assert kept.size == np.unique(kept).size == per_edge + per_bus
    assert bidx[bidx >= 0].size == np.unique(bidx[bidx >= 0]).size == 3 * (hid + hid + lat) \
        + 3 * hid + 3 * hid + 2 + lat


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_gives_fused_bf16_weights(seed):
    """Unpacking the tiles gives step_params' bf16 fused weights exactly:
    the per-head blocks, the block-diagonal zeros, the padding and L w1's
    column selection. Every fused weight lands in at most one slot, and the
    slots hold exactly the heads' own weights (1650 per edge, 1840 per bus)."""
    _check_unpack(seed, LAT, HID)


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_gives_fused_bf16_weights_at_40_10(seed):
    """The same at (L, H) = (40, 10), the deep checkpoints' width and
    megakernel.cu's Dims<40, 10> (88 tiles, 368 biases): 5850 weights per
    edge, 4140 per bus."""
    _check_unpack(seed, 40, 10)


def _check_tile_products(case, lat, hid):
    (T_PW1, T_PW2, T_PW4, T_LW1, T_LW2, T_LW4, N_TILES), \
        (B_PB1, B_PB2, B_PB4, B_LB1, B_LB2, B_LB4, _) = DIMS[(lat, hid)]
    LAT, HID = lat, hid  # noqa: N806 (the widths under test)
    kp, kl, nl = -(-(LAT + 5) // 16), -(-(4 + 2 * LAT) // 16), -(-LAT // 8)
    fused, wpack, bpack = _packs(0, lat, hid)
    batch = base_case_batch(case)
    n_bus, n_line = batch.buses.shape[1], batch.lines.shape[1]
    rng = np.random.default_rng(case)
    for k, st in enumerate(fused):
        tiles = wpack[k].view(N_TILES, 32, 4)
        bias = bpack[k]
        phi, lay = st["phi_fused"], st["L_fused"]
        w = {h: {n: t.to(torch.bfloat16).float() if n.startswith("w") else t for n, t in p.items()}
             for h, p in (("phi", phi), ("L", lay))}

        # phi: edge rows, input (E, L + 5)
        x = _bf(torch.as_tensor(rng.standard_normal((n_line, LAT + 5)), dtype=torch.float32))
        ref1 = x @ w["phi"]["w1"].t() + w["phi"]["b1"]
        xp = torch.nn.functional.pad(x, (0, 16 * kp - x.shape[1]))
        for nt in range(6):
            head, half = divmod(nt, 2)
            got = sum(xp[:, 16 * kt:16 * kt + 16] @ _b(tiles, T_PW1 + nt * kp + kt)
                      for kt in range(kp))
            got = got + bias[B_PB1 + nt * 8:B_PB1 + nt * 8 + 8]
            cols = slice(head * HID + half * 8, head * HID + min(half * 8 + 8, HID))
            n_real = cols.stop - cols.start
            _close(got[:, :n_real], ref1[:, cols], x, w["phi"]["w1"][cols])
            assert torch.equal(got[:, n_real:], bias[B_PB1 + nt * 8 + n_real:B_PB1 + nt * 8 + 8]
                               .expand(got.shape[0], -1))
        h1 = _bf(torch.where(ref1 >= 0, ref1, 0.01 * ref1))
        ref2 = h1 @ w["phi"]["w2"].t() + w["phi"]["b2"]
        h2 = _bf(torch.where(ref2 >= 0, ref2, 0.01 * ref2))
        ref4 = h2 @ w["phi"]["w4"].t() + w["phi"]["b4"]
        for h in range(3):
            a = torch.nn.functional.pad(h1[:, h * HID:(h + 1) * HID], (0, 16 - HID))
            got = torch.cat([a @ _b(tiles, T_PW2 + h * 2 + nt) for nt in range(2)], 1)
            got = (got + bias[B_PB2 + 16 * h:B_PB2 + 16 * h + 16])[:, :HID]
            rows = slice(h * HID, (h + 1) * HID)
            _close(got, ref2[:, rows], h1, w["phi"]["w2"][rows])
            a = torch.nn.functional.pad(h2[:, h * HID:(h + 1) * HID], (0, 16 - HID))
            got = torch.cat([a @ _b(tiles, T_PW4 + h * nl + nt) for nt in range(nl)], 1)
            got = (got + bias[B_PB4 + 8 * nl * h:B_PB4 + 8 * nl * (h + 1)])[:, :LAT]
            rows = slice(h * LAT, (h + 1) * LAT)
            _close(got, ref4[:, rows], h2, w["phi"]["w4"][rows])

        # L: bus rows, input (N, 4 + 4L) = v, theta, dp, dq, m, the three aggregates
        x = _bf(torch.as_tensor(rng.standard_normal((n_bus, 4 + 4 * LAT)), dtype=torch.float32))
        ref1 = x @ w["L"]["w1"].t() + w["L"]["b1"]
        h1 = _bf(torch.where(ref1 >= 0, ref1, 0.01 * ref1))
        ref2 = h1 @ w["L"]["w2"].t() + w["L"]["b2"]
        h2 = _bf(torch.where(ref2 >= 0, ref2, 0.01 * ref2))
        ref4 = h2 @ w["L"]["w4"].t() + w["L"]["b4"]
        out_rows = (slice(0, 1), slice(1, 2), slice(2, 2 + LAT))
        out_tiles = ([T_LW4], [T_LW4 + 1], [T_LW4 + 2 + nt for nt in range(nl)])
        out_bias = (B_LB4, B_LB4 + 8, B_LB4 + 16)
        for h, blk in enumerate((1, 0, 2)):
            xi = torch.cat([x[:, :4 + LAT], x[:, 4 + LAT + blk * LAT:4 + LAT + (blk + 1) * LAT]], 1)
            xi = torch.nn.functional.pad(xi, (0, 16 * kl - xi.shape[1]))
            got = torch.cat([sum(xi[:, 16 * kt:16 * kt + 16] @ _b(tiles, T_LW1 + (h * 2 + nt) * kl + kt)
                                 for kt in range(kl)) for nt in range(2)], 1)
            got = (got + bias[B_LB1 + 16 * h:B_LB1 + 16 * h + 16])[:, :HID]
            rows = slice(h * HID, (h + 1) * HID)
            _close(got, ref1[:, rows], x, w["L"]["w1"][rows])
            a = torch.nn.functional.pad(h1[:, rows], (0, 16 - HID))
            got = torch.cat([a @ _b(tiles, T_LW2 + h * 2 + nt) for nt in range(2)], 1)
            got = (got + bias[B_LB2 + 16 * h:B_LB2 + 16 * h + 16])[:, :HID]
            _close(got, ref2[:, rows], h1, w["L"]["w2"][rows])
            a = torch.nn.functional.pad(h2[:, rows], (0, 16 - HID))
            got = torch.cat([a @ _b(tiles, t) for t in out_tiles[h]], 1)
            width = out_rows[h].stop - out_rows[h].start
            got = got[:, :width] + bias[out_bias[h]:out_bias[h] + width]
            _close(got, ref4[:, out_rows[h]], h2, w["L"]["w4"][out_rows[h]])


@pytest.mark.parametrize("case", [14, 30])
def test_tile_products_match_dense_mlp(case):
    """A torch emulation of the kernel's per-head, padded tile products on
    the packed operands equals the twin's dense-layout mlp layer by layer
    (pre-activation, on the twin's own bf16 activations) within float32
    rounding, on every step's weights; the edge and node rows are case
    grids' sizes with seeded inputs."""
    _check_tile_products(case, LAT, HID)


@pytest.mark.parametrize("case", [14, 30])
def test_tile_products_match_dense_mlp_at_40_10(case):
    """The same tile products at (L, H) = (40, 10): phi's first layer over
    3 k-tiles, L's over 6, 5 n-tiles of each 40-wide output."""
    _check_tile_products(case, 40, 10)


def _kernel_aggregate(x, index: SegmentIndex):
    """The kernel's in-block aggregate, emulated: work items of whole buses,
    their dst-CSR rows in 16-row tiles; one running float32 sum from 0, in
    row order, stored at a row flagged as its bus's last and reset there, so
    a bus spanning tiles carries its sum across them; a bus with no line
    keeps its zeros."""
    items, row_bus = schedule_items(index.indptr.numpy(), mk.ROWS)
    order = index.order.numpy()
    out = torch.zeros((x.shape[0], index.n, x.shape[2]), dtype=torch.float32)
    for _, _, r0, r1 in items.tolist():
        acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32)
        for row0 in range(r0, r1, 16):
            for j in range(row0, min(row0 + 16, r1)):
                acc = acc + x[:, order[j]]
                if row_bus[j] & 1:
                    out[:, row_bus[j] >> 1] = acc
                    acc = torch.zeros_like(acc)
        assert not acc.any()  # an item ends on a bus's last row
    return out


@pytest.mark.parametrize("case", [14, 30, 300, "hub"])
def test_dst_order_aggregate_equals_segment_sum(case):
    """The in-kernel aggregate's order (work items over the dst CSR) gives
    segment_sum_plain's result bit for bit, on the case grids' dst index
    and on a made-up one whose hub bus has 40 in-edges (an item spanning
    three tiles) beside buses with none."""
    if case == "hub":
        rng = np.random.default_rng(3)
        dst = np.concatenate([np.full(40, 5), rng.integers(0, 30, 60)])
        rng.shuffle(dst)
        n = 32
    else:
        batch = batch_from_cases(list(generate_cases(case, 1, seed=0)))
        dst, n = extract_shared_topology(batch).dst, batch.buses.shape[1]
    index = SegmentIndex(dst, n, "cpu")
    items, row_bus = schedule_items(index.indptr.numpy(), mk.ROWS)
    assert np.array_equal(row_bus >> 1, index.ids.numpy()[index.order.numpy()])
    bounds = np.append(items[:, 0], items[-1, 1])
    assert bounds[0] == 0 and bounds[-1] == n and np.all(np.diff(bounds) > 0)
    indptr = index.indptr.numpy()
    assert np.array_equal(items[:, 2:], np.stack([indptr[bounds[:-1]], indptr[bounds[1:]]], 1))
    rows = items[:, 3] - items[:, 2]
    assert np.all(np.diff(bounds) <= 16)  # at most 16 buses: one L tile
    assert np.all((rows <= 16) | (np.diff(bounds) == 1))  # 16 rows, or one hub bus
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((3, len(dst), 3 * LAT)),
                        dtype=torch.float32)
    assert torch.equal(_kernel_aggregate(x, index),
                       segment_sum_plain(x, index.order, index.indptr, index.n))


def _lane_aggregate(x, index: SegmentIndex, width: int):
    """megakernel.cu's aggregate with its lane layout: lane c of the warp
    keeps running sums of columns c, c + 32, ... (Dims::NA of them) of the
    3L-wide phi outputs, adding a 16-row tile's rows in order and storing
    at each bus's last row. Returns the sums and how often each column was
    written per bus row."""
    items, row_bus = schedule_items(index.indptr.numpy(), mk.ROWS)
    order = index.order.numpy()
    na = -(-width // 32)
    out = torch.zeros((x.shape[0], index.n, width), dtype=torch.float32)
    seen = np.zeros((index.n, width), np.int64)
    for _, _, r0, r1 in items.tolist():
        acc = [[torch.zeros(x.shape[0]) for _ in range(na)] for _ in range(32)]
        for row0 in range(r0, r1, 16):
            for j in range(row0, min(row0 + 16, r1)):
                for lane in range(32):
                    for a in range(na):
                        col = 32 * a + lane
                        if col >= width:
                            continue
                        acc[lane][a] = acc[lane][a] + x[:, order[j], col]
                        if row_bus[j] & 1:
                            out[:, row_bus[j] >> 1, col] = acc[lane][a]
                            seen[row_bus[j] >> 1, col] += 1
                            acc[lane][a] = torch.zeros(x.shape[0])
    return out, seen


@pytest.mark.parametrize("case", [14, 30, "hub"])
def test_dst_order_aggregate_at_l40_equals_segment_sum(case):
    """At L = 40 each lane sums four of the aggregate's 120 columns (c, c +
    32, c + 64 and, for lanes below 24, c + 96): every column of every bus
    with lines is stored once, and the sums equal segment_sum_plain bit for
    bit, a 40-edge hub bus over three tiles included."""
    if case == "hub":
        rng = np.random.default_rng(3)
        dst = np.concatenate([np.full(40, 5), rng.integers(0, 30, 60)])
        rng.shuffle(dst)
        n = 32
    else:
        batch = batch_from_cases(list(generate_cases(case, 1, seed=0)))
        dst, n = extract_shared_topology(batch).dst, batch.buses.shape[1]
    index = SegmentIndex(dst, n, "cpu")
    width = 3 * 40
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((2, len(dst), width)),
                        dtype=torch.float32)
    got, seen = _lane_aggregate(x, index, width)
    has_lines = np.diff(index.indptr.numpy()) > 0
    assert np.all(seen[has_lines] == 1) and np.all(seen[~has_lines] == 0)
    assert torch.equal(got, segment_sum_plain(x, index.order, index.indptr, index.n))
