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
CFG = GNSConfig(K=4, latent_dim=LAT, hidden_dim=HID, multiple_phi=True, reference_parity=True)
JCFG = JConfig(K=4, latent_dim=LAT, hidden_dim=HID, multiple_phi=True, reference_parity=True)
# tile offsets and padded bias offsets of megakernel.cu's Dims<20, 10>
T_PW1, T_PW2, T_PW4, T_LW1, T_LW2, T_LW4, N_TILES = 0, 12, 18, 27, 45, 51, 56
B_PB1, B_PB2, B_PB4, B_LB1, B_LB2, B_LB4, N_BIAS = 0, 48, 96, 168, 216, 264, 304
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _packs(seed=0):
    params = init_gns_params(jax.random.key(seed), JCFG)
    model = module_from_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")
    fused = step_params(model, CFG.replace(fused_heads=True, fold_output="off"))
    wpack, bpack = mk.pack_step_weights(fused, LAT, HID)
    return fused, wpack, bpack


def _b(tiles, t):
    """Tile t (32 lanes x 4 bf16) as the (16 k, 8 n) float32 B operand."""
    lane = torch.arange(32)
    out = torch.zeros(16, 8)
    for q, dk in enumerate((0, 1, 8, 9)):
        out[2 * (lane % 4) + dk, lane // 4] = tiles[t, :, q].float()
    return out


def _unpack(wrow, brow):
    """One step's tiles and padded biases back to the fused layout
    {"phi_fused": {w1, b1, ...}, "L_fused": {...}}: bf16 weights, float32
    biases, zero wherever no tile slot lands (the block-diagonal zeros)."""
    widx, bidx = mk._tile_plan(LAT, HID)
    shapes = mk._fused_shapes(LAT, HID)
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


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_gives_fused_bf16_weights(seed):
    """Unpacking the tiles gives step_params' bf16 fused weights exactly:
    the per-head blocks, the block-diagonal zeros, the padding and L w1's
    column selection. Every fused weight lands in at most one slot, and the
    slots hold exactly the heads' own weights (1650 per edge, 1840 per bus)."""
    fused, wpack, bpack = _packs(seed)
    assert wpack.shape == (CFG.K, N_TILES * 128) and bpack.shape == (CFG.K, N_BIAS)
    for k, st in enumerate(fused):
        back = _unpack(wpack[k], bpack[k])
        for head in ("phi_fused", "L_fused"):
            for n, t in st[head].items():
                want = t.to(torch.bfloat16) if n.startswith("w") else t
                assert torch.equal(back[head][n], want), (k, head, n)
    widx, bidx = mk._tile_plan(LAT, HID)
    kept = widx[widx >= 0]
    assert kept.size == np.unique(kept).size == 1650 + 1840
    assert bidx[bidx >= 0].size == np.unique(bidx[bidx >= 0]).size == 3 * (HID + HID + LAT) \
        + 3 * HID + 3 * HID + 2 + LAT


@pytest.mark.parametrize("case", [14, 30])
def test_tile_products_match_dense_mlp(case):
    """A torch emulation of the kernel's per-head, padded tile products on
    the packed operands equals the twin's dense-layout mlp layer by layer
    (pre-activation, on the twin's own bf16 activations) within float32
    rounding, on every step's weights; the edge and node rows are case
    grids' sizes with seeded inputs."""
    fused, wpack, bpack = _packs()
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
        xp = torch.nn.functional.pad(x, (0, 32 - x.shape[1]))
        for nt in range(6):
            head, half = divmod(nt, 2)
            got = sum(xp[:, 16 * kt:16 * kt + 16] @ _b(tiles, T_PW1 + nt * 2 + kt) for kt in range(2))
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
            got = torch.cat([a @ _b(tiles, T_PW4 + h * 3 + nt) for nt in range(3)], 1)
            got = (got + bias[B_PB4 + 24 * h:B_PB4 + 24 * h + 24])[:, :LAT]
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
        out_tiles = ([T_LW4], [T_LW4 + 1], [T_LW4 + 2 + nt for nt in range(3)])
        out_bias = (B_LB4, B_LB4 + 8, B_LB4 + 16)
        for h, blk in enumerate((1, 0, 2)):
            xi = torch.cat([x[:, :4 + LAT], x[:, 4 + LAT + blk * LAT:4 + LAT + (blk + 1) * LAT]], 1)
            xi = torch.nn.functional.pad(xi, (0, 48 - xi.shape[1]))
            got = torch.cat([sum(xi[:, 16 * kt:16 * kt + 16] @ _b(tiles, T_LW1 + (h * 2 + nt) * 3 + kt)
                                 for kt in range(3)) for nt in range(2)], 1)
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
