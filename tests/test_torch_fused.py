"""gns_torch K3, the fused edge stage, on the CPU against gns_tpu's
`fused_edge_stage` in interpret mode (tests/test_fused.py's problem: S3,
N14, E20), at every (L, H) of WIDTHS: gns_tpu's own test width (8, 8), the
reference's default (10, 10), an odd L with H > 16 (33, 24), the shipped
checkpoints' (20, 10) and (40, 10), three widths of the kernel's wide
design: (64, 32), (97, 40) (an odd L over 64, H over two k-tiles) and
(128, 128), and (160, 136), past 128 on both axes.

On the CPU the port's fused_edge_stage is its plain twin (gather_plain,
F.linear, segment_sum_plain). The CUDA kernel runs only on the card, where
chip_smoke.py holds it against this twin; here the CUDA wrapper must refuse
CPU tensors. Tolerances: forward rtol 1e-5 / atol 1e-6 (exact float32 on
both sides, sums in another order), gradients rtol 2e-4 / atol 1e-5
(tests/test_fused.py:61)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gns_tpu.models.blocks import init_learning_block
from gns_tpu.ops.pallas_fused import fused_edge_stage as j_fused_edge_stage
from gns_torch.models.convert import heads_from_jax
from gns_torch.ops import fused
from gns_torch.ops.fused import fused_edge_cuda, fused_edge_stage, fused_edge_stage_plain
from gns_torch.ops.segment import SegmentIndex

torch.set_num_threads(1)
S, N, E = 3, 14, 20
WIDTHS = [(8, 8), (10, 10), (33, 24), (20, 10), (40, 10), (64, 32), (97, 40), (128, 128),
          (160, 136)]
SLOPE = 0.01
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=1e-5)
HEADS = ("phi_v", "phi_theta", "phi_m")


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda w: f"L{w[0]}_H{w[1]}")
def problem(request):
    L, H = request.param  # noqa: N806 (the width under test)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((S, N, L)).astype(np.float32)
    feats = rng.standard_normal((S, E, 5)).astype(np.float32)
    mask = np.ones((S, E), np.float32)
    mask[:, -2:] = 0.0
    mask[1, 3] = 0.0
    seg = rng.integers(0, N, E).astype(np.int32)
    sp = {
        h: jax.tree.map(np.asarray, init_learning_block(jax.random.key(i + 3), L + 5, H, L))
        for i, h in enumerate(HEADS)
    }
    return m, feats, mask, seg, sp


def _torch(problem, requires_grad=False):
    m, feats, mask, seg, sp = problem
    heads = heads_from_jax(sp, device="cpu")
    t = [torch.tensor(a, requires_grad=requires_grad) for a in (m, feats, mask)]
    if requires_grad:
        for p in heads.values():
            for w in p.values():
                w.requires_grad_(True)
    return (*t, SegmentIndex(seg, N), heads)


def test_k3_plain_matches_pallas_interpret(problem):
    m, feats, mask, seg, sp = problem
    L = m.shape[-1]  # noqa: N806
    ref = j_fused_edge_stage(jnp.asarray(m), jnp.asarray(feats), jnp.asarray(mask),
                             jnp.asarray(seg), sp, SLOPE, True)
    tm, tf, tmask, idx, heads = _torch(problem)
    for out in (fused_edge_stage(tm, tf, tmask, idx, heads, SLOPE),
                fused_edge_stage_plain(tm, tf, tmask, idx, heads, SLOPE)):
        assert len(out) == 3
        for o, r in zip(out, ref):
            assert o.shape == (S, N, L) and o.dtype == torch.float32
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **FWD)


def test_k3_respects_mask(problem):
    """Masked edges contribute nothing: zeroing their features, or dropping
    them from the index, leaves the sums as they are."""
    m, feats, mask, seg, sp = problem
    tm, tf, tmask, idx, heads = _torch(problem)
    out = fused_edge_stage(tm, tf, tmask, idx, heads, SLOPE)
    out2 = fused_edge_stage(tm, tf * tmask[..., None], tmask, idx, heads, SLOPE)
    for a, b in zip(out, out2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)
    keep = np.arange(E - 2)  # the last two edges are masked in every sample
    out3 = fused_edge_stage(tm, tf[:, keep], tmask[:, keep], SegmentIndex(seg[keep], N),
                            heads, SLOPE)
    for a, b in zip(out, out3):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD)


def _jax_grads(problem):
    m, feats, mask, seg, sp = problem

    def loss(mm, ff, lm, sp_):
        o = j_fused_edge_stage(mm, ff, lm, jnp.asarray(seg), sp_, SLOPE, True)
        return sum((x ** 2).sum() for x in o)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(jnp.asarray(m), jnp.asarray(feats),
                                                jnp.asarray(mask), sp)


def _check_grads(problem, tm, tf, tmask, heads):
    dm, dfeats, dmask, dsp = _jax_grads(problem)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(dm), **GRAD)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(dfeats), **GRAD)
    np.testing.assert_allclose(tmask.grad.numpy(), np.asarray(dmask), **GRAD)
    for h in HEADS:
        for n, w in heads[h].items():
            want = np.asarray(dsp[h][n])
            got = w.grad.numpy()
            np.testing.assert_allclose(got.T if n.startswith("w") else got, want,
                                       err_msg=f"{h}.{n}", **GRAD)


def test_k3_grads_match_jax_grad(problem):
    """Gradients of m, feats, line_mask and all 18 weights against jax.grad
    through gns_tpu's custom VJP."""
    tm, tf, tmask, idx, heads = _torch(problem, requires_grad=True)
    out = fused_edge_stage(tm, tf, tmask, idx, heads, SLOPE)
    sum((x ** 2).sum() for x in out).backward()
    _check_grads(problem, tm, tf, tmask, heads)


def test_k3_autograd_function_recomputes_through_the_primitives(problem, monkeypatch):
    """The card's autograd.Function, with the kernel's launch stood in for by
    its plain twin: its backward (a recompute through ops/segment.py's
    gather / segment_sum, which are K2 / K1 on the card) gives jax.grad's
    gradients, and None for what needs none."""
    def stand_in(m, feats, line_mask, index, weights, slope):
        return fused._edge_stage(m, feats, line_mask, weights, slope,
                                 lambda x: x.index_select(1, index.ids.long()),
                                 lambda x: fused.kern.segment_sum_plain(
                                     x, index.order, index.indptr, index.n))

    monkeypatch.setattr(fused, "fused_edge_cuda", stand_in)
    tm, tf, tmask, idx, heads = _torch(problem, requires_grad=True)
    out = fused._FusedEdgeK3.apply(SLOPE, idx, tm, tf, tmask, *fused._weights(heads))
    sum((x ** 2).sum() for x in out).backward()
    _check_grads(problem, tm, tf, tmask, heads)

    tm2, tf2, tmask2, _, heads2 = _torch(problem)
    tm2.requires_grad_(True)
    out = fused._FusedEdgeK3.apply(SLOPE, idx, tm2, tf2, tmask2, *fused._weights(heads2))
    out[0].sum().backward()
    assert tm2.grad is not None and tf2.grad is None


def test_k3_cuda_wrapper_and_index_checks(problem):
    tm, tf, tmask, idx, heads = _torch(problem)
    L, H = problem[0].shape[-1], heads["phi_v"]["w1"].shape[0]  # noqa: N806
    libs = dict(fused.kern._libs)
    with pytest.raises(ValueError, match="CUDA"):
        fused_edge_cuda(tm, tf, tmask, idx, fused._weights(heads), SLOPE)
    assert fused.kern._libs == libs  # refused before any build or library load
    # what the kernel would read beside the inputs: the padded weights and
    # the work items over this index's dst CSR
    packed = fused.pack_weights(fused._weights(heads), L, H)
    assert packed.shape == (fused.pack_index(L, H).size,) and packed.dtype == torch.float32
    assert packed.numel() == fused.kern.k3_pack_floats(L, H)
    items, row_bus = fused._schedule(idx)
    assert items.dtype == torch.int32 and items.shape[1] == 4 and items.is_contiguous()
    assert items[0, 0] == 0 and items[-1, 1] == N and row_bus.shape == (E,)
    assert fused._schedule(idx)[0] is items  # made once per index
    per_sample = SegmentIndex(np.tile(problem[3], (S, 1)), N)
    with pytest.raises(ValueError, match="shared"):
        fused_edge_stage(tm, tf, tmask, per_sample, heads, SLOPE)
    with pytest.raises(ValueError):
        fused_edge_stage(tm[:, :-1], tf, tmask, idx, heads, SLOPE)
    with pytest.raises(ValueError):
        fused_edge_stage(tm.to("meta"), tf, tmask, idx, heads, SLOPE)


def test_k3_width_range():
    """K3's CUDA path takes every (L, H) of at least (1, 1)
    (segment_kernels.check_width): (129, 8), (136, 8) and (512, 512) among
    them; it refuses a width below 1, and sizes whose 32-bit offsets would
    overflow, before anything is built: fused_edge_occupancy and the
    library's build check the width before they load or build, and on CPU
    tensors fused_edge_cuda raises at its device check. The plain twin, the
    CPU path, takes any width: (136, 8) against jax's interpret-mode
    kernel."""
    libs = dict(fused.kern._libs)
    for latent, hidden in ((1, 1), (128, 128), (129, 8), (136, 8), (97, 40), (7, 17), (128, 1),
                           (1, 128), (8, 129), (512, 64), (64, 512), (512, 512)):
        fused.kern.check_width(latent, hidden)
        fused.kern.check_width(latent, hidden, 1024 * 300, 1024 * 411)
        fused.kern._library_path("fused_edge", width=(latent, hidden))
    for latent, hidden in ((0, 8), (8, 0), (0, 0), (-1, 8)):
        with pytest.raises(ValueError, match="latent and hidden of at least 1"):
            fused.kern.check_width(latent, hidden)
        with pytest.raises(ValueError, match="of at least 1"):
            fused.fused_edge_occupancy(latent, hidden)
        with pytest.raises(ValueError, match="of at least 1"):
            fused.kern._library_path("fused_edge", width=(latent, hidden))
    with pytest.raises(ValueError, match="32 bits"):  # S x E x L at 2^31
        fused.kern.check_width(20, 10, 1024 * 411, (1 << 31) // 20 + 1)
    with pytest.raises(ValueError, match="32 bits"):  # K3's packed weights past 2^31 floats
        fused.kern.check_width(20000, 20000)
    wide = {h: jax.tree.map(np.asarray, init_learning_block(jax.random.key(i), 141, 8, 136))
            for i, h in enumerate(HEADS)}
    rng = np.random.default_rng(2)
    m = rng.standard_normal((S, N, 136)).astype(np.float32)
    feats = rng.standard_normal((S, E, 5)).astype(np.float32)
    mask = np.ones((S, E), np.float32)
    seg = np.arange(E, dtype=np.int32) % N
    heads = heads_from_jax(wide, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fused_edge_cuda(torch.tensor(m), torch.tensor(feats), torch.tensor(mask),
                        SegmentIndex(seg, N), fused._weights(heads), SLOPE)
    assert fused.kern._libs == libs  # nothing built or loaded
    ref = j_fused_edge_stage(jnp.asarray(m), jnp.asarray(feats), jnp.asarray(mask),
                             jnp.asarray(seg), wide, SLOPE, True)
    out = fused_edge_stage(torch.tensor(m), torch.tensor(feats), torch.tensor(mask),
                           SegmentIndex(seg, N), heads, SLOPE)
    for o, r in zip(out, ref):
        assert o.shape == (S, N, 136)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **FWD)
