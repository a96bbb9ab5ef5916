"""gns_torch K4, the whole-forward megakernel, on the CPU: its plain twin
against gns_tpu's `megakernel_forward_batch` in interpret mode and against
the port's own float32 forward.

The weights are gns_tpu's `init_gns_params` carried across with
module_from_jax_params. The twin is held to gns_tpu at every (latent,
hidden) of WIDTHS: gns_tpu's K3 test width (8, 8), the reference's default
(10, 10), an odd latent with hidden > 16 (33, 24), the shipped
checkpoints' (20, 10) and (40, 10), and widths past one block's shared
memory on the card: (64, 32), (97, 40) and the range's corner (128, 128);
also at (136, 8) and (72, 40), which the plain twin takes and the kernel
does not. On the CPU megakernel_forward_batch is the plain twin; the CUDA
kernel runs only on the card, where chip_smoke.py holds it against this
twin.

Tolerance against gns_tpu's megakernel: both round the MLP operands to
bf16 at the same places, but gns_tpu's gathers and sums go through hi + lo
bf16 halves (exact to about 2^-16 relative) where the port sums exactly in
float32. Measured on case14 and case30 (5 grids each): v 3.8e-4, theta
2.3e-4, total_loss 2e-3 relative, delta_p 1.3e-2 (at a bus with a large
injection), delta_q 4.8e-7. The bounds are about 2.5x those.

At (10, 10) and (33, 24) one case14 grid's last_loss differs by 1.61e-2
and 9.07e-3 relative (the bound is 7e-3). That gap is gns_tpu's sums: with
the twin's segment-sums taken as gns_tpu takes them (hi + lo bf16 halves,
`_gns_tpu_sums`), it is within VS_JAX. So every width holds the twin
with gns_tpu's sums to VS_JAX, and the twin as it is to VS_JAX but for
those widths' last_loss, which VS_JAX_WIDTH bounds at about 2.5x its
reading. The same holds at (97, 40): the twin as it is reads theta
6.24e-4, total_loss 9.72e-3 and last_loss 1.27e-2 relative, delta_p
3.06e-2, which VS_JAX_WIDTH bounds at about 2.5x, while the twin with
gns_tpu's sums reads 2.59e-4, 1.12e-3, 1.08e-3 and 7.18e-3, within
VS_JAX."""

import contextlib

import numpy as np
import pytest
import torch

import jax

from gns_tpu.models.gns import init_gns_params
from gns_tpu.ops.pallas_megakernel import megakernel_forward_batch as j_megakernel
from gns_tpu.utils.config import GNSConfig as JConfig
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.gns import gns_forward_batch, step_params
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.megakernel import (
    megakernel_cuda,
    megakernel_forward_batch,
    megakernel_forward_plain,
    megakernel_inputs,
)
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

torch.set_num_threads(1)
CFG = GNSConfig(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True, reference_parity=True)
JCFG = JConfig(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True, reference_parity=True)
WIDTHS = [(8, 8), (10, 10), (33, 24), (20, 10), (40, 10), (64, 32), (97, 40), (128, 128)]
VS_JAX_WIDTH = {(10, 10): {"last_loss": (4e-2, 1e-5)}, (33, 24): {"last_loss": (4e-2, 1e-5)},
                (97, 40): {"theta": (0.0, 1.6e-3), "total_loss": (2.5e-2, 1e-5),
                           "last_loss": (3.2e-2, 1e-5), "delta_p": (0.0, 7.6e-2)}}
VS_JAX = {  # output -> (rtol, atol)
    "v": (0.0, 1e-3), "theta": (0.0, 6e-4), "total_loss": (5e-3, 1e-5),
    "last_loss": (7e-3, 1e-5), "delta_p": (0.0, 3e-2), "delta_q": (0.0, 2e-6),
}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@contextlib.contextmanager
def _gns_tpu_sums():
    """The plain twin's segment-sums taken as gns_tpu's megakernel takes
    them (pallas_megakernel.py _oh_dot_exact): the data split into a bf16
    high half and a bf16 low half, each summed in float32, then added."""
    plain = kern.segment_sum_plain

    def hi_lo(data, order, indptr, n):
        hi = data.float().to(torch.bfloat16).float()
        lo = (data.float() - hi).to(torch.bfloat16).float()
        return plain(hi, order, indptr, n) + plain(lo, order, indptr, n)

    kern.segment_sum_plain = hi_lo
    try:
        yield
    finally:
        kern.segment_sum_plain = plain


def _cfgs(width):
    kw = dict(latent_dim=width[0], hidden_dim=width[1])
    return CFG.replace(**kw), JCFG.replace(**kw)


def _setup(case, seed=0, pad_sizes=None, width=(20, 10)):
    cfg, jcfg = _cfgs(width)
    params = init_gns_params(jax.random.key(seed), jcfg)
    model = module_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    batch = batch_from_cases(list(generate_cases(case, 5, seed=0)), pad_sizes=pad_sizes)
    return params, model, batch, extract_shared_topology(batch)


@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: f"L{w[0]}_H{w[1]}")
@pytest.mark.parametrize("case,pad", [(14, None), (30, None), (14, (16, 24, 7))])
def test_k4_plain_matches_pallas_interpret(case, pad, width):
    """case14 and case30, 5 grids each, and a padded case14 batch (dead
    bus, lines and generators masked), at each width: the twin with
    gns_tpu's sums within VS_JAX, the twin as it is within VS_JAX (and
    VS_JAX_WIDTH)."""
    cfg, jcfg = _cfgs(width)
    params, model, batch, topo = _setup(case, pad_sizes=pad, width=width)
    ref = j_megakernel(params, jcfg, batch, topo, interpret=True)
    out = megakernel_forward_batch(model, cfg, batch, topo)
    plain = megakernel_forward_plain(model, cfg, batch, topo)
    with _gns_tpu_sums():
        same_sums = megakernel_forward_plain(model, cfg, batch, topo)
    for name, (rtol, atol) in VS_JAX.items():
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert np.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(getattr(same_sums, name).numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=f"{name}, the twin with gns_tpu's sums")
        rtol, atol = VS_JAX_WIDTH.get(width, {}).get(name, (rtol, atol))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
        assert torch.equal(getattr(out, name), getattr(plain, name))


@pytest.mark.parametrize("case", [14, 30])
def test_k4_plain_matches_float32_forward(case):
    """tests/test_megakernel.py:31-40's tolerances against the port's own
    float32 forward (bf16 MLP compute: serving-grade)."""
    _, model, batch, topo = _setup(case)
    ref = gns_forward_batch(model, CFG, batch, topo=topo)
    out = megakernel_forward_batch(model, CFG, batch, topo)
    np.testing.assert_allclose(out.v.numpy(), ref.v.numpy(), atol=2e-2)
    np.testing.assert_allclose(out.theta.numpy(), ref.theta.numpy(), atol=2e-2)
    np.testing.assert_allclose(out.last_loss.numpy(), ref.last_loss.numpy(), rtol=0.1, atol=5e-2)


def test_k4_inputs_layout():
    """The packs hold the kernel's tiles: 56 tiles of 16 x 8 bf16 and 304
    padded float32 biases per step at L=20, H=10; the twin's steps are
    step_params' fused float32-path weights, bf16-cast, and float32 biases;
    the discounts are gamma^(K-k); the work items cover the buses and the
    row flags the dst CSR."""
    _, model, batch, topo = _setup(14)
    inp = megakernel_inputs(model, CFG, batch, topo)
    assert inp.wpack.dtype == torch.bfloat16 and inp.bpack.dtype == torch.float32
    assert inp.wpack.shape == (4, 56 * 128) and inp.bpack.shape == (4, 304)
    steps = step_params(model, CFG.replace(fused_heads=True, fold_output="off"))
    for k in range(CFG.K):
        for head in ("phi_fused", "L_fused"):
            for n, t in steps[k][head].items():
                want = t.to(torch.bfloat16) if n.startswith("w") else t
                assert torch.equal(inp.steps[k][head][n], want), (k, head, n)
    items = inp.items.numpy()
    assert items[0, 0] == 0 and items[-1, 1] == inp.bus_mask.shape[1]
    assert np.array_equal(items[1:, 0], items[:-1, 1])
    assert np.array_equal(items[:, 2:], inp.dst.indptr.numpy()[items[:, :2]])
    assert inp.row_bus.numel() == inp.dst.order.numel()
    for index, pos in ((inp.dst, inp.dst_pos), (inp.src, inp.src_pos), (inp.gen, inp.gen_pos)):
        assert torch.equal(index.order[pos.long()], torch.arange(pos.numel(), dtype=torch.int32))
    np.testing.assert_allclose(inp.discounts.numpy(), [0.9 ** (4 - k) for k in range(4)],
                               rtol=1e-7)
    assert torch.equal(inp.srcq, inp.src.ids) and torch.equal(inp.dstq, inp.dst.ids)


def test_k4_rejects_unsupported():
    _, model, batch, topo = _setup(14)
    with pytest.raises(ValueError):
        megakernel_forward_batch(model, CFG.replace(reference_parity=False), batch, topo)
    with pytest.raises(ValueError):
        megakernel_forward_batch(model, CFG, batch, None)
    with pytest.raises(ValueError):
        megakernel_forward_plain(model, CFG.replace(multiple_phi=False), batch, topo)


def test_k4_cuda_wrapper_raises_on_cpu():
    _, model, batch, topo = _setup(14)
    with pytest.raises(ValueError, match="CUDA"):
        megakernel_cuda(megakernel_inputs(model, CFG, batch, topo))


def test_k4_width_range():
    """K4's CUDA path takes every (latent, hidden) of at least (1, 1):
    (129, 8), (8, 129), (136, 8) and (512, 512) among them, each built at
    its first call. A width below 1 is refused before anything is built or
    loaded: by the library's build, by megakernel_occupancy and by
    megakernel_cuda (whose inputs at such a width reach it only by hand),
    and megakernel_forward_batch at (0, 8) raises in the packing. Its CUDA
    wrapper refuses CPU tensors before any library is built or loaded. Its
    packing, so its plain twin, takes any width of at least 1. Whether a
    grid fits one of the kernel's plans is the library's answer
    (megakernel.cu's Layout, gns_megakernel_plan), read on the card:
    chip_smoke.py runs K4 up to (512, 512) on case300 and holds it at (0,
    8) and (8, 0) to raise there."""
    from gns_torch.models.gns import GNS
    from gns_torch.ops import megakernel as mk

    libs = dict(kern._libs)
    for width in ((129, 8), (8, 129), (136, 8), (512, 512)):
        kern._library_path("megakernel", width=width)
    for width in ((0, 10), (20, 0)):
        with pytest.raises(ValueError, match="latent and hidden of at least 1"):
            kern._library_path("megakernel", width=width)
        with pytest.raises(ValueError, match="at least 1"):
            mk.pack_step_weights([], *width)
    _, model, batch, topo = _setup(14, width=(8, 8))
    inp = megakernel_inputs(model, _cfgs((8, 8))[0], batch, topo)
    for width in ((0, 8), (8, 0)):
        low = inp._replace(latent=width[0], hidden=width[1])
        with pytest.raises(ValueError, match="of at least 1"):
            mk.megakernel_occupancy(low)
    low = CFG.replace(latent_dim=0, hidden_dim=8)
    with pytest.raises(ValueError, match="of at least 1"):
        megakernel_forward_batch(GNS(low, seed=0, device="cpu"), low, batch, topo)
    for width in ((129, 8), (8, 129)):
        wide = CFG.replace(latent_dim=width[0], hidden_dim=width[1])
        wide_inp = megakernel_inputs(GNS(wide, seed=0, device="cpu"), wide, batch, topo)
        with pytest.raises(ValueError, match="CUDA"):
            megakernel_cuda(wide_inp)
    with pytest.raises(ValueError, match="CUDA"):
        megakernel_cuda(inp)
    assert kern._libs == libs


@pytest.mark.parametrize("width", [(136, 8), (72, 40), (160, 136)], ids=lambda w: f"L{w[0]}_H{w[1]}")
def test_k4_cpu_twin_takes_any_width(width):
    """megakernel_forward_batch on a CPU model runs the plain twin at
    widths past 128 ((136, 8), (160, 136): the kernel's pass instance on
    the card) or never held at (72, 40), against gns_tpu's interpret-mode
    megakernel on case14, at
    test_k4_plain_matches_pallas_interpret's tolerances (the twin with
    gns_tpu's sums within VS_JAX; as it is, within VS_JAX)."""
    cfg, jcfg = _cfgs(width)
    params, model, batch, topo = _setup(14, width=width)
    ref = j_megakernel(params, jcfg, batch, topo, interpret=True)
    out = megakernel_forward_batch(model, cfg, batch, topo)
    with _gns_tpu_sums():
        same_sums = megakernel_forward_plain(model, cfg, batch, topo)
    for name, (rtol, atol) in VS_JAX.items():
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert np.isfinite(got).all() and got.shape == want.shape
        np.testing.assert_allclose(getattr(same_sums, name).numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=f"{name}, the twin with gns_tpu's sums")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
