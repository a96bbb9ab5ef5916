"""gns_torch K4, the whole-forward megakernel, on the CPU: its plain twin
against gns_tpu's `megakernel_forward_batch` in interpret mode and against
the port's own float32 forward.

The weights are gns_tpu's `init_gns_params` carried across with
module_from_jax_params. On the CPU megakernel_forward_batch is the plain
twin; the CUDA kernel runs only on the card, where chip_smoke.py holds it
against this twin.

Tolerance against gns_tpu's megakernel: both round the MLP operands to
bf16 at the same places, but gns_tpu's gathers and sums go through hi + lo
bf16 halves (exact to about 2^-16 relative) where the port sums exactly in
float32. Measured on case14 and case30 (5 grids each): v 3.8e-4, theta
2.3e-4, total_loss 2e-3 relative, delta_p 1.3e-2 (at a bus with a large
injection), delta_q 4.8e-7. The bounds are about 2.5x those."""

import numpy as np
import pytest
import torch

import jax

from gns_tpu.models.gns import init_gns_params
from gns_tpu.ops.pallas_megakernel import megakernel_forward_batch as j_megakernel
from gns_tpu.utils.config import GNSConfig as JConfig
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.gns import gns_forward_batch, step_params
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
VS_JAX = {  # output -> (rtol, atol)
    "v": (0.0, 1e-3), "theta": (0.0, 6e-4), "total_loss": (5e-3, 1e-5),
    "last_loss": (7e-3, 1e-5), "delta_p": (0.0, 3e-2), "delta_q": (0.0, 2e-6),
}


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _setup(case, seed=0, pad_sizes=None):
    params = init_gns_params(jax.random.key(seed), JCFG)
    model = module_from_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")
    batch = batch_from_cases(list(generate_cases(case, 5, seed=0)), pad_sizes=pad_sizes)
    return params, model, batch, extract_shared_topology(batch)


@pytest.mark.parametrize("case,pad", [(14, None), (30, None), (14, (16, 24, 7))])
def test_k4_plain_matches_pallas_interpret(case, pad):
    """case14 and case30, 5 grids each, and a padded case14 batch (dead
    bus, lines and generators masked)."""
    params, model, batch, topo = _setup(case, pad_sizes=pad)
    ref = j_megakernel(params, JCFG, batch, topo, interpret=True)
    out = megakernel_forward_batch(model, CFG, batch, topo)
    plain = megakernel_forward_plain(model, CFG, batch, topo)
    for name, (rtol, atol) in VS_JAX.items():
        got = getattr(out, name).numpy()
        assert np.isfinite(got).all() and got.shape == np.asarray(getattr(ref, name)).shape
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)), rtol=rtol, atol=atol,
                                   err_msg=name)
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
