"""gns_torch graph primitives (K1 segment-sum, K2 gather) on the CPU, where
they run their plain twins, against gns_tpu's: the Pallas kernels in
interpret mode and the XLA scatter/take lowerings, forward and VJP.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain twins there)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gns_tpu.ops.pallas_segment import pallas_gather, pallas_segment_sum
from gns_tpu.ops.segment import broadcast_col0_segment_sum as j_col0
from gns_tpu.ops.segment import gather as j_gather
from gns_tpu.ops.segment import segment_sum as j_segment_sum
from gns_torch.ops import segment_kernels as kern
from gns_torch.ops.segment import (
    GATHER_METHODS,
    METHODS,
    SegmentIndex,
    broadcast_col0_segment_sum,
    check_method,
    gather,
    segment_sum,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _problem(seed, s=3, e=37, n=17, d=8):
    rng = np.random.default_rng(seed)
    shape = (s, e) if d is None else (s, e, d)
    data = rng.standard_normal(shape).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32)
    return data, seg, n


@pytest.mark.parametrize("batch", [1, 3])
def test_k1_plain_matches_pallas_interpret(batch):
    data, seg, n = _problem(0, s=batch)
    ref = np.asarray(pallas_segment_sum(jnp.asarray(data), jnp.asarray(seg), n, True))
    idx = SegmentIndex(seg, n)
    out = kern.segment_sum_plain(torch.from_numpy(data), idx.order, idx.indptr, n)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(segment_sum(torch.from_numpy(data), idx).numpy(), ref, **TOL)


def test_k2_plain_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((2, 11, 4)).astype(np.float32)
    seg = np.array([0, 3, 3, 10, 5], np.int32)
    ref = np.asarray(pallas_gather(jnp.asarray(data), jnp.asarray(seg), 5, interpret=True))
    idx = SegmentIndex(seg, 11)
    out = kern.gather_plain(torch.from_numpy(data), idx.ids)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(gather(torch.from_numpy(data), idx).numpy(), ref, **TOL)


@pytest.mark.parametrize("d", [None, 1, 5])
def test_segment_sum_and_gather_match_xla(d):
    """1-D (S, E) and 2-D (S, E, D) per-sample data; every gns_tpu method
    name passes the entry points' check on the CPU, where the primitives
    (which take no method) run their plain twins."""
    data, seg, n = _problem(1, d=d)
    ref = np.asarray(jax.vmap(lambda x: j_segment_sum(x, seg, n, method="scatter"))(data))
    idx = SegmentIndex(seg, n)
    for method in METHODS:
        assert check_method(method, "cpu") == method
    np.testing.assert_allclose(segment_sum(torch.from_numpy(data), idx).numpy(), ref, **TOL)
    nodes = np.array(ref)
    g_ref = np.asarray(jax.vmap(lambda x: j_gather(x, seg, method="take"))(nodes))
    for method in GATHER_METHODS:
        assert check_method(method, "cpu", GATHER_METHODS) == method
    np.testing.assert_allclose(gather(torch.from_numpy(nodes), idx).numpy(), g_ref, **TOL)


def test_bf16_segment_sum_accumulates_in_f32():
    data, seg, n = _problem(2)
    x = torch.from_numpy(data).to(torch.bfloat16)
    out = segment_sum(x, SegmentIndex(seg, n))
    assert out.dtype == torch.float32
    ref = np.asarray(jax.vmap(lambda v: j_segment_sum(v, seg, n, method="onehot"))(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    nodes = out.to(torch.bfloat16)
    g = gather(nodes, SegmentIndex(seg, n))
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.float().numpy(), nodes.float().numpy()[:, seg])


def test_out_of_range_ids_dropped_and_empty_segments():
    data = np.ones((2, 4, 3), np.float32)
    seg = np.array([0, 0, 2, 9], np.int32)  # 9 >= n: dropped
    idx = SegmentIndex(seg, 5)
    out = segment_sum(torch.from_numpy(data), idx).numpy()
    ref = np.asarray(jax.vmap(lambda x: j_segment_sum(x, seg, 5, method="scatter"))(data))
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0].sum() == 6.0 and np.all(out[:, [1, 3, 4]] == 0)
    assert not idx.in_range
    with pytest.raises(ValueError):
        gather(torch.zeros((2, 5, 3)), idx)


def test_per_sample_index_flattens_to_one_call():
    """A (S, E) index (mixed-size request) runs as one flat (1, S*E) call
    and equals the per-sample sums, dropped ids included."""
    rng = np.random.default_rng(3)
    s, e, n, d = 4, 12, 6, 3
    ids = rng.integers(0, n, (s, e)).astype(np.int32)
    ids[1, 2] = n + 4  # out of range: dropped
    data = rng.standard_normal((s, e, d)).astype(np.float32)
    idx = SegmentIndex(ids, n)
    assert idx.batch == s and idx.rows == s * n and idx.ids.shape == (s * e,)
    out = segment_sum(torch.from_numpy(data), idx).numpy()
    for i in range(s):
        ref = np.asarray(j_segment_sum(data[i], ids[i], n, method="scatter"))
        np.testing.assert_allclose(out[i], ref, **TOL)
    ok = SegmentIndex(np.clip(ids, 0, n - 1), n)
    nodes = rng.standard_normal((s, n, d)).astype(np.float32)
    g = gather(torch.from_numpy(nodes), ok).numpy()
    for i in range(s):
        np.testing.assert_array_equal(g[i], nodes[i][np.clip(ids[i], 0, n - 1)])
    with pytest.raises(ValueError):
        segment_sum(torch.zeros((s + 1, e, d)), idx)


def test_vjps_match_jax_grad():
    data, seg, n = _problem(4)
    idx = SegmentIndex(seg, n)

    def f_jax(x):
        return (jax.vmap(lambda v: j_segment_sum(v, seg, n, method="scatter"))(x) ** 2).sum()

    x = torch.from_numpy(data).requires_grad_(True)
    (segment_sum(x, idx) ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(f_jax)(data)), **TOL)

    nodes = np.random.default_rng(5).standard_normal((3, n, 8)).astype(np.float32)

    def g_jax(y):
        return (jax.vmap(lambda v: j_gather(v, seg, method="take"))(y) ** 3).sum()

    y = torch.from_numpy(nodes).requires_grad_(True)
    (gather(y, idx) ** 3).sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jax.grad(g_jax)(nodes)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_sample", [False, True])
def test_dropped_ids_gradient_matches_jax_grad(per_sample):
    """Segment ids outside [0, n) are dropped and get a zero gradient: the
    twin's autograd equals jax.grad(jax.ops.segment_sum) (TOL), and the
    masked gather that K1's backward launches on the card (its plain twin
    here, on SegmentIndex.masked_ids) gives the twin's gradient bit for
    bit."""
    rng = np.random.default_rng(9)
    s, e, n, d = 3, 23, 7, 5
    ids = rng.integers(0, n, (s, e) if per_sample else (e,)).astype(np.int32)
    flat = ids.reshape(-1)
    flat[[2, 9]] = [n + 3, -2]  # dropped
    data = rng.standard_normal((s, e, d)).astype(np.float32)
    w = rng.standard_normal((s, n, d)).astype(np.float32)
    idx = SegmentIndex(ids, n)
    assert not idx.in_range and idx.masked_ids is not None

    def f_jax(x):
        if per_sample:
            sums = jax.vmap(lambda v, i: jax.ops.segment_sum(v, i, n))(x, ids)
        else:
            sums = jax.vmap(lambda v: jax.ops.segment_sum(v, ids, n))(x)
        return (sums * w).sum()

    x = torch.from_numpy(data).requires_grad_(True)
    out = segment_sum(x, idx)
    g_out = torch.from_numpy(w)
    (out * g_out).sum().backward()
    want = np.asarray(jax.grad(f_jax)(data))
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)
    dropped = (flat < 0) | (flat >= n)
    assert np.all(x.grad.numpy()[np.broadcast_to(dropped.reshape(-1, e), (s, e))] == 0)
    g_flat = g_out.reshape(1, -1, d) if per_sample else g_out
    got = kern.gather_plain(g_flat, idx.masked_ids, masked=True).reshape(s, e, d)
    assert torch.equal(got, x.grad)
    assert np.array_equal(idx.masked_ids.numpy() < 0, dropped)


def test_broadcast_col0_quirk():
    data, seg, n = _problem(6, d=1)
    out = broadcast_col0_segment_sum(torch.from_numpy(data), SegmentIndex(seg, n), 6).numpy()
    ref = np.asarray(jax.vmap(lambda x: j_col0(x, seg, n, 6, method="scatter"))(data))
    assert out.shape == (3, n, 6) and np.all(out[..., 1:] == 0)
    np.testing.assert_allclose(out, ref, **TOL)


def test_dispatch_rejects_bad_methods_and_devices():
    """check_method, the one check of a method name at the entry points:
    an unknown name raises; on the card only 'auto', 'pallas' and
    'degree' run; no device but cuda and cpu. The entry points call it
    before any work, and the primitives take no method at all and raise
    on any other device."""
    from gns_torch.models.gns import GNS
    from gns_torch.serve import GNSPredictor
    from gns_torch.train.trainer import make_epoch_step, make_train_step
    from gns_torch.utils.config import GNSConfig

    data, seg, n = _problem(8)
    idx = SegmentIndex(seg, n)
    with pytest.raises(ValueError, match="unknown method"):
        check_method("bogus")
    with pytest.raises(ValueError, match="unknown method"):
        check_method("take", "cpu")  # a gather's name, not a forward's
    with pytest.raises(ValueError, match="unknown method"):
        check_method("scatter", names=GATHER_METHODS)
    for method in ("scatter", "onehot", "hybrid"):
        with pytest.raises(ValueError, match="no CUDA lowering"):
            check_method(method, "cuda")
    for method in ("auto", "pallas", "degree"):
        assert check_method(method, "cuda") == method
    with pytest.raises(ValueError, match="unsupported device"):
        check_method("auto", "meta")
    cfg = GNSConfig(K=1, latent_dim=4, hidden_dim=4)
    model = GNS(cfg, seed=0, device="cpu")
    assert GNSPredictor(model, cfg, method="onehot", device="cpu").method == "onehot"
    with pytest.raises(ValueError, match="unknown method"):
        GNSPredictor(model, cfg, method="bogus", device="cpu")
    for build in (make_train_step, make_epoch_step):
        with pytest.raises(ValueError, match="unknown method"):
            build(cfg, method="bogus")
    with pytest.raises(TypeError):  # the primitives take no method
        segment_sum(torch.from_numpy(data), idx, method="auto")
    with pytest.raises(ValueError):  # neither cuda nor cpu: no silent path
        segment_sum(torch.zeros((3, 37, 2), device="meta"), idx)
    with pytest.raises(ValueError):
        segment_sum(torch.zeros((3, 36, 2)), idx)  # edge count mismatch
    with pytest.raises(ValueError):
        kern.segment_sum_cuda(torch.zeros((3, 37, 2)), idx.order, idx.indptr, n)
    with pytest.raises(ValueError):
        kern.gather_cuda(torch.zeros((3, n, 2)), idx.ids)


def test_kernel_source_and_build_dir():
    """The kernels are built from the checkout's sources into build/, one
    library per source (K3 and K4: per source and width), keyed by the
    source's and flags' hash."""
    import os

    symbols = {
        "segment": ("gns_segment_sum", "gns_gather"),
        "fused_edge": ("gns_fused_edge",),
        "megakernel": ("gns_megakernel", "gns_megakernel_plan"),
    }
    assert set(kern.SOURCES) == set(symbols)
    assert kern.BUILD_DIR.endswith(os.path.join("build", "torch_kernels"))
    assert "arch=compute_90a,code=sm_90a" in kern.NVCC_FLAGS
    assert "--use_fast_math" not in kern.NVCC_FLAGS
    for name, syms in symbols.items():
        path = kern.SOURCES[name]
        assert os.path.exists(path) and path.endswith(os.path.join("csrc", f"{name}.cu"))
        src = open(path).read()
        for sym in (*syms, "cudaGetLastError"):
            assert sym in src
        width = (20, 10) if name in kern.WIDTHED else None
        lib = kern._library_path(name, width=width)
        assert os.path.dirname(lib) == kern.BUILD_DIR and f"libgns_{name}_" in lib
        if width is not None:
            assert "_L20_H10_" in lib
            with pytest.raises(ValueError, match="width"):
                kern._library_path(name)
    assert kern._library_path("megakernel", width=(20, 10)) != kern._library_path("segment")
