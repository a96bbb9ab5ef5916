"""gns_torch's sharded forward and train step (parallel/sharding.py) on
4-rank gloo meshes on the CPU: dp = 4, dp x gp = 2 x 2 and the hybrid
dcn x dp x gp = 2 x 1 x 2, in reference-parity mode (quirk Q2's per-line
gathers under gp) and paper mode; and the initialize_distributed contract
(parallel/mesh.py), monkeypatched as tests/test_hybrid_mesh.py does.

One spawn (tests/torch_parallel_ranks.py job_sharding) runs every case.
Against the port's single-process run, gns_tpu's sharded bounds
(tests/test_parallel.py:48-69): v rtol 2e-5 / atol 1e-6, losses rtol
2e-5, post-Adam parameters rtol 8e-3 / atol lr; the step's gradients leaf
by leaf against single-process autograd at tests/test_edge_partition.py's
bound (atol 5e-5 of each leaf's largest entry) plus a floor of 1e-5 of
the largest gradient entry of all leaves, for the leaves whose exact
gradient is 0 (a uniform shift of theta moves no residual: the last
step's L_theta output bias has a gradient of float noise, 1e-8 to 1e-6
against entries up to 0.6). A gradient off by a factor gp on any leaf
above 2e-5 of the largest fails. Against gns_tpu's sharded
run on 4 of the simulated devices: tests/test_torch_model.py's
cross-package bound, rtol / atol 2e-4, on the forward and the step's
loss; gns_tpu's make_sharded_train_step on the same three meshes, one
step of optax.sgd(1.0) from the same weights, whose change to each leaf
is minus its gradient, against the port's recorded gradients at
tests/test_torch_train.py's cross-package gradient bound (2e-4 of each
leaf's largest entry) with the floor above. Each path's collectives are
held to the count its code gives.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.parallel.mesh import make_hybrid_mesh as j_make_hybrid_mesh
from gns_tpu.parallel.mesh import make_mesh as j_make_mesh
from gns_tpu.parallel.sharding import make_sharded_train_step as j_sharded_train_step
from gns_tpu.parallel.sharding import replicate as j_replicate
from gns_tpu.parallel.sharding import shard_batch as j_shard_batch
from gns_tpu.utils.prepare import GridBatch as JGridBatch
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.gns import batch_tensors, gns_forward_batch
from gns_torch.parallel import mesh as mesh_mod
from gns_torch.parallel import sharding
from gns_torch.physics.common import build_graph
from gns_torch.train.trainer import (TrainState, loss_and_grads, make_optimizer,
                                     make_train_step)
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology
from torch_parallel_ranks import TRAIN_MESHES, gns_tpu_step, hold_gns_tpu, hold_leaves, run_world

torch.set_num_threads(2)

CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, multiple_phi=True, seed=0)
CFGS = {"parity": CFG, "paper": CFG.replace(reference_parity=False)}
GP = {"dp4": 1, "dp2_gp2": 2, "dcn2_dp1_gp2": 2}
CASES = [(m, c) for m in TRAIN_MESHES for c in CFGS]


@pytest.fixture(scope="module")
def inputs():
    cases = list(generate_cases(14, 8, seed=5))[1:]  # 8 grids, E = 20
    return dict(
        batch=batch_from_cases(cases + cases[:1])[:8], cfgs=CFGS,
        params={k: jax.tree.map(np.asarray, init_gns_params(jax.random.key(i), c))
                for i, (k, c) in enumerate(CFGS.items())},
    )


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_world("sharding", 4, tmp_path_factory.mktemp("sharding"), inputs)


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-process forward, gradients and Adam step."""
    batch = inputs["batch"]
    topo = extract_shared_topology(batch)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    out = {}
    for mode, cfg in CFGS.items():
        params = inputs["params"][mode]
        model = module_from_jax_params(params, cfg, device="cpu")
        with torch.no_grad():
            out[f"fwd/{mode}"] = gns_forward_batch(model, cfg, batch, topo=topo,
                                                   dense=batch.is_dense())
        loss, last, grads = loss_and_grads(model, cfg, batch_tensors(batch, "cpu"), graph,
                                           dense=batch.is_dense())
        out[f"grads/{mode}"] = [g.numpy() for g in grads]
        out[f"loss/{mode}"] = (float(loss), float(last))
        adam = make_optimizer(cfg)
        state = TrainState(model, adam.init(model.parameters()), torch.zeros((), dtype=torch.int32))
        make_train_step(cfg, adam, topo=topo, dense=batch.is_dense())(state, batch)
        out[f"adam/{mode}"] = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return out


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """gns_tpu's forward on a (2, 2) mesh of 4 simulated devices."""
    mesh = j_make_mesh(dp=2, gp=2, devices=jax.devices()[:4])
    out = {}
    for mode, cfg in CFGS.items():
        params = j_replicate(inputs["params"][mode], mesh)
        out[mode] = jax.jit(lambda p, b, cfg=cfg: j_forward_batch(p, cfg, b, method="onehot"))(
            params, j_shard_batch(inputs["batch"], mesh))
    return out


def _j_mesh(name):
    """gns_tpu's counterpart of torch_parallel_ranks._train_mesh on 4 of
    the simulated devices, with its batch axes."""
    devices = jax.devices()[:4]
    if name == "dcn2_dp1_gp2":
        return j_make_hybrid_mesh(dcn=2, dp=1, gp=2, devices=devices), ("dcn", "dp")
    dp, gp = TRAIN_MESHES[name]
    return j_make_mesh(dp=dp, gp=gp, devices=devices), "dp"


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """gns_tpu's sharded train step on each mesh: one optax.sgd(1.0) step,
    so the change to each leaf is minus its gradient."""
    out = {}
    batch = JGridBatch(*inputs["batch"])
    for name in TRAIN_MESHES:
        mesh, dp = _j_mesh(name)
        for mode, cfg in CFGS.items():
            step = j_sharded_train_step(cfg, mesh, optimizer=optax.sgd(1.0), method="onehot",
                                        dp=dp)
            out[(name, mode)] = gns_tpu_step(
                lambda st, b: step(st, j_shard_batch(b, mesh, dp=dp)), inputs["params"][mode],
                batch, optax.sgd(1.0), place=lambda st: j_replicate(st, mesh))
    return out


def _collectives(cfg: GNSConfig, gp: int, train: bool) -> dict:
    """The collectives of one sharded forward (eval step) or train step,
    as models/gns.py, physics/fused.py and parallel/sharding.py issue them
    for a multiple_phi, fused, unfolded config: under gp > 1 per K step
    one all-reduce of the message aggregate and three in the physics
    (Joule sum, two mismatch sums), in parity mode one all-gather of the
    angle differences per step and one of the step-invariant Q2 geometry;
    the backward sums each all-reduce's and each differentiable
    all-gather's gradient once; the step's gradients (and metrics) take
    one all-reduce, the eval step's outputs one all-gather over dp."""
    ar = ag = 0
    if gp > 1:
        ar = 4 * cfg.K
        if cfg.reference_parity:
            ag = cfg.K + 1
        if train:
            ar += 4 * cfg.K + (cfg.K if cfg.reference_parity else 0)
    if train:
        ar += 1
    else:
        ag += 1
    return {k: v for k, v in (("all_reduce", ar), ("all_gather", ag)) if v}


def _same_on_every_rank(ranks, key):
    for other in ranks[1:]:
        a, b = ranks[0][key], other[key]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key}.{k}")
        else:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.mark.parametrize("mesh,mode", CASES)
def test_sharded_forward_matches_single_process(ranks, single, mesh, mode):
    _same_on_every_rank(ranks, f"fwd/{mesh}/{mode}")
    got, want = ranks[0][f"fwd/{mesh}/{mode}"], single[f"fwd/{mode}"]
    np.testing.assert_allclose(got["v"], want.v.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["theta"], want.theta.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got["total_loss"], want.total_loss.numpy(), rtol=2e-5)
    np.testing.assert_allclose(got["last_loss"], want.last_loss.numpy(), rtol=2e-5)
    assert ranks[0][f"fwd_coll/{mesh}/{mode}"] == _collectives(CFGS[mode], GP[mesh], False)


@pytest.mark.parametrize("mode", sorted(CFGS))
def test_sharded_forward_matches_gns_tpu(ranks, jax_sharded, mode):
    got, want = ranks[0][f"fwd/dp2_gp2/{mode}"], jax_sharded[mode]
    np.testing.assert_allclose(got["v"], np.asarray(want.v), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["total_loss"], np.asarray(want.total_loss), rtol=2e-4)


@pytest.mark.parametrize("mesh,mode", CASES)
def test_sharded_step_gradients_leaf_by_leaf(ranks, single, mesh, mode):
    """The one all-reduce of the gradients gives single-process autograd's
    gradient on every leaf; a gradient scaled by gp (the all-reduce's
    backward summed without the 1/gp loss scale) fails here."""
    _same_on_every_rank(ranks, f"grads/{mesh}/{mode}")
    got, want = ranks[0][f"grads/{mesh}/{mode}"], single[f"grads/{mode}"]
    hold_leaves(got, want)
    loss, last = single[f"loss/{mode}"]
    metrics = ranks[0][f"metrics/{mesh}/{mode}"]
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=2e-5)
    np.testing.assert_allclose(float(metrics["last_loss"]), last, rtol=2e-5)
    assert ranks[0][f"step_coll/{mesh}/{mode}"] == _collectives(CFGS[mode], GP[mesh], True)


@pytest.mark.parametrize("mesh,mode", CASES)
def test_sharded_step_matches_gns_tpu(ranks, inputs, jax_steps, mesh, mode):
    """The port's sharded step and gns_tpu's on the same mesh shape, the
    same weights and batch: gradients leaf by leaf, and the losses."""
    delta, metrics = jax_steps[(mesh, mode)]
    minus_grad = jax.tree.map(np.negative, delta)
    names = [n for n, _ in module_from_jax_params(inputs["params"][mode], CFGS[mode],
                                                  device="cpu").named_parameters()]
    for r in ranks:
        hold_gns_tpu(dict(zip(names, r[f"grads/{mesh}/{mode}"])), minus_grad, CFGS[mode])
    got = ranks[0][f"metrics/{mesh}/{mode}"]
    np.testing.assert_allclose(float(got["loss"]), metrics["loss"], rtol=2e-4)
    np.testing.assert_allclose(float(got["last_loss"]), metrics["last_loss"], rtol=2e-4)


@pytest.mark.parametrize("mesh,mode", CASES)
def test_sharded_adam_step_matches_single_process(ranks, single, mesh, mode):
    # Adam divides by sqrt(second moment), amplifying float32
    # reduction-order noise on near-zero gradients to up to ~lr per
    # element: gns_tpu's bound (tests/test_parallel.py:63-69)
    got, want = ranks[0][f"adam/{mesh}/{mode}"], single[f"adam/{mode}"]
    for name, b in want.items():
        np.testing.assert_allclose(got[name], b, rtol=8e-3, atol=CFG.lr, err_msg=name)


def test_shard_batch_layout(inputs):
    """batch_sharding's placements are gns_tpu's layout, and shard_batch
    refuses a line count the gp axis does not divide."""

    class Mesh1D:  # the DeviceMesh surface shard_batch reads
        mesh_dim_names = ("dp", "gp")

        def get_coordinate(self):
            return [1, 2]

        def size(self, d):
            return (2, 3)[d]

    spec = sharding.batch_sharding(Mesh1D())
    assert spec.lines == ("dp", "gp", None) and spec.buses == ("dp", None, None)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_batch(inputs["batch"], Mesh1D())  # E = 20 over gp = 3
    with pytest.raises(ValueError, match="no axis 'tp'"):
        sharding.batch_sharding(Mesh1D(), gp="tp")


class _Dist:
    """A stand-in for torch.distributed's init surface."""

    def __init__(self, initialized=False, raise_on_init=None):
        self._initialized = initialized
        self.calls = []
        self.raise_on_init = raise_on_init

    def is_initialized(self):
        return self._initialized

    def init_process_group(self, **kw):
        self.calls.append(kw)
        if self.raise_on_init is not None:
            raise self.raise_on_init


def test_initialize_distributed_contract(monkeypatch):
    """gns_tpu's contract (tests/test_hybrid_mesh.py:120-185): a no-op once
    initialized; explicit arguments go through and their failures
    propagate; no cluster environment at all runs single-process; a
    detected environment that cannot be reached raises."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    fake = _Dist(initialized=True)
    monkeypatch.setattr(mesh_mod, "dist", fake)
    mesh_mod.initialize_distributed(backend="gloo")
    assert fake.calls == []

    fake = _Dist()
    monkeypatch.setattr(mesh_mod, "dist", fake)
    mesh_mod.initialize_distributed(backend="gloo", init_method="tcp://h0:1234",
                                    world_size=2, rank=0)
    assert fake.calls == [dict(backend="gloo", init_method="tcp://h0:1234", world_size=2,
                               rank=0)]

    fake = _Dist(raise_on_init=RuntimeError("connection refused"))
    monkeypatch.setattr(mesh_mod, "dist", fake)
    with pytest.raises(RuntimeError, match="refused"):
        mesh_mod.initialize_distributed(backend="gloo", init_method="tcp://h0:1234")

    # no arguments, no cluster environment: single-process, nothing called
    mesh_mod.initialize_distributed()
    assert len(fake.calls) == 1

    # a cluster environment whose rendezvous fails: the error propagates
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "h0")
    with pytest.raises(RuntimeError, match="refused"):
        mesh_mod.initialize_distributed()
    assert fake.calls[-1] == {"backend": "gloo", "init_method": "env://"}


def test_make_mesh_validation():
    """make_mesh / make_hybrid_mesh refuse shapes that do not cover the
    ranks, with gns_tpu's messages (no process group is needed for that)."""
    with pytest.raises(ValueError, match="not divisible by gp=3"):
        mesh_mod.make_mesh(gp=3, ranks=range(4))
    with pytest.raises(ValueError, match=r"mesh 3x2 != 4 devices"):
        mesh_mod.make_mesh(dp=3, gp=2, ranks=range(4))
    with pytest.raises(ValueError, match="not divisible by dcn=3"):
        mesh_mod.make_hybrid_mesh(dcn=3, ranks=range(4))
    with pytest.raises(ValueError, match=r"mesh 2x1x1 != 4 devices"):
        mesh_mod.make_hybrid_mesh(dcn=2, dp=1, gp=1, ranks=range(4))
