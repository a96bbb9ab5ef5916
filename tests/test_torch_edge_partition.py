"""gns_torch's explicit edge partition (parallel/edge_partition.py) on a
4-rank gloo mesh on the CPU (dp x gp = 2 x 2, and gp = 4 for case300):
forward and train step against the port's single-process run and
gns_tpu's edge-partitioned forward, in paper-correct physics.

One spawn (tests/torch_parallel_ranks.py job_edge) runs every case.
Tolerances are gns_tpu's (tests/test_edge_partition.py): forward v rtol
2e-5 / atol 2e-6 and total_loss rtol 2e-5 (:43-48); bf16 + fold rtol 1e-4
/ atol 1e-5 (:80-85); case300 padded total_loss rtol 5e-5 (:63); the
paper conventions' delta_q rtol 2e-4 / atol 1e-5 (:164-168); the train
step's loss rtol 2e-5 and post-Adam parameters rtol 5e-2 / atol 2e-4
(:103-114); gradients leaf by leaf against single-process autograd at
atol 5e-5 of each leaf's largest entry (:147), with
tests/test_torch_parallel.py's floor for the exactly-zero leaves. Against
gns_tpu: the cross-package rtol / atol 2e-4 (tests/test_torch_model.py)
on the forward and the step's loss; gns_tpu's
make_edge_partitioned_train_step on the same dp x gp = 2 x 2 mesh, one
step of optax.sgd(1.0) (minus the gradient), against the port's recorded
gradients at tests/test_torch_train.py's cross-package gradient bound
with the same floor.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from gns_tpu.models.gns import init_gns_params
from gns_tpu.parallel.edge_partition import make_edge_partitioned_forward as j_ep_forward
from gns_tpu.parallel.edge_partition import make_edge_partitioned_train_step as j_ep_train_step
from gns_tpu.parallel.mesh import make_mesh as j_make_mesh
from gns_tpu.utils.prepare import GridBatch as JGridBatch
from gns_torch.models.convert import module_from_jax_params
from gns_torch.models.gns import batch_tensors, gns_forward_batch
from gns_torch.physics.common import build_graph
from gns_torch.train.trainer import TrainState, loss_and_grads, make_optimizer, make_train_step
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology
from torch_parallel_ranks import gns_tpu_step, hold_gns_tpu, hold_leaves, run_world

torch.set_num_threads(2)

CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, multiple_phi=True, reference_parity=False,
                seed=0)
CFGS = {
    "paper": CFG,
    "prod": CFG.replace(compute_dtype="bfloat16", fold_output="on"),
    "conv": CFG.replace(qg_gen_only=True, dispatch="setpoint_slack"),
}


def _np_params(cfg, seed):
    return jax.tree.map(np.asarray, init_gns_params(jax.random.key(seed), cfg))


@pytest.fixture(scope="module")
def inputs():
    return dict(
        batch=batch_from_cases(list(generate_cases(14, 7, seed=9))),  # 8 grids, E = 20
        cfgs=CFGS, params={k: _np_params(c, i) for i, (k, c) in enumerate(CFGS.items())},
        # case300 (E = 411) padded to a gp-divisible bucket
        batch300=batch_from_cases(list(generate_cases(300, 1, seed=3)), pad_sizes=(304, 416, 72)),
        params300=_np_params(CFG, 7),
    )


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_world("edge", 4, tmp_path_factory.mktemp("edge"), inputs)


def _single_forward(params, cfg, batch):
    model = module_from_jax_params(params, cfg, device="cpu")
    with torch.no_grad():
        return gns_forward_batch(model, cfg, batch, topo=extract_shared_topology(batch),
                                 dense=batch.is_dense())


@pytest.mark.parametrize("mode", sorted(CFGS))
def test_edge_partitioned_forward_matches(ranks, inputs, mode):
    got = ranks[0][f"fwd/{mode}"]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"fwd/{mode}"]["v"], got["v"])
    want = _single_forward(inputs["params"][mode], CFGS[mode], inputs["batch"])
    rtol, atol = ((1e-4, 1e-5) if mode == "prod" else (2e-5, 2e-6))
    np.testing.assert_allclose(got["v"], want.v.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["total_loss"], want.total_loss.numpy(), rtol=max(rtol, 2e-5))
    if mode == "conv":
        np.testing.assert_allclose(got["delta_q"], want.delta_q.numpy(), rtol=2e-4, atol=1e-5)
        # the reactive residual is live (Q8 fixed)
        assert float(np.abs(got["delta_q"]).max()) > 1e-3
    # per K step: the message aggregate, the Joule sum and the two paired
    # mismatch sums; the fold adds the step-invariant in-degree sum; one
    # all-gather of the outputs over dp
    want_coll = {"all_reduce": 4 * CFG.K + (1 if mode == "prod" else 0), "all_gather": 1}
    assert ranks[0][f"fwd_coll/{mode}"] == want_coll


def test_edge_partitioned_forward_matches_gns_tpu(ranks, inputs):
    mesh = j_make_mesh(dp=2, gp=2, devices=jax.devices()[:4])
    want = j_ep_forward(CFG, mesh, method="onehot")(inputs["params"]["paper"],
                                                    JGridBatch(*inputs["batch"]))
    got = ranks[0]["fwd/paper"]
    np.testing.assert_allclose(got["v"], np.asarray(want.v), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["total_loss"], np.asarray(want.total_loss), rtol=2e-4)


def test_edge_partitioned_case300_padded(ranks, inputs):
    want = _single_forward(inputs["params300"], CFG, inputs["batch300"])
    np.testing.assert_allclose(ranks[0]["case300"]["total_loss"], want.total_loss.numpy(),
                               rtol=5e-5)


@pytest.fixture(scope="module")
def single_step(inputs):
    batch = inputs["batch"][:4]
    topo = extract_shared_topology(batch)
    model = module_from_jax_params(inputs["params"]["paper"], CFG, device="cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    loss, last, grads = loss_and_grads(model, CFG, batch_tensors(batch, "cpu"), graph,
                                       dense=batch.is_dense())
    adam = make_optimizer(CFG)
    state = TrainState(model, adam.init(model.parameters()), torch.zeros((), dtype=torch.int32))
    make_train_step(CFG, adam, topo=topo, dense=batch.is_dense())(state, batch)
    return dict(loss=float(loss), last=float(last), grads=[g.numpy() for g in grads],
                adam={n: p.detach().numpy() for n, p in model.named_parameters()})


def test_edge_partitioned_gradients_match(ranks, single_step):
    """The strict invariant: each rank's summed gradient is the
    single-process gradient, leaf by leaf. The all-reduce's backward sums
    the ranks' output gradients, so without the 1/gp loss scale every leaf
    would be gp times too large, and without the sum over gp the
    replicated node MLPs would be 1/gp of their due: either fails here."""
    for r in ranks:
        hold_leaves(r["grads"], single_step["grads"])
    np.testing.assert_allclose(float(ranks[0]["metrics"]["loss"]), single_step["loss"], rtol=2e-5)
    np.testing.assert_allclose(float(ranks[0]["metrics"]["last_loss"]), single_step["last"],
                               rtol=2e-5)
    # forward 4 per K step, the backward's sums of each, the gradients' one
    assert ranks[0]["step_coll"] == {"all_reduce": 8 * CFG.K + 1}


def test_edge_partitioned_gradients_match_gns_tpu(ranks, inputs):
    """The port's edge-partitioned step and gns_tpu's on the same mesh
    shape, weights and batch: gradients leaf by leaf, and the losses."""
    mesh = j_make_mesh(dp=2, gp=2, devices=jax.devices()[:4])
    params = inputs["params"]["paper"]
    step = j_ep_train_step(CFG, mesh, optimizer=optax.sgd(1.0), method="onehot")
    delta, metrics = gns_tpu_step(step, params, JGridBatch(*inputs["batch"][:4]),
                                  optax.sgd(1.0))
    names = [n for n, _ in module_from_jax_params(params, CFG, device="cpu").named_parameters()]
    for r in ranks:
        hold_gns_tpu(dict(zip(names, r["grads"])), jax.tree.map(np.negative, delta), CFG)
    np.testing.assert_allclose(float(ranks[0]["metrics"]["loss"]), metrics["loss"], rtol=2e-4)
    np.testing.assert_allclose(float(ranks[0]["metrics"]["last_loss"]), metrics["last_loss"],
                               rtol=2e-4)


def test_edge_partitioned_train_step_matches(ranks, single_step):
    # Adam's sqrt(second-moment) normalization amplifies float32
    # reduction-order noise on near-zero gradients (gns_tpu's bound)
    for name, b in single_step["adam"].items():
        np.testing.assert_allclose(ranks[0]["adam"][name], b, rtol=5e-2, atol=2e-4, err_msg=name)


def test_parity_mode_rejected(ranks):
    for key in ("parity_fwd_error", "parity_step_error"):
        assert ranks[0][key] == (
            "ValueError: edge partitioning requires reference_parity=False"), key
