"""gns_torch's tensor-parallel and pipeline-parallel executors
(parallel/tensor_parallel.py, parallel/pipeline.py) on a 4-rank gloo mesh
on the CPU, against the port's single-process run and gns_tpu's
executors on the simulated devices.

One spawn (tests/torch_parallel_ranks.py job_tp_pp) runs every case: TP
on a (dp, tp) = (2, 2) mesh; PP over 2 stages (two replicas of the
pipeline side by side on the "unused" axis) and over 4 stages.

Tolerances are gns_tpu's (tests/test_tp_pp.py): forwards v / theta rtol
2e-5 / atol 1e-6, total_loss rtol 2e-5, last_loss rtol 2e-5 / atol 1e-7
(:42-46, :105-114); the step's loss rtol 2e-5 and gradients rtol 1e-3 /
atol 2e-5 (:62-73, :127-143); the bf16 + fold lowering rtol 1e-4 / atol
1e-5 (:163-166). A clipped step (grad_clip=1.0, Adagrad, whose first
update depends on the gradient's size, unlike Adam's) is held at the
gradients' bound on the updated parameters. Against gns_tpu: the
cross-package rtol / atol 2e-4 (tests/test_torch_model.py) on forwards
and losses; gns_tpu's make_tp_train_step and make_pipelined_train_step
on the same meshes, weights and batch, one step of optax.sgd(1.0) (minus
the gradient) against the port's recorded gradients, and one clipped
Adagrad step (gns_tpu's make_optimizer) against the port's change to each
leaf, both at tests/test_torch_train.py's cross-package gradient bound
(2e-4 of each leaf's largest entry) with tests/test_torch_parallel.py's
floor for the exactly-zero leaves.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.parallel.mesh import make_mesh as j_make_mesh
from gns_tpu.parallel.pipeline import make_pipelined_forward as j_pp_forward
from gns_tpu.parallel.pipeline import make_pipelined_train_step as j_pp_train_step
from gns_tpu.parallel.sharding import shard_batch as j_shard_batch
from gns_tpu.parallel.tensor_parallel import make_tp_train_step as j_tp_train_step
from gns_tpu.parallel.tensor_parallel import shard_params_tp as j_shard_params_tp
from gns_tpu.train.trainer import make_optimizer as j_make_optimizer
from gns_tpu.utils.prepare import GridBatch as JGridBatch
from gns_torch.models.convert import module_from_jax_params, state_dict_from_params
from gns_torch.models.gns import batch_tensors, gns_forward_batch
from gns_torch.parallel.tensor_parallel import tp_param_shardings
from gns_torch.physics.common import build_graph
from gns_torch.train.trainer import TrainState, loss_and_grads, make_optimizer, make_train_step
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology
from torch_parallel_ranks import gns_tpu_step, hold_gns_tpu, run_world

torch.set_num_threads(2)

CFG = GNSConfig(K=4, latent_dim=8, hidden_dim=8, multiple_phi=True, seed=0)
CLIP = CFG.replace(optimizer="adagrad", grad_clip=1.0)
PROD = CFG.replace(compute_dtype="bfloat16", fold_output="on", reference_parity=False)
PP_CASES = [(2, 2, True), (4, 1, True), (2, 4, False), (4, 2, True)]


@pytest.fixture(scope="module")
def inputs():
    cases = list(generate_cases(14, 8, seed=5))[1:]
    return dict(
        cfg=CFG, clip_cfg=CLIP, prod_cfg=PROD, pp_cases=PP_CASES,
        batch=batch_from_cases(cases + cases[:1])[:8],
        params=jax.tree.map(np.asarray, init_gns_params(jax.random.key(0), CFG)),
        prod_params=jax.tree.map(np.asarray, init_gns_params(jax.random.key(1), PROD)),
    )


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_world("tp_pp", 4, tmp_path_factory.mktemp("tp_pp"), inputs)


def _step(cfg, params, batch):
    """The port's single-process gradients, metrics and one update."""
    topo = extract_shared_topology(batch)
    model = module_from_jax_params(params, cfg, device="cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    loss, last, grads = loss_and_grads(model, cfg, batch_tensors(batch, "cpu"), graph,
                                       dense=batch.is_dense())
    opt = make_optimizer(cfg)
    state = TrainState(model, opt.init(model.parameters()), torch.zeros((), dtype=torch.int32))
    make_train_step(cfg, opt, topo=topo, dense=batch.is_dense())(state, batch)
    return dict(loss=float(loss), last=float(last), grads=[g.numpy() for g in grads],
                params={n: p.detach().numpy() for n, p in model.named_parameters()},
                names=[n for n, _ in model.named_parameters()])


@pytest.fixture(scope="module")
def single(inputs):
    batch = inputs["batch"]
    model = module_from_jax_params(inputs["params"], CFG, device="cpu")
    prod = module_from_jax_params(inputs["prod_params"], PROD, device="cpu")
    topo = extract_shared_topology(batch)
    with torch.no_grad():
        fwd = gns_forward_batch(model, CFG, batch, topo=topo, dense=batch.is_dense())
        prod_fwd = gns_forward_batch(prod, PROD, batch, topo=topo, dense=batch.is_dense())
    return dict(fwd=fwd, prod=prod_fwd, step=_step(CFG, inputs["params"], batch),
                clip=_step(CLIP, inputs["params"], batch), tp_dims=tp_param_shardings(model))


def _j_tp_mesh():
    return j_make_mesh(dp=2, gp=2, devices=jax.devices()[:4], axis_names=("dp", "tp"))


def _j_pp_mesh(stages):
    return j_make_mesh(dp=stages, gp=1, devices=jax.devices()[:stages],
                       axis_names=("pp", "unused"))


# the pipelined cases held against gns_tpu's step: both remat settings,
# 2 and 4 stages (each costs gns_tpu a compile of some 10-15 s here)
PP_VS_JAX = [(2, 2, True), (2, 4, False), (4, 2, True)]


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """gns_tpu's TP and pipelined train steps from the same weights, one
    optax.sgd(1.0) step each: (minus the change to each leaf, i.e. the
    step's gradient, metrics). "tp_clip" / "pp_clip": the change gns_tpu's
    clipped Adagrad (make_optimizer(CLIP)) makes from the TP and the
    2-stage pipelined gradients."""
    params, batch = inputs["params"], JGridBatch(*inputs["batch"])
    mesh = _j_tp_mesh()
    step = j_tp_train_step(CFG, mesh, optimizer=optax.sgd(1.0), method="onehot")
    out = {"tp": gns_tpu_step(
        lambda st, b: step(st, j_shard_batch(b, mesh, gp=None)), params, batch, optax.sgd(1.0),
        place=lambda st: st._replace(params=j_shard_params_tp(st.params, mesh)))}
    for stages, micro, remat in PP_VS_JAX:
        step = j_pp_train_step(CFG, _j_pp_mesh(stages), optimizer=optax.sgd(1.0),
                               microbatch=micro, remat=remat)
        out[_key((stages, micro, remat))] = gns_tpu_step(step, params, batch, optax.sgd(1.0))
    out = {k: (jax.tree.map(np.negative, delta), m) for k, (delta, m) in out.items()}
    opt = j_make_optimizer(CLIP)
    for key, src in (("tp_clip", "tp"), ("pp_clip", "2/2/True")):
        grads = out[src][0]
        updates, _ = opt.update(grads, opt.init(params), params)
        out[key] = (jax.tree.map(np.asarray, updates), out[src][1])
    return out


def _tp_slice(dim, value, tp_index):
    """A single-process leaf cut to a tp rank's slice (dim: the leaf's
    split dimension, tensor_parallel.tp_param_shardings; None: whole)."""
    if dim is None:
        return value
    half = CFG.hidden_dim // 2
    part = slice(tp_index * half, (tp_index + 1) * half)
    return value[part] if dim == 0 else value[:, part]


def _hold_fwd(got, want, rows=slice(None), rtol=2e-5, atol=1e-6):
    np.testing.assert_allclose(got["v"], want.v.numpy()[rows], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["theta"], want.theta.numpy()[rows], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["total_loss"], want.total_loss.numpy()[rows], rtol=max(rtol, 2e-5))
    np.testing.assert_allclose(got["last_loss"], want.last_loss.numpy()[rows], rtol=max(rtol, 2e-5),
                               atol=1e-7)


def test_tp_forward_matches(ranks, single):
    for r in ranks:
        rows = slice(4 * r["tp_rows"], 4 * r["tp_rows"] + 4)
        _hold_fwd(r["tp_fwd"], single["fwd"], rows)


def test_tp_forward_matches_gns_tpu(ranks, inputs):
    mesh = j_make_mesh(dp=2, gp=2, devices=jax.devices()[:4], axis_names=("dp", "tp"))
    out = jax.jit(lambda p, b: j_forward_batch(p, CFG, b, method="onehot"))(
        j_shard_params_tp(inputs["params"], mesh),
        j_shard_batch(JGridBatch(*inputs["batch"]), mesh, gp=None))
    for r in ranks:
        rows = slice(4 * r["tp_rows"], 4 * r["tp_rows"] + 4)
        np.testing.assert_allclose(r["tp_fwd"]["v"], np.asarray(out.v)[rows], rtol=2e-4, atol=2e-4)


def test_tp_train_step_gradients(ranks, single):
    """Each rank's gradients are single-process autograd's, cut to its
    slices: the sharded leaves are its own, the replicated ones whole (a
    replicated leaf summed over tp would be twice its due and fail)."""
    want = dict(zip(single["step"]["names"], single["step"]["grads"]))
    for rank, r in enumerate(ranks):
        for name, g in zip(r["tp_names"], r["tp_grads"]):
            np.testing.assert_allclose(g, _tp_slice(single["tp_dims"][name], want[name], rank % 2),
                                       rtol=1e-3, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(float(r["tp_metrics"]["loss"]), single["step"]["loss"],
                                   rtol=2e-5)
    # per K step two MLPs (phi, L) each with one forward all-reduce ("g")
    # and one backward all-reduce of its input's gradient ("f"), but for
    # step 0's phi input, which is data; one all-reduce of the gradients
    # over dp
    assert ranks[0]["tp_step_coll"] == {"all_reduce": 4 * CFG.K}
    assert ranks[0]["tp_init_step"] == 0


def test_tp_train_step_matches_gns_tpu(ranks, inputs, single, jax_steps):
    """The port's TP step and gns_tpu's on a (dp, tp) = (2, 2) mesh from the
    same weights: each rank's gradient slices, then each rank's change to
    its slices under the clipped Adagrad step, and the losses."""
    params = inputs["params"]
    tp_names = ranks[0]["tp_names"]
    grads = jax_steps["tp"][0]
    for rank, r in enumerate(ranks):
        def cut(name, value, rank=rank):
            return _tp_slice(single["tp_dims"][name], value, rank % 2)

        hold_gns_tpu(dict(zip(tp_names, r["tp_grads"])), grads, CFG, cut)
        start = state_dict_from_params(params, CLIP)
        moved = {n: p - cut(n, start[n]) for n, p in r["tp_clip_params"].items()}
        hold_gns_tpu(moved, jax_steps["tp_clip"][0], CLIP, cut)
    for key in ("tp_metrics", "tp_clip_metrics"):
        np.testing.assert_allclose(float(ranks[0][key]["loss"]), jax_steps["tp"][1]["loss"],
                                   rtol=2e-4)


def test_tp_clipped_step(ranks, single):
    """grad_clip=1.0 by the true global norm: the sharded leaves' squares
    all-reduced over tp, each replicated leaf counted once."""
    assert np.sqrt(sum(float((g ** 2).sum()) for g in single["clip"]["grads"])) > 1.0
    want = single["clip"]["params"]
    for rank, r in enumerate(ranks):
        for name, p in r["tp_clip_params"].items():
            np.testing.assert_allclose(p, _tp_slice(single["tp_dims"][name], want[name], rank % 2),
                                       rtol=1e-3, atol=2e-5, err_msg=name)
    assert ranks[0]["tp_clip_coll"] == {"all_reduce": 4 * CFG.K + 1}


def _key(case):
    return "/".join(str(x) for x in case)


@pytest.mark.parametrize("case", PP_CASES, ids=_key)
def test_pipeline_forward_matches(ranks, single, case):
    for r in ranks:
        _hold_fwd(r[f"pp_fwd/{_key(case)}"], single["fwd"])
    stages, micro, _ = case
    n_micro = 8 // micro
    # stage 0 sends every microbatch's carry, the last stage broadcasts
    assert ranks[0][f"pp_fwd_coll/{_key(case)}"] == {"send": n_micro, "broadcast": 1}
    if stages == 4:
        assert ranks[1][f"pp_fwd_coll/{_key(case)}"] == {"send": n_micro, "recv": n_micro,
                                                         "broadcast": 1}


@pytest.mark.parametrize("case", PP_CASES, ids=_key)
def test_pipeline_train_step_matches(ranks, single, case):
    """Gradients flow backward through the GPipe schedule (the carry's
    gradient sent stage to stage) and equal single-process autograd on
    every stage's leaves; remat=True recomputes each stage's steps."""
    stages, micro, _ = case
    want = single["step"]["grads"]
    seen = set()
    for r in ranks:
        for i, g in r[f"pp_grads/{_key(case)}"].items():
            np.testing.assert_allclose(g, want[i], rtol=1e-3, atol=2e-5, err_msg=str(i))
            seen.add(i)
        np.testing.assert_allclose(float(r[f"pp_metrics/{_key(case)}"]["loss"]),
                                   single["step"]["loss"], rtol=2e-5)
        np.testing.assert_allclose(float(r[f"pp_metrics/{_key(case)}"]["last_loss"]),
                                   single["step"]["last"], rtol=2e-5)
    assert seen == set(range(len(want)))
    n_micro = 8 // micro
    # stage 0: a carry out and its gradient back per microbatch, the metrics
    assert ranks[0][f"pp_step_coll/{_key(case)}"] == {"send": n_micro, "recv": n_micro,
                                                      "broadcast": 1}


@pytest.mark.parametrize("case", PP_VS_JAX, ids=_key)
def test_pipeline_train_step_matches_gns_tpu(ranks, single, jax_steps, case):
    """The port's pipelined step and gns_tpu's on the same stage count,
    microbatch and remat from the same weights: every stage's gradients,
    and the losses."""
    grads, metrics = jax_steps[_key(case)]
    names = single["step"]["names"]
    for r in ranks:
        got = {names[i]: g for i, g in r[f"pp_grads/{_key(case)}"].items()}
        hold_gns_tpu(got, grads, CFG)
        got = r[f"pp_metrics/{_key(case)}"]
        np.testing.assert_allclose(float(got["loss"]), metrics["loss"], rtol=2e-4)
        np.testing.assert_allclose(float(got["last_loss"]), metrics["last_loss"], rtol=2e-4)


def test_pipeline_clipped_step_matches_gns_tpu(ranks, inputs, jax_steps):
    """A clipped Adagrad step over 2 stages, gathered: the change to each
    leaf against the one gns_tpu's optimizer makes from its pipelined
    gradients."""
    start = state_dict_from_params(inputs["params"], CLIP)
    delta, metrics = jax_steps["pp_clip"]
    for r in ranks:
        moved = {n: p - start[n] for n, p in r["pp_clip_params"].items()}
        hold_gns_tpu(moved, delta, CLIP)
        np.testing.assert_allclose(float(r["pp_clip_metrics"]["loss"]), metrics["loss"],
                                   rtol=2e-4)


def test_pipeline_clipped_step(ranks, single):
    """grad_clip=1.0 by the norm over every stage's gradients (one
    all-reduce over pp); the stages' updated weights, gathered."""
    want = single["clip"]["params"]
    for r in ranks:
        for name, p in r["pp_clip_params"].items():
            np.testing.assert_allclose(p, want[name], rtol=1e-3, atol=2e-5, err_msg=name)
    assert ranks[0]["pp_clip_coll"] == {"send": 4, "recv": 4, "broadcast": 1, "all_reduce": 1}


def test_pipeline_forward_production_lowering(ranks, single):
    for r in ranks:
        got = r["pp_prod"]
        np.testing.assert_allclose(got["v"], single["prod"].v.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["total_loss"], single["prod"].total_loss.numpy(), rtol=1e-4)


def test_pipeline_forward_matches_gns_tpu(ranks, inputs):
    mesh = j_make_mesh(dp=2, gp=1, devices=jax.devices()[:2], axis_names=("pp", "unused"))
    out = j_pp_forward(CFG, mesh, microbatch=2)(inputs["params"], JGridBatch(*inputs["batch"]))
    got = ranks[0]["pp_fwd/2/2/True"]
    np.testing.assert_allclose(got["v"], np.asarray(out.v), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["total_loss"], np.asarray(out.total_loss), rtol=2e-4)


def test_pipeline_errors(ranks):
    assert ranks[0]["pp_k_error"] == "ValueError: K=3 not divisible by 2 stages"
    assert ranks[0]["pp_micro_error"] == "ValueError: batch size 8 not divisible by microbatch=3"
