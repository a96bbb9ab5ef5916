"""Per-rank programs of the parallel layer's CPU tests
(tests/test_torch_{solver_dp,parallel,edge_partition,tp_pp}.py).

`run_world(job, world, tmp_path)` spawns `world` processes that start a
gloo group through a FileStore under tmp_path (no TCP port, so parallel
test workers cannot collide), run JOBS[job] and pickle what each rank
returns; the caller gets the list of per-rank results. One spawn runs
every case of a test module, and the tests assert on the saved results.
Inputs come from the parent: `inputs.pkl` in tmp_path (numpy-seeded
cases and gns_tpu's initial weights as numpy arrays, carried into the
port by models/convert.py). The children import torch and gns_torch only,
and run with one thread each.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(job: str, world: int, tmp_path, inputs: dict) -> list:
    tmp = str(tmp_path)
    with open(os.path.join(tmp, f"{job}.inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_entry, args=(world, job, tmp), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{job}.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    errors = [f"rank {r} of {job}: {res['error']}" for r, res in enumerate(out) if "error" in res]
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _entry(rank: int, world: int, job: str, tmp: str):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"{job}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    with open(os.path.join(tmp, f"{job}.inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    try:
        res = JOBS[job](rank, inputs)
    except Exception:  # reported to the parent, which raises it
        res = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, f"{job}.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_np(v) for v in x)
    if hasattr(x, "_fields"):
        return {k: _np(v) for k, v in x._asdict().items()}
    return x


def _counted(fn):
    """(fn's result, the collectives it issued by kind)."""
    from gns_torch.ops import collectives

    collectives.reset_counts()
    out = fn()
    return out, dict(collectives.COUNTS)


def _raises(fn) -> str:
    try:
        fn()
    except Exception as exc:  # the message is what the tests read
        return f"{type(exc).__name__}: {exc}"
    return "no error"


class Recorder:
    """A GradientTransformation (train/trainer.py's interface) that keeps
    the gradients it is handed and applies plain -1 x gradient updates,
    so a test reads a train step's gradients leaf by leaf."""

    def __init__(self):
        self.grads = []

    def init(self, params):
        return {"count": torch.zeros((), dtype=torch.int32)}

    def update(self, grads, state, params=None):
        self.grads.append([g.detach().clone() for g in grads])
        return [-g for g in grads], {"count": state["count"] + 1}

    def transformation(self):
        from gns_torch.train.trainer import GradientTransformation

        return GradientTransformation(self.init, self.update)


def hold_leaves(got, want):
    """Gradients leaf by leaf: each within 5e-5 of its own largest entry
    plus 1e-5 of the largest entry of all leaves, the floor for leaves
    whose exact gradient is 0 (tests/test_torch_parallel.py's docstring).
    A leaf off by a factor of 2 fails unless it is below 2e-5 of the
    largest."""
    assert len(got) == len(want)
    floor = 1e-5 * max(np.abs(b).max() for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        err, bound = np.abs(a - b).max(), 5e-5 * np.abs(b).max() + floor
        assert err <= bound, f"leaf {i}: {err:.3e} > {bound:.3e}"


def gns_tpu_step(step, params, batch, optimizer, place=lambda tree: tree):
    """One gns_tpu train step from `params` (a numpy tree) with `optimizer`
    (an optax transformation), in the parent process: (the change it made
    to each leaf, as a numpy tree, and its metrics). place: commits the
    TrainState to the step's mesh layout. With optax.sgd(1.0) the change is
    minus the step's gradient."""
    import jax
    import jax.numpy as jnp

    from gns_tpu.train.trainer import TrainState

    p0 = jax.tree.map(jnp.asarray, params)
    state = place(TrainState(p0, jax.jit(optimizer.init)(p0), jnp.zeros((), jnp.int32)))
    new, metrics = step(state, batch)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.params, params)
    return delta, {k: float(v) for k, v in metrics.items()}


def hold_gns_tpu(got: dict, want_tree, cfg, cut=lambda name, value: value):
    """The port's arrays by parameter name (gradients, or a step's change
    to each leaf) against gns_tpu's tree of the same, carried to the
    port's names by models/convert.py: tests/test_torch_train.py's
    cross-package gradient bound, 2e-4 of each leaf's largest entry, with
    hold_leaves' floor (1e-5 of the largest entry of all leaves) for the
    leaves whose exact value is 0. cut(name, value): the part of gns_tpu's
    whole leaf this rank holds (a tensor-parallel slice)."""
    from gns_torch.models.convert import state_dict_from_params

    want = state_dict_from_params(want_tree, cfg)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for name, a in got.items():
        b = cut(name, want[name])
        err, bound = np.abs(a - b).max(), 2e-4 * np.abs(b).max() + floor
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _module(params, cfg):
    from gns_torch.models.convert import module_from_jax_params

    return module_from_jax_params(params, cfg, device="cpu")


def _state(params, cfg, optimizer):
    from gns_torch.train.trainer import TrainState

    model = _module(params, cfg)
    return TrainState(model, optimizer.init(model.parameters()), torch.zeros((), dtype=torch.int32))


def _params_np(model):
    return {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}


# --------------------------------------------------------------------------
# solver_dp: every solver, screen and the predictor on a ("dp",) mesh


def job_solver(rank, inp):
    from gns_torch.eval import contingency, dcpf, fdpf, hybrid, n2, nr_batched, solve
    from gns_torch.parallel.solver_dp import padded_rows, solver_mesh
    from gns_torch.serve import GNSPredictor

    mesh = solver_mesh(device_type="cpu")
    grids, cfg = inp["grids14"], inp["cfg"]
    model = _module(inp["params"], cfg)
    cpu = dict(device="cpu")
    res = {"padded": [padded_rows(12, mesh), padded_rows(16, mesh), padded_rows(1, mesh),
                      padded_rows(12, None)]}
    res["nr"], res["nr_coll"] = _counted(
        lambda: nr_batched.solve_batched(grids, mesh=mesh, **cpu))
    res["nr5"], res["nr5_coll"] = _counted(
        lambda: nr_batched.solve_batched(grids, chunk_size=5, mesh=mesh, **cpu))
    res["nr_compact"] = nr_batched.solve_batched(grids, compact_after=1, mesh=mesh, **cpu)
    res["fdpf"], res["fdpf_coll"] = _counted(
        lambda: fdpf.solve_batched_fdpf(grids, mesh=mesh, **cpu))
    res["dc"] = dcpf.solve_batched_dc(grids, mesh=mesh, **cpu)
    res["ac"] = solve.solve_ac(grids, mesh=mesh, **cpu)
    res["mixed"] = nr_batched.solve_mixed(inp["mixed"], method="auto", mesh=mesh, **cpu)
    res["hybrid"] = hybrid.hybrid_solve(model, cfg, grids, mesh=mesh)
    res["screen"] = contingency.screen_n1(inp["case14"], gen_outages=True, mesh=mesh, **cpu)
    res["ranked"] = contingency.screen_n1_ranked(inp["case14"], model, cfg, top_k=8, mesh=mesh,
                                                 **cpu)
    res["n2"], res["n2_coll"] = _counted(
        lambda: n2.screen_n2(inp["case14"], chunk_size=64, mesh=mesh, **cpu))
    res["n2_ranked"] = n2.screen_n2_ranked(inp["case14"], model, cfg, top_k=16, chunk_size=64,
                                           mesh=mesh, **cpu)
    res["pred"], res["pred_coll"] = _counted(
        lambda: GNSPredictor(model, cfg, batch_size=8, mesh=mesh, **cpu).predict(grids))
    res["pred_error"] = _raises(lambda: GNSPredictor(model, cfg, batch_size=10, mesh=mesh, **cpu))
    return _np(res)


# --------------------------------------------------------------------------
# sharding: forward and train step on dp, dp x gp and dcn x dp x gp meshes

TRAIN_MESHES = {"dp4": (4, 1), "dp2_gp2": (2, 2), "dcn2_dp1_gp2": None}


def _train_mesh(name):
    from gns_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    if name == "dcn2_dp1_gp2":
        return make_hybrid_mesh(dcn=2, dp=1, gp=2, device_type="cpu"), ("dcn", "dp")
    dp, gp = TRAIN_MESHES[name]
    return make_mesh(dp=dp, gp=gp, device_type="cpu"), "dp"


def job_sharding(rank, inp):
    from gns_torch.parallel.sharding import (make_sharded_eval_step, make_sharded_train_step,
                                             replicate)
    from gns_torch.train.trainer import make_optimizer

    batch = inp["batch"]
    res = {}
    for name in TRAIN_MESHES:
        mesh, dp = _train_mesh(name)
        for mode, cfg in inp["cfgs"].items():
            params = inp["params"][mode]
            fwd = make_sharded_eval_step(cfg, mesh, dp=dp)
            res[f"fwd/{name}/{mode}"], res[f"fwd_coll/{name}/{mode}"] = _counted(
                lambda: fwd(_module(params, cfg), batch))
            rec = Recorder()
            step = make_sharded_train_step(cfg, mesh, optimizer=rec.transformation(), dp=dp)
            state = replicate(_state(params, cfg, rec), mesh)
            (_, metrics), coll = _counted(lambda: step(state, batch))
            res[f"grads/{name}/{mode}"] = [g.numpy() for g in rec.grads[0]]
            res[f"metrics/{name}/{mode}"] = _np(metrics)
            res[f"step_coll/{name}/{mode}"] = coll
            adam = make_optimizer(cfg)
            step = make_sharded_train_step(cfg, mesh, optimizer=adam, dp=dp)
            state = _state(params, cfg, adam)
            step(state, batch)
            res[f"adam/{name}/{mode}"] = _params_np(state.model)
    return _np(res)


# --------------------------------------------------------------------------
# edge partition


def job_edge(rank, inp):
    from gns_torch.parallel.edge_partition import (make_edge_partitioned_forward,
                                                   make_edge_partitioned_train_step)
    from gns_torch.parallel.mesh import make_mesh
    from gns_torch.train.trainer import make_optimizer

    mesh = make_mesh(dp=2, gp=2, device_type="cpu")
    mesh_gp4 = make_mesh(dp=1, gp=4, device_type="cpu")
    batch = inp["batch"]
    res = {}
    for mode, cfg in inp["cfgs"].items():
        fwd = make_edge_partitioned_forward(cfg, mesh)
        res[f"fwd/{mode}"], res[f"fwd_coll/{mode}"] = _counted(
            lambda: fwd(_module(inp["params"][mode], cfg), batch))
    cfg = inp["cfgs"]["paper"]
    fwd = make_edge_partitioned_forward(cfg, mesh_gp4, dp=None)
    res["case300"] = _np(fwd(_module(inp["params300"], cfg), inp["batch300"]))
    rec = Recorder()
    step = make_edge_partitioned_train_step(cfg, mesh, optimizer=rec.transformation())
    (_, metrics), res["step_coll"] = _counted(
        lambda: step(_state(inp["params"]["paper"], cfg, rec), inp["batch"][:4]))
    res["grads"] = [g.numpy() for g in rec.grads[0]]
    res["metrics"] = _np(metrics)
    adam = make_optimizer(cfg)
    state = _state(inp["params"]["paper"], cfg, adam)
    make_edge_partitioned_train_step(cfg, mesh)(state, inp["batch"][:4])
    res["adam"] = _params_np(state.model)
    parity = cfg.replace(reference_parity=True)
    res["parity_fwd_error"] = _raises(lambda: make_edge_partitioned_forward(parity, mesh))
    res["parity_step_error"] = _raises(lambda: make_edge_partitioned_train_step(parity, mesh))
    return _np(res)


# --------------------------------------------------------------------------
# tensor and pipeline parallel


def job_tp_pp(rank, inp):
    from gns_torch.models.gns import gns_forward, step_params
    from gns_torch.parallel.mesh import make_mesh
    from gns_torch.parallel.pipeline import (gather_stage_params, make_pipelined_forward,
                                             make_pipelined_train_step, stage_param_indices)
    from gns_torch.parallel.sharding import _Local, axis_group
    from gns_torch.parallel.tensor_parallel import (make_tp_train_step, shard_params_tp,
                                                    tp_init_train_state)
    from gns_torch.train.trainer import TrainState, make_optimizer

    cfg, params, batch = inp["cfg"], inp["params"], inp["batch"]
    res = {}
    tp_mesh = make_mesh(dp=2, gp=2, axis_names=("dp", "tp"), device_type="cpu")
    local = shard_params_tp(_module(params, cfg), tp_mesh)
    view = _Local(cfg, tp_mesh, "dp", None, None, "auto")
    tensors, graph, dense, _ = view(batch)
    with torch.no_grad():
        out = gns_forward(step_params(local, cfg), cfg, tensors, graph, dense=dense,
                          tp_group=axis_group(tp_mesh, "tp"))
    res["tp_fwd"] = _np(out)
    res["tp_rows"] = view.mesh.get_local_rank("dp")
    rec = Recorder()
    step = make_tp_train_step(cfg, tp_mesh, optimizer=rec.transformation())
    state = TrainState(shard_params_tp(_module(params, cfg), tp_mesh),
                       rec.init(None), torch.zeros((), dtype=torch.int32))
    (_, metrics), res["tp_step_coll"] = _counted(lambda: step(state, batch))
    res["tp_grads"] = [g.numpy() for g in rec.grads[0]]
    res["tp_names"] = [n for n, _ in state.model.named_parameters()]
    res["tp_metrics"] = _np(metrics)
    clip = inp["clip_cfg"]
    state = TrainState(shard_params_tp(_module(params, clip), tp_mesh), None, None)
    opt = make_optimizer(clip)
    state = TrainState(state.model, opt.init(state.model.parameters()),
                       torch.zeros((), dtype=torch.int32))
    (_, res["tp_clip_metrics"]), res["tp_clip_coll"] = _counted(
        lambda: make_tp_train_step(clip, tp_mesh)(state, batch))
    res["tp_clip_params"] = _params_np(state.model)
    res["tp_init_step"] = int(tp_init_train_state(0, cfg, tp_mesh).step)

    for stages, micro, remat in inp["pp_cases"]:
        mesh = make_mesh(dp=stages, gp=4 // stages, axis_names=("pp", "unused"),
                         device_type="cpu")
        key = f"{stages}/{micro}/{remat}"
        fwd = make_pipelined_forward(cfg, mesh, microbatch=micro)
        res[f"pp_fwd/{key}"], res[f"pp_fwd_coll/{key}"] = _counted(
            lambda: fwd(_module(params, cfg), batch))
        rec = Recorder()
        step = make_pipelined_train_step(cfg, mesh, optimizer=rec.transformation(),
                                         microbatch=micro, remat=remat)
        state = _state(params, cfg, rec)
        (_, metrics), res[f"pp_step_coll/{key}"] = _counted(lambda: step(state, batch))
        stage = mesh.get_local_rank("pp")
        res[f"pp_grads/{key}"] = dict(zip(stage_param_indices(state.model, cfg, stage, stages),
                                          (g.numpy() for g in rec.grads[0])))
        res[f"pp_metrics/{key}"] = _np(metrics)
    mesh = make_mesh(dp=2, gp=2, axis_names=("pp", "unused"), device_type="cpu")
    clip = inp["clip_cfg"]
    opt = make_optimizer(clip)
    state = _state(params, clip, opt)
    (_, res["pp_clip_metrics"]), res["pp_clip_coll"] = _counted(
        lambda: make_pipelined_train_step(clip, mesh, microbatch=2)(state, batch))
    res["pp_clip_params"] = _params_np(gather_stage_params(state.model, clip, mesh))
    prod = inp["prod_cfg"]
    res["pp_prod"] = _np(make_pipelined_forward(prod, mesh, microbatch=2)(
        _module(inp["prod_params"], prod), batch))
    res["pp_k_error"] = _raises(lambda: make_pipelined_forward(cfg.replace(K=3), mesh))
    res["pp_micro_error"] = _raises(
        lambda: make_pipelined_forward(cfg, mesh, microbatch=3)(_module(params, cfg), batch))
    return _np(res)


JOBS = {"solver": job_solver, "sharding": job_sharding, "edge": job_edge, "tp_pp": job_tp_pp}
