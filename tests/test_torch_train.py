"""gns_torch's training path against gns_tpu's, on the CPU.

Sizes are tests/test_train.py's (case14, K=2, latent 8, hidden 8, batch 8,
16 grids). Inputs come from numpy seeds; parameters are gns_tpu's
init_gns_params carried over with module_from_jax_params, so both packages
start from the same weights. Tolerances:
  * gradients, per leaf: max |port - jax| <= 2e-4 * max |jax leaf| + 1e-6,
    the forward's parity tolerance (tests/test_torch_model.py, 2e-4) taken
    relative to each leaf's scale;
  * optimizer vs optax: rtol 1e-6, atol 1e-7 (the same float32 formulas;
    the global norm sums its leaves in another order);
  * train() / train_multi() epoch losses: rtol 1e-3 (three epochs of
    updates from gradients that agree to 2e-4);
  * unfused physics: rtol 1e-5 / atol 1e-6, as tests/test_torch_physics.py,
    but parity mode's delta_q (quirk Q8: 0 but for rounding) within 1e-5 of
    qg_new's largest value.
Port-only checks (epoch step against a loop of steps, remat, resume) are
bit for bit.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.physics.compensation import global_active_compensation as j_compensation
from gns_tpu.physics.imbalance import local_power_imbalance as j_imbalance
from gns_tpu.physics.lineflow import active_line_flow as j_line_flow
from gns_tpu.train import checkpoint as j_ckpt
from gns_tpu.train import trainer as j_trainer
from gns_tpu.utils import prepare as j_prepare
from gns_torch.models.convert import module_from_jax_params, params_from_state_dict
from gns_torch.models.gns import batch_tensors
from gns_torch.physics.common import build_graph
from gns_torch.physics.compensation import global_active_compensation
from gns_torch.physics.fused import physics_refresh
from gns_torch.physics.imbalance import local_power_imbalance
from gns_torch.physics.lineflow import active_line_flow
from gns_torch.train import checkpoint as ckpt
from gns_torch.train.__main__ import main as cli_main
from gns_torch.train.trainer import (
    TrainState,
    loss_and_grads,
    make_epoch_step,
    make_optimizer,
    make_train_step,
    stack_epoch,
    train,
    train_multi,
)
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils import profiling
from gns_torch.utils.prepare import (
    batch_from_cases,
    extract_shared_topology,
    load_all_grids,
)

torch.set_num_threads(1)

CFG = GNSConfig(
    K=2, latent_dim=8, hidden_dim=8, multiple_phi=True,
    batch_size=8, nr_samples=16, epochs=8, seed=0,
)
PHYS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data14():
    return batch_from_cases(list(generate_cases(14, 16, seed=3))[1:])


def _jbatch(batch):
    return j_prepare.GridBatch(*batch)


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, init_gns_params(jax.random.key(seed), cfg))


def _state(cfg, params_np):
    """The port's TrainState on the CPU around gns_tpu's parameters."""
    model = module_from_jax_params(params_np, cfg, device="cpu")
    return TrainState(model, make_optimizer(cfg).init(model.parameters()),
                      torch.zeros((), dtype=torch.int32))


def _grad_tree(model, cfg, grads):
    names = [n for n, _ in model.named_parameters()]
    return params_from_state_dict(dict(zip(names, grads)), cfg)


GRAD_MODES = {
    "parity": dict(reference_parity=True),
    "paper_fold": dict(reference_parity=False, fold_output="on"),
    "single_phi": dict(reference_parity=True, multiple_phi=False),
}


@pytest.mark.parametrize("mode", sorted(GRAD_MODES))
def test_gradients_match_jax(mode, data14):
    """One batch's gradients of mean(total_loss): the port's autograd
    through its plain twins against jax.grad through gns_tpu."""
    cfg = CFG.replace(**GRAD_MODES[mode])
    batch = data14[:8]
    params = _np_params(cfg)
    jb = _jbatch(batch)
    topo_j = j_prepare.extract_shared_topology(jb)

    def loss(p):
        out = j_forward_batch(p, cfg, jb, method="scatter", topo=topo_j, dense=jb.is_dense())
        return jnp.mean(out.total_loss)

    want = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
    model = module_from_jax_params(params, cfg, device="cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    _, _, grads = loss_and_grads(model, cfg, batch_tensors(batch, "cpu"), graph,
                                 dense=batch.is_dense())
    got = _grad_tree(model, cfg, grads)
    for head, block in want.items():
        for name, leaf in block.items():
            w = np.asarray(leaf)
            err = np.abs(got[head][name] - w).max()
            bound = 2e-4 * np.abs(w).max() + 1e-6
            assert err <= bound, f"{mode} {head}.{name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("opt", ["adam", "adagrad"])
def test_optimizer_matches_optax(opt, clip, warmup):
    """make_optimizer against gns_tpu's optax chain on one seeded sequence
    of gradients, 5 updates. The gradients' global norm runs from about 0.5
    to 50, so with clip 1.0 some updates are clipped and some are not."""
    cfg = CFG.replace(optimizer=opt, grad_clip=clip, warmup_steps=warmup)
    rng = np.random.default_rng(7)
    shapes = [(3, 4), (4,), (2, 5, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    seq = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
           for scale in (0.1, 10.0, 1.0, 5.0, 0.3)]

    j_opt = j_trainer.make_optimizer(cfg)
    jp = {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}
    j_state = j_opt.init(jp)
    mine = make_optimizer(cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    state = mine.init(tp)
    for k, grads in enumerate(seq):
        updates, j_state = j_opt.update({f"p{i}": jnp.asarray(g) for i, g in enumerate(grads)},
                                        j_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        upd, state = mine.update([torch.from_numpy(g) for g in grads], state, tp)
        tp = [p + u for p, u in zip(tp, upd)]
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[f"p{i}"]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {k} leaf {i}")
    assert int(state["count"]) == len(seq) and state["count"].dtype == torch.int32


def test_warmup_first_step_moves_nothing_but_the_moments():
    """linear_schedule(0, lr, n) reads the count before the update: the
    first update is 0, while Adam's moments advance."""
    cfg = CFG.replace(warmup_steps=4)
    opt = make_optimizer(cfg)
    p = [torch.ones(3)]
    state = opt.init(p)
    upd, state = opt.update([torch.full((3,), 2.0)], state, p)
    assert torch.equal(upd[0], torch.zeros(3))
    assert torch.allclose(state["mu"][0], torch.full((3,), 0.2))


def _j_state(cfg, params_np):
    params = jax.tree.map(jnp.asarray, params_np)
    return j_trainer.TrainState(params, j_trainer.make_optimizer(cfg).init(params),
                                jnp.zeros((), jnp.int32))


def test_train_matches_gns_tpu(data14):
    """3 epochs of train() from the same parameters: each epoch's
    final_loss against gns_tpu's train()."""
    cfg = CFG.replace(epochs=3)
    params = _np_params(cfg, seed=1)
    _, want = j_trainer.train(cfg, _jbatch(data14), method="scatter", state=_j_state(cfg, params))
    best, got = train(cfg, data14, state=_state(cfg, params))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1, 2]
    np.testing.assert_allclose([r["final_loss"] for r in got], [r["final_loss"] for r in want],
                               rtol=1e-3)
    assert not any(r["diverged"] for r in got)
    assert next(best.model.parameters()).device.type == "cpu"


def test_train_padded_mixed_batch_matches_gns_tpu():
    """train() on a padded case9 + case14 dataset (no shared topology: the
    epoch takes its eager path, as it does on the card) for 2 epochs of 2
    batches that mix both cases: each epoch's final_loss against gns_tpu's
    train(), which scans the same batches with topo=None (rtol 1e-3)."""
    c9 = list(generate_cases(9, 4, seed=11))[1:]
    c14 = list(generate_cases(14, 4, seed=12))[1:]
    data = batch_from_cases([c for pair in zip(c9, c14) for c in pair])
    assert not data.is_dense() and extract_shared_topology(data) is None
    cfg = CFG.replace(epochs=2, batch_size=4)
    params = _np_params(cfg, seed=2)
    _, want = j_trainer.train(cfg, _jbatch(data), method="scatter", state=_j_state(cfg, params))
    _, got = train(cfg, data, state=_state(cfg, params))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    np.testing.assert_allclose([r["final_loss"] for r in got], [r["final_loss"] for r in want],
                               rtol=1e-3)
    assert not any(r["diverged"] for r in got)


def test_early_stop_matches_gns_tpu(data14):
    """lr 0 keeps the loss constant: both stop after patience + 1
    non-improving epochs, at the same epoch, and call checkpoint_fn once."""
    cfg = CFG.replace(epochs=50, early_stop_patience=1, learning_rate=0.0)
    params = _np_params(cfg)
    _, want = j_trainer.train(cfg, _jbatch(data14), method="scatter", state=_j_state(cfg, params))
    calls = []
    _, got = train(cfg, data14, state=_state(cfg, params),
                   checkpoint_fn=lambda s, e, l: calls.append(e))
    assert len(got) == len(want) == cfg.early_stop_patience + 2
    assert calls == [0]


def test_train_multi_matches_gns_tpu():
    """train_multi over a case9 and a case14 group (paper physics, as
    tests/test_train.py): the per-group epoch losses."""
    cfg = GNSConfig(K=2, latent_dim=6, hidden_dim=6, epochs=3, batch_size=4,
                    reference_parity=False, seed=0)
    datasets = [batch_from_cases(list(generate_cases(9, 4, seed=1))[1:]),
                batch_from_cases(list(generate_cases(14, 4, seed=2))[1:])]
    params = _np_params(cfg)
    _, want = j_trainer.train_multi(cfg, [_jbatch(d) for d in datasets],
                                    state=_j_state(cfg, params))
    _, got = train_multi(cfg, datasets, state=_state(cfg, params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["group_losses"], w["group_losses"], rtol=1e-3)
        assert len(g["group_losses"]) == 2


def _tensors(state):
    out = [p.detach() for p in state.model.parameters()]
    for v in state.opt_state.values():
        out.extend(v if isinstance(v, list) else [v])
    return out + [state.step]


def test_epoch_step_equals_step_loop(data14):
    """make_epoch_step over two batches is bit-equal to two calls of
    make_train_step: parameters, optimizer state, step and losses."""
    params = _np_params(CFG)
    topo = extract_shared_topology(data14)
    a, b = _state(CFG, params), _state(CFG, params)
    _, m_epoch = make_epoch_step(CFG, topo=topo, dense=True)(a, stack_epoch(data14, 8))
    step = make_train_step(CFG, topo=topo, dense=True)
    losses = [step(b, data14[i * 8:(i + 1) * 8])[1]["loss"] for i in range(2)]
    assert torch.equal(m_epoch["loss"], torch.stack(losses))
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)
    assert int(a.step) == 2


def test_eager_epoch_span_tree(data14):
    """Recorded, an eager epoch (the CPU) is one train.epoch root with one
    train.step per batch inside it, and K model.step spans inside each
    train.step, all of the root's unit."""
    topo = extract_shared_topology(data14)
    state = _state(CFG, _np_params(CFG))
    epoch = make_epoch_step(CFG, topo=topo, dense=True)
    with profiling.recording():
        for _ in range(2):
            epoch(state, stack_epoch(data14, 8))
    rec = profiling.recorded()
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["train.epoch"] * 2
    for root in roots:
        unit = [s for s in rec.spans if s.unit == root.unit and s is not root]
        steps = [s for s in unit if s.parent == root.id]
        assert [s.name for s in steps] == ["train.step"] * 2
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in steps)
        inner = [s for s in unit if s.parent != root.id]
        assert [s.name for s in inner] == ["model.step"] * (2 * CFG.K)
        assert sorted(s.parent for s in inner) == sorted([s.id for s in steps] * CFG.K)
    # no capture on the CPU; each step built once, its refresh the eager chain
    assert rec.counted() == {"model.eager_refreshes": 2 * 2 * CFG.K, "train.steps_built": 2 * 2}


def test_remat_gradients_equal(data14):
    """cfg.remat=True recomputes each K step in the backward: the same
    gradients (rtol 1e-6)."""
    params = _np_params(CFG)
    batch = data14[:8]
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    grads = {}
    for remat in (False, True):
        cfg = CFG.replace(remat=remat)
        assert cfg.resolved_remat is remat
        model = module_from_jax_params(params, cfg, device="cpu")
        grads[remat] = loss_and_grads(model, cfg, batch_tensors(batch, "cpu"), graph, dense=True)[2]
    for x, y in zip(grads[False], grads[True]):
        torch.testing.assert_close(y, x, rtol=1e-6, atol=0)


def test_resume_is_bit_exact(tmp_path, data14):
    """Two epochs, save, load, two more epochs: bit-equal to four epochs."""
    params = _np_params(CFG)
    topo = extract_shared_topology(data14)
    stacked = stack_epoch(data14, 8)
    whole = _state(CFG, params)
    epoch = make_epoch_step(CFG, topo=topo, dense=True)
    for _ in range(4):
        epoch(whole, stacked)
    half = _state(CFG, params)
    for _ in range(2):
        epoch(half, stacked)
    path = str(tmp_path / "state.pt")
    ckpt.save_checkpoint(path, half)
    resumed = ckpt.load_checkpoint(path, CFG, device="cpu")
    epoch2 = make_epoch_step(CFG, topo=topo, dense=True)
    for _ in range(2):
        epoch2(resumed, stacked)
    for x, y in zip(_tensors(whole), _tensors(resumed)):
        assert torch.equal(x, y)
    assert int(resumed.step) == 8


def test_pth_round_trips_with_gns_tpu(tmp_path):
    """The reference-layout .pth both ways: the port's export read by
    gns_tpu's import_torch, and gns_tpu's export read by the port's."""
    params = _np_params(CFG, seed=2)
    state = _state(CFG, params)
    path = str(tmp_path / "port.pth")
    ckpt.export_torch(path, state, CFG)
    back = j_ckpt.import_torch(path, CFG)
    want = params_from_state_dict(state.model.state_dict(), CFG)
    for head, block in want.items():
        for name, leaf in block.items():
            np.testing.assert_array_equal(np.asarray(back.params[head][name]), leaf)

    path = str(tmp_path / "jax.pth")
    j_ckpt.export_torch(path, _j_state(CFG, params), CFG)
    mine = ckpt.import_torch(path, CFG, device="cpu")
    got = params_from_state_dict(mine.model.state_dict(), CFG)
    for head, block in params.items():
        for name, leaf in block.items():
            np.testing.assert_array_equal(got[head][name], leaf)
    assert int(mine.step) == 0 and int(mine.opt_state["count"]) == 0
    assert ckpt.checkpoint_name(CFG) == j_ckpt.checkpoint_name(CFG)


def _mixed_batch():
    cs = [*generate_cases(9, 1, seed=11), *generate_cases(14, 1, seed=12)]
    return batch_from_cases(cs)


PHYS_MODES = {
    "parity": dict(reference_parity=True),
    "paper": dict(reference_parity=False),
    "paper_qg_gen_only": dict(reference_parity=False, qg_gen_only=True),
}


@pytest.mark.parametrize("mode", sorted(PHYS_MODES))
def test_unfused_physics_matches(mode):
    """global_active_compensation, local_power_imbalance and
    active_line_flow on a padded case9 + case14 batch against gns_tpu's,
    and compensation then imbalance against the port's own fused
    physics_refresh (the identity gns_tpu/physics/fused.py:80-81 states)."""
    kw = PHYS_MODES[mode]
    batch = _mixed_batch()
    rng = np.random.default_rng(3)
    s, n = batch.buses.shape[:2]
    v = (1.0 + 0.05 * rng.standard_normal((s, n))).astype(np.float32)
    theta = (0.1 * rng.standard_normal((s, n))).astype(np.float32)
    jmask = dict(method="scatter", **kw)

    def one(v1, th1, b, l, g, bm, lm, gm):
        masks = dict(bus_mask=bm, line_mask=lm, gen_mask=gm)
        pg, qg = j_compensation(v1, th1, b, l, g, **masks, **jmask)
        dp, dq = j_imbalance(v1, th1, b, l, g, pg, qg, method="scatter",
                             reference_parity=kw["reference_parity"], **masks)
        return pg, qg, dp, dq, j_line_flow(v1, th1, l)

    ref = jax.vmap(one)(v, theta, batch.buses, batch.lines, batch.generators,
                        batch.bus_mask, batch.line_mask, batch.gen_mask)
    graph = build_graph(batch.buses, batch.lines, batch.generators, None, "cpu")
    bt = batch_tensors(batch, "cpu")
    tv, tt = torch.from_numpy(v), torch.from_numpy(theta)
    masks = dict(bus_mask=bt.bus_mask, line_mask=bt.line_mask, gen_mask=bt.gen_mask)
    pg, qg = global_active_compensation(tv, tt, bt.buses, bt.lines, bt.generators, graph,
                                        **masks, **kw)
    dp, dq = local_power_imbalance(tv, tt, bt.buses, bt.lines, bt.generators, pg, qg, graph,
                                   reference_parity=kw["reference_parity"], **masks)
    flow = active_line_flow(tv, tt, bt.lines, graph)
    # in parity mode delta_q is quirk Q8's residual, 0 in exact arithmetic:
    # what is left is the rounding of qg_new's terms, so it is held to
    # 1e-5 of their size rather than to 1e-6
    q8 = dict(rtol=0.0, atol=1e-5 * float(qg.abs().max())) if kw["reference_parity"] else PHYS_TOL
    tols = (PHYS_TOL, PHYS_TOL, PHYS_TOL, q8, PHYS_TOL)
    for name, a, b, tol in zip(("pg_new", "qg_new", "delta_p", "delta_q", "line_flow"),
                               (pg, qg, dp, dq, flow), ref, tols):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)
    fused = physics_refresh(tv, tt, bt.buses, bt.lines, bt.generators, graph, **masks, **kw)
    for name, a, b, tol in zip(("pg_new", "qg_new", "delta_p", "delta_q"), (pg, qg, dp, dq), fused,
                               tols):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"fused {name}", **tol)


def test_masked_batch_trains_through_the_kernel_backward():
    """A padded, masked case9 + case14 batch (per-sample topology) takes
    update steps. On the card the backward of every K1 sum is a K2 gather,
    which needs every segment id in range: padded lines and generators
    point at the dead bus slot, so every index of the batch is in range."""
    batch = _mixed_batch()
    assert not batch.is_dense() and extract_shared_topology(batch) is None
    graph = build_graph(batch.buses, batch.lines, batch.generators, None, "cpu")
    for name, index in graph._asdict().items():
        assert index.in_range, name
    cfg = CFG.replace(batch_size=2)
    state = _state(cfg, _np_params(cfg))
    before = [p.detach().clone() for p in state.model.parameters()]
    step = make_train_step(cfg)
    for _ in range(2):
        _, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
    assert int(state.step) == 2
    assert any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


def test_load_all_grids_matches(tmp_path):
    """pickle_path / prepare_grid / load_all_grids read the reference's
    augmented pickles as gns_tpu does, bit for bit."""
    os.makedirs(tmp_path / "case14")
    cases = list(generate_cases(14, 4, seed=5))
    for i, case in enumerate(cases):
        with open(tmp_path / "case14" / f"augmented_case14_{i}.pkl", "wb") as f:
            pickle.dump(case, f)
    for test_set in (False, True):
        got = load_all_grids(14, 3, test_set=test_set, data_dir=str(tmp_path), total_grids=5)
        want = j_prepare.load_all_grids(14, 3, test_set=test_set, data_dir=str(tmp_path),
                                        total_grids=5)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_cli_trains_on_the_cpu(tmp_path):
    """python -m gns_torch.train --cpu: 2 epochs of case14 from the
    repository's prepared data; writes the checkpoint, the .pth and the
    metrics CSV."""
    out, runs = tmp_path / "models", tmp_path / "runs"
    cli_main(["--case", "14", "--nr-samples", "16", "--batch-size", "8", "--epochs", "2",
              "--K", "2", "--latent", "8", "--hidden", "8", "--cpu", "--export-torch",
              "--out-dir", str(out), "--runs-dir", str(runs)])
    name = ckpt.checkpoint_name(GNSConfig(case_nr=14, K=2, latent_dim=8, hidden_dim=8))
    assert (out / f"{name}.pt").exists() and (out / f"{name}.pth").exists()
    rows = (runs / f"{name}.csv").read_text().strip().splitlines()
    assert rows[0].split(",") == ["diverged", "epoch", "final_loss", "sec"]
    assert len(rows) == 3
    state = ckpt.load_checkpoint(str(out / f"{name}.pt"),
                                 GNSConfig(case_nr=14, K=2, latent_dim=8, hidden_dim=8),
                                 device="cpu")
    assert int(state.step) in (2, 4)  # the best of the two epochs, 2 batches each
