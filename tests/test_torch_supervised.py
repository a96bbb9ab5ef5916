"""gns_torch's supervised training (train/supervised.py) against gns_tpu's, on
the CPU.

Sizes follow tests/test_torch_train.py (case14, K=2, latent 8, hidden 8,
batch 8, 16 grids), here NR-feasible grids with Newton-Raphson labels; both
packages start from gns_tpu's init_gns_params (module_from_jax_params).
Tolerances:
  * nr_labels: equal (the same float64 oracle, the same float32 casts);
  * one batch's gradients of the supervised loss, per leaf: max |port -
    jax| <= 2e-4 * max |jax leaf| + 1e-6 (tests/test_torch_train.py's
    bound);
  * one epoch's supervised and physics losses: rtol 1e-3, and the
    parameters after it at the same per-leaf bound. That epoch runs
    Adagrad: Adam's first update is lr * sign(g) wherever |g| >> eps, so a
    gradient component that is 0 in exact arithmetic (a dead unit's bias,
    here 1e-13 and 2e-9 of rounding in L_theta.b1, of either sign in
    either package) moves its parameter by up to lr one way or the other;
    Adagrad's update is linear in such a gradient;
  * train_supervised's history: rtol 1e-3 on each epoch's sup (as
    train()'s epoch losses).
Port-only checks (the eager step against the epoch) are bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.train import supervised as j_sup
from gns_tpu.train import trainer as j_trainer
from gns_tpu.utils import prepare as j_prepare
from gns_torch.models.convert import module_from_jax_params, params_from_state_dict
from gns_torch.models.gns import batch_tensors
from gns_torch.physics.common import build_graph
from gns_torch.train.supervised import (
    NRLabels,
    make_supervised_epoch_step,
    make_supervised_train_step,
    nr_labels,
    stack_labels,
    supervised_loss_and_grads,
    train_supervised,
    train_supervised_multi,
)
from gns_torch.train.trainer import TrainState, make_optimizer, stack_epoch
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

torch.set_num_threads(1)

CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, multiple_phi=True,
                batch_size=8, nr_samples=16, epochs=3, seed=0)
W_PHYSICS = 0.1


@pytest.fixture(scope="module")
def sup14():
    cases = list(generate_cases(14, 16, seed=21, feasible_only=True))[1:]
    data = batch_from_cases(cases)
    return cases, data, nr_labels(cases, n_pad=data.buses.shape[1])


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, init_gns_params(jax.random.key(seed), cfg))


def _state(cfg, params_np):
    model = module_from_jax_params(params_np, cfg, device="cpu")
    return TrainState(model, make_optimizer(cfg).init(model.parameters()),
                      torch.zeros((), dtype=torch.int32))


def _j_state(cfg, params_np):
    params = jax.tree.map(jnp.asarray, params_np)
    return j_trainer.TrainState(params, j_trainer.make_optimizer(cfg).init(params),
                                jnp.zeros((), jnp.int32))


def _torch_labels(labels):
    return NRLabels(*(torch.as_tensor(a) for a in labels))


def test_nr_labels_match_gns_tpu(sup14):
    """nr_labels equals gns_tpu's, padding included; a non-converged grid
    raises."""
    cases, data, labels = sup14
    n_pad = data.buses.shape[1] + 3
    got = nr_labels(cases[:5], n_pad=n_pad)
    want = j_sup.nr_labels(cases[:5], n_pad=n_pad)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (5, n_pad)
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(labels.v, np.asarray(j_sup.nr_labels(cases).v))
    bad = list(generate_cases(300, 2, seed=0, scale=1.0))[1:]
    with pytest.raises(ValueError, match="did not converge"):
        nr_labels(bad)


def _assert_leaves_close(got_tree, want_tree):
    for head, block in want_tree.items():
        for name, leaf in block.items():
            w = np.asarray(leaf)
            err = np.abs(got_tree[head][name] - w).max()
            bound = 2e-4 * np.abs(w).max() + 1e-6
            assert err <= bound, f"{head}.{name}: {err:.3e} > {bound:.3e}"


def test_supervised_gradients_match_jax(sup14):
    """One batch's gradients of sup + w_physics * physics: the port's
    autograd through its plain twins against jax.grad of gns_tpu's loss."""
    _, data, labels = sup14
    params = _np_params(CFG)
    batch = data[:8]
    jb = j_prepare.GridBatch(*batch)
    topo = j_prepare.extract_shared_topology(jb)
    lv, lt = jnp.asarray(labels.v[:8]), jnp.asarray(labels.theta[:8])

    def loss(p):
        out = j_forward_batch(p, CFG, jb, method="scatter", topo=topo)
        mask, n_real = jb.bus_mask, jb.n_bus.astype(jnp.float32)
        v_err = jnp.sum((out.v - lv) ** 2 * mask, axis=1) / n_real
        th_err = jnp.sum((j_sup._centered(out.theta, mask, n_real)
                          - j_sup._centered(lt, mask, n_real)) ** 2 * mask, axis=1) / n_real
        return jnp.mean(v_err + th_err) + W_PHYSICS * jnp.mean(out.total_loss)

    want = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
    model = module_from_jax_params(params, CFG, device="cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    _, _, grads = supervised_loss_and_grads(
        model, CFG, batch_tensors(batch, "cpu"), graph, torch.as_tensor(labels.v[:8]),
        torch.as_tensor(labels.theta[:8]), W_PHYSICS, dense=True)
    names = [n for n, _ in model.named_parameters()]
    _assert_leaves_close(params_from_state_dict(dict(zip(names, grads)), CFG), want)


def test_supervised_epoch_matches_gns_tpu(sup14):
    """One supervised epoch (2 batches of 8, Adagrad) from the same
    converted init: the per-batch sup and physics losses and the
    parameters after it."""
    _, data, labels = sup14
    cfg = CFG.replace(optimizer="adagrad")
    params = _np_params(cfg)
    jb = j_prepare.GridBatch(*data)
    j_step = j_sup.make_supervised_epoch_step(cfg, W_PHYSICS, method="scatter",
                                              topo=j_prepare.extract_shared_topology(jb))
    j_labels = j_sup.NRLabels(jnp.asarray(labels.v), jnp.asarray(labels.theta))
    j_state, want = j_step(_j_state(cfg, params),
                           (j_trainer.stack_epoch(jb, 8), j_sup.stack_labels(j_labels, 8)))
    state = _state(cfg, params)
    step = make_supervised_epoch_step(cfg, W_PHYSICS, topo=extract_shared_topology(data),
                                      dense=data.is_dense())
    _, got = step(state, stack_epoch(data, 8), _torch_labels(stack_labels(labels, 8)))
    for key in ("sup", "physics"):
        assert got[key].shape == (2,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-3, err_msg=key)
    assert int(state.step) == 2
    _assert_leaves_close(params_from_state_dict(state.model.state_dict(), cfg), j_state.params)


def test_train_supervised_matches_gns_tpu(sup14):
    """train_supervised for 3 epochs: each epoch's sup against gns_tpu's
    train_supervised, the same history keys, a CPU best state."""
    _, data, labels = sup14
    params = _np_params(CFG, seed=1)
    _, want = j_sup.train_supervised(
        CFG, j_prepare.GridBatch(*data),
        j_sup.NRLabels(jnp.asarray(labels.v), jnp.asarray(labels.theta)),
        w_physics=W_PHYSICS, method="scatter", state=_j_state(CFG, params))
    best, got = train_supervised(CFG, data, labels, w_physics=W_PHYSICS,
                                 state=_state(CFG, params))
    assert [list(r) for r in got] == [list(r) for r in want]
    np.testing.assert_allclose([r["sup"] for r in got], [r["sup"] for r in want], rtol=1e-3)
    np.testing.assert_allclose([r["physics"] for r in got], [r["physics"] for r in want],
                               rtol=1e-3)
    assert next(best.model.parameters()).device.type == "cpu"


def test_train_supervised_multi_matches_gns_tpu():
    """train_supervised_multi over a case9 and a case14 group: the
    per-group sups of each epoch."""
    cfg = CFG.replace(batch_size=4, epochs=2)
    datasets, label_sets = [], []
    for case, seed in ((9, 1), (14, 2)):
        cases = list(generate_cases(case, 4, seed=seed, feasible_only=True))[1:]
        datasets.append(batch_from_cases(cases))
        label_sets.append(nr_labels(cases))
    params = _np_params(cfg)
    _, want = j_sup.train_supervised_multi(
        cfg, [j_prepare.GridBatch(*d) for d in datasets],
        [j_sup.NRLabels(jnp.asarray(lab.v), jnp.asarray(lab.theta)) for lab in label_sets],
        w_physics=W_PHYSICS, method="scatter", state=_j_state(cfg, params))
    _, got = train_supervised_multi(cfg, datasets, label_sets, w_physics=W_PHYSICS,
                                    state=_state(cfg, params))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["group_sups"], w["group_sups"], rtol=1e-3)


def test_supervised_step_equals_epoch(sup14):
    """make_supervised_train_step twice is bit-equal to one epoch of two
    batches: losses, parameters, optimizer state and step."""
    _, data, labels = sup14
    params = _np_params(CFG)
    topo = extract_shared_topology(data)
    a, b = _state(CFG, params), _state(CFG, params)
    _, m_epoch = make_supervised_epoch_step(CFG, W_PHYSICS, topo=topo, dense=True)(
        a, stack_epoch(data, 8), _torch_labels(stack_labels(labels, 8)))
    step = make_supervised_train_step(CFG, W_PHYSICS, topo=topo, dense=True)
    sups = [step(b, data[i * 8:(i + 1) * 8], NRLabels(labels.v[i * 8:(i + 1) * 8],
                                                       labels.theta[i * 8:(i + 1) * 8]))[1]["sup"]
            for i in range(2)]
    assert torch.equal(m_epoch["sup"], torch.stack(sups))
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)
    assert int(a.step) == int(b.step) == 2
