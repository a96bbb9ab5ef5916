"""gns_torch physics refresh against gns_tpu.physics.fused.physics_refresh,
parity and paper modes, dense and masked batches, same inputs from a numpy
seed. Tolerance rtol 1e-5 / atol 1e-6: the same float32 formulas, with sums
and trig from two libraries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gns_tpu.physics.common import branch_flows as j_branch_flows
from gns_tpu.physics.common import edge_geometry as j_edge_geometry
from gns_tpu.physics.compensation import _lambda_dispatch as j_lambda
from gns_tpu.physics.fused import physics_refresh as j_refresh
from gns_torch.models.gns import batch_tensors
from gns_torch.physics.common import branch_flows, build_graph, edge_geometry
from gns_torch.physics.compensation import _lambda_dispatch
from gns_torch.physics.fused import physics_refresh
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(mixed: bool):
    if mixed:
        cs = [*generate_cases(9, 1, seed=11), *generate_cases(14, 1, seed=12)]
    else:
        cs = list(generate_cases(30, 3, seed=13))
    return batch_from_cases(cs)


def _state(batch, seed):
    rng = np.random.default_rng(seed)
    s, n = batch.buses.shape[:2]
    v = (1.0 + 0.05 * rng.standard_normal((s, n))).astype(np.float32)
    theta = (0.1 * rng.standard_normal((s, n))).astype(np.float32)
    return v, theta


MODES = {
    "parity": dict(reference_parity=True),
    "paper": dict(reference_parity=False),
    "paper_qg_gen_only": dict(reference_parity=False, qg_gen_only=True),
    "paper_setpoint_slack": dict(reference_parity=False, qg_gen_only=True,
                                 dispatch="setpoint_slack"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mixed", [False, True])
def test_physics_refresh_matches(mode, mixed):
    kw = MODES[mode]
    batch = _batch(mixed)
    v, theta = _state(batch, 3)
    masks = mixed  # the mixed batch is padded: exercise every mask

    def one(v1, th1, b, l, g, bm, lm, gm):
        return j_refresh(
            v1, th1, b, l, g, method="scatter",
            bus_mask=bm if masks else None, line_mask=lm if masks else None,
            gen_mask=gm if masks else None, **kw,
        )

    ref = jax.vmap(one)(v, theta, batch.buses, batch.lines, batch.generators,
                        batch.bus_mask, batch.line_mask, batch.gen_mask)
    topo = None if mixed else extract_shared_topology(batch)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    bt = batch_tensors(batch, "cpu")
    out = physics_refresh(
        torch.from_numpy(v), torch.from_numpy(theta), bt.buses, bt.lines, bt.generators,
        graph,
        bus_mask=bt.bus_mask if masks else None,
        line_mask=bt.line_mask if masks else None,
        gen_mask=bt.gen_mask if masks else None,
        **kw,
    )
    for name, a, b in zip(("pg_new", "qg_new", "delta_p", "delta_q"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


def test_refresh_rejects_paper_options_in_parity_mode():
    batch = _batch(False)
    v, theta = _state(batch, 4)
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    bt = batch_tensors(batch, "cpu")
    args = (torch.from_numpy(v), torch.from_numpy(theta), bt.buses, bt.lines,
            bt.generators, graph)
    with pytest.raises(ValueError):
        physics_refresh(*args, reference_parity=True, qg_gen_only=True)
    with pytest.raises(ValueError):
        physics_refresh(*args, reference_parity=False, dispatch="nope")


def test_geometry_flows_and_dispatch_match():
    batch = _batch(False)
    v, theta = _state(batch, 5)
    bt = batch_tensors(batch, "cpu")
    geom = edge_geometry(bt.lines)
    j_geom = jax.vmap(j_edge_geometry)(batch.lines)
    for name in ("y", "g", "b_series", "b_chg", "tau", "shift"):
        np.testing.assert_allclose(getattr(geom, name).numpy(), np.asarray(getattr(j_geom, name)),
                                   err_msg=name, **TOL)
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    flows = branch_flows(torch.from_numpy(v), torch.from_numpy(theta), geom, graph)
    j_flows = jax.vmap(lambda a, b, l: j_branch_flows(a, b, j_edge_geometry(l)))(
        v, theta, batch.lines)
    for a, b in zip(flows, j_flows):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    rng = np.random.default_rng(6)
    for p_global in (rng.uniform(0.5, 3.0, 4).astype(np.float32),
                     rng.uniform(10.0, 30.0, 4).astype(np.float32)):
        gens = np.repeat(batch.generators[:1], 4, axis=0)
        gm = np.ones(gens.shape[:2], np.float32)
        gm[1, -1] = 0.0
        ours = _lambda_dispatch(torch.from_numpy(p_global), torch.from_numpy(gens),
                                torch.from_numpy(gm))
        ref = jax.vmap(j_lambda)(jnp.asarray(p_global), gens, gm)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


# ---- the refresh's lowerings: method="degree", _STACK_GATHER, _STACK_AGG --

import gns_tpu.physics.fused as j_fused  # noqa: E402
import gns_torch.physics.fused as fused  # noqa: E402

# (reference_parity, method, _STACK_GATHER, _STACK_AGG)
LOWERINGS = {
    "degree_parity": (True, "degree", False, False),
    "degree_paper": (False, "degree", False, False),
    "stack_gather": (False, "auto", True, False),
    "stack_agg": (False, "auto", False, True),
    "stack_both": (False, "auto", True, True),
}
# Gradients of the loss wrt v and theta: gns_tpu's own bound for its
# stacked paths against the unstacked one (tests/test_ops.py:161-163); the
# stacked sum adds each bus's rows in another order.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def switches(monkeypatch):
    """Set the stacking switches of both packages; monkeypatch restores them."""
    def set_(gather_on, agg_on):
        for mod in (fused, j_fused):
            monkeypatch.setattr(mod, "_STACK_GATHER", gather_on)
            monkeypatch.setattr(mod, "_STACK_AGG", agg_on)
    return set_


def _refresh_both(batch, v, theta, parity, method, masks):
    """(forward, (dL/dv, dL/dtheta)) of the port and of gns_tpu, with the
    loss gns_tpu's test uses: the sum of squares of qg_new, delta_p and
    delta_q. gns_tpu gets the shared topology where there is one (its
    'degree' needs host-known ids)."""
    kw = dict(reference_parity=parity, qg_gen_only=not parity)
    topo = None if masks else extract_shared_topology(batch)
    j_topo = None if topo is None else (topo.src, topo.dst, topo.gen_idx)

    def j_loss(v1, th1, b, l, g, bm, lm, gm):
        out = j_refresh(v1, th1, b, l, g, method=method if method == "degree" else "scatter",
                        topo=j_topo, bus_mask=bm if masks else None,
                        line_mask=lm if masks else None, gen_mask=gm if masks else None, **kw)
        return sum((x ** 2).sum() for x in out[1:]), out

    def j_one(*a):
        (_, out), grads = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(*a)
        return out, grads

    ref, ref_grads = jax.vmap(j_one)(v, theta, batch.buses, batch.lines, batch.generators,
                                     batch.bus_mask, batch.line_mask, batch.gen_mask)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    bt = batch_tensors(batch, "cpu")
    vt = torch.from_numpy(v).requires_grad_(True)
    tt = torch.from_numpy(theta).requires_grad_(True)
    out = physics_refresh(
        vt, tt, bt.buses, bt.lines, bt.generators, graph, method=method,
        bus_mask=bt.bus_mask if masks else None, line_mask=bt.line_mask if masks else None,
        gen_mask=bt.gen_mask if masks else None, **kw)
    grads = torch.autograd.grad(sum((x ** 2).sum() for x in out[1:]), (vt, tt))
    return ((out, grads), (ref, ref_grads))


@pytest.mark.parametrize("lowering", sorted(LOWERINGS))
@pytest.mark.parametrize("mixed", [False, True])
def test_refresh_lowerings_match_gns_tpu(lowering, mixed, switches):
    """physics_refresh with method="degree" (both modes) and each stacking
    switch (paper mode) against gns_tpu's refresh with the same setting:
    forward within TOL, the gradients of the loss wrt v and theta within
    GRAD_TOL."""
    parity, method, gather_on, agg_on = LOWERINGS[lowering]
    switches(gather_on, agg_on)
    batch = _batch(mixed)
    v, theta = _state(batch, 7)
    (out, grads), (ref, ref_grads) = _refresh_both(batch, v, theta, parity, method, masks=mixed)
    for name, a, b in zip(("pg_new", "qg_new", "delta_p", "delta_q"), out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **TOL)
    for name, a, b in zip(("v", "theta"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d/d{name}", **GRAD_TOL)


@pytest.mark.parametrize("parity", [True, False])
def test_refresh_degree_equals_auto(parity):
    """The port's "degree" runs the same sums and gathers as "auto": its
    outputs are bit-equal, and stacking stays off under it."""
    batch = _batch(False)
    v, theta = _state(batch, 8)
    bt = batch_tensors(batch, "cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    kw = dict(reference_parity=parity)
    args = (torch.from_numpy(v), torch.from_numpy(theta), bt.buses, bt.lines, bt.generators,
            graph)
    auto = physics_refresh(*args, method="auto", **kw)
    degree = physics_refresh(*args, method="degree", **kw)
    for a, b in zip(auto, degree):
        assert torch.equal(a, b)


def test_stack_switch_needs_its_index(switches):
    """A Graph built while a switch was off has no stacked index: the
    refresh raises instead of running the other lowering; one built after
    the switch has it."""
    batch = _batch(False)
    v, theta = _state(batch, 9)
    bt = batch_tensors(batch, "cpu")
    topo = extract_shared_topology(batch)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    assert graph.src_dst is None and graph.src_dst_gen is None
    args = (torch.from_numpy(v), torch.from_numpy(theta), bt.buses, bt.lines, bt.generators)
    for flags in ((True, False), (False, True)):
        switches(*flags)
        with pytest.raises(ValueError, match="built while it was off"):
            physics_refresh(*args, graph, reference_parity=False)
        rebuilt = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
        assert (rebuilt.src_dst is not None) == flags[0]
        assert (rebuilt.src_dst_gen is not None) == flags[1]
        physics_refresh(*args, rebuilt, reference_parity=False)
        # parity mode and "degree" never stack, so the old Graph serves them
        physics_refresh(*args, graph, reference_parity=True)
        physics_refresh(*args, graph, reference_parity=False, method="degree")


def test_train_step_rebuilds_after_a_switch_flips(switches):
    """make_train_step's Graph cache is keyed by the switches: a step
    taken after _STACK_AGG flips builds its own Graph (with the stacked
    index) instead of reusing the other setting's, and updates the state as
    a step built fresh under that setting does."""
    from gns_torch.train.trainer import init_train_state, make_train_step
    from gns_torch.utils.config import GNSConfig

    batch = _batch(False)
    topo = extract_shared_topology(batch)
    cfg = GNSConfig(case_nr=30, K=2, latent_dim=4, hidden_dim=4, reference_parity=False,
                    qg_gen_only=True, batch_size=3)
    switches(False, False)
    step = make_train_step(cfg, topo=topo, dense=True)
    state = init_train_state(0, cfg, device="cpu")
    step(state, batch)
    switches(False, True)
    _, m_flipped = step(state, batch)  # reusing the old Graph would raise here
    switches(False, False)
    state2 = init_train_state(0, cfg, device="cpu")
    step(state2, batch)
    switches(False, True)
    _, m_fresh = make_train_step(cfg, topo=topo, dense=True)(state2, batch)
    assert torch.equal(m_flipped["loss"], m_fresh["loss"])
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)


# ---- the forward hands its method to the refresh and checks it there ----

PAPER_CFG = dict(case_nr=30, K=2, latent_dim=4, hidden_dim=4, reference_parity=False,
                 qg_gen_only=True, batch_size=3)


@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)])
def test_forward_degree_reaches_the_refresh(flags, switches):
    """gns_forward(method="degree") in paper mode with a stacking switch on
    runs the refresh unstacked, as gns_tpu's does: it runs on a Graph built
    while the switches were off (with "auto" the refresh asks for the
    stacked index and raises), and equals the unstacked "auto" forward bit
    for bit."""
    from gns_torch.models.gns import GNS, gns_forward, step_params
    from gns_torch.utils.config import GNSConfig

    cfg = GNSConfig(**PAPER_CFG)
    batch = _batch(False)
    bt = batch_tensors(batch, "cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators,
                        extract_shared_topology(batch), "cpu")
    model = GNS(cfg, seed=0, device="cpu")
    steps = step_params(model, cfg)
    with torch.no_grad():
        unstacked = gns_forward(steps, cfg, bt, graph, dense=True)
        switches(*flags)
        with pytest.raises(ValueError, match="built while it was off"):
            gns_forward(steps, cfg, bt, graph, dense=True)
        for out in (gns_forward(steps, cfg, bt, graph, dense=True, method="degree"),
                    model(bt, graph, dense=True, method="degree")):
            for a, b in zip(out, unstacked):
                assert torch.equal(a, b)


def _cuda_check(monkeypatch):
    """Make the forward's method check see a CUDA batch (the CPU has no
    card): each entry point below then rejects a name the card has no
    lowering for before any work."""
    import gns_torch.models.gns as gns
    from gns_torch.ops.segment import check_method

    seen = []

    def as_on_cuda(method, device=None, names=None):
        if names is not None:
            return check_method(method, names=names)
        seen.append((method, torch.device(device).type))
        return check_method(method, "cuda")

    monkeypatch.setattr(gns, "check_method", as_on_cuda)
    return seen


def _forward_entries(cfg, batch):
    from gns_torch.models.gns import GNS, gns_forward, gns_forward_batch, step_params
    from gns_torch.train.trainer import init_train_state, make_train_step

    bt = batch_tensors(batch, "cpu")
    topo = extract_shared_topology(batch)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    model = GNS(cfg, seed=0, device="cpu")
    return {
        "gns_forward": lambda m: gns_forward(step_params(model, cfg), cfg, bt, graph,
                                             dense=True, method=m),
        "GNS.forward": lambda m: model(bt, graph, dense=True, method=m),
        "gns_forward_batch": lambda m: gns_forward_batch(model, cfg, batch, method=m,
                                                         topo=topo, dense=True),
        "make_train_step": lambda m: make_train_step(cfg, method=m, topo=topo, dense=True)(
            init_train_state(0, cfg, device="cpu"), batch),
    }


@pytest.mark.parametrize("entry", ["gns_forward", "GNS.forward", "gns_forward_batch",
                                   "make_train_step"])
def test_forward_checks_method_against_the_device(entry, monkeypatch):
    """Every forward entry point checks its method against the batch's
    device: on a CUDA batch 'scatter' raises, 'auto' and 'degree' run, and
    the check sees the caller's name."""
    from gns_torch.utils.config import GNSConfig

    seen = _cuda_check(monkeypatch)
    run = _forward_entries(GNSConfig(**PAPER_CFG), _batch(False))[entry]
    with pytest.raises(ValueError, match="no CUDA lowering"):
        run("scatter")
    for method in ("auto", "degree"):
        run(method)
    assert [m for m, _ in seen] == ["scatter", "auto", "degree"]
    assert {d for _, d in seen} == {"cpu"}
