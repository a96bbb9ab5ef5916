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


# ---- the refresh's one lowering against gns_tpu's lowerings ----------------

import gns_tpu.physics.fused as j_fused  # noqa: E402

# (reference_parity, method, gns_tpu's _STACK_GATHER, gns_tpu's _STACK_AGG):
# the port runs its one refresh under `method`; gns_tpu runs the lowering
# the method and its stacking switches pick.
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
    """Set gns_tpu's stacking switches; monkeypatch restores them."""
    def set_(gather_on, agg_on):
        monkeypatch.setattr(j_fused, "_STACK_GATHER", gather_on)
        monkeypatch.setattr(j_fused, "_STACK_AGG", agg_on)
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
    """The port's one physics_refresh (method "degree" in both modes, "auto"
    in paper mode) against gns_tpu's refresh with that method and each of
    its stacking settings: forward within TOL, the gradients of the loss
    wrt v and theta within GRAD_TOL."""
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
    outputs are bit-equal."""
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


# ---- the forward hands its method to the refresh and checks it there ----

PAPER_CFG = dict(case_nr=30, K=2, latent_dim=4, hidden_dim=4, reference_parity=False,
                 qg_gen_only=True, batch_size=3)


@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)])
def test_forward_degree_reaches_the_refresh(flags, switches):
    """The port's paper-mode gns_forward and GNS.forward with
    method="degree" against gns_tpu's paper-mode forward with its stacking
    switches `flags` on (the same weights): within TOL."""
    from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
    from gns_tpu.models.gns import init_gns_params
    from gns_torch.models.convert import module_from_jax_params
    from gns_torch.models.gns import gns_forward, step_params
    from gns_torch.utils.config import GNSConfig

    cfg = GNSConfig(**PAPER_CFG)
    batch = _batch(False)
    topo = extract_shared_topology(batch)
    params = init_gns_params(jax.random.key(0), cfg)
    model = module_from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    switches(*flags)
    ref = j_forward_batch(params, cfg, batch, method="scatter", topo=topo, dense=True)
    bt = batch_tensors(batch, "cpu")
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    with torch.no_grad():
        outs = (gns_forward(step_params(model, cfg), cfg, bt, graph, dense=True,
                            method="degree"),
                model(bt, graph, dense=True, method="degree"))
    for out in outs:
        for name in ("v", "theta", "total_loss", "last_loss", "delta_p", "delta_q"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)), err_msg=name, **TOL)


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


# ---- GraphCache: a topology's Graph per device, shape and line_rows -------

from gns_torch.physics import common  # noqa: E402
from gns_torch.utils.prepare import GridTopology  # noqa: E402


def _same_ids(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name).ids, getattr(b, name).ids), name


def _stub_builds(monkeypatch):
    """Replace build_graph under the cache by a stub that records each
    call and returns a fresh object."""
    built = []

    def stub(buses, lines, gens, topo=None, device="cpu", line_rows=None):
        built.append((topo, device, line_rows))
        return object()

    monkeypatch.setattr(common, "build_graph", stub)
    return built


def test_graph_cache_hits_the_same_topology_shape_and_device():
    """A second call with the same topology, N / E / G and device, from
    numpy or tensors and at another batch size, returns the cached Graph,
    which equals build_graph's."""
    batch = _batch(False)
    topo = extract_shared_topology(batch)
    cache = common.GraphCache()
    graph = cache(batch.buses, batch.lines, batch.generators, topo, "cpu")
    bt = batch_tensors(batch[:2], "cpu")
    assert cache(bt.buses, bt.lines, bt.generators, topo, torch.device("cpu")) is graph
    assert cache.builds == 1 and len(cache) == 1
    _same_ids(graph, build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu"))


@pytest.mark.parametrize("change", ["topology", "device", "line_rows"])
def test_graph_cache_builds_anew_for_another_key(change, monkeypatch):
    """Another topology, device or line_rows is another Graph; the first
    stays cached."""
    built = _stub_builds(monkeypatch)
    batch = _batch(False)
    topo = extract_shared_topology(batch)
    cache = common.GraphCache()
    args = dict(topo=topo, device="cpu", line_rows=None)
    other = {"topology": dict(topo=GridTopology(topo.dst, topo.src, topo.gen_idx)),
             "device": dict(device="cuda:1"),
             "line_rows": dict(line_rows=2 * batch.lines.shape[1])}[change]
    new = {**args, **other}
    first = cache(batch.buses, batch.lines, batch.generators, **args)
    again = cache(batch.buses, batch.lines, batch.generators, **new)
    assert again is not first and cache.builds == 2 and len(cache) == 2
    assert cache(batch.buses, batch.lines, batch.generators, **args) is first
    assert len(built) == 2 and built[1][0] is new["topo"]
    assert built[1][1:] == (new["device"], new["line_rows"])


def test_graph_cache_builds_per_call_without_a_topology():
    """topo=None: every call builds the batch's per-sample Graph anew from
    the host view of its arrays, and nothing is cached."""
    batch = _batch(True)
    cache = common.GraphCache()
    bt = batch_tensors(batch, "cpu")
    want = build_graph(batch.buses, batch.lines, batch.generators, None, "cpu")
    graphs = [cache(batch.buses, batch.lines, batch.generators, None, "cpu"),
              cache(bt.buses, bt.lines, bt.generators, None, "cpu")]
    assert graphs[0] is not graphs[1] and cache.builds == 2 and len(cache) == 0
    for graph in graphs:
        _same_ids(graph, want)


def test_graph_cache_drops_its_oldest_past_the_cap(monkeypatch):
    """Past GRAPH_CACHE_CAP Graphs the oldest goes: the newest is still a
    hit, the first is built again."""
    _stub_builds(monkeypatch)
    batch = _batch(False)
    topo = extract_shared_topology(batch)
    cache = common.GraphCache()
    first, *_, last = [cache(batch.buses, batch.lines, batch.generators, topo, "cpu", rows)
                       for rows in range(1, common.GRAPH_CACHE_CAP + 2)]
    assert len(cache) == common.GRAPH_CACHE_CAP
    rows = common.GRAPH_CACHE_CAP + 1
    assert cache(batch.buses, batch.lines, batch.generators, topo, "cpu", rows) is last
    assert cache(batch.buses, batch.lines, batch.generators, topo, "cpu", 1) is not first
    assert cache.builds == common.GRAPH_CACHE_CAP + 2


def test_graph_cache_inserts_from_many_threads(monkeypatch):
    """Threads past the core count insert distinct Graphs with a short
    switch interval: every build is counted and the cache ends at its cap."""
    import sys
    import threading

    _stub_builds(monkeypatch)
    batch = _batch(False)
    topo = extract_shared_topology(batch)
    cache = common.GraphCache()
    n_threads, per_thread = 16, 200

    def insert(t):
        for i in range(per_thread):
            cache(batch.buses, batch.lines, batch.generators, topo, "cpu", t * per_thread + i + 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=insert, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cache.builds == n_threads * per_thread
    assert len(cache) == common.GRAPH_CACHE_CAP
