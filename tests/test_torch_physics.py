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
