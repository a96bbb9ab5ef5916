"""Fused physics refresh: compensation + imbalance in one pass (port of
gns_tpu/physics/fused.py `physics_refresh`).

The reference runs global_active_compensation then local_power_imbalance
with the same (v, theta) every step (GNS/main.py:190-192); both share the
edge geometry, the Q2 gathers and the reactive messages, so they are
computed once and the mismatch scatters are paired into (S, E, 2) blocks.
Returns (pg_new (S, G), qg_new (S, N), delta_p (S, N), delta_q (S, N)).

Two modes, as in the JAX package:
  * reference_parity=True keeps the reference's exact gather pattern:
    quirk Q2 (per-line arrays y/delta/tau/shift/b indexed by BUS ids,
    main.py:41,68-72), Q4 (the to-side reactive message uses sin) and the
    explicit Q8 delta_q form whose float noise matches the reference.
  * reference_parity=False uses textbook branch flows, with the paper-mode
    conventions qg_gen_only and dispatch="setpoint_slack".

edge_group (parallel/edge_partition.py): the lines are partitioned over
this process group, bus and generator state replicated; the Joule sum and
the paired mismatch sums are local partials all-reduced over it, at
gns_tpu's psum sites (gns_tpu/physics/fused.py:210, 220-221, 238-239).

One lowering: the refresh's sums run on K1 over the Graph's prebuilt CSR
and its gathers on K2 on the card (the plain twins on the CPU). gns_tpu's
method="degree" (its lowering for host-known ids, ops/segment.py
make_degree_segment_sum) is such a lowering already, so "degree" computes
what "auto" does. gns_tpu's two paper-mode stacking switches (one gather
over [src; dst], one sum over [src; dst; gen]) have no counterpart: the
port computes what they compute the unstacked way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gns_torch.ops.collectives import all_gather_rows, all_reduce_sum
from gns_torch.ops.segment import check_method, gather, segment_sum
from gns_torch.physics.common import EdgeGeom, Graph, branch_flows, edge_geometry
from gns_torch.physics.compensation import _lambda_dispatch
from gns_torch.utils.schema import BUS, BUS_TYPE_SLACK, GEN

def q2_geometry(geom: EdgeGeom, graph: Graph, line_group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quirk Q2's step-invariant gathers: (y, tau, shift, b_chg) of line
    src[e] and of line dst[e] (bus ids used as line indices), each
    (S, E, 4). The model computes them once per forward. line_group: the
    group the lines are partitioned over; the per-line array is then
    all-gathered over it first, since a bus id may name another rank's
    line (graph.src_rows / dst_rows index the whole line set)."""
    per_line = torch.stack([geom.y, geom.tau, geom.shift, geom.b_chg], dim=-1)
    per_line = all_gather_rows(per_line, line_group, dim=1)
    return (gather(per_line, graph.src_rows),
            gather(per_line, graph.dst_rows))


def physics_refresh(
    v,
    theta,
    buses,
    lines,
    gens,
    graph: Graph,
    *,
    reference_parity: bool = True,
    bus_mask: Optional[torch.Tensor] = None,
    line_mask: Optional[torch.Tensor] = None,
    gen_mask: Optional[torch.Tensor] = None,
    method: str = "auto",
    qg_gen_only: bool = False,
    dispatch: str = "lambda",
    gen_bus_mask: Optional[torch.Tensor] = None,
    slack_mask: Optional[torch.Tensor] = None,
    geom: Optional[EdgeGeom] = None,
    q2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    edge_group=None,
):
    """One-pass compensation + imbalance on a batch.

    gen_bus_mask / slack_mask (S, N): the step-invariant masks of the
    paper-mode conventions; derived here when None. geom / q2: the
    step-invariant edge geometry and Q2 gathers, computed here when None.
    edge_group: see the module docstring; in reference-parity mode Q2's
    per-line reads all-gather the per-line arrays over the group
    (models/gns.py gns_machinery).
    """
    if reference_parity and (qg_gen_only or dispatch != "lambda"):
        raise ValueError(
            "qg_gen_only / dispatch='setpoint_slack' are paper-mode options "
            "(reference_parity=False): the parity path keeps the reference's "
            "cancelling reactive residual (quirk Q8)."
        )
    if dispatch not in ("lambda", "setpoint_slack"):
        raise ValueError(f"dispatch must be lambda/setpoint_slack, got {dispatch!r}")
    check_method(method, v.device)

    if geom is None:
        geom = edge_geometry(lines)
    lm = line_mask if line_mask is not None else 1.0

    v2 = v * v
    pd = buses[..., BUS["Pd"]]
    qd = buses[..., BUS["Qd"]]
    gs = buses[..., BUS["Gs"]]
    bs = buses[..., BUS["Bs"]]

    if reference_parity:
        if q2 is None:
            q2 = q2_geometry(geom, graph, edge_group)
        y_s, tau_s, sh_s, b_s = q2[0].unbind(-1)
        y_d, tau_d, sh_d, b_d = q2[1].unbind(-1)
        vth = torch.stack([v, theta], dim=-1)
        at_src = gather(vth, graph.src)
        at_dst = gather(vth, graph.dst)
        v_s, v_d = at_src[..., 0], at_dst[..., 0]
        th_sd = at_src[..., 1] - at_dst[..., 1]  # delta (S, E)
        th_all = all_gather_rows(th_sd, edge_group, dim=1)  # Q2 reads any line
        d_s = gather(th_all, graph.src_rows)  # delta[src]
        dj_d = -gather(th_all, graph.dst_rows)  # delta_ji[dst]

        ang_s = th_sd - d_s - sh_s
        ang_d = -th_sd - dj_d - sh_d
        sin_ds, cos_ds = torch.sin(d_s), torch.cos(d_s)
        sin_djd = torch.sin(dj_d)
        sin_angs, cos_angs = torch.sin(ang_s), torch.cos(ang_s)
        sin_angd, cos_angd = torch.sin(ang_d), torch.cos(ang_d)
        vv_s = v_s * v_d * y_s / tau_s
        vv_d = v_d * v_s * y_d / tau_d

        # Joule message (main.py:41); its second term uses v_s/tau^2, an
        # inconsistency of the reference kept for parity.
        msg_joule = torch.abs(
            vv_s * (sin_angs + torch.sin(-th_sd - d_s + sh_s))
            + (v_s / tau_s**2) * y_s * sin_ds
            + v_d**2 * y_s * sin_ds
        )
        p_joule = all_reduce_sum((msg_joule * lm).sum(-1), edge_group)

        p_from = vv_s * sin_angs + (v_s / tau_s) ** 2 * y_s * sin_ds
        p_to = vv_d * sin_angd + v_d**2 * y_d * sin_djd
        q_from = -vv_s * cos_angs + (v_s / tau_s) ** 2 * (y_s * cos_ds - b_s / 2)
        q_to = -vv_d * cos_angd + v_d**2 * (y_d * sin_djd - b_d / 2)
        from_idx, to_idx = graph.dst, graph.src
    else:
        p_f, q_f, p_t, q_t = branch_flows(v, theta, geom, graph)
        p_joule = all_reduce_sum(((p_f + p_t) * lm).sum(-1), edge_group)
        p_from, p_to = -p_f, -p_t  # the imbalance subtracts the line draw
        q_from, q_to = -q_f, -q_t
        from_idx, to_idx = graph.src, graph.dst

    lm_col = line_mask[..., None] if line_mask is not None else 1.0
    from_pair = torch.stack([p_from, q_from], dim=-1) * lm_col
    to_pair = torch.stack([p_to, q_to], dim=-1) * lm_col
    agg_from = all_reduce_sum(segment_sum(from_pair, from_idx), edge_group)
    agg_to = all_reduce_sum(segment_sum(to_pair, to_idx), edge_group)
    p_sum = agg_from[..., 0] + agg_to[..., 0]
    q_sum = agg_from[..., 1] + agg_to[..., 1]

    if dispatch == "setpoint_slack":
        pg_new = gens[..., GEN["Pg_set"]]
        if gen_mask is not None:
            pg_new = pg_new * gen_mask
    else:
        pdm = pd * bus_mask if bus_mask is not None else pd
        v2m = v2 * bus_mask if bus_mask is not None else v2
        p_global = pdm.sum(-1) + (v2m * gs).sum(-1) + p_joule
        pg_new = _lambda_dispatch(p_global, gens, gen_mask)

    pg = pg_new * gen_mask if gen_mask is not None else pg_new
    pg_bus = segment_sum(pg, graph.gen)
    delta_p = pg_bus - pd - gs * v2 + p_sum

    qg_start = qd - bs * v2
    qg_new = qg_start - q_sum
    if qg_gen_only:
        if gen_bus_mask is None:
            ones = gen_mask if gen_mask is not None else torch.ones_like(pg)
            gen_bus_mask = (segment_sum(ones, graph.gen) > 0).to(qg_new.dtype)
        qg_new = qg_new * gen_bus_mask
    if dispatch == "setpoint_slack":
        if slack_mask is None:
            slack_mask = (buses[..., BUS["type"]] == BUS_TYPE_SLACK).to(delta_p.dtype)
        delta_p = delta_p * (1.0 - slack_mask)

    # Q8: == 0 by construction without qg_gen_only; the explicit form keeps
    # the reference's float noise.
    delta_q = (qg_new - qd + bs * v2) + q_sum

    if bus_mask is not None:
        qg_new = qg_new * bus_mask
        delta_p = delta_p * bus_mask
        delta_q = delta_q * bus_mask
    return pg_new, qg_new, delta_p, delta_q
