"""Global active compensation (port of gns_tpu/physics/compensation.py):
the scalar lambda redispatch `_lambda_dispatch` (paper eqs. (20)-(21),
reference GNS/main.py:47-57), which the fused physics refresh uses, and
the unfused `global_active_compensation`, the training path's oracle. The
data-dependent branches of the reference (quirk Q5) are torch.where, per
sample."""

from __future__ import annotations

from typing import Optional

import torch

from gns_torch.ops.collectives import all_reduce_sum
from gns_torch.ops.segment import gather, segment_sum
from gns_torch.physics.common import EdgeGeom, Graph, branch_flows, edge_geometry
from gns_torch.utils.schema import BUS, GEN


def _lambda_dispatch(p_global: torch.Tensor, gens: torch.Tensor,
                     gen_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """p_global (S,), gens (S, G, 7) -> Pg_new (S, G)."""
    pg_set = gens[..., GEN["Pg_set"]]
    pmin = gens[..., GEN["Pmin"]]
    pmax = gens[..., GEN["Pmax"]]
    if gen_mask is not None:
        pg_set, pmin, pmax = pg_set * gen_mask, pmin * gen_mask, pmax * gen_mask
    s_set, s_min, s_max = pg_set.sum(-1), pmin.sum(-1), pmax.sum(-1)

    lam_lo = (p_global - s_min) / (2.0 * (s_set - s_min))
    lam_hi = (p_global - 2.0 * s_set + s_max) / (2.0 * (s_max - s_set))
    lam = torch.where(p_global < s_set, lam_lo, lam_hi)[:, None]

    pg_lo = pmin + 2.0 * (pg_set - pmin) * lam
    pg_hi = 2.0 * pg_set - pmax + 2.0 * (pmax - pg_set) * lam
    pg_new = torch.where(lam < 0.5, pg_lo, pg_hi)
    if gen_mask is not None:
        pg_new = pg_new * gen_mask
    return pg_new


def global_active_compensation(
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
    qg_gen_only: bool = False,
    dispatch: str = "lambda",
    edge_group=None,
):
    """The unfused compensation of gns_tpu/physics/compensation.py on a
    batch: (Pg_new (S, G), qg_new (S, N)) for the iterate (v, theta) (S, N).

    Pg_new redistributes generation so that it covers load, shunts and the
    Joule-loss proxy (the scalar lambda, paper eqs. (20)-(21)); qg_new is
    each bus's reactive generation that zeroes its reactive mismatch given
    the line flows. reference_parity=True keeps the reference's gathers,
    quirks Q2 (per-line arrays indexed by bus ids, main.py:41,68-72) and Q4
    (the to-side reactive message uses sin, main.py:70-72); False uses
    textbook branch flows. physics/fused.py computes the same in one pass;
    this form is the oracle it is held against.

    edge_group: the process group the lines are partitioned over (paper
    mode only, as gns_tpu's edge_axis): the Joule sum and the reactive
    flow sums are local partials all-reduced over it.
    """
    if edge_group is not None and reference_parity:
        raise ValueError("edge-partitioned execution requires reference_parity=False")
    if reference_parity and (qg_gen_only or dispatch != "lambda"):
        raise ValueError(
            "qg_gen_only / dispatch='setpoint_slack' are paper-mode options "
            "(reference_parity=False)"
        )
    if dispatch not in ("lambda", "setpoint_slack"):
        raise ValueError(f"dispatch must be lambda/setpoint_slack, got {dispatch!r}")
    geom = edge_geometry(lines)
    lm = line_mask if line_mask is not None else 1.0

    if reference_parity:
        q2 = q2_gathers(v, theta, geom, graph)
        v_s, v_d, th_s, th_d = q2["v_s"], q2["v_d"], q2["th_s"], q2["th_d"]
        y_s, d_s, tau_s, sh_s = q2["y_s"], q2["d_s"], q2["tau_s"], q2["sh_s"]
        msg = torch.abs(
            v_s * v_d * y_s / tau_s
            * (torch.sin(th_s - th_d - d_s - sh_s) + torch.sin(th_d - th_s - d_s + sh_s))
            + (v_s / tau_s**2) * y_s * torch.sin(d_s)
            + v_d**2 * y_s * torch.sin(d_s)
        )
        p_joule = (msg * lm).sum(-1)
    else:
        p_f, _, p_t, _ = branch_flows(v, theta, geom, graph)
        p_joule = all_reduce_sum(((p_f + p_t) * lm).sum(-1), edge_group)

    v2 = v * v
    pd = buses[..., BUS["Pd"]]
    gs = buses[..., BUS["Gs"]]
    if bus_mask is not None:
        pd, v2m = pd * bus_mask, v2 * bus_mask
    else:
        v2m = v2
    p_global = pd.sum(-1) + (v2m * gs).sum(-1) + p_joule

    if dispatch == "setpoint_slack":
        pg_new = gens[..., GEN["Pg_set"]]
        if gen_mask is not None:
            pg_new = pg_new * gen_mask
    else:
        pg_new = _lambda_dispatch(p_global, gens, gen_mask)

    qg_start = buses[..., BUS["Qd"]] - buses[..., BUS["Bs"]] * v2
    if reference_parity:
        msg_from = (
            -v_s * v_d * y_s / tau_s * torch.cos(th_s - th_d - d_s - sh_s)
            + (v_s / tau_s) ** 2 * (y_s * torch.cos(d_s) - q2["b_s"] / 2.0)
        )
        # Q4: the to-side uses sin where the from-side uses cos
        y_d, dj_d, tau_d, sh_d = q2["y_d"], q2["dj_d"], q2["tau_d"], q2["sh_d"]
        msg_to = (
            -v_d * v_s * y_d / tau_d * torch.cos(th_d - th_s - dj_d - sh_d)
            + v_d**2 * (y_d * torch.sin(dj_d) - q2["b_d"] / 2.0)
        )
        aggr_from = segment_sum(msg_from * lm, graph.dst)
        aggr_to = segment_sum(msg_to * lm, graph.src)
        qg_new = qg_start - aggr_from - aggr_to
    else:
        _, q_f, _, q_t = branch_flows(v, theta, geom, graph)
        q_at_bus = all_reduce_sum(segment_sum(q_f * lm, graph.src)
                                  + segment_sum(q_t * lm, graph.dst), edge_group)
        qg_new = qg_start + q_at_bus

    if qg_gen_only:
        ones = gen_mask if gen_mask is not None else torch.ones_like(pg_new)
        gen_bus_mask = segment_sum(ones, graph.gen) > 0
        qg_new = qg_new * gen_bus_mask.to(qg_new.dtype)
    if bus_mask is not None:
        qg_new = qg_new * bus_mask
    return pg_new, qg_new


def q2_gathers(v, theta, geom: EdgeGeom, graph: Graph) -> dict:
    """The per-line operands of the reference's parity formulas, each
    (S, E): v and theta at each line's ends, and quirk Q2's reads of the
    per-line arrays (y, tau, shift, b, the angle difference delta) at the
    BUS ids src[e] / dst[e] used as line indices (main.py:41,68-72,91-99)."""
    v_s, v_d = gather(v, graph.src), gather(v, graph.dst)
    th_s, th_d = gather(theta, graph.src), gather(theta, graph.dst)
    delta = th_s - th_d
    out = dict(v_s=v_s, v_d=v_d, th_s=th_s, th_d=th_d)
    for side, rows in (("s", graph.src_rows), ("d", graph.dst_rows)):
        out[f"y_{side}"] = gather(geom.y, rows)
        out[f"tau_{side}"] = gather(geom.tau, rows)
        out[f"sh_{side}"] = gather(geom.shift, rows)
        out[f"b_{side}"] = gather(geom.b_chg, rows)
    out["d_s"] = gather(delta, graph.src_rows)  # delta[src]
    out["dj_d"] = gather(-delta, graph.dst_rows)  # delta_ji[dst]
    return out
