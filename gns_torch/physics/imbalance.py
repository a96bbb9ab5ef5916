"""Local power imbalance: the per-bus physics residual, the loss signal
(port of gns_tpu/physics/imbalance.py; reference GNS/main.py:80-104).

delta_p / delta_q (S, N) are each bus's active / reactive mismatch:
generation scattered to buses, minus load and shunt, plus the directed
line-flow sums. The squared residual summed over buses is the model's
unsupervised loss (main.py:198). Modes as in compensation.py. The fused
physics refresh (physics/fused.py) computes compensation and imbalance in
one pass; these unfused forms are its oracles.
"""

from __future__ import annotations

from typing import Optional

import torch

from gns_torch.ops.segment import segment_sum
from gns_torch.physics.common import Graph, branch_flows, edge_geometry
from gns_torch.physics.compensation import q2_gathers
from gns_torch.utils.schema import BUS, BUS_TYPE_SLACK


def local_power_imbalance(
    v,
    theta,
    buses,
    lines,
    gens,
    pg_k,
    qg_k,
    graph: Graph,
    *,
    reference_parity: bool = True,
    bus_mask: Optional[torch.Tensor] = None,
    line_mask: Optional[torch.Tensor] = None,
    gen_mask: Optional[torch.Tensor] = None,
    method: str = "auto",
    zero_slack_dp: bool = False,
):
    """(delta_p (S, N), delta_q (S, N)) for generator outputs pg_k (S, G)
    and per-bus reactive generation qg_k (S, N).

    zero_slack_dp: mask delta_p at the slack bus (type 3), NR's convention
    (paper mode; pair with global_active_compensation(dispatch=
    "setpoint_slack"))."""
    geom = edge_geometry(lines)
    lm = line_mask if line_mask is not None else 1.0

    pg = pg_k * gen_mask if gen_mask is not None else pg_k
    pg_bus = segment_sum(pg, graph.gen, method=method)
    v2 = v * v
    delta_p_start = pg_bus - buses[..., BUS["Pd"]] - buses[..., BUS["Gs"]] * v2
    delta_q_start = qg_k - buses[..., BUS["Qd"]] + buses[..., BUS["Bs"]] * v2

    if reference_parity:
        q2 = q2_gathers(v, theta, geom, graph, method)
        v_s, v_d, th_s, th_d = q2["v_s"], q2["v_d"], q2["th_s"], q2["th_d"]
        y_s, d_s, tau_s, sh_s = q2["y_s"], q2["d_s"], q2["tau_s"], q2["sh_s"]
        y_d, dj_d, tau_d, sh_d = q2["y_d"], q2["dj_d"], q2["tau_d"], q2["sh_d"]
        p_msg_from = (
            v_s * v_d * y_s / tau_s * torch.sin(th_s - th_d - d_s - sh_s)
            + (v_s / tau_s) ** 2 * y_s * torch.sin(d_s)
        )
        p_msg_to = (
            v_d * v_s * y_d / tau_d * torch.sin(th_d - th_s - dj_d - sh_d)
            + v_d**2 * y_d * torch.sin(dj_d)
        )
        p_sum = (segment_sum(p_msg_from * lm, graph.dst, method=method)
                 + segment_sum(p_msg_to * lm, graph.src, method=method))
        delta_p = delta_p_start + p_sum
        q_msg_from = (
            -v_s * v_d * y_s / tau_s * torch.cos(th_s - th_d - d_s - sh_s)
            + (v_s / tau_s) ** 2 * (y_s * torch.cos(d_s) - q2["b_s"] / 2.0)
        )
        # Q4 again: sin on the to-side (main.py:99)
        q_msg_to = (
            -v_d * v_s * y_d / tau_d * torch.cos(th_d - th_s - dj_d - sh_d)
            + v_d**2 * (y_d * torch.sin(dj_d) - q2["b_d"] / 2.0)
        )
        q_sum = (segment_sum(q_msg_from * lm, graph.dst, method=method)
                 + segment_sum(q_msg_to * lm, graph.src, method=method))
        delta_q = delta_q_start + q_sum
    else:
        p_f, q_f, p_t, q_t = branch_flows(v, theta, geom, graph, method)
        delta_p = delta_p_start - (segment_sum(p_f * lm, graph.src, method=method)
                                   + segment_sum(p_t * lm, graph.dst, method=method))
        delta_q = delta_q_start - (segment_sum(q_f * lm, graph.src, method=method)
                                   + segment_sum(q_t * lm, graph.dst, method=method))

    if zero_slack_dp:
        if reference_parity:
            raise ValueError("zero_slack_dp is a paper-mode option")
        delta_p = delta_p * (buses[..., BUS["type"]] != BUS_TYPE_SLACK).to(delta_p.dtype)
    if bus_mask is not None:
        delta_p = delta_p * bus_mask
        delta_q = delta_q * bus_mask
    return delta_p, delta_q
