"""Active line flow, the reference's evaluation metric (port of
gns_tpu/physics/lineflow.py; reference GNS/evaluate.py:15-18).

P_line = (1/x) V_src V_dst sin(theta_src - theta_dst) per line: the
lossless, tap-free flow.
"""

from __future__ import annotations

import torch

from gns_torch.ops.segment import gather
from gns_torch.physics.common import Graph
from gns_torch.utils.schema import LINE


def active_line_flow(v, theta, lines, graph: Graph, method: str = "auto"):
    """v / theta (S, N), lines (S, E, 7) -> per-line active flow (S, E)."""
    vth = torch.stack([v, theta], dim=-1)
    at_src = gather(vth, graph.src, method=method)
    at_dst = gather(vth, graph.dst, method=method)
    x = lines[..., LINE["x"]]
    return (1.0 / x) * at_src[..., 0] * at_dst[..., 0] * torch.sin(at_src[..., 1] - at_dst[..., 1])
