"""Shared per-edge quantities for the physics ops (port of
gns_tpu/physics/common.py).

Batched shapes: v/theta (S, N), buses (S, N, 6), lines (S, E, 7),
gens (S, G, 7). Graph indices come as a `Graph` of SegmentIndex objects
(models/gns.py build_graph).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gns_torch.ops.segment import SegmentIndex, gather
from gns_torch.utils.schema import GEN, LINE


class Graph(NamedTuple):
    """The index sets of one topology, each a host-checked SegmentIndex.

    src/dst/gen index bus ids into N buses (aggregation at buses and the
    bus -> edge gathers). src_rows/dst_rows are the same bus ids as
    indices into the E rows of per-line arrays: the reference's quirk Q2
    gathers (physics/fused.py), valid because batches keep E >= N.
    """

    src: SegmentIndex
    dst: SegmentIndex
    gen: SegmentIndex
    src_rows: SegmentIndex
    dst_rows: SegmentIndex


def build_graph(buses, lines, gens, topo=None, device="cpu") -> Graph:
    """Index sets of a batch, from host (numpy) arrays buses (S, N, 6),
    lines (S, E, 7) and gens (S, G, 7). topo: the batch's shared
    GridTopology, or None for per-sample indices (a mixed-size request)."""
    if topo is not None:
        src, dst, gen = topo.src, topo.dst, topo.gen_idx
    else:
        src = np.asarray(lines[..., LINE["f_bus"]]).astype(np.int32) - 1
        dst = np.asarray(lines[..., LINE["t_bus"]]).astype(np.int32) - 1
        gen = np.asarray(gens[..., GEN["bus_i"]]).astype(np.int32) - 1
    n, e = buses.shape[-2], lines.shape[-2]
    return Graph(
        src=SegmentIndex(src, n, device),
        dst=SegmentIndex(dst, n, device),
        gen=SegmentIndex(gen, n, device),
        src_rows=SegmentIndex(src, e, device),
        dst_rows=SegmentIndex(dst, e, device),
    )


class EdgeGeom(NamedTuple):
    """Per-line electrical quantities, all (S, E)."""

    y: torch.Tensor  # admittance magnitude 1/sqrt(r^2+x^2) (reference main.py:38)
    g: torch.Tensor  # series conductance r/(r^2+x^2)
    b_series: torch.Tensor  # series susceptance -x/(r^2+x^2)
    b_chg: torch.Tensor  # total line charging susceptance
    tau: torch.Tensor  # tap ratio (0 already mapped to 1 in data prep)
    shift: torch.Tensor  # phase shift, radians


def edge_geometry(lines: torch.Tensor) -> EdgeGeom:
    r = lines[..., LINE["r"]]
    x = lines[..., LINE["x"]]
    z2 = r * r + x * x
    return EdgeGeom(
        y=1.0 / torch.sqrt(z2),
        g=r / z2,
        b_series=-x / z2,
        b_chg=lines[..., LINE["b"]],
        tau=lines[..., LINE["tau"]],
        shift=lines[..., LINE["theta"]],
    )


def branch_flows(v, theta, geom: EdgeGeom, graph: Graph, method: str = "auto"):
    """Textbook AC branch flows (paper mode): per-line (p_f, q_f, p_t, q_t),
    the power flowing into the line at its from- and to-side."""
    vth = torch.stack([v, theta], dim=-1)
    at_src = gather(vth, graph.src, method=method)
    at_dst = gather(vth, graph.dst, method=method)
    vf = at_src[..., 0] / geom.tau
    vt = at_dst[..., 0]
    th = at_src[..., 1] - at_dst[..., 1] - geom.shift
    c, s = torch.cos(th), torch.sin(th)
    g, b = geom.g, geom.b_series
    bc2 = geom.b_chg / 2.0
    p_f = vf * vf * g - vf * vt * (g * c + b * s)
    q_f = -vf * vf * (b + bc2) - vf * vt * (g * s - b * c)
    p_t = vt * vt * g - vf * vt * (g * c - b * s)
    q_t = -vt * vt * (b + bc2) + vf * vt * (g * s + b * c)
    return p_f, q_f, p_t, q_t
