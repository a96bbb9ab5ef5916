"""Shared per-edge quantities for the physics ops (port of
gns_tpu/physics/common.py).

Batched shapes: v/theta (S, N), buses (S, N, 6), lines (S, E, 7),
gens (S, G, 7). Graph indices come as a `Graph` of SegmentIndex objects
(build_graph below; GraphCache keeps a shared topology's).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gns_torch.ops.segment import SegmentIndex, gather, segment_sum
from gns_torch.utils.schema import BUS, GEN, LINE


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


def build_graph(buses, lines, gens, topo=None, device="cpu", line_rows=None) -> Graph:
    """Index sets of a batch, from host (numpy) arrays buses (S, N, 6),
    lines (S, E, 7) and gens (S, G, 7). topo: the batch's shared
    GridTopology, or None for per-sample indices (a mixed-size request).
    line_rows: the row count Q2's gathers index (default E); a rank that
    holds a slice of the lines passes the whole line count."""
    if topo is not None:
        src, dst, gen = topo.src, topo.dst, topo.gen_idx
    else:
        src = np.asarray(lines[..., LINE["f_bus"]]).astype(np.int32) - 1
        dst = np.asarray(lines[..., LINE["t_bus"]]).astype(np.int32) - 1
        gen = np.asarray(gens[..., GEN["bus_i"]]).astype(np.int32) - 1
    n = buses.shape[-2]
    e = lines.shape[-2] if line_rows is None else int(line_rows)
    return Graph(
        src=SegmentIndex(src, n, device),
        dst=SegmentIndex(dst, n, device),
        gen=SegmentIndex(gen, n, device),
        src_rows=SegmentIndex(src, e, device),
        dst_rows=SegmentIndex(dst, e, device),
    )


GRAPH_CACHE_CAP = 64  # Graphs a GraphCache holds before it drops its oldest


def host_array(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class GraphCache:
    """build_graph with a shared topology's Graphs kept: one per device,
    N, E, G, line_rows and topology ids, the oldest dropped past
    GRAPH_CACHE_CAP. With topo None (per-sample indices) every call builds
    anew from the host view of the arrays (numpy, or tensors the host can
    read). Inserts and `builds`, the count of Graphs built, are
    thread-safe."""

    def __init__(self):
        self._graphs: Dict[tuple, Graph] = {}
        self._lock = threading.Lock()
        self.builds = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __call__(self, buses, lines, gens, topo, device, line_rows=None) -> Graph:
        if topo is None:
            with self._lock:
                self.builds += 1
            return build_graph(host_array(buses), host_array(lines), host_array(gens), None,
                               device, line_rows)
        key = (str(device), buses.shape[-2], lines.shape[-2], gens.shape[-2], line_rows,
               topo.src.tobytes(), topo.dst.tobytes(), topo.gen_idx.tobytes())
        graph = self._graphs.get(key)
        if graph is None:
            graph = build_graph(buses, lines, gens, topo, device, line_rows)
            with self._lock:
                self.builds += 1
                while len(self._graphs) >= GRAPH_CACHE_CAP:
                    self._graphs.pop(next(iter(self._graphs)))
                self._graphs[key] = graph
        return graph


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


def ones_mask(n, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """An all-ones mask: n is a length (one grid) or an (S, n) shape (a
    batch)."""
    return torch.ones(n, dtype=dtype, device=device)


def branch_flows(v, theta, geom: EdgeGeom, graph: Graph):
    """Textbook AC branch flows (paper mode): per-line (p_f, q_f, p_t, q_t),
    the power flowing into the line at its from- and to-side."""
    vth = torch.stack([v, theta], dim=-1)
    at_src = gather(vth, graph.src)
    at_dst = gather(vth, graph.dst)
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


def bus_injections(v, buses, gens, pg, qg_bus, gen_mask: Optional[torch.Tensor],
                   graph: Optional[Graph] = None):
    """(P_inj, Q_inj) per bus, each (S, N), from per-generator active power
    pg (S, G) and per-bus reactive generation qg_bus (S, N)
    (gns_tpu/physics/common.py:93). graph: the batch's Graph; without one
    the generator buses are read from gens' bus column on the host."""
    index = graph.gen if graph is not None else SegmentIndex(
        gens[..., GEN["bus_i"]].detach().cpu().numpy().astype(np.int32) - 1,
        buses.shape[-2], buses.device)
    if gen_mask is not None:
        pg = pg * gen_mask
    pg_bus = segment_sum(pg, index)
    v2 = v * v
    p_inj = pg_bus - buses[..., BUS["Pd"]] - buses[..., BUS["Gs"]] * v2
    q_inj = qg_bus - buses[..., BUS["Qd"]] + buses[..., BUS["Bs"]] * v2
    return p_inj, q_inj
