"""Batched serving: case dicts in, decoded predictions out (port of
gns_tpu/serve.py).

A request set is chunked into batch_size-sized batches (the last padded
with copies of its last case), each batch runs one K-step forward on the
device, and the angles are decoded into Newton-Raphson's slack-pinned
gauge (eval/harness.py align_slack_angle, one call over the request, the
slack rows found in the packed bus types). On the card every segment-sum
and gather of the forward is a K1 / K2 launch (ops/segment.py).

Usage:
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.serve import GNSPredictor

    model, cfg = load_pretrained(300)              # on "cuda"
    out = GNSPredictor(model, cfg).predict(cases)  # list of pypower dicts
    out["v"], out["theta"], out["last_loss"]       # (S, N), (S, N), (S,)

With a DeviceMesh that has a "dp" axis (parallel/solver_dp.py), every rank
is given the whole request; each batch's rows are split over dp, every
rank runs the forward (K1 / K2 on its own device) over its block, and v,
theta and last_loss are all-gathered in row order, so every rank returns
the whole answer.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gns_torch.eval.harness import align_slack_angle
from gns_torch.models.gns import GNS, batch_tensors, gns_forward, step_params
from gns_torch.ops import collectives
from gns_torch.ops.segment import check_method
from gns_torch.parallel.solver_dp import dp_block, dp_group, dp_size
from gns_torch.physics.common import GraphCache
from gns_torch.utils import native, profiling
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology
from gns_torch.utils.schema import BUS


class GNSPredictor:
    """Batched predictor that reuses per-shape state.

    The step weights are fused and cast once. The index sets of a shared
    topology (ids and the CSR that K1 walks) are built once per shape and
    topology and kept in `_graphs` (physics/common.py GraphCache), the way
    the JAX package caches one compiled program per shape; per-sample
    indices of a mixed-size request are built per batch. The counter
    serve.index_builds counts the Graphs a request had built.

    With compute_dtype "float32" the constructor turns TF32 off for
    matmuls and cuDNN (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 = False, process-wide): float32 means
    float32, as the parity numerics need.
    """

    def __init__(
        self,
        model: GNS,
        cfg: GNSConfig,
        batch_size: int = 1024,
        method: str = "auto",
        align_slack: bool = True,
        mesh=None,
        device="cuda",
    ):
        """mesh: optional DeviceMesh with a "dp" axis; batch_size must
        then divide into it. device: this rank's device under a mesh."""
        self.device = resolve_device(device)
        if mesh is not None and batch_size % dp_size(mesh):
            raise ValueError(
                f"batch_size {batch_size} must divide the mesh's dp axis ({dp_size(mesh)})"
            )
        self.mesh = mesh
        if cfg.compute_dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.batch_size = batch_size
        self.method = check_method(method, self.device)
        self.align_slack = align_slack
        with torch.no_grad():
            steps = step_params(model, cfg)
        self.steps = [
            {h: {n: t.to(self.device) for n, t in p.items()} for h, p in s.items()}
            for s in steps
        ]
        self._graphs = GraphCache()
        if native.HAVE_NATIVE:  # the packer is built here, not in a request
            native.load()

    def _graph_for(self, batch, topo):
        builds = self._graphs.builds
        graph = self._graphs(batch.buses, batch.lines, batch.generators, topo, self.device)
        if self._graphs.builds != builds:
            profiling.count("serve.index_builds")
        return graph

    def _gather(self, out):
        """v, theta and last_loss of every dp rank's rows, in row order:
        one all-gather of the three packed side by side."""
        n = out.v.shape[1]
        packed = torch.cat([out.v, out.theta, out.last_loss[:, None]], dim=1)
        full = torch.cat(collectives.all_gather_list(packed, dp_group(self.mesh)))
        return out._replace(v=full[:, :n], theta=full[:, n:2 * n], last_loss=full[:, 2 * n],
                            total_loss=None, delta_p=None, delta_q=None)

    def predict(self, cases: List[Dict]) -> Dict[str, np.ndarray]:
        """Solve a list of pypower-style case dicts.

        Returns {"v": (S, N), "theta": (S, N) [decoded gauge],
        "last_loss": (S,)} for the S requested grids (padding rows of the
        last chunk stripped). Each chunk's results stay on the device until
        every chunk is queued, so host packing of chunk i+1 overlaps the
        device's work on chunk i.
        """
        if not cases:
            raise ValueError("empty request")
        span = profiling.span
        with span("serve.predict"):
            outs, types, n_bus = [], [], []
            for lo in range(0, len(cases), self.batch_size):
                chunk = cases[lo:lo + self.batch_size]
                padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                batch = batch_from_cases(padded, paper_shunts=not self.cfg.true_shunts)
                # the whole chunk's bus types: every dp rank decodes the gathered answer
                types.append(batch.buses[:len(chunk), :, BUS["type"]])
                n_bus.append(batch.n_bus[:len(chunk)])
                with span("pack.topology"):
                    topo = extract_shared_topology(batch)
                    dense = batch.is_dense()
                if self.mesh is not None:
                    lo, hi = dp_block(self.mesh, self.batch_size)
                    batch = type(batch)(*(a[lo:hi] for a in batch))
                with span("serve.graph"):
                    graph = self._graph_for(batch, topo)
                with span("serve.upload"):
                    inputs = batch_tensors(batch, self.device)
                with torch.no_grad(), span("serve.forward"):
                    out = gns_forward(self.steps, self.cfg, inputs, graph, dense=dense,
                                      method=self.method)
                if self.mesh is not None:
                    out = self._gather(out)
                outs.append((out, len(chunk)))
            with span("serve.readback"):
                v = np.concatenate([o.v[:k].cpu().numpy() for o, k in outs])
                theta = np.concatenate([o.theta[:k].cpu().numpy() for o, k in outs])
                last_loss = np.concatenate([o.last_loss[:k].cpu().numpy() for o, k in outs])
            if self.align_slack:
                with span("serve.decode"):
                    profiling.count("serve.batched_decodes")
                    theta = align_slack_angle(theta, cases, np.concatenate(types),
                                              np.concatenate(n_bus))
        return {"v": v, "theta": theta, "last_loss": last_loss}


def predict(
    model: GNS,
    cfg: GNSConfig,
    cases: List[Dict],
    batch_size: Optional[int] = None,
    method: str = "auto",
    align_slack: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """One-shot convenience wrapper around GNSPredictor."""
    bs = batch_size if batch_size is not None else max(len(cases), 1)
    return GNSPredictor(
        model, cfg, batch_size=bs, method=method, align_slack=align_slack, device=device
    ).predict(cases)
