"""Batched serving: case dicts in, decoded predictions out (port of
gns_tpu/serve.py).

A request set is chunked into batch_size-sized batches (the last padded
with copies of its last case), each batch runs one K-step forward on the
device, and the angles are decoded into Newton-Raphson's slack-pinned
gauge (eval/harness.py align_slack_angle). On the card every segment-sum
and gather of the forward is a K1 / K2 launch (ops/segment.py).

Usage:
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.serve import GNSPredictor

    model, cfg = load_pretrained(300)              # on "cuda"
    out = GNSPredictor(model, cfg).predict(cases)  # list of pypower dicts
    out["v"], out["theta"], out["last_loss"]       # (S, N), (S, N), (S,)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gns_torch.eval.harness import align_slack_angle
from gns_torch.models.gns import GNS, batch_tensors, gns_forward, step_params
from gns_torch.physics.common import build_graph
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology


class GNSPredictor:
    """Batched predictor that reuses per-shape state.

    The step weights are fused and cast once. The index sets of a shared
    topology (ids and the CSR that K1 walks) are built once per (shape,
    topology) and cached in `_compiled`, the way the JAX package caches
    one compiled program per shape; per-sample indices of a mixed-size
    request are built per batch.

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
        device="cuda",
    ):
        self.device = resolve_device(device)
        if cfg.compute_dtype == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.batch_size = batch_size
        self.method = method
        self.align_slack = align_slack
        with torch.no_grad():
            steps = step_params(model, cfg)
        self.steps = [
            {h: {n: t.to(self.device) for n, t in p.items()} for h, p in s.items()}
            for s in steps
        ]
        self._compiled: Dict[tuple, object] = {}

    def _graph_for(self, batch, topo):
        if topo is None:
            return build_graph(batch.buses, batch.lines, batch.generators, None, self.device)
        key = (batch.buses.shape, batch.lines.shape, batch.generators.shape,
               topo.src.tobytes(), topo.dst.tobytes(), topo.gen_idx.tobytes())
        graph = self._compiled.get(key)
        if graph is None:
            graph = build_graph(batch.buses, batch.lines, batch.generators, topo, self.device)
            self._compiled[key] = graph
        return graph

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
        outs = []
        for lo in range(0, len(cases), self.batch_size):
            chunk = cases[lo:lo + self.batch_size]
            padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
            batch = batch_from_cases(padded, paper_shunts=not self.cfg.true_shunts)
            topo = extract_shared_topology(batch)
            graph = self._graph_for(batch, topo)
            with torch.no_grad():
                out = gns_forward(
                    self.steps, self.cfg, batch_tensors(batch, self.device), graph,
                    dense=batch.is_dense(), method=self.method,
                )
            outs.append((out, len(chunk)))
        v = np.concatenate([o.v[:k].cpu().numpy() for o, k in outs])
        theta = np.concatenate([o.theta[:k].cpu().numpy() for o, k in outs])
        if self.align_slack:
            theta = np.stack([align_slack_angle(t, c) for t, c in zip(theta, cases)])
        return {
            "v": v,
            "theta": theta,
            "last_loss": np.concatenate([o.last_loss[:k].cpu().numpy() for o, k in outs]),
        }


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
