"""Explicit edge-partitioned execution (port of
gns_tpu/parallel/edge_partition.py).

The lines of every grid are partitioned over the 'gp' mesh axis, bus and
generator state is replicated, and every edge -> bus aggregation is a
local partial sum (K1 on the rank's own slice, whose Graph indexes global
bus ids) followed by an all-reduce over gp: the boundary exchange of
BASELINE.json's north star. Per K step and grid that is one (N, D)
all-reduce for the message aggregate plus the physics' Joule sum and its
two paired mismatch sums (models/gns.py, physics/fused.py). Node-side
compute is duplicated; the O(E * latent) edge work splits.

Requires paper-correct physics (reference_parity=False): quirk Q2 indexes
per-line arrays with bus ids, which has no consistent meaning on a
partitioned edge set. (parallel/sharding.py's gp layout keeps parity mode
by all-gathering those arrays, the counterpart of XLA's partitioned
gathers.)

The gradient rule. After each forward all-reduce every gp rank holds the
same node state, so every rank computes the same loss. The all-reduce
(ops/collectives.py all_reduce_sum) is an autograd Function whose
backward sums the ranks' output gradients. Each rank scales its copy of
the loss by 1/gp; then:
  * the gradient reaching any all-reduce input is the sum over ranks of
    (1/gp) x the true output gradient, i.e. the true one, so edge-side
    partials and everything upstream of them get true-scale gradients;
  * a replicated computation's gradient on one rank is 1/gp of the true
    one plus that rank's own edge-side share;
so EVERY parameter gradient, replicated or edge-side, is summed over gp
(and over dp, with the loss a mean over the global batch): one
all-reduce of all gradients over dp x gp per step. Summing without the
1/gp scale would multiply every gradient by gp; skipping the sum for the
replicated parameters would leave them at 1/gp of their due.
tests/test_torch_edge_partition.py holds the gradients leaf by leaf
against single-process autograd.
"""

from __future__ import annotations

from typing import Optional

from gns_torch.parallel.sharding import _sharded_eval, _sharded_step
from gns_torch.train.trainer import make_optimizer
from gns_torch.utils.config import GNSConfig


def make_edge_partitioned_forward(
    cfg: GNSConfig,
    mesh,
    dp: Optional[str] = "dp",
    gp: str = "gp",
    method: str = "auto",
    topo=None,
):
    """Batched forward with explicit edge partitioning: fn(model, whole
    GridBatch) -> GNSOutput of the whole batch on every rank (replicated
    over gp, all-gathered over dp)."""
    if cfg.reference_parity:
        raise ValueError("edge partitioning requires reference_parity=False")
    return _sharded_eval(cfg, mesh, method, dp, gp, topo)


def make_edge_partitioned_train_step(
    cfg: GNSConfig,
    mesh,
    optimizer=None,
    dp: Optional[str] = "dp",
    gp: str = "gp",
    method: str = "auto",
    topo=None,
):
    """Full training step with explicit dp x gp collectives: per-bus
    partial all-reduces over gp inside the forward (and their sums in the
    backward), gradients summed over dp x gp under the module docstring's
    rule. (TrainState, whole GridBatch) -> (TrainState, {loss,
    last_loss}), the state updated in place."""
    if cfg.reference_parity:
        raise ValueError("edge partitioning requires reference_parity=False")
    return _sharded_step(cfg, mesh, optimizer or make_optimizer(cfg), method, dp, gp, topo)
