"""Device meshes and process-group start-up (port of
gns_tpu/parallel/mesh.py).

gns_tpu is single-controller: one process drives every device of a
jax.sharding.Mesh, and XLA inserts the collectives. torch runs one process
per device; each rank holds its slice and torch.distributed's collectives
join the slices. The port's mesh is a
torch.distributed.device_mesh.DeviceMesh over the ranks of the initialized
world, with gns_tpu's axis names:

  dp  - data parallel: the batch dimension, gradient all-reduce.
  gp  - graph (edge) partition: the line dimension; every edge -> bus
        aggregation becomes a local partial sum and an all-reduce over gp
        (parallel/edge_partition.py).
  dcn - the outer, cross-host axis of a hybrid mesh (dcn, dp, gp).

The backend is the caller's process group: NCCL when the ranks' devices
are CUDA, gloo on the CPU. Start-up: `initialize_distributed()` first
(torchrun sets RANK / WORLD_SIZE / MASTER_ADDR / LOCAL_RANK), then a mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _ranks(ranks: Optional[Sequence[int]]):
    if ranks is not None:
        return list(ranks)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.initialize_distributed() "
            "(or torch.distributed.init_process_group) before building a mesh"
        )
    return list(range(dist.get_world_size()))


def make_mesh(
    dp: Optional[int] = None,
    gp: int = 1,
    ranks: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str] = ("dp", "gp"),
    device_type: str = "cuda",
):
    """A (dp, gp) DeviceMesh over `ranks` (default: the whole world).

    dp defaults to n_ranks // gp. Rank r sits at (r // gp, r % gp), so a gp
    group is consecutive ranks, the ones a host's fast links join.
    """
    from torch.distributed.device_mesh import DeviceMesh

    ranks = _ranks(ranks)
    n = len(ranks)
    if dp is None:
        if n % gp:
            raise ValueError(f"{n} devices not divisible by gp={gp}")
        dp = n // gp
    if dp * gp != n:
        raise ValueError(f"mesh {dp}x{gp} != {n} devices")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(dp, gp), mesh_dim_names=axis_names)


def make_hybrid_mesh(
    dcn: Optional[int] = None,
    dp: Optional[int] = None,
    gp: int = 1,
    ranks: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str, str] = ("dcn", "dp", "gp"),
    device_type: str = "cuda",
):
    """Hybrid multi-host mesh: outer 'dcn' axis across hosts, inner
    ('dp', 'gp') axes across each host's devices.

    Shard the batch over ('dcn', 'dp') together (sharding.py dp=("dcn",
    "dp")) so the gradient all-reduce spans hosts once per step, and keep
    'gp' (the per-K-step edge exchange) inside a host.

    dcn defaults to the host count: the ranks over torchrun's
    LOCAL_WORLD_SIZE (one host when it is not set); dp to the per-host
    devices // gp. Ranks are numbered host by host, as torchrun numbers
    them.
    """
    from torch.distributed.device_mesh import DeviceMesh

    ranks = _ranks(ranks)
    n = len(ranks)
    if dcn is None:
        dcn = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if n % dcn:
        raise ValueError(f"{n} devices not divisible by dcn={dcn}")
    per_host = n // dcn
    if dp is None:
        if per_host % gp:
            raise ValueError(f"{per_host} per-host devices not divisible by gp={gp}")
        dp = per_host // gp
    if dcn * dp * gp != n:
        raise ValueError(f"mesh {dcn}x{dp}x{gp} != {n} devices")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(dcn, dp, gp),
                      mesh_dim_names=axis_names)


def initialize_distributed(**kwargs) -> None:
    """Start the process group. Call it first in every process.

    Behavior (gns_tpu's contract):
      * already initialized -> no-op, so library and launcher may both
        call this;
      * explicit kwargs (backend, init_method, world_size, rank, ...) ->
        torch.distributed.init_process_group with them; failures
        PROPAGATE (silently running one process on a real cluster would
        train each rank alone, with no gradient sync);
      * no kwargs and no cluster environment at all (none of RANK,
        WORLD_SIZE, MASTER_ADDR set) -> return: a single-process run, the
        right default for local development;
      * no kwargs and a cluster environment -> init from it (env://, NCCL
        when CUDA is available, else gloo); any failure, a partial
        environment included, PROPAGATES.

    A CUDA process is bound to the device LOCAL_RANK names (torchrun sets
    it) before the group starts, so NCCL's communicator opens on it.
    """
    if dist.is_initialized():
        return
    if not kwargs:
        if not any(k in os.environ for k in _CLUSTER_ENV):
            return  # no cluster environment: single-process dev run
        kwargs = {"backend": "nccl" if torch.cuda.is_available() else "gloo",
                  "init_method": "env://"}
    if torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(**kwargs)
