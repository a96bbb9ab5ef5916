"""Data parallelism for the batched solvers and serving (port of
gns_tpu/parallel/solver_dp.py).

gns_tpu places each chunk's batch axis on a mesh's "dp" axis and lets
XLA partition the one jitted program; its only collectives are the
all-reduce of the lock-step while_loop's "all converged" predicate and the
gather of the packed result. The port runs one process per device
(torch.distributed), so the same contract is written out:

  * every rank is handed the WHOLE request, as gns_tpu's caller passes
    one host array; each chunk is padded to a multiple of the dp size by
    repeating its last grid (`padded_rows` / `pad_rows`) and each rank
    takes its contiguous block of rows (`put_dp`);
  * the Newton / fast-decoupled loop's exit test is one all-reduce (MIN)
    of the local "all converged" flag over dp per iteration
    (`all_converged`), at the host sync the loop already has, so every
    rank runs the same iteration count and the reported counts equal the
    single-process run's (converged grids are frozen, so the fixed points
    do not depend on the count);
  * the packed chunk result is all-gathered over dp in row order and
    trimmed of the padding (`gather_rows`), so every rank returns the
    whole result.

Grids never interact, so the fixed points are those of the single-process
run. Decisions a rank makes from its own measurements (compact_after=
"auto", solve_ac's warm-start policy) are taken from the first dp rank
(`agree`), so no rank runs a different program.

The port's mesh is a torch.distributed.device_mesh.DeviceMesh whose
mesh_dim_names holds "dp". Usage, one process per device:

    from gns_torch.parallel.mesh import initialize_distributed
    from gns_torch.parallel.solver_dp import solver_mesh
    initialize_distributed()                  # torchrun's environment
    mesh = solver_mesh()                      # all ranks, axis "dp"
    solve_ac(cases, mesh=mesh)                # any solver arm
    screen_n1(case, mesh=mesh)                # the screens
    GNSPredictor(model, cfg, mesh=mesh)       # serving
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gns_torch.ops import collectives
from gns_torch.utils.device import resolve_device


def solver_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """A 1-axis ("dp",) DeviceMesh over the first n_devices ranks of the
    initialized world (default: all of them), the canonical mesh for
    sharded batched solves. Any mesh with a "dp" axis works."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"solver_mesh of {n} devices in a world of {world}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("dp",))


def dp_size(mesh) -> int:
    """Rows the batch axis must divide: the size of the mesh's "dp" axis
    (1 when no mesh, the unsharded path)."""
    if mesh is None:
        return 1
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "dp" not in names:
        raise ValueError(f"solver mesh needs a 'dp' axis, got {names}")
    return int(mesh.size(names.index("dp")))


def padded_rows(s: int, mesh) -> int:
    """Smallest batch size >= s that divides the mesh's dp axis."""
    m = dp_size(mesh)
    return ((s + m - 1) // m) * m


def pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading axis to `target` rows by repeating the last row (a
    duplicate grid solves identically; callers trim after the gather)."""
    s = arr.shape[0]
    if s == target:
        return arr
    if s > target:
        raise ValueError(f"batch of {s} rows exceeds target {target}")
    return np.concatenate([arr, np.repeat(arr[-1:], target - s, axis=0)])


def dp_group(mesh):
    """The process group of this rank's dp axis (None without a mesh)."""
    if mesh is None:
        return None
    dp_size(mesh)
    return mesh.get_group("dp")


def dp_block(mesh, s: int):
    """(lo, hi): this rank's contiguous rows of a batch of s rows, s a
    multiple of the dp size."""
    m = dp_size(mesh)
    if s % m:
        raise ValueError(f"batch of {s} rows does not divide the dp axis ({m})")
    r = 0 if mesh is None else mesh.get_local_rank("dp")
    return r * (s // m), (r + 1) * (s // m)


def mesh_device(mesh) -> torch.device:
    """This rank's device: its current CUDA device on a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _device(mesh, device):
    """`device` if given, else the mesh's device on this rank (the card
    without a mesh, as every entry point of the port)."""
    if device is not None:
        return resolve_device(device)
    return resolve_device() if mesh is None else mesh_device(mesh)


def put_dp(mesh, arr, device=None) -> torch.Tensor:
    """This rank's block of rows of a batch-leading array, as a tensor on
    `device` (default: the mesh's device; the whole array without a
    mesh)."""
    lo, hi = dp_block(mesh, np.shape(arr)[0])
    return torch.as_tensor(np.asarray(arr)[lo:hi], device=_device(mesh, device))


def put_repl(mesh, tree, device=None):
    """Replicated inputs (index arrays, weights): every rank already holds
    the whole value, so this only moves array leaves onto `device`
    (default: the mesh's device)."""
    device = _device(mesh, device)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v) for v in t)
        return torch.as_tensor(t, device=device)

    return put(tree)


def shard_chunk(mesh, arrays, k: int):
    """Pad each batch-leading numpy array of a k-row chunk to the dp
    multiple and return this rank's rows of each (unchanged without a
    mesh)."""
    if mesh is None:
        return list(arrays)
    target = padded_rows(k, mesh)
    lo, hi = dp_block(mesh, target)
    return [pad_rows(np.asarray(a), target)[lo:hi] for a in arrays]


def gather_rows(mesh, local: torch.Tensor, k: int) -> torch.Tensor:
    """Every rank's block of a chunk's result, concatenated over dp in row
    order and trimmed to the chunk's k real rows."""
    if mesh is None:
        return local[:k]
    parts = collectives.all_gather_list(local, dp_group(mesh))
    return torch.cat(parts)[:k]


def all_converged(conv: torch.Tensor, group) -> bool:
    """The lock-step loop's exit test: every grid of every dp rank
    converged. One all-reduce (MIN) of the local flag under a mesh."""
    done = conv.all()
    if group is not None:
        flag = done.to(torch.int32).reshape(1)
        collectives.all_reduce_(flag, group, op=dist.ReduceOp.MIN)
        done = flag[0]
    return bool(done)


def agree(mesh, value: int, device="cpu") -> int:
    """The first dp rank's `value` on every rank (a local decision made
    the same everywhere); `value` itself without a mesh."""
    if mesh is None:
        return value
    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    collectives.broadcast_(t, 0, dp_group(mesh))
    return int(t[0])
