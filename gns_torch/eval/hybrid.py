"""Hybrid solver: the GNS prediction warm-starts the batched exact solver
(port of gns_tpu/eval/hybrid.py).

A learned power-flow solver's practical use (Donon et al., the paper
behind the reference, GNS/main.py:10) is not to replace Newton-Raphson but
to seed it: the network's prediction is a good initial iterate, and Newton
converges quadratically from a good start. The reference only compares the
two side by side (GNS/evaluate.py:89-148); here it is one pipeline.

The fused path runs each chunk as one sequence of device work with no host
round trip between its stages (gns_tpu compiles the same stages into one
XLA program):

    stacked raw case arrays (float32, one host pass shared with the flat
    arm: nr_batched.stack_cases)
      -> grid preparation on the device (the prepare_case column
         transforms as tensor ops, `_prepare_stacked`)
      -> the GNS forward (models/gns.py gns_forward; on the card every
         segment-sum and gather is a K1 / K2 launch)
      -> the slack-gauge decode (theta - theta_slack + Va_slack)
      -> the warm seeding of the free unknowns
      -> the dense admittance assembly (nr_batched._assemble_gb, K1)
      -> the Newton loop (nr_batched._nr_solve) or the fast-decoupled one
         (fdpf._fdpf_solve)
      -> ONE packed output, one copy to the host (the prediction is
         fetched only when asked)

The loops read their exit test from the device once per iteration; nothing
else waits for the host. The result is exact: the same fixed point as a
flat start (Newton's root does not depend on its start; only the
iteration count does).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from gns_torch.eval.fdpf import _fdpf_core, solve_batched_fdpf
from gns_torch.eval.nr_batched import (
    _cache_put,
    _compact_stragglers,
    _nr_core,
    _on,
    _topology,
    build_nr_small_stacked,
    check_no_mesh,
    f32_matmuls,
    resolve_compact_after,
    solve_batched,
    stack_cases,
    unpack_results,
)
from gns_torch.models.gns import GNS, gns_forward, step_params
from gns_torch.physics.common import build_graph
from gns_torch.serve import GNSPredictor
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.prepare import GridBatch, GridTopology

# The forward's index sets (physics/common.py Graph) per (topology,
# device), module-level so repeated hybrid_solve calls reuse them as
# GNSPredictor does; bounded by nr_batched._cache_put.
_FUSED_CACHE: Dict[tuple, object] = {}


def _prepare_stacked(bus, branch, gen, base, paper_shunts: bool):
    """Grid preparation on the device from stacked raw case arrays: the
    tensor twin of utils/prepare.py prepare_case (reference
    GNS/utils.py:17-41 column / unit contract), batched: bus (S, N, Cb),
    branch (S, E, Cc), gen (S, G, Cg), base (S,), all float32."""
    inv = 1.0 / base[:, None]
    shunt_g = torch.ones_like(bus[:, :, 4]) if paper_shunts else bus[:, :, 4]
    shunt_b = -torch.ones_like(bus[:, :, 5]) if paper_shunts else bus[:, :, 5]
    buses = torch.stack(
        [bus[:, :, 0], bus[:, :, 1], bus[:, :, 2] * inv, bus[:, :, 3] * inv,
         shunt_g * inv, shunt_b * inv], dim=2,
    )
    tau = torch.where(branch[:, :, 8] == 0, torch.ones_like(branch[:, :, 8]), branch[:, :, 8])
    lines = torch.stack(
        [branch[:, :, 0], branch[:, :, 1], branch[:, :, 2], branch[:, :, 3],
         branch[:, :, 4], tau, torch.deg2rad(branch[:, :, 9])], dim=2,
    )
    pg = gen[:, :, 1] * inv
    gens = torch.stack(
        [gen[:, :, 0], gen[:, :, 8] * inv, gen[:, :, 9] * inv, pg,
         gen[:, :, 5], gen[:, :, 2] * inv, pg], dim=2,
    )
    return buses, lines, gens


def _forward_graph(bus, branch, gen, device):
    """The forward's Graph for the stacks' shared topology (cached)."""
    topo = GridTopology(
        src=branch[0, :, 0].astype(np.int32) - 1,
        dst=branch[0, :, 1].astype(np.int32) - 1,
        gen_idx=gen[0, :, 0].astype(np.int32) - 1,
    )
    key = (bus.shape[1], branch.shape[1], topo.src.tobytes(), topo.dst.tobytes(),
           topo.gen_idx.tobytes(), str(device))
    graph = _FUSED_CACHE.get(key)
    if graph is None:
        graph = build_graph(bus[:1], branch[:1], gen[:1], topo, device)
        _cache_put(_FUSED_CACHE, key, graph)
    return graph


def _fused_fn(steps, cfg: GNSConfig, method: str, graph, topo, slack_idx: int,
              bus, branch, gen, base, p_sched, q_sched, vm0, va0,
              has_status: bool, tol: float, max_iter: int, solver: str = "nr"):
    """One chunk's fused path (module docstring) on the chunk's device:
    returns (packed (S, 2N+4) solution, host syncs, predicted v, the
    prediction's angles in the slack-pinned gauge)."""
    buses, lines, gens = _prepare_stacked(bus, branch, gen, base, not cfg.true_shunts)
    out = gns_forward(steps, cfg, GridBatch(buses, lines, gens, None, None, None, None),
                      graph, dense=True, method=method)
    # decode into NR's slack-pinned gauge (harness.align_slack_angle, on
    # the device): the residual is shift-invariant, the slack angle is a
    # problem input that va0 already carries
    theta = (out.theta - out.theta[:, slack_idx:slack_idx + 1]
             + va0[:, slack_idx:slack_idx + 1])
    # seed only the free unknowns (cf. solve_batched warm_start): |v| at
    # PQ buses, angles at PV+PQ buses
    v = out.v.to(vm0.dtype)
    vm_w, va_w = vm0.clone(), va0.clone()
    vm_w[:, topo.pq] = v[:, topo.pq]
    va_w[:, topo.pvpq] = theta.to(va0.dtype)[:, topo.pvpq]
    if solver == "fdpf":
        packed, syncs = _fdpf_core(topo, bus, branch, base, p_sched, q_sched, vm_w, va_w,
                                   has_status, "XB", tol, max_iter)
    else:
        packed, syncs = _nr_core(topo, bus, branch, base, p_sched, q_sched, vm_w, va_w,
                                 has_status, tol, max_iter)
    return packed, syncs, v, theta


def _pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading axis to `target` rows by repeating the last row (a
    duplicate grid solves identically; the results are trimmed)."""
    s = arr.shape[0]
    if s == target:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], target - s, axis=0)])


def _hybrid_solve_fused(
    model: GNS, cfg: GNSConfig, cases: List[Dict], tol: float, max_iter: int,
    chunk_size: int, method: str = "auto", return_pred: bool = False,
    compact_after: int = 0, solver: str = "nr",
) -> Dict[str, np.ndarray]:
    device = next(model.parameters()).device
    with torch.no_grad():
        steps = step_params(model, cfg)
    s = len(cases)
    packs, its, syncs, pv, pth = [], [], 0, [], []
    # no compaction for the fast-decoupled tail: its iterations are two
    # matvecs, so the per-grid exit's extra round trip never pays
    k1 = compact_after if solver == "nr" and 0 < compact_after < max_iter else max_iter
    for lo in range(0, s, chunk_size):
        chunk = cases[lo:lo + chunk_size]
        k = len(chunk)
        bus, branch, gen, base = stack_cases(chunk)
        # the last chunk is padded to chunk_size, as gns_tpu does, so
        # every chunk has one shape
        target = chunk_size if (k < chunk_size and s > chunk_size) else k
        bus, branch, gen, base = (_pad_rows(a, target) for a in (bus, branch, gen, base))
        if branch.shape[1] < bus.shape[1]:
            raise ValueError(
                "fused hybrid requires E >= N (reference-parity gathers, "
                "SURVEY.md Q2): true for every shipped IEEE case"
            )
        ns = build_nr_small_stacked(bus, branch, gen, base)
        f = branch[0, :, 0].astype(np.int64) - 1
        t = branch[0, :, 1].astype(np.int64) - 1
        n = bus.shape[1]
        has_status = branch.shape[2] > 10
        slack_idx = int(np.flatnonzero(bus[0, :, 1].astype(int) == 3)[0])
        topo = _topology(f, t, n, ns.pvpq, ns.pq, device)
        graph = _forward_graph(bus, branch, gen, device)
        tensors = _on(device, bus, branch, gen, base, ns.p_sched, ns.q_sched, ns.vm0, ns.va0)
        with torch.no_grad():
            packed, chunk_syncs, v, theta = _fused_fn(
                steps, cfg, method, graph, topo, slack_idx, *tensors,
                has_status=has_status, tol=tol, max_iter=k1, solver=solver,
            )
        packed = packed.cpu().numpy()
        syncs += chunk_syncs + 1
        it_chunk = int(packed[0, 2 * n + 1])
        # stragglers continue in a compact power-of-2 sub-batch (no
        # forward needed, cf. solve_batched's compact_after)
        extra, extra_syncs = _compact_stragglers(
            packed, k1, max_iter, topo, bus, branch, base, ns.p_sched, ns.q_sched,
            has_status, tol, device,
        )
        packs.append(packed[:k])
        its.append(it_chunk + extra)
        syncs += extra_syncs
        if return_pred:
            pv.append(v[:k].cpu().numpy())
            pth.append(theta[:k].cpu().numpy())
            syncs += 2
    res = unpack_results(packs, its, tol, syncs)
    if return_pred:
        res["gns_v"] = np.concatenate(pv).astype(np.float32)
        res["gns_theta_deg"] = np.rad2deg(np.concatenate(pth)).astype(np.float32)
    return res


def hybrid_solve(
    model: GNS,
    cfg: GNSConfig,
    cases: List[Dict],
    tol: float = 3e-5,
    max_iter: int = 20,
    chunk_size: int = 256,
    predictor: Optional[GNSPredictor] = None,
    return_prediction: bool = False,
    fallback_flat: bool = True,
    fused: bool = True,
    compact_after=0,
    solver: str = "nr",
    mesh=None,
) -> Dict[str, np.ndarray]:
    """Solve `cases` exactly, warm-started by the GNS prediction of `model`
    (the GNS module; it runs, and the solve with it, on the module's
    device).

    Returns the solve_batched dict ({"v", "theta_deg", "converged",
    "iterations", "iterations_per_chunk", ...}); "iterations" counts the
    warm attempt only. When the flat-start fallback fires, its re-solve
    cost is reported separately as "fallback_iterations". With
    return_prediction=True it also carries the raw network guess under
    "gns_v" / "gns_theta_deg".

    fused=True (default): forward, gauge decode, warm seeding and the exact
    loop run as one device path per chunk (module docstring). Passing
    `predictor` (or fused=False) selects the two-step pipeline instead:
    GNSPredictor.predict, then solve_batched(warm_start=...).

    compact_after: per-grid convergence exit, forwarded to the Newton stage
    (nr_batched.solve_batched; "auto" resolves against the measured round
    trip via resolve_compact_after).

    solver: the exact tail after the warm seeding: "nr" (default; the
    batched full-Newton loop) or "fdpf" (the fast-decoupled loop of
    eval/fdpf.py; pass a larger max_iter, e.g. 60). Both gate on the true
    AC mismatch and reach the same fixed point; the flat-start fallback
    always uses full Newton.

    fallback_flat: Newton is only locally convergent, so a bad prediction
    can leave the basin of attraction on grids a flat start solves. Any
    grid the warm solve fails is re-solved from the flat start and spliced
    in, so the hybrid is never less robust than plain NR; "fallback_grids"
    reports how many needed it.

    mesh: not ported (only None).
    """
    check_no_mesh(mesh)
    if solver not in ("nr", "fdpf"):
        raise ValueError(f"solver must be nr|fdpf, got {solver!r}")
    device = next(model.parameters()).device
    f32_matmuls()
    compact_after = resolve_compact_after(compact_after, device=device)
    if fused and predictor is None:
        out = _hybrid_solve_fused(
            model, cfg, cases, tol, max_iter, chunk_size,
            return_pred=return_prediction, compact_after=compact_after, solver=solver,
        )
    else:
        if predictor is None:
            predictor = GNSPredictor(model, cfg, batch_size=max(len(cases), 1),
                                     align_slack=True, device=device)
        pred = predictor.predict(cases)
        solve = solve_batched_fdpf if solver == "fdpf" else solve_batched
        out = solve(cases, tol=tol, max_iter=max_iter, chunk_size=chunk_size,
                    warm_start=(pred["v"], pred["theta"]), device=device)
        if return_prediction:
            out["gns_v"] = pred["v"]
            out["gns_theta_deg"] = np.rad2deg(pred["theta"]).astype(np.float32)
    if fallback_flat and not out["converged"].all():
        bad = np.flatnonzero(~out["converged"])
        flat = solve_batched([cases[i] for i in bad], tol=tol, max_iter=max_iter,
                             chunk_size=chunk_size, device=device)
        splice_fallback(out, bad, flat)
    else:
        out["fallback_grids"] = 0
        out["fallback_iterations"] = 0
    return out


def splice_fallback(out: Dict, bad: np.ndarray, flat: Dict) -> None:
    """Splice the flat-start re-solve of the grids `bad` into `out`. Their
    per-grid sequential depth is the failed warm attempt plus the
    fallback's own count; the fallback is sequential work on top of the
    warm attempt, reported as "fallback_iterations"."""
    out["v"][bad] = flat["v"]
    out["theta_deg"][bad] = flat["theta_deg"]
    out["converged"][bad] = flat["converged"]
    out["mismatch"][bad] = flat["mismatch"]
    out["stalled"][bad] = flat["stalled"]
    out["iterations_per_grid"] = np.asarray(out["iterations_per_grid"]).copy()
    out["iterations_per_grid"][bad] += flat["iterations_per_grid"]
    out["fallback_iterations"] = flat["iterations"]
    out["fallback_grids"] = bad.size
    out["host_syncs"] = out.get("host_syncs", 0) + flat["host_syncs"]
