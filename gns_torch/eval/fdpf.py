"""Batched fast-decoupled AC power flow (Stott-Alsac) on the card (port of
gns_tpu/eval/fdpf.py).

Full Newton (eval/nr_batched.py) pays, every iteration, a dense (S, M, M)
Jacobian build and an O(M^3) batched LU factorization (M = #unknowns,
~2N). The fast-decoupled method (Stott & Alsac 1974; pypower's fdpf/makeB)
replaces the Jacobian blocks with two constant susceptance matrices:

  B'  - the P-theta half-step operator (network with line charging, bus
        shunts and off-nominal tap ratios removed; the XB scheme also
        drops series resistance),
  B'' - the Q-V half-step operator (network with phase shifters removed;
        the BX scheme drops series resistance here instead),

which depend only on the branch parameters, not on the iterate, so they are
factored once per solve (one batched inverse each), and every iteration
costs

  * two edge-list mismatch evaluations, O(S*E) elementwise: the branch
    ends' (vm, va) read by one K2 launch over [f; t], the per-branch flows
    summed at the buses by one K1 launch over the same index
    (`_make_injections`; gns_tpu contracts (N, E) incidence matrices on
    the TPU's matrix unit instead), and
  * two batched matvecs against the precomputed inverses, O(S*M^2), in
    full float32 (TF32 off).

Convergence is linear (geometric) instead of quadratic: more, much cheaper,
iterations. The fixed point is the Newton one: convergence is gated on the
true AC mismatch, and B'/B'' only shape the update direction, so this is an
exact solver with the same contract as `solve_batched`. Grids whose r/x
ratios break the decoupling assumption converge slowly or not at all; any
non-converged grid should be (and, via `eval.solve.solve_ac`, is) re-solved
with full Newton, so robustness is never worse than NR alone.

Everything is float32 real arithmetic. The f32 inverse of a stiff B' is
inexact, which only degrades the update direction (a slower geometric
rate), never the answer: the mismatch gate is computed from the raw branch
parameters.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gns_torch.eval.nr_batched import (
    _assemble_gb,
    _branch_parts,
    _on,
    _pack_solution,
    _seed_warm,
    _stall_cap,
    _topology,
    build_nr_small_stacked,
    lu_factor,
    f32_matmuls,
    stack_cases,
    unpack_results,
)
from gns_torch.ops.segment import SegmentIndex, gather, segment_sum
from gns_torch.parallel.solver_dp import all_converged, dp_group, gather_rows, shard_chunk
from gns_torch.utils.device import resolve_device


def _make_injections(parts, ends: SegmentIndex):
    """Closure computing bus P/Q injections from (vm, va) via the edge
    list: per-branch complex flows S_f = V_f (y_ff V_f + y_ft V_t)*,
    S_t = V_t (y_tf V_f + y_tt V_t)* expanded in real arithmetic, then
    summed at the buses. `ends` indexes the 2E branch ends [f; t] into the
    N buses: one K2 launch reads (vm, va) at every end, one K1 launch sums
    the (p, q) of every end at its bus. O(S*E) work, no dense (S, N, N)
    intermediate."""
    (yff_re, yff_im, yft_re, yft_im,
     ytf_re, ytf_im, ytt_re, ytt_im, gsh, bsh) = parts
    e = yff_re.shape[1]

    def injections(vm, va):
        at_ends = gather(torch.stack([vm, va], dim=-1), ends)  # (S, 2E, 2)
        vf, vt = at_ends[:, :e, 0], at_ends[:, e:, 0]
        dva = at_ends[:, :e, 1] - at_ends[:, e:, 1]
        c, s = torch.cos(dva), torch.sin(dva)
        vf2, vt2, vfvt = vf * vf, vt * vt, vf * vt
        # from-side: V_f V_t* = vfvt e^{+j dva}; conj(yft) = g - jb
        pf = vf2 * yff_re + vfvt * (yft_re * c + yft_im * s)
        qf = -vf2 * yff_im + vfvt * (yft_re * s - yft_im * c)
        # to-side: V_t V_f* = vfvt e^{-j dva}
        pt = vt2 * ytt_re + vfvt * (ytf_re * c - ytf_im * s)
        qt = -vt2 * ytt_im - vfvt * (ytf_re * s + ytf_im * c)
        flows = torch.stack([torch.cat([pf, pt], dim=1), torch.cat([qf, qt], dim=1)], dim=-1)
        at_bus = segment_sum(flows, ends)  # (S, N, 2)
        vm2 = vm * vm
        p = at_bus[..., 0] + vm2 * gsh
        q = at_bus[..., 1] - vm2 * bsh
        return p, q

    return injections


def _batched_inverse(mat):
    """Explicit batched inverse: LU (lu_factor_ex, no error check) and a
    solve against the identity. The inverse is applied as one batched
    matvec per half-iteration, cheaper than repeated triangular solves."""
    s, m = mat.shape[0], mat.shape[1]
    lu, piv = lu_factor(mat)
    eye = torch.eye(m, dtype=mat.dtype, device=mat.device).expand(s, m, m)
    return torch.linalg.lu_solve(lu, piv, eye)


def _build_b_matrices(bus, branch, base, pattern, has_status: bool, alg: str):
    """B' and B'' per pypower/MATPOWER makeB semantics, assembled on the
    device by `_assemble_gb` on modified branch/bus stacks (one K1 launch
    each):

      B'  = -Im Ybus(charging=0, tap ratio=1, bus shunts=0
                     [, r=0 if XB]; phase shift kept)
      B'' = -Im Ybus(phase shift=0 [, r=0 if BX]; shunts/taps kept)
    """
    bp_branch = branch.clone()
    bp_branch[:, :, 4] = 0.0
    bp_branch[:, :, 8] = 1.0
    if alg == "XB":
        bp_branch[:, :, 2] = 0.0
    bp_bus = bus.clone()
    bp_bus[:, :, 5] = 0.0
    _, bp_bmat = _assemble_gb(bp_bus, bp_branch, base, pattern, has_status)

    bpp_branch = branch.clone()
    bpp_branch[:, :, 9] = 0.0
    if alg == "BX":
        bpp_branch[:, :, 2] = 0.0
    _, bpp_bmat = _assemble_gb(bus, bpp_branch, base, pattern, has_status)
    return -bp_bmat, -bpp_bmat


def _fdpf_solve(injections, bp_inv, bpp_inv, p_sched, q_sched, vm0, va0,
                pvpq, pq, tol: float, max_iter: int, group=None):
    """The fast-decoupled loop: alternating P-theta / Q-V half-steps with
    per-grid freezing and the same stalled-at-floor acceptance contract as
    `_nr_solve` (a stricter 0.95 progress factor: fast-decoupled
    convergence is geometric, so "still shrinking" looks different from
    Newton's quadratic drops). Returns (vm, va, conv, iters,
    iters_per_grid, mismatch, host_syncs). group: as `_nr_solve`'s (the
    exit test all-reduced over a sharded chunk's dp group)."""
    stall_cap = _stall_cap(tol)

    def f_of(p, q):
        return torch.cat([(p - p_sched)[:, pvpq], (q - q_sched)[:, pq]], dim=1)

    vm, va = vm0.clone(), va0.clone()
    p, q = injections(vm, va)
    fmax = torch.amax(torch.abs(f_of(p, q)), dim=1)
    conv = fmax < tol
    itg = torch.zeros(vm.shape[0], dtype=torch.int32, device=vm.device)
    it, syncs = 0, 0
    while it < max_iter:
        syncs += 1
        if all_converged(conv, group):
            break
        frozen = conv[:, None]
        # P half-step: B' dtheta = dP / Vm  (pypower fdpf conventions)
        fp = (p - p_sched)[:, pvpq] / vm[:, pvpq]
        dva = torch.bmm(bp_inv, fp[:, :, None])[..., 0]
        va[:, pvpq] = va[:, pvpq] - torch.where(frozen, torch.zeros_like(dva), dva)
        p, q = injections(vm, va)
        # Q half-step: B'' dVm = dQ / Vm
        fq = (q - q_sched)[:, pq] / vm[:, pq]
        dvm = torch.bmm(bpp_inv, fq[:, :, None])[..., 0]
        vm[:, pq] = vm[:, pq] - torch.where(frozen, torch.zeros_like(dvm), dvm)
        p, q = injections(vm, va)

        fnew = torch.amax(torch.abs(f_of(p, q)), dim=1)
        now = (fnew < tol) | ((fnew < stall_cap) & (fnew > 0.95 * fmax))
        itg = torch.where(now & ~conv, torch.full_like(itg, it + 1), itg)
        conv = conv | now
        fmax = fnew
        it += 1
    itg = torch.where(conv, itg, torch.full_like(itg, it))
    return vm, va, conv, it, itg, fmax, syncs


def _fdpf_core(topo, bus, branch, base, p_sched, q_sched, vm0, va0,
               has_status: bool, alg: str, tol: float, max_iter: int, group=None):
    """B'/B'' assembly, the one-time batched inverses, the fast-decoupled
    loop and the packed output of one chunk on its device. Returns (packed
    (S, 2N+4) tensor, host syncs)."""
    pvpq, pq = topo.pvpq, topo.pq
    bp, bpp = _build_b_matrices(bus, branch, base, topo.pattern, has_status, alg)
    bp_inv = _batched_inverse(bp[:, pvpq][:, :, pvpq])
    bpp_inv = _batched_inverse(bpp[:, pq][:, :, pq])
    parts = _branch_parts(bus, branch, base, has_status)
    injections = _make_injections(parts, topo.ends)
    vm, va, conv, it, itg, fmax, syncs = _fdpf_solve(
        injections, bp_inv, bpp_inv, p_sched, q_sched, vm0, va0, pvpq, pq, tol, max_iter,
        group,
    )
    return _pack_solution(vm, va, conv, it, itg, fmax), syncs


def calc_injections(cases: List[Dict], device="cuda"):
    """Bus P/Q injections (p.u.) at each case's stored voltage profile,
    via the edge-list evaluation: the test hook that pins the edge-list
    formulation against the dense trig-kernel path."""
    dev = resolve_device(device)
    bus, branch, gen, base = stack_cases(cases)
    f = branch[0, :, 0].astype(np.int64) - 1
    t = branch[0, :, 1].astype(np.int64) - 1
    has_status = branch.shape[2] > 10
    ends = SegmentIndex(np.concatenate([f, t]), bus.shape[1], dev)
    busj, branchj, basej = _on(dev, bus, branch, base)
    inj = _make_injections(_branch_parts(busj, branchj, basej, has_status), ends)
    vm = busj[:, :, 7]
    va = torch.deg2rad(busj[:, :, 8])
    p, q = inj(vm, va)
    return p.cpu().numpy(), q.cpu().numpy()


def solve_batched_fdpf(
    cases: List[Dict],
    tol: float = 3e-5,
    max_iter: int = 60,
    chunk_size: int = 256,
    warm_start=None,
    alg: str = "XB",
    mesh=None,
    device="cuda",
) -> Dict:
    """Fast-decoupled twin of `nr_batched.solve_batched`: same inputs, same
    result schema ({"v", "theta_deg", "converged", "iterations",
    "iterations_per_grid", "mismatch", "stalled", "host_syncs", ...}), same
    warm-start seeding (PQ magnitudes + PV/PQ angles only), same chunking
    and one packed fetch per chunk.

    max_iter counts P/Q half-step PAIRS and defaults higher than Newton's
    (60 vs 20): convergence is geometric, so the solver takes more, far
    cheaper, iterations. There is no compact_after: an iteration costs two
    matvecs and four small kernel launches, so a per-grid exit's extra
    round trip cannot pay.

    alg: "XB" (default; series resistance dropped from B') or "BX" (dropped
    from B'' instead), the two classical Stott-Alsac variants; both gate on
    the true mismatch and give the same fixed point.

    Non-converged grids keep their last iterate, flagged False: on grids
    whose r/x ratios defeat the decoupling, re-solve with full Newton
    (`solve_ac(..., method="auto")` does exactly that).

    mesh: a DeviceMesh with a "dp" axis: each chunk sharded over it as in
    nr_batched.solve_batched. device: "cuda" (default) or "cpu"; under a
    mesh, this rank's device.
    """
    if alg not in ("XB", "BX"):
        raise ValueError(f"alg must be XB|BX, got {alg!r}")
    dev = resolve_device(device)
    f32_matmuls()
    group = dp_group(mesh)
    packs, its, syncs = [], [], 0
    for lo in range(0, len(cases), chunk_size):
        bus, branch, gen, base = stack_cases(cases[lo:lo + chunk_size])
        ns = build_nr_small_stacked(bus, branch, gen, base)
        vm0, va0 = _seed_warm(ns, warm_start, lo, lo + chunk_size)
        f = branch[0, :, 0].astype(np.int64) - 1
        t = branch[0, :, 1].astype(np.int64) - 1
        has_status = branch.shape[2] > 10
        topo = _topology(f, t, bus.shape[1], ns.pvpq, ns.pq, dev)
        k = bus.shape[0]
        local = shard_chunk(mesh, (bus, branch, base, ns.p_sched, ns.q_sched, vm0, va0), k)
        packed, chunk_syncs = _fdpf_core(topo, *_on(dev, *local), has_status, alg, tol,
                                         max_iter, group)
        packed = gather_rows(mesh, packed, k).cpu().numpy()
        packs.append(packed)
        its.append(int(packed[0, 2 * bus.shape[1] + 1]))
        syncs += chunk_syncs + 1
    out = unpack_results(packs, its, tol, syncs)
    out["method"] = "fdpf"
    return out
