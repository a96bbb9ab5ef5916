"""Batched Newton-Raphson AC power flow on the card (port of
gns_tpu/eval/nr_batched.py).

The reference's oracle solves grids one at a time with pypower's runpf
(reference GNS/evaluate.py:25-40). Augmented grids of one case share their
topology (bus types, branch endpoints: the augmentation perturbs only
electrical parameters, GNS/augment_grids.py:28-54), so a whole set is
solved as one batch: dense per-grid G/B admittance matrices, the polar
Jacobian in its real H/N/J/L block form, and a batched LU solve.

The dense admittance matrices are assembled on the device from the raw
float32 case stacks (`_assemble_gb`). Each matrix entry is the sum of the
branch and shunt terms that land on it (4E + N terms into N*N slots,
parallel branches landing on the same slot): the slots a topology hits are
found once on the host (`admittance_pattern`), the terms are summed per
slot by K1 (ops/segment.py segment_sum, in a fixed order, so G/B are the
same bits from run to run) and written with one store whose indices are
all distinct. All outputs of a chunk come back in one packed array, one
copy to the host.

Everything is real float32, as in gns_tpu (the float64 oracle stays
eval/newton_raphson.py); the polar power-flow Jacobian has real closed
forms (the identities pypower's dSbus_dV expands to):

  P_m = V_m sum_k V_k (G_mk cos th_mk + B_mk sin th_mk)
  Q_m = V_m sum_k V_k (G_mk sin th_mk - B_mk cos th_mk)
  H = dP/dth: off-diag  V_m V_k (G sin - B cos);  diag -Q_m - B_mm V_m^2
  N = dP/dV:  off-diag  V_m (G cos + B sin);      diag  P_m/V_m + G_mm V_m
  J = dQ/dth: off-diag -V_m V_k (G cos + B sin);  diag  P_m - G_mm V_m^2
  L = dQ/dV:  off-diag  V_m (G sin - B cos);      diag  Q_m/V_m - B_mm V_m

The products against G/B run in full float32: the public entry points turn
TF32 off for matmuls (torch.backends.cuda.matmul.allow_tf32 = False,
process-wide, as GNSPredictor does). Each Newton step factors the batch's
Jacobians with torch.linalg.lu_factor_ex (`lu_factor`), which, unlike
lu_factor, neither raises on a singular member nor waits for the device to
check: a singular Jacobian (an islanded or diverging grid) yields
non-finite steps for that grid alone, which then stays non-converged, as
jax.lax.linalg.lu leaves it in gns_tpu.

Numerics: float32's attainable mismatch floor is ~1e-5 p.u. (the scipy
float64 oracle's is 1e-8), 2-3 orders below the GNS model errors this
oracle measures. For parity-grade ground truth keep eval/newton_raphson.py.

gns_tpu's jax.lax.while_loop is a Python loop here: its exit test (every
grid converged?) reads one boolean from the device per iteration, a host
sync. Results carry "host_syncs", the count of those reads and of the
packed fetches.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from gns_torch.ops.segment import SegmentIndex, segment_sum
from gns_torch.utils.device import resolve_device

def check_no_mesh(mesh) -> None:
    """The solvers take gns_tpu's `mesh=` argument, and only None."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: gns_torch's solvers run on one device; the "
            "parallel layer (parallel/solver_dp.py) is ROADMAP §1 item 6"
        )


def lu_factor(mat):
    """(LU, pivots) of a batch of matrices by torch.linalg.lu_factor_ex,
    with no error check: a singular member is factored to the end (a zero
    pivot), not raised on, and on the card nothing waits for the device.
    On a CPU tensor the matrices are factored one at a time: the CPU
    build's batched LU (MKL) has been seen to stop in a loop, after "Intel
    oneMKL ERROR: Parameter 6 was incorrect on entry to SLASWP", when it
    factors a batch with more than one thread (torch 2.13 on the CPU)."""
    if mat.is_cuda:
        lu, piv, _ = torch.linalg.lu_factor_ex(mat)
        return lu, piv
    parts = [torch.linalg.lu_factor_ex(m) for m in mat]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def f32_matmuls() -> None:
    """float32 means float32: TF32 off for matmuls and cuDNN (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class NRBatch(NamedTuple):
    """Host-prepared batched NR problem (one shared-topology case set)."""

    gmat: np.ndarray  # (S, N, N) float32 dense conductance matrix
    bmat: np.ndarray  # (S, N, N) float32 dense susceptance matrix
    p_sched: np.ndarray  # (S, N) float32 scheduled net active injection, p.u.
    q_sched: np.ndarray  # (S, N) float32 scheduled net reactive injection
    vm0: np.ndarray  # (S, N) float32 initial |v| (gen buses at vg)
    va0: np.ndarray  # (S, N) float32 initial angle, radians
    pvpq: np.ndarray  # (M1,) int32 PV+PQ bus indices (shared across batch)
    pq: np.ndarray  # (M2,) int32 PQ bus indices


def stack_cases(cases: List[Dict]):
    """Stack shared-topology case dicts into (bus, branch, gen, base) arrays.

    One pass over the Python dicts; everything downstream is vectorized
    over these stacks. Validates the shared-topology contract (identical
    bus types, branch endpoints, consecutive 1..N numbering).
    """
    bus0 = np.asarray(cases[0]["bus"], np.float64)
    br0 = np.asarray(cases[0]["branch"], np.float64)
    gen0 = np.asarray(cases[0]["gen"], np.float64)
    n, e, ng = bus0.shape[0], br0.shape[0], gen0.shape[0]
    if not np.array_equal(bus0[:, 0].astype(int), np.arange(1, n + 1)):
        raise ValueError("batched NR requires consecutive 1..N bus ids")
    s = len(cases)

    bus = np.empty((s, n, bus0.shape[1]), np.float64)
    branch = np.empty((s, e, br0.shape[1]), np.float64)
    gen = np.empty((s, ng, gen0.shape[1]), np.float64)
    base = np.empty((s,), np.float64)
    for i, case in enumerate(cases):
        bus[i] = np.asarray(case["bus"], np.float64)
        branch[i] = np.asarray(case["branch"], np.float64)
        gen[i] = np.asarray(case["gen"], np.float64)
        base[i] = case["baseMVA"]

    types = bus0[:, 1].astype(int)
    if not (bus[:, :, 1].astype(int) == types).all():
        raise ValueError("batched NR requires identical bus types")
    f = br0[:, 0].astype(np.int64) - 1
    t = br0[:, 1].astype(np.int64) - 1
    if not (
        (branch[:, :, 0].astype(np.int64) - 1 == f).all()
        and (branch[:, :, 1].astype(np.int64) - 1 == t).all()
    ):
        raise ValueError("batched NR requires identical branch endpoints")
    return bus, branch, gen, base


def build_nr_batch(cases: List[Dict]) -> NRBatch:
    """Pack pypower-style case dicts into one batched problem, with the
    dense Ybus assembled on the host in complex128 (the reference the
    device assembly is tested against). All cases must share bus types,
    branch endpoints and consecutive 1..N bus numbering."""
    return build_nr_batch_stacked(*stack_cases(cases))


def build_nr_batch_stacked(bus, branch, gen, base) -> NRBatch:
    """Vectorized NR assembly from stack_cases output (no Python loop)."""
    s, n = bus.shape[:2]
    e, ng = branch.shape[1], gen.shape[1]
    br0, gen0 = branch[0], gen[0]
    types = bus[0, :, 1].astype(int)
    pv = np.flatnonzero(types == 2)
    pq = np.flatnonzero(types == 1)
    pvpq = np.concatenate([pv, pq]).astype(np.int32)
    f = br0[:, 0].astype(np.int64) - 1
    t = br0[:, 1].astype(np.int64) - 1

    # vectorized Ybus (MATPOWER conventions, cf. newton_raphson.make_ybus)
    status = branch[:, :, 10] if br0.shape[1] > 10 else np.ones((s, e))
    ys = status / (branch[:, :, 2] + 1j * branch[:, :, 3])
    bc = status * branch[:, :, 4]
    tap = np.where(branch[:, :, 8] == 0, 1.0, branch[:, :, 8]) * np.exp(
        1j * np.deg2rad(branch[:, :, 9])
    )
    ytt = ys + 1j * bc / 2.0
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap
    ysh = (bus[:, :, 4] + 1j * bus[:, :, 5]) / base[:, None]

    ybus = np.zeros((s, n, n), np.complex128)
    flat = ybus.reshape(s, n * n)
    np.add.at(flat, (slice(None), f * n + t), yft)
    np.add.at(flat, (slice(None), t * n + f), ytf)
    np.add.at(flat, (slice(None), f * n + f), yff)
    np.add.at(flat, (slice(None), t * n + t), ytt)
    flat[:, np.arange(n) * n + np.arange(n)] += ysh

    small = build_nr_small_stacked(bus, branch, gen, base)
    return NRBatch(
        ybus.real.astype(np.float32), ybus.imag.astype(np.float32),
        small.p_sched, small.q_sched, small.vm0, small.va0, pvpq, pq.astype(np.int32),
    )


class NRSmall(NamedTuple):
    """The NR inputs other than the dense G/B matrices, which are assembled
    on the device (`_assemble_gb`) from the raw branch/bus stacks."""

    p_sched: np.ndarray  # (S, N) float32
    q_sched: np.ndarray  # (S, N)
    vm0: np.ndarray  # (S, N)
    va0: np.ndarray  # (S, N)
    pvpq: np.ndarray  # (M1,) int32
    pq: np.ndarray  # (M2,) int32


def build_nr_small_stacked(bus, branch, gen, base) -> NRSmall:
    """Scheduled injections, initial voltage, bus-type index sets: the
    host-side part of the batched problem (vectorized, no Ybus)."""
    s, n = bus.shape[:2]
    ng = gen.shape[1]
    gen0 = gen[0]
    types = bus[0, :, 1].astype(int)
    pv = np.flatnonzero(types == 2)
    pq = np.flatnonzero(types == 1)
    pvpq = np.concatenate([pv, pq]).astype(np.int32)

    gbus = gen0[:, 0].astype(np.int64) - 1
    if not (gen[:, :, 0].astype(np.int64) - 1 == gbus).all():
        raise ValueError("batched NR requires identical generator buses")
    gstat = gen[:, :, 7] if gen0.shape[1] > 7 else np.ones((s, ng))
    pg = np.zeros((s, n))
    qg = np.zeros((s, n))
    np.add.at(pg, (slice(None), gbus), gen[:, :, 1] * gstat)
    np.add.at(qg, (slice(None), gbus), gen[:, :, 2] * gstat)
    p_sched = (pg - bus[:, :, 2]) / base[:, None]
    q_sched = (qg - bus[:, :, 3]) / base[:, None]

    # in-service generator set-points win (runpf semantics)
    vm0 = bus[:, :, 7].copy()
    rows = np.repeat(np.arange(s), ng)
    cols = np.tile(gbus, s)
    on = (gstat > 0).ravel()
    vm0[rows[on], cols[on]] = (gen[:, :, 5]).ravel()[on]
    va0 = np.deg2rad(bus[:, :, 8])
    return NRSmall(
        p_sched.astype(np.float32), q_sched.astype(np.float32),
        vm0.astype(np.float32), va0.astype(np.float32),
        pvpq, pq.astype(np.int32),
    )


class AdmittancePattern(NamedTuple):
    """Where one topology's admittance terms land in the dense (N, N)
    matrix: the distinct flat slots (row * N + col) and, for each of the
    4E + N terms in `_assemble_gb`'s order (ft, tf, ff, tt per branch, then
    the N bus shunts), its slot as a segment id."""

    slots: torch.Tensor  # (U,) int64 distinct flat slots, ascending
    index: SegmentIndex  # 4E + N term ids into U segments
    n: int


def admittance_pattern(f, t, n: int, device) -> AdmittancePattern:
    """Built once per topology on the host (np.unique), then moved to
    `device`. Terms that land on one slot are summed in the order above
    (K1 keeps edge order within a segment)."""
    f = np.asarray(f, np.int64)
    t = np.asarray(t, np.int64)
    diag = np.arange(n, dtype=np.int64) * (n + 1)
    slot = np.concatenate([f * n + t, t * n + f, f * n + f, t * n + t, diag])
    uniq, inv = np.unique(slot, return_inverse=True)
    return AdmittancePattern(
        torch.as_tensor(uniq, device=device), SegmentIndex(inv, len(uniq), device), n
    )


def _branch_parts(bus, branch, base, has_status: bool):
    """Per-branch admittance components (MATPOWER conventions) as (S, E)
    tensors, yff/yft/ytf/ytt real and imaginary, plus the (S, N) bus shunt
    conductance and susceptance: branch series admittance ys =
    status/(r+jx), charging b, complex tap tau*e^{j shift}. The dense
    assembly (`_assemble_gb`) and the fast-decoupled edge-list mismatch
    (eval/fdpf.py) both start from these."""
    r, x, bc0 = branch[:, :, 2], branch[:, :, 3], branch[:, :, 4]
    status = branch[:, :, 10] if has_status else torch.ones_like(r)
    denom = r * r + x * x
    ys_re = status * r / denom
    ys_im = -status * x / denom
    bc = status * bc0
    tau = torch.where(branch[:, :, 8] == 0, torch.ones_like(r), branch[:, :, 8])
    shift = torch.deg2rad(branch[:, :, 9])
    ct, st = torch.cos(shift), torch.sin(shift)
    tau2 = tau * tau

    ytt_re, ytt_im = ys_re, ys_im + bc / 2.0
    yff_re, yff_im = ytt_re / tau2, ytt_im / tau2
    # yft = -ys / conj(tap) = -ys * e^{j shift} / tau
    yft_re = -(ys_re * ct - ys_im * st) / tau
    yft_im = -(ys_re * st + ys_im * ct) / tau
    # ytf = -ys / tap = -ys * e^{-j shift} / tau
    ytf_re = -(ys_re * ct + ys_im * st) / tau
    ytf_im = -(ys_im * ct - ys_re * st) / tau

    gsh = bus[:, :, 4] / base[:, None]
    bsh = bus[:, :, 5] / base[:, None]
    return (yff_re, yff_im, yft_re, yft_im,
            ytf_re, ytf_im, ytt_re, ytt_im, gsh, bsh)


def _assemble_gb(bus, branch, base, pattern: AdmittancePattern, has_status: bool):
    """Dense G/B admittance assembly on the device: the real-arithmetic
    twin of the host complex path in `build_nr_batch_stacked`. bus / branch
    / base are the raw float32 case stacks. The terms of each slot are
    summed by one K1 launch over (S, 4E + N, 2) (G and B side by side),
    then stored into zeroed (S, N, N) matrices at distinct slots."""
    (yff_re, yff_im, yft_re, yft_im,
     ytf_re, ytf_im, ytt_re, ytt_im, gsh, bsh) = _branch_parts(bus, branch, base, has_status)
    s, n = bus.shape[0], pattern.n
    terms = torch.stack(
        [torch.cat([yft_re, ytf_re, yff_re, ytt_re, gsh], dim=1),
         torch.cat([yft_im, ytf_im, yff_im, ytt_im, bsh], dim=1)],
        dim=-1,
    )
    sums = segment_sum(terms, pattern.index)  # (S, U, 2)
    gb = bus.new_zeros((s, 2, n * n))
    gb.index_copy_(2, pattern.slots, sums.transpose(1, 2))
    return gb[:, 0].view(s, n, n), gb[:, 1].view(s, n, n)


class _Topology(NamedTuple):
    """A topology's index sets on one device, built once and cached."""

    pattern: AdmittancePattern  # the dense G/B assembly
    ends: SegmentIndex  # the 2E branch ends [f; t] into N buses (eval/fdpf.py)
    pvpq: torch.Tensor  # (M1,) int64
    pq: torch.Tensor  # (M2,) int64


# Index sets per (topology, device), module-level so every solve reuses
# them. Bounded: a long-lived server over a varied solve_mixed stream
# would otherwise keep one entry per topology it has seen; past the cap
# the oldest entry goes (dicts keep insertion order).
_CORE_CACHE: Dict[tuple, object] = {}
_CACHE_CAP = 64
# Inserts are serialized: the eviction loop iterates while popping.
_CACHE_LOCK = threading.Lock()


def _cache_put(cache: Dict[tuple, object], key: tuple, value) -> None:
    """Insert with oldest-entry eviction past _CACHE_CAP (thread-safe)."""
    with _CACHE_LOCK:
        while len(cache) >= _CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = value


def _topology(f: np.ndarray, t: np.ndarray, n: int, pvpq: np.ndarray, pq: np.ndarray,
              device: torch.device) -> _Topology:
    key = (f.tobytes(), t.tobytes(), n, pvpq.tobytes(), pq.tobytes(), str(device))
    topo = _CORE_CACHE.get(key)
    if topo is None:
        topo = _Topology(
            admittance_pattern(f, t, n, device),
            SegmentIndex(np.concatenate([f, t]), n, device),
            torch.as_tensor(pvpq.astype(np.int64), device=device),
            torch.as_tensor(pq.astype(np.int64), device=device),
        )
        _cache_put(_CORE_CACHE, key, topo)
    return topo


def _pack_solution(vm, va, conv, it: int, itg, fmax):
    """[vm | va | conv | iters | iters_per_grid | mismatch] -> (S, 2N+4)
    float32: one packed array, one copy to the host."""
    s = vm.shape[0]
    return torch.cat(
        [vm, va, conv[:, None].to(vm.dtype), vm.new_full((s, 1), float(it)),
         itg[:, None].to(vm.dtype), fmax[:, None].to(vm.dtype)],
        dim=1,
    )


# Stalled-at-floor acceptance cap: a grid whose mismatch is below
# min(_STALL_TOL, 10*tol) (0.03 MW on a 100 MVA base at the default tol,
# 2-3 orders under GNS model error) and no longer making Newton progress
# is accepted as converged at its float32-attainable iterate. Scaling with
# tol keeps the contract honest for strict callers: at tol=1e-6 the cap is
# 1e-5, so a grid stalled at 3e-4 is reported non-converged. Stall-accepted
# grids (converged with final mismatch >= tol) are marked by the "stalled"
# mask of the results.
_STALL_TOL = 3e-4


def _stall_cap(tol: float) -> float:
    """min(_STALL_TOL, 10 * tol), in float32 as gns_tpu computes it."""
    return float(min(np.float32(_STALL_TOL), np.float32(10.0) * np.float32(tol)))


def _trig_terms(gmat, bmat, vm, va):
    """A1 = G cos + B sin and A2 = G sin - B cos of every (m, k), the
    kernels of every formula in the module docstring, and the injections
    P, Q at (vm, va). cos/sin(th_m - th_k) as rank-1 combinations."""
    c, s = torch.cos(va), torch.sin(va)
    cosmk = c[:, :, None] * c[:, None, :] + s[:, :, None] * s[:, None, :]
    sinmk = s[:, :, None] * c[:, None, :] - c[:, :, None] * s[:, None, :]
    a1 = gmat * cosmk + bmat * sinmk
    a2 = gmat * sinmk - bmat * cosmk
    p = vm * torch.bmm(a1, vm[:, :, None])[..., 0]
    q = vm * torch.bmm(a2, vm[:, :, None])[..., 0]
    return a1, a2, p, q


def _jacobian(gmat, bmat, vm, a1, a2, p, q, pvpq, pq):
    """The (S, M, M) polar Jacobian [[H, N], [J, L]] over the unknowns
    (angles at PV+PQ buses, magnitudes at PQ buses) from `_trig_terms`."""
    n = vm.shape[1]
    eye = torch.eye(n, dtype=vm.dtype, device=vm.device)
    g_diag = torch.diagonal(gmat, dim1=1, dim2=2)
    b_diag = torch.diagonal(bmat, dim1=1, dim2=2)

    def with_diag(mat, d):
        # off-diagonal of `mat`, closed-form diagonal `d`
        return mat * (1.0 - eye) + eye * d[:, :, None]

    vv = vm[:, :, None] * vm[:, None, :]
    vm_safe = torch.clamp_min(vm, 1e-12)
    h = with_diag(vv * a2, -q - b_diag * vm * vm)
    nmat = with_diag(vm[:, :, None] * a1, p / vm_safe + g_diag * vm)
    jmat = with_diag(-vv * a1, p - g_diag * vm * vm)
    lmat = with_diag(vm[:, :, None] * a2, q / vm_safe - b_diag * vm)
    return torch.cat(
        [
            torch.cat([h[:, pvpq][:, :, pvpq], nmat[:, pvpq][:, :, pq]], dim=2),
            torch.cat([jmat[:, pq][:, :, pvpq], lmat[:, pq][:, :, pq]], dim=2),
        ],
        dim=1,
    )


def _nr_solve(gmat, bmat, p_sched, q_sched, vm0, va0, pvpq, pq,
              tol: float = 3e-5, max_iter: int = 20):
    """Batched full-Newton polar power flow, real arithmetic + LU solve.

    Returns (vm, va, conv, iters, iters_per_grid, mismatch, host_syncs):
    iters_per_grid is the iteration at which each grid first met the gate
    (== iters for stragglers); mismatch is each grid's final max |f|
    (p.u.), which separates tol-converged grids from stall-accepted ones;
    host_syncs counts the loop's exit tests read from the device."""
    n_pvpq = pvpq.shape[0]
    stall_cap = _stall_cap(tol)

    def trig_terms(vm, va):
        return _trig_terms(gmat, bmat, vm, va)

    def f_of(p, q):
        return torch.cat([(p - p_sched)[:, pvpq], (q - q_sched)[:, pq]], dim=1)

    vm, va = vm0.clone(), va0.clone()
    # the iterate's trig terms carry over from one iteration's gate to the
    # next one's Jacobian (the same values gns_tpu's loop body recomputes)
    a1, a2, p, q = trig_terms(vm, va)
    # seed the progress tracker with the INITIAL mismatch so (a) the first
    # stall test compares against it and (b) a batch that converges before
    # the loop runs still reports a real final mismatch
    fmax = torch.amax(torch.abs(f_of(p, q)), dim=1)
    conv = fmax < tol
    itg = torch.zeros(vm.shape[0], dtype=torch.int32, device=vm.device)
    it, syncs = 0, 0
    while it < max_iter:
        syncs += 1
        if bool(conv.all()):
            break
        f = f_of(p, q)
        jac = _jacobian(gmat, bmat, vm, a1, a2, p, q, pvpq, pq)
        # batched LU, no error check: a singular member yields a
        # non-finite step for that grid alone (module docstring)
        lu, piv = lu_factor(jac)
        dx = torch.linalg.lu_solve(lu, piv, f[:, :, None])[..., 0]

        # frozen grids (already converged) stop moving
        upd = torch.where(conv[:, None], torch.zeros_like(dx), dx)
        va[:, pvpq] = va[:, pvpq] - upd[:, :n_pvpq]
        vm[:, pq] = vm[:, pq] - upd[:, n_pvpq:]

        a1, a2, p, q = trig_terms(vm, va)
        fnew = torch.amax(torch.abs(f_of(p, q)), dim=1)
        # Convergence gate: below tol, OR stalled at the float32 mismatch
        # floor. The floor scales with the largest |V_m V_k Y_mk| products
        # being cancelled: the authentic IEEE case118's stiff 345 kV
        # branches (x down to 0.00405 -> |y| ~ 250 p.u.) put it at ~2.5e-5,
        # above a 3e-5 tol for some draws. A grid whose mismatch is small
        # (< min(_STALL_TOL, 10*tol)) and no longer making Newton progress
        # (not shrinking by 30% an iteration; in the quadratic regime it
        # shrinks by orders of magnitude) has reached its f32-attainable
        # iterate; more lock-step iterations only gate the rest.
        now = (fnew < tol) | ((fnew < stall_cap) & (fnew > 0.7 * fmax))
        itg = torch.where(now & ~conv, torch.full_like(itg, it + 1), itg)
        conv = conv | now
        fmax = fnew
        it += 1
    # stragglers that never met the gate carry the full iteration count
    itg = torch.where(conv, itg, torch.full_like(itg, it))
    return vm, va, conv, it, itg, fmax, syncs


def _nr_core(topo: _Topology, bus, branch, base, p_sched, q_sched, vm0, va0,
             has_status: bool, tol: float, max_iter: int):
    """Assembly + the Newton loop + the packed output of one chunk, all on
    the chunk's device. Returns (packed (S, 2N+4) tensor, host syncs)."""
    gmat, bmat = _assemble_gb(bus, branch, base, topo.pattern, has_status)
    vm, va, conv, it, itg, fmax, syncs = _nr_solve(
        gmat, bmat, p_sched, q_sched, vm0, va0, topo.pvpq, topo.pq,
        tol=tol, max_iter=max_iter,
    )
    return _pack_solution(vm, va, conv, it, itg, fmax), syncs


def _on(device, *arrays):
    """numpy arrays -> float32 tensors on `device`."""
    return [torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrays]


# --- dispatch round-trip measurement & compact_after="auto" resolution.
# The per-grid convergence exit (compact_after) costs one extra fetch and
# launch round trip per chunk; whether that pays depends on the
# deployment's round trip. "auto" measures it once per device and picks
# the side of the break-even the caller is on.
_RTT_CACHE: Dict[str, float] = {}
_COMPACT_RTT_BREAKEVEN = 5e-3  # seconds


def measured_dispatch_rtt(device="cuda") -> float:
    """Min-of-3 wall time of one tiny launch plus the read of its value on
    the host (.item()), the cost every extra device round trip pays here;
    cached per device."""
    dev = resolve_device(device)
    key = str(dev)
    rtt = _RTT_CACHE.get(key)
    if rtt is not None:
        return rtt
    x = torch.zeros(8, dtype=torch.float32, device=dev)
    (x + 1.0)[0].item()  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        (x + 1.0)[0].item()
        best = min(best, time.perf_counter() - t0)
    _RTT_CACHE[key] = best
    return best


def resolve_compact_after(compact_after, rtt_breakeven: float = None, device="cuda") -> int:
    """Resolve compact_after="auto" against the measured round trip:
    lock-step (0) when a round trip costs more than `rtt_breakeven`
    (default _COMPACT_RTT_BREAKEVEN = 5 ms), the per-grid exit (3) when
    round trips are cheap. Integers pass through unchanged."""
    if compact_after != "auto":
        return int(compact_after)
    cap = _COMPACT_RTT_BREAKEVEN if rtt_breakeven is None else rtt_breakeven
    return 0 if measured_dispatch_rtt(device) > cap else 3


def solve_mixed(
    cases: List[Dict],
    tol: float = 3e-5,
    max_iter: int = 20,
    chunk_size: int = 256,
    compact_after: int = 0,
    method: str = "nr",
    mesh=None,
    device="cuda",
) -> Dict:
    """Solve a HETEROGENEOUS case list: group by topology, batch per group.

    `solve_batched` requires one shared topology; a request stream mixes
    cases. This groups by the full topology signature (bus count and types,
    branch endpoints, generator buses), solves each group as one batch and
    reassembles the results in the original order. Arrays are padded to
    the largest bus count with NaN; "n_bus" carries each case's real size.

    method: "nr" (default) or "fdpf" / "auto", routed through
    `eval.solve.solve_ac` per group (the fast-decoupled solver with
    full-Newton flat-start fallback).

    The groups run one after another. gns_tpu overlaps them on a thread
    pool to hide its relay's fetch round trips; here each group's Newton
    loop reads its exit test from the device every iteration anyway, and
    the kernels' launch counters are plain integers.
    """
    check_no_mesh(mesh)
    sigs: Dict[bytes, list] = {}
    for i, case in enumerate(cases):
        bus = np.asarray(case["bus"])
        br = np.asarray(case["branch"])
        gen = np.asarray(case["gen"])
        sig = b"|".join([
            bus[:, 1].astype(np.int8).tobytes(),
            br[:, :2].astype(np.int32).tobytes(),
            gen[:, 0].astype(np.int32).tobytes(),
        ])
        sigs.setdefault(sig, []).append(i)
    n_max = max(np.asarray(c["bus"]).shape[0] for c in cases)
    s = len(cases)
    v = np.full((s, n_max), np.nan, np.float32)
    th = np.full((s, n_max), np.nan, np.float32)
    conv = np.zeros(s, bool)
    itg = np.zeros(s, np.int32)
    n_bus = np.zeros(s, np.int32)
    mismatch = np.zeros(s, np.float32)
    stalled = np.zeros(s, bool)
    iterations, syncs = 0, 0

    def _solve(idx):
        if method == "nr":
            return solve_batched(
                [cases[i] for i in idx], tol=tol, max_iter=max_iter,
                chunk_size=chunk_size, compact_after=compact_after, device=device,
            )
        from gns_torch.eval.solve import solve_ac

        return solve_ac(
            [cases[i] for i in idx], warm_start="flat", method=method,
            tol=tol, max_iter=max_iter, chunk_size=chunk_size,
            compact_after=compact_after, device=device,
        )

    for idx in sigs.values():
        sub = _solve(idx)
        n = sub["v"].shape[1]
        ii = np.asarray(idx)
        v[ii, :n] = sub["v"]
        th[ii, :n] = sub["theta_deg"]
        conv[ii] = sub["converged"]
        itg[ii] = sub["iterations_per_grid"]
        mismatch[ii] = sub["mismatch"]
        stalled[ii] = sub["stalled"]
        n_bus[ii] = n
        iterations = max(iterations, sub["iterations"])
        syncs += sub.get("host_syncs", 0)
    return {
        "v": v, "theta_deg": th, "converged": conv,
        "iterations": iterations, "iterations_per_grid": itg,
        "mismatch": mismatch, "stalled": stalled,
        "n_bus": n_bus, "n_groups": len(sigs), "host_syncs": syncs,
    }


def _seed_warm(ns: NRSmall, warm_start, lo: int, hi: int):
    """The chunk's initial iterate: the flat start, with the free unknowns
    (|v| at PQ buses, angles at PV+PQ buses) taken from `warm_start`."""
    vm0, va0 = ns.vm0, ns.va0
    if warm_start is not None:
        wv = np.asarray(warm_start[0][lo:hi], np.float32)
        wth = np.asarray(warm_start[1][lo:hi], np.float32)
        vm0, va0 = vm0.copy(), va0.copy()
        vm0[:, ns.pq] = wv[:, ns.pq]
        va0[:, ns.pvpq] = wth[:, ns.pvpq]
    return vm0, va0


def _compact_stragglers(packed, k1, max_iter, topo, bus, branch, base, p_sched, q_sched,
                        has_status, tol, device):
    """Per-grid convergence exit on one fetched chunk (numpy `packed`):
    the grids that missed the gate within k1 lock-step iterations
    continue from their current iterates in a power-of-2 sub-batch (at
    least 8, the last straggler repeated) with the remaining budget.
    Updates `packed` in place; returns (the sub-batch's iterations, its
    host syncs)."""
    n = bus.shape[1]
    bad = np.flatnonzero(packed[:, 2 * n] < 0.5)
    if k1 >= max_iter or not bad.size:
        return 0, 0
    sub = max(8, 1 << int(np.ceil(np.log2(bad.size))))
    sel = np.concatenate([bad, np.repeat(bad[:1], sub - bad.size)])
    p2, syncs = _nr_core(
        topo, *_on(device, bus[sel], branch[sel], base[sel], p_sched[sel], q_sched[sel],
                   packed[sel, :n], packed[sel, n:2 * n]),
        has_status, tol, max_iter - k1,
    )
    p2 = p2.cpu().numpy()[:bad.size]
    packed[bad, :2 * n] = p2[:, :2 * n]
    packed[bad, 2 * n] = p2[:, 2 * n]
    packed[bad, 2 * n + 2] = k1 + p2[:, 2 * n + 2]
    packed[bad, 2 * n + 3] = p2[:, 2 * n + 3]
    return int(p2[0, 2 * n + 1]), syncs + 1


def unpack_results(packed_chunks, its, tol: float, syncs: int) -> Dict:
    """The result dict of a chunked solve from its fetched (S_chunk, 2N+4)
    packs and per-chunk iteration counts."""
    vms, vas, convs, itgs, fms = [], [], [], [], []
    for packed in packed_chunks:
        n = (packed.shape[1] - 4) // 2
        vms.append(packed[:, :n])
        vas.append(packed[:, n:2 * n])
        convs.append(packed[:, 2 * n] > 0.5)
        itgs.append(packed[:, 2 * n + 2].astype(np.int32))
        fms.append(packed[:, 2 * n + 3])
    conv_all = np.concatenate(convs)
    mismatch = np.concatenate(fms).astype(np.float32)
    return {
        "v": np.concatenate(vms).astype(np.float32),
        "theta_deg": np.rad2deg(np.concatenate(vas)).astype(np.float32),
        "converged": conv_all,
        "iterations": max(its),
        # per-chunk counts, to audit where the lock-step loop spent its
        # iterations
        "iterations_per_chunk": list(its),
        # iteration at which each grid individually met the gate
        "iterations_per_grid": np.concatenate(itgs),
        # each grid's final max |f| (p.u.): separates tol-converged grids
        # from stall-accepted ones ("stalled" below)
        "mismatch": mismatch,
        "stalled": conv_all & (mismatch >= tol),
        # exit tests read from the device, and packed fetches
        "host_syncs": syncs,
    }


def solve_batched(
    cases: List[Dict],
    tol: float = 3e-5,
    max_iter: int = 20,
    chunk_size: int = 256,
    warm_start=None,
    compact_after=0,
    mesh=None,
    device="cuda",
) -> Dict:
    """Solve every case; returns {"v", "theta_deg", "converged",
    "iterations", "iterations_per_grid", "mismatch", "stalled",
    "host_syncs", ...}. "stalled" marks grids accepted at the float32
    mismatch floor (final mismatch in [tol, min(3e-4, 10*tol)) with Newton
    progress stalled) rather than strictly below tol; converged=True is the
    union.

    Chunks the batch so the dense (chunk, N, N) G/B matrices stay small.
    Non-converged grids keep their last iterate, flagged False; callers
    filter exactly as with the scipy oracle (harness.compute_metrics drops
    them).

    compact_after: per-grid convergence exit. 0 (default) = pure lock-step.
    "auto" = resolved against the measured round trip
    (resolve_compact_after). k > 0 = after k full-batch iterations, grids
    that already met the gate stop paying Jacobian builds: the stragglers
    are repacked into a power-of-2 sub-batch that continues from its
    current iterates with the remaining budget (one extra fetch and launch
    round trip per chunk). It pays most when a batch holds members that
    never converge (islanded N-1 variants): lock-step would spin the whole
    batch to max_iter on their account. "iterations" then reports k1 + the
    sub-batch's count (an upper bound on any grid's sequential depth).

    warm_start: optional (v (S, N), theta_rad (S, N)) initial guess, e.g. a
    GNS prediction (eval/hybrid.py). Only the free unknowns are seeded:
    |v| at PQ buses and angles at PV+PQ buses; PV-bus magnitudes stay at
    their set-points and the slack stays at the case's (input) Va, exactly
    like the flat start. The fixed point is unchanged; only the iteration
    count is not.

    tol default 3e-5: safely above the float32 mismatch floor (~1e-5 on the
    largest cases), while Newton's quadratic convergence means the accepted
    iterate is the one a 1e-5 gate would accept.

    mesh: gns_tpu shards each chunk over a "dp" mesh axis; not ported
    (only None). device: "cuda" (default) or "cpu" (the plain path).
    """
    check_no_mesh(mesh)
    dev = resolve_device(device)
    f32_matmuls()
    compact_after = resolve_compact_after(compact_after, device=dev)
    k1 = compact_after if 0 < compact_after < max_iter else max_iter
    packs, its, syncs = [], [], 0
    for lo in range(0, len(cases), chunk_size):
        bus, branch, gen, base = stack_cases(cases[lo:lo + chunk_size])
        ns = build_nr_small_stacked(bus, branch, gen, base)
        vm0, va0 = _seed_warm(ns, warm_start, lo, lo + chunk_size)
        f = branch[0, :, 0].astype(np.int64) - 1
        t = branch[0, :, 1].astype(np.int64) - 1
        has_status = branch.shape[2] > 10
        topo = _topology(f, t, bus.shape[1], ns.pvpq, ns.pq, dev)
        packed, chunk_syncs = _nr_core(
            topo, *_on(dev, bus, branch, base, ns.p_sched, ns.q_sched, vm0, va0),
            has_status, tol, k1,
        )
        packed = packed.cpu().numpy()
        syncs += chunk_syncs + 1
        it_chunk = int(packed[0, 2 * bus.shape[1] + 1])
        extra, extra_syncs = _compact_stragglers(
            packed, k1, max_iter, topo, bus, branch, base, ns.p_sched, ns.q_sched,
            has_status, tol, dev,
        )
        packs.append(packed)
        its.append(it_chunk + extra)
        syncs += extra_syncs
    return unpack_results(packs, its, tol, syncs)
