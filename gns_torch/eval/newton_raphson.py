"""Newton-Raphson AC power flow: the evaluation oracle (the port's own copy
of gns_tpu/eval/newton_raphson.py).

The reference uses pypower's `runpf` with PF_ALG=1 (Newton's method) as
ground truth (reference: GNS/evaluate.py:25-40). This is the same
algorithm written out (full Newton, polar form, sparse LU) on the same
pypower/MATPOWER case-dict format. It solves the *raw* case (true shunts,
not the paper-default ones prepare_case forces), exactly like runpf.

Host-side numpy/scipy in float64 by design: the oracle runs once per
evaluation on the CPU and has no CUDA counterpart; the model under test is
the forward on the card. The batched on-device solver is a later port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


class NRResult(NamedTuple):
    vm: np.ndarray  # (N,) voltage magnitudes, p.u.
    va_deg: np.ndarray  # (N,) voltage angles, degrees
    success: bool
    iterations: int
    bus: np.ndarray  # updated bus array (cols 7/8 = solved VM/VA)
    gen: np.ndarray  # updated gen array (cols 1/2 = solved Pg/Qg at slack/PV)


def make_ybus(case: Dict):
    """Bus admittance matrix, MATPOWER conventions."""
    base_mva = case["baseMVA"]
    bus = np.asarray(case["bus"], dtype=np.float64)
    branch = np.asarray(case["branch"], dtype=np.float64)
    n = bus.shape[0]
    # Bus numbering may be non-consecutive in general MATPOWER data; the
    # shipped/generated cases are consecutive 1..N (SURVEY.md §2.3), but map
    # defensively anyway.
    bus_index = {int(b): i for i, b in enumerate(bus[:, 0])}

    status = branch[:, 10] if branch.shape[1] > 10 else np.ones(branch.shape[0])
    ys = status / (branch[:, 2] + 1j * branch[:, 3])
    bc = status * branch[:, 4]
    tap = np.where(branch[:, 8] == 0, 1.0, branch[:, 8]) * np.exp(
        1j * np.deg2rad(branch[:, 9])
    )
    ytt = ys + 1j * bc / 2.0
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap

    f = np.array([bus_index[int(x)] for x in branch[:, 0]])
    t = np.array([bus_index[int(x)] for x in branch[:, 1]])

    ysh = (bus[:, 4] + 1j * bus[:, 5]) / base_mva

    rows = np.concatenate([f, f, t, t, np.arange(n)])
    cols = np.concatenate([f, t, f, t, np.arange(n)])
    vals = np.concatenate([yff, yft, ytf, ytt, ysh])
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n)), bus_index, (f, t)


def newton_raphson_pf(
    case: Dict, tol: float = 1e-8, max_iter: int = 10
) -> NRResult:
    """Solve the AC power flow for a pypower-style case dict."""
    base_mva = case["baseMVA"]
    bus = np.array(case["bus"], dtype=np.float64)
    gen = np.array(case["gen"], dtype=np.float64)
    n = bus.shape[0]

    ybus, bus_index, _ = make_ybus(case)

    types = bus[:, 1].astype(int)
    slack = np.flatnonzero(types == 3)
    pv = np.flatnonzero(types == 2)
    pq = np.flatnonzero(types == 1)
    pvpq = np.concatenate([pv, pq])

    # Net scheduled injections (p.u.): generation minus load.
    gstat = gen[:, 7] if gen.shape[1] > 7 else np.ones(gen.shape[0])
    gbus = np.array([bus_index[int(x)] for x in gen[:, 0]])
    pg = np.zeros(n)
    qg = np.zeros(n)
    np.add.at(pg, gbus, gen[:, 1] * gstat)
    np.add.at(qg, gbus, gen[:, 2] * gstat)
    sbus = (pg - bus[:, 2] + 1j * (qg - bus[:, 3])) / base_mva

    # Initial voltage: case VM/VA, generator buses forced to Vg (runpf
    # semantics: the in-service gen's set-point wins).
    vm = bus[:, 7].copy()
    va = np.deg2rad(bus[:, 8].copy())
    vm[gbus[gstat > 0]] = gen[gstat > 0, 5]
    v = vm * np.exp(1j * va)

    def mismatch(v):
        return v * np.conj(ybus @ v) - sbus

    def f_of(v):
        mis = mismatch(v)
        return np.concatenate([mis[pvpq].real, mis[pq].imag])

    # pypower's newtonpf checks convergence AFTER each update (so a case
    # that converges on exactly the max_iter-th update counts); mirror that
    # rather than checking at the top of the loop.
    f_vec = f_of(v)
    converged = bool(np.max(np.abs(f_vec)) < tol)
    it = 0
    while not converged and it < max_iter:
        it += 1

        # Power-flow Jacobian in polar coordinates.
        ibus = ybus @ v
        diag_v = sp.diags(v)
        diag_i = sp.diags(ibus)
        diag_vnorm = sp.diags(v / np.abs(v))
        ds_dva = 1j * diag_v @ np.conj(diag_i - ybus @ diag_v)
        ds_dvm = diag_v @ np.conj(ybus @ diag_vnorm) + np.conj(diag_i) @ diag_vnorm

        j11 = ds_dva[np.ix_(pvpq, pvpq)].real
        j12 = ds_dvm[np.ix_(pvpq, pq)].real
        j21 = ds_dva[np.ix_(pq, pvpq)].imag
        j22 = ds_dvm[np.ix_(pq, pq)].imag
        jac = sp.bmat([[j11, j12], [j21, j22]], format="csr")

        dx = spla.spsolve(jac, f_vec)
        n_pvpq = pvpq.size
        va[pvpq] -= dx[:n_pvpq]
        vm[pq] -= dx[n_pvpq:]
        v = vm * np.exp(1j * va)

        f_vec = f_of(v)
        converged = bool(np.max(np.abs(f_vec)) < tol)

    vm = np.abs(v)
    va_deg = np.rad2deg(np.angle(v))

    bus_out = bus.copy()
    bus_out[:, 7] = vm
    bus_out[:, 8] = va_deg

    # Back out slack P and slack/PV Q (runpf's gen update).
    s_inj = v * np.conj(ybus @ v)
    gen_out = gen.copy()
    for gi, b in enumerate(gbus):
        if gstat[gi] <= 0:
            continue
        if types[b] == 3:
            gen_out[gi, 1] = (s_inj[b].real * base_mva + bus[b, 2])
        if types[b] in (2, 3):
            gen_out[gi, 2] = (s_inj[b].imag * base_mva + bus[b, 3])

    return NRResult(vm, va_deg, converged, it, bus_out, gen_out)
