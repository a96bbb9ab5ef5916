"""N-2 (double branch outage) screening with variants built on the card
(port of gns_tpu/eval/n2.py).

The N-1 screen materializes each variant as a case dict (fine for C ~ E
contingencies). An N-2 screen is C(E, 2) pairs, 17,205 for the authentic
case118, and there the host-side variant stacks would be the larger cost:
branch tables whose rows differ from the base case ONLY in two status
zeros.

So the base case goes to the device once per chunk, with an (S, 2) pair
array, and every variant is built there (`_n2_core`): the base branch
table is repeated into a materialised (S, E, C) stack and the status
column is zeroed at the two outaged rows of each pair (plain indexed
assignment: the same zeros wherever two writes meet). Everything
downstream is the shared solver machinery: B'/B'' or G/B assembly on K1,
the fast-decoupled loop with its injections on K1 / K2 (eval/fdpf.py) or
the Newton loop (eval/nr_batched.py), one packed output per chunk. The
chunks' packed outputs stay on the device until every chunk is queued;
each loop still reads its exit test once per iteration.

Structural islanding is exact at N-2 too, on the host: pair (a, b)
islands the network iff a is a bridge of the base graph, b is, or b is a
bridge of the graph with a removed (`n2_islanding_pairs`, at most E runs of
the O(N+E) Tarjan search). The ranked screen uses the structural set to
skip verification of hopeless pairs.

Usage:
    from gns_torch.eval.n2 import n2_pairs, screen_n2, screen_n2_ranked
    pairs = n2_pairs(case)                      # all C(E,2) pairs
    rep = screen_n2(case, pairs)                # full exact screen, on "cuda"
    rep = screen_n2_ranked(case, model, cfg, pairs, top_k=256)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gns_torch.eval.contingency import find_bridges
from gns_torch.eval.fdpf import _fdpf_core
from gns_torch.eval.hybrid import _forward_graph
from gns_torch.eval.nr_batched import (
    _nr_core,
    _on,
    _topology,
    build_nr_small_stacked,
    f32_matmuls,
    stack_cases,
)
from gns_torch.models.gns import GNS, gns_forward, step_params
from gns_torch.parallel.solver_dp import (
    dp_group, dp_size, gather_rows, pad_rows, padded_rows, shard_chunk,
)
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device
from gns_torch.utils.prepare import GridBatch, prepare_case


def n2_pairs(case: Dict, in_service_only: bool = True) -> np.ndarray:
    """All unordered branch index pairs (P, 2) int32 of `case` (C(E, 2);
    pairs involving out-of-service branches dropped unless
    in_service_only=False: outaging a dead branch is a no-op)."""
    br = np.asarray(case["branch"], np.float64)
    e = br.shape[0]
    rows = np.arange(e)
    if in_service_only and br.shape[1] > 10:
        rows = rows[br[:, 10] > 0]
    a, b = np.triu_indices(rows.size, k=1)
    return np.stack([rows[a], rows[b]], axis=1).astype(np.int32)


def n2_islanding_pairs(case: Dict,
                       pairs: Optional[np.ndarray] = None) -> np.ndarray:
    """(P,) bool aligned with `pairs` (default n2_pairs(case)): True where
    the pair STRUCTURALLY islands the network. Exact, host-side, <= E
    Tarjan runs: (a, b) islands iff a or b is a base-graph bridge, or b
    bridges the graph with a removed (computed once per distinct a).

    This is the STRUCTURAL verdict, which can differ from solver
    convergence on one degenerate class: an island whose injections
    balance exactly (e.g. case14 pair (4-7, 7-9): buses {7, 8} island with
    zero load and a Pg=0 condenser) has zero mismatch at an indeterminate
    angle; Newton may report it "converged" at a singular Jacobian while
    fast-decoupled returns NaN. The screens report BOTH signals; "worst"
    unions them.
    """
    br = np.asarray(case["branch"], np.float64)
    if br.shape[1] <= 10:
        raise ValueError("N-2 islanding needs a branch status column")
    if pairs is None:
        pairs = n2_pairs(case)
    pairs = np.asarray(pairs, np.int64)
    base_bridges = set(find_bridges(case).tolist())
    # bridges of G - a, for every distinct first element (find_bridges on
    # a status-masked copy)
    cond_bridges = {}
    for a in np.unique(pairs[:, 0]):
        a = int(a)
        if a in base_bridges:
            continue  # already islanding alone
        va = dict(case)
        vb = br.copy()
        vb[a, 10] = 0.0
        va["branch"] = vb
        cond_bridges[a] = set(find_bridges(va).tolist())
    out = np.zeros(pairs.shape[0], bool)
    for i, (a, b) in enumerate(pairs):
        a, b = int(a), int(b)
        if a in base_bridges or b in base_bridges:
            out[i] = True
        else:
            out[i] = b in cond_bridges[a]
    return out


def n2_branch_loading(case: Dict, pairs: np.ndarray, v: np.ndarray,
                      theta_deg: np.ndarray,
                      chunk: int = 4096) -> np.ndarray:
    """(P, E) max(|S_f|, |S_t|) MVA loadings at N-2 solved states.

    The N-2 twin of `contingency.ac_branch_loading`, without
    materializing per-variant branch tables: the base case's complex
    branch admittances are computed once and the two outaged rows are
    zeroed per pair. NaN states (non-converged pairs) propagate NaN.
    float64 numpy on the host.
    """
    br = np.asarray(case["branch"], np.float64)
    e = br.shape[0]
    f = br[:, 0].astype(np.int64) - 1
    t = br[:, 1].astype(np.int64) - 1
    status = br[:, 10] if br.shape[1] > 10 else np.ones(e)
    ys = status / (br[:, 2] + 1j * br[:, 3])
    bc = status * br[:, 4]
    tap = np.where(br[:, 8] == 0, 1.0, br[:, 8]) * np.exp(
        1j * np.deg2rad(br[:, 9])
    )
    ytt = ys + 1j * bc / 2.0
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap
    base = float(case["baseMVA"])

    p = pairs.shape[0]
    out = np.empty((p, e), np.float64)
    for lo in range(0, p, chunk):
        pr = pairs[lo:lo + chunk]
        k = pr.shape[0]
        rows = np.arange(k)[:, None]
        live = np.ones((k, e), np.float64)
        live[rows, pr] = 0.0  # the per-pair status zeros
        vc = v[lo:lo + chunk].astype(np.float64) * np.exp(
            1j * np.deg2rad(theta_deg[lo:lo + chunk].astype(np.float64))
        )
        vf, vt = vc[:, f], vc[:, t]
        sf = vf * np.conj(live * (yff[None] * vf + yft[None] * vt))
        st = vt * np.conj(live * (ytf[None] * vf + ytt[None] * vt))
        out[lo:lo + chunk] = np.maximum(np.abs(sf), np.abs(st)) * base
    return out


def _n2_core(topo, bus, branch, base, p_sched, q_sched, vm0, va0, pairs,
             method: str, tol: float, max_iter: int, group=None):
    """One chunk of device-built variants, solved: bus (N, Cb) / branch
    (E, Cc) / base () / p_sched, q_sched (N,) of the base case, the initial
    iterate vm0 / va0 ((N,) flat or (S, N) warm), pairs (S, 2) int64, all
    on one device. The (S, E, Cc) branch stack is a materialised copy whose
    status column (col 10, the N-1 variant semantics) is zeroed at each
    pair's two rows; the other inputs are broadcast views, which the
    solvers only read. group: a sharded chunk's dp group (the loop's exit
    test is all-reduced over it). Returns (packed (S, 2N+4) tensor, host
    syncs)."""
    s = pairs.shape[0]
    n = bus.shape[0]
    branch_s = branch.repeat(s, 1, 1)
    branch_s[torch.arange(s, device=pairs.device)[:, None], pairs, 10] = 0.0
    bus_s = bus.expand(s, *bus.shape)
    base_s = base.expand(s)
    p_s, q_s = p_sched.expand(s, n), q_sched.expand(s, n)
    vm_s, va_s = vm0.expand(s, n), va0.expand(s, n)
    if method == "fdpf":
        return _fdpf_core(topo, bus_s, branch_s, base_s, p_s, q_s, vm_s, va_s,
                          True, "XB", tol, max_iter, group)
    return _nr_core(topo, bus_s, branch_s, base_s, p_s, q_s, vm_s, va_s,
                    True, tol, max_iter, group)


def screen_n2(
    case: Dict,
    pairs: Optional[np.ndarray] = None,
    tol: float = 3e-5,
    max_iter: int = 20,
    fdpf_max_iter: int = 60,
    chunk_size: int = 2048,
    method: str = "auto",
    warm_start=None,
    v_limits=(0.94, 1.06),
    mesh=None,
    device="cuda",
) -> Dict:
    """Exact screen of double branch outages; variants built on the device.

    pairs: (P, 2) int32 branch-row pairs (default: every in-service
    C(E, 2) pair). method "auto"/"fdpf" = the fast-decoupled loop (at most
    fdpf_max_iter iterations), "nr" = full Newton (max_iter). warm_start:
    optional (v (P, N), theta_rad (P, N)) per-pair initial iterates (e.g.
    ranked-screen predictions), seeded on the host on the free unknowns
    exactly like solve_batched.

    A non-converged pair is the islanding/divergence signal, as in
    screen_n1; structurally islanding pairs (n2_islanding_pairs) cannot
    converge from any start, and no Newton rescue is attempted on other
    failures; pass method="nr" for the most robust arm. Pairs go in chunks
    of `chunk_size`, the last padded to that size by repeating its final
    row (every chunk has one shape; padded rows are trimmed).

    Returns {"pairs", "converged", "islanded", "v", "theta_deg",
    "v_violations", "flow_violations", "max_loading_frac",
    "iterations_per_grid", "mismatch", "worst", "method",
    "iterations_per_chunk", "host_syncs"}.

    mesh: a DeviceMesh with a "dp" axis (parallel/solver_dp.py): each
    chunk (padded to a dp multiple) is split over it by rows, its loop's
    exit test all-reduced over dp and its packed result all-gathered, so
    every rank returns the whole screen. device: "cuda" (default) or
    "cpu"; under a mesh, this rank's device.
    """
    dev = resolve_device(device)
    f32_matmuls()
    group = dp_group(mesh)
    if pairs is None:
        pairs = n2_pairs(case)
    pairs = np.asarray(pairs, np.int32)
    if method == "auto":
        method = "fdpf"
    if method not in ("nr", "fdpf"):
        raise ValueError(f"method must be auto|nr|fdpf, got {method!r}")
    budget = fdpf_max_iter if method == "fdpf" else max_iter

    bus, branch, gen, base = stack_cases([case])
    if branch.shape[2] <= 10:
        raise ValueError("N-2 screen requires a branch status column")
    ns = build_nr_small_stacked(bus, branch, gen, base)
    f = branch[0, :, 0].astype(np.int64) - 1
    t = branch[0, :, 1].astype(np.int64) - 1
    n = bus.shape[1]
    topo = _topology(f, t, n, ns.pvpq, ns.pq, dev)
    base_args = _on(dev, bus[0], branch[0], base[0], ns.p_sched[0], ns.q_sched[0])

    pending, syncs = [], 0
    for lo in range(0, pairs.shape[0], chunk_size):
        chunk = pairs[lo:lo + chunk_size]
        k = chunk.shape[0]
        # one shape for every chunk, and a dp multiple under a mesh
        target = padded_rows(chunk_size if pairs.shape[0] > chunk_size else k, mesh)
        chunk = pad_rows(chunk, target)
        if warm_start is not None:
            # per-pair warm iterates: seed the free unknowns on the host
            # and send the (S, N) arrays
            wv = pad_rows(np.asarray(warm_start[0][lo:lo + k], np.float32), target)
            wth = pad_rows(np.asarray(warm_start[1][lo:lo + k], np.float32), target)
            vm0 = np.broadcast_to(ns.vm0[0], (target, n)).copy()
            va0 = np.broadcast_to(ns.va0[0], (target, n)).copy()
            vm0[:, ns.pq] = wv[:, ns.pq]
            va0[:, ns.pvpq] = wth[:, ns.pvpq]
            vm0, va0 = shard_chunk(mesh, (vm0, va0), target)
        else:
            vm0, va0 = ns.vm0[0], ns.va0[0]
        (chunk,) = shard_chunk(mesh, (chunk,), target)
        packed, chunk_syncs = _n2_core(
            topo, *base_args, *_on(dev, vm0, va0),
            torch.as_tensor(chunk.astype(np.int64), device=dev), method, tol, budget, group,
        )
        pending.append((gather_rows(mesh, packed, k), k))
        syncs += chunk_syncs

    vms, vas, convs, itgs, fms, its = [], [], [], [], [], []
    for dev_packed, k in pending:
        packed = dev_packed.cpu().numpy()[:k]
        syncs += 1
        vms.append(packed[:, :n])
        vas.append(packed[:, n:2 * n])
        convs.append(packed[:, 2 * n] > 0.5)
        its.append(int(packed[0, 2 * n + 1]))
        itgs.append(packed[:, 2 * n + 2].astype(np.int32))
        fms.append(packed[:, 2 * n + 3])
    conv = np.concatenate(convs)
    v = np.concatenate(vms).astype(np.float32)
    theta = np.rad2deg(np.concatenate(vas)).astype(np.float32)
    v[~conv] = np.nan
    theta[~conv] = np.nan

    lo_v, hi_v = v_limits
    is_pq = bus[0, :, 1].astype(int) == 1  # branch outages never change bus types
    with np.errstate(invalid="ignore"):
        viol = np.where(
            conv, (((v < lo_v) | (v > hi_v)) & is_pq[None, :]).sum(axis=1), 0
        ).astype(np.int32)
    # MVA-limit screening as in screen_n1: exact AC loadings at the solved
    # states against each branch's published rateA; unrated branches
    # (9900 placeholders included) never count
    rate = np.asarray(case["branch"], np.float64)[:, 5]
    rated = (rate > 0) & (rate < 9000.0)
    if rated.any():
        loading = n2_branch_loading(case, pairs, v, theta)
        with np.errstate(invalid="ignore"):
            over = rated[None, :] & (loading > rate[None, :])
            frac = np.where(rated[None, :], loading / np.where(
                rated, rate, 1.0)[None, :], 0.0)
        nan_rows = np.isnan(loading).any(axis=1)
        fl_viol = np.where(nan_rows, 0, over.sum(axis=1)).astype(np.int32)
        max_frac = np.where(nan_rows, np.nan,
                            frac.max(axis=1)).astype(np.float32)
    else:
        fl_viol = np.zeros(pairs.shape[0], np.int32)
        max_frac = np.where(conv, 0.0, np.nan).astype(np.float32)
    # structural islanding is reported beside solver convergence: the two
    # differ exactly on balanced islands (see n2_islanding_pairs)
    islanded = n2_islanding_pairs(case, pairs)
    return {
        "pairs": pairs,
        "converged": conv,
        "islanded": islanded,
        "v": v,
        "theta_deg": theta,
        "v_violations": viol,
        "flow_violations": fl_viol,
        "max_loading_frac": max_frac,
        "iterations_per_grid": np.concatenate(itgs),
        "mismatch": np.concatenate(fms).astype(np.float32),
        "worst": np.flatnonzero(
            islanded | ~conv | (viol > 0) | (fl_viol > 0)
        ),
        "method": method,
        "iterations_per_chunk": its,
        "host_syncs": syncs,
    }


def _n2_rank_core(steps, cfg: GNSConfig, graph, slack_idx: int, buses, lines, gens,
                  pairs, va_slack):
    """The ranked stage's forward on one chunk: base PREPARED tensors
    (buses (N, 6), lines (E, 7), gens (G, 7)) + pairs (S, 2) -> (severity,
    predicted v, predicted theta in the slack-pinned gauge), device
    tensors. The outage encoding is the aware representation (r=x=1e6,
    b=0, a zero in admittance space) written into a materialised copy of
    the prepared line features (cols 2/3/4 = r/x/b, utils/prepare.py); one
    forward over the S variants on the shared topology, one over the
    intact case (the bias-cancelling severity reference)."""
    s = pairs.shape[0]
    lines_s = lines.repeat(s, 1, 1)
    rows = torch.arange(s, device=pairs.device)[:, None]
    lines_s[rows, pairs, 2] = 1e6
    lines_s[rows, pairs, 3] = 1e6
    lines_s[rows, pairs, 4] = 0.0
    batch = GridBatch(buses.expand(s, *buses.shape), lines_s, gens.expand(s, *gens.shape),
                      None, None, None, None)
    out = gns_forward(steps, cfg, batch, graph, dense=True)
    intact = GridBatch(buses[None], lines[None], gens[None], None, None, None, None)
    base_out = gns_forward(steps, cfg, intact, graph, dense=True)
    sev = torch.sqrt(((out.v - base_out.v) ** 2).mean(dim=1))
    theta = out.theta - out.theta[:, slack_idx:slack_idx + 1] + va_slack
    return sev, out.v, theta


def screen_n2_ranked(
    case: Dict,
    params: GNS,
    cfg: GNSConfig,
    pairs: Optional[np.ndarray] = None,
    top_k: int = 256,
    tol: float = 3e-5,
    max_iter: int = 20,
    fdpf_max_iter: int = 60,
    chunk_size: int = 2048,
    method: str = "auto",
    v_limits=(0.94, 1.06),
    score: str = "depth",
    mesh=None,
    device="cuda",
) -> Dict:
    """Ranked N-2 screen: structural islanding exact, ONE aware forward per
    chunk over device-built variants, verify only top_k pairs.

    At C(E, 2) scale the full exact screen solves P power flows; this
    screen solves `top_k` of them plus P forwards, and flags every
    structurally islanding pair exactly (n2_islanding_pairs). Requires an
    outage-AWARE checkpoint (GNSConfig.admittance_inputs, the
    `*-n1`/`*-deep-n1` family); `params` is the GNS module, whose step
    weights go to `device`.

    score: the severity ordering. "depth" (default) ranks by PREDICTED
    violation depth (sum over PQ buses of the predicted excursion past
    v_limits), right where truth is defined by violation (the N-2 regime);
    "rms" is the N-1 screen's bias-cancelled deviation-from-intact score,
    right where truth is defined by change.

    Returns {"pairs", "islanded" (structural), "severity", "order",
    "verified_idx", "converged"/"iterations_per_grid"/"v"/"theta_deg"/
    "v_violations"/"flow_violations" (verified subset; NaN/0 elsewhere), "pred_v",
    "pred_theta", "worst", "n_solves", "host_syncs"}.

    mesh: a DeviceMesh with a "dp" axis: the verify solves (screen_n2) are
    sharded over it; the ranking forwards run whole on every rank, as
    gns_tpu's do. device: "cuda" (default) or "cpu"; under a mesh, this
    rank's device.
    """
    dev = resolve_device(device)
    dp_size(mesh)
    f32_matmuls()
    if score not in ("depth", "rms"):
        raise ValueError(f"score must be depth|rms, got {score!r}")
    if pairs is None:
        pairs = n2_pairs(case)
    pairs = np.asarray(pairs, np.int32)
    p = pairs.shape[0]

    # stage 1: exact structural islanding
    islanded = n2_islanding_pairs(case, pairs)

    # stage 2: chunked aware forwards over device-built variants
    buses, lines, gens = prepare_case(case, paper_shunts=not cfg.true_shunts)
    types = np.asarray(case["bus"])[:, 1].astype(int)
    slack_idx = int(np.flatnonzero(types == 3)[0])
    va_slack = np.deg2rad(
        np.asarray(case["bus"], np.float64)[slack_idx, 8]
    ).astype(np.float32)
    graph = _forward_graph(*stack_cases([case])[:3], dev)  # cached per topology
    with torch.no_grad():
        steps = [{h: {k: w.to(dev) for k, w in hp.items()} for h, hp in s.items()}
                 for s in step_params(params, cfg)]
    buses_d, lines_d, gens_d = (torch.as_tensor(a, device=dev) for a in (buses, lines, gens))
    va_slack_d = torch.as_tensor(va_slack, device=dev)
    pend = []
    with torch.no_grad():
        for lo in range(0, p, chunk_size):
            chunk = pairs[lo:lo + chunk_size]
            k = chunk.shape[0]
            target = chunk_size if p > chunk_size else k
            chunk = pad_rows(chunk, target)
            out = _n2_rank_core(steps, cfg, graph, slack_idx, buses_d, lines_d, gens_d,
                                torch.as_tensor(chunk.astype(np.int64), device=dev), va_slack_d)
            pend.append((out, lo, k))
    sev = np.zeros(p, np.float64)
    n = buses.shape[0]
    pv = np.zeros((p, n), np.float32)
    pth = np.zeros((p, n), np.float32)
    syncs = 0
    for (s_dev, v_dev, th_dev), lo, k in pend:
        sev[lo:lo + k] = s_dev.cpu().numpy()[:k]
        pv[lo:lo + k] = v_dev.cpu().numpy()[:k]
        pth[lo:lo + k] = th_dev.cpu().numpy()[:k]
        syncs += 3
    if score == "depth":
        lo_v, hi_v = v_limits
        is_pq = types == 1
        sev = (
            (np.maximum(lo_v - pv, 0.0) + np.maximum(pv - hi_v, 0.0))
            * is_pq[None, :]
        ).sum(axis=1).astype(np.float64)
    sev[islanded] = np.inf
    order = np.argsort(-sev, kind="stable").astype(np.int64)

    # stage 3: verify the top_k rankable pairs, warm-started by predictions
    rankable = order[~islanded[order]]
    top_k = min(top_k, rankable.size)
    verified_idx = np.sort(rankable[:top_k])
    conv = np.zeros(p, bool)
    v = np.full((p, n), np.nan, np.float32)
    theta = np.full((p, n), np.nan, np.float32)
    itg = np.zeros(p, np.int32)
    viol = np.zeros(p, np.int32)
    fl_viol = np.zeros(p, np.int32)
    if top_k:
        sub = screen_n2(
            case, pairs[verified_idx], tol=tol, max_iter=max_iter,
            fdpf_max_iter=fdpf_max_iter, chunk_size=chunk_size,
            method=method, v_limits=v_limits, mesh=mesh, device=dev,
            warm_start=(pv[verified_idx], pth[verified_idx]),
        )
        syncs += sub["host_syncs"]
        conv[verified_idx] = sub["converged"]
        itg[verified_idx] = sub["iterations_per_grid"]
        v[verified_idx] = sub["v"]
        theta[verified_idx] = sub["theta_deg"]
        viol[verified_idx] = sub["v_violations"]
        fl_viol[verified_idx] = sub["flow_violations"]
    worst = np.flatnonzero(
        islanded
        | (np.isin(np.arange(p), verified_idx)
           & (~conv | (viol > 0) | (fl_viol > 0)))
    )
    return {
        "pairs": pairs,
        "islanded": islanded,
        "severity": sev,
        "order": order,
        "verified_idx": verified_idx,
        "converged": conv,
        "iterations_per_grid": itg,
        "v": v,
        "theta_deg": theta,
        "v_violations": viol,
        "flow_violations": fl_viol,
        "pred_v": pv,
        "pred_theta": pth,
        "worst": worst,
        "n_solves": int(top_k),
        "host_syncs": syncs,
    }
