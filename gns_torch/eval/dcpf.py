"""Batched DC power flow on the card (port of gns_tpu/eval/dcpf.py).

The linearized (DC) approximation (flat voltage magnitudes, small angles,
lossless branches) reduces power flow to one batched linear solve:
B_dc theta = P. It is the screening tier below the exact solvers
(eval/nr_batched.py, eval/fdpf.py), the third rung of the solver ladder:

    GNS forward      learned approximation
    DC power flow    one solve, linear approximation (this module)
    fast-decoupled   matvec loop, exact
    full Newton      LU loop, exact

MATPOWER/pypower `makeBdc` conventions: per-branch susceptance
b = status / (x * tau) (resistance and charging ignored), phase-shift
injections Pf_inj = -b * shift moved to the bus side, bus-shunt Gs consumed
at flat voltage. B_dc and the phase-shift injections are assembled on the
device from the raw float32 case stacks like nr_batched's G/B: one K1
launch sums the 4E matrix terms per slot and the 2E injection terms per
bus (`_dc_pattern`), one store writes the matrix; the branch flows read
the angles at both branch ends with one K2 launch. The solve is a batched
LU (lu_factor_ex, no error check). One packed output, one copy to the host.

The DC solution is approximate by design (no |v|, no losses, no reactive
flows): typical transmission-grid angle errors are a few degrees and
branch-flow errors a few percent; callers needing exact states use
`solve_ac`. Returns per-branch MW flows, the quantity DC screening ranks
on. `lodf_matrix` and `dc_outage_severity` are host numpy (float64), a
copy of gns_tpu's.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from gns_torch.eval.nr_batched import (_cache_put, _on, check_no_mesh, f32_matmuls, lu_factor,
                                       stack_cases)
from gns_torch.ops.segment import SegmentIndex, gather, segment_sum
from gns_torch.utils.device import resolve_device

_DC_CACHE: Dict[tuple, object] = {}


class _DCTopology(NamedTuple):
    """A topology's DC index sets on one device."""

    slots: torch.Tensor  # (U,) distinct flat (N, N) slots of B_dc
    sums: SegmentIndex  # 4E matrix terms -> U slots, then 2E injection terms -> U + bus
    ends: SegmentIndex  # [f; t] into N buses (the flows' angle reads)
    nonslack: torch.Tensor  # (N - 1,) int64


def _dc_pattern(f: np.ndarray, t: np.ndarray, n: int, nonslack: np.ndarray,
                device) -> _DCTopology:
    """Index sets of one topology, built once on the host. The terms, in
    gns_tpu's order: -b at (f, t), -b at (t, f), b at (f, f), b at (t, t),
    then -b*shift at f and b*shift at t."""
    key = (f.tobytes(), t.tobytes(), n, nonslack.tobytes(), str(device))
    topo = _DC_CACHE.get(key)
    if topo is not None:
        return topo
    slot = np.concatenate([f * n + t, t * n + f, f * n + f, t * n + t])
    uniq, inv = np.unique(slot, return_inverse=True)
    u = len(uniq)
    ids = np.concatenate([inv, u + f, u + t])
    topo = _DCTopology(
        torch.as_tensor(uniq, device=device),
        SegmentIndex(ids, u + n, device),
        SegmentIndex(np.concatenate([f, t]), n, device),
        torch.as_tensor(nonslack.astype(np.int64), device=device),
    )
    _cache_put(_DC_CACHE, key, topo)
    return topo


def _dc_core(topo: _DCTopology, bus, branch, base, p_sched, has_status: bool,
             slack: int):
    """B_dc assembly, the batched solve and the branch flows of one chunk;
    returns the packed [theta | pf] (S, N + E) tensor."""
    s, n = bus.shape[:2]
    e = branch.shape[1]
    ns = topo.nonslack
    x = branch[:, :, 3]
    status = branch[:, :, 10] if has_status else torch.ones_like(x)
    tau = torch.where(branch[:, :, 8] == 0, torch.ones_like(x), branch[:, :, 8])
    b = status / (x * tau)  # (S, E) series susceptance, 1/(x*tau)
    shift = torch.deg2rad(branch[:, :, 9])

    # phase-shift injections (makeBdc): Pf_inj = -b * shift at the from
    # bus, +b * shift at the to bus; bus Gs consumed at |v| = 1
    terms = torch.cat([-b, -b, b, b, -b * shift, b * shift], dim=1)
    sums = segment_sum(terms, topo.sums)  # (S, U + N)
    u = topo.slots.numel()
    bmat = bus.new_zeros((s, n * n))
    bmat.index_copy_(1, topo.slots, sums[:, :u])
    bmat = bmat.view(s, n, n)
    p_inj = sums[:, u:]
    rhs = (p_sched - p_inj - bus[:, :, 4] / base[:, None])[:, ns]

    bred = bmat[:, ns][:, :, ns]
    lu, piv = lu_factor(bred)
    th_ns = torch.linalg.lu_solve(lu, piv, rhs[:, :, None])[..., 0]
    theta = bus.new_zeros((s, n))
    theta[:, ns] = th_ns
    # slack keeps the case's reference angle; shift everything
    theta = theta + torch.deg2rad(bus[:, slack, 8])[:, None]
    # per-branch DC flow, from-side MW: b * (th_f - th_t - shift)
    at_ends = gather(theta, topo.ends)  # (S, 2E)
    pf = b * (at_ends[:, :e] - at_ends[:, e:] - shift) * base[:, None]
    return torch.cat([theta, pf], dim=1)


def solve_batched_dc(cases: List[Dict], chunk_size: int = 1024, mesh=None,
                     device="cuda") -> Dict:
    """DC power flow for a shared-topology case list, one batched solve.

    Returns {"theta_deg" (S, N), "pf_mw" (S, E) from-side branch flows,
    "p_slack_mw" (S,) slack injection}. No iteration, no convergence
    question (the linear system is singular only for islanded grids, which
    surface as non-finite angles: check np.isfinite if the input may hold
    islands). Magnitudes are the DC assumption's flat profile; use solve_ac
    for exact states.

    mesh: not ported (only None). device: "cuda" (default) or "cpu".
    """
    check_no_mesh(mesh)
    dev = resolve_device(device)
    f32_matmuls()
    outs_th, outs_pf, outs_sl = [], [], []
    for lo in range(0, len(cases), chunk_size):
        bus, branch, gen, base = stack_cases(cases[lo:lo + chunk_size])
        s, n = bus.shape[:2]
        types = bus[0, :, 1].astype(int)
        slack = int(np.flatnonzero(types == 3)[0])
        nonslack = np.flatnonzero(types != 3).astype(np.int64)
        gen0 = gen[0]
        ng = gen.shape[1]
        gbus = gen0[:, 0].astype(np.int64) - 1
        gstat = gen[:, :, 7] if gen0.shape[1] > 7 else np.ones((s, ng))
        pg = np.zeros((s, n))
        np.add.at(pg, (slice(None), gbus), gen[:, :, 1] * gstat)
        p_sched = ((pg - bus[:, :, 2]) / base[:, None]).astype(np.float32)

        f = branch[0, :, 0].astype(np.int64) - 1
        t = branch[0, :, 1].astype(np.int64) - 1
        has_status = branch.shape[2] > 10
        topo = _dc_pattern(f, t, n, nonslack, dev)
        packed = _dc_core(topo, *_on(dev, bus, branch, base, p_sched), has_status,
                          slack).cpu().numpy()
        theta = packed[:, :n]
        pf = packed[:, n:]
        # slack balances the (lossless) system: its injection is total
        # load minus the other generators, recovered from the flows
        inc = np.zeros((n, len(f)), np.float32)
        np.add.at(inc, (f, np.arange(len(f))), 1.0)
        np.add.at(inc, (t, np.arange(len(t))), -1.0)
        p_slack = (pf @ inc[slack]) + bus[:, slack, 2] + bus[:, slack, 4]
        outs_th.append(np.rad2deg(theta))
        outs_pf.append(pf)
        outs_sl.append(p_slack)
    return {
        "theta_deg": np.concatenate(outs_th).astype(np.float32),
        "pf_mw": np.concatenate(outs_pf).astype(np.float32),
        "p_slack_mw": np.concatenate(outs_sl).astype(np.float32),
    }


def find_bridges(case: Dict) -> np.ndarray:
    """Branch rows whose outage ISLANDS the network (graph bridges of the
    in-service branch multigraph; a branch with an in-service parallel
    companion is never a bridge), by an iterative Tarjan search, O(N+E).
    gns_tpu keeps this in eval/contingency.py; the port's copy lives here
    until the screens are ported."""
    bus = np.asarray(case["bus"], float)
    br = np.asarray(case["branch"], float)
    n = bus.shape[0]
    f = br[:, 0].astype(int) - 1
    t = br[:, 1].astype(int) - 1
    status = br[:, 10] > 0 if br.shape[1] > 10 else np.ones(br.shape[0], bool)
    adj: List[list] = [[] for _ in range(n)]
    pair_count: Dict[tuple, int] = {}
    for i in np.flatnonzero(status):
        a, b = int(f[i]), int(t[i])
        adj[a].append((b, i))
        adj[b].append((a, i))
        key = (min(a, b), max(a, b))
        pair_count[key] = pair_count.get(key, 0) + 1

    disc = np.full(n, -1, np.int64)
    low = np.zeros(n, np.int64)
    out = []
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        # iterative DFS: stack of (node, parent-edge, next-child-pointer)
        stack = [(root, -1, 0)]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, pe, ptr = stack[-1]
            if ptr < len(adj[u]):
                stack[-1] = (u, pe, ptr + 1)
                vtx, ei = adj[u][ptr]
                if ei == pe:
                    continue
                if disc[vtx] == -1:
                    disc[vtx] = low[vtx] = timer
                    timer += 1
                    stack.append((vtx, ei, 0))
                else:
                    low[u] = min(low[u], disc[vtx])
            else:
                stack.pop()
                if stack:
                    p = stack[-1][0]
                    low[p] = min(low[p], low[u])
                    if low[u] > disc[p]:
                        key = (min(p, u), max(p, u))
                        if pair_count[key] == 1:
                            out.append(pe)
    return np.asarray(sorted(out), np.int64)


def lodf_matrix(case: Dict):
    """Line Outage Distribution Factors of `case` (numpy, float64).

    The classical linear screening operator: post-outage DC flow on branch
    l when branch k trips is f_l + LODF[l, k] * f_k, every branch outage's
    flow redistribution from one factorization. Built from the
    injection-shift (PTDF) matrix: S = B_f * inv(B_bus) (slack column
    zero), PTDF_br[l, k] = S[l, f_k] - S[l, t_k],
    LODF[l, k] = PTDF_br[l, k] / (1 - PTDF_br[k, k]), LODF[k, k] = -1.
    A bridge branch (find_bridges) has PTDF_br[k, k] -> 1: its column is
    returned as +inf (islanding).

    Islanding is decided by the structural bridge set, not by the numeric
    |1 - self-PTDF| residual; a non-bridge branch whose denominator is
    below 1e-6 (a near-radial branch paralleled by a very high-impedance
    path) is divided through as it is, as gns_tpu does (whether to flag
    such columns is an open question of the reference).
    """
    bus = np.asarray(case["bus"], np.float64)
    br = np.asarray(case["branch"], np.float64)
    n, e = bus.shape[0], br.shape[0]
    f = br[:, 0].astype(np.int64) - 1
    t = br[:, 1].astype(np.int64) - 1
    status = br[:, 10] if br.shape[1] > 10 else np.ones(e)
    tau = np.where(br[:, 8] == 0, 1.0, br[:, 8])
    b = status / (br[:, 3] * tau)
    types = bus[:, 1].astype(int)
    ns = np.flatnonzero(types != 3)

    bbus = np.zeros((n, n))
    np.add.at(bbus, (f, t), -b)
    np.add.at(bbus, (t, f), -b)
    np.add.at(bbus, (f, f), b)
    np.add.at(bbus, (t, t), b)
    bf = np.zeros((e, n))
    bf[np.arange(e), f] += b
    bf[np.arange(e), t] -= b

    s = np.zeros((e, n))
    s[:, ns] = np.linalg.solve(bbus[np.ix_(ns, ns)].T, bf[:, ns].T).T
    ptdf_br = s[:, f] - s[:, t]  # (E, E)
    denom = 1.0 - np.diag(ptdf_br)
    # a structural bridge's self-PTDF must be 1 up to float64 rounding
    bridge = np.zeros(e, bool)
    bridge[find_bridges(case)] = True
    near_one = np.abs(denom) < 1e-6
    if (bridge & ~near_one).any():
        raise AssertionError(
            "structural bridge with self-PTDF far from 1: inconsistent "
            f"branch data? rows {np.flatnonzero(bridge & ~near_one)}"
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        lodf = ptdf_br / np.where(bridge, 0.0, denom)[None, :]
    lodf[:, bridge] = np.inf
    lodf[np.arange(e), np.arange(e)] = -1.0
    return lodf


def dc_outage_severity(case: Dict, device="cuda") -> Dict[str, np.ndarray]:
    """Classical DC screening scores for every single-branch outage.

    One DC base solve (solve_batched_dc on `device`) and the LODF closed
    form give every outage's post-contingency flow pattern; severity
    scores per branch outage (+inf for bridges):
      "max_shift_mw" - largest absolute flow change on any surviving
                       branch,
      "overload_mw"  - largest post-outage loading above rateA (0 when the
                       table carries no rates).
    """
    dc = solve_batched_dc([case], device=device)
    f0 = dc["pf_mw"][0].astype(np.float64)
    lodf = lodf_matrix(case)
    e = f0.shape[0]
    with np.errstate(invalid="ignore"):
        post = f0[:, None] + lodf * f0[None, :]  # post[l, k]
    post[np.arange(e), np.arange(e)] = 0.0
    shift = np.abs(post - f0[:, None])
    shift[np.arange(e), np.arange(e)] = 0.0
    max_shift = shift.max(axis=0)
    br = np.asarray(case["branch"], np.float64)
    rate = br[:, 5] if br.shape[1] > 5 else np.zeros(e)
    rated = rate > 0
    overload = np.zeros(e)
    if rated.any():
        overload = np.maximum(
            np.abs(post[rated]) - rate[rated, None], 0.0
        ).max(axis=0)
    bridges = ~np.isfinite(lodf).all(axis=0)
    max_shift[bridges] = np.inf
    overload[bridges] = np.inf
    return {"max_shift_mw": max_shift, "overload_mw": overload,
            "islanded": bridges}
