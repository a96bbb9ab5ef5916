"""N-1 contingency screening: every single-outage variant in one batched
solve per bus-type group (port of gns_tpu/eval/contingency.py).

After any change to a power system its operator re-solves it with each
element knocked out and checks the post-contingency state. An outage only
zeroes the branch (or generator) STATUS column and leaves the endpoint
index arrays untouched, so the N-1 variants of one case share their
topology and solve as one batch per bus-type group (eval/nr_batched.py,
eval/fdpf.py: admittance assembly on the device over K1, the
fast-decoupled injections over K1 / K2, one packed fetch per chunk),
optionally warm-started by the GNS prediction through the fused hybrid
(eval/hybrid.py). Branch outages never change bus types (one group);
generator outages that strip a bus of its last in-service generator
convert it PV -> PQ (pypower bustypes semantics) and solve as their own
small groups.

Islanding is reported, not hidden: removing a bridge branch disconnects
part of the network, the Jacobian (or B') goes singular, and the solve
reports that contingency as non-converged, the "needs operator attention"
flag a screen must raise.

The groups run one after another in the calling thread (gns_tpu overlaps
them on a thread pool to hide its relay's fetch round trips; here each
solve loop reads its exit test from the device every iteration, the
kernels' library is loaded without a lock and the launch counters are
plain integers). Results carry "host_syncs": the exit tests and fetches
of every solve (and, in the ranked screen, the predictor's fetches).

The host functions (n1_variants, find_bridges, ac_branch_flows,
ac_branch_loading, flow_violations) are float64 numpy, the port's own
copy of gns_tpu's.

Usage:
    from gns_torch.eval.contingency import screen_n1
    rep = screen_n1(case)                          # on "cuda"
    rep = screen_n1(case, params=model, cfg=cfg)   # GNS-warm-started
    rep["converged"], rep["v_min"], rep["v_violations"]
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from gns_torch.eval.nr_batched import f32_matmuls, solve_batched
from gns_torch.eval.solve import solve_ac
from gns_torch.models.gns import GNS
from gns_torch.parallel.solver_dp import dp_size, padded_rows
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device


def n1_variants(
    case: Dict,
    branch_outages: bool = True,
    gen_outages: bool = False,
    encode_impedance: bool = False,
    gen_pq_conversion: bool = True,
) -> List[Dict]:
    """All single-outage variants of `case` (shared-topology by design).

    Each variant zeroes one status column (branch col 10 / gen col 7), so
    endpoint and generator index arrays are identical across the set and
    the batched solver's shared-topology contract holds. Outages of the
    slack generator are skipped (no reference bus, the problem is
    undefined). Each variant dict carries an "outage" key ("branch", i) /
    ("gen", i) for reporting.

    gen_pq_conversion (default True): a bus whose LAST in-service
    generator is outaged loses voltage control; pypower/MATPOWER's
    bustypes converts it from PV to PQ, and the variant here does the same
    (solving it as PV would hold the set-point magnitude with implicit
    unbounded reactive support). These variants carry different bus types
    than the rest, so screen_n1 groups them into their own batched solve.

    encode_impedance: additionally set the outaged branch's r=x=1e6, b=0.
    The Newton solution is unchanged (status already zeroes its
    admittance), but the outage becomes VISIBLE to the GNS, whose input
    schema has no status column; in admittance space
    (GNSConfig.admittance_inputs) the encoding is a well-scaled zero, the
    representation the outage-aware models are trained on.
    """
    out = []
    if branch_outages:
        for i in range(np.asarray(case["branch"]).shape[0]):
            v = copy.deepcopy(case)
            v["branch"] = np.asarray(v["branch"], np.float64).copy()
            if v["branch"].shape[1] <= 10:
                raise ValueError("case branch table has no status column")
            v["branch"][i, 10] = 0.0
            if encode_impedance:
                v["branch"][i, 2] = 1e6
                v["branch"][i, 3] = 1e6
                v["branch"][i, 4] = 0.0
            v["outage"] = ("branch", i)
            out.append(v)
    if gen_outages:
        bus = np.asarray(case["bus"])
        gen = np.asarray(case["gen"], np.float64)
        slack_bus = int(bus[np.flatnonzero(bus[:, 1] == 3)[0], 0])
        gstat = gen[:, 7] if gen.shape[1] > 7 else np.ones(gen.shape[0])
        for i in range(gen.shape[0]):
            gbus = int(gen[i, 0])
            if gbus == slack_bus:
                continue  # removing the slack leaves no reference bus
            v = copy.deepcopy(case)
            v["gen"] = gen.copy()
            v["gen"][i, 7] = 0.0
            if gen_pq_conversion and gstat[i] > 0:
                others_on = (
                    (gen[:, 0].astype(int) == gbus) & (gstat > 0)
                ).sum() > 1
                if not others_on:
                    v["bus"] = np.asarray(v["bus"], np.float64).copy()
                    row = np.flatnonzero(
                        v["bus"][:, 0].astype(int) == gbus
                    )[0]
                    if int(v["bus"][row, 1]) == 2:  # PV -> PQ
                        v["bus"][row, 1] = 1.0
            v["outage"] = ("gen", i)
            out.append(v)
    return out


def _by_signature(variants: List[Dict], idx: Sequence[int]) -> Dict[bytes, list]:
    """Positions in `idx` grouped by their variant's bus-type signature
    (the shared-topology contract holds per group), in first-seen order."""
    sigs: Dict[bytes, list] = {}
    for j, i in enumerate(idx):
        key = np.asarray(variants[i]["bus"])[:, 1].astype(np.int8).tobytes()
        sigs.setdefault(key, []).append(j)
    return sigs


def screen_n1(
    case: Dict,
    branch_outages: bool = True,
    gen_outages: bool = False,
    tol: float = 3e-5,
    max_iter: int = 20,
    compact_after: int = 3,
    method: str = "auto",
    warm: str = "base",
    params: Optional[GNS] = None,
    cfg: Optional[GNSConfig] = None,
    encode_impedance: bool = False,
    gen_pq_conversion: bool = True,
    v_limits=(0.94, 1.06),
    mesh=None,
    device="cuda",
) -> Dict:
    """Screen every single outage of `case`; one batched solve per
    bus-type group.

    warm="base" (default): solve the PRE-contingency case once and seed
    every variant with its solution, the classical tracking start (mild
    outages barely move the state). warm="flat": plain flat starts. With
    `params` (the GNS module, on `device`) and `cfg` the GNS prediction
    warm-starts through the fused hybrid instead; the GNS input schema
    carries no branch-status column, so its prediction approximates the
    pre-contingency state. method="auto" resolves the solver to the
    fast-decoupled loop (eval/fdpf.py), "nr" to full Newton;
    compact_after=3 applies to Newton only (islanded variants never
    converge, so lock-step would spin the whole batch to max_iter on their
    account). Non-converged contingencies are reported as the islanding
    signal, with one guard: structural bridges are the only outages that
    cannot converge, so a non-bridge failure (e.g. a fast-decoupled stall
    on a high-r/x grid) gets ONE full-Newton flat re-solve before the
    verdict; islanded variants are never re-solved.

    Returns {
      "outages":       list of ("branch"|"gen", index),
      "converged":     (C,) bool, False flags islanding/divergence,
      "iterations_per_grid": (C,) int,
      "mismatch":      (C,) each contingency's final max |f| (p.u.), which
                       tells tol-converged grids from stall-accepted ones,
      "v":             (C, N) solved magnitudes,
      "theta_deg":     (C, N),
      "v_min"/"v_max": (C,) per-contingency extremes (converged only;
                       NaN otherwise),
      "v_violations":  (C,) int, PQ (load) buses outside v_limits per
                       contingency, using each VARIANT's own bus types (a
                       PV bus converted to PQ by its generator's outage
                       counts); generator-bus magnitudes are set-points,
                       not solved values,
      "flow_violations": (C,) int, branches whose exact AC apparent-power
                       loading exceeds their published rating (rateA; see
                       `flow_violations`),
      "branch_loading_mva": (C, E) max(|S_f|, |S_t|) per branch,
      "max_loading_frac": (C,) worst loading / rating over rated branches,
      "worst":         indices of non-converged + voltage- or
                       flow-violating contingencies,
      "host_syncs":    exit tests and fetches of every solve,
    }

    mesh: a DeviceMesh with a "dp" axis (parallel/solver_dp.py): every
    group's solve and every rescue is sharded over it (the one-grid base
    solve is not), and every rank returns the whole screen. device:
    "cuda" (default) or "cpu"; under a mesh, this rank's device.
    """
    dev = resolve_device(device)
    f32_matmuls()
    dp_size(mesh)
    variants = n1_variants(
        case, branch_outages, gen_outages,
        encode_impedance=encode_impedance,
        gen_pq_conversion=gen_pq_conversion,
    )
    if not variants:
        raise ValueError("no contingencies to screen")
    if params is not None and cfg is None:
        raise ValueError("cfg is required when params are given")
    if params is None and warm not in ("base", "flat"):
        raise ValueError(f"warm must be 'base' or 'flat', got {warm!r}")

    syncs = 0
    base_sol = None
    if params is None and warm == "base":
        base = solve_batched([case], tol=tol, max_iter=max_iter, device=dev)  # one grid
        syncs += base["host_syncs"]
        if base["converged"][0]:
            base_sol = (base["v"], np.deg2rad(base["theta_deg"]))

    c = len(variants)
    n = np.asarray(case["bus"]).shape[0]
    conv = np.zeros(c, bool)
    v = np.full((c, n), np.nan, np.float32)
    theta = np.full((c, n), np.nan, np.float32)
    itg = np.zeros(c, np.int32)
    mismatch = np.zeros(c, np.float32)

    def solve_group(idx):
        group = [variants[i] for i in idx]
        # fallback_flat=False throughout: an islanded variant fails from
        # ANY start, so a flat re-solve would only burn a solve;
        # non-convergence is the screen's signal, not an error
        common = dict(method=method, tol=tol, max_iter=max_iter, chunk_size=len(group),
                      compact_after=compact_after, mesh=mesh, device=dev)
        if params is not None:
            return solve_ac(group, params=params, cfg=cfg, warm_start="gns",
                            fallback_flat=False, **common)
        if base_sol is not None:
            s = len(group)
            return solve_ac(
                group, warm_start="prev",
                prev=(np.repeat(base_sol[0], s, axis=0), np.repeat(base_sol[1], s, axis=0)),
                fallback_flat=False, **common,
            )
        return solve_ac(group, warm_start="flat", **common)

    for idx in _by_signature(variants, range(c)).values():
        res = solve_group(idx)
        ii = np.asarray(idx)
        conv[ii] = res["converged"]
        v[ii] = res["v"]
        theta[ii] = res["theta_deg"]
        itg[ii] = res["iterations_per_grid"]
        mismatch[ii] = res["mismatch"]
        syncs += res["host_syncs"]

    # Non-convergence reads as islanding, but the fast-decoupled solver can
    # fail on non-islanded variants full Newton handles (high r/x ratios
    # break the B'/B'' decoupling). Structural bridges are the only outages
    # that CANNOT converge (gen outages never island), so any other failure
    # gets one full-Newton flat re-solve before it is reported.
    if method != "nr" and (~conv).any():
        bridge_rows = set(find_bridges(case).tolist()) if branch_outages else set()
        retry = [
            i for i in np.flatnonzero(~conv)
            if not (variants[i]["outage"][0] == "branch"
                    and variants[i]["outage"][1] in bridge_rows)
        ]
        # regroup by bus-type signature (the retry set can mix PV->PQ
        # converted gen-outage variants with base-typed ones)
        for rows in _by_signature(variants, retry).values():
            ridx = [retry[j] for j in rows]
            res = solve_ac(
                [variants[i] for i in ridx], warm_start="flat",
                method="nr", tol=tol, max_iter=max_iter,
                chunk_size=len(ridx), compact_after=compact_after, mesh=mesh, device=dev,
            )
            syncs += res["host_syncs"]
            ok = np.flatnonzero(res["converged"])
            ii = np.asarray(ridx)[ok]
            conv[ii] = True
            v[ii] = res["v"][ok]
            theta[ii] = res["theta_deg"][ok]
            itg[ii] += res["iterations_per_grid"][ok]
            mismatch[ii] = res["mismatch"][ok]

    lo, hi = v_limits
    v_min = np.full(c, np.nan, np.float32)
    v_max = np.full(c, np.nan, np.float32)
    if conv.any():
        v_min[conv] = v[conv].min(axis=1)
        v_max[conv] = v[conv].max(axis=1)
    # per-VARIANT load-bus mask: a PQ-converted bus is a solved magnitude
    # in its own variant and counts toward violations there
    is_pq = np.stack([np.asarray(va["bus"])[:, 1] == 1 for va in variants])
    viol = np.where(
        conv, (((v < lo) | (v > hi)) & is_pq).sum(axis=1), 0
    ).astype(np.int32)
    fl_viol, loading, max_frac = flow_violations(variants, v, theta)
    worst = np.flatnonzero(~conv | (viol > 0) | (fl_viol > 0))
    return {
        "outages": [va["outage"] for va in variants],
        "converged": conv,
        "iterations_per_grid": itg,
        "mismatch": mismatch,
        "v": v,
        "theta_deg": theta,
        "v_min": v_min,
        "v_max": v_max,
        "v_violations": viol,
        "flow_violations": fl_viol,
        "branch_loading_mva": loading,
        "max_loading_frac": max_frac,
        "worst": worst,
        "host_syncs": syncs,
    }


def ac_branch_flows(variants: List[Dict], v: np.ndarray,
                    theta_deg: np.ndarray):
    """Exact complex AC branch flows (MVA) at solved states.

    MATPOWER conventions: S_f = V_f (y_ff V_f + y_ft V_t)*,
    S_t = V_t (y_tf V_f + y_tt V_t)*, both scaled to MVA. Shapes:
    v/theta_deg (C, N) over C variants (each with its OWN branch table; an
    outaged branch has status 0 and flows 0); returns (sf, st) each (C, E)
    complex128. Re(sf + st) summed over branches is the system's series
    losses (case30's published solution: 17.557 MW). Rows with NaN states
    (non-converged variants) propagate NaN. float64 numpy on the host.
    """
    br0 = np.asarray(variants[0]["branch"], np.float64)
    e = br0.shape[0]
    c = len(variants)
    f = br0[:, 0].astype(np.int64) - 1
    t = br0[:, 1].astype(np.int64) - 1
    branch = np.stack(
        [np.asarray(va["branch"], np.float64) for va in variants]
    )
    base = np.array([va["baseMVA"] for va in variants], np.float64)
    status = branch[:, :, 10] if br0.shape[1] > 10 else np.ones((c, e))
    ys = status / (branch[:, :, 2] + 1j * branch[:, :, 3])
    bc = status * branch[:, :, 4]
    tap = np.where(branch[:, :, 8] == 0, 1.0, branch[:, :, 8]) * np.exp(
        1j * np.deg2rad(branch[:, :, 9])
    )
    ytt = ys + 1j * bc / 2.0
    yff = ytt / (tap * np.conj(tap))
    yft = -ys / np.conj(tap)
    ytf = -ys / tap

    vc = v.astype(np.float64) * np.exp(
        1j * np.deg2rad(theta_deg.astype(np.float64))
    )
    vf, vt = vc[:, f], vc[:, t]
    sf = vf * np.conj(yff * vf + yft * vt) * base[:, None]
    st = vt * np.conj(ytf * vf + ytt * vt) * base[:, None]
    return sf, st


def ac_branch_loading(variants: List[Dict], v: np.ndarray,
                      theta_deg: np.ndarray) -> np.ndarray:
    """max(|S_f|, |S_t|) per branch (MVA), the quantity MVA ratings
    (branch col 5, rateA) limit. (C, E); see `ac_branch_flows`."""
    sf, st = ac_branch_flows(variants, v, theta_deg)
    return np.maximum(np.abs(sf), np.abs(st))


def flow_violations(variants: List[Dict], v: np.ndarray,
                    theta_deg: np.ndarray, rate_cap: float = 9000.0):
    """Count per-variant branch MVA-limit violations at solved states.

    Returns (counts (C,) int32, loading (C, E) MVA, max_loading_frac
    (C,)). A branch is violated when its loading exceeds its rateA
    (branch col 5). Branches with rateA <= 0 or >= `rate_cap` are UNRATED:
    pypower ships 9900 as "effectively unlimited" on case14/case118 (only
    case9/case30 publish real limits, utils/cases.py). NaN rows
    (non-converged variants) count 0 and report NaN loading.
    """
    loading = ac_branch_loading(variants, v, theta_deg)
    rate = np.stack([
        np.asarray(va["branch"], np.float64)[:, 5] for va in variants
    ])
    rated = (rate > 0) & (rate < rate_cap)
    with np.errstate(invalid="ignore"):
        over = rated & (loading > rate)
        frac = np.where(rated, loading / np.where(rated, rate, 1.0), 0.0)
    nan_rows = np.isnan(loading).any(axis=1)
    counts = np.where(nan_rows, 0, over.sum(axis=1)).astype(np.int32)
    max_frac = np.where(
        nan_rows, np.nan, frac.max(axis=1)
    ).astype(np.float32)
    return counts, loading.astype(np.float32), max_frac


def find_bridges(case: Dict) -> np.ndarray:
    """Branch rows whose outage ISLANDS the network (graph bridges).

    Islanding is graph-structural, not electrical: removing a bridge of
    the in-service branch multigraph disconnects buses, the power-flow
    Jacobian goes singular, and NO solver converges from any start. The
    ranked screen therefore flags these exactly, with an iterative Tarjan
    bridge search (O(N+E)) instead of Newton iterations per variant (a
    branch with an in-service parallel companion is never a bridge).
    """
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


def screen_n1_ranked(
    case: Dict,
    params: GNS,
    cfg: GNSConfig,
    branch_outages: bool = True,
    gen_outages: bool = False,
    top_k: int = 32,
    tol: float = 3e-5,
    max_iter: int = 20,
    compact_after: int = 3,
    method: str = "auto",
    encode_impedance: bool = True,
    gen_pq_conversion: bool = True,
    v_limits=(0.94, 1.06),
    batch_size: Optional[int] = None,
    mesh=None,
    device="cuda",
) -> Dict:
    """GNS-ranked N-1 screen: predict ALL, Newton-verify only the top-k.

      1. STRUCTURAL: islanding outages are flagged exactly by graph bridge
         detection (`find_bridges`): no model, no Newton; they go straight
         to "worst".
      2. RANK: ONE batched GNS forward (GNSPredictor on `device`) over
         every variant plus the intact case; severity = rms deviation of
         the predicted voltage profile from the model's OWN intact-grid
         prediction (the difference cancels its per-bus bias). The
         predicted violation depth ships alongside as "pred_violation_pu".
      3. VERIFY: the `top_k` most severe rankable variants are solved
         exactly, warm-started by the predictions already in hand.

    Requires an outage-AWARE model (GNSConfig.admittance_inputs trained on
    outage-augmented grids: the `*-n1` checkpoints); encode_impedance=True
    (default) feeds that representation. `params` is the GNS module.

    Returns {
      "outages", "severity" (C,; +inf for islanding),
      "islanded" (C,) bool, the stage-1 structural flags,
      "order" (C, descending severity; islanding first),
      "verified_idx" (k,), the contingencies sent to the exact solver,
      "converged"/"iterations_per_grid"/"v"/"theta_deg"/"v_violations"/
          "v_min", exact results on the verified subset (NaN/0 elsewhere),
      "pred_v"/"pred_theta_deg"/"pred_violation_pu", the GNS view of ALL
          variants,
      "worst", islanded outages + verified indices that violate,
      "n_newton_solves", the exact-solve budget spent,
      "host_syncs", the predictor's fetches and the verify solves' syncs,
    }

    mesh: a DeviceMesh with a "dp" axis: the forward's batch is sharded
    over it (the default batch, c + 1, rounded up to a dp multiple) and
    so are the verify solves. device: "cuda" (default) or "cpu"; under a
    mesh, this rank's device.
    """
    from gns_torch.serve import GNSPredictor

    dev = resolve_device(device)
    f32_matmuls()
    dp_size(mesh)
    variants = n1_variants(
        case, branch_outages, gen_outages,
        encode_impedance=encode_impedance,
        gen_pq_conversion=gen_pq_conversion,
    )
    c = len(variants)
    if not variants:
        raise ValueError("no contingencies to screen")

    # stage 1: exact structural islanding flags
    bridge_rows = set(find_bridges(case).tolist()) if branch_outages else set()
    islanded = np.array(
        [va["outage"][0] == "branch" and va["outage"][1] in bridge_rows
         for va in variants]
    )

    # stage 2: one batched forward over variants + the intact case (the
    # intact prediction is the bias-cancelling reference for severity)
    bs = batch_size or padded_rows(c + 1, mesh)
    predictor = GNSPredictor(params, cfg, batch_size=bs, align_slack=True, mesh=mesh,
                             device=dev)
    pred = predictor.predict(variants + [case])
    syncs = 3 * -(-(c + 1) // bs)  # v, theta, last_loss fetched per batch
    pv, pth = pred["v"][:c], pred["theta"][:c]
    v_base = pred["v"][c]
    sev = np.sqrt(((pv - v_base[None, :]) ** 2).mean(axis=1)).astype(
        np.float64
    )
    lo, hi = v_limits
    is_pq = np.stack([np.asarray(va["bus"])[:, 1] == 1 for va in variants])
    pred_viol = (
        (np.maximum(lo - pv, 0.0) + np.maximum(pv - hi, 0.0)) * is_pq
    ).sum(axis=1)
    sev[islanded] = np.inf  # flagged exactly; ranked above everything
    order = np.argsort(-sev, kind="stable").astype(np.int64)

    # stage 3: verify the top-k RANKABLE variants (islanding needs no
    # verification: there is nothing to converge to)
    rankable = order[~islanded[order]]
    top_k = min(top_k, rankable.size)
    verified_idx = np.sort(rankable[:top_k])

    n = np.asarray(case["bus"]).shape[0]
    conv = np.zeros(c, bool)
    v = np.full((c, n), np.nan, np.float32)
    theta = np.full((c, n), np.nan, np.float32)
    itg = np.zeros(c, np.int32)
    viol = np.zeros(c, np.int32)
    v_min = np.full(c, np.nan, np.float32)
    if top_k:
        sub = _verify_subset(
            variants, verified_idx, {"v": pv, "theta": pth},
            tol, max_iter, compact_after, method=method, mesh=mesh, device=dev,
        )
        syncs += sub["host_syncs"]
        conv[verified_idx] = sub["converged"]
        itg[verified_idx] = sub["iterations_per_grid"]
        v[verified_idx] = sub["v"]
        theta[verified_idx] = sub["theta_deg"]
        for i in verified_idx:
            if not conv[i]:
                continue
            viol[i] = int((((v[i] < lo) | (v[i] > hi)) & is_pq[i]).sum())
            v_min[i] = v[i].min()
    # MVA screening on the verified subset (NaN rows, unverified or
    # non-converged, count zero)
    fl_viol, loading, max_frac = flow_violations(variants, v, theta)
    worst = np.flatnonzero(
        islanded
        | (np.isin(np.arange(c), verified_idx)
           & (~conv | (viol > 0) | (fl_viol > 0)))
    )
    return {
        "outages": [va["outage"] for va in variants],
        "severity": sev,
        "islanded": islanded,
        "order": order,
        "verified_idx": verified_idx,
        "converged": conv,
        "iterations_per_grid": itg,
        "v": v,
        "theta_deg": theta,
        "v_violations": viol,
        "flow_violations": fl_viol,
        "branch_loading_mva": loading,
        "max_loading_frac": max_frac,
        "v_min": v_min,
        "pred_v": pv,
        "pred_theta_deg": np.rad2deg(pth).astype(np.float32),
        "pred_violation_pu": pred_viol,
        "worst": worst,
        "n_newton_solves": int(top_k),
        "host_syncs": syncs,
    }


def _verify_subset(
    variants: List[Dict],
    idx: Sequence[int],
    pred: Dict,
    tol: float,
    max_iter: int,
    compact_after,
    method: str = "auto",
    mesh=None,
    device="cuda",
) -> Dict:
    """Solve the selected variants exactly, warm-started by the GNS
    prediction already in hand (no second forward), grouped by bus-type
    signature like screen_n1. Results in `idx` order ("converged", "v",
    "theta_deg", "iterations_per_grid"), plus "host_syncs". mesh: the
    solves' dp mesh, or None."""
    idx = np.asarray(idx)
    n = pred["v"].shape[1]
    out = {
        "converged": np.zeros(idx.size, bool),
        "v": np.full((idx.size, n), np.nan, np.float32),
        "theta_deg": np.full((idx.size, n), np.nan, np.float32),
        "iterations_per_grid": np.zeros(idx.size, np.int32),
        "host_syncs": 0,
    }
    for rows in _by_signature(variants, idx).values():
        rows = np.asarray(rows)
        gidx = idx[rows]
        res = solve_ac(
            [variants[i] for i in gidx],
            warm_start="prev",
            prev=(pred["v"][gidx], pred["theta"][gidx]),
            method=method,
            tol=tol, max_iter=max_iter, chunk_size=len(gidx),
            compact_after=compact_after, fallback_flat=False, mesh=mesh, device=device,
        )
        out["converged"][rows] = res["converged"]
        out["v"][rows] = res["v"]
        out["theta_deg"][rows] = res["theta_deg"]
        out["iterations_per_grid"][rows] = res["iterations_per_grid"]
        out["host_syncs"] += res["host_syncs"]
    # Callers verify only non-islanded variants (stage 1 filtered the
    # bridges), so ANY failure here is solver-side (a bad warm start, a
    # fast-decoupled stall on high-r/x branches) and gets one full-Newton
    # flat re-solve before it is reported (cf. screen_n1's rescue).
    if method != "nr" and (~out["converged"]).any():
        bad = np.flatnonzero(~out["converged"])
        for sub in _by_signature(variants, idx[bad]).values():
            rows = bad[np.asarray(sub)]
            res = solve_ac(
                [variants[i] for i in idx[rows]], warm_start="flat",
                method="nr", tol=tol, max_iter=max_iter,
                chunk_size=len(rows), compact_after=compact_after, mesh=mesh,
                device=device,
            )
            out["host_syncs"] += res["host_syncs"]
            ok = np.flatnonzero(res["converged"])
            out["converged"][rows[ok]] = True
            out["v"][rows[ok]] = res["v"][ok]
            out["theta_deg"][rows[ok]] = res["theta_deg"][ok]
            out["iterations_per_grid"][rows[ok]] += res["iterations_per_grid"][ok]
    return out
