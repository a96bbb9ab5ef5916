"""solve_ac: the one solver surface, with an automatic warm-start policy
(port of gns_tpu/eval/solve.py).

Three exact arms differ only in where the initial iterate comes from:

  * flat - the classical flat start (nr_batched.solve_batched),
  * prev - warm-started from a previous solution the caller already has
           (the tracking-solver pattern: re-solving a slightly changed
           system),
  * gns  - warm-started by the GNS prediction through the fused hybrid
           (eval/hybrid.py; it pays the forward, so it is the arm for when
           no previous solution exists but a trained model does).

`warm_start="auto"` resolves to prev when one is given, then gns when it
pays, flat otherwise. "When it pays" is gns_tpu's policy, kept as it is: on
a backend whose round trip (nr_batched.measured_dispatch_rtt) is at most
the 5 ms break-even, the gns arm always pays; on a slower one only from
_GNS_WARM_MIN_BUSES buses up.

`method` picks the solver: batched full Newton (nr_batched) or the batched
fast-decoupled solver (eval/fdpf.py: B'/B'' factored once, iterations are
matvecs). method="auto" resolves to fdpf, with a full-Newton flat-start
re-solve of any grid the decoupling fails. Under fdpf, auto resolves cold
starts to flat (the gns arm stays one explicit override away), as gns_tpu
does.

All arms return the same fixed point (Newton's root does not depend on its
start) and the same result schema, and all are protected by the flat-start
fallback: any grid a warm arm fails is re-solved flat and spliced in.
Whether this policy holds on the card is for the chip readings to show
(PERF.md); the port keeps gns_tpu's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from gns_torch.eval import nr_batched
from gns_torch.models.gns import GNS
from gns_torch.utils.config import GNSConfig
from gns_torch.utils.device import resolve_device

# Below this bus count, on a backend whose round trip is above the
# break-even, the gns arm's forward and round trips outweigh the saved
# iterations (gns_tpu's measured policy).
_GNS_WARM_MIN_BUSES = 100


def _gns_warm_pays(cases, device="cuda") -> bool:
    """auto's gns arm: always when a round trip on `device` costs at most
    the break-even; from _GNS_WARM_MIN_BUSES buses up otherwise."""
    if nr_batched.measured_dispatch_rtt(device) <= nr_batched._COMPACT_RTT_BREAKEVEN:
        return True
    return np.asarray(cases[0]["bus"]).shape[0] >= _GNS_WARM_MIN_BUSES


def _prev_as_tuple(prev, n_cases: int):
    """Accept a previous solution as either the result dict of a prior
    solve ({"v", "theta_deg"}) or a raw (v, theta_rad) tuple."""
    if isinstance(prev, dict):
        v = np.asarray(prev["v"], np.float32)
        th = np.deg2rad(np.asarray(prev["theta_deg"], np.float32))
    else:
        v = np.asarray(prev[0], np.float32)
        th = np.asarray(prev[1], np.float32)
    if v.shape[0] != n_cases:
        raise ValueError(f"previous solution covers {v.shape[0]} grids, got {n_cases}")
    return v, th


def solve_ac(
    cases: List[Dict],
    params: Optional[GNS] = None,
    cfg: Optional[GNSConfig] = None,
    prev: Union[None, Dict, Tuple[np.ndarray, np.ndarray]] = None,
    warm_start: str = "auto",
    method: str = "auto",
    tol: float = 3e-5,
    max_iter: int = 20,
    fdpf_max_iter: int = 60,
    chunk_size: int = 256,
    compact_after="auto",
    fallback_flat: bool = True,
    mesh=None,
    device="cuda",
) -> Dict:
    """Solve `cases` (shared topology) exactly; pick the warm start.

    params: the GNS module (gns_tpu's parameter pytree in the same place);
    it must lie on `device`.

    warm_start:
      "auto" (default) - "prev" if `prev` is given; else, under
          method="nr", "gns" if `params` are given and the gns arm pays
          (_gns_warm_pays); else "flat". Under the fast-decoupled method
          cold starts resolve to "flat". The resolved arm is recorded
          under "warm_start".
      "prev" - seed from `prev`: a previous solve's result dict (its
          "v" / "theta_deg") or a raw (v (S, N), theta_rad (S, N)) tuple.
          Only the free unknowns are seeded (PQ magnitudes, PV+PQ angles).
      "gns"  - the fused GNS hybrid (requires params + cfg).
      "flat" - plain flat start.

    method:
      "auto" (default) - the fast-decoupled solver (eval/fdpf.py), with a
          full-Newton flat-start re-solve spliced in for any grid the
          decoupling fails.
      "nr"   - batched full Newton everywhere.
      "fdpf" - the fast-decoupled solver (fallback_flat still applies and
          uses Newton).
    The resolved solver is recorded under "method". max_iter bounds Newton
    iterations; fdpf_max_iter bounds fast-decoupled half-step pairs.

    compact_after: per-grid convergence exit; "auto" (default) resolves
    against the measured round trip (nr_batched.resolve_compact_after).

    fallback_flat: any grid the warm arm fails is re-solved from the flat
    start and spliced in (reported via "fallback_grids").

    mesh: not ported (only None). device: "cuda" (default) or "cpu".

    Returns the solve_batched result schema plus "warm_start" (the resolved
    arm) and "compact_after" (the resolved exit point).
    """
    nr_batched.check_no_mesh(mesh)
    dev = resolve_device(device)
    if method == "auto":
        method = "fdpf"
    if method not in ("nr", "fdpf"):
        raise ValueError(f"method must be auto|nr|fdpf, got {method!r}")
    if warm_start == "auto":
        if prev is not None:
            warm_start = "prev"
        elif params is not None and method == "nr" and _gns_warm_pays(cases, dev):
            warm_start = "gns"
        else:
            warm_start = "flat"
    if warm_start not in ("prev", "gns", "flat"):
        raise ValueError(f"warm_start must be auto|prev|gns|flat, got {warm_start!r}")
    compact_after = nr_batched.resolve_compact_after(compact_after, device=dev)
    if method == "fdpf":
        from gns_torch.eval.fdpf import solve_batched_fdpf

        def _warm_solve(cs, ws=None):
            return solve_batched_fdpf(cs, tol=tol, max_iter=fdpf_max_iter,
                                      chunk_size=chunk_size, warm_start=ws, device=dev)
    else:
        def _warm_solve(cs, ws=None):
            return nr_batched.solve_batched(cs, tol=tol, max_iter=max_iter, chunk_size=chunk_size,
                                            warm_start=ws, compact_after=compact_after,
                                            device=dev)

    if warm_start == "gns":
        if params is None or cfg is None:
            raise ValueError("warm_start='gns' requires params and cfg")
        if next(params.parameters()).device != dev:
            raise ValueError(f"the model lies on {next(params.parameters()).device}, "
                             f"the solve runs on {dev}")
        from gns_torch.eval.hybrid import hybrid_solve

        out = hybrid_solve(
            params, cfg, cases, tol=tol,
            max_iter=fdpf_max_iter if method == "fdpf" else max_iter,
            chunk_size=chunk_size, compact_after=compact_after,
            fallback_flat=fallback_flat, solver=method,
        )
    else:
        ws = None
        if warm_start == "prev":
            if prev is None:
                raise ValueError("warm_start='prev' requires prev")
            ws = _prev_as_tuple(prev, len(cases))
        out = _warm_solve(cases, ws)
        # the fallback re-solve is ALWAYS batched full Newton from the flat
        # start, the most robust arm, so neither a bad previous solution
        # nor a decoupling failure ever costs a solution
        if (fallback_flat and (warm_start == "prev" or method == "fdpf")
                and not out["converged"].all()):
            from gns_torch.eval.hybrid import splice_fallback

            bad = np.flatnonzero(~out["converged"])
            flat = nr_batched.solve_batched([cases[i] for i in bad], tol=tol, max_iter=max_iter,
                                            chunk_size=chunk_size, device=dev)
            splice_fallback(out, bad, flat)
        elif "fallback_grids" not in out:
            out["fallback_grids"] = 0
            out["fallback_iterations"] = 0
    out["warm_start"] = warm_start
    out["method"] = method
    out["compact_after"] = compact_after
    return out
