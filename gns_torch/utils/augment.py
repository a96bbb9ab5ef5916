"""Seeded augmentation: perturbed copies of a base case.

The port's copy of gns_tpu/utils/augment.py, drawing from the same numpy
RNG stream in the same order, so `generate_cases(c, n, seed)` yields the
same cases as the JAX package. Semantics (reference
GNS/augment_grids.py:25-54), every draw elementwise U[a, b]:

  * branch r, x, b scaled by U[0.9, 1.1]; tau overwritten with U[0.8, 1.2];
    theta_shift overwritten with U[-0.2, 0.2] degrees
  * gen vg scaled by U[0.95, 1.05]; Pg ~ U(Pmin + 0.25 span, 0.75 span)
  * bus Pd scaled by U[0.5, 1.5] and rebalanced to sum(Pg); Qd by U[0.5, 1.5]
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator

import numpy as np

from gns_torch.eval.newton_raphson import newton_raphson_pf
from gns_torch.utils import cases as case_tables

RANGES = {
    "r": (0.9, 1.1),
    "x": (0.9, 1.1),
    "b": (0.9, 1.1),
    "tau": (0.8, 1.2),
    "theta_shift": (-0.2, 0.2),
    "vg": (0.95, 1.05),
    "pg": (0.25, 0.75),
    "pd": (0.5, 1.5),
    "qd": (0.5, 1.5),
}


def augment_case(case: Dict, rng: np.random.Generator, scale: float = 1.0) -> Dict:
    """Return one perturbed copy of `case`.

    scale shrinks every range toward its no-op point (1.0 is the
    reference recipe; large cases need < 1 to stay AC-solvable).
    """

    def _mul(lo, hi, size):
        return rng.uniform(1.0 + (lo - 1.0) * scale, 1.0 + (hi - 1.0) * scale, size)

    c = copy.deepcopy(case)
    bus = np.asarray(c["bus"], dtype=np.float64)
    branch = np.asarray(c["branch"], dtype=np.float64)
    gen = np.asarray(c["gen"], dtype=np.float64)

    nb, ne, ng = bus.shape[0], branch.shape[0], gen.shape[0]
    branch[:, 2] *= _mul(*RANGES["r"], ne)
    branch[:, 3] *= _mul(*RANGES["x"], ne)
    branch[:, 4] *= _mul(*RANGES["b"], ne)
    branch[:, 8] = _mul(*RANGES["tau"], ne)
    sh_lo, sh_hi = RANGES["theta_shift"]
    branch[:, 9] = rng.uniform(sh_lo * scale, sh_hi * scale, size=ne)
    gen[:, 5] = gen[:, 5] * _mul(*RANGES["vg"], ng)
    span = gen[:, 8] - gen[:, 9]  # Pmax - Pmin
    lo, hi = RANGES["pg"]
    pg_draw = rng.uniform(gen[:, 9] + lo * span, hi * span, size=ng)
    gen[:, 1] = (1.0 - scale) * gen[:, 1] + scale * pg_draw
    bus[:, 2] *= _mul(*RANGES["pd"], nb)
    total_pd = bus[:, 2].sum()
    if total_pd != 0:
        bus[:, 2] *= gen[:, 1].sum() / total_pd
    bus[:, 3] *= _mul(*RANGES["qd"], nb)

    c["bus"], c["branch"], c["gen"] = bus, branch, gen
    return c


def generate_cases(
    case_nr: int,
    num_augmentations: int,
    seed: int = 0,
    feasible_only: bool = False,
    max_tries_per_case: int = 200,
    scale: float = 1.0,
) -> Iterator[Dict]:
    """Yield the base case (index 0) then `num_augmentations` perturbed cases.

    feasible_only: rejection-sample each augmentation until Newton-Raphson
    (eval/newton_raphson.py) converges on it, drawing from the one RNG
    stream, so the cases equal gns_tpu's for the same seed. Large cases
    leave the AC-solvable region for most draws at scale 1, and an
    accuracy-vs-oracle set must not hold a non-converged oracle iterate.
    """
    base = case_tables.load_case(case_nr)
    yield copy.deepcopy(base)
    rng = np.random.default_rng(seed)
    for _ in range(num_augmentations):
        if not feasible_only:
            yield augment_case(base, rng, scale=scale)
            continue
        for _try in range(max_tries_per_case):
            c = augment_case(base, rng, scale=scale)
            if newton_raphson_pf(c).success:
                yield c
                break
        else:
            raise RuntimeError(
                f"no NR-feasible augmentation of case{case_nr} in "
                f"{max_tries_per_case} tries: the perturbation ranges are "
                f"too violent for this case"
            )
