"""The benchmark's frozen grid generator and its plain grid preparation.

A copy, kept here so that no later change to the program can move the
yardstick, of the port's case300 recipe:

  * `synthetic_case300` is gns_torch/utils/cases.py `_synthetic_case(300)`:
    a deterministic grid at the IEEE 300-bus dimensions (300 buses, 411
    branches, 69 generators), a random spanning tree plus chords, from a
    generator fixed per case;
  * `augment_case` is gns_torch/utils/augment.py `augment_case` at scale
    1.0, the reference's recipe (GNS/augment_grids.py:25-54);
  * `prepare_case` restates the reference's unit contract
    (GNS/utils.py:17-41): paper shunts Gs = 1, Bs = -1, powers over
    baseMVA, tau 0 -> 1, phase shift in radians.

Only numpy is imported: the reference works from case dicts, never from
anything the program made of them.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np

CASE300_SIZES = (300, 411, 69)  # buses, branches, generators


def synthetic_case300() -> Dict:
    """The port's synthetic case300, number for number."""
    n_bus, n_branch, n_gen = CASE300_SIZES
    rng = np.random.default_rng(1_000_000 + 300)

    base_mva = 100.0
    bus = np.zeros((n_bus, 13), dtype=np.float64)
    bus[:, 0] = np.arange(1, n_bus + 1)
    bus[:, 1] = 1
    bus[:, 6] = 1
    bus[:, 7] = 1
    bus[:, 9] = 135.0
    bus[:, 10] = 1
    bus[:, 11] = 1.06
    bus[:, 12] = 0.94

    gen_buses = np.concatenate(
        [[1], 1 + rng.choice(np.arange(1, n_bus), size=n_gen - 1, replace=False)]
    )
    bus[0, 1] = 3
    bus[gen_buses[1:] - 1, 1] = 2

    load_mask = rng.random(n_bus) < 0.6
    load_mask[0] = False
    pd = np.where(load_mask, rng.uniform(5.0, 60.0, n_bus), 0.0)
    qd = pd * rng.uniform(0.2, 0.5, n_bus)
    bus[:, 2] = np.round(pd, 2)
    bus[:, 3] = np.round(qd, 2)

    gen = np.zeros((n_gen, 21), dtype=np.float64)
    gen[:, 0] = gen_buses
    total_load = bus[:, 2].sum()
    pg = rng.uniform(0.8, 1.2, n_gen)
    pg = pg / pg.sum() * total_load
    gen[:, 1] = np.round(pg, 2)
    gen[:, 3] = 300.0
    gen[:, 4] = -300.0
    gen[:, 5] = np.round(rng.uniform(1.0, 1.05, n_gen), 4)
    gen[:, 6] = base_mva
    gen[:, 7] = 1
    gen[:, 8] = np.round(pg * 2.5 + 50, 1)
    gen[:, 9] = 0.0

    edges = []
    for i in range(2, n_bus + 1):
        j = int(rng.integers(max(1, i - 8), i))
        edges.append((j, i))
    while len(edges) < n_branch:
        a = int(rng.integers(1, n_bus + 1))
        b = int(rng.integers(1, n_bus + 1))
        if a != b:
            edges.append((min(a, b), max(a, b)))
    edges = edges[:n_branch]

    branch = np.zeros((n_branch, 13), dtype=np.float64)
    branch[:, 0] = [e[0] for e in edges]
    branch[:, 1] = [e[1] for e in edges]
    branch[:, 2] = np.round(rng.uniform(0.005, 0.06, n_branch), 5)
    branch[:, 3] = np.round(rng.uniform(0.02, 0.25, n_branch), 5)
    branch[:, 4] = np.round(rng.uniform(0.0, 0.08, n_branch), 5)
    branch[:, 5:8] = 250.0
    branch[:, 8] = 0.0
    branch[:, 9] = 0.0
    branch[:, 10] = 1.0
    branch[:, 11] = -360.0
    branch[:, 12] = 360.0

    gencost = np.tile(np.array([2, 0, 0, 3, 0.01, 40, 0], dtype=np.float64), (n_gen, 1))
    return {"version": "2", "baseMVA": base_mva, "bus": bus, "gen": gen, "branch": branch,
            "gencost": gencost}


def augment_case(case: Dict, rng: np.random.Generator) -> Dict:
    """One perturbed copy of `case`, every draw elementwise and uniform, in
    the port's order: branch r, x, b scaled by [0.9, 1.1]; tau set in [0.8,
    1.2]; shift set in [-0.2, 0.2] degrees; vg scaled by [0.95, 1.05]; Pg
    drawn in (Pmin + 0.25 span, 0.75 span); Pd scaled by [0.5, 1.5] and
    rebalanced to the total Pg; Qd scaled by [0.5, 1.5]."""
    c = copy.deepcopy(case)
    bus = np.asarray(c["bus"], dtype=np.float64)
    branch = np.asarray(c["branch"], dtype=np.float64)
    gen = np.asarray(c["gen"], dtype=np.float64)
    nb, ne, ng = bus.shape[0], branch.shape[0], gen.shape[0]
    branch[:, 2] *= rng.uniform(0.9, 1.1, ne)
    branch[:, 3] *= rng.uniform(0.9, 1.1, ne)
    branch[:, 4] *= rng.uniform(0.9, 1.1, ne)
    branch[:, 8] = rng.uniform(0.8, 1.2, ne)
    branch[:, 9] = rng.uniform(-0.2, 0.2, size=ne)
    gen[:, 5] = gen[:, 5] * rng.uniform(0.95, 1.05, ng)
    span = gen[:, 8] - gen[:, 9]
    gen[:, 1] = rng.uniform(gen[:, 9] + 0.25 * span, 0.75 * span, size=ng)
    bus[:, 2] *= rng.uniform(0.5, 1.5, nb)
    total_pd = bus[:, 2].sum()
    if total_pd != 0:
        bus[:, 2] *= gen[:, 1].sum() / total_pd
    bus[:, 3] *= rng.uniform(0.5, 1.5, nb)
    c["bus"], c["branch"], c["gen"] = bus, branch, gen
    return c


def make_cases(base: Dict, count: int, seed: int) -> List[Dict]:
    """`count` augmented copies of `base`, drawn from one stream of `seed`
    (any whole number: large seeds are folded by numpy's SeedSequence)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 1]))
    return [augment_case(base, rng) for _ in range(count)]


def prepare_case(case: Dict):
    """(buses (N, 6), lines (E, 7), gens (G, 7)) float32 of one case dict:
    buses (bus_i, type, Pd, Qd, Gs, Bs), lines (f_bus, t_bus, r, x, b, tau,
    shift), gens (bus_i, Pmax, Pmin, Pg_set, vg, qg, Pg)."""
    base = np.float32(case["baseMVA"])
    bus = np.asarray(case["bus"], dtype=np.float32)
    buses = np.stack([bus[:, 0], bus[:, 1], bus[:, 2], bus[:, 3],
                      np.ones(len(bus), np.float32), -np.ones(len(bus), np.float32)], axis=1)
    buses[:, 2:6] /= base
    br = np.asarray(case["branch"], dtype=np.float32)
    tau = np.where(br[:, 8] == 0, np.float32(1.0), br[:, 8])
    lines = np.stack([br[:, 0], br[:, 1], br[:, 2], br[:, 3], br[:, 4], tau,
                      np.deg2rad(br[:, 9])], axis=1).astype(np.float32)
    g = np.asarray(case["gen"], dtype=np.float32)
    gens = np.stack([g[:, 0], g[:, 8] / base, g[:, 9] / base, g[:, 1] / base, g[:, 5],
                     g[:, 2] / base, g[:, 1] / base], axis=1).astype(np.float32)
    return buses, lines, gens


def stack_cases(cases: List[Dict]):
    """Stacked (S, ...) float32 arrays of cases that share one topology,
    with the 0-based (src, dst, gen_bus) index arrays; raises if the
    topologies differ (the reference runs one topology per block)."""
    triples = [prepare_case(c) for c in cases]
    buses = np.stack([t[0] for t in triples])
    lines = np.stack([t[1] for t in triples])
    gens = np.stack([t[2] for t in triples])
    ids = (lines[:, :, 0], lines[:, :, 1], gens[:, :, 0])
    if not all((a == a[:1]).all() for a in ids):
        raise ValueError("the reference takes blocks of grids with one shared topology")
    src, dst, gen_bus = (a[0].astype(np.int64) - 1 for a in ids)
    return buses, lines, gens, src, dst, gen_bus


def slack_angles(cases: List[Dict]):
    """(index of the first slack bus, its angle in radians) per case, or
    (-1, 0) where a case has no slack bus."""
    out = []
    for c in cases:
        bus = np.asarray(c["bus"], dtype=np.float64)
        slack = np.flatnonzero(bus[:, 1] == 3)
        out.append((int(slack[0]), float(np.deg2rad(bus[slack[0], 8]))) if slack.size
                   else (-1, 0.0))
    return out
