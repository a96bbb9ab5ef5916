"""Global active compensation: the scalar lambda redispatch (port of
gns_tpu/physics/compensation.py `_lambda_dispatch`; paper eqs. (20)-(21),
reference GNS/main.py:47-57). The data-dependent branches of the
reference (quirk Q5) are torch.where, per sample."""

from __future__ import annotations

from typing import Optional

import torch

from gns_torch.utils.schema import GEN


def _lambda_dispatch(p_global: torch.Tensor, gens: torch.Tensor,
                     gen_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """p_global (S,), gens (S, G, 7) -> Pg_new (S, G)."""
    pg_set = gens[..., GEN["Pg_set"]]
    pmin = gens[..., GEN["Pmin"]]
    pmax = gens[..., GEN["Pmax"]]
    if gen_mask is not None:
        pg_set, pmin, pmax = pg_set * gen_mask, pmin * gen_mask, pmax * gen_mask
    s_set, s_min, s_max = pg_set.sum(-1), pmin.sum(-1), pmax.sum(-1)

    lam_lo = (p_global - s_min) / (2.0 * (s_set - s_min))
    lam_hi = (p_global - 2.0 * s_set + s_max) / (2.0 * (s_max - s_set))
    lam = torch.where(p_global < s_set, lam_lo, lam_hi)[:, None]

    pg_lo = pmin + 2.0 * (pg_set - pmin) * lam
    pg_hi = 2.0 * pg_set - pmax + 2.0 * (pmax - pg_set) * lam
    pg_new = torch.where(lam < 0.5, pg_lo, pg_hi)
    if gen_mask is not None:
        pg_new = pg_new * gen_mask
    return pg_new
