"""Model FLOPs of the single-phi GNS (`multiple_phi` false), the
counterpart of lib/counts.py's multi-phi count, which the metrics divide
by the same peaks (lib/counts.py FP32_FLOPS).

2 x the multiply-adds of every MLP product the equations need: per step,
the one phi head (5 + latent -> hidden -> hidden -> 1) on every line, and
the three update heads on every bus, each at its full 4 + 2 x latent
input (quirk Q1 leaves all but column 0 of the phi sum zero, but the heads
read the whole of it); a training step counts 3 forwards (forward, and the
two products of each layer's backward). The physics refresh and the
aggregation adds are not counted.
"""

from __future__ import annotations

from benchmark.lib.counts import mlp_macs


def forward_flops(model: dict, n_bus: int, n_line: int) -> int:
    """Model FLOPs of one grid's K-step single-phi forward.
    model: {"K", "latent_dim", "hidden_dim"}."""
    k, lat, hid = model["K"], model["latent_dim"], model["hidden_dim"]
    phi_in, upd_in = 5 + lat, 4 + 2 * lat
    per_line = mlp_macs(phi_in, hid, 1)
    per_bus = 2 * mlp_macs(upd_in, hid, 1) + mlp_macs(upd_in, hid, lat)
    return 2 * k * (n_line * per_line + n_bus * per_bus)


def train_step_flops(model: dict, n_bus: int, n_line: int, batch: int) -> int:
    """Model FLOPs of one update step over `batch` grids."""
    return 3 * batch * forward_flops(model, n_bus, n_line)
