"""The benchmark's yardstick arithmetic: the H100's peaks, the model FLOPs
of a GNS forward and training step, and the least time of a K1 / K2
launch.

Peaks are NVIDIA's data-sheet numbers for one H100 SXM at its full 700 W
(dense rates): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM3. A card set below 700 W reaches less; the run prints its limit.

Model FLOPs are 2 x the multiply-adds of every MLP product the equations
need: per step, the three phi heads on every line and the three update
heads on every bus; a training step counts 3 forwards (forward, and the
two products of each layer's backward). The physics refresh and the
aggregation adds are not counted.

A launch's least time is its bytes at the HBM peak, each input byte read
once and each output byte written once: K1 (segment-sum) reads the kept
rows of its data, its order and indptr, and writes the float32 sums; K2
(gather) reads each distinct gathered row once and its ids, and writes
the gathered rows.
"""

from __future__ import annotations

FP32_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def mlp_macs(din: int, hidden: int, dout: int) -> int:
    """Multiply-adds of one row through a 3-layer MLP din -> H -> H -> dout."""
    return din * hidden + hidden * hidden + hidden * dout


def forward_flops(model: dict, n_bus: int, n_line: int) -> int:
    """Model FLOPs of one grid's K-step forward (multiple phi heads).
    model: {"K", "latent_dim", "hidden_dim"}."""
    k, lat, hid = model["K"], model["latent_dim"], model["hidden_dim"]
    phi_in, upd_in = 5 + lat, 4 + 2 * lat
    per_line = 3 * mlp_macs(phi_in, hid, lat)
    per_bus = 2 * mlp_macs(upd_in, hid, 1) + mlp_macs(upd_in, hid, lat)
    return 2 * k * (n_line * per_line + n_bus * per_bus)


def train_step_flops(model: dict, n_bus: int, n_line: int, batch: int) -> int:
    """Model FLOPs of one update step over `batch` grids."""
    return 3 * batch * forward_flops(model, n_bus, n_line)


def k1_bytes(s: int, kept: int, n: int, d: int, elem: int) -> int:
    """Bytes of one K1 launch: (s, rows, d) data of `elem` bytes, `kept`
    rows summed into n float32 segments."""
    return s * kept * d * elem + s * n * d * 4 + (kept + n + 1) * 4


def k2_bytes(s: int, distinct: int, e: int, d: int, elem: int) -> int:
    """Bytes of one K2 launch: `distinct` rows of (s, R, d) data gathered
    into e rows."""
    return s * distinct * d * elem + s * e * d * elem + e * 4


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
