"""Configuration: the same GNSConfig as gns_tpu/utils/config.py.

Field names, defaults and derived properties are identical, so a config
written for the JAX package means the same here. The field comments are
short; gns_tpu/utils/config.py carries the measurements behind each knob.
Fields that steer only the JAX package's compilation (`scan_unroll`,
`gather_method`) are kept for compatibility and have no effect here.
`remat=True` recomputes each K step in the backward
(torch.utils.checkpoint, models/gns.py); "auto" leaves it off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GNSConfig:
    """Hyperparameters of the GNS model + training driver.

    Defaults follow the reference's best configuration
    (reference README.md:16 — K=4, latent 20, hidden 10, multiple_phi).
    """

    # --- model (reference GNS/main.py:108) ---
    latent_dim: int = 20
    hidden_dim: int = 10
    K: int = 4
    gamma: float = 0.9
    multiple_phi: bool = True
    leaky_relu_slope: float = 0.01  # torch nn.LeakyReLU default

    # Reproduce the reference's numerics, quirks Q1-Q8 included
    # (SURVEY.md §2.4). False selects the paper-correct physics.
    reference_parity: bool = True

    # --- paper-mode physics conventions (require reference_parity=False) ---
    # Reactive generation only at generator buses (fixes quirk Q8).
    qg_gen_only: bool = False
    # "lambda" (scalar redispatch, the reference) or "setpoint_slack"
    # (generators hold set-points, the slack bus absorbs the imbalance).
    dispatch: str = "lambda"
    # Loss weight pinning the slack-bus angle to 0.
    slack_anchor: float = 0.0
    # Keep each case's own Gs/Bs shunts in data prep instead of the
    # reference's paper defaults.
    true_shunts: bool = False
    # Message MLPs see admittance (g, b_series, b, tau, shift) in place
    # of raw (r, x, b, tau, shift).
    admittance_inputs: bool = False
    # Loss weight of the (v - 1)^2 tie-breaker on non-generator buses.
    v_anchor: float = 0.0

    # --- training (reference GNS/main.py:235-254) ---
    case_nr: int = 14
    batch_size: int = 128
    nr_samples: int = 256
    epochs: int = 101
    optimizer: str = "adam"  # "adam" | "adagrad"
    learning_rate: Optional[float] = None  # None -> per-optimizer default
    warmup_steps: int = 0
    grad_clip: float = 0.0
    # Scale on the update heads' output-layer init (1.0 = torch default).
    init_correction_scale: float = 1.0
    early_stop_patience: int = 2
    seed: int = 0

    # --- execution ---
    dtype: str = "float32"
    # MLP compute dtype: "float32" or "bfloat16" (state and physics stay
    # float32).
    compute_dtype: str = "float32"
    # Fold the three phi heads and the three L heads into block MLPs.
    fused_heads: bool = True
    # Aggregate-then-project fold of the phi output layer; "auto" turns
    # it on for bfloat16 compute only.
    fold_output: str = "auto"
    gather_method: str = "auto"
    scan_unroll: int = 0
    remat: object = "auto"

    @property
    def resolved_fold_output(self) -> bool:
        if self.fold_output == "on":
            return True
        if self.fold_output == "off":
            return False
        if self.fold_output != "auto":
            raise ValueError(f"fold_output must be auto/on/off, got {self.fold_output!r}")
        return (
            self.fused_heads
            and self.multiple_phi
            and self.compute_dtype == "bfloat16"
        )

    @property
    def resolved_scan_unroll(self) -> int:
        if self.scan_unroll > 0:
            return self.scan_unroll
        return self.K if self.K <= 12 else 1

    @property
    def resolved_remat(self) -> bool:
        if isinstance(self.remat, bool):
            return self.remat
        if self.remat != "auto":
            raise ValueError(f"remat must be auto/True/False, got {self.remat!r}")
        return False

    @property
    def lr(self) -> float:
        if self.learning_rate is not None:
            return self.learning_rate
        # reference GNS/main.py:236-243 — Adam 1e-3, Adagrad 1e-2.
        return 0.01 if self.optimizer == "adagrad" else 0.001

    @property
    def phi_in_dim(self) -> int:
        return 5 + self.latent_dim

    @property
    def update_in_dim(self) -> int:
        return 4 + 2 * self.latent_dim

    def replace(self, **kw) -> "GNSConfig":
        return dataclasses.replace(self, **kw)


# Per-case presets (the same as gns_tpu's).
PRESETS = {
    "case14": GNSConfig(case_nr=14),
    "case9": GNSConfig(case_nr=9),
    "case30": GNSConfig(case_nr=30),
    "case118": GNSConfig(case_nr=118, batch_size=512, nr_samples=2048),
    "case300": GNSConfig(
        case_nr=300, K=8, latent_dim=40, batch_size=512, nr_samples=2048
    ),
    "eval_reference": GNSConfig(K=6, latent_dim=20, hidden_dim=10, multiple_phi=False),
}


def preset(name: str) -> GNSConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
