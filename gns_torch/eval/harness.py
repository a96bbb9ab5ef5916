"""Evaluation helpers (port of gns_tpu/eval/harness.py; this slice carries
only the angle decode that serving needs)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def align_slack_angle(theta: np.ndarray, case: Dict) -> np.ndarray:
    """Shift a predicted angle vector so the slack bus hits its known angle.

    The physics residual is invariant under a global angle shift, so the
    network's raw angle gauge is arbitrary; the slack-bus angle is an input
    of the power-flow problem (Newton-Raphson holds it at the case's Va).
    Decoding into that gauge changes no angle difference, flow or residual.
    """
    bus = np.asarray(case["bus"], dtype=np.float64)
    slack = np.flatnonzero(bus[:, 1] == 3)
    if slack.size == 0:
        return theta
    i = int(slack[0])
    va_rad = float(np.deg2rad(bus[i, 8]))
    return theta - theta[i] + va_rad
