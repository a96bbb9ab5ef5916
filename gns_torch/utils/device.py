"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is "cuda", and a CUDA request on a machine without a GPU raises
instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gns_torch: no CUDA device is available. The port runs on the GPU "
            "by default; pass device='cpu' to run its plain PyTorch path."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
