"""Checkpoints: full training state for resuming, and the reference's .pth
layout (port of gns_tpu/train/checkpoint.py).

The reference saves bare `torch.save(model.state_dict())` with the
hyperparameters in the file name (GNS/main.py:308-309) and never keeps the
optimizer state. A checkpoint here is one `torch.save` file of the module's
state_dict, the optimizer state and the step count (the counterpart of
gns_tpu's Orbax checkpoint), so a resumed run continues bit for bit. The
GNS module's state_dict keys are the reference's own
(models/gns.py GNS), so `export_torch` / `import_torch` read and write the
reference layout directly.
"""

from __future__ import annotations

import torch

from gns_torch.models.gns import GNS
from gns_torch.train.trainer import TrainState, make_optimizer
from gns_torch.utils.config import GNSConfig


def checkpoint_name(cfg: GNSConfig) -> str:
    """Reference filename convention (GNS/main.py:308-309), minus extension."""
    opt = "Adam" if cfg.optimizer == "adam" else "Adagrad"
    return (
        f"best_model_c{cfg.case_nr}_K{cfg.K}_L{cfg.latent_dim}"
        f"_H{cfg.hidden_dim}_{cfg.multiple_phi}_optim{opt}"
    )


def _cpu(x):
    if isinstance(x, list):
        return [t.detach().cpu().clone() for t in x]
    return x.detach().cpu().clone()


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the module's state_dict, the optimizer state and the step."""
    torch.save(
        {
            "model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "opt_state": {k: _cpu(v) for k, v in state.opt_state.items()},
            "step": _cpu(state.step),
        },
        path,
    )


def load_checkpoint(path: str, cfg: GNSConfig, device="cuda") -> TrainState:
    """Restore a save_checkpoint file onto `device`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = GNS(cfg, device=device)
    model.load_state_dict(ckpt["model"])
    dev = next(model.parameters()).device
    opt = {k: ([t.to(dev) for t in v] if isinstance(v, list) else v.to(dev))
           for k, v in ckpt["opt_state"].items()}
    return TrainState(model, opt, ckpt["step"].to(dev))


def export_torch(path: str, state: TrainState, cfg: GNSConfig) -> None:
    """Write the parameters as a reference-layout .pth (a torch.save
    state_dict)."""
    torch.save({k: v.detach().cpu().contiguous().clone()
                for k, v in state.model.state_dict().items()}, path)


def import_torch(path: str, cfg: GNSConfig, device="cuda") -> TrainState:
    """A fresh TrainState (new optimizer state, step 0) around the weights
    of a reference .pth."""
    model = GNS(cfg, device=device)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    dev = next(model.parameters()).device
    return TrainState(model, make_optimizer(cfg).init(model.parameters()),
                      torch.zeros((), dtype=torch.int32, device=dev))
