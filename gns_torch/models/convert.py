"""Weight layouts: reference state_dicts, stacked-K parameter trees, modules.

Port of gns_tpu/models/import_torch.py. The JAX package keeps its weights
as a pytree of stacked-K arrays in (in, out) layout ({"phi_v": {"w1":
(K, in, out), "b1": (K, out), ...}, ...}); the reference and this
package's GNS module keep torch's (out, in) layout under keys like
`phi_v.0.linear1.weight`. These functions move weights between the three,
as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gns_torch.models.gns import GNS, head_dims
from gns_torch.utils.config import GNSConfig

_LAYER_TO_PARAM = {"linear1": ("w1", "b1"), "linear2": ("w2", "b2"), "linear4": ("w4", "b4")}


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def params_from_state_dict(state_dict: Dict, cfg: GNSConfig):
    """Reference-layout state_dict (tensors or arrays) -> stacked-K tree
    in (in, out) layout, the layout of gns_tpu's parameters."""
    params = {}
    for mod, _, _ in head_dims(cfg):
        block = {}
        for layer, (wname, bname) in _LAYER_TO_PARAM.items():
            block[wname] = np.stack([
                _to_np(state_dict[f"{mod}.{k}.{layer}.weight"]).T for k in range(cfg.K)
            ])
            block[bname] = np.stack([
                _to_np(state_dict[f"{mod}.{k}.{layer}.bias"]) for k in range(cfg.K)
            ])
        params[mod] = block
    return params


def state_dict_from_params(params, cfg: GNSConfig) -> Dict[str, np.ndarray]:
    """Stacked-K tree in (in, out) layout -> reference-layout state_dict."""
    sd = {}
    for mod, block in params.items():
        for layer, (wname, bname) in _LAYER_TO_PARAM.items():
            for k in range(cfg.K):
                sd[f"{mod}.{k}.{layer}.weight"] = np.ascontiguousarray(
                    np.asarray(block[wname][k], np.float32).T
                )
                sd[f"{mod}.{k}.{layer}.bias"] = np.asarray(block[bname][k], np.float32)
    return sd


def module_from_jax_params(params_np, cfg: GNSConfig, device="cuda") -> GNS:
    """A gns_tpu parameter tree (as numpy arrays) -> this package's module,
    weights transposed back to (out, in). The weight carry-over the tests
    use to run both packages on the same parameters."""
    model = GNS(cfg, device=device)
    sd = state_dict_from_params(params_np, cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return model


def heads_from_jax(heads_np, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """One step's heads in gns_tpu's layout ({head: {"w1": (in, out), "b1":
    (out,), ...}}, numpy) -> the port's (out, in) layout as float32 tensors
    on `device`, the form models/gns.py `_block` gives and ops/fused.py
    takes."""
    return {
        head: {
            n: torch.tensor(_to_np(a).T.copy() if n.startswith("w") else _to_np(a), device=device)
            for n, a in block.items()
        }
        for head, block in heads_np.items()
    }
