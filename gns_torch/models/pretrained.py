"""Shipped pretrained checkpoints (port of gns_tpu/models/pretrained.py).

The checkpoints are in the reference's torch state_dict layout and are
read in place from gns_tpu/utils/case_assets/*.pth (data files, not
imports). The registry has the same keys and training configs as the JAX
package's; gns_tpu/models/pretrained.py documents how each was trained
and how accurate it is.
"""

from __future__ import annotations

import os

import torch

from gns_torch.models.gns import GNS
from gns_torch.utils.config import GNSConfig

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gns_tpu", "utils", "case_assets",
)

# key -> (filename, config it was trained at)
_BEST = dict(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True)
_DEEP = dict(K=8, latent_dim=40, hidden_dim=10, multiple_phi=True)
_PAPER = dict(reference_parity=False, qg_gen_only=True)
# the oracle-consistent paper recipe (true shunts, NR's dispatch, v tie-breaker)
_ORACLE = dict(_PAPER, dispatch="setpoint_slack", true_shunts=True, v_anchor=0.1)
_CLIP = dict(grad_clip=1.0, warmup_steps=300)

_PRETRAINED = {
    c: (f"pretrained_c{c}_K4_L20_H10.pth", dict(case_nr=c, **_BEST))
    for c in (9, 14, 30, 118, 300)
}
_PRETRAINED.update({
    "300-deep": ("pretrained_c300_K8_L40_H10.pth", dict(case_nr=300, **_DEEP)),
    "300-deep-paper": ("pretrained_c300_K8_L40_H10_paper.pth",
                       dict(case_nr=300, **_DEEP, **_PAPER)),
    "118-deep-paper": ("pretrained_c118_K8_L40_H10_paper.pth",
                       dict(case_nr=118, **_DEEP, **_ORACLE, **_CLIP,
                            init_correction_scale=0.1)),
    "14-deep-paper": ("pretrained_c14_K8_L40_H10_paper.pth",
                      dict(case_nr=14, **_DEEP, **_ORACLE, init_correction_scale=0.1)),
    "multi-deep-paper": ("pretrained_multi_K8_L40_H10_paper.pth",
                         dict(case_nr=0, **_DEEP, **_ORACLE, **_CLIP,
                              init_correction_scale=0.1)),
    "30-deep-paper": ("pretrained_c30_K8_L40_H10_paper.pth",
                      dict(case_nr=30, **_DEEP, **_ORACLE, init_correction_scale=0.1)),
    "14-deep-sup": ("pretrained_c14_K8_L40_H10_sup.pth",
                    dict(case_nr=14, **_DEEP, **_PAPER, true_shunts=True)),
    "118-deep-sup": ("pretrained_c118_K8_L40_H10_sup.pth",
                     dict(case_nr=118, **_DEEP, **_PAPER, true_shunts=True)),
    "30-deep-sup": ("pretrained_c30_K8_L40_H10_sup.pth",
                    dict(case_nr=30, **_DEEP, **_PAPER, true_shunts=True)),
    "9-deep-sup": ("pretrained_c9_K8_L40_H10_sup.pth",
                   dict(case_nr=9, **_DEEP, **_PAPER, true_shunts=True)),
    "300-deep-sup": ("pretrained_c300_K8_L40_H10_sup.pth",
                     dict(case_nr=300, **_DEEP, **_PAPER)),
    "multi-deep-sup": ("pretrained_multi_K8_L40_H10_sup.pth",
                       dict(case_nr=0, **_DEEP, **_ORACLE, **_CLIP,
                            init_correction_scale=0.1)),
    "multi": ("pretrained_multi_K4_L20_H10.pth", dict(case_nr=0, **_BEST)),
    "multi-paper": ("pretrained_multi_K4_L20_H10_paper.pth",
                    dict(case_nr=0, **_PAPER, **_BEST)),
    "multi-sup": ("pretrained_multi_K4_L20_H10_sup.pth",
                  dict(case_nr=0, **_PAPER, **_BEST)),
})
for _c in (9, 14, 30, 118, 300):
    _PRETRAINED[f"{_c}-paper"] = (f"pretrained_c{_c}_K4_L20_H10_paper.pth",
                                  dict(case_nr=_c, **_PAPER, **_BEST))
    _PRETRAINED[f"{_c}-sup"] = (f"pretrained_c{_c}_K4_L20_H10_sup.pth",
                                dict(case_nr=_c, **_PAPER, **_BEST))
_PRETRAINED.update({
    "30-paper": ("pretrained_c30_K4_L20_H10_paper.pth",
                 dict(case_nr=30, **_ORACLE, **_BEST)),
    "118-paper": ("pretrained_c118_K4_L20_H10_paper.pth",
                  dict(case_nr=118, **_ORACLE, **_CLIP, **_BEST)),
    "14-paper": ("pretrained_c14_K4_L20_H10_paper.pth",
                 dict(case_nr=14, **_ORACLE, **_BEST)),
    "118-sup": ("pretrained_c118_K4_L20_H10_sup.pth",
                dict(case_nr=118, **_PAPER, true_shunts=True, **_BEST)),
    "30-sup": ("pretrained_c30_K4_L20_H10_sup.pth",
               dict(case_nr=30, **_PAPER, true_shunts=True, **_BEST)),
    "14-sup": ("pretrained_c14_K4_L20_H10_sup.pth",
               dict(case_nr=14, **_PAPER, true_shunts=True, **_BEST)),
    "14-n1": ("pretrained_c14_K4_L20_H10_n1.pth",
              dict(case_nr=14, **_ORACLE, admittance_inputs=True, **_BEST)),
    "118-n1": ("pretrained_c118_K4_L20_H10_n1.pth",
               dict(case_nr=118, **_ORACLE, admittance_inputs=True, **_CLIP, **_BEST)),
    "118-deep-n1": ("pretrained_c118_K8_L40_H10_n1.pth",
                    dict(case_nr=118, **_DEEP, **_ORACLE, admittance_inputs=True,
                         **_CLIP, init_correction_scale=0.1)),
    "multi-n1": ("pretrained_multi_K4_L20_H10_n1.pth",
                 dict(case_nr=0, **_ORACLE, admittance_inputs=True, **_CLIP, **_BEST)),
    "30-n1": ("pretrained_c30_K4_L20_H10_n1.pth",
              dict(case_nr=30, **_ORACLE, admittance_inputs=True, **_BEST)),
})

_ALIASES = {"deep300": "300-deep"}


def available_cases():
    """Registry keys with a checkpoint present on disk (ints first)."""
    present = [
        k for k, (name, _) in _PRETRAINED.items()
        if os.path.exists(os.path.join(_ASSET_DIR, name))
    ]
    return sorted(k for k in present if isinstance(k, int)) + sorted(
        k for k in present if isinstance(k, str)
    )


def _lookup(key):
    key = _ALIASES.get(key, key)
    try:
        return _PRETRAINED[key]
    except KeyError:
        raise KeyError(
            f"no pretrained checkpoint {key!r}; available: {available_cases()}"
        ) from None


def pretrained_path(case_nr=14) -> str:
    """Absolute path of the shipped .pth for a case number or variant key."""
    name, _ = _lookup(case_nr)
    return os.path.join(_ASSET_DIR, name)


def pretrained_config(case_nr=14) -> GNSConfig:
    """The GNSConfig the shipped checkpoint was trained at."""
    _, kw = _lookup(case_nr)
    return GNSConfig(**kw)


def load_pretrained(case_nr=14, device="cuda"):
    """Return (model, cfg) for a shipped checkpoint (case number or variant
    key such as "300-deep" / "multi"), the module on `device`."""
    cfg = pretrained_config(case_nr)
    model = GNS(cfg, device=device)
    sd = torch.load(pretrained_path(case_nr), map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model, cfg
