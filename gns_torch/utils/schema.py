"""Column schemas for the three grid tensors.

One power grid is three dense float32 arrays:

  buses      (N, 6)  — bus_i, type, Pd, Qd, Gs, Bs
  lines      (E, 7)  — f_bus, t_bus, r, x, b, tau, theta_shift
  generators (G, 7)  — bus_i, Pmax, Pmin, Pg_set, vg, qg, Pg

The same layout as gns_tpu/utils/schema.py and the reference
(GNS/utils.py:4-13 `get_BLG`), so grids prepared by any of them are
interchangeable. Bus numbering in the data is 1-based (MATPOWER); every
consumer converts to 0-based indices at the use site.
"""

from __future__ import annotations

from types import MappingProxyType

BUS = MappingProxyType(
    {"bus_i": 0, "type": 1, "Pd": 2, "Qd": 3, "Gs": 4, "Bs": 5}
)
LINE = MappingProxyType(
    {"f_bus": 0, "t_bus": 1, "r": 2, "x": 3, "b": 4, "tau": 5, "theta": 6}
)
GEN = MappingProxyType(
    {"bus_i": 0, "Pmax": 1, "Pmin": 2, "Pg_set": 3, "vg": 4, "qg": 5, "Pg": 6}
)

# Per-line features fed to the message MLPs: lines[:, 2:7].
N_LINE_FEATURES = 5

# MATPOWER bus-type codes (bus column 1).
BUS_TYPE_PQ = 1
BUS_TYPE_PV = 2
BUS_TYPE_SLACK = 3


def get_BLG():
    """The (B, L, G) column-index dicts, as the reference's GNS/utils.py:4-13
    returns them (gns_tpu/utils/schema.py:40); new code imports BUS / LINE /
    GEN."""
    return dict(BUS), dict(LINE), dict(GEN)
