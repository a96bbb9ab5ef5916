"""Grid preparation: case dict -> dense float32 grid arrays (numpy).

The port's copy of gns_tpu/utils/prepare.py. Output stays numpy, so the
arrays can be compared with the JAX package's bit for bit; the model moves
them to the device (models/gns.py `batch_tensors`).

Unit/column contract (reference GNS/utils.py:17-41, SURVEY.md §2.3):

  * buses: pypower bus cols [0..5] -> (bus_i, type, Pd, Qd, Gs, Bs); Gs/Bs
    overwritten with the paper defaults +1/-1 unless `paper_shunts=False`,
    then Pd, Qd, Gs, Bs divided by baseMVA.
  * lines: pypower branch cols [0,1,2,3,4,8,9]; tau==0 -> 1; shift deg->rad.
  * generators: pypower gen cols [0,8,9,1,5,2] plus a copy of Pg, so the
    schema is (bus_i, Pmax, Pmin, Pg_set, vg, qg, Pg); powers / baseMVA.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np

from gns_torch.utils import cases as case_tables

DEFAULT_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


def prepare_case(
    case: dict, paper_shunts: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert one pypower-style case dict into (buses, lines, generators)."""
    base_mva = np.float32(case["baseMVA"])

    bus = np.asarray(case["bus"], dtype=np.float32)
    buses = bus[:, :6].copy()
    if paper_shunts:
        buses[:, 4] = 1.0  # Gs (reference utils.py:25)
        buses[:, 5] = -1.0  # Bs (reference utils.py:26)
    buses[:, 2:6] /= base_mva

    br = np.asarray(case["branch"], dtype=np.float32)
    lines = br[:, [0, 1, 2, 3, 4, 8, 9]].copy()
    lines[:, 5] = np.where(lines[:, 5] == 0, np.float32(1.0), lines[:, 5])
    lines[:, 6] = np.deg2rad(lines[:, 6])

    g = np.asarray(case["gen"], dtype=np.float32)
    gens = g[:, [0, 8, 9, 1, 5, 2]].copy()
    gens = np.concatenate([gens, gens[:, 3:4]], axis=1)
    gens[:, [1, 2, 3, 5, 6]] /= base_mva
    return buses, lines, gens


def pickle_path(case_nr: int, augmentation_nr: int, data_dir: Optional[str] = None) -> str:
    data_dir = data_dir or DEFAULT_DATA_DIR
    return os.path.join(
        data_dir, f"case{case_nr}", f"augmented_case{case_nr}_{augmentation_nr}.pkl"
    )


def prepare_grid(
    case_nr: int, augmentation_nr: int, data_dir: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load one augmented pickle of the reference's data set and prepare
    it (reference: GNS/utils.py:17). Read only files the data set's own
    generator wrote: unpickling runs code."""
    with open(pickle_path(case_nr, augmentation_nr, data_dir), "rb") as f:
        case = pickle.load(f)
    return prepare_case(case)


class GridBatch(NamedTuple):
    """A batch of S grids with static shapes (numpy, or torch tensors once
    moved to a device by models/gns.py `batch_tensors`).

    buses (S, N, 6), lines (S, E, 7), generators (S, G, 7) float32;
    bus_mask (S, N), line_mask (S, E), gen_mask (S, G) float32 — 1 for real
    rows, 0 for padding; n_bus (S,) int32 — the real bus count.
    """

    buses: np.ndarray
    lines: np.ndarray
    generators: np.ndarray
    bus_mask: np.ndarray
    line_mask: np.ndarray
    gen_mask: np.ndarray
    n_bus: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.buses.shape[0]

    def __getitem__(self, idx):  # slicing along the batch axis
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return GridBatch(*(a[idx] for a in self))

    def is_dense(self) -> bool:
        """True when no grid is padded (every mask is all ones and every
        n_bus equals N): the forward may then skip every mask multiply."""
        return bool(
            np.all(np.asarray(self.n_bus) == self.buses.shape[1])
            and np.all(np.asarray(self.bus_mask) == 1)
            and np.all(np.asarray(self.line_mask) == 1)
            and np.all(np.asarray(self.gen_mask) == 1)
        )


class GridTopology(NamedTuple):
    """Shared (batch-invariant) topology: 0-based index arrays.

    Augmentation perturbs parameters, never topology (reference
    GNS/augment_grids.py:25-54), so the grids of one case share it.
    """

    src: np.ndarray  # (E,) int32 from-bus
    dst: np.ndarray  # (E,) int32 to-bus
    gen_idx: np.ndarray  # (G,) int32 generator bus


def extract_shared_topology(batch: GridBatch) -> Optional[GridTopology]:
    """Return the batch's shared topology, or None if the grids differ."""
    f_bus = np.asarray(batch.lines[..., 0])
    t_bus = np.asarray(batch.lines[..., 1])
    g_bus = np.asarray(batch.generators[..., 0])
    if not (
        (f_bus == f_bus[:1]).all()
        and (t_bus == t_bus[:1]).all()
        and (g_bus == g_bus[:1]).all()
    ):
        return None
    return GridTopology(
        src=f_bus[0].astype(np.int32) - 1,
        dst=t_bus[0].astype(np.int32) - 1,
        gen_idx=g_bus[0].astype(np.int32) - 1,
    )


def _stack_to_batch(triples, pad_sizes=None) -> GridBatch:
    """Stack prepared (buses, lines, gens) triples into a GridBatch.

    pad_sizes: optional (N_pad, E_pad, G_pad). Padded lines and generators
    point at the last bus slot (a dead bus) so quirk-Q2 indexing stays in
    bounds; their contributions are masked. E >= N is enforced, because Q2
    indexes length-E arrays with bus ids.
    """
    s = len(triples)
    n = max(t[0].shape[0] for t in triples)
    e = max(t[1].shape[0] for t in triples)
    g = max(t[2].shape[0] for t in triples)
    if pad_sizes is not None:
        pn, pe, pg = pad_sizes
        if pn < n or pe < e or pg < g:
            raise ValueError(f"pad_sizes {pad_sizes} smaller than data ({n},{e},{g})")
        n, e, g = pn, pe, pg
    if e < n:
        e = n

    buses = np.zeros((s, n, 6), dtype=np.float32)
    lines = np.zeros((s, e, 7), dtype=np.float32)
    gens = np.zeros((s, g, 7), dtype=np.float32)
    bus_mask = np.zeros((s, n), dtype=np.float32)
    line_mask = np.zeros((s, e), dtype=np.float32)
    gen_mask = np.zeros((s, g), dtype=np.float32)
    n_bus = np.zeros((s,), dtype=np.int32)

    for i, (b, l, gn) in enumerate(triples):
        nb, ne, ng = b.shape[0], l.shape[0], gn.shape[0]
        buses[i, :nb] = b
        buses[i, nb:, 0] = np.arange(nb + 1, n + 1)
        lines[i, :ne] = l
        lines[i, ne:, 0] = n  # f_bus (1-based): the dead slot
        lines[i, ne:, 1] = n  # t_bus
        lines[i, ne:, 2] = 1.0  # r
        lines[i, ne:, 3] = 1.0  # x
        lines[i, ne:, 5] = 1.0  # tau
        gens[i, :ng] = gn
        gens[i, ng:, 0] = n
        gens[i, ng:, 4] = 0.0  # vg = 0 -> v-init 'no generator' path
        bus_mask[i, :nb] = 1.0
        line_mask[i, :ne] = 1.0
        gen_mask[i, :ng] = 1.0
        n_bus[i] = nb
    return GridBatch(buses, lines, gens, bus_mask, line_mask, gen_mask, n_bus)


def load_all_grids(
    case_nr: int,
    nr_samples: int = 100,
    test_set: bool = False,
    data_dir: Optional[str] = None,
    total_grids: int = 10001,
) -> GridBatch:
    """Load `nr_samples` augmented grids as one static-shape batch
    (reference GNS/utils.py:44-68): training grids are indices
    1..nr_samples (index 0 is the unaugmented base case); test_set=True
    takes the last nr_samples, the NR-oracle range of GNS/evaluate.py:31
    (the reference's own test_set branch crashes, SURVEY.md Q7).
    """
    start = (total_grids - nr_samples) if test_set else 1
    return _stack_to_batch(
        [prepare_grid(case_nr, i, data_dir) for i in range(start, start + nr_samples)]
    )


def load_prepared(
    case_nr: int,
    nr_samples: Optional[int] = None,
    test_set: bool = False,
    data_dir: Optional[str] = None,
) -> GridBatch:
    """Load the prepared .npz cache (data/case{nr}/prepared_case{nr}.npz).

    Index 0 is the unaugmented base case; training slices start at 1, test
    slices take the tail.
    """
    data_dir = data_dir or DEFAULT_DATA_DIR
    path = os.path.join(data_dir, f"case{case_nr}", f"prepared_case{case_nr}.npz")
    with np.load(path) as z:
        buses, lines, gens = z["buses"], z["lines"], z["generators"]
    total = buses.shape[0]
    if nr_samples is None:
        nr_samples = total - 1
    sl = slice(total - nr_samples, total) if test_set else slice(1, 1 + nr_samples)
    buses, lines, gens = buses[sl], lines[sl], gens[sl]
    s, n = buses.shape[0], buses.shape[1]
    e, g = lines.shape[1], gens.shape[1]
    return GridBatch(
        buses=buses,
        lines=lines,
        generators=gens,
        bus_mask=np.ones((s, n), np.float32),
        line_mask=np.ones((s, e), np.float32),
        gen_mask=np.ones((s, g), np.float32),
        n_bus=np.full((s,), n, np.int32),
    )


def batch_from_cases(case_dicts, pad_sizes=None, paper_shunts=True) -> GridBatch:
    """Build a (possibly mixed-size, padded) batch straight from case dicts."""
    return _stack_to_batch(
        [prepare_case(c, paper_shunts=paper_shunts) for c in case_dicts],
        pad_sizes,
    )


def base_case_batch(case_nr: int) -> GridBatch:
    """Single-grid batch of the unaugmented base case."""
    return _stack_to_batch([prepare_case(case_tables.load_case(case_nr))])
