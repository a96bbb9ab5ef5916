"""gns_torch's dataset writer (utils/augment.py generate_dataset) against
gns_tpu's: the same files for the same arguments, npz arrays bit for bit
and pickles loading to equal case dicts; the reader functions on what it
writes; get_BLG and physics/common.py's ones_mask and bus_injections
against gns_tpu's (bus_injections at rtol 1e-6: the same float32
formulas, the generator sum from two libraries)."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

import gns_tpu
import gns_torch
from gns_tpu.physics.common import bus_injections as j_bus_injections
from gns_tpu.physics.common import ones_mask as j_ones_mask
from gns_tpu.utils.augment import generate_dataset as j_generate_dataset
from gns_torch.physics.common import build_graph, bus_injections, ones_mask
from gns_torch.utils.augment import generate_cases, generate_dataset
from gns_torch.utils.prepare import (_stack_to_batch, batch_from_cases, load_all_grids,
                                     load_prepared, prepare_case)

torch.set_num_threads(1)


def _assert_npz_equal(a: str, b: str):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in zb.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def _assert_dirs_equal(ours: str, ref: str):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        a, b = os.path.join(ours, name), os.path.join(ref, name)
        if name.endswith(".npz"):
            _assert_npz_equal(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                ca, cb = pickle.load(fa), pickle.load(fb)
            assert ca.keys() == cb.keys()
            for key in cb:
                np.testing.assert_array_equal(np.asarray(ca[key]), np.asarray(cb[key]),
                                              err_msg=f"{name}:{key}")


@pytest.mark.parametrize("case_nr,num,seed,scale,feasible", [
    (9, 8, 3, 1.0, False),
    (9, 8, 4, 0.5, False),
    (14, 8, 3, 0.5, False),
    (14, 8, 4, 1.0, False),
    (9, 4, 3, 1.0, True),
    (14, 4, 4, 0.5, True),
])
def test_generate_dataset_matches_gns_tpu(tmp_path, case_nr, num, seed, scale, feasible):
    kw = dict(seed=seed, scale=scale, feasible_only=feasible)
    ours = generate_dataset(case_nr, num, data_dir=str(tmp_path / "ours"), **kw)
    ref = j_generate_dataset(case_nr, num, data_dir=str(tmp_path / "ref"), **kw)
    assert ours == str(tmp_path / "ours" / f"case{case_nr}")
    assert len(os.listdir(ours)) == num + 2  # num + 1 pickles and the npz
    _assert_dirs_equal(ours, ref)
    with np.load(os.path.join(ours, f"prepared_case{case_nr}.npz")) as z:
        assert z["seed"] == seed and z["seed"].dtype == np.int64
        assert z["scale"] == scale and z["scale"].dtype == np.float64
        assert z["buses"].shape[0] == num + 1


def test_generate_dataset_variants_and_readers(tmp_path):
    """write_pickles / write_npz each alone; the npz holds prepare_case of
    generate_cases with the same arguments, and load_all_grids (pickles)
    equals load_prepared (npz) on the train and the test slices."""
    only_npz = generate_dataset(14, 6, seed=2, data_dir=str(tmp_path / "a"), write_pickles=False)
    assert os.listdir(only_npz) == ["prepared_case14.npz"]
    only_pkl = generate_dataset(14, 6, seed=2, data_dir=str(tmp_path / "b"), write_npz=False)
    assert sorted(os.listdir(only_pkl)) == sorted(f"augmented_case14_{i}.pkl" for i in range(7))
    both = str(tmp_path / "c")
    generate_dataset(14, 6, seed=2, data_dir=both)
    _assert_npz_equal(os.path.join(only_npz, "prepared_case14.npz"),
                      os.path.join(both, "case14", "prepared_case14.npz"))
    want = _stack_to_batch([prepare_case(c) for c in generate_cases(14, 6, seed=2)])
    got = load_prepared(14, data_dir=str(tmp_path / "a"), nr_samples=7)
    # load_prepared's train slice starts at 1; compare from there
    for name, x, y in zip(want._fields, want[1:], got[:6]):
        np.testing.assert_array_equal(x, y, err_msg=name)
    for test_set in (False, True):
        a = load_all_grids(14, 4, test_set=test_set, data_dir=str(tmp_path / "b"), total_grids=7)
        b = load_prepared(14, 4, test_set=test_set, data_dir=str(tmp_path / "a"))
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_get_blg_matches():
    assert gns_torch.get_BLG() == gns_tpu.get_BLG()
    from gns_torch.utils import get_BLG as u_get_BLG
    from gns_tpu.utils import get_BLG as j_u_get_BLG

    assert u_get_BLG() == j_u_get_BLG()
    b, _, _ = gns_torch.get_BLG()
    b["bus_i"] = 99  # a copy: the module's maps stay as they are
    assert gns_torch.BUS["bus_i"] == 0


def test_ones_mask_and_bus_injections_match():
    assert torch.equal(ones_mask(7), torch.from_numpy(np.array(j_ones_mask(7))))
    assert ones_mask((3, 7), torch.bfloat16).shape == (3, 7)
    assert ones_mask(4, torch.bfloat16).dtype == torch.bfloat16
    cases = [*generate_cases(9, 1, seed=11), *generate_cases(14, 1, seed=12)]
    batch = batch_from_cases(cases)  # padded: generator and bus masks both exercised
    rng = np.random.default_rng(3)
    s, n = batch.buses.shape[:2]
    g = batch.generators.shape[1]
    v = (1.0 + 0.05 * rng.standard_normal((s, n))).astype(np.float32)
    pg = rng.uniform(0.1, 1.0, (s, g)).astype(np.float32)
    qg = rng.uniform(-0.5, 0.5, (s, n)).astype(np.float32)
    ref = jax.vmap(j_bus_injections)(v, batch.buses, batch.generators, pg, qg,
                                     batch.gen_mask)
    t = {k: torch.from_numpy(np.asarray(a)) for k, a in zip(batch._fields, batch)}
    graph = build_graph(batch.buses, batch.lines, batch.generators, None, "cpu")
    for gr in (graph, None):
        out = bus_injections(torch.from_numpy(v), t["buses"], t["generators"],
                             torch.from_numpy(pg), torch.from_numpy(qg), t["gen_mask"], gr)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    no_mask = jax.vmap(lambda *a: j_bus_injections(*a, None))(
        v, batch.buses, batch.generators, pg, qg)
    out = bus_injections(torch.from_numpy(v), t["buses"], t["generators"],
                         torch.from_numpy(pg), torch.from_numpy(qg), None, graph)
    for a, b in zip(out, no_mask):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
