"""gns_torch data layer against gns_tpu's: the same arrays, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import gns_tpu.utils.augment as j_augment
import gns_tpu.utils.cases as j_cases
import gns_tpu.utils.config as j_config
import gns_tpu.utils.prepare as j_prepare
import gns_tpu.utils.schema as j_schema
from gns_torch.utils import augment, cases, config, prepare, schema

torch.set_num_threads(1)

CASES = [9, 14, 30, 118, 300]


def _assert_case_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def _assert_batch_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "GridBatch"
    for x, y, name in zip(a, b, a._fields):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("case_nr", CASES)
def test_generate_cases_match(case_nr):
    ours = list(augment.generate_cases(case_nr, 3, seed=5))
    ref = list(j_augment.generate_cases(case_nr, 3, seed=5))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        _assert_case_equal(a, b)
    scaled = next(iter(augment.generate_cases(case_nr, 1, seed=1, scale=0.5)))
    _assert_case_equal(scaled, next(iter(j_augment.generate_cases(case_nr, 1, seed=1, scale=0.5))))


@pytest.mark.parametrize("case_nr", CASES)
def test_base_case_batch_matches(case_nr):
    _assert_batch_equal(prepare.base_case_batch(case_nr), j_prepare.base_case_batch(case_nr))


@pytest.mark.parametrize("paper_shunts", [True, False])
def test_batch_from_cases_dense_and_topology(paper_shunts):
    cs = list(augment.generate_cases(14, 5, seed=3))
    ours = prepare.batch_from_cases(cs, paper_shunts=paper_shunts)
    ref = j_prepare.batch_from_cases(cs, paper_shunts=paper_shunts)
    _assert_batch_equal(ours, ref)
    assert ours.is_dense() and ref.is_dense()
    t_ours = prepare.extract_shared_topology(ours)
    t_ref = j_prepare.extract_shared_topology(ref)
    for x, y in zip(t_ours, t_ref):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_batch_from_cases_mixed_padded():
    mixed = [*augment.generate_cases(9, 1, seed=1), *augment.generate_cases(14, 1, seed=2)]
    for pad in (None, (20, 24, 8)):
        ours = prepare.batch_from_cases(mixed, pad_sizes=pad)
        ref = j_prepare.batch_from_cases(mixed, pad_sizes=pad)
        _assert_batch_equal(ours, ref)
        assert not ours.is_dense()
        assert prepare.extract_shared_topology(ours) is None
        assert j_prepare.extract_shared_topology(ref) is None
    _assert_batch_equal(ours[1], ref[1])
    with pytest.raises(ValueError):
        prepare.batch_from_cases(mixed, pad_sizes=(5, 5, 5))


def test_stack_pads_lines_to_bus_count():
    """E >= N is enforced for the quirk-Q2 gathers (case9 has E == N)."""
    b = cases.load_case(9)
    trip = prepare.prepare_case(b)
    trip_short = (trip[0], trip[1][:5], trip[2])
    _assert_batch_equal(
        prepare._stack_to_batch([trip_short]), j_prepare._stack_to_batch([trip_short])
    )
    assert prepare._stack_to_batch([trip_short]).lines.shape[1] == 9


def test_load_prepared_matches():
    for test_set in (False, True):
        _assert_batch_equal(
            prepare.load_prepared(14, nr_samples=8, test_set=test_set),
            j_prepare.load_prepared(14, nr_samples=8, test_set=test_set),
        )


def test_renumber_case_matches():
    c = cases.load_case(9)
    c["bus"][:, 0] *= 10
    c["gen"][:, 0] *= 10
    c["branch"][:, :2] *= 10
    _assert_case_equal(cases.renumber_case(c), j_cases.renumber_case(c))
    _assert_case_equal(cases.renumber_case(cases.load_case(14)),
                       j_cases.renumber_case(j_cases.load_case(14)))
    with pytest.raises(ValueError):
        cases.load_case(57)


def test_config_and_schema_match():
    assert [f.name for f in dataclasses.fields(config.GNSConfig)] == [
        f.name for f in dataclasses.fields(j_config.GNSConfig)
    ]
    assert dataclasses.asdict(config.GNSConfig()) == dataclasses.asdict(j_config.GNSConfig())
    assert config.PRESETS.keys() == j_config.PRESETS.keys()
    for name in config.PRESETS:
        ours, ref = config.preset(name), j_config.preset(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for prop in ("resolved_fold_output", "resolved_scan_unroll", "resolved_remat",
                     "lr", "phi_in_dim", "update_in_dim"):
            assert getattr(ours, prop) == getattr(ref, prop)
    bf = config.GNSConfig(compute_dtype="bfloat16")
    assert bf.resolved_fold_output and not config.GNSConfig().resolved_fold_output
    with pytest.raises(KeyError):
        config.preset("nope")
    with pytest.raises(ValueError):
        _ = config.GNSConfig(fold_output="maybe").resolved_fold_output
    assert (dict(schema.BUS), dict(schema.LINE), dict(schema.GEN)) == j_schema.get_BLG()


def test_feasible_only_needs_the_oracle():
    """feasible_only rejection-samples through the port's own NR oracle
    (eval/newton_raphson.py): the cases are NR-feasible and equal gns_tpu's
    for the same seed."""
    from gns_torch.eval.newton_raphson import newton_raphson_pf

    got = list(augment.generate_cases(14, 2, seed=4, feasible_only=True))
    want = list(j_augment.generate_cases(14, 2, seed=4, feasible_only=True))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
        assert newton_raphson_pf(g).success
