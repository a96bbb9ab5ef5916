"""gns_torch serving against gns_tpu's: the cases of tests/test_serve.py,
the shipped checkpoints, the bfloat16 path, and the port's import
hygiene (no jax, no gns_tpu)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import gns_tpu.models.pretrained as j_pretrained
from gns_tpu.models.gns import gns_forward_batch as j_forward_batch
from gns_tpu.models.gns import init_gns_params
from gns_tpu.serve import GNSPredictor as JPredictor
from gns_tpu.serve import predict as j_predict
from gns_torch.models import pretrained
from gns_torch.models.convert import module_from_jax_params, params_from_state_dict
from gns_torch.models.gns import gns_forward_batch
from gns_torch.serve import GNSPredictor, predict
from gns_torch.utils.augment import generate_cases
from gns_torch.utils.config import GNSConfig
from gns_torch.utils import native, profiling
from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GNSConfig(K=2, latent_dim=8, hidden_dim=8, reference_parity=False)
J_CFG = j_pretrained.GNSConfig(**dataclasses.asdict(CFG))
TOL = dict(rtol=2e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    params = init_gns_params(jax.random.key(0), J_CFG)
    return params, module_from_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


def _assert_same(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("align", [False, True])
def test_predict_matches_gns_tpu(models, align):
    params, model = models
    cases = list(generate_cases(14, 3, seed=31))
    ours = predict(model, CFG, cases, align_slack=align, device="cpu")
    _assert_same(ours, j_predict(params, J_CFG, cases, method="scatter", align_slack=align))
    if align:  # the decoded gauge pins the slack angle
        bus = np.asarray(cases[0]["bus"])
        slack = int(np.flatnonzero(bus[:, 1] == 3)[0])
        np.testing.assert_allclose(ours["theta"][:, slack], np.deg2rad(bus[slack, 8]), atol=1e-6)


def test_predictor_pads_and_reuses_state(models):
    params, model = models
    pred = GNSPredictor(model, CFG, batch_size=8, device="cpu")
    jpred = JPredictor(params, J_CFG, batch_size=8, method="scatter")
    for n_aug, seed in ((2, 33), (4, 34)):
        cases = list(generate_cases(9, n_aug, seed=seed))
        _assert_same(pred.predict(cases), jpred.predict(cases))
    assert len(pred._graphs) == 1  # one topology state served both requests
    with pytest.raises(ValueError):
        pred.predict([])


def test_predict_mixed_size_request(models):
    """case9 and case14 grids in one request: the padded, masked path with
    per-sample indices (no shared topology)."""
    params, model = models
    c9 = list(generate_cases(9, 2, seed=51))
    c14 = list(generate_cases(14, 2, seed=52))
    mixed = [c9[0], c14[0], c9[1], c14[1]]
    pred = GNSPredictor(model, CFG, batch_size=4, align_slack=False, device="cpu")
    ours = pred.predict(mixed)
    assert ours["v"].shape == (4, 14) and not pred._graphs
    _assert_same(ours, j_predict(params, J_CFG, mixed, method="scatter", align_slack=False))


def test_predictor_chunks_large_requests(models):
    params, model = models
    pred = GNSPredictor(model, CFG, batch_size=8, align_slack=False, device="cpu")
    jpred = JPredictor(params, J_CFG, batch_size=8, method="scatter", align_slack=False)
    for n_req in (3, 8, 20, 37):
        cases = list(generate_cases(9, n_req - 1, seed=40 + n_req))
        out = pred.predict(cases)
        assert out["v"].shape == (n_req, 9) and out["last_loss"].shape == (n_req,)
        _assert_same(out, jpred.predict(cases))
    assert len(pred._graphs) == 1


# the spans of one predict call: the root's children in the order they run
PREDICT_CHILDREN = ["pack.prepare", "pack.stack", "pack.topology", "serve.graph", "serve.upload",
                    "serve.forward", "serve.readback", "serve.decode"]


def test_predict_span_tree(models):
    """Recorded, each predict call is one serve.predict root whose children
    are PREDICT_CHILDREN, in order, with one model.step span for each of
    the K steps inside serve.forward, each inside its parent, all of the
    root's unit; two requests, two units."""
    _, model = models
    pred = GNSPredictor(model, CFG, batch_size=4, device="cpu")
    cases = list(generate_cases(14, 3, seed=31))
    with profiling.recording():
        for _ in range(2):
            pred.predict(cases)
    rec = profiling.recorded()
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["serve.predict"] * 2
    assert roots[0].unit != roots[1].unit
    by_id = {s.id: s for s in rec.spans}
    for root in roots:
        unit = [s for s in rec.spans if s.unit == root.unit]
        children = sorted((s for s in unit if s.parent == root.id), key=lambda s: s.start_ns)
        assert [c.name for c in children] == PREDICT_CHILDREN
        forward = next(c for c in children if c.name == "serve.forward")
        steps = [s for s in unit if s.name == "model.step"]
        assert len(steps) == CFG.K and all(s.parent == forward.id for s in steps)
        assert len(unit) == 1 + len(PREDICT_CHILDREN) + CFG.K
        for s in unit:
            if s.parent:
                parent = by_id[s.parent]
                assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_index_builds_counted_on_a_cache_miss(models):
    """serve.index_builds: 1 on a predictor's first request of a topology,
    0 on the next; a request without a shared topology builds per batch."""
    _, model = models
    pred = GNSPredictor(model, CFG, batch_size=4, align_slack=False, device="cpu")
    cases = list(generate_cases(14, 3, seed=31))
    with profiling.recording():
        pred.predict(cases)
        pred.predict(cases)
    rec = profiling.recorded()
    units = [s.unit for s in rec.spans if s.name == "serve.predict"]
    assert [rec.counted(u).get("serve.index_builds", 0) for u in units] == [1, 0]
    mixed = [*generate_cases(9, 1, seed=51), *generate_cases(14, 1, seed=52)]
    with profiling.recording():
        pred.predict(mixed)
    packed = {"pack.native_batches": 1} if native.HAVE_NATIVE else {}
    assert profiling.recorded().counted() == {"serve.index_builds": 1, **packed}


@pytest.mark.parametrize("key", [14, 300, "300-deep", "multi-paper", "118-deep-n1"])
def test_shipped_checkpoint_equals_gns_tpu(key):
    model, cfg = pretrained.load_pretrained(key, device="cpu")
    j_params, j_cfg = j_pretrained.load_pretrained(key)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    ours = params_from_state_dict(model.state_dict(), cfg)
    assert ours.keys() == j_params.keys()
    for mod in ours:
        for leaf in ours[mod]:
            np.testing.assert_array_equal(ours[mod][leaf], j_params[mod][leaf])


def test_registry_matches_gns_tpu():
    assert pretrained._PRETRAINED.keys() == j_pretrained._PRETRAINED.keys()
    for key in j_pretrained._PRETRAINED:
        assert dataclasses.asdict(pretrained.pretrained_config(key)) == dataclasses.asdict(
            j_pretrained.pretrained_config(key))
        assert pretrained.pretrained_path(key) == j_pretrained.pretrained_path(key)
    assert pretrained.available_cases() == j_pretrained.available_cases()
    assert pretrained.pretrained_config("deep300") == pretrained.pretrained_config("300-deep")
    with pytest.raises(KeyError):
        pretrained.pretrained_config("nope")


def test_bf16_deviation_matches_gns_tpu():
    """The shipped case300 model in bfloat16 (fold on) moves away from its
    float32 output by about as much as gns_tpu's own bfloat16 path does on
    the same grids (the two round at different places, so they are held to
    each other's deviation, not to each other)."""
    cases = list(generate_cases(300, 31, seed=0))
    batch = batch_from_cases(cases)
    topo = extract_shared_topology(batch)
    model, cfg = pretrained.load_pretrained(300, device="cpu")
    j_params, _ = j_pretrained.load_pretrained(300)
    out, ref = {}, {}
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dt)
        with torch.no_grad():
            out[dt] = gns_forward_batch(model, c, batch, topo=topo, dense=True)
        j_c = j_pretrained.GNSConfig(**dataclasses.asdict(c))
        ref[dt] = j_forward_batch(j_params, j_c, batch, method="scatter", topo=topo, dense=True)
    np.testing.assert_allclose(out["float32"].v.numpy(), np.asarray(ref["float32"].v),
                               rtol=2e-4, atol=2e-4)
    for name in ("v", "theta"):
        ours = np.abs(getattr(out["bfloat16"], name).numpy() - getattr(out["float32"], name).numpy())
        theirs = np.abs(np.asarray(getattr(ref["bfloat16"], name))
                        - np.asarray(getattr(ref["float32"], name)))
        assert np.isfinite(ours).all()
        assert ours.max() <= 2.0 * theirs.max(), (name, ours.max(), theirs.max())
        assert np.quantile(ours, 0.99) <= 2.0 * np.quantile(theirs, 0.99), name


def test_entry_points_need_the_card_by_default(models, monkeypatch):
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNSPredictor(model, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrained.load_pretrained(14)


def test_port_imports_neither_jax_nor_gns_tpu():
    """A fresh interpreter that imports every gns_torch module (and the
    chip smoke script) loads no jax and no gns_tpu module; no source line
    of the port imports them either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gns_torch\n"
        "for m in pkgutil.walk_packages(gns_torch.__path__, 'gns_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'gns_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('gns_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]" and int(count) >= 15
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gns_tpu)\b", re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gns_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            assert not pattern.search(f.read()), path
