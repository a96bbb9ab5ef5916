"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run on the CPU at a small size (case14,
K=2, the cell's driver and comparison; the look for a card is skipped):
once sound, where it must come out correct, and once for each fault the
cell can have: for serving, an answer altered where it is produced; for
training, a step that returns its state unchanged, and half of each batch
left out with the mean taken over the rest. One card, so no exchange
between cards can be left out."""

import pytest

from benchmark.tests.conftest import cells


@pytest.mark.parametrize("cell", cells("serve"))
@pytest.mark.parametrize("fault", [None, "answer"])
def test_serve(cell, fault, monkeypatch, small_run):
    from gns_torch import serve

    if fault == "answer":
        forward = serve.gns_forward

        def altered(*args, **kwargs):
            out = forward(*args, **kwargs)
            v = out.v.clone()
            v[0, 1] += 1e-3
            return out._replace(v=v)
        monkeypatch.setattr(serve, "gns_forward", altered)
    _, rec = small_run(cell)
    assert rec.attempted > 0 and rec.failed == 0 and rec.e2e["serve_p95_ms"] > 0
    assert rec.correct == (fault is None), rec.checks


@pytest.mark.parametrize("cell", cells("train"))
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train(cell, fault, monkeypatch, small_run):
    from gns_torch.train import trainer
    from gns_torch.utils.prepare import GridBatch

    if fault == "unchanged":
        def core_of(cfg, optimizer, method, dense, grads_fn=None):
            def core(state, batch, graph, *extra):
                loss, last, _ = trainer.loss_and_grads(state.model, cfg, batch, graph, method,
                                                       dense)
                return loss, last
            return core
        monkeypatch.setattr(trainer, "_update_core", core_of)
    elif fault == "half_batch":
        whole = trainer.loss_and_grads

        def half(model, cfg, batch, graph, method="auto", dense=False):
            rows = batch.buses.shape[0] // 2
            return whole(model, cfg, GridBatch(*(a[:rows] for a in batch)), graph, method, dense)
        monkeypatch.setattr(trainer, "loss_and_grads", half)
    _, rec = small_run(cell)
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.correct == (fault is None), rec.checks
    if fault == "unchanged":
        assert rec.checks["change_gap"]["value"] == pytest.approx(1.0)
