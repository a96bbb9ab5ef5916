"""The benchmark's yardstick arithmetic and its description, on the CPU."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.lib import counts
from benchmark.lib import trace as tr

K4 = {"K": 4, "latent_dim": 20, "hidden_dim": 10}
K8 = {"K": 8, "latent_dim": 40, "hidden_dim": 10}


def test_forward_flops_by_hand():
    # K4 L20 H10 at 300 buses and 411 lines: per line 3 x (25*10 + 10*10 +
    # 10*20) = 1650 MACs; per bus 2 x (44*10 + 100 + 10) + (440 + 100 + 200)
    # = 1840; 4 steps, 2 FLOP a MAC
    assert counts.forward_flops(K4, 300, 411) == 2 * 4 * (411 * 1650 + 300 * 1840) == 9_841_200
    # K8 L40 H10: per line 3 x (45*10 + 100 + 400) = 2850; per bus 2 x (840
    # + 100 + 10) + (840 + 100 + 400) = 3240
    assert counts.forward_flops(K8, 300, 411) == 2 * 8 * (411 * 2850 + 300 * 3240) == 34_293_600
    assert counts.train_step_flops(K4, 300, 411, 256) == 3 * 256 * 9_841_200


@pytest.mark.parametrize("kernel, args, mb", [
    ("K1", (1024, 411, 300, 60, 4), 174.7),  # the phi aggregate at D=60, f32
    ("K2", (1024, 300, 411, 20, 4), 58.2),  # m[dst] at D=20, every bus a destination
])
def test_launch_bytes(kernel, args, mb):
    fn = counts.k1_bytes if kernel == "K1" else counts.k2_bytes
    assert round(fn(*args) / 1e6, 1) == mb
    assert counts.least_seconds(fn(*args)) == pytest.approx(fn(*args) / 3.35e12)


def test_busy_union_and_idle_gaps():
    device = [(10, 20, "a"), (15, 30, "b"), (40, 45, "a"), (44, 50, "c"), (70, 80, "a")]
    assert tr.union(device) == [[10, 30], [40, 50], [70, 80]]
    assert tr.busy_us(device) == 40
    labels = [(0, 100, "request"), (30, 40, "pack"), (50, 75, "forward")]
    trace = tr.Trace(device, labels, (0, 100), 1)
    gaps = tr.idle_gaps(trace)
    # [0, 10] and [80, 100] under "request" alone, [30, 40] inside "pack",
    # [50, 70] inside "forward"; longest first
    assert [g[0] for g in gaps] == ["forward", "request", "request", "pack"] \
        or [g[0] for g in gaps] == ["request", "forward", "request", "pack"]
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 20e-6, 10e-6, 10e-6])
    name, seconds = tr.device_ops(trace)[0]
    assert name == "a" and seconds == pytest.approx(25e-6)
    assert tr.kernel_seconds(trace, "b", "c") == pytest.approx(21e-6)


def _record(kind, **kw):
    base = dict(kind=kind, e2e={}, attempted=1, failed=0, checks={}, memory_peak_bytes=0)
    base.update(kw)
    return harness.Record(**base)


def test_readers():
    spec = harness.spec()
    spans = tr.Spans()
    spans.seconds.update(pack=0.3, decode=0.1)
    trace = tr.Trace([(0, 10, "segment_sum_warp"), (20, 25, "gns_gather_narrow"),
                      (30, 40, "other")], [], (0, 100), 1)
    launch = tr.Launch("K1", 1, 100, 10, 1, 4, None)
    rec = _record("serve", window_s=2.0, flops=67e12, spans=spans, units=3,
                  forward_ms=[1.0, 3.0], launches=[launch], trace=trace)
    read = {m["name"]: harness.reader(m["name"])(rec) for m in spec["per_layer"]}
    assert read["pack_ms.serve"] == pytest.approx(100.0)
    assert read["decode_ms.serve"] == pytest.approx(100.0 / 3)
    assert read["forward_ms.serve"] == 2.0
    assert read["mfu_pct.serve"] == pytest.approx(50.0)
    assert read["idle_pct.serve"] == pytest.approx(75.0)
    least = counts.least_seconds(counts.k1_bytes(1, 100, 10, 1, 4))
    assert read["seg_roofline_pct.serve"] == pytest.approx(100 * least / 15e-6)
    for name in ("mfu_pct.train", "idle_pct.train", "seg_roofline_pct.train"):
        assert read[name] is None  # a serve record has nothing for a train metric


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_spec_is_whole():
    spec = harness.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    configs = {c["name"] for c in spec["configs"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for cell in spec["workloads"]:
        assert NAME.match(cell["name"]) and cell["config"] in configs and cell["chips"] == 1
        for part in (("traffic", cell["traffic"]), ("limits", cell["name"])):
            assert os.path.exists(os.path.join(harness.HERE, part[0], part[1] + ".json"))
        traffic = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
        assert os.path.exists(os.path.join(harness.HERE, "drivers", traffic["driver"] + ".py"))
        reported = [m for m in spec["end_to_end"] if harness.applies(m, cell["name"], set())]
        assert len(reported) >= 2
        assert any(harness.applies(m, cell["name"], {r["name"] for r in reported})
                   for m in spec["per_layer"])
    for c in spec["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for m in spec["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
    assert len(json.dumps(spec)) < 64 * 1024
