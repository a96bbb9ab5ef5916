"""What a run loads: nothing of JAX or of the JAX package, compared by the
whole top-level name of each loaded module; and the reference loads
nothing of the program either. Each check runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

from benchmark import harness

LOAD_RUN = r"""
import importlib, importlib.util, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("bench_run", os.path.join(root, "benchmark", "run.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from benchmark import harness
bench = harness.spec()
for c in bench["configs"]:
    json.load(open(os.path.join(root, c["file"])))
for cell in bench["workloads"]:
    traffic = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
    harness.load_json(harness.HERE, "limits", cell["name"] + ".json")
    importlib.import_module("benchmark.drivers." + traffic["driver"])
for m in bench["per_layer"]:
    harness.reader(m["name"])
import benchmark.lib.trace, benchmark.control
for mod in ("gns_torch.serve", "gns_torch.train.trainer", "gns_torch.models.gns",
            "gns_torch.ops.segment_kernels", "gns_torch.utils.prepare"):
    importlib.import_module(mod)
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""

LOAD_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.gns_ref, benchmark.reference.grids, benchmark.lib.counts
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _run(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, timeout=300, env=env, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    loaded = _run(LOAD_RUN)
    assert loaded["forbidden"] == []
    assert "gns_torch" in loaded["tops"] and "torch" in loaded["tops"]
    # the port's name begins with the JAX package's: compared whole, it is not it
    assert not {"jax", "jaxlib", "flax", "gns_tpu"} & set(loaded["tops"])


def test_the_reference_loads_nothing_of_the_program():
    tops = set(_run(LOAD_REFERENCE))
    assert "torch" in tops and "numpy" in tops
    assert not {"gns_torch", "jax", "jaxlib", "flax", "gns_tpu"} & tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gns_tpu_lookalike", sys)
    assert "gns_tpu_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()
