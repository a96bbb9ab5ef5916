"""The benchmark's general part: a cell's configuration, traffic and limits
found by name, the seeded inputs both sides are given, the driver of the
traffic's kind, and the result line.

A cell of BENCHMARK.json names a configuration (configs/<config>.json)
and a traffic mix (traffic/<traffic>.json); the mix names its driver
(drivers/<driver>.py, `run(ctx) -> Record`); the limits of the comparison
that decides `correct` are in limits/<cell>.json; each per-layer metric is
read by metrics/<metric>.py (`read(record) -> float or None`). Adding a
cell, a configuration, a mix or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(spec_: dict, name: str) -> dict:
    for cell in spec_["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


@dataclass
class Context:
    """What a driver is given: the cell's name, configuration, traffic,
    limits and seed, the measured seconds, whether to trace, the device,
    and the process's start (perf_counter) for setup_s. base_case: the
    grid the traffic perturbs (the configuration's, unless a test passes a
    smaller one)."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    base_case: Optional[dict] = None

    def model(self) -> dict:
        return self.config["gns"]

    def grid(self) -> dict:
        if self.base_case is not None:
            return self.base_case
        from benchmark.reference import grids
        return {"synthetic_case300": grids.synthetic_case300}[self.config["grid"]]()


@dataclass
class Record:
    """What a driver returns: end-to-end readings by metric name, the
    counts, the compared numbers with their limits, and, traced, what the
    per-layer readers read."""

    kind: str
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    window_s: float = 0.0  # the window less its profiled part (--trace 1)
    flops: float = 0.0  # model FLOPs completed in window_s
    spans: Optional[object] = None  # lib.trace.Spans
    units: int = 0  # requests or steps in the window
    forward_ms: List[float] = field(default_factory=list)
    launches: list = field(default_factory=list)  # lib.trace.Launch in the traced part
    trace: Optional[object] = None  # lib.trace.Trace
    detail: dict = field(default_factory=dict)  # what was compared, for control.py

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())


def gns_config(ctx: Context):
    from gns_torch.utils.config import GNSConfig
    return GNSConfig(**ctx.model())


def seed_weights(model, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Fill every parameter of the port's GNS module from `seed`, on the
    device and in a few calls: torch.nn.Linear's distribution, U(-1/sqrt
    (fan_in), 1/sqrt(fan_in)) for a layer's weight and bias. Returns a copy
    of the weights by state_dict name, which the reference is given."""
    import torch

    named = list(model.named_parameters())
    scale = np.concatenate([
        np.full(p.numel(), 1.0 / math.sqrt(_fan_in(model, n)), np.float32) for n, p in named])
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.rand(scale.size, generator=gen, device=device) * 2 - 1
    flat *= torch.as_tensor(scale, device=device)
    parts = flat.split([p.numel() for _, p in named])
    with torch.no_grad():
        torch._foreach_copy_([p for _, p in named],
                             [t.view_as(p) for t, (_, p) in zip(parts, named)])
    return {n: p.detach().clone() for n, p in named}


def _fan_in(model, name: str) -> int:
    layer = model.get_submodule(name.rsplit(".", 1)[0])
    return layer.in_features


def reference_model(ctx: Context) -> dict:
    m = ctx.model()
    return {"K": m["K"], "latent_dim": m["latent_dim"], "hidden_dim": m["hidden_dim"],
            "gamma": m["gamma"], "leaky_relu_slope": m["leaky_relu_slope"]}


def run_cell(ctx: Context) -> Record:
    """Run the traffic's driver on the context."""
    driver = importlib.import_module(f"benchmark.drivers.{ctx.traffic['driver']}")
    return driver.run(ctx)


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether `metric` is reported in `cell`: listed there, or, without a
    list, an end-to-end metric of every cell or a per-layer metric of every
    cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec_: dict, cell: str, rec: Record, trace: bool) -> Dict[str, dict]:
    """The end-to-end metrics (--trace 0) or the per-layer metrics that a
    reader finds (--trace 1) of `cell`, by name."""
    e2e = [m for m in spec_["end_to_end"] if applies(m, cell, set())]
    if not trace:
        missing = [m["name"] for m in e2e if m["name"] not in rec.e2e]
        if missing:
            raise RuntimeError(f"the driver gave no reading of {missing}")
        return {m["name"]: {"value": rec.e2e[m["name"]], "unit": m["unit"]} for m in e2e}
    reported = {m["name"] for m in e2e}
    out = {}
    for m in spec_["per_layer"]:
        if applies(m, cell, reported):
            value = reader(m["name"])(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


FORBIDDEN = ("jax", "jaxlib", "flax", "gns_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
