"""Run one cell of the benchmark of gns_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json "workloads") names
its configuration and traffic; harness.py finds their files. The last line
of standard output is one JSON object: correct, attempted, failed, the
cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1),
the device, with --trace 1 the breakdown of the traced window, and last
the numbers compared with the reference beside their limits, which also
end standard error.

Exits 2, printing no result, where the card or the cell's count of cards
is missing, and 3 where JAX or the JAX package was loaded. Build and kernel
caches stay inside the checkout (build/).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", "bench_cache", sub))
    sys.path.insert(0, ROOT)
    from benchmark import harness

    spec = harness.spec()
    cell = harness.cell_of(spec, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    config = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    ctx = harness.Context(
        cell=cell["name"], config=config,
        traffic=harness.load_json(harness.HERE, "traffic", f"{cell['traffic']}.json"),
        limits=harness.load_json(harness.HERE, "limits", f"{cell['name']}.json"),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda", t0=T0)
    rec = harness.run_cell(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    result = {
        "correct": rec.correct,
        "attempted": rec.attempted,
        "failed": rec.failed,
        "metrics": harness.metrics_of(spec, cell["name"], rec, bool(args.trace)),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": rec.memory_peak_bytes},
    }
    if args.trace:
        from benchmark.lib import trace as tr

        if rec.trace is None:
            print("the window closed before its traced part", file=sys.stderr)
            return 1
        w0, w1 = rec.trace.window
        result["device"]["busy_s"] = tr.busy_us(rec.trace.device) / 1e6
        result["device"]["window_s"] = (w1 - w0) / 1e6
        result["breakdown"] = {
            "device_ops": [list(x) for x in tr.device_ops(rec.trace)[:10]],
            "idle_gaps": [list(x) for x in tr.idle_gaps(rec.trace)[:10]],
        }
    result["checks"] = rec.checks
    for name, c in rec.checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
