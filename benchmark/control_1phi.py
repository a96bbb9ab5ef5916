"""Readings that set the limits of the single-phi cells (limits/<cell>.json
of a cell whose traffic names drivers/serve_1phi.py or train_1phi.py), on
the card at the cell's own size, several seeds in one process, as
control.py reads them for the multi-phi cells:

    python3 benchmark/control_1phi.py --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed it prints one JSON line:
  program  the numbers a run compares, from a short window of the cell's
           own driver (the lower readings);
  control  the same numbers of reference/gns_ref_1phi.py put in the
           program's place and computed in the nearest precision below the
           one the configuration states (float32 with TF32 off -> TF32),
           on the same inputs and weights (the upper readings);
  bf16     the reference with bfloat16 products, for scale;
  faults   the reference without quirk Q1 (the phi sum written into every
           latent column, `q1`), and for training also with half of each
           batch left out of the loss (`half_batch`) and a state left
           unchanged (`unchanged`: the reference at a step size of 0, the
           parameters as they started, Adam's first moment read as 0).
The benchmark's own runs never run this; the tests call `controls`.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def controls(ctx, rec) -> dict:
    """The control's and the faults' readings on the same inputs and
    weights as the run `rec` of `ctx` and against its references."""
    import torch

    from benchmark.reference import grids

    traffic = ctx.traffic
    weights = rec.detail["weights"]
    ref32, ref64 = rec.detail["reference"], rec.detail["reference64"]
    out = {}
    if traffic["driver"] == "serve_1phi":
        from benchmark.drivers import serve_1phi as drv

        pool = grids.make_cases(ctx.grid(), traffic["pool"], ctx.seed)
        everything = list(range(len(pool)))

        def gaps(mm_dtype=None, tf32=False, **kwargs):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                answers = drv.reference_answers(ctx, pool, weights, mm_dtype, **kwargs)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            return drv.compare([(everything, answers)], ref32, ref64)

        out["faults"] = {"q1": gaps(q1=False)}
    else:
        from benchmark.drivers import train_1phi as drv

        cases = grids.make_cases(ctx.grid(), traffic["dataset"], ctx.seed)

        def gaps(mm_dtype=None, tf32=False, **kwargs):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                steps = drv.reference_steps(ctx, cases, weights, mm_dtype=mm_dtype, **kwargs)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            return drv.compare(steps, ref32, ref64, detail=True)

        unchanged = drv.reference_steps(ctx, cases, weights, lr=0.0)
        unchanged["grad"] = {k: torch.zeros_like(g) for k, g in unchanged["grad"].items()}
        out["faults"] = {"q1": gaps(q1=False), "half_batch": gaps(rows=traffic["batch"] // 2),
                         "unchanged": drv.compare(unchanged, ref32, ref64, detail=True)}
    out["control"] = gaps(tf32=True)
    out["bf16"] = gaps(mm_dtype=torch.bfloat16)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control_1phi.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control readings need the card", file=sys.stderr)
        return 2
    spec = harness.spec()
    cell = harness.cell_of(spec, args.workload)
    config = harness.load_json(harness.HERE, "configs", f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE, "traffic", f"{cell['traffic']}.json")
    limits = harness.load_json(harness.HERE, "limits", f"{cell['name']}.json")
    for seed in args.seeds:
        ctx = harness.Context(cell=cell["name"], config=config, traffic=traffic, limits=limits,
                              seed=seed, seconds=args.seconds, trace=False, device="cuda",
                              t0=time.perf_counter())
        rec = harness.run_cell(ctx)
        line = {"seed": seed, "attempted": rec.attempted, "failed": rec.failed,
                "program": {k: c["value"] for k, c in rec.checks.items()}}
        if traffic["driver"] == "train_1phi":
            from benchmark.drivers import train_1phi as drv

            line["program"] = drv.compare(rec.detail["program"], rec.detail["reference"],
                                          rec.detail["reference64"], detail=True)
        line.update(controls(ctx, rec))
        print(json.dumps(line), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
