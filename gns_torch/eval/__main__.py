"""Evaluation CLI: `python -m gns_torch.eval` (port of gns_tpu/eval/__main__.py;
reference GNS/evaluate.py).

Evaluates a checkpoint against the Newton-Raphson oracle on the SAME test
grids (fixing reference quirk Q6) and prints the reference's metric table.
The flags are gns_tpu's. The GNS forward runs on the GPU unless --cpu is
given; with no GPU and no --cpu it raises. --checkpoint takes the shipped
checkpoints ("pretrained[:key]"), a reference-layout .pth, or a checkpoint
file of `python -m gns_torch.train` (train/checkpoint.py), which takes the
place of gns_tpu's Orbax directory.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate GNS vs Newton-Raphson")
    p.add_argument("--case", type=int, default=14)
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--latent", type=int, default=20)
    p.add_argument("--hidden", type=int, default=10)
    p.add_argument("--multiple-phi", action="store_true", default=True)
    p.add_argument("--single-phi", dest="multiple_phi", action="store_false")
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file of `python -m gns_torch.train`, reference .pth "
                        "file, the literal 'pretrained' for the shipped per-case "
                        "checkpoint, or 'pretrained:<key>' for a variant (e.g. "
                        "pretrained:300-deep, pretrained:multi); random init if omitted")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--total-grids", type=int, default=10001)
    p.add_argument("--from-base-case", action="store_true",
                   help="generate eval grids in-memory from the base case instead of pickles")
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--scale", type=float, default=1.0,
                   help="augmentation strength for --from-base-case grids "
                        "(case300 needs <=0.5 to stay NR-solvable)")
    p.add_argument("--feasible-only", action="store_true",
                   help="rejection-sample --from-base-case grids until the "
                        "NR oracle converges on them")
    p.add_argument("--nr-backend", choices=["scipy", "batched"], default="scipy",
                   help="oracle: scipy = sequential float64 (parity-grade); batched = "
                        "the batched float32 solver (eval/nr_batched.py) on the model's device")
    p.add_argument("--method", default="auto")
    p.add_argument("--plot", default="images/per_bus_errors.png")
    p.add_argument("--json-out", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run the GNS on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)

    from gns_torch.eval.harness import evaluate, load_eval_cases
    from gns_torch.models.gns import GNS
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = GNSConfig(
        case_nr=args.case, K=args.K, latent_dim=args.latent,
        hidden_dim=args.hidden, multiple_phi=args.multiple_phi,
    )

    if args.checkpoint and (
        args.checkpoint == "pretrained" or args.checkpoint.startswith("pretrained:")
    ):
        from gns_torch.models.pretrained import pretrained_config, pretrained_path

        key = args.checkpoint.split(":", 1)[1] if ":" in args.checkpoint else args.case
        if isinstance(key, str) and key.isdigit():
            key = int(key)
        # the 'multi' variants are case-agnostic: evaluate them on --case
        cfg = pretrained_config(key).replace(case_nr=args.case)
        args.checkpoint = pretrained_path(key)
    if args.checkpoint and args.checkpoint.endswith(".pth"):
        from gns_torch.train.checkpoint import import_torch

        model = import_torch(args.checkpoint, cfg, device=device).model
    elif args.checkpoint:
        from gns_torch.train.checkpoint import load_checkpoint

        model = load_checkpoint(args.checkpoint, cfg, device=device).model
    else:
        print("WARNING: no checkpoint given — evaluating a random init")
        model = GNS(cfg, seed=0, device=device)

    fell_back = False
    if not args.from_base_case:
        try:
            cases = load_eval_cases(args.case, args.samples, data_dir=args.data_dir,
                                    total_grids=args.total_grids)
        except FileNotFoundError as e:
            # With NO dataset, fall back to in-memory grids (a fresh clone
            # still evaluates); a partly present dataset is a real error:
            # evaluating other grids than asked for would corrupt comparisons.
            from gns_torch.utils.prepare import pickle_path

            if os.path.isdir(os.path.dirname(pickle_path(args.case, 0, args.data_dir))):
                raise
            print(f"WARNING: {e}\nWARNING: falling back to --from-base-case "
                  f"(in-memory seeded augmentation of the base case)")
            args.from_base_case = fell_back = True
    if args.from_base_case:
        from gns_torch.utils.augment import generate_cases

        cases = list(generate_cases(
            args.case, args.samples - 1, seed=args.seed, scale=args.scale,
            feasible_only=args.feasible_only,
        ))

    print(f"evaluating on {len(cases)} case{args.case} grids; device {device}")
    m = evaluate(model, cfg, cases, method=args.method, plot_path=args.plot,
                 nr_backend=args.nr_backend)
    if fell_back:
        # recorded so --json-out readers can tell these numbers came from
        # generated grids, not the data set
        m["fallback_from_base_case"] = True
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(m, f, indent=2)
    return m


if __name__ == "__main__":
    main()
