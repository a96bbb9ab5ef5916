"""Dataset-generation CLI: `python -m gns_torch.utils` (port of
gns_tpu/utils/__main__.py; reference GNS/augment_grids.py, seeded and for
all five cases). It writes the pickles and the prepared .npz that
`python -m gns_torch.train` and `python -m gns_torch.eval` read."""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate augmented grid datasets")
    p.add_argument("--case", type=int, default=14, choices=[9, 14, 30, 118, 300])
    p.add_argument("--num", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--no-pickles", action="store_true",
                   help="write only the fast .npz cache")
    p.add_argument("--scale", type=float, default=1.0,
                   help="augmentation strength (1.0 = reference recipe; "
                        "case300 needs <=0.5 to stay NR-solvable)")
    p.add_argument("--feasible-only", action="store_true",
                   help="rejection-sample grids until Newton-Raphson "
                        "converges on them")
    args = p.parse_args(argv)

    from gns_torch.utils.augment import generate_dataset

    out = generate_dataset(
        args.case, args.num, seed=args.seed, data_dir=args.data_dir,
        write_pickles=not args.no_pickles, scale=args.scale,
        feasible_only=args.feasible_only,
    )
    print(f"wrote case{args.case} dataset ({args.num}+1 grids) to {out}")


if __name__ == "__main__":
    main()
