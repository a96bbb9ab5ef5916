"""Training CLI: `python -m gns_torch.train` (port of gns_tpu/train/__main__.py;
reference GNS/main.py main()).

The flags are gns_tpu's. Training runs on the GPU unless --cpu is given;
with no GPU and no --cpu it raises. --method keeps the JAX package's
choices: on the GPU only "auto" and "pallas" reach the CUDA kernels and
the others raise (ops/segment.py); on the CPU every choice runs the plain
PyTorch path.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Train a GNS model")
    p.add_argument("--case", type=int, default=14)
    p.add_argument("--cases", type=int, nargs="+", default=None,
                   help="train one model on a mix of cases (e.g. --cases 9 14 30), "
                        "one dataset per case (train_multi). Overrides --case; grids "
                        "are generated on the fly with --seed.")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--latent", type=int, default=20)
    p.add_argument("--hidden", type=int, default=10)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--multiple-phi", action="store_true", default=True)
    p.add_argument("--single-phi", dest="multiple_phi", action="store_false")
    p.add_argument("--epochs", type=int, default=101)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--nr-samples", type=int, default=256)
    p.add_argument("--optimizer", choices=["adam", "adagrad"], default="adam")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--method", default="auto", choices=["auto", "scatter", "onehot", "hybrid", "pallas"])
    p.add_argument("--paper-physics", action="store_true",
                   help="use paper-correct physics instead of reference parity")
    p.add_argument("--qg-gen-only", action="store_true",
                   help="paper mode: reactive generation only at generator buses "
                        "(the quirk-Q8 fix)")
    p.add_argument("--dispatch", choices=["lambda", "setpoint_slack"], default="lambda",
                   help="paper-mode generator convention (utils/config.py)")
    p.add_argument("--v-anchor", type=float, default=0.0,
                   help="paper mode: weak (v-1)^2 tie-breaker on free buses (GNSConfig.v_anchor)")
    p.add_argument("--true-shunts", action="store_true",
                   help="paper mode: keep each case's true Gs/Bs instead of the reference's "
                        "paper defaults (in-memory --cases data only)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="augmentation strength for --cases in-memory data "
                        "(case300 needs <=0.5 to stay NR-solvable)")
    p.add_argument("--out-dir", default="models")
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--export-torch", action="store_true",
                   help="also write a reference-layout .pth next to the checkpoint")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a checkpoint file (parameters + optimizer state + "
                        "step count)")
    p.add_argument("--cpu", action="store_true", help="train on the CPU (the plain PyTorch path)")
    args = p.parse_args(argv)

    from gns_torch.train.checkpoint import (checkpoint_name, export_torch, load_checkpoint,
                                            save_checkpoint)
    from gns_torch.train.metrics import MetricsLogger
    from gns_torch.train.trainer import train, train_multi
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.device import resolve_device
    from gns_torch.utils.prepare import load_all_grids, load_prepared

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = GNSConfig(
        case_nr=args.case, K=args.K, latent_dim=args.latent,
        hidden_dim=args.hidden, gamma=args.gamma, multiple_phi=args.multiple_phi,
        epochs=args.epochs, batch_size=args.batch_size, nr_samples=args.nr_samples,
        optimizer=args.optimizer, learning_rate=args.lr, seed=args.seed,
        reference_parity=not args.paper_physics,
        qg_gen_only=args.qg_gen_only, dispatch=args.dispatch,
        true_shunts=args.true_shunts, v_anchor=args.v_anchor,
    )
    if args.true_shunts and not args.cases:
        raise SystemExit(
            "--true-shunts needs in-memory data (--cases ...): stored "
            "pickle/npz datasets are prepared with the paper shunts"
        )

    if args.cases:
        from gns_torch.utils.augment import generate_cases
        from gns_torch.utils.prepare import batch_from_cases

        per = max(1, cfg.nr_samples // len(args.cases))
        datasets = [
            batch_from_cases(
                list(generate_cases(c, per, seed=cfg.seed + i, scale=args.scale))[1:],
                paper_shunts=not cfg.true_shunts,
            )
            for i, c in enumerate(args.cases)
        ]
        print(f"{len(datasets)} case groups {args.cases}, {per} grids each; device {device}")
    else:
        try:
            data = load_prepared(args.case, cfg.nr_samples, data_dir=args.data_dir)
        except FileNotFoundError:
            data = load_all_grids(args.case, cfg.nr_samples, data_dir=args.data_dir)
        print(f"loaded {data.batch_size} case{args.case} grids; device {device}")

    name = checkpoint_name(cfg)
    if args.cases:
        # a mixed-case model names its cases (c9-14-30, not c14)
        cases_tag = "c" + "-".join(str(c) for c in args.cases)
        name = name.replace(f"_c{cfg.case_nr}_", f"_{cases_tag}_", 1)
    os.makedirs(args.out_dir, exist_ok=True)

    def ckpt_fn(state, epoch, loss):
        save_checkpoint(os.path.join(args.out_dir, name + ".pt"), state)
        if args.export_torch:
            export_torch(os.path.join(args.out_dir, name + ".pth"), state, cfg)

    with MetricsLogger(args.runs_dir, run_name=name, config=vars(args)) as logger:
        def log_fn(row):
            logger.log(row)
            print(f"Epoch: {row['epoch']}, Final Loss: {row['final_loss']:.6f}, {row['sec']:.2f}s")

        state = None
        if args.resume:
            state = load_checkpoint(args.resume, cfg, device=device)
            print(f"resumed from {args.resume} at step {int(state.step)}")
        run = train_multi if args.cases else train
        run(cfg, datasets if args.cases else data, method=args.method, log_fn=log_fn,
            checkpoint_fn=ckpt_fn, state=state, device=device)
    print(f"done; best checkpoint in {args.out_dir}/{name}.pt")


if __name__ == "__main__":
    main()
