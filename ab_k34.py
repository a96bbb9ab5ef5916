#!/usr/bin/env python3
"""K3 and K4 at the shipped checkpoints' widths, (20, 10) and (40, 10), built
from two trees and compared on one card: bit for bit, and by time.

    python3 ab_k34.py PARENT [CHANGE]

PARENT and CHANGE (default: this script's directory) are checkouts of the
repository, e.g. a parent commit unpacked with `git archive` under build/.
Each tree builds its own K3 / K4 libraries (into its own build/) and runs,
in a process of its own (`ab_k34.py --run TREE OUT`), K4 on the 1024
case300 requests of `generate_cases(300, 1023, seed=0)` with the shipped
case300 checkpoint (20, 10) and `300-deep` (40, 10), and K3 on step 0's phi
heads of each at the case300 dst index, S=1024, from a seeded generator.
The runs go parent, change, change, parent, then again (ROUNDS rounds);
every output must be equal bit for bit across them all. Each time is the
mean of 20 launches of K4 or 50 of K3 between two CUDA events, the
launches queued behind a spin on the card (torch.cuda._sleep) long enough
that the host has issued them all before the card reaches the first, so
the events read the card's time alone; beside it the host's time per
call of the wrapper (megakernel_cuda, fused_edge_cuda) while it queues.
Three such means per run; each is printed as the median and range of each
tree with the change's median over the parent's. Needs a GPU; exits 1
where an output differs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2  # of parent, change, change, parent
SPIN_CYCLES = 200_000_000  # about 0.1 s of the card's clock: longer than the host's queueing


def run(root: str, out_path: str) -> int:
    """One tree's outputs and times into out_path (npz)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from gns_torch.models.gns import PHI_HEADS, _block
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.ops import fused
    from gns_torch.ops import megakernel as mk
    from gns_torch.ops import segment_kernels as kern
    from gns_torch.ops.segment import SegmentIndex
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    if not kern.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {kern.__file__}, not the tree at {root}")
    t0 = time.perf_counter()
    kern.build_kernels([(n, w) for n in ("fused_edge", "megakernel") for w in ((20, 10), (40, 10))])
    print(f"[ab {root}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = batch_from_cases(list(generate_cases(300, 1023, seed=0)))
    topo = extract_shared_topology(batch)

    def ms(fn, reps):
        """(card ms per launch, host ms per call) of `reps` queued calls."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        c, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        c.record()
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        if 1e3 * (t1 - h0) >= c.elapsed_time(a):
            raise RuntimeError("the spin on the card ended before the host had queued every launch")
        return a.elapsed_time(b) / reps, 1e3 * (t1 - t0) / reps

    res = {}
    for name in (300, "300-deep"):
        model, cfg = load_pretrained(name, device="cuda")
        tag = f"L{cfg.latent_dim}_H{cfg.hidden_dim}"
        with torch.no_grad():
            inp = mk.megakernel_inputs(model, cfg, batch, topo)
            for i, o in enumerate(mk.megakernel_cuda(inp)):
                res[f"K4_{tag}_{i}"] = o.cpu().numpy()
            res[f"K4_{tag}_ms"], res[f"K4_{tag}_host_ms"] = np.array(
                [ms(lambda: mk.megakernel_cuda(inp), 20) for _ in range(3)]).T
            n, e = batch.buses.shape[1], batch.lines.shape[1]
            gen = torch.Generator(device="cuda").manual_seed(1)
            m = torch.randn((1024, n, cfg.latent_dim), generator=gen, device="cuda")
            feats = torch.randn((1024, e, 5), generator=gen, device="cuda")
            mask = (torch.rand((1024, e), generator=gen, device="cuda") > 0.1).float()
            heads = {h: {k: t.detach().clone() for k, t in _block(getattr(model, h)[0]).items()}
                     for h in PHI_HEADS}
            idx = SegmentIndex(topo.dst, n, "cuda")
            w = fused._weights(heads)
            for i, o in enumerate(fused.fused_edge_cuda(m, feats, mask, idx, w, 0.01)):
                res[f"K3_{tag}_{i}"] = o.cpu().numpy()
            res[f"K3_{tag}_ms"], res[f"K3_{tag}_host_ms"] = np.array([
                ms(lambda: fused.fused_edge_cuda(m, feats, mask, idx, w, 0.01), 50)
                for _ in range(3)]).T
        print(f"[ab {root}] {tag}: K4 {res[f'K4_{tag}_ms']} ms (host {res[f'K4_{tag}_host_ms']}), "
              f"K3 {res[f'K3_{tag}_ms']} ms (host {res[f'K3_{tag}_host_ms']})", flush=True)
    np.savez(out_path, **res)
    return 0


def compare(paths) -> int:
    """Runs of parent, change, change, parent (repeated): outputs bit for
    bit, times."""
    runs = [np.load(p) for p in paths]
    parent = [r for i, r in enumerate(runs) if i % 4 in (0, 3)]
    change = [r for i, r in enumerate(runs) if i % 4 in (1, 2)]
    differ = 0
    for k in sorted(runs[0].files):
        if k.endswith("_ms"):
            pa = np.concatenate([r[k] for r in parent])
            pb = np.concatenate([r[k] for r in change])
            print(f"[ab] {k}: parent median {np.median(pa):.4f} ms ({pa.min():.4f}-{pa.max():.4f}), "
                  f"change median {np.median(pb):.4f} ms ({pb.min():.4f}-{pb.max():.4f}), "
                  f"change / parent {np.median(pb) / np.median(pa):.4f}")
        else:
            same = all(np.array_equal(runs[0][k], r[k]) for r in runs[1:])
            differ += not same
            print(f"[ab] {k} {runs[0][k].shape}: {'bit-equal' if same else 'DIFFERENT'} parent vs change")
    return 1 if differ else 0


def main() -> int:
    if sys.argv[1:2] == ["--run"] and len(sys.argv) == 4:
        return run(sys.argv[2], sys.argv[3])
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) == 3 else HERE
    out_dir = os.path.join(HERE, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, root in enumerate((parent, change, change, parent) * ROUNDS):
        out = os.path.join(out_dir, f"run{i}.npz")
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", root, out]).returncode
        if rc != 0:
            print(f"[ab] the run of {root} failed ({rc})", file=sys.stderr)
            return 1
        paths.append(out)
    return compare(paths)


if __name__ == "__main__":
    sys.exit(main())
