#!/usr/bin/env python3
"""K4's wide instance against its pass instance, where the wide one is chosen.

    python3 probe_k4_pass.py

megakernel.cu builds one of two instances for its plans 1 and 2 (Dims::
kPass): the wide instance, whose hidden layers keep their accumulators and
fragments in registers, while a hidden layer has at most 16 n-tiles (H <=
128) and its eight warps' scratch takes at most half a block (L <= 146);
the pass instance, whose layers run their n-tiles in passes of 8 through
the warp's scratch, elsewhere. This script builds the library at each of
WIDTHS twice, as segment_kernels builds it (the wide instance) and with
-DGNS_PASS=1 (the pass instance), all nvcc started together, and runs both
on the 1024 case300 requests of generate_cases(300, 1023, seed=0) with
GNS(cfg, seed=0) weights, K = 4, under each of plans 1 and 2 that holds a
case300 grid in both, and the pass instance under its plan 3 too. Every
output must equal the wide instance's under its own plan bit for bit. Each
pair is timed by CUDA events in the order wide, pass, pass, wide (three
means of 5 launches each time), printed as the median and range of each
and the pass instance's median over the wide one's, beside ptxas's
registers and spills of each instance and the card's name and power
limit. Needs a GPU; exits 1 where an output differs.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the widths chip_smoke.py holds under the wide plans up to (128, 128),
# and (129, 8), the first latent past 128, odd
WIDTHS = ((64, 32), (97, 40), (128, 128), (129, 8))


def report(log: str) -> dict:
    """{"plan 0" / "wide": (registers, spill bytes)} from ptxas's report;
    the wide plans' instance mangles as Lb1E."""
    out, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = "wide" if "Lb1E" in hit.group(1) else "plan 0"
            out[name] = [None, 0]
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            out[name][1] = int(hit.group(1)) + int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name][0] = int(hit.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from gns_torch.models.gns import GNS
    from gns_torch.ops import megakernel as mk
    from gns_torch.ops import segment_kernels as kern
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    if not torch.cuda.is_available():
        print("probe_k4_pass: needs a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[probe] card: {card}", flush=True)
    variants = {"wide": [], "pass": ["-DGNS_PASS=1"]}
    jobs = {}
    for width in WIDTHS:
        for variant, extra in variants.items():
            flags = kern._flags("megakernel", width) + extra
            path = kern._library_path("megakernel", key=" ".join(flags) + "\n" + kern.nvcc_host(),
                                      width=width)
            jobs[(width, variant)] = (path, lambda out, f=flags: [kern._nvcc(), *f, "-o", out,
                                                                   kern.SOURCES["megakernel"]])
    info = kern.build_libraries(jobs)
    fns = {}
    for key, built in info.items():
        lib = ctypes.CDLL(built["path"])
        fns[key] = {}
        for fn, (argtypes, restype) in kern.SIGNATURES["megakernel"].items():
            bound = getattr(lib, fn)
            bound.argtypes, bound.restype = argtypes, restype
            fns[key][fn] = bound

    def use(width, variant):  # route megakernel.py's calls at `width` to one build
        for fn, bound in fns[(width, variant)].items():
            kern._fns[(fn, width)] = bound

    batch = batch_from_cases(list(generate_cases(300, 1023, seed=0)))
    topo = extract_shared_topology(batch)

    def ms(inp, plan):
        for _ in range(2):
            mk.megakernel_cuda(inp, plan=plan)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            mk.megakernel_cuda(inp, plan=plan)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 5

    differ = 0
    for width in WIDTHS:
        seen = {v: report(info[(width, v)]["log"])["wide"] for v in variants}
        print(f"[probe] (L, H) = {width}: ptxas, the wide plans' instance: "
              + "; ".join(f"{v} {r} registers, {s} bytes spilled" for v, (r, s) in seen.items()),
              flush=True)
        cfg = GNSConfig(K=4, latent_dim=width[0], hidden_dim=width[1], multiple_phi=True,
                        reference_parity=True)
        model = GNS(cfg, seed=0, device="cuda")
        with torch.no_grad():
            inp = mk.megakernel_inputs(model, cfg, batch, topo)
            use(width, "wide")
            chosen = mk.megakernel_occupancy(inp)
            ref = mk.megakernel_cuda(inp)
            torch.cuda.synchronize()
            print(f"[probe] {width}: the library's plan {chosen.plan} ({chosen.shared_bytes} bytes "
                  f"a block, {chosen.workspace_bytes} of workspace a grid)", flush=True)
            for plan in (1, 2, 3):
                held = {}
                for v in variants:
                    use(width, v)
                    occ = mk.megakernel_occupancy(inp, plan)
                    if occ.plan == plan:
                        held[v] = occ
                if "pass" not in held:
                    continue
                for v in held:
                    use(width, v)
                    got = mk.megakernel_cuda(inp, plan=plan)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, ref))
                    differ += not same
                    print(f"[probe] {width} plan {plan} {v} ({held[v].shared_bytes} bytes a block, "
                          f"{held[v].workspace_bytes} of workspace a grid, {held[v].grids_per_sm} "
                          f"grids per SM): {'bit-equal' if same else 'DIFFERENT'} to the wide "
                          f"instance under plan {chosen.plan}", flush=True)
                if len(held) < 2:
                    continue
                times = {v: [] for v in variants}
                for v in ("wide", "pass", "pass", "wide"):
                    use(width, v)
                    times[v] += [ms(inp, plan) for _ in range(3)]
                wide, pas = np.median(times["wide"]), np.median(times["pass"])
                print(f"[probe] {width} plan {plan}: wide median {wide:.4f} ms "
                      f"({min(times['wide']):.4f}-{max(times['wide']):.4f}), pass median "
                      f"{pas:.4f} ms ({min(times['pass']):.4f}-{max(times['pass']):.4f}), "
                      f"pass / wide {pas / wide:.4f} (card: {card})", flush=True)
        del model, inp, ref
        torch.cuda.empty_cache()
    print(f"[probe] {'every output bit-equal' if not differ else f'{differ} outputs DIFFERENT'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
