#!/usr/bin/env python3
"""How many blocks per SM K3's __launch_bounds__ should ask for, width by width.

    python3 probe_k3_blocks.py

Builds gns_torch/csrc/fused_edge.cu with nvcc (the flags of
gns_torch/ops/segment_kernels.py, the width's design included) at each
(latent, hidden) of WIDTHS asking for 2 resident blocks per SM (at most
255 registers a thread), for 3 (170) and for the choice of
segment_kernels.min_blocks where that is another (4, 128 registers, for
the wide and workspace designs), all builds started together. Prints ptxas's registers
and spills of each build's default and clocks instances beside the
choice, and exits non-zero where the choice spills while fewer blocks do
not (fewer blocks buy registers up to 255). Needs nvcc (the CUDA
toolkit), not a GPU; the builds go to build/probe_k3/.
"""

from __future__ import annotations

import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's fourteen widths; then min_blocks' boundary, where a
# lane's 2 (L + 5) + 4 H input and hidden floats reach 90 (3 blocks at L
# <= 25) or just pass it, or L passes 25 (2); k3_design's boundaries, where
# they reach 172 (the register design) or just pass it (the wide one), and
# where four warps' scratch just fits a block (282, 282: the wide design)
# or just does not (283, 283: the workspace); then narrow and wide ends
WIDTHS = ((20, 10), (40, 10), (8, 8), (10, 10), (33, 24), (64, 32), (97, 40), (128, 128),
          (129, 8), (200, 136), (256, 256), (512, 64), (64, 512), (512, 512),
          (24, 8), (16, 12), (25, 7), (30, 5), (26, 6), (25, 8), (21, 10),
          (41, 20), (42, 20), (34, 24), (282, 282), (283, 283),
          (1, 41), (1, 1), (128, 1), (1, 128), (1024, 1), (1, 1024))


def report(log: str) -> dict:
    """{instance: (registers, spill bytes)} from ptxas's report: each entry
    function is a block of lines starting at its "Compiling entry
    function" line; the clocks instance mangles as Lb1E."""
    out, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            name = "clocks" if "Lb1E" in hit.group(1) else "default"
            out[name] = [None, None]
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
    from gns_torch.ops import segment_kernels as kern

    out_dir = os.path.join(HERE, "build", "probe_k3")
    os.makedirs(out_dir, exist_ok=True)
    jobs, counts = {}, {}
    for width in WIDTHS:
        counts[width] = sorted({2, 3, kern.min_blocks("fused_edge", *width)})
        for blocks in counts[width]:
            path = os.path.join(out_dir, "fused_edge_L{}_H{}_{}.so".format(*width, blocks))
            if os.path.exists(path):
                os.remove(path)  # build anew, so that ptxas reports
            jobs[(width, blocks)] = (path, lambda out, w=width, b=blocks: [
                kern._nvcc(), *kern._flags("fused_edge", w, b), "-o", out,
                kern.SOURCES["fused_edge"]])
    try:
        info = kern.build_libraries(jobs)
    except RuntimeError as exc:
        print(f"probe: {exc}", file=sys.stderr)
        return 1
    wrong = []
    for width in WIDTHS:
        chosen = kern.min_blocks("fused_edge", *width)
        design = kern.k3_design(*width)
        spills = {}
        for blocks in counts[width]:
            seen = report(info[(width, blocks)]["log"])
            spills[blocks] = any(s for _, s in seen.values())
            print(f"[probe] (L, H) = {width}, {design} design, at {blocks} blocks per SM"
                  f"{' (the choice)' if blocks == chosen else ''}: "
                  + "; ".join(f"{name} instance {regs} registers, {spill} bytes spilled"
                              for name, (regs, spill) in sorted(seen.items())))
        if spills[chosen] and any(not spills[b] for b in counts[width] if b < chosen):
            wrong.append(width)
    if wrong:
        print(f"[probe] min_blocks' choice spills at {wrong}, where fewer blocks per SM do "
              f"not", file=sys.stderr)
        return 1
    print("[probe] min_blocks' choice spills nowhere that fewer blocks per SM would not")
    return 0


if __name__ == "__main__":
    sys.exit(main())
