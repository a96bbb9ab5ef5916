#!/usr/bin/env python3
"""How many blocks per SM K3's __launch_bounds__ should ask for, width by width.

    python3 probe_k3_blocks.py

Builds gns_torch/csrc/fused_edge.cu with nvcc (the flags of
gns_torch/ops/segment_kernels.py) at each (latent, hidden) of WIDTHS twice:
asking for 3 resident blocks per SM (at most 170 registers a thread) and
for 2 (at most 255), all builds started together. Prints ptxas's
registers and spills of each build's default and clocks instances beside
the choice of segment_kernels.min_blocks, and exits non-zero where that
choice is 3 and spills while 2 does not (at 2 the cap is already 255, so
fewer blocks buy no registers). Needs nvcc (the CUDA toolkit), not a GPU;
the builds go to build/probe_k3/.
"""

from __future__ import annotations

import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's five widths; then min_blocks' boundary, where a lane's
# 2 (L + 5) + 4 H input and hidden floats reach 90 (3 blocks at L <= 25)
# or just pass it, or L passes 25 (2); then the range's ends
WIDTHS = ((20, 10), (40, 10), (8, 8), (10, 10), (33, 24),
          (24, 8), (16, 12), (25, 7), (30, 5), (26, 6), (25, 8), (21, 10), (1, 1), (64, 32))


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
    jobs = {}
    for width in WIDTHS:
        for blocks in (2, 3):
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
        spills = {}
        for blocks in (2, 3):
            seen = report(info[(width, blocks)]["log"])
            spills[blocks] = any(s for _, s in seen.values())
            print(f"[probe] (L, H) = {width} at {blocks} blocks per SM"
                  f"{' (the choice)' if blocks == chosen else ''}: "
                  + "; ".join(f"{name} instance {regs} registers, {spill} bytes spilled"
                              for name, (regs, spill) in sorted(seen.items())))
        if chosen == 3 and spills[3] and not spills[2]:
            wrong.append(width)
    if wrong:
        print(f"[probe] min_blocks asks for 3 blocks per SM at {wrong}, which spill at 3 "
              f"and not at 2", file=sys.stderr)
        return 1
    print("[probe] min_blocks' choice spills nowhere that 2 blocks per SM would not")
    return 0


if __name__ == "__main__":
    sys.exit(main())
