#!/usr/bin/env python3
"""Why K3's (latent, hidden) = (40, 10) instance asks for 2 blocks per SM.

    python3 probe_k3_blocks.py

Builds gns_torch/csrc/fused_edge.cu twice with nvcc (the flags of
gns_torch/ops/segment_kernels.py): as it is, where fused_edge_kernel<40,
10> asks for 2 resident blocks per SM in its __launch_bounds__ (MinBlocks),
and with that instance asking for 3, as the (20, 10) instance does (at
most 170 registers a thread). Prints ptxas's registers and spills of each
build's L=40 instances and exits non-zero unless the source's choice
builds without a spill. Needs nvcc (the CUDA toolkit), not a GPU; the
builds go to build/probe_k3/.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_CHOICE = "return L <= 20 ? 3 : 2;"


def main() -> int:
    sys.path.insert(0, HERE)
    from gns_torch.ops import segment_kernels as kern

    src = open(kern.SOURCES["fused_edge"]).read()
    if SOURCE_CHOICE not in src:
        print(f"probe: fused_edge.cu no longer holds {SOURCE_CHOICE!r}", file=sys.stderr)
        return 1
    out_dir = os.path.join(HERE, "build", "probe_k3")
    os.makedirs(out_dir, exist_ok=True)
    variants = {2: src, 3: src.replace(SOURCE_CHOICE, "return 3;")}
    running = {}
    for blocks, text in variants.items():
        path = os.path.join(out_dir, f"fused_edge_l40_{blocks}.cu")
        with open(path, "w") as f:
            f.write(text)
        running[blocks] = subprocess.Popen(
            [kern._nvcc(), *kern._flags("fused_edge"), "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spills = {}
    for blocks, proc in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"probe: nvcc failed ({proc.returncode}) at {blocks} blocks per SM:\n{log}",
                  file=sys.stderr)
            return 1
        # ptxas reports each entry function as a block of lines, starting
        # at its "Compiling entry function" line
        blocks_of, current = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = [line]
                blocks_of.append(current)
            elif current is not None:
                current.append(line)
        spills[blocks] = False
        for entry in blocks_of:
            if "fused_edge_kernelILi40" not in entry[0]:
                continue
            report = [x.strip() for x in entry[1:] if "spill" in x or "registers" in x]
            spills[blocks] |= not any("0 bytes spill stores, 0 bytes spill loads" in x
                                      for x in report)
            print(f"[probe] L=40 at {blocks} blocks per SM "
                  f"({'CLOCKS' if 'Lb1E' in entry[0] else 'default'} instance): "
                  + " | ".join(report))
    print(f"[probe] the source's choice, 2 blocks per SM at L=40: "
          f"{'spills' if spills[2] else 'no spill'}; 3 blocks per SM: "
          f"{'spills' if spills[3] else 'no spill'}")
    return 1 if spills[2] else 0


if __name__ == "__main__":
    sys.exit(main())
