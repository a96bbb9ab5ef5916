#!/usr/bin/env python3
"""Drive gns_torch's serving, training, evaluation, solver, screening,
parallel and dataset paths on one NVIDIA GPU (an H100) and check them.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles the CUDA sources of gns_torch/csrc (segment.cu: K1,
     K2; fused_edge.cu: K3 and megakernel.cu: K4, each once per (latent,
     hidden) width of WIDTHS) with nvcc for sm_90a, one nvcc per library,
     all started together, timed; ptxas's registers and spills printed.
  3. kernels: K1 (segment-sum) and K2 (gather) against their plain twins on
     random data at the serving path's case300 index sets (S=1024,
     D in {1, 2, 4, 20, 60}, float32 and bfloat16 data), and each kernel's
     autograd backward (the other kernel) against the plain gradient. K2
     also on a flattened per-sample index, bf16 rows of 2 and 8, f32 rows
     of 5, and data 2 bytes off a word, so that each of its variants
     (narrow, word / wide) and unit widths runs; it must equal its twin bit
     for bit, and its library's launch plan must equal the Python mirror.
  4. parity: the port's forward on the card against the reference golden
     tests/golden/multiphi_K4_L20_H10_case300_grid1.npz.
  5. serving: the shipped case300 checkpoint (K4/L20/H10, reference parity)
     serves 1024 generated grids through GNSPredictor in float32, checked
     against the same port on the CPU, with the kernels' launch counts
     proving the path ran through K1 and K2. Then one bfloat16 run (fold
     on), checked against the port's bfloat16 run on the CPU, and against
     float32 as a sanity bound. Every distinct kernel launch of both runs
     is then replayed on its recorded input and held against its plain
     twin.
  6. fused edge stage: gns_torch.ops.fused.fused_edge_stage (K3) at the
     case300 dst index, S=1024, with step 0's phi heads of the shipped
     checkpoint: one K3 launch per forward, against its plain twin on the
     card and on CPU copies; its autograd backward (a recompute through K1
     and K2, never a plain twin) against the twin's gradients on the CPU;
     then a made-up index with a 70-edge hub bus (a work item over two
     tiles); ptxas must report no spill for K3. Then K3 at (L, H) = (40,
     10), the deep checkpoints' width, with `300-deep`'s step-0 heads: one
     launch against its plain twin, its shared bytes and blocks per SM.
  7. megakernel: gns_torch.ops.megakernel.megakernel_forward_batch (K4) on
     the same 1024 case300 requests and checkpoint as phase 5: one K4
     launch and no K1/K2 launch, against its plain twin on the CPU (worst
     value and 99.9th percentile, each beside the eager bfloat16 path's
     reading of phase 5) and against the float32 forward on the card (a
     sanity bound); its shared bytes per grid, grids resident per SM,
     ptxas registers and spills, and the count of HMMA (tensor-core)
     instructions in its SASS, which must not be 0; the same launch under
     the wide plans 1 and 2 (tiles from L2, one head at a time; state rows
     in a global workspace) must give the same bits. Then `300-deep` (K=8,
     L=40, H=10) on the same requests: one K4 launch and no K1/K2, against
     its plain twin on the CPU (K4_DEEP_CARD_VS_CPU) and its float32
     forward (DEEP_VS_F32), its shared bytes per grid and grids per SM.
 7b. widths (run last, after phase 15: after its widths the profiler
     leaves activities out of later traces of the same process): K3 and
     K4 at (latent, hidden) = (8, 8) (gns_tpu's K3 test
     width), (10, 10) (the reference's default), (33, 24) (an odd latent,
     hidden over two k-tiles), (64, 32), (97, 40) (an odd latent over 64,
     hidden over three k-tiles), (128, 128), then past 128: (129, 8),
     (200, 136), (256, 256), (512, 64), (64, 512) and (512, 512) (WIDTHS
     says why each), weights from GNS(cfg, seed=0), K=4: K3 as in phase 6
     (forward, backward, hub index; K3_FWD, K3_GRAD, or the width's
     K3_WIDTH_FWD / K3_WIDTH_GRAD beside the twin's own float32-vs-float64
     reading that justifies it; past (128, 128) each gradient per leaf,
     not per element, within K3_GRAD_NORM of the twin's own float32
     reading against its float64 autograd), K4 on the 1024 requests as in phase 7 (one K4
     launch, K4_CARD_VS_CPU, or K4_WIDTH_CARD_VS_CPU beside the eager
     bfloat16 path's card-vs-CPU reading that justifies it; the library's
     plan the first that holds a case300 grid, its bytes per block, blocks
     per grid and where the tiles sit; every other plan that holds the
     grid bit-equal to it; HMMA in the plan's SASS); K3's design and bytes
     equal to segment_kernels' mirror; each with its build seconds, ptxas
     registers and spills, blocks per SM, device time against its bound
     and its plain twin. At the widths of CPU_SUBSET the CPU twins hold the
     first 128 of the 1024 requests (K3: samples; the card's K3 runs all
     1024, held against its plain twin on the card) and the timing takes
     fewer repeats. Then K3 and K4 at (0, 8)
     and (8, 0), below the range: each wrapper raises before any build and
     launches nothing.
  8. timing: predict grids/s, forward grids/s, the device's busy and idle
     share of the forward from one profiler trace, each kernel against its
     bound, its plain twin and one PyTorch library call where one computes
     the same function, each also as kernel-only device time per launch
     from the profiler, K4 at K=1 beside K=4, and K4 beside the eager
     forwards. K2 is timed interleaved with index_select (a b b a, median
     and range), also in bfloat16 at D=20 and D=2, and the host side of one
     K2 launch part by part (the launch path before this design beside
     now). K3 and K4 also one launch at a time with a warm and a cold L2
     (after a 128 MB write), and K3's registers, shared bytes per block and
     blocks per SM; K3 and K4 at (40, 10) with `300-deep` against their
     bounds and plain twins.
  9. train: the trainer (gns_torch/train/trainer.py) at the benchmark's
     model (benchmark/configs/gns-k4-l20-h10-c300.json), case300 K=4
     latent 20 hidden 10 multiple phi, batch 256 (the grids of
     generate_cases(300, 255, seed=0), one shared topology, dense), from
     GNS(cfg, seed=0), in two configurations: A, float32 with reference
     parity (TF32 off); B, bench.py's default, bfloat16 MLPs with the paper
     physics (fold on). For each: one update step's gradients against the
     port's CPU path (TRAIN_GRAD); its K1 / K2 launches, forward and
     backward apart, against the counts the code gives (train_launches) and
     K3 = K4 = 0; every distinct K1 / K2 launch of the step replayed on its
     recorded input, bit-equal to its plain twin; 20 eager Adam steps through
     make_train_step (finite losses, the last below the first, the launch
     counts 20 steps' worth), then the same 20 steps through
     make_epoch_step's CUDA graph from the same start, whose parameters must
     equal the eager run's in A. A padded case9 + case14 batch takes one
     step through the kernels' backward. Timing: ms per step eager (host
     wall and CUDA events) and by graph replay, train edges/s (bench.py:137's
     definition) and the device's busy and idle share of one eager step.
     Then, in a process of its own (`chip_smoke.py --train-timing`; after
     the train phase the profiler has left one activity out of nearly
     every later trace of the same process), each new K1 / K2 shape of the
     backward against its bound and index_add_ / index_select, and the busy
     and idle share of one replayed step. A trace that misses a call's
     activity is taken again; six short traces fail the run.
 10. eval: (a) evaluate() (gns_torch/eval/harness.py) of the shipped
     case300 checkpoint on the 64 grids of generate_cases(300, 63, seed=0,
     scale=0.5, feasible_only=True) against the Newton-Raphson oracle: its
     K1 / K2 launches (serving's counts per forward), every metric finite,
     the oracle converged on every grid, run_gns on the card against the
     CPU at serving's float32 bounds, NR and GNS ms per grid; (b) the case30
     multi-seed protocol of tools/accuracy_multiseed.py: train() over
     pool[1:257] of generate_cases(30, 1000, seed=20301) by CUDA-graph
     replay, seeds 101-105, each evaluated with run_gns against one oracle
     run over pool[769:1001]; each seed's v MSE (failing above WORST_DRAW)
     and the median beside gns_tpu's band; (c) supervised training on NR
     labels of 128 feasible case30 grids: one eager step's launches against
     train_launches, each distinct launch bit-equal to its twin, then 5
     epochs of train_supervised by graph replay (finite, falling); (d)
     train() for 2 epochs on a padded case9 + case14 dataset (no shared
     topology: eager steps on K1/K2); (e) K1's backward over an index with
     dropped ids (a masked K2) bit-equal to the CPU twin's gradient.
 11. solve: the exact-solver ladder (gns_torch/eval/) on the 256 grids of
     generate_cases(300, 255, seed=0, scale=0.5, feasible_only=True), one
     chunk at gns_tpu's chunk_size 256, with the shipped case300
     checkpoint: flat solve_batched, solve_batched_fdpf, hybrid_solve with
     a Newton and with a fast-decoupled tail, solve_ac on auto,
     solve_batched_dc, and run_nr_oracle(backend="batched") on the first
     64 (the eval phase's grids). Each arm: its K1 / K2 launches against
     the counts the code gives (solve_launches); against the port's CPU run
     on the same grids (SOLVE_CARD_VS_CPU; per-grid counts may differ only
     where a gate decided at its edge, SOLVE_EDGE; DC_CARD_VS_CPU); against
     the scipy float64 oracle on every grid (SOLVE_VS_ORACLE; the DC angles
     within DC_VS_ORACLE_DEG). Every distinct K1 / K2 launch of the phase
     is replayed bit-equal to its twin. Printed: ms per chunk and per grid
     of each arm beside scipy's host ms per grid, iterations and host
     syncs, peak device memory, one Newton iteration's parts (trig terms,
     Jacobian, lu_factor_ex, lu_solve), measured_dispatch_rtt and what
     compact_after="auto" resolves to; then, in a process of its own
     (`chip_smoke.py --solve-timing CASES.npz`), the busy and idle share
     of one flat solve from one profiler trace.
 13. screen: the contingency screens (gns_torch/eval/contingency.py,
     eval/n2.py) on the authentic case118 at full size: (a) screen_n1 over
     its 239 branch and generator outages, method "auto" and "nr",
     warm="base", against the port's CPU run (converged, worst and the
     violation counts equal, states within SOLVE_CARD_VS_CPU, per-grid
     counts at most one apart) and the scipy oracle on every non-bridge
     outage (SOLVE_VS_ORACLE); its non-converged branch outages must be
     exactly find_bridges(case), 9 of 186; (b) screen_n1_ranked with
     118-n1, top_k=64: islanded flags equal to the CPU run's, pred_v within
     serving's float32 bound, severities within what that bound lets them
     move (screen_sev_bound), the verified sets equal but for near-ties of
     the k-th severity, the verified solves against the oracle; (c)
     screen_n2 over all 17,205 in-service pairs in chunks of 2048: the
     first chunk against the port's CPU run (hold_solve), every
     structurally islanded pair non-converged but for the balanced-island
     class (counted), 64 converged pairs drawn with a seed against the
     oracle on explicit variant dicts; (d) screen_n2_ranked with
     118-deep-n1, score "depth", top_k=256: the first chunk's severities
     against the CPU run's, and its precision at k beside gns_tpu's record
     in docs/N1_SCREEN.md. Each screen: its K1 / K2 launches against the
     counts the code gives, the host wall of its second run, contingencies
     per second, ms per N-2 chunk, host syncs and peak device memory; every
     distinct K1 / K2 launch of the phase replayed bit-equal to its twin.
     Then, in a process of its own (`chip_smoke.py --screen-timing`), the
     busy and idle share of one N-2 chunk, end to end and its solve core.
 14. parallel: the parallel layer (gns_torch/parallel) with its ranks as
     processes of this script on the one card (`chip_smoke.py --parallel
     WORLD RANK STORE`, all on cuda:0): a gloo pair runs every solver arm
     sharded over dp on the solve phase's 256 case300 grids, GNSPredictor
     on the 1024 serving requests, screen_n1 on case118, and one train
     step each of dp = 2, gp = 2 (parity mode), the edge partition (gp =
     2, paper mode) and TP = 2 at bench.py's config A on its batch (411
     lines padded to 412), and the pipeline's forward and train step on
     `300-deep` over pp = 2 (4 microbatches of 64); a gloo square the dp x
     gp = 2 x 2 step; an NCCL world of one (the card holds one NCCL rank)
     a sharded solve and a step. Meanwhile this process runs each path
     single-process on the card. Each rank's path is held to it: verdicts
     and converged flags equal, states within SOLVE_CARD_VS_CPU (counts
     off only at a gate's edge), predictions and the pipeline's forward
     within the CPU tests' bounds, gradients leaf by leaf (a Recorder
     optimizer keeps them); its K1 / K2 launches equal the single-process
     run's (the pipeline's stages: each > 0), every distinct launch
     bit-equal to its twin, and its collectives equal to what the code
     gives (`par_collectives`). Walls are second runs of W processes
     sharing the one card, not scaling figures.
 15. data: the dataset path (gns_torch/utils) at full width, under
     build/data_phase/: (a) the host packer gns_torch/csrc/gridpack.cpp
     built at first use (compiler, version, flags, seconds); (b) `python
     -m gns_torch.utils --case 300 --num 1023 --seed 0 --scale 0.5
     --feasible-only` as a user runs it, while this process generates the
     same grids: the npz bit-equal to prepare_case over them, the pickles
     loading (load_all_grids) to the npz's batch (load_prepared), the CLI's
     host seconds; (c) pack_batch of the 1024 case dicts bit-equal to
     _stack_to_batch, csr_by_dst equal to its numpy path, the host ms of
     each (median and range of 5); (d) `python -m gns_torch.train` from the
     data set (K4 L20 H10, batch 256, 2 epochs), its logged losses and
     checkpoint equal to train() in this process on load_prepared's grids,
     whose launches are the CUDA-graph capture's (warm-up and captured
     step at train_launches' counts; the replays call no wrapper); (e)
     `python -m gns_torch.eval` with that checkpoint on the data set's last
     64 pickles (no fallback; the grids it reads equal the generated ones)
     and with the shipped checkpoint, its accuracy metrics equal to
     evaluate() in this process (launches: serving's per forward); (f) the
     physics refresh's method="degree" at bench.py's problem (config A):
     one step's K1 / K2 launches against train_launches, every distinct
     launch bit-equal to its twin, outputs and gradients bit-equal to the
     card's "auto" run and against the port's CPU run, the launches while
     capturing its epoch, and a replayed step's ms against "auto"'s (a b b
     a).
Then one JSON line with every kernel's numbers (K1 / K2 with each rank's
launches per phase-14 path under "parallel_launches" and the data phase's
under "data_launches"; K3 and K4 an entry per width), and last the
{"ok": true, "device": ...} line.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
S_SERVE = 1024
CASE = 300
# bfloat16 serving, card vs the port's CPU path on the same cases:
# (output, atol on every value, bound on the 99.9th percentile of the
# absolute error). Set from the NVIDIA H100 80GB HBM3 readings: v 3.714e-02
# worst and 4.883e-04 at p99.9, theta 2.441e-03 and 9.766e-04, last_loss
# 6.174e-04 and 3.970e-04; each bound is about twice to four times those.
BF16_CARD_VS_CPU = (("v", 7.5e-2, 2e-3), ("theta", 5e-3, 4e-3), ("last_loss", 2e-3, 1.5e-3))
# K4 on the card vs its plain twin on the CPU, same 1024 case300 grids:
# (output, atol on every value, bound on the 99.9th percentile or None).
# Both sum in the same order and round the MLP operands to bf16 at the same
# places, but K4 multiplies on the tensor cores, whose dot products add in
# another order than the twin's float32 matmul; a flipped bf16 rounding is
# then carried by the K steps, as on the eager bfloat16 path through
# cuBLAS's tensor cores. So v, theta and the losses take BF16_CARD_VS_CPU's
# bounds (total_loss last_loss's); delta_p and delta_q keep the worst-value
# bounds set for K4's first, CUDA-core version from its H100 readings
# (7.599e-02 and 3.815e-06).
K4_CARD_VS_CPU = (
    ("v", 7.5e-2, 2e-3), ("theta", 5e-3, 4e-3), ("delta_p", 0.2, None),
    ("delta_q", 1.5e-5, None), ("total_loss", 2e-3, 1.5e-3), ("last_loss", 2e-3, 1.5e-3),
)
# K4 at (L, H) = (40, 10), 300-deep (K=8) on the same 1024 grids, card vs
# its plain twin on the CPU, as K4_CARD_VS_CPU: the same reason, a flipped
# bf16 rounding carried by twice the steps. Set from the NVIDIA H100 80GB
# HBM3 readings (v 1.713e-02 worst, 2.630e-03 at p99.9; theta 1.845e-03 and
# 9.190e-04; delta_p 1.443e-01 worst; delta_q 7.629e-06; total_loss
# 4.603e-04 and 4.476e-04; last_loss 2.981e-04 and 1.856e-04), each about
# three times the reading.
K4_DEEP_CARD_VS_CPU = (
    ("v", 5e-2, 8e-3), ("theta", 6e-3, 3e-3), ("delta_p", 0.45, None),
    ("delta_q", 2.5e-5, None), ("total_loss", 1.5e-3, 1.5e-3), ("last_loss", 1e-3, 6e-4),
)
# K4 at the widths of phase 7b, card vs its plain twin on the CPU, where a
# width cannot meet K4_CARD_VS_CPU: {width: bounds as K4_CARD_VS_CPU}. At
# (128, 128), GNS(cfg, seed=0)'s weights, the NVIDIA H100 80GB HBM3 read
# delta_q 1.526e-05 at worst (2^-16) against K4_CARD_VS_CPU's 1.5e-5, and
# the port's eager bfloat16 forward, card vs CPU on the same weights,
# 7.629e-06 (2^-17): delta_q is what is left of an exact cancellation
# (quirk Q8), the rounding of the bus's reactive sums, so both read one or
# two float32 units in the last place of those sums; K4's other outputs
# deviate less than the eager path's (v 3.992e-04 against 7.935e-04, theta
# 4.476e-04 against 1.190e-03). Its delta_q takes three times K4's
# reading; the rest keep K4_CARD_VS_CPU's. At (8, 8), with GNS(cfg,
# seed=0)'s random weights, the NVIDIA H100 80GB HBM3 read delta_p
# 2.137e-01 worst, total_loss 1.211e-01 and 4.801e-02 at p99.9,
# last_loss 1.085e-01 and 3.993e-02; the port's own eager bfloat16
# forward, card vs CPU on the same weights, read as much or more (delta_p
# 4.401e-01, total_loss 1.033e-01 / 4.884e-02, last_loss 1.170e-01 /
# 4.700e-02): a flipped bf16 rounding carried by the steps, at losses of
# an untrained model. Those three take about three times K4's reading; v,
# theta and delta_q keep K4_CARD_VS_CPU's.
K4_WIDTH_CARD_VS_CPU = {
    (8, 8): (("v", 7.5e-2, 2e-3), ("theta", 5e-3, 4e-3), ("delta_p", 0.65, None),
             ("delta_q", 1.5e-5, None), ("total_loss", 0.36, 0.15), ("last_loss", 0.33, 0.12)),
    (128, 128): (("v", 7.5e-2, 2e-3), ("theta", 5e-3, 4e-3), ("delta_p", 0.2, None),
                 ("delta_q", 4.6e-5, None), ("total_loss", 2e-3, 1.5e-3), ("last_loss", 2e-3, 1.5e-3)),
}
# 300-deep's bf16 MLPs against its float32 forward, a sanity bound (rtol,
# atol): on these 1024 grids K4 on the NVIDIA H100 80GB HBM3 differs from
# the float32 forward by v 0.1017, theta 0.0223 and last_loss 1.35e-3 at
# worst, as K4's plain twin does from the float32 forward on the CPU, so
# theta takes 5e-2 where the L=20 checkpoint's 2e-2 holds.
DEEP_VS_F32 = (("v", 0.0, 0.15), ("theta", 0.0, 5e-2), ("last_loss", 0.1, 5e-2))
EVAL_GRIDS = 64  # eval phase (a): feasible case300 grids, the base case first
# eval phase (b), the case30 multi-seed protocol of tools/accuracy_multiseed.py
SEEDS = (101, 102, 103, 104, 105)
GNS_TPU_BAND = (0.0161, 0.0187)  # gns_tpu's case30 v MSE over those seeds (ACCURACY_SEEDS.json)
WORST_DRAW = 0.0401  # the worst case30 v MSE of either side in ACCURACY_SEEDS.json (0.04006)
SUP_EPOCHS = 5
SOLVE_GRIDS = 256  # solve phase: feasible case300 grids, one chunk at gns_tpu's chunk_size
# Solve phase, each arm on the card against the port's CPU run on the same
# grids: v and theta (degrees) on the converged grids, tests/test_eval.py:209-226's
# bounds (the CPU run of the port against gns_tpu on 32 of these grids read
# v 3.6e-06, theta 4.0e-04).
SOLVE_CARD_VS_CPU = (2e-5, 2e-3)
# A grid whose iteration count differs between the two runs must have been
# accepted, in the run that stopped first, by the stall gate or by the tol
# gate at a mismatch of at least SOLVE_EDGE x tol: at the gate's edge, where
# float32 roundings fall on either side. Set from a CPU run: the port's
# fast-decoupled solve against gns_tpu's on six case30 grids
# (tests/test_torch_fdpf.py's) differed on two grids, accepted at 2.97e-05
# and 2.35e-05 (tol 3e-05) by one package and one iteration later by the
# other; their lock-step counts then differ by one.
SOLVE_EDGE = 0.5
# Against the scipy float64 oracle on every grid, (v, theta in degrees):
# gns_tpu's case30 bounds, Newton tests/test_eval.py:209-226, fast-decoupled
# tests/test_fdpf.py. The port's CPU run on these 256 case300 grids met them:
# Newton v 3.917e-06, theta 8.068e-04; fast-decoupled 1.203e-05, 1.045e-03.
SOLVE_VS_ORACLE = {"nr": (2e-5, 2e-3), "fdpf": (3e-5, 3e-3)}
# DC, card vs CPU: theta in radians, flows relative to the largest |flow|
# (the CPU run against gns_tpu's on these grids read 2.2e-06 rad and
# 3.4e-06 of the largest flow, 163.8 MW).
DC_CARD_VS_CPU = (1e-5, 1e-5)
# DC against the AC oracle, worst angle in degrees: a sanity band, not an
# accuracy bound; DC drops losses and magnitudes, and case300's angles reach
# 58.7 degrees. The port's CPU run on these grids read 47.57 degrees at worst.
DC_VS_ORACLE_DEG = 60.0
# Screen phase: the authentic IEEE case118 (186 branches, 54 generators), at
# gns_tpu's N-2 chunk size and the ranked screens' budgets of
# docs/N1_SCREEN.md (k=64 at N-1, k=256 at N-2).
SCREEN_CASE = 118
SCREEN_CHUNK = 2048
N1_TOP_K, N2_TOP_K = 64, 256
N2_ORACLE_PAIRS = 64  # converged N-2 pairs, drawn with a seed, held against the oracle
# The ranked screens' GNS predictions, card vs the port's CPU run: serving's
# float32 bound on v (each value within 2e-4 + 2e-4 |v_cpu|). Severities are
# held to what that bound lets them move (screen_sev_bound).
SCREEN_V_RTOL = SCREEN_V_ATOL = 2e-4
K3_FWD = dict(rtol=1e-5, atol=1e-5)  # exact float32; dot products add in another order
# K3's forward at the widths of phase 7b where K3_FWD does not hold, card
# vs its plain twin: {width: K3_FWD scaled}, each beside hold_k3's reading
# of the twin's own float32 forward against its float64 one (printed at
# every width past (128, 128)). At (512, 512) the hub index's sum_phi_theta
# (517-term float32 dot products, a 70-edge sum) read 1.070 of K3_FWD card
# vs twin on the NVIDIA H100 80GB HBM3, the card 0.993 and the twin 0.541
# of it against the twin's float64 forward: both float32 sums sit within
# rounding of the exact one, on opposite sides. Its bound is three times
# K3_FWD.
K3_WIDTH_FWD = {(512, 512): dict(rtol=3e-5, atol=3e-5)}
# The (latent, hidden) widths K3 and K4 are built and held at: the shipped
# checkpoints' (20, 10) and (40, 10), then gns_tpu's own K3 test width (8,
# 8), the reference's default (10, 10), an odd latent with hidden > 16
# (33, 24), (64, 32) (whose case300 grid needs 330,240 bytes under K4's
# plan 0), an odd latent over 64 with hidden over three k-tiles (97, 40),
# (128, 128), then past 128: (129, 8), the first latent past it, odd; (200,
# 136), both axes past it, not powers of two; (256, 256), where K4's warp
# scratch no longer fits a case300 block; (512, 64), latent alone (state
# rows of 516 floats, 1,536 aggregate columns); (64, 512), hidden alone (32
# k-tiles); (512, 512). All but the first two from random weights made
# from a seed (phase 7b).
WIDTHS = ((20, 10), (40, 10), (8, 8), (10, 10), (33, 24), (64, 32), (97, 40), (128, 128),
          (129, 8), (200, 136), (256, 256), (512, 64), (64, 512), (512, 512))
NEW_WIDTHS = WIDTHS[2:]
# The widest widths' CPU twins (K4 on the CPU at (512, 512) would take
# about 34 TFLOP of float32, K3's float64 autograd at (512, 64) over a
# minute) hold the first CPU_SUBSET[width] requests of phase 7b's 1024
# (K3: the first samples of its 1024; its loss for the backward reads
# those), and their timing takes fewer repeats; the card runs all 1024,
# K3's forward held against its plain twin on the card at all of them.
CPU_SUBSET = {(256, 256): 128, (512, 64): 128, (64, 512): 128, (512, 512): 128}
# Widths below K3's and K4's range: each must refuse them, naming the rule,
# with no build and no launch (phase 7b, width_limit).
LIMIT_WIDTHS = ((0, 8), (8, 0))
K3_GRAD = dict(rtol=2e-4, atol=1e-5)  # tests/test_fused.py:61
# K3's backward (a recompute through K1 / K2 and cuBLAS) against the plain
# twin's float32 autograd on the CPU, per element, at the widths up to
# (128, 128) where K3_GRAD does not hold: {width: K3_GRAD scaled}. The
# edge stage's LeakyReLUs make its gradient jump where a pre-activation
# crosses 0, and at these widths some of the 1024 x 411 x 6 H
# pre-activations lie within float32 rounding of 0, so a GEMM that adds
# in another order (cuBLAS against MKL) flips a unit's slope and moves a
# weight's gradient, a sum over 420,864 edge rows, past K3_GRAD. On the
# NVIDIA H100 80GB HBM3 the worst leaf used 2.973 (64, 32), 1.429 (97, 40)
# and 9.232 (128, 128) of K3_GRAD; each bound scales K3_GRAD by about
# three times that reading. Past (128, 128) no per-element bound holds:
# one set at three times a reading at (256, 256) (3.689 of K3_GRAD, the
# backward run on 128 samples) read 1.688 of itself when the same
# gradient came from a backward over all 1024 (the loss reading the
# first 128), cuBLAS adding in another order, while the card stayed as
# far from the twin's float64 autograd as the twin's own float32 (2.76e-5
# against 2.71e-5 of the largest element); at (64, 512) and (512, 512) a
# bound wide enough (503.894 and 22570 of K3_GRAD read) passes a gradient
# 30% off or zeroed. Those widths are held by K3_GRAD_NORM.
K3_WIDTH_GRAD = {(64, 32): dict(rtol=1.8e-3, atol=9e-5), (97, 40): dict(rtol=9e-4, atol=4.5e-5),
                 (128, 128): dict(rtol=5.6e-3, atol=2.8e-4)}
# Past (128, 128) K3's backward is held per leaf by a normwise measure:
# rel(g) = max |g - g64| / max |g64|, g64 the plain twin's float64 autograd
# on the CPU. A leaf's largest element reaches 1e3-1e6 there, while a
# flipped slope moves elements near 0 by up to 1e-3 of it, so no
# per-element bound both holds and refuses a zeroed or halved gradient
# (rel 1 and 0.5). The card's rel must stay within K3_GRAD_NORM times the
# twin's own float32 rel in the same run, the worst of the leaf's group:
# the inputs m, feats, line_mask (each element a sum over a few edges) or
# the 18 weights (each a sum over S x 411 edge rows). A flip lands on
# whichever weights it feeds, so one float32 run's reading of a single
# leaf is no scale: at (512, 512) on the NVIDIA H100 80GB HBM3 the card
# read 8.54e-5 on phi_m.w2 where the twin read 6.22e-7, and 6.73e-5 on
# phi_theta.w1 where the twin read 1.70e-3. Against the group's worst the
# card read at most 1.05 of the twin at every width past 128 (0.57 for the
# inputs at (512, 512)); the factor leaves four times that. hold_k3
# checks that a zeroed and a halved gradient fail every bound it holds.
K3_GRAD_NORM = 4.0
S_TRAIN = 256  # bench.py's batch
TRAIN_STEPS = 20
# One update step's gradients, card vs the port's CPU path on the same batch
# and weights, per parameter: max |card - cpu| <= rel * max |cpu| + abs.
# A (float32) keeps the bound tests/test_torch_train.py holds the CPU path
# to against jax.grad: on an NVIDIA H100 80GB HBM3 its worst leaf used
# 0.064 of it. B (bfloat16 MLPs): a GEMM that adds in another order flips
# a bf16 rounding, which the K steps and the backward carry; on the same
# card the worst leaf read 7.629e-06 against a largest |grad| of 9.995e-04
# (7.6e-03 of it) and the next 4.883e-04 against 8.350e-02, so rel is 2e-2,
# about 2.6 times the worst reading.
TRAIN_GRAD = {"A": (2e-4, 1e-6), "B": (2e-2, 1e-6)}


def log(*parts):
    print(*parts, flush=True)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call of fn, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SPIN_CYCLES = 20_000  # torch.cuda._sleep's spin that opens and closes a device_us trace


def device_us(fn, reps: int = 20, pattern: str = "", per_call: int = 0):
    """Kernel-only device time of fn: the durations of the device
    activities the profiler traced over `reps` calls (host launch gaps
    excluded) whose name holds `pattern`, summed, per call, in us; and
    those activities per call. With `per_call`, the number of such
    activities one call makes (one kernel of one name), a trace that left
    some out still gives the mean of the durations it recorded, per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # The profiler now and then leaves out a call's device activity: a trace
    # counts when each kind of activity numbers a whole multiple of `reps`;
    # else trace again, up to six times, and fail after six short traces.
    # (After the train phase it has left one activity out of nearly every
    # trace of the same process, so its readings are taken in a process of
    # its own: phase_train_child.) A short spin kernel opens and closes each
    # trace, so that an activity left out at either end is one of them;
    # they are not counted.
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        kinds = collections.defaultdict(list)
        spins = 0
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA or ev.time_range.end <= ev.time_range.start:
                continue
            if "spin_kernel" in ev.name:
                spins += 1
            elif pattern in ev.name:
                kinds[ev.name].append(ev.time_range.end - ev.time_range.start)
        n = sum(map(len, kinds.values()))
        if n and all(len(spans) % reps == 0 for spans in kinds.values()):
            return sum(map(sum, kinds.values())) / reps, n / reps
        if per_call and len(kinds) == 1 and 0 < n <= per_call * reps:
            log(f"[timing] the trace recorded {n} of {per_call * reps} activities matching "
                f"{pattern!r} and {spins} of its 2 spins: their mean duration is the call's")
            return sum(map(sum, kinds.values())) / n * per_call, per_call
        log(f"[timing] trace {attempt + 1} of 6 recorded {n} device activities matching "
            f"{pattern!r} over {reps} calls, {spins} of its 2 spins: not the same number per call")
    fail(f"the profiler did not record every call's device activity ({pattern!r}) in six traces")


def abba(a, b, rounds: int = 3):
    """Readings of two measurements taken in the order a b b a, `rounds`
    times over, so that a drift of the card or the host falls on both
    alike: (a's readings, b's readings)."""
    ra, rb = [], []
    for _ in range(rounds):
        ra.append(a())
        rb.append(b())
        rb.append(b())
        ra.append(a())
    return ra, rb


def spread(readings) -> str:
    """Median and range of a list of readings in us."""
    return (f"{statistics.median(readings):.2f} us (range {min(readings):.2f} to "
            f"{max(readings):.2f}, n={len(readings)})")


def behind(mine, theirs) -> str:
    """Whether the readings `mine` lose to `theirs`: 'yes' when every one of
    mine is above every one of theirs, 'no' when every one is below, else
    'within noise' (the ranges overlap)."""
    if min(mine) > max(theirs):
        return "yes"
    if max(mine) < min(theirs):
        return "no"
    return "within noise"


def launch_us(fn, before, reps: int = 10) -> float:
    """Mean us of fn alone between two CUDA events, each launch after
    `before()` on the same stream (a sleep, or a write over the L2), so the
    events time the device, not the host's launch pace."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in marks:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return 1e3 * sum(start.elapsed_time(end) for start, end in marks) / reps


def warm_and_cold(fn, pattern: str, reps: int = 10) -> dict:
    """fn's launches (one kernel of `pattern` a call) with the L2 as the
    previous launch left it (warm) and
    after a 128 MB write, more than the H100's 50 MB L2 (cold): CUDA events
    around each launch alone (a ~1 ms sleep ahead of each, so the host has
    enqueued it before the device gets there), and the profiler's
    kernel-only device time of the cold launches. In us."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")

    def sleep():
        torch.cuda._sleep(2_000_000)

    def cold():
        flush.fill_(1.0)
        sleep()

    out = dict(warm=launch_us(fn, sleep, reps), cold=launch_us(fn, cold, reps))
    out["cold_device"], _ = device_us(lambda: (flush.fill_(1.0), fn()), reps=reps, pattern=pattern,
                                      per_call=1)
    del flush
    return out


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def phase_build(kern) -> dict:
    """Builds segment.cu, K3 and K4 at every width of WIDTHS, one nvcc per
    library, all started together; returns
    {library: (path, ptxas lines, seconds, ptxas entries)}, a library keyed
    "segment" or (name, width)."""
    t0 = time.perf_counter()
    libs = [name for name in kern.SOURCES if name not in kern.WIDTHED]
    libs += [(name, width) for name in kern.WIDTHED for width in WIDTHS]
    info = kern.build_kernels(libs)
    check(set(info) == set(libs), f"built {sorted(map(str, info))}, wanted {sorted(map(str, libs))}")
    built = {}
    for lib, one in info.items():
        log(f"[build] {os.path.relpath(one['path'])} built in {one['seconds']:.2f} s")
        lines = [line.strip() for line in one["log"].splitlines()
                 if "registers" in line or "spill" in line or "entry function" in line
                 or "error" in line.lower()]
        for line in lines:
            log(f"[build]   {line}")
        built[lib] = (one["path"], lines, one["seconds"], ptxas_entries(one["log"]))
    log(f"[build] {len(info)} libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    return built


def ptxas_entries(log_text: str) -> list:
    """ptxas's report per entry function of a build log: [(name,
    registers, spill store bytes, spill load bytes)]."""
    import re

    out, cur = [], None
    for line in log_text.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            cur = [hit.group(1), None, None, None]
            out.append(cur)
            continue
        if cur is None:
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit:
            cur[2], cur[3] = int(hit.group(1)), int(hit.group(2))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            cur[1] = int(hit.group(1))
    return [tuple(e) for e in out]


def case300_indices():
    from gns_torch.utils.prepare import base_case_batch, extract_shared_topology

    batch = base_case_batch(CASE)
    topo = extract_shared_topology(batch)
    return batch, topo


def make_compare(errs: dict, tag: str):
    """A checker of one kernel output against its plain twin on the same
    inputs: against the twin on CPU copies, which adds in the kernel's
    order (per segment, edges in edge order; rtol = atol = 1e-6 in
    float32, rtol 1e-2 in bfloat16), and against the twin on the card,
    where index_add_ adds in atomic order (rtol = atol = 1e-5)."""
    tol = {torch.float32: dict(rtol=1e-6, atol=1e-6), torch.bfloat16: dict(rtol=1e-2, atol=1e-6)}

    def compare(name, got, want, dtype, what, on_card=None):
        want = want.to(got.dtype)
        err = (got.cpu().float() - want.float()).abs().max().item()
        errs[name] = max(errs[name], err)
        ok = torch.allclose(got.cpu().float(), want.float(), **tol[dtype])
        card = ""
        if on_card is not None:
            card_err = (got.float() - on_card.float()).abs().max().item()
            card_ok = torch.allclose(got.float(), on_card.float(), rtol=1e-5, atol=1e-5)
            ok = ok and card_ok
            card = f", plain twin on the card {card_err:.3e}"
        log(f"[{tag}] {name} {what} max_abs_err {err:.3e}{card} {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} {what} disagrees with its plain twin")

    return compare


def check_k2(kern, x, ids, compare, what, variants):
    """K2 on x against its plain twin (bit for bit: a gather is a copy), and
    its library's launch plan against the Python mirror of it."""
    got = kern.gather_cuda(x, ids)
    torch.cuda.synchronize()
    want = kern.gather_plain(x.cpu(), ids.cpu())
    on_card = kern.gather_plain(x, ids)
    compare("K2", got, want, x.dtype, what, on_card)
    check(torch.equal(got.cpu(), want) and torch.equal(got, on_card), f"K2 {what} is not bit-equal")
    s, _, d = x.shape
    args = (s, ids.numel(), d * x.element_size(), x.data_ptr(), got.data_ptr())
    plan, mirror = kern.gather_plan_cuda(*args), kern.gather_plan(*args)
    check(plan == mirror, f"K2 plan {plan} != its Python mirror {mirror} ({what})")
    variants.setdefault(plan["variant"], set()).add(plan["unit"])


def phase_kernels(kern, seg, errs):
    """K1 / K2 against their plain twins on random data at the case300
    index sets, S=1024, D in {1, 2, 4, 20, 60}, both dtypes; then each
    kernel's autograd backward (the other kernel) against the plain
    gradient."""
    batch, topo = case300_indices()
    n, e = batch.buses.shape[1], batch.lines.shape[1]
    dev = torch.device("cuda")
    idx = {
        "dst": seg.SegmentIndex(topo.dst, n, dev),
        "gen": seg.SegmentIndex(topo.gen_idx, n, dev),
        "src_rows": seg.SegmentIndex(topo.src, e, dev),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    compare = make_compare(errs, "kernels")
    variants = {}  # K2 plan variant -> unit bytes seen

    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 2, 4, 20, 60):
            for iname in ("dst", "gen") if d in (1, 4) else ("dst",):
                ix = idx[iname]
                rows_in = len(topo.gen_idx) if iname == "gen" else e
                x = torch.randn((S_SERVE, rows_in, d), generator=gen, device=dev).to(dtype)
                got = kern.segment_sum_cuda(x, ix.order, ix.indptr, ix.n)
                torch.cuda.synchronize()
                want = kern.segment_sum_plain(x.cpu(), ix.order.cpu(), ix.indptr.cpu(), ix.n)
                on_card = kern.segment_sum_plain(x, ix.order, ix.indptr, ix.n)
                compare("K1", got, want, dtype, f"{iname} D={d} {str(dtype)[6:]}", on_card)
            for iname, rows in (("dst", n), ("src_rows", e)) if d in (1, 4) else (("dst", n),):
                ix = idx[iname]
                x = torch.randn((S_SERVE, rows, d), generator=gen, device=dev).to(dtype)
                check_k2(kern, x, ix.ids, compare, f"{iname} D={d} {str(dtype)[6:]}", variants)
    # K2's other shapes and alignments: a flattened per-sample index (one
    # sample, a (1, S*N) table), rows of 8 bf16 (one 16-byte word), and
    # data 2 bytes off a 4-byte word (2-byte units)
    flat = seg.SegmentIndex(np.tile(topo.dst, (64, 1)), n, dev)
    for d in (1, 4):
        x = torch.randn((64, n, d), generator=gen, device=dev)
        check_k2(kern, flat._flat(x), flat.ids, compare, f"flattened per-sample dst D={d} float32",
                 variants)
    for d in (2, 8):
        x = torch.randn((S_SERVE, n, d), generator=gen, device=dev).to(torch.bfloat16)
        check_k2(kern, x, idx["dst"].ids, compare, f"dst D={d} bfloat16", variants)
    x = torch.randn((S_SERVE, n, 5), generator=gen, device=dev)  # 20-byte rows: 4-byte units
    check_k2(kern, x, idx["dst"].ids, compare, "dst D=5 float32", variants)
    base = torch.randn((S_SERVE * n * 20 + 1,), generator=gen, device=dev).to(torch.bfloat16)
    x = base[1:1 + S_SERVE * n * 2].view(S_SERVE, n, 2)
    check_k2(kern, x, idx["dst"].ids, compare, "dst D=2 bfloat16, data 2 bytes off", variants)
    x = base[1:1 + S_SERVE * n * 20].view(S_SERVE, n, 20)
    check_k2(kern, x, idx["dst"].ids, compare, "dst D=20 bfloat16, data 2 bytes off", variants)
    names = {0: "narrow", 1: "word / wide"}
    log(f"[kernels] K2 variants checked, with the plan's unit bytes: "
        + "; ".join(f"{names[v]} {sorted(u)}" for v, u in sorted(variants.items())))
    check(variants == {0: {2, 4}, 1: {2, 4, 8, 16}},
          f"K2 variants and unit bytes checked {variants}, want narrow 2 and 4, word / wide 2 to 16")

    # autograd: K1's backward launches K2, K2's launches K1
    x = torch.randn((S_SERVE, e, 60), generator=gen, device=dev, requires_grad=True)
    w = torch.randn((S_SERVE, n, 60), generator=gen, device=dev)
    (seg.segment_sum(x, idx["dst"]) * w).sum().backward()
    xc = x.detach().cpu().requires_grad_(True)
    (seg.segment_sum(xc, seg.SegmentIndex(topo.dst, n, "cpu")) * w.cpu()).sum().backward()
    compare("K2", x.grad, xc.grad, torch.float32, "as K1 backward D=60 float32")
    m = torch.randn((S_SERVE, n, 20), generator=gen, device=dev, requires_grad=True)
    wg = torch.randn((S_SERVE, e, 20), generator=gen, device=dev)
    (seg.gather(m, idx["dst"]) * wg).sum().backward()
    mc = m.detach().cpu().requires_grad_(True)
    (seg.gather(mc, seg.SegmentIndex(topo.dst, n, "cpu")) * wg.cpu()).sum().backward()
    compare("K1", m.grad, mc.grad, torch.float32, "as K2 backward D=20 float32")


class PathRecorder:
    """Stands in for ops/segment.py's handle on ops/segment_kernels.py while
    the main path runs, and keeps a copy of the first input of every
    distinct kernel launch (kernel, data shape, dtype, index), so that
    phase_path_inputs can hold the kernels against their plain twins on
    exactly what the path sent them. Each call goes on to the wrapper
    itself, once, so the wrappers' launch counts are the path's own."""

    def __init__(self, kern, seg):
        self.kern, self.seg = kern, seg
        self.inputs = {}  # key -> [args, launches]

    def _keep(self, key, args):
        if key not in self.inputs:
            self.inputs[key] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args), 0]
        self.inputs[key][1] += 1

    def __getattr__(self, name):  # every other name of the kernel module
        return getattr(self.kern, name)

    def segment_sum_cuda(self, data, order, indptr, n):
        self._keep(("K1", tuple(data.shape), data.dtype, order.data_ptr(), n),
                   (data, order, indptr, n))
        return self.kern.segment_sum_cuda(data, order, indptr, n)

    def gather_cuda(self, data, ids, masked=False):
        self._keep(("K2", tuple(data.shape), data.dtype, ids.data_ptr()), (data, ids, masked))
        return self.kern.gather_cuda(data, ids, masked)

    def __enter__(self):
        self.seg.kern = self
        return self

    def __exit__(self, *exc):
        self.seg.kern = self.kern
        return False


def phase_path_inputs(kern, recorded: dict, errs):
    """Every distinct K1 / K2 launch of the float32 and bfloat16 serving
    runs, replayed on its recorded input and held against its plain twin."""
    compare = make_compare(errs, "path")
    for key, (args, count) in recorded.items():
        name, shape, dtype = key[:3]
        what = f"S={shape[0]} rows={shape[1]} D={shape[2]} {str(dtype)[6:]} x{count}"
        if name == "K1":
            data, order, indptr, n = args
            got = kern.segment_sum_cuda(data, order, indptr, n)
            torch.cuda.synchronize()
            want = kern.segment_sum_plain(data.cpu(), order.cpu(), indptr.cpu(), n)
            compare("K1", got, want, dtype, f"n={n} {what}", kern.segment_sum_plain(*args))
        else:
            data, ids, masked = args
            got = kern.gather_cuda(data, ids, masked)
            torch.cuda.synchronize()
            want = kern.gather_plain(data.cpu(), ids.cpu(), masked)
            compare("K2", got, want, dtype, f"E={ids.numel()} {what}", kern.gather_plain(*args))
    check({k[0] for k in recorded} == {"K1", "K2"}, "the serving runs did not record both kernels")


def phase_parity():
    from gns_torch.models.gns import GNS, gns_forward_batch
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import _stack_to_batch

    here = os.path.dirname(os.path.abspath(__file__))
    g = np.load(os.path.join(here, "tests", "golden", "multiphi_K4_L20_H10_case300_grid1.npz"))
    cfg = GNSConfig(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True, reference_parity=True)
    model = GNS(cfg, device="cuda")
    model.load_state_dict({k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd.")})
    batch = _stack_to_batch([(g["buses"], g["lines"], g["generators"])])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        out = gns_forward_batch(model, cfg, batch, dense=True)
    got = {k: getattr(out, k)[0].cpu().numpy() for k in ("v", "theta", "delta_p")}
    checks = [  # tests/test_parity.py:53-69 and :178-187 tolerances
        ("v", got["v"], g["v"], 2e-4, 2e-4),
        ("theta", got["theta"], g["theta"], 2e-4, 2e-4),
        ("total_loss", float(out.total_loss[0]), float(g["total_loss"]), 5e-4, 0.0),
        ("last_loss", float(out.last_loss[0]), float(g["last_loss"]), 5e-4, 0.0),
        ("delta_p", got["delta_p"], g["delta_p"][-1], 2e-3, 5e-5),
    ]
    for name, a, b, rtol, atol in checks:
        err = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        ok = np.allclose(a, b, rtol=rtol, atol=atol)
        log(f"[parity] case300 golden {name} max_abs_err {err:.3e} "
            f"(rtol {rtol:g} atol {atol:g}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"golden parity {name}")


def wrappers() -> dict:
    """The port's CUDA wrappers by kernel tag. Each adds one to its
    `launches` where it launches its kernel, and nowhere else."""
    from gns_torch.ops import segment_kernels as kern
    from gns_torch.ops.fused import fused_edge_cuda
    from gns_torch.ops.megakernel import megakernel_cuda

    return {"K1": kern.segment_sum_cuda, "K2": kern.gather_cuda,
            "K3": fused_edge_cuda, "K4": megakernel_cuda}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def agree(tag, label, a, b, rtol, atol, key, p999=None):
    """a (numpy, the card's) against b: allclose, finite, same shape, and
    optionally the 99.9th percentile of |a - b| at most p999."""
    err = np.abs(a.astype(np.float64) - b)
    q = float(np.quantile(err, 0.999))
    ok = bool(np.isfinite(a).all()) and a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol)
    ok = ok and (p999 is None or q <= p999)
    bound = "" if p999 is None else f" p99.9 <= {p999:g}"
    log(f"[{tag}] {label} {key} shape {a.shape} max_abs_err {float(err.max()):.3e} "
        f"p99.9 {q:.3e} (rtol {rtol:g} atol {atol:g}{bound}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{label} {key}")
    return float(err.max()), q


def phase_serving(kern, seg):
    """Returns the cases, the card's model, its config, the float32 run's
    launch counts, the inputs of every distinct kernel launch of both runs
    (PathRecorder) and the bfloat16 run's card-vs-CPU readings {output:
    (worst, p99.9)}."""
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.serve import GNSPredictor
    from gns_torch.utils.augment import generate_cases

    t0 = time.perf_counter()
    cases = list(generate_cases(CASE, S_SERVE - 1, seed=0))
    log(f"[serving] generated {len(cases)} case{CASE} requests in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    model, cfg = load_pretrained(CASE, device="cuda")
    model_cpu, _ = load_pretrained(CASE, device="cpu")
    pred = GNSPredictor(model, cfg, batch_size=S_SERVE, device="cuda")
    recorder = PathRecorder(kern, seg)

    reset_counts()
    with recorder:
        out = pred.predict(cases)
        torch.cuda.synchronize()
    launches = counts()
    want = {"K1": 1 + 4 * cfg.K, "K2": 2 + 5 * cfg.K, "K3": 0, "K4": 0}
    log(f"[serving] float32 b{S_SERVE} launches {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != {want}")

    ref = GNSPredictor(model_cpu, cfg, batch_size=S_SERVE, device="cpu").predict(cases)
    for key, rtol, atol in (("v", 2e-4, 2e-4), ("theta", 2e-4, 2e-4), ("last_loss", 5e-4, 0.0)):
        agree("serving", "float32 card vs cpu", out[key], ref[key], rtol, atol, key)

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    pred16 = GNSPredictor(model, cfg16, batch_size=S_SERVE, device="cuda")
    reset_counts()
    with recorder:
        out16 = pred16.predict(cases)
        torch.cuda.synchronize()
    launches16 = counts()
    want16 = {"K1": 2 + 4 * cfg.K, "K2": 2 + 5 * cfg.K, "K3": 0, "K4": 0}
    log(f"[serving] bfloat16 (fold on) launches {launches16} (expected {want16})")
    check(launches16 == want16, f"bf16 launch counts {launches16} != {want16}")
    # The card's bfloat16 path against the same port's bfloat16 path on
    # the CPU, same cases and weights: the two differ only where a GEMM's
    # order of adds flips a bfloat16 rounding, which the K steps carry on.
    ref16 = GNSPredictor(model_cpu, cfg16, batch_size=S_SERVE, device="cpu").predict(cases)
    bf16_readings = {key: agree("serving", "bfloat16 card vs cpu", out16[key], ref16[key], 0.0,
                                atol, key, p999)
                     for key, atol, p999 in BF16_CARD_VS_CPU}
    # Sanity bound against float32 only. On this trained checkpoint gns_tpu's
    # own bfloat16 path differs from its float32 path by up to 0.087 in v
    # (256 of these grids; ~4% of buses beyond test_megakernel's 2e-2), and
    # tests/test_torch_serve.py holds the port's bf16 deviation to the JAX
    # package's.
    for key, rtol, atol in (("v", 0.0, 0.15), ("theta", 0.0, 2e-2), ("last_loss", 0.1, 5e-2)):
        agree("serving", "bfloat16 vs float32", out16[key], out[key], rtol, atol, key)
    return cases, model, cfg, launches, recorder.inputs, bf16_readings


class NoPlainTwins:
    """While active, a plain twin of K1 / K2 called on a CUDA tensor fails
    the run: the card's path must reach the kernels, never their twins."""

    def __init__(self, kern):
        self.kern = kern
        self.saved = {}

    def __enter__(self):
        for name in ("segment_sum_plain", "gather_plain"):
            fn = getattr(self.kern, name)
            self.saved[name] = fn

            def guard(data, *args, _fn=fn, _name=name):
                check(not data.is_cuda, f"{_name} ran on a CUDA tensor on the card's path")
                return _fn(data, *args)

            setattr(self.kern, name, guard)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.kern, name, fn)
        return False


def k3_problem(model, seed: int = 0):
    """K3's inputs at the case300 dst index, S=1024: step 0's phi heads of
    the shipped checkpoint, m and feats from a seeded generator, about 10%
    of the line_mask at 0."""
    from gns_torch.models.gns import PHI_HEADS, _block
    from gns_torch.ops.segment import SegmentIndex

    batch, topo = case300_indices()
    n, e = batch.buses.shape[1], batch.lines.shape[1]
    latent = model.cfg.latent_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((S_SERVE, n, latent), generator=gen, device="cuda")
    feats = torch.randn((S_SERVE, e, 5), generator=gen, device="cuda")
    line_mask = (torch.rand((S_SERVE, e), generator=gen, device="cuda") > 0.1).float()
    heads = {h: {k: t.detach().clone() for k, t in _block(getattr(model, h)[0]).items()}
             for h in PHI_HEADS}
    return m, feats, line_mask, SegmentIndex(topo.dst, n, "cuda"), heads, topo


def k3_f64(params, index, grads: bool = True):
    """The plain twin in float64 on the CPU (gather and CSR sum kept in
    float64) at params' values (m, feats, line_mask and the 18 weights):
    its three outputs and, with `grads`, the gradients of the sum of
    squares of the outputs with respect to each of params."""
    from gns_torch.ops import fused

    x = [t.detach().cpu().double().requires_grad_(grads) for t in params]
    ids, order = index.ids.long(), index.order.long()
    seg = torch.repeat_interleave(torch.arange(index.n), (index.indptr[1:] - index.indptr[:-1]).long())
    with torch.set_grad_enabled(grads):
        outs = fused._edge_stage(
            x[0], x[1], x[2], x[3:], 0.01, lambda v: v.index_select(1, ids),
            lambda v: torch.zeros((v.shape[0], index.n, v.shape[2]), dtype=v.dtype).index_add(
                1, seg, v.index_select(1, order)))
    if not grads:
        return outs, None
    sum((o * o).sum() for o in outs).backward()
    return [o.detach() for o in outs], [t.grad for t in x]


def rel_err(got, want) -> float:
    """Normwise: the largest |got - want| over the largest |want|."""
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def hold_k3(kern, model, errs, tag: str = "fused", seed: int = 0, samples: int = S_SERVE) -> int:
    """K3 through its public entry point at the model's width on
    k3_problem's S_SERVE samples: the forward on the card against the
    plain twin on the card (K3_FWD, or the width's K3_WIDTH_FWD), and on
    its first `samples` samples against the plain twin on the CPU; the
    autograd backward of a loss over those first samples up to (128, 128)
    against the CPU autograd per element (K3_GRAD, or the width's
    K3_WIDTH_GRAD), past it per leaf against the twin's float64 autograd
    (K3_GRAD_NORM), each bound beside the twin's own float32 reading
    against its float64 forward or autograd; every bound held must refuse
    a zeroed and a halved gradient. Then on a made-up hub index. Returns
    the forward's K3 launch count."""
    from gns_torch.ops import fused
    from gns_torch.ops.segment import SegmentIndex

    m, feats, line_mask, idx, heads, topo = k3_problem(model, seed)
    if samples < S_SERVE:
        log(f"[{tag}] K3 on the card at all {S_SERVE} samples, against the CPU on the first "
            f"{samples} (CPU_SUBSET)")
    params = [m, feats, line_mask] + fused._weights(heads)
    for t in params:
        t.requires_grad_(True)
    reset_counts()
    with NoPlainTwins(kern):
        out = fused.fused_edge_stage(m, feats, line_mask, idx, heads)
        torch.cuda.synchronize()
        fwd = counts()
        want = {"K1": 0, "K2": 0, "K3": 1, "K4": 0}
        log(f"[{tag}] forward launches {fwd} (expected {want})")
        check(fwd == want, f"K3 forward launches {fwd} != {want}")
        # the loss reads the samples the CPU holds
        sum((o[:samples] * o[:samples]).sum() for o in out).backward()
        torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    # the recompute: 1 K2 gather and 3 K1 sums; their adjoints: 3 K2 and 1 K1
    want = {"K1": 4, "K2": 4, "K3": 0, "K4": 0}
    log(f"[{tag}] backward launches {bwd} (expected {want}; no plain twin ran on the card)")
    check(bwd == want, f"K3 backward launches {bwd} != {want}")

    sub = [t.detach()[:samples] for t in params[:3]] + [t.detach() for t in params[3:]]
    grads = [t.grad[:samples] for t in params[:3]] + [t.grad for t in params[3:]]
    cpu = [t.cpu().requires_grad_(True) for t in sub]
    heads_cpu = {h: dict(zip(fused._PARAMS, cpu[3 + 6 * i: 9 + 6 * i]))
                 for i, h in enumerate(fused.PHI_HEADS)}
    idx_cpu = SegmentIndex(topo.dst, idx.n, "cpu")
    want_out = fused.fused_edge_stage_plain(cpu[0], cpu[1], cpu[2], idx_cpu, heads_cpu)
    sum((o * o).sum() for o in want_out).backward()
    with torch.no_grad():
        on_card = fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads)
    names = [f"sum_{h}" for h in fused.PHI_HEADS]
    labels = ["m", "feats", "line_mask"] + [f"{h}.{n}" for h in fused.PHI_HEADS for n in fused._PARAMS]
    width = (m.shape[2], heads["phi_v"]["w1"].shape[0])
    wide = max(width) > 128
    tol = K3_WIDTH_GRAD.get(width, None if wide else K3_GRAD)
    fwd_tol = K3_WIDTH_FWD.get(width, K3_FWD)
    exact_out = exact = None
    if width in K3_WIDTH_GRAD or wide:
        exact_out, exact = k3_f64(sub, idx_cpu)
    elif width in K3_WIDTH_FWD:
        exact_out, _ = k3_f64(sub, idx_cpu, grads=False)

    def share(got, want, bound=tol):  # the share of the allowed error used
        return ((got.double() - want.double()).abs()
                / (bound["atol"] + bound["rtol"] * want.double().abs())).max().item()

    for i, (name, got, want_o, card) in enumerate(zip(names, out, want_out, on_card)):
        got = got.detach()
        head = got[:samples].cpu()
        err = (head - want_o.detach()).abs().max().item()
        card_err = (got - card).abs().max().item()
        errs["K3"] = max(errs["K3"], err, card_err)
        ok = torch.allclose(head, want_o.detach(), **fwd_tol) and torch.allclose(got, card, **fwd_tol)
        log(f"[{tag}] {name} max_abs_err {err:.3e} vs the plain twin on the CPU ({samples} samples), "
            f"{card_err:.3e} on the card ({S_SERVE}) (rtol {fwd_tol['rtol']:g} atol "
            f"{fwd_tol['atol']:g}; {share(head, want_o.detach(), fwd_tol):.3f} of it used) "
            f"{'ok' if ok else 'MISMATCH'}")
        if exact_out is not None:
            # the card's float32 forward and the twin's own, each against
            # the twin's float64 forward, in shares of K3_FWD
            log(f"[{tag}] {name} against the twin's float64 forward: the card "
                f"{share(head, exact_out[i], K3_FWD):.3f} of K3_FWD "
                f"({(head.double() - exact_out[i]).abs().max().item():.3e}), the twin's float32 "
                f"{share(want_o.detach(), exact_out[i], K3_FWD):.3f} "
                f"({(want_o.detach().double() - exact_out[i]).abs().max().item():.3e})")
        check(ok, f"K3 {name} disagrees with its plain twin")

    if wide:
        # K3_GRAD_NORM's scale: the twin's own float32 rel, the worst of
        # each group (the three inputs, the 18 weights)
        twin_rel = [rel_err(c.grad, exact[i]) for i, c in enumerate(cpu)]
        scale = [max(twin_rel[:3])] * 3 + [max(twin_rel[3:])] * (len(cpu) - 3)
    worst, worst_label, twin_worst, norm_worst = -1.0, "", 0.0, 0.0
    for i, (label, g, c) in enumerate(zip(labels, grads, cpu)):
        g = g.cpu()
        parts = []
        ok = True
        if tol is not None:
            used = share(g, c.grad)
            if used > worst:
                worst, worst_label = used, label
            ok = torch.allclose(g, c.grad, **tol)
            check(not torch.allclose(torch.zeros_like(c.grad), c.grad, **tol)
                  and not torch.allclose(0.5 * c.grad, c.grad, **tol),
                  f"K3's per-element bound at {width} passes a zeroed or halved gradient of {label}")
            parts.append(f"card vs the twin's float32 autograd {used:.3f} of its bound")
        if exact is not None:
            twin = share(c.grad, exact[i], K3_GRAD)
            twin_worst = max(twin_worst, twin)
            parts.append(f"against its float64 autograd, in shares of K3_GRAD, the card "
                         f"{share(g, exact[i], K3_GRAD):.3f}, the twin's float32 {twin:.3f}; rel "
                         f"(largest |grad| {exact[i].abs().max().item():.3e}): card vs twin "
                         f"{rel_err(g, c.grad):.2e}, card vs float64 {rel_err(g, exact[i]):.2e}, "
                         f"twin vs float64 {rel_err(c.grad, exact[i]):.2e}")
        if wide:
            bound = K3_GRAD_NORM * scale[i]
            card_rel = rel_err(g, exact[i])
            norm_worst = max(norm_worst, card_rel / scale[i])
            ok = ok and card_rel <= bound
            check(rel_err(torch.zeros_like(exact[i]), exact[i]) > bound
                  and rel_err(0.5 * exact[i], exact[i]) > bound,
                  f"K3_GRAD_NORM at {width} passes a zeroed or halved gradient of {label} "
                  f"(bound {bound:.3e})")
            parts.append(f"K3_GRAD_NORM bound {bound:.3e} (the group's twin {scale[i]:.3e})")
        if exact is not None or not ok:
            log(f"[{tag}] grad {label}: " + "; ".join(parts) + ("" if ok else " MISMATCH"))
        check(ok, f"K3 backward: grad of {label} disagrees with the CPU autograd")
    held = [] if tol is None else [f"per element within rtol {tol['rtol']:g} atol {tol['atol']:g} "
                                   f"of the plain twin's autograd on the CPU (the worst, "
                                   f"{worst_label}, uses {worst:.3f} of its bound)"]
    if wide:
        held.append(f"per leaf within {K3_GRAD_NORM:g} x the twin's own float32 rel against its "
                    f"float64 autograd (the card's worst: {norm_worst:.3f} of the twin's)")
    log(f"[{tag}] backward: all {len(labels)} gradients " + "; ".join(held)
        + (f"; the twin's own float32 gradient uses up to {twin_worst:.3f} of K3_GRAD against its "
           f"float64 one" if exact is not None else "")
        + "; a zeroed and a halved gradient fail every bound held")

    # a hub bus with 70 in-edges (a work item over several tiles) beside
    # buses with none, which case300 (in-degree < 10) never reaches
    rng = np.random.default_rng(3)
    dst = np.concatenate([np.full(70, 5), rng.integers(0, 30, 60)])
    rng.shuffle(dst)
    hub = SegmentIndex(dst, 32, "cuda")
    check(np.diff(hub.indptr.cpu().numpy()).max() > fused.ROWS, "the hub index has no hub")
    gen = torch.Generator(device="cuda").manual_seed(5)
    hm = torch.randn((64, 32, m.shape[2]), generator=gen, device="cuda")
    hf = torch.randn((64, len(dst), 5), generator=gen, device="cuda")
    hk = (torch.rand((64, len(dst)), generator=gen, device="cuda") > 0.1).float()
    hw = [w.detach() for w in fused._weights(heads)]
    with torch.no_grad():
        got = fused.fused_edge_cuda(hm, hf, hk, hub, hw, 0.01)
        torch.cuda.synchronize()
        on_card = fused.fused_edge_stage_plain(hm, hf, hk, hub, heads)
    want_h = fused.fused_edge_stage_plain(hm.cpu(), hf.cpu(), hk.cpu(), SegmentIndex(dst, 32, "cpu"),
                                          {h: {k: t.detach().cpu() for k, t in p.items()}
                                           for h, p in heads.items()})
    exact_h = None
    if exact_out is not None:  # the twin's float64 forward on the hub index too
        exact_h, _ = k3_f64([hm, hf, hk] + hw, SegmentIndex(dst, 32, "cpu"), grads=False)
    for name, g, w, c in zip(names, got, want_h, on_card):
        err = max((g.cpu() - w).abs().max().item(), (g - c).abs().max().item())
        errs["K3"] = max(errs["K3"], err)
        ok = torch.allclose(g.cpu(), w, **fwd_tol) and torch.allclose(g, c, **fwd_tol)
        log(f"[{tag}] hub index (70-edge bus, S=64) {name} max_abs_err {err:.3e} "
            f"({share(g.cpu(), w, fwd_tol):.3f} of its bound) {'ok' if ok else 'MISMATCH'}"
            + ("" if exact_h is None else
               f"; against the twin's float64 forward the card {share(g.cpu(), exact_h[names.index(name)], K3_FWD):.3f} "
               f"of K3_FWD, the twin's float32 {share(w, exact_h[names.index(name)], K3_FWD):.3f}"))
        check(ok, f"K3 {name} on the hub index disagrees with its plain twin")
    return fwd["K3"]


def phase_fused(kern, model, errs, built):
    """K3 at (20, 10) through hold_k3 with the shipped checkpoint's heads;
    ptxas must report no spill for K3 at (20, 10) or (40, 10). Returns the
    forward's K3 launch count."""
    launches = hold_k3(kern, model, errs)
    for width in ((20, 10), (40, 10)):
        lines = built[("fused_edge", width)][1]
        spills = [line for line in lines if "spill" in line]
        log(f"[fused] ptxas at {width}: " + " | ".join(lines))
        check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in line
                                   for line in spills),
              f"K3's ptxas report at {width} shows spills (or none was printed)")
    return launches


def phase_fused_deep(kern, deep, errs):
    """K3 at (L, H) = (40, 10): 300-deep's step-0 phi heads at the case300
    dst index, S=1024, through fused_edge_stage: one K3 launch, against its
    plain twin on the CPU and on the card (K3_FWD); its shared bytes and
    blocks per SM."""
    from gns_torch.ops import fused
    from gns_torch.ops.segment import SegmentIndex

    m, feats, line_mask, idx, heads, topo = k3_problem(deep, seed=2)
    reset_counts()
    with NoPlainTwins(kern), torch.no_grad():
        out = fused.fused_edge_stage(m, feats, line_mask, idx, heads)
        torch.cuda.synchronize()
    got = counts()
    want = {"K1": 0, "K2": 0, "K3": 1, "K4": 0}
    log(f"[fused] 300-deep (L=40, H=10) forward launches {got} (expected {want})")
    check(got == want, f"K3 L=40 forward launches {got} != {want}")
    with torch.no_grad():
        on_card = fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads)
    want_out = fused.fused_edge_stage_plain(
        m.cpu(), feats.cpu(), line_mask.cpu(), SegmentIndex(topo.dst, idx.n, "cpu"),
        {h: {k: t.cpu() for k, t in p.items()} for h, p in heads.items()})
    for h, g, w, c in zip(fused.PHI_HEADS, out, want_out, on_card):
        err = max((g.cpu() - w).abs().max().item(), (g - c).abs().max().item())
        errs["K3"] = max(errs["K3"], err)
        ok = torch.allclose(g.cpu(), w, **K3_FWD) and torch.allclose(g, c, **K3_FWD)
        log(f"[fused] 300-deep sum_{h} max_abs_err {err:.3e} vs the plain twin on the CPU and "
            f"the card (rtol {K3_FWD['rtol']:g} atol {K3_FWD['atol']:g}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"K3 L=40 sum_{h} disagrees with its plain twin")
    shared, per_sm, threads, sms, _ = fused.fused_edge_occupancy(40, 10)
    log(f"[fused] L=40: {threads} threads and {shared} bytes of shared memory per block, "
        f"{per_sm} blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    check(per_sm >= 2, f"K3 at L=40 keeps {per_sm} blocks per SM, its launch bounds ask for 2")


def sass_hmma(library: str):
    """Counts of HMMA (tensor-core) instructions in a built library's SASS
    per kernel function (its mangled name), from cuobjdump, or None where
    the toolkit has no cuobjdump."""
    import shutil

    import importlib.util

    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")  # Triton's package carries one too
    if spec is not None and spec.submodule_search_locations:
        cands.append(os.path.join(spec.submodule_search_locations[0], "backends", "nvidia",
                                  "bin", "cuobjdump"))
    tool = next((c for c in cands if c and os.path.exists(c)), None)
    if tool is None:
        return None
    run = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300)
    check(run.returncode == 0, f"cuobjdump -sass failed: {run.stderr.strip()[:300]}")
    counts, name = {}, None
    for line in run.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def hmma_of(counts: dict, wide: bool) -> int:
    """HMMA count of K4's plan-0 instance (megakernel<L, H, false>, mangled
    Lb0E) or of its wide one (Lb1E), from sass_hmma's counts."""
    tag = "Lb1E" if wide else "Lb0E"
    found = [n for name, n in counts.items() if "megakernel" in name and tag in name]
    check(len(found) == 1, f"K4's SASS has {len(found)} {'wide' if wide else 'plan-0'} instances "
                           f"({sorted(counts)})")
    return found[0]


def phase_megakernel(kern, cases, model, cfg, errs, built, bf16_readings):
    """K4 through megakernel_forward_batch on the serving requests; returns
    its K4 launch count."""
    from gns_torch.models.gns import gns_forward_batch
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.ops.megakernel import (megakernel_forward_batch, megakernel_forward_plain,
                                          megakernel_inputs, megakernel_occupancy)
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    batch = batch_from_cases(cases)
    topo = extract_shared_topology(batch)
    check(topo is not None, "the case300 requests do not share a topology")
    path, ptxas = built[("megakernel", (20, 10))][:2]
    with torch.no_grad():
        inp = megakernel_inputs(model, cfg, batch, topo)
    plan = megakernel_occupancy(inp)
    log(f"[megakernel] case300 grid: plan {plan.plan}, {plan.shared_bytes} bytes of shared memory "
        f"per grid, {plan.grids_per_sm} grids resident per SM "
        f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor), tiles in {plan.tiles}")
    check(plan.plan == 0 and plan.grids_per_sm >= 1,
          f"K4 does not keep a case300 grid resident under plan 0 ({plan})")
    for line in ptxas:
        log(f"[megakernel] ptxas: {line}")
    hmma = sass_hmma(path)
    if hmma is None:
        log("[megakernel] this toolkit has no cuobjdump: the SASS is not inspected")
    else:
        log(f"[megakernel] SASS of {os.path.basename(path)}: HMMA instructions per kernel {hmma}")
        check(hmma_of(hmma, False) > 0 and hmma_of(hmma, True) > 0,
              "K4's SASS has no HMMA instruction: its products are not on the tensor cores")

    reset_counts()
    with NoPlainTwins(kern), torch.no_grad():
        out = megakernel_forward_batch(model, cfg, batch, topo)
        torch.cuda.synchronize()
    got = counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 1}
    log(f"[megakernel] b{S_SERVE} launches {got} (expected {want})")
    check(got == want, f"K4 launches {got} != {want}")
    hold_plans(inp, out, "megakernel")

    model_cpu, _ = load_pretrained(CASE, device="cpu")
    with torch.no_grad():
        ref = megakernel_forward_plain(model_cpu, cfg, batch, topo)
        f32 = gns_forward_batch(model, cfg, batch, topo=topo, dense=batch.is_dense())
    for key, atol, p999 in K4_CARD_VS_CPU:
        a, b = getattr(out, key).cpu().numpy(), getattr(ref, key).numpy()
        errs["K4"] = max(errs["K4"], float(np.abs(a.astype(np.float64) - b).max()))
        worst, q = agree("megakernel", "card vs plain twin on the cpu", a, b, 0.0, atol, key, p999)
        if key in bf16_readings:
            log(f"[megakernel]   {key}: K4 {worst:.3e} worst, {q:.3e} at p99.9; the eager "
                f"bfloat16 path card vs cpu {bf16_readings[key][0]:.3e} and "
                f"{bf16_readings[key][1]:.3e}")
    # sanity bound only: bf16 MLPs against the float32 forward (ROADMAP §3)
    for key, rtol, atol in (("v", 0.0, 0.15), ("theta", 0.0, 2e-2), ("last_loss", 0.1, 5e-2)):
        agree("megakernel", "vs float32 forward", getattr(out, key).cpu().numpy(),
              getattr(f32, key).cpu().numpy(), rtol, atol, key)
    return got["K4"]


def time_k3(m, feats, line_mask, idx, heads, quick: bool = False) -> dict:
    """K3 at these inputs: CUDA-event and device time per launch, its bound
    (bytes at 3.35 TB/s or float32 FMAs at 67 TFLOP/s) and its plain twin
    on the card; `quick`, fewer repeats (a width of CPU_SUBSET)."""
    from gns_torch.ops import fused

    weights = fused._weights(heads)
    s, n, latent = m.shape
    e, hidden = idx.edges, weights[0].shape[0]
    macs = s * e * 3 * (hidden * (latent + 5) + hidden * hidden + latent * hidden)
    nbytes = 4 * (m.numel() + feats.numel() + line_mask.numel() + sum(w.numel() for w in weights)
                  + idx.ids.numel() + idx.order.numel() + idx.indptr.numel() + 3 * s * n * latent)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / FP32_FLOPS
    reps = (10, 3, 5) if quick else (50, 20, 20)
    with torch.no_grad():
        ms = cuda_ms(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01),
                     reps=reps[0], warmup=2 if quick else 5)
        plain = cuda_ms(lambda: fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads),
                        reps=reps[1], warmup=1 if quick else 5)
        dev, acts = device_us(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01),
                              reps=reps[2], pattern="fused_edge_kernel", per_call=1)
    out = dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
               device_ms=dev / 1e3)
    log(f"[timing] K3 fused edge stage case300 S={s} L={latent} H={hidden} float32: "
        f"{ms * 1e3:.2f} us (CUDA events), {dev:.2f} us device (profiler, the kernel alone, "
        f"x{acts:g} per call), bound {out['bound_ms'] * 1e3:.2f} us by "
        f"{out['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s = {t_bytes * 1e6:.2f} us; "
        f"{2 * macs / 1e9:.3f} GFLOP at 67 TFLOP/s float32 = {t_ops * 1e6:.2f} us), "
        f"plain twin on the card {plain * 1e3:.2f} us")
    return out


def time_k4(model, cfg, inp, quick: bool = False) -> dict:
    """K4 on these inputs: CUDA-event and device time per launch, its bound
    (the model's own heads' MACs on the bf16 tensor cores, or bytes) and its
    plain twin on the card; `quick`, fewer repeats (a width of
    CPU_SUBSET)."""
    from gns_torch.models.gns import _block, head_dims
    from gns_torch.ops.megakernel import megakernel_cuda, megakernel_plain

    reps = (5, 2, 3) if quick else (20, 5, 10)
    with torch.no_grad():
        ms = cuda_ms(lambda: megakernel_cuda(inp), reps=reps[0], warmup=1 if quick else 3)
        plain = cuda_ms(lambda: megakernel_plain(inp), reps=reps[1], warmup=1 if quick else 2)
        dev, acts = device_us(lambda: megakernel_cuda(inp), reps=reps[2], pattern="megakernel",
                              per_call=1)
    s, n = inp.bus_mask.shape
    e, k = inp.line_mask.shape[1], len(inp.steps)
    # MACs per grid and step of the model's own heads (phi per edge, L per
    # bus), not of the fused layout's block-diagonal zeros: 1650 per edge
    # and 1840 per bus at L=20, H=10
    macs = {"edge": 0, "bus": 0}
    for head, _, _ in head_dims(cfg):
        block = _block(getattr(model, head)[0])
        macs["edge" if head.startswith("phi") else "bus"] += sum(
            block[w].numel() for w in ("w1", "w2", "w4"))
    flops = 2 * s * k * (e * macs["edge"] + n * macs["bus"])
    # what K4's tiles multiply, padding included (not the bound): per 16-row
    # phi tile 3 NH KP + 3 NH KH + 3 NL KH mma of 16 x 8 x 16 (27 at L=20),
    # per work item's 16-bus L tile 3 NH KL + 3 NH KH + (2 + NL) KH (29)
    from gns_torch.ops.megakernel import tile_dims

    latent = cfg.latent_dim
    d = tile_dims(latent, cfg.hidden_dim)
    per_phi = 3 * d.nh * d.kp + 3 * d.nh * d.kh + 3 * d.nl * d.kh
    per_l = 3 * d.nh * d.kl + 3 * d.nh * d.kh + (2 + d.nl) * d.kh
    items = inp.items.cpu().numpy()
    phi_tiles = int(sum(-(-int(r1 - r0) // 16) for r0, r1 in items[:, 2:]))
    tile_flops = 2 * s * k * 16 * 8 * 16 * (per_phi * phi_tiles + per_l * len(items))
    ints = [inp.src.ids, inp.dst.ids, inp.srcq, inp.dstq, inp.dst.order, inp.dst.indptr,
            inp.src.indptr, inp.gen.order, inp.gen.indptr, inp.dst_pos, inp.src_pos, inp.gen_pos,
            inp.items, inp.row_bus]
    nbytes = sum(t.numel() * t.element_size() for t in (
        inp.buses, inp.lines, inp.gens, inp.bus_mask, inp.line_mask, inp.gen_mask,
        inp.wpack, inp.bpack, inp.discounts, *ints)) + 4 * (4 * s * n + 2 * s)
    t_bytes, t_tc, t_f32 = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS, flops / FP32_FLOPS
    out = dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_tc) * 1e3,
               bound_by="bytes" if t_bytes >= t_tc else "operations", library_ms=None,
               device_ms=dev / 1e3)
    log(f"[timing] K4 megakernel case300 b{s} K={k} L={latent} H={cfg.hidden_dim}: {ms:.3f} ms "
        f"per forward (CUDA events) = {s / ms * 1e3:.1f} grids/s, {dev / 1e3:.3f} ms device "
        f"(profiler, x{acts:g} per call); bound {out['bound_ms'] * 1e3:.2f} us by "
        f"{out['bound_by']}: {macs['edge']} MACs per edge and {macs['bus']} per bus "
        f"per step, {flops / 1e9:.2f} GFLOP of bf16-operand products at "
        f"989 TFLOP/s (tensor cores) = {t_tc * 1e6:.2f} us, {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{t_bytes * 1e6:.2f} us; on the float32 CUDA cores (67 TFLOP/s) the same products "
        f"take {t_f32 * 1e6:.2f} us; K4's tiles, padding included ({phi_tiles} phi tiles of 16 "
        f"rows, {len(items)} L tiles per grid and step), multiply {tile_flops / 1e9:.2f} GFLOP, "
        f"{tile_flops / BF16_TC_FLOPS * 1e6:.2f} us at 989 TFLOP/s; plain twin on the card "
        f"{plain:.3f} ms")
    return out


def phase_megakernel_deep(kern, cases, deep, deep_cfg, errs):
    """K4 at (L, H) = (40, 10): 300-deep (K=8) on the 1024 case300
    requests: one K4 launch and no K1/K2, against its plain twin on the CPU
    (K4_DEEP_CARD_VS_CPU) and against the float32 forward on the card (a
    sanity bound, DEEP_VS_F32); shared bytes per grid and grids per SM."""
    from gns_torch.models.gns import gns_forward_batch
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.ops.megakernel import (megakernel_forward_batch, megakernel_forward_plain,
                                          megakernel_inputs, megakernel_occupancy)
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    batch = batch_from_cases(cases)
    topo = extract_shared_topology(batch)
    plan = megakernel_occupancy(megakernel_inputs(deep, deep_cfg, batch, topo))
    log(f"[megakernel] 300-deep (K=8, L=40, H=10) case300 grid: plan {plan.plan}, "
        f"{plan.shared_bytes} bytes of shared memory per grid, {plan.grids_per_sm} grids resident "
        f"per SM")
    check(plan.plan == 0 and plan.grids_per_sm >= 1,
          f"K4 does not keep a case300 grid resident under plan 0 at L=40 ({plan})")
    reset_counts()
    with NoPlainTwins(kern), torch.no_grad():
        out = megakernel_forward_batch(deep, deep_cfg, batch, topo)
        torch.cuda.synchronize()
    got = counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 1}
    log(f"[megakernel] 300-deep b{S_SERVE} launches {got} (expected {want})")
    check(got == want, f"K4 L=40 launches {got} != {want}")
    deep_cpu, _ = load_pretrained("300-deep", device="cpu")
    with torch.no_grad():
        ref = megakernel_forward_plain(deep_cpu, deep_cfg, batch, topo)
        f32 = gns_forward_batch(deep, deep_cfg, batch, topo=topo, dense=batch.is_dense())
    for key, atol, p999 in K4_DEEP_CARD_VS_CPU:
        a, b = getattr(out, key).cpu().numpy(), getattr(ref, key).numpy()
        errs["K4"] = max(errs["K4"], float(np.abs(a.astype(np.float64) - b).max()))
        agree("megakernel", "300-deep card vs plain twin on the cpu", a, b, 0.0, atol, key, p999)
    for key, rtol, atol in DEEP_VS_F32:
        agree("megakernel", "300-deep vs float32 forward", getattr(out, key).cpu().numpy(),
              getattr(f32, key).cpu().numpy(), rtol, atol, key)


def ptxas_default(entries, second: bool = False):
    """(registers, spill store bytes, spill load bytes) of one kernel
    instance of a library, whose template's last argument is false
    (mangled Lb0E): K3's without the clocks, K4's plan 0; with `second`,
    the one where it is true (Lb1E): K3's clocks instance, K4's wide
    plans. None where the library has no such instance (K4 builds plan 0
    only for H <= 32)."""
    found = [e for e in entries if ("Lb1E" in e[0]) == second]
    check(len(found) <= 1, f"ptxas reported {len(found)} such kernel instances: {entries}")
    return found[0][1:] if found else None


def hold_plans(inp, out, tag: str) -> list:
    """K4 under every plan other than the library's choice that holds this
    batch's grid, each bit-equal to `out` (megakernel_forward_batch's
    GNSOutput under the library's plan): the plans do the same operations
    in the same order, only from other memories. Returns the plans held;
    these launches compare, they are not the main path's."""
    from gns_torch.ops import megakernel as mk

    chosen = mk.megakernel_occupancy(inp).plan
    want = (out.v, out.theta, out.delta_p, out.delta_q,
            torch.stack([out.total_loss, out.last_loss], dim=-1))
    held = []
    for plan in (0, 1, 2, 3):
        if plan == chosen or mk.megakernel_occupancy(inp, plan).plan != plan:
            continue
        with torch.no_grad():
            got = mk.megakernel_cuda(inp, plan=plan)
            torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"[{tag}] K4 under plan {plan} against plan {chosen}: "
            f"{'bit-equal' if same else 'DIFFERENT'}")
        check(same, f"K4's plan {plan} differs from plan {chosen} ({tag})")
        held.append(plan)
    return held


def phase_widths(kern, cases, built, card, widths) -> dict:
    """Phase 7b: K3 and K4 at each of `widths`, weights from
    GNS(cfg, seed=0) (random, the same on the card and the CPU), K=4,
    multiple phi, reference parity. K3 through hold_k3 (case300 dst
    index, S=1024: forward and backward, the hub index), its design and
    shared bytes equal to segment_kernels' mirror; K4 through
    megakernel_forward_batch on the 1024 serving requests: one K4 launch
    and no K1 / K2, against its plain twin on the CPU (K4_CARD_VS_CPU, or
    the width's K4_WIDTH_CARD_VS_CPU beside the eager bfloat16 path's
    card-vs-CPU reading on the same weights, which justifies it), the
    library's plan for a case300 grid (bytes per block, blocks per grid,
    workspace bytes, where the tiles sit, grids per SM) the first of its
    plans that holds the grid, every other plan that holds the grid
    bit-equal to it (hold_plans; past (128, 128) on 64 case14 grids too,
    where the pass instance has more plans), HMMA in the plan's SASS.
    At a width of CPU_SUBSET the CPU holds take its first requests and
    samples (the card runs all 1024). Then each timed against its bound and plain twin (time_k3,
    time_k4; fewer repeats at a CPU_SUBSET width), beside its build
    seconds, ptxas registers and spills and blocks per SM. Last, K3 and K4
    at LIMIT_WIDTHS (width_limit). Returns {(kernel, width): readings}."""
    from gns_torch.models.gns import GNS, gns_forward_batch
    from gns_torch.ops import fused
    from gns_torch.ops import megakernel as mk
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    batch = batch_from_cases(cases)
    topo = extract_shared_topology(batch)
    # 64 case14 grids: past (128, 128) K4's pass instance holds them under
    # plans its case300 grid does not fit (plan 1 at (129, 8))
    small = batch_from_cases(list(generate_cases(14, 63, seed=0)))
    small_topo = extract_shared_topology(small)
    subsets = {}
    for count in set(CPU_SUBSET.values()):
        sub = batch_from_cases(cases[:count])
        sub_topo = extract_shared_topology(sub)
        check(sub.buses.shape[1:] == batch.buses.shape[1:] and sub_topo is not None,
              f"the first {count} requests do not share the batch's shapes and topology")
        subsets[count] = (sub, sub_topo)
    n, e, g = batch.buses.shape[1], batch.lines.shape[1], batch.generators.shape[1]
    out = {}
    for width in widths:
        latent, hidden = width
        tag = f"widths L{latent} H{hidden}"
        samples = CPU_SUBSET.get(width, S_SERVE)
        quick = samples < S_SERVE
        log(f"[{tag}] (card: {card})")
        cfg = GNSConfig(K=4, latent_dim=latent, hidden_dim=hidden, multiple_phi=True,
                        reference_parity=True)
        model = GNS(cfg, seed=0, device="cuda")

        errs = {"K3": 0.0}
        t0 = time.perf_counter()
        launches = hold_k3(kern, model, errs, tag, samples=samples)
        log(f"[{tag}] K3 held in {time.perf_counter() - t0:.1f} s")
        occ = fused.fused_edge_occupancy(latent, hidden)
        _, _, seconds, entries = built[("fused_edge", width)]
        regs, stores, loads = ptxas_default(entries)
        asked = kern.min_blocks("fused_edge", latent, hidden)
        design, rows = kern.k3_design(latent, hidden), kern.k3_rows(latent, hidden)
        workspace = occ.workspace_bytes_per_warp * occ.warps
        log(f"[{tag}] K3: {design} design, {rows}-row tiles; built in {seconds:.2f} s; {asked} "
            f"blocks per SM asked (__launch_bounds__), {occ.blocks_per_sm} resident "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor); {regs} registers, {stores} / "
            f"{loads} bytes spill stores / loads; {occ.threads} threads and {occ.shared_bytes} bytes "
            f"of shared memory per block; workspace {occ.workspace_bytes_per_warp} bytes a warp, "
            f"{workspace} for the grid's {occ.warps} warps")
        check(occ.blocks_per_sm >= 1, f"K3 at {width} keeps no block resident")
        check(occ.shared_bytes == kern.k3_block_bytes(latent, hidden)
              and (occ.workspace_bytes_per_warp > 0) == (design == "workspace"),
              f"K3's library at {width} takes {occ.shared_bytes} shared bytes and "
              f"{occ.workspace_bytes_per_warp} workspace bytes a warp, the mirror "
              f"{kern.k3_block_bytes(latent, hidden)} ({design})")
        m, feats, line_mask, idx, heads, _ = k3_problem(model, seed=1)
        res = time_k3(m, feats, line_mask, idx, heads, quick=quick)
        res.update(launches=launches, max_abs_err=errs["K3"], build_s=seconds, registers=regs,
                   spill_bytes=stores + loads, blocks_per_sm=occ.blocks_per_sm,
                   shared_bytes=occ.shared_bytes, design=design, rows=rows,
                   workspace_bytes=workspace, cpu_samples=samples)
        out[("K3", width)] = res
        del m, feats, line_mask, idx, heads

        with torch.no_grad():
            inp = mk.megakernel_inputs(model, cfg, batch, topo)
        plan = mk.megakernel_occupancy(inp)
        # the library's plan is the first that holds the grid, within a
        # block, with a workspace exactly where the state rows leave shared
        # memory (plans 2 and 3)
        earlier = [p for p in range(max(plan.plan, 0)) if mk.megakernel_occupancy(inp, p).plan == p]
        check(plan.plan >= 0 and not earlier and plan.shared_bytes <= kern.MAX_SHARED_BYTES
              and (plan.workspace_bytes > 0) == (plan.plan >= 2),
              f"K4's library at {width} picks {plan}, though plans {earlier} hold the grid")
        path, _, seconds, entries = built[("megakernel", width)]
        regs, stores, loads = ptxas_default(entries, second=plan.plan > 0)
        log(f"[{tag}] K4: built in {seconds:.2f} s; a case300 grid under plan {plan.plan} "
            f"(the first that holds it): {plan.shared_bytes} bytes of shared memory a block, "
            f"{plan.blocks_per_grid} block a grid, tiles in {plan.tiles}, {plan.workspace_bytes} "
            f"workspace bytes a grid, {plan.grids_per_sm} grids resident per SM, "
            f"{kern.min_blocks('megakernel', latent, hidden) if plan.plan == 0 else 1} asked; "
            f"{regs} registers, {stores} / {loads} bytes spill stores / loads; "
            f"{mk.tile_dims(latent, hidden).tiles[-1] * 256} bytes of tiles a step")
        check(plan.plan >= 0 and plan.grids_per_sm >= 1,
              f"K4 at {width} cannot keep a case300 grid resident ({plan})")
        hmma = sass_hmma(path)
        if hmma is None:
            log(f"[{tag}] this toolkit has no cuobjdump: the SASS is not inspected")
        else:
            n_hmma = hmma_of(hmma, plan.plan > 0)
            log(f"[{tag}] SASS of {os.path.basename(path)}: {n_hmma} HMMA instructions in "
                f"plan {plan.plan}'s kernel ({hmma})")
            check(n_hmma > 0, f"K4's SASS at {width} has no HMMA instruction")
        reset_counts()
        with NoPlainTwins(kern), torch.no_grad():
            got = mk.megakernel_forward_batch(model, cfg, batch, topo)
            torch.cuda.synchronize()
        c = counts()
        want = {"K1": 0, "K2": 0, "K3": 0, "K4": 1}
        log(f"[{tag}] K4 b{S_SERVE} launches {c} (expected {want})")
        check(c == want, f"K4 launches at {width} {c} != {want}")
        held = hold_plans(inp, got, tag)
        if max(width) > 128:
            with torch.no_grad():
                small_inp = mk.megakernel_inputs(model, cfg, small, small_topo)
                small_out = mk.megakernel_forward_batch(model, cfg, small, small_topo)
            log(f"[{tag}] K4 on 64 case14 grids: plan {mk.megakernel_occupancy(small_inp).plan}")
            held_small = hold_plans(small_inp, small_out, f"{tag} case14")
            log(f"[{tag}] case14: plans {held_small} bit-equal to the library's")
            del small_inp, small_out
        model_cpu = GNS(cfg, seed=0, device="cpu")
        cpu_batch, cpu_topo = subsets[samples] if quick else (batch, topo)
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = mk.megakernel_forward_plain(model_cpu, cfg, cpu_batch, cpu_topo)
        log(f"[{tag}] K4's plain twin on the CPU, the first {samples} of {S_SERVE} requests "
            f"({time.perf_counter() - t0:.1f} s): total_loss {float(ref.total_loss.min()):.4g} to "
            f"{float(ref.total_loss.max()):.4g}, last_loss {float(ref.last_loss.min()):.4g} to "
            f"{float(ref.last_loss.max()):.4g}, |delta_p| up to {float(ref.delta_p.abs().max()):.4g}, "
            f"|v| up to {float(ref.v.abs().max()):.4g}; the card's outputs "
            f"{'finite' if all(bool(torch.isfinite(t).all()) for t in got) else 'NOT FINITE'}")
        eager = None
        if width in K4_WIDTH_CARD_VS_CPU:
            # what justifies the width's own bounds: the port's eager
            # bfloat16 forward (fold on), card against CPU, on the same
            # weights, deviates as much (BF16_CARD_VS_CPU's reading)
            bf16 = cfg.replace(compute_dtype="bfloat16")
            with torch.no_grad():
                eager = (gns_forward_batch(model, bf16, batch, topo=topo, dense=batch.is_dense()),
                         gns_forward_batch(model_cpu, bf16, cpu_batch, topo=cpu_topo,
                                           dense=cpu_batch.is_dense()))
        err = 0.0
        for key, atol, p999 in K4_WIDTH_CARD_VS_CPU.get(width, K4_CARD_VS_CPU):
            a, b = getattr(got, key)[:samples].cpu().numpy(), getattr(ref, key).numpy()
            err = max(err, float(np.abs(a.astype(np.float64) - b).max()))
            if eager is not None:
                e_err = np.abs(getattr(eager[0], key)[:samples].cpu().numpy().astype(np.float64)
                               - getattr(eager[1], key).numpy())
                log(f"[{tag}] eager bfloat16 forward card vs cpu {key}: {float(e_err.max()):.3e} "
                    f"worst, {float(np.quantile(e_err, 0.999)):.3e} at p99.9")
            agree(tag, "K4 card vs plain twin on the cpu", a, b, 0.0, atol, key, p999)
        res = time_k4(model, cfg, inp, quick=quick)
        res.update(launches=c["K4"], max_abs_err=err, build_s=seconds, registers=regs,
                   spill_bytes=stores + loads, grids_per_sm=plan.grids_per_sm,
                   shared_bytes=plan.shared_bytes, plan=plan.plan,
                   blocks_per_grid=plan.blocks_per_grid, tiles=plan.tiles,
                   workspace_bytes=plan.workspace_bytes, plans_bit_equal=held,
                   cpu_samples=samples)
        out[("K4", width)] = res
        del inp, got, ref, model, eager
    width_limit(kern, batch, topo, card)
    return out


def width_limit(kern, batch, topo, card) -> None:
    """K3 and K4 at LIMIT_WIDTHS, below the widths their CUDA paths take:
    each wrapper (fused_edge_cuda on tensors of that width, megakernel_cuda
    on the serving batch's inputs at that width, each occupancy query, and
    megakernel_forward_batch where a model of that width can be made)
    raises a ValueError that names the rule ("of at least 1") before any
    library is built or loaded, and nothing is launched, neither a kernel
    nor a plain twin (there is no fallback)."""
    from gns_torch.models.gns import GNS
    from gns_torch.ops import fused
    from gns_torch.ops import megakernel as mk
    from gns_torch.ops.segment import SegmentIndex
    from gns_torch.utils.config import GNSConfig

    def cfg_of(latent, hidden):
        return GNSConfig(K=4, latent_dim=latent, hidden_dim=hidden, multiple_phi=True,
                         reference_parity=True)

    with torch.no_grad():
        inp = mk.megakernel_inputs(GNS(cfg_of(8, 8), seed=0, device="cuda"), cfg_of(8, 8), batch,
                                   topo)
    idx = SegmentIndex(topo.dst, batch.buses.shape[1], "cuda")
    s, n, e = 4, idx.n, idx.edges
    libs, files = dict(kern._libs), set(os.listdir(kern.BUILD_DIR))
    for latent, hidden in LIMIT_WIDTHS:
        tag = f"widths L{latent} H{hidden}"
        calls = {
            "fused_edge_cuda": lambda: fused.fused_edge_cuda(
                torch.zeros((s, n, latent), device="cuda"), torch.zeros((s, e, 5), device="cuda"),
                torch.ones((s, e), device="cuda"), idx,
                [torch.zeros(shape, device="cuda") for shape in fused._weight_shapes(latent, hidden)],
                0.01),
            "fused_edge_occupancy": lambda: fused.fused_edge_occupancy(latent, hidden),
            "megakernel_cuda": lambda: mk.megakernel_cuda(inp._replace(latent=latent, hidden=hidden)),
            "megakernel_occupancy": lambda: mk.megakernel_occupancy(
                inp._replace(latent=latent, hidden=hidden)),
        }
        if hidden > 0:  # a GNS of hidden width 0 cannot be made
            model = GNS(cfg_of(latent, hidden), seed=0, device="cuda")
            calls["megakernel_forward_batch"] = lambda: mk.megakernel_forward_batch(
                model, cfg_of(latent, hidden), batch, topo)
        reset_counts()
        for name, call in calls.items():
            with NoPlainTwins(kern), torch.no_grad():
                try:
                    call()
                except ValueError as exc:
                    msg = str(exc)
                else:
                    fail(f"{name} ran at {(latent, hidden)}, below the widths K3 and K4 take")
            torch.cuda.synchronize()
            log(f"[{tag}] {name} raised: {msg}")
            check("of at least 1" in msg, f"{name}'s error at {(latent, hidden)} does not name "
                                          f"the rule")
        c = counts()
        log(f"[{tag}] launches {c} (card: {card})")
        check(not any(c.values()), f"K3 / K4 at {(latent, hidden)} launched {c}")
    check(kern._libs == libs and set(os.listdir(kern.BUILD_DIR)) == files,
          f"K3 / K4 at {LIMIT_WIDTHS} built or loaded a library")


def phase_timing_k34(model, cfg, deep, deep_cfg, cases, forward_ms, card, built):
    """K3 and K4 at the main path's shapes, each against its bound and its
    plain twin on the card, and K4 beside the eager forwards; then both at
    (L, H) = (40, 10) with `300-deep` (deep, deep_cfg)."""
    from gns_torch.ops import fused
    from gns_torch.ops.megakernel import STAGES, megakernel_cuda, megakernel_inputs
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    results = {}
    no_library = ("no single PyTorch call computes {}: it chains gathers, three MLPs "
                  "and segment-sums{}, so library_ms is null")
    m, feats, line_mask, idx, heads, _ = k3_problem(model, seed=1)
    weights = fused._weights(heads)
    s, n, latent = m.shape
    hidden = weights[0].shape[0]
    results["K3"] = time_k3(m, feats, line_mask, idx, heads)
    with torch.no_grad():
        wc = warm_and_cold(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01),
                           "fused_edge_kernel")
    results["K3"].update(cold_ms=wc["cold"] / 1e3, cold_device_ms=wc["cold_device"] / 1e3)
    log(f"[timing] K3 one launch alone (CUDA events): warm L2 {wc['warm']:.2f} us, cold L2 "
        f"{wc['cold']:.2f} us (after a 128 MB write), cold device {wc['cold_device']:.2f} us "
        f"(profiler); bound {results['K3']['bound_ms'] * 1e3:.2f} us")
    shared, per_sm, threads, sms, _ = fused.fused_edge_occupancy(latent, hidden)
    log(f"[timing] K3 occupancy: {threads} threads and {shared} bytes of shared memory per block, "
        f"{per_sm} blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
        f"{sms} SMs; ptxas: " + " | ".join(built[("fused_edge", (20, 10))][1]))
    with torch.no_grad():
        clocks = torch.zeros((per_sm * sms * threads // 32, len(fused.CLOCK_PHASES)),
                             dtype=torch.int64, device="cuda")
        fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01, clocks)
        torch.cuda.synchronize()
    c = clocks[clocks[:, 3] > 0].double()
    per_unit = (c[:, :3].sum(0) / c[:, 3].sum()).tolist()
    total = c[:, :3].sum(1)
    log(f"[timing] K3 phase clocks (SM cycles per warp, the kernel's own `clocks`, {c.shape[0]} warps, "
        f"{int(c[:, 3].min())} to {int(c[:, 3].max())} units of up to {fused.ROWS} CSR rows each): per "
        f"unit " + "; ".join(f"{name} {v:.0f} ({100 * v / sum(per_unit):.1f}%)"
                             for name, v in zip(fused.CLOCK_PHASES, per_unit))
        + f"; per warp {total.mean():.0f} mean, {total.min():.0f} min, {total.max():.0f} max")
    log(f"[timing] K3 library_ms: " + no_library.format("the fused edge stage", ""))

    batch = batch_from_cases(cases)
    topo = extract_shared_topology(batch)
    with torch.no_grad():
        inp = megakernel_inputs(model, cfg, batch, topo)
    s, k = inp.bus_mask.shape[0], len(inp.steps)
    results["K4"] = time_k4(model, cfg, inp)
    ms = results["K4"]["ms"]
    with torch.no_grad():
        one = inp._replace(wpack=inp.wpack[:1], bpack=inp.bpack[:1], discounts=inp.discounts[:1],
                           steps=inp.steps[:1])
        ms1 = cuda_ms(lambda: megakernel_cuda(one), reps=20, warmup=3)
        wc = warm_and_cold(lambda: megakernel_cuda(inp), "megakernel", reps=5)
    results["K4"].update(cold_ms=wc["cold"] / 1e3, cold_device_ms=wc["cold_device"] / 1e3)
    log(f"[timing] K4 one launch alone (CUDA events): warm L2 {wc['warm']:.2f} us, cold L2 "
        f"{wc['cold']:.2f} us (after a 128 MB write), cold device {wc['cold_device']:.2f} us "
        f"(profiler)")
    with torch.no_grad():
        clocks = torch.zeros((s, len(STAGES)), dtype=torch.int64, device="cuda")
        megakernel_cuda(inp, clocks)
        torch.cuda.synchronize()
    per_grid = clocks.double().mean(0).tolist()
    log(f"[timing] K4 stage clocks (SM cycles per grid, mean of {s} grids, K={k}; a grid shares "
        f"its SM with the other resident grid): " + "; ".join(
            f"{name} {c:.0f} ({100 * c / sum(per_grid):.1f}%)" for name, c in zip(STAGES, per_grid)))
    log(f"[timing] K4 at K=1: {ms1:.3f} ms, at K={k}: {ms:.3f} ms (CUDA events): "
        f"{(ms - ms1) / max(k - 1, 1):.3f} ms per further step, {ms1 - (ms - ms1) / max(k - 1, 1):.3f} "
        f"ms fixed (inputs in, state init, outputs out)")
    log(f"[timing] K4 beside the eager forward of the same run: float32 "
        f"{forward_ms['float32']:.3f} ms, bfloat16 {forward_ms['bfloat16']:.3f} ms, K4 {ms:.3f} ms "
        f"(card: {card})")
    log(f"[timing] K4 library_ms: " + no_library.format(
        "the whole forward", ", physics and reductions over K steps"))

    # the deep checkpoints' width: 300-deep's step-0 heads for K3, the whole
    # K=8 forward for K4, on the same grids
    log(f"[timing] (L, H) = (40, 10), 300-deep (card: {card}):")
    m, feats, line_mask, idx, heads, _ = k3_problem(deep, seed=1)
    results["K3"]["at_L40_H10"] = time_k3(m, feats, line_mask, idx, heads)
    with torch.no_grad():
        inp = megakernel_inputs(deep, deep_cfg, batch, topo)
    results["K4"]["at_L40_H10"] = time_k4(deep, deep_cfg, inp)
    return results


def trace_busy(run, reps: int = 3, what: str = "forward", expect=None):
    """Device windows and busy time of `run`, from one trace.

    Each of `reps` runs goes alone on an idle stream, between two CUDA
    events; the events' span is that run's window on the device, launch
    gaps included. The kernels the profiler saw in the same trace give the
    busy time (the union of their intervals). Only device activity is
    traced; the same runs untraced, just before, show what the tracing
    costs the host's launch pace. A trace counts when every run left the
    same number of device activities, or, with `expect` ({name pattern:
    activities per run}), when the activities of each pattern number
    `reps` times that (a training step's other activities, copies and
    fills, need not repeat exactly). Returns (untraced windows, traced
    windows in ms, busy ms over all runs, the sorted device spans, the
    profile)."""

    def complete(spans):
        if expect is None:
            return bool(spans) and len(spans) % reps == 0
        return all(sum(1 for *_, name in spans if pat in name) == reps * n
                   for pat, n in expect.items())
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def windows():
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        for start, end in marks:
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in marks]

    untraced = windows()
    # as device_us: a spin kernel, not counted, opens and closes each trace,
    # and a trace that missed activity is traced again
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            traced = windows()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        spans = sorted(
            (ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
            and "spin_kernel" not in ev.name
        )
        if complete(spans):
            break
        log(f"[profile] trace {attempt + 1} of 6 recorded {len(spans)} device activities over "
            f"{reps} runs of the {what}: not the same number per run")
    else:
        fail(f"the profiler did not record every run's device activity of the {what} "
             f"in six traces")
    busy_us, reach = 0.0, float("-inf")
    for lo, hi, _ in spans:  # union of the intervals
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    busy_ms = busy_us / 1e3
    check(0 < busy_ms <= sum(traced) * 1.05,
          f"busy {busy_ms:.3f} ms outside windows {sum(traced):.3f} ms")
    return untraced, traced, busy_ms, spans, prof


def phase_profile(model, cfg, bt, graph, reps: int = 3):
    """Device busy and idle share of the float32 forward, from one trace
    (trace_busy)."""
    from torch.autograd import DeviceType

    from gns_torch.models.gns import gns_forward, step_params

    with torch.no_grad():
        steps = step_params(model, cfg)
        gns_forward(steps, cfg, bt, graph, dense=True)
    torch.cuda.synchronize()

    def forward():
        with torch.no_grad():
            gns_forward(steps, cfg, bt, graph, dense=True)

    untraced, traced, busy_ms, spans, prof = trace_busy(forward, reps)
    window_ms = sum(traced)
    log(f"[profile] float32 forward x{reps} (one trace): device windows "
        f"{', '.join(f'{w:.3f}' for w in traced)} ms (CUDA events), "
        f"busy {busy_ms / reps:.3f} ms per forward in {len(spans) // reps} device activities, "
        f"idle {100 * (1 - busy_ms / window_ms):.1f}%")
    log(f"[profile] the same forward untraced, just before: windows "
        f"{', '.join(f'{w:.3f}' for w in untraced)} ms; the traced busy time is "
        f"{100 * busy_ms / sum(untraced):.1f}% of them")

    def dev_us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0)

    rows = sorted(
        (r for r in prof.key_averages()
         if r.device_type == DeviceType.CUDA and "spin_kernel" not in r.key),
        key=lambda r: -dev_us(r),
    )
    total = sum(dev_us(r) for r in rows)
    for label, pat in (("K1", "segment_sum_"), ("K2", "gns_gather_")):
        mine = [r for r in rows if pat in r.key]
        t = sum(dev_us(r) for r in mine)
        log(f"[profile]   {label} {pat}: {t / reps / 1e3:.3f} ms per forward, "
            f"{100 * t / total:.1f}% of device time, x{sum(r.count for r in mine) // reps}")
    for r in rows[:12]:
        t = dev_us(r)
        if t > 0:
            log(f"[profile]   {t / reps / 1e3:8.3f} ms {100 * t / total:5.1f}% "
                f"x{r.count // reps:<4d} {r.key[:90]}")


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds per call of fn (perf_counter over `reps` calls,
    after a warm-up), then a synchronize outside the window."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def phase_launch_path(kern, ix, rows: int):
    """The host side of one K2 launch at Q2 D=1 (S=1024, 411 rows), part by
    part: what the launch path before this design paid (the signature table
    built and the library looked up per call, two _check_cuda,
    torch.empty(device=), torch.cuda.current_stream) beside what it pays
    now, a whole call of the old path, then whole calls of gather_cuda and
    index_select timed interleaved (a b b a)."""
    import ctypes

    x = torch.randn((S_SERVE, rows, 1), device="cuda")
    ids, dev = ix.ids, x.get_device()
    ids_l = ids.long()
    out = x.new_empty((S_SERVE, ids.numel(), 1))
    fn = kern.function("gns_gather")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dtypes = (torch.float32, torch.bfloat16)

    def old_lookup():
        sig = {"gns_segment_sum": ([p, i, p, p, p, ll, ll, ll, ll, p], i),
               "gns_gather": ([p, p, p, ll, ll, ll, ll, p], i)}
        return kern.library("segment"), sig

    def old_checks():
        kern._check_cuda("data", x, dtypes, 3)
        kern._check_cuda("ids", ids, (torch.int32,), 1, x.device)

    def new_checks():
        return (x.is_cuda and x.dtype in dtypes and x.dim() == 3 and x.is_contiguous()
                and ids.is_cuda and ids.dtype == torch.int32 and ids.dim() == 1
                and ids.is_contiguous() and ids.get_device() == dev)

    def launch():
        return fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), S_SERVE, rows, ids.numel(), 4, 0,
                  kern._stream_of(dev))

    def old_gather():
        old_lookup()
        old_checks()
        o = torch.empty((S_SERVE, ids.numel(), 1), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), ids.data_ptr(), o.data_ptr(), S_SERVE, rows, ids.numel(), 4, 0, stream)
        check(rc == 0, f"K2 launch failed: cudaError {rc}")
        return o

    parts = [
        ("signature table + library lookup (before)", old_lookup),
        ("bound function lookup (now)", lambda: kern.function("gns_gather")),
        ("two _check_cuda (before)", old_checks),
        ("combined check (now)", new_checks),
        ("torch.empty(device=) (before)", lambda: torch.empty(
            (S_SERVE, ids.numel(), 1), dtype=x.dtype, device=x.device)),
        ("new_empty (now)", lambda: x.new_empty((S_SERVE, ids.numel(), 1))),
        ("torch.cuda.current_stream().cuda_stream (before)",
         lambda: torch.cuda.current_stream(x.device).cuda_stream),
        (f"raw current stream (now; {'torch._C._cuda_getCurrentRawStream' if kern._raw_stream else 'public API'})",
         lambda: kern._stream_of(dev)),
        ("ctypes call with nothing to launch (S=0): the FFI alone",
         lambda: fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), 0, rows, ids.numel(), 4, 0,
                    kern._stream_of(dev))),
        ("ctypes call, the launch itself", launch),
        ("whole call, the launch path before this design", old_gather),
    ]
    for label, f in parts:
        log(f"[launch path] K2 Q2 D=1: {label}: {host_us(f):.2f} us host per call")
    mine, theirs = abba(lambda: host_us(lambda: kern.gather_cuda(x, ids)),
                        lambda: host_us(lambda: x.index_select(1, ids_l)))
    log(f"[launch path] K2 Q2 D=1 whole calls, a b b a: gather_cuda now {spread(mine)} host per "
        f"call; index_select {spread(theirs)}; gather_cuda behind: {behind(mine, theirs)}")
    # the handle follows the current stream: on a side stream it is that stream's
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        check(kern._stream_of(dev) == side.cuda_stream, "the stream handle did not follow the current stream")
    check(kern._stream_of(dev) == torch.cuda.current_stream().cuda_stream, "stream handle is stale")


def phase_timing(kern, seg, cases, model, cfg, card):
    from gns_torch.eval.harness import align_slack_angle
    from gns_torch.models.gns import batch_tensors, gns_forward
    from gns_torch.physics.common import build_graph
    from gns_torch.serve import GNSPredictor
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    log(f"[timing] card: {card}")
    forward_ms = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        pred = GNSPredictor(model, c, batch_size=S_SERVE, device="cuda")
        pred.predict(cases)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(cases)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        t0 = time.perf_counter()
        batch = batch_from_cases(cases)
        topo = extract_shared_topology(batch)
        t1 = time.perf_counter()
        graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cuda")
        t2 = time.perf_counter()
        bt = batch_tensors(batch, "cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        theta = np.zeros((S_SERVE, batch.buses.shape[1]), np.float32)
        np.stack([align_slack_angle(t, case) for t, case in zip(theta, cases)])
        t4 = time.perf_counter()
        steps = pred.steps
        with torch.no_grad():
            fwd = cuda_ms(lambda: gns_forward(steps, c, bt, graph, dense=True), reps=20, warmup=3)
        forward_ms[dtype] = fwd
        log(f"[timing] predict {dtype} b{S_SERVE}: {S_SERVE / wall:.1f} grids/s "
            f"end to end (host wall {wall * 1e3:.2f} ms, median of 3, host packing included); "
            f"forward alone {fwd:.3f} ms = {S_SERVE / fwd * 1e3:.1f} grids/s (CUDA events)")
        log(f"[timing] host stages of one predict ({dtype}): pack {(t1 - t0) * 1e3:.2f} ms, "
            f"index sets {(t2 - t1) * 1e3:.2f} ms (cached after the first batch), "
            f"copy to card {(t3 - t2) * 1e3:.2f} ms, slack decode {(t4 - t3) * 1e3:.2f} ms")

    phase_profile(model, cfg, bt, graph)

    # kernels at the path's shapes
    batch0, topo = case300_indices()
    n, e = batch0.buses.shape[1], batch0.lines.shape[1]
    g_cnt = len(topo.gen_idx)
    dst = seg.SegmentIndex(topo.dst, n, "cuda")
    gidx = seg.SegmentIndex(topo.gen_idx, n, "cuda")
    rows_idx = seg.SegmentIndex(topo.src, e, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}

    def k1_case(ix, rows_in, d, dtype, label):
        x = torch.randn((S_SERVE, rows_in, d), generator=gen, device="cuda").to(dtype)
        kept = ix.order.numel()
        esz = x.element_size()
        nbytes = S_SERVE * kept * d * esz + S_SERVE * ix.n * d * 4 + (kept + ix.n + 1) * 4
        ops = S_SERVE * kept * d
        def kernel():
            return kern.segment_sum_cuda(x, ix.order, ix.indptr, ix.n)

        ms = cuda_ms(kernel)
        plain = cuda_ms(lambda: kern.segment_sum_plain(x, ix.order, ix.indptr, ix.n))
        ids_l = ix.ids.long()
        xf = x.float()

        def library():
            return torch.zeros((S_SERVE, ix.n, d), device="cuda").index_add_(1, ids_l, xf)

        lib = cuda_ms(library)
        dev, acts = device_us(kernel, pattern="segment_sum_")
        lib_dev, lib_acts = device_us(library)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
        log(f"[timing] K1 {label} D={d} {str(dtype)[6:]}: {ms * 1e3:.2f} us (CUDA events), "
            f"{dev:.2f} us device (profiler, x{acts:g} per call), bound "
            f"{bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB), plain {plain * 1e3:.2f} us, "
            f"index_add_ {lib * 1e3:.2f} us (CUDA events), {lib_dev:.2f} us device "
            f"(x{lib_acts:g}: zeros + index_add_)")
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib, device_ms=dev / 1e3,
                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations")

    def k2_case(ix, rows_in, d, dtype, label):
        """K2 beside index_select, the two timed interleaved (a b b a), in
        CUDA-event time (3 rounds) and in kernel-only device time (1)."""
        x = torch.randn((S_SERVE, rows_in, d), generator=gen, device="cuda").to(dtype)
        esz = x.element_size()
        uniq = int(np.unique(ix.ids.cpu().numpy()).size)
        nbytes = S_SERVE * uniq * d * esz + S_SERVE * ix.edges * d * esz + ix.edges * 4
        def kernel():
            return kern.gather_cuda(x, ix.ids)

        plain = cuda_ms(lambda: kern.gather_plain(x, ix.ids))
        ids_l = ix.ids.long()

        def library():
            return x.index_select(1, ids_l)

        ms, lib = abba(lambda: 1e3 * cuda_ms(kernel), lambda: 1e3 * cuda_ms(library))
        dev, lib_dev = abba(lambda: device_us(kernel, pattern="gns_gather_")[0],
                            lambda: device_us(library)[0], rounds=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        what = f"K2 {label} D={d} {str(dtype)[6:]}"
        log(f"[timing] {what}: bound {bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB), plain "
            f"{plain * 1e3:.2f} us (CUDA events)")
        log(f"[timing] {what} CUDA events, K2 then index_select, a b b a: K2 {spread(ms)}; "
            f"index_select {spread(lib)}")
        log(f"[timing] {what} device (profiler, the kernel alone), a b b a: K2 {spread(dev)}; "
            f"index_select {spread(lib_dev)}")
        log(f"[timing] {what}: behind index_select in device time: {behind(dev, lib_dev)}; "
            f"in CUDA-event time: {behind(ms, lib)}")
        med = statistics.median
        return dict(ms=med(ms) / 1e3, plain_ms=plain, bound_ms=bound, library_ms=med(lib) / 1e3,
                    device_ms=med(dev) / 1e3, bound_by="bytes")

    f32, bf16 = torch.float32, torch.bfloat16
    results["K1"] = k1_case(dst, e, 60, f32, "phi aggregate at dst")
    k1_case(dst, e, 30, bf16, "folded phi aggregate at dst")
    k1_case(dst, e, 2, f32, "physics pairs at dst")
    k1_case(gidx, g_cnt, 4, f32, "generator init at gen")
    k1_case(gidx, g_cnt, 1, f32, "pg at gen")
    k1_case(dst, e, 1, f32, "in-degree at dst")
    results["K2"] = k2_case(dst, n, 20, f32, "m[dst]")
    k2_case(dst, n, 2, f32, "(v, theta) at dst")
    k2_case(rows_idx, e, 1, f32, "Q2 delta[src]")
    k2_case(rows_idx, e, 4, f32, "Q2 geometry[src]")
    k2_case(dst, n, 20, bf16, "m[dst]")
    k2_case(dst, n, 2, bf16, "(v, theta) at dst")
    phase_launch_path(kern, rows_idx, e)
    return results, forward_ms


def train_configs() -> dict:
    """Config A: case300 K=4 latent 20 hidden 10 multiple phi (the model of
    benchmark/configs/gns-k4-l20-h10-c300.json), float32, reference parity;
    B: bench.py's default
    (bench.py:50-52, 78-82), bfloat16 MLPs and the paper physics, the fold
    on by "auto"."""
    from gns_torch.utils.config import GNSConfig

    a = GNSConfig(case_nr=CASE, K=4, latent_dim=20, hidden_dim=10, multiple_phi=True,
                  reference_parity=True, batch_size=S_TRAIN)
    b = a.replace(compute_dtype="bfloat16", reference_parity=False)
    check(b.resolved_fold_output and not a.resolved_fold_output, "config B must fold, A must not")
    return {"A": a, "B": b}


def forward_launches(cfg) -> dict:
    """K1 / K2 launches of one forward of a dense batch with a shared
    topology (train_launches' forward counts): per step m[dst] (K2), the
    phi aggregate (K1), the two paired line-flow sums and the generator sum
    (3 K1), the gathers of (v, theta) at src and dst (2 K2), in parity mode
    the Q2 gathers of delta (2 K2); once the generator init (K1), the Q2
    geometry (2 K2, parity) or, with the fold on, the in-degree (K1)."""
    k = cfg.K
    if cfg.reference_parity:
        return {"K1": 1 + 4 * k, "K2": 2 + 5 * k}
    return {"K1": 1 + int(cfg.resolved_fold_output) + 4 * k, "K2": 3 * k}


def train_launches(cfg):
    """K1 / K2 launches of one update step on a dense batch with a shared
    topology, (forward, backward), as models/gns.py and physics/fused.py
    give them. Forward, per step: m[dst] (K2), the phi aggregate (K1), the
    two paired line-flow sums and the generator sum (3 K1), the gathers of
    (v, theta) at src and dst (2 K2), and in parity mode the Q2 gathers of
    delta at src and dst (2 K2); once: the generator init (K1), the Q2
    geometry (2 K2, parity) or the in-degree (K1, fold). Backward: each
    launch whose input needs a gradient launches its adjoint once: every
    per-step launch but m[dst] at step 0 (m starts at 0); none of the once
    launches (their inputs are data)."""
    k = cfg.K
    if cfg.reference_parity:
        return forward_launches(cfg), {"K1": (k - 1) + 4 * k, "K2": 4 * k}
    return forward_launches(cfg), {"K1": (k - 1) + 2 * k, "K2": 4 * k}


def hold_recorded(kern, recorded: dict, tag: str, quiet: bool = False) -> int:
    """Every recorded K1 / K2 launch replayed on its input: bit-equal to its
    plain twin on CPU copies (the same order of adds), and K2 also to its
    twin on the card (a copy). Returns the number of launches held. quiet:
    log only a launch that is not bit-equal."""
    for key, (args, count) in recorded.items():
        name, shape, dtype = key[:3]
        what = f"S={shape[0]} rows={shape[1]} D={shape[2]} {str(dtype)[6:]} x{count}"
        if name == "K1":
            data, order, indptr, n = args
            got = kern.segment_sum_cuda(data, order, indptr, n)
            torch.cuda.synchronize()
            want = kern.segment_sum_plain(data.cpu(), order.cpu(), indptr.cpu(), n)
            same = torch.equal(got.cpu(), want)
            what = f"n={n} {what}"
        else:
            data, ids, masked = args
            got = kern.gather_cuda(data, ids, masked)
            torch.cuda.synchronize()
            want = kern.gather_plain(data.cpu(), ids.cpu(), masked)
            same = torch.equal(got.cpu(), want) and torch.equal(got, kern.gather_plain(*args))
            what = f"E={ids.numel()} {what}"
        err = (got.cpu().float() - want.float()).abs().max().item()
        if not (quiet and same):
            log(f"[train] {tag} {name} {what} max_abs_err {err:.3e} "
                f"{'bit-equal' if same else 'MISMATCH'}")
        check(same, f"{tag} {name} {what} is not bit-equal to its plain twin")
    return len(recorded)


def train_problem():
    """bench.py's batch: the 256 grids of generate_cases(300, 255, seed=0),
    one shared topology, dense; host arrays and the card's tensors."""
    from gns_torch.models.gns import batch_tensors
    from gns_torch.physics.common import build_graph
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    batch = batch_from_cases(list(generate_cases(CASE, S_TRAIN - 1, seed=0)))
    topo = extract_shared_topology(batch)
    check(topo is not None and batch.is_dense() and batch.batch_size == S_TRAIN,
          "the training batch must be 256 dense grids of one topology")
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cuda")
    return batch, topo, batch_tensors(batch, "cuda"), graph


def train_one_step(kern, seg, tag, cfg, batch, topo, bt, graph):
    """One update step's forward and backward on the card with every K1 /
    K2 launch recorded, forward and backward apart, held against the
    counts of train_launches, then its gradients against the port's CPU
    path. Returns (forward counts, backward counts, forward and backward
    recordings, the largest share of its TRAIN_GRAD bound a leaf used)."""
    from gns_torch.models.gns import batch_tensors, gns_forward, step_params
    from gns_torch.physics.common import build_graph
    from gns_torch.train.trainer import init_train_state, loss_and_grads

    state = init_train_state(0, cfg, device="cuda")
    params = list(state.model.parameters())
    rec_f, rec_b = PathRecorder(kern, seg), PathRecorder(kern, seg)
    reset_counts()
    with NoPlainTwins(kern):
        with rec_f:
            out = gns_forward(step_params(state.model, cfg), cfg, bt, graph, dense=True)
            loss = out.total_loss.mean()
            torch.cuda.synchronize()
        fwd = counts()
        with rec_b:
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    want_f, want_b = train_launches(cfg)
    want_f.update(K3=0, K4=0)
    want_b.update(K3=0, K4=0)
    log(f"[train] {tag} one step: forward launches {fwd} (expected {want_f}), backward {bwd} "
        f"(expected {want_b}); no plain twin ran on the card")
    check(fwd == want_f and bwd == want_b, f"{tag} step launches {fwd} / {bwd}")

    cpu = init_train_state(0, cfg, device="cpu")
    graph_cpu = build_graph(batch.buses, batch.lines, batch.generators, topo, "cpu")
    loss_cpu, _, want = loss_and_grads(cpu.model, cfg, batch_tensors(batch, "cpu"), graph_cpu,
                                       dense=True)
    rel, atol = TRAIN_GRAD[tag]
    names = [n for n, _ in state.model.named_parameters()]
    readings = []  # (share of the bound used, leaf, max |card - cpu|, max |cpu|)
    for name, g, w in zip(names, grads, want):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        readings.append((err / (rel * scale + atol), name, err, scale))
    readings.sort(reverse=True)
    log(f"[train] {tag} gradients, card vs the port's CPU path, {len(names)} leaves, bound {rel:g} x "
        f"max |cpu| + {atol:g} per leaf; the three leaves nearest it: " + "; ".join(
            f"{name} max_abs_err {err:.3e}, max |cpu| {scale:.3e}, {share:.3f} of the bound"
            for share, name, err, scale in readings[:3])
        + f"; loss card {float(loss.detach()):.6e} cpu {float(loss_cpu):.6e}")
    check(readings[0][0] <= 1.0, f"{tag} gradients disagree with the CPU path")
    return fwd, bwd, rec_f.inputs, rec_b.inputs, readings[0][0]


def steps_ms(run, reps: int):
    """(host wall ms, CUDA-event ms) per call of run over `reps` calls."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, start.elapsed_time(end) / reps


def host_ops(label: str, run, reps: int = 3):
    """What the host spends an eager step on: the profiler's CPU activity
    over `reps` runs, the six ops of most self time and the optimizer's
    foreach ops, per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    total = sum(r.self_cpu_time_total for r in rows) / reps / 1e3
    foreach = sum(r.self_cpu_time_total for r in rows if "_foreach" in r.key) / reps / 1e3
    log(f"[train] {label} host side of an eager step (profiler, CPU, {reps} steps): "
        f"{total:.2f} ms of ops per step; most self time: " + "; ".join(
            f"{r.key} {r.self_cpu_time_total / reps / 1e3:.2f} ms x{r.count // reps}" for r in rows[:6])
        + f"; the optimizer's foreach ops {foreach:.2f} ms (self)")


def phase_train(kern, seg, card):
    """The training path on the card (module docstring, phase 9). Returns
    {"A"/"B": {forward, backward, main-path counts}} and the backward's
    distinct launches for the timing."""
    from gns_torch.models.gns import batch_tensors
    from gns_torch.train.trainer import (CAPTURE_WARMUP, init_train_state, make_epoch_step,
                                         make_train_step)
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.prepare import GridBatch, batch_from_cases

    torch.backends.cuda.matmul.allow_tf32 = False  # "f32 means f32" (ROADMAP)
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    batch, topo, bt, graph = train_problem()
    n_edges = batch.lines.shape[1]
    results = {}
    for tag, cfg in train_configs().items():
        label = f"{tag} ({cfg.compute_dtype}, {'parity' if cfg.reference_parity else 'paper, fold'})"
        fwd, bwd, rec_f, rec_b, grad_share = train_one_step(kern, seg, tag, cfg, batch, topo, bt, graph)
        held = hold_recorded(kern, {**rec_f, **rec_b}, tag)
        log(f"[train] {tag}: all {held} distinct K1 / K2 launches of one step ({len(rec_f)} forward, "
            f"{len(rec_b)} backward) bit-equal to their plain twins")
        del rec_f, rec_b

        # the main path: 20 eager update steps through make_train_step
        state = init_train_state(0, cfg, device="cuda")
        step = make_train_step(cfg, topo=topo, dense=True)
        losses = []
        reset_counts()
        with NoPlainTwins(kern):
            for _ in range(TRAIN_STEPS):
                losses.append(step(state, bt)[1]["loss"])
            torch.cuda.synchronize()
        main = counts()
        want = {"K1": TRAIN_STEPS * (fwd["K1"] + bwd["K1"]), "K2": TRAIN_STEPS * (fwd["K2"] + bwd["K2"]),
                "K3": 0, "K4": 0}
        losses = torch.stack(losses).cpu()
        log(f"[train] {label} {TRAIN_STEPS} eager Adam steps (make_train_step): launches {main} "
            f"(expected {want}); loss {float(losses[0]):.6e} -> {float(losses[-1]):.6e}")
        check(main == want, f"{tag} eager steps' launches {main} != {want}")
        check(bool(torch.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{tag} losses not finite or not falling: {losses.tolist()}")

        # the same steps through the CUDA graph of make_epoch_step
        graph_state = init_train_state(0, cfg, device="cuda")
        epoch = make_epoch_step(cfg, topo=topo, dense=True)
        xs = GridBatch(*(a.unsqueeze(0).expand((TRAIN_STEPS,) + tuple(a.shape)) for a in bt))
        reset_counts()
        with NoPlainTwins(kern):
            _, metrics = epoch(graph_state, xs)
            torch.cuda.synchronize()
        captured = counts()
        want_cap = {k: (CAPTURE_WARMUP + 1) * v // TRAIN_STEPS for k, v in want.items()}
        diff = max((x - y).abs().max().item()
                   for x, y in zip(state.model.parameters(), graph_state.model.parameters()))
        loss_diff = (metrics["loss"].cpu() - losses).abs().max().item()
        log(f"[train] {label} the same {TRAIN_STEPS} steps by graph replay (make_epoch_step): "
            f"launches while capturing {captured} ({CAPTURE_WARMUP} warm-up steps and the capture, "
            f"expected {want_cap}; a replay calls no wrapper); parameters max |graph - eager| "
            f"{diff:.3e}, losses {loss_diff:.3e}; step {int(graph_state.step)}")
        check(captured == want_cap, f"{tag} launches while capturing {captured} != {want_cap}")
        check(int(graph_state.step) == TRAIN_STEPS, "the graph epoch did not take every step")
        check(bool(torch.isfinite(metrics["loss"]).all()), f"{tag} graph losses not finite")
        if tag == "A":
            check(diff == 0.0 and loss_diff == 0.0,
                  "A: the graph-replayed epoch's parameters differ from the eager steps'")

        # timing (the checks above passed)
        wall, event = steps_ms(lambda: step(state, bt), reps=10)
        replay_wall, replay_event = steps_ms(lambda: epoch(graph_state, xs), reps=1)
        replay_wall, replay_event = replay_wall / TRAIN_STEPS, replay_event / TRAIN_STEPS
        work = S_TRAIN * n_edges * cfg.K
        log(f"[train] {label} case{CASE} K{cfg.K} b{S_TRAIN}: eager {wall:.3f} ms per step host wall, "
            f"{event:.3f} ms CUDA events = {work / wall * 1e3:.4e} train edges/s; graph replay "
            f"{replay_wall:.3f} ms per step host wall, {replay_event:.3f} ms CUDA events = "
            f"{work / replay_wall * 1e3:.4e} train edges/s ({S_TRAIN} x {n_edges} lines x K {cfg.K} per "
            f"step, bench.py:137; card: {card})")
        expect = {"segment_sum_": fwd["K1"] + bwd["K1"], "gns_gather_": fwd["K2"] + bwd["K2"]}
        idle = {"eager step": step_idle(label, "eager step", lambda: step(state, bt), expect)}
        host_ops(label, lambda: step(state, bt))
        results[tag] = dict(forward=fwd, backward=bwd, steps=main, eager_ms=wall, replay_ms=replay_wall,
                            replay_edges_per_s=work / replay_wall * 1e3, grad_share=grad_share,
                            idle=idle)
        del state, step, graph_state, epoch

    # a padded case9 + case14 batch (per-sample topology) through the
    # kernels' backward: every id in range, so K1's backward (K2) runs
    mixed = batch_from_cases([*generate_cases(9, 3, seed=11), *generate_cases(14, 3, seed=12)])
    cfg = train_configs()["A"]
    state = init_train_state(0, cfg, device="cuda")
    reset_counts()
    with NoPlainTwins(kern):
        _, m = make_train_step(cfg)(state, mixed)
        loss = float(m["loss"])
    got = counts()
    log(f"[train] padded case9 + case14 batch (8 grids, masked, per-sample index): one step, "
        f"loss {loss:.6e}, launches {got}")
    check(np.isfinite(loss) and got["K1"] > 0 and got["K2"] > 0 and got["K3"] == got["K4"] == 0,
          "the masked batch's step did not run through K1 / K2")
    log(f"[train] phase took {time.perf_counter() - t_phase:.1f} s")
    return results


def step_idle(label: str, what: str, run, expect: dict) -> float:
    """One trace of three runs of a training step (trace_busy): busy time,
    activities, K1 / K2's share and the idle share, logged; returns the
    idle share of the untraced windows in %."""
    untraced, traced, busy, spans, _ = trace_busy(run, reps=3, what=what, expect=expect)
    kernel_ms = sum(hi - lo for lo, hi, name in spans
                    if "segment_sum_" in name or "gns_gather_" in name) / 3e3
    idle = 100 * (1 - busy / sum(untraced))
    log(f"[train] {label} {what} x3 (one trace): device windows "
        f"{', '.join(f'{w:.3f}' for w in traced)} ms traced, "
        f"{', '.join(f'{w:.3f}' for w in untraced)} ms untraced just before; busy "
        f"{busy / 3:.3f} ms per step in {len(spans) / 3:.1f} device activities, of which "
        f"{expect['segment_sum_']} K1 and {expect['gns_gather_']} K2 take {kernel_ms:.3f} ms; "
        f"idle {100 * (1 - busy / sum(traced)):.1f}% of the traced windows, "
        f"{idle:.1f}% of the untraced")
    return idle


def train_timing_child() -> int:
    """`chip_smoke.py --train-timing`, run by phase_train_child in a process
    of its own: the training backward's K1 / K2 shapes against their bounds
    and library calls (phase_train_timing), then the busy and idle share of
    one replayed step per configuration; last, one JSON line with the idle
    shares. Its first device-time reading comes before any CUDA graph is
    captured or any training step traced."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gns_torch.models.gns import gns_forward, step_params
    from gns_torch.ops import segment as seg
    from gns_torch.ops import segment_kernels as kern
    from gns_torch.train.trainer import init_train_state, make_epoch_step
    from gns_torch.utils.prepare import GridBatch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device()
    _, topo, bt, graph = train_problem()
    backward = {}
    for cfg in train_configs().values():
        state = init_train_state(0, cfg, device="cuda")
        params = list(state.model.parameters())
        loss = gns_forward(step_params(state.model, cfg), cfg, bt, graph, dense=True).total_loss.mean()
        with PathRecorder(kern, seg) as recorder:
            torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
        backward.update(recorder.inputs)
        del state, params, loss
    phase_train_timing(kern, backward, card)
    del backward
    idle = {}
    one = GridBatch(*(a.unsqueeze(0) for a in bt))
    for tag, cfg in train_configs().items():
        label = f"{tag} ({cfg.compute_dtype}, {'parity' if cfg.reference_parity else 'paper, fold'})"
        state = init_train_state(0, cfg, device="cuda")
        epoch = make_epoch_step(cfg, topo=topo, dense=True)
        epoch(state, one)  # the capture
        fwd, bwd = train_launches(cfg)
        expect = {"segment_sum_": fwd["K1"] + bwd["K1"], "gns_gather_": fwd["K2"] + bwd["K2"]}
        idle[tag] = step_idle(label, "replayed step", lambda: epoch(state, one), expect)
        del state, epoch
    log(json.dumps({"replayed_step_idle": idle}))
    return 0


def phase_train_child(results: dict) -> None:
    """The train phase's device-time readings (train_timing_child) in a
    process of its own. In this script's process, once the train phase has
    run (its CUDA-graph captures and replays, its traces), the profiler
    has left one activity out of nearly every trace that follows, in some
    runs; a new process starts clean. Its lines are printed when it ends
    (it is killed after 300 s); its replayed-step idle shares join
    `results`."""
    t0 = time.perf_counter()
    lines = run_child(["--train-timing"], "train timing", 300)
    last = [line for line in lines if line.startswith('{"replayed_step_idle"')]
    check(bool(last), "the train timing process printed no idle shares")
    for tag, idle in json.loads(last[-1])["replayed_step_idle"].items():
        results[tag]["idle"]["replayed step"] = idle
    log(f"[train timing] the train phase's device-time readings took {time.perf_counter() - t0:.1f} s "
        f"in a process of their own")


def phase_eval(kern, seg, card) -> dict:
    """The evaluation path on the card (module docstring, phase 10).
    Returns the K1 / K2 counts of its runs for the kernels line."""
    from gns_torch.eval.harness import compute_metrics, evaluate, run_gns, run_nr_oracle
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.train.supervised import (make_supervised_train_step, nr_labels,
                                            train_supervised)
    from gns_torch.train.trainer import CAPTURE_WARMUP, init_train_state, state_to, train
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.config import GNSConfig
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    torch.backends.cuda.matmul.allow_tf32 = False  # "f32 means f32" (ROADMAP)
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    out = {}

    # (a) the shipped case300 checkpoint against the oracle
    t0 = time.perf_counter()
    cases = list(generate_cases(CASE, EVAL_GRIDS - 1, seed=0, scale=0.5, feasible_only=True))
    log(f"[eval] (a) {len(cases)} feasible case{CASE} grids (generate_cases(300, 63, seed=0, "
        f"scale=0.5, feasible_only=True)) in {time.perf_counter() - t0:.2f} s (host)")
    model, cfg = load_pretrained(CASE, device="cuda")
    reset_counts()
    with NoPlainTwins(kern):
        metrics = evaluate(model, cfg, cases)
        torch.cuda.synchronize()
    got = counts()
    forwards = len(cases) + 1  # run_gns: one untimed warm-up forward of the shape, then each grid
    per = {"K1": 1 + 4 * cfg.K, "K2": 2 + 5 * cfg.K}  # serving's float32 counts per forward
    want = {"K1": forwards * per["K1"], "K2": forwards * per["K2"], "K3": 0, "K4": 0}
    log(f"[eval] (a) evaluate() launches {got} (expected {want}: {forwards} forwards, "
        f"{len(cases)} grids and one warm-up, {per['K1']} K1 + {per['K2']} K2 each, as serving)")
    check(got == want, f"eval launches {got} != {want}")
    for key, value in metrics.items():
        log(f"[eval] (a) {key} {value:.6g}")
    check(metrics["nr_converged_frac"] == 1.0, "the NR oracle did not converge on every eval grid")
    check(all(np.isfinite(v) for v in metrics.values()), "a non-finite eval metric")
    nr = run_nr_oracle(cases)
    on_card = run_gns(model, cfg, cases)
    model_cpu, _ = load_pretrained(CASE, device="cpu")
    on_cpu = run_gns(model_cpu, cfg, cases)
    for key, rtol, atol in (("v", 2e-4, 2e-4), ("theta", 2e-4, 2e-4), ("last_loss", 5e-4, 0.0)):
        agree("eval", "run_gns card vs cpu", on_card[key], on_cpu[key], rtol, atol, key)
    log(f"[eval] (a) per grid: NR {1e3 * nr['time'].mean():.3f} ms (host, scipy float64), "
        f"GNS {1e3 * on_card['time'].mean():.3f} ms on the card (copy in, K={cfg.K} forward, "
        f"synchronize), {1e3 * on_cpu['time'].mean():.3f} ms on the CPU (card: {card})")
    out["eval"] = dict(grids=len(cases), forwards=forwards, launches=got, per_forward=per,
                       v_mse=metrics["v_mse"], theta_mse=metrics["theta_mse"],
                       nr_ms=1e3 * float(nr["time"].mean()),
                       gns_ms=1e3 * float(on_card["time"].mean()))
    del model, model_cpu

    # (b) the case30 multi-seed protocol (tools/accuracy_multiseed.py:94-102,
    # :150-169): the seeds' v MSE beside gns_tpu's band
    pool = list(generate_cases(30, 1000, seed=20301))
    train_cases, eval_cases = pool[1:257], pool[1001 - 232:1001]
    log(f"[eval] (b) case30 pool of {len(pool)} cases; training on pool[1:257] ({len(train_cases)} "
        f"grids), evaluating on pool[769:1001] ({len(eval_cases)} grids, gns_tpu's slice)")
    nr30 = run_nr_oracle(eval_cases)
    data30 = batch_from_cases(train_cases)
    rows = []
    for seed in SEEDS:
        cfg30 = GNSConfig(K=4, latent_dim=20, hidden_dim=10, multiple_phi=True, epochs=101,
                          nr_samples=256, seed=seed, case_nr=30, batch_size=128,
                          early_stop_patience=2, reference_parity=True)
        t0 = time.perf_counter()
        with NoPlainTwins(kern):
            best, history = train(cfg30, data30, device="cuda")
            sec = time.perf_counter() - t0
            g = run_gns(state_to(best, "cuda").model, cfg30, eval_cases)
        m = compute_metrics(nr30, g)
        rows.append(m["v_mse"])
        log(f"[eval] (b) seed {seed}: v MSE {m['v_mse']:.5f}, theta MSE {m['theta_mse']:.5f}, "
            f"theta centred MSE {m['theta_centered_mse']:.5f}, {len(history)} epochs in {sec:.2f} s "
            f"(CUDA-graph replay), NR converged on {100 * m['nr_converged_frac']:.0f}%")
        check(np.isfinite(m["v_mse"]) and np.isfinite(m["theta_mse"]), f"seed {seed}: non-finite MSE")
        check(m["v_mse"] <= WORST_DRAW, f"seed {seed}: v MSE {m['v_mse']:.5f} above {WORST_DRAW}")
    median = statistics.median(rows)
    inside = GNS_TPU_BAND[0] <= median <= GNS_TPU_BAND[1]
    log(f"[eval] (b) case30 v MSE over seeds {SEEDS}: median {median:.5f} (range {min(rows):.5f} "
        f"to {max(rows):.5f}); gns_tpu's recorded band {GNS_TPU_BAND[0]}-{GNS_TPU_BAND[1]}: "
        f"{'inside' if inside else 'OUTSIDE'} (card: {card})")
    out["multiseed"] = dict(v_mse=rows, median=median, eval_grids=len(eval_cases))

    # (c) supervised training on NR labels: one eager step's launches held
    # against the code and their twins, then 5 epochs by graph replay
    sup_cases = list(generate_cases(30, 128, seed=7, feasible_only=True))[1:]
    data = batch_from_cases(sup_cases)
    topo = extract_shared_topology(data)
    labels = nr_labels(sup_cases, n_pad=data.buses.shape[1])
    cfg_s = train_configs()["A"].replace(case_nr=30, batch_size=128, epochs=SUP_EPOCHS,
                                         early_stop_patience=SUP_EPOCHS)
    fwd, bwd = train_launches(cfg_s)
    per_step = {k: fwd[k] + bwd[k] for k in fwd}
    state = init_train_state(0, cfg_s, device="cuda")
    step = make_supervised_train_step(cfg_s, 0.1, topo=topo, dense=True)
    recorder = PathRecorder(kern, seg)
    reset_counts()
    with NoPlainTwins(kern), recorder:
        step(state, data, labels)
        torch.cuda.synchronize()
    got = counts()
    want = dict(per_step, K3=0, K4=0)
    log(f"[eval] (c) one supervised step on {len(sup_cases)} feasible case30 grids: launches {got} "
        f"(expected {want}: the training step's, train_launches)")
    check(got == want, f"supervised step launches {got} != {want}")
    held = hold_recorded(kern, recorder.inputs, "supervised")
    log(f"[eval] (c) all {held} distinct K1 / K2 launches of the step bit-equal to their twins")
    reset_counts()
    with NoPlainTwins(kern):
        _, history = train_supervised(cfg_s, data, labels, w_physics=0.1, seed=0, device="cuda")
    got = counts()
    want = {k: (CAPTURE_WARMUP + 1) * v for k, v in per_step.items()}
    want.update(K3=0, K4=0)
    sups = [r["sup"] for r in history]
    log(f"[eval] (c) train_supervised {len(history)} epochs by graph replay: sup "
        + ", ".join(f"{x:.6e}" for x in sups) + f"; physics {history[-1]['physics']:.6e}; "
        f"launches while capturing {got} (expected {want}; a replay calls no wrapper)")
    check(got == want, f"supervised capture launches {got} != {want}")
    check(len(sups) == SUP_EPOCHS and all(np.isfinite(sups)) and sups[-1] < sups[0],
          f"supervised losses not finite or not falling: {sups}")
    out["supervised_step"] = per_step

    # (d) train() on a padded case9 + case14 dataset (no shared topology):
    # eager steps on K1/K2
    c9, c14 = list(generate_cases(9, 4, seed=11))[1:], list(generate_cases(14, 4, seed=12))[1:]
    mixed = batch_from_cases([c for pair in zip(c9, c14) for c in pair])
    check(extract_shared_topology(mixed) is None and not mixed.is_dense(), "the mixed batch is shared")
    cfg_d = train_configs()["A"].replace(case_nr=14, batch_size=4, epochs=2, early_stop_patience=2)
    reset_counts()
    with NoPlainTwins(kern):
        _, history = train(cfg_d, mixed, device="cuda")
    got = counts()
    want = {k: 2 * 2 * v for k, v in per_step.items()}  # 2 epochs of 2 batches
    want.update(K3=0, K4=0)
    losses = [r["final_loss"] for r in history]
    log(f"[eval] (d) train() on the padded case9 + case14 batch (8 grids, per-sample index), 2 "
        f"epochs of 2 eager steps: final_loss {losses}, launches {got} (expected {want})")
    check(len(losses) == 2 and all(np.isfinite(losses)), "the mixed batch's losses are not finite")
    check(got == want, f"mixed-batch train launches {got} != {want}")

    # (e) K1's backward over an index with dropped ids: a masked K2
    batch, topo300 = case300_indices()
    n, e = batch.buses.shape[1], batch.lines.shape[1]
    dst = np.where(np.arange(e) % 5 == 1, n + 7, topo300.dst)  # every fifth id dropped
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((S_SERVE, e, 60), generator=gen, device="cuda", requires_grad=True)
    w = torch.randn((S_SERVE, n, 60), generator=gen, device="cuda")
    reset_counts()
    with NoPlainTwins(kern):
        (seg.segment_sum(x, seg.SegmentIndex(dst, n, "cuda")) * w).sum().backward()
        torch.cuda.synchronize()
    got = counts()
    xc = x.detach().cpu().requires_grad_(True)
    (seg.segment_sum(xc, seg.SegmentIndex(dst, n, "cpu")) * w.cpu()).sum().backward()
    same = torch.equal(x.grad.cpu(), xc.grad)
    log(f"[eval] (e) K1 forward + backward over an index with {int((np.arange(e) % 5 == 1).sum())} "
        f"dropped ids (S={S_SERVE}, D=60): launches {got} (expected one K1 and one masked K2); "
        f"gradient {'bit-equal' if same else 'NOT equal'} to the CPU twin's autograd, dropped rows "
        f"zero: {bool((x.grad[:, np.arange(e) % 5 == 1] == 0).all())}")
    check(got == {"K1": 1, "K2": 1, "K3": 0, "K4": 0}, f"dropped-id backward launches {got}")
    check(same, "K1's backward over dropped ids differs from the CPU twin's gradient")
    log(f"[eval] phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def solve_arms(model, cfg, cases, mesh=None):
    """The solve phase's arms on the model's device, by name: functions of
    no argument returning the result dict. mesh: phase 14's dp mesh."""
    from gns_torch.eval import dcpf, fdpf, hybrid, nr_batched, solve

    dev = next(model.parameters()).device
    m = dict(mesh=mesh)
    return {
        "flat NR": lambda: nr_batched.solve_batched(cases, device=dev, **m),
        "FDPF": lambda: fdpf.solve_batched_fdpf(cases, device=dev, **m),
        "hybrid NR": lambda: hybrid.hybrid_solve(model, cfg, cases, **m),
        "hybrid FDPF": lambda: hybrid.hybrid_solve(model, cfg, cases, solver="fdpf", max_iter=60,
                                                   **m),
        "solve_ac auto": lambda: solve.solve_ac(cases, params=model, cfg=cfg, device=dev, **m),
        "DC": lambda: dcpf.solve_batched_dc(cases, device=dev, **m),
    }


def solve_launches(arm: str, out: dict, forward: dict) -> dict:
    """K1 / K2 launches of one solve arm over one chunk, as eval/ gives
    them: a Newton solve assembles G/B once (one K1), and its compaction is
    off; a fast-decoupled solve assembles B' and B'' (two K1) and evaluates
    the injections once before the loop and twice per iteration, each one
    K2 gather of (vm, va) at the branch ends and one K1 sum at the buses;
    the hybrids add one forward (`forward`, serving's counts); a flat
    Newton fallback adds one assembly; the DC solve is one K1 (matrix and
    injections) and one K2 (the flows' angles)."""
    it = out.get("iterations", 0)
    fallback = 1 if out.get("fallback_grids", 0) else 0
    fd = fdpf_launches(it)
    want = {
        "flat NR": {"K1": 1, "K2": 0},
        "FDPF": fd,
        "hybrid NR": {"K1": forward["K1"] + 1 + fallback, "K2": forward["K2"]},
        "hybrid FDPF": {"K1": forward["K1"] + fd["K1"] + fallback, "K2": forward["K2"] + fd["K2"]},
        "solve_ac auto": {"K1": fd["K1"] + fallback, "K2": fd["K2"]},
        "DC": {"K1": 1, "K2": 1},
    }[arm]
    return dict(want, K3=0, K4=0)


def hold_solve(arm: str, got: dict, want: dict, tol: float = 3e-5, tag: str = "solve",
               what: str = "card vs cpu") -> None:
    """One arm on the card (got) against the port's CPU run on the same
    grids (want; phase 14: a sharded run against the single-process one):
    converged masks equal; v and theta within SOLVE_CARD_VS_CPU on the
    converged grids; per-grid iteration counts equal except on grids where
    a gate decided at its edge (module constant SOLVE_EDGE), and lock-step
    counts equal or off by exactly what those grids explain."""
    v_tol, th_tol = SOLVE_CARD_VS_CPU
    if arm == "DC":
        th = np.abs(np.deg2rad(got["theta_deg"]) - np.deg2rad(want["theta_deg"])).max()
        pf = np.abs(got["pf_mw"] - want["pf_mw"]).max()
        ok = th <= DC_CARD_VS_CPU[0] and pf <= DC_CARD_VS_CPU[1] * max(1.0, np.abs(want["pf_mw"]).max())
        log(f"[{tag}] {arm} {what}: theta {th:.3e} rad, pf {pf:.3e} MW {'ok' if ok else 'MISMATCH'}")
        check(ok and np.isfinite(got["theta_deg"]).all(), f"{arm}: {what}")
        return
    conv = want["converged"]
    check(np.array_equal(got["converged"], conv), f"{arm}: converged masks differ ({what}) "
          f"{int(got['converged'].sum())} against {int(conv.sum())}")
    dv = np.abs(got["v"] - want["v"])[conv].max()
    dth = np.abs(got["theta_deg"] - want["theta_deg"])[conv].max()
    diff = np.flatnonzero(got["iterations_per_grid"] != want["iterations_per_grid"])
    edge = []
    for g in diff:
        a, b = int(got["iterations_per_grid"][g]), int(want["iterations_per_grid"][g])
        first = got if a < b else want  # the run that accepted the grid first
        m = float(first["mismatch"][g])
        if abs(a - b) == 1 and conv[g] and m >= SOLVE_EDGE * tol:
            edge.append(g)
    lock_card, lock_cpu = got["iterations"], want["iterations"]
    explained = (lock_card == lock_cpu
                 or (abs(lock_card - lock_cpu) == 1 and set(diff) == set(edge)
                     and lock_card - lock_cpu == int(got["iterations_per_grid"].max())
                     - int(want["iterations_per_grid"].max())))
    ok = dv <= v_tol and dth <= th_tol and set(diff) == set(edge) and explained
    log(f"[{tag}] {arm} {what}: converged {int(conv.sum())} of {len(conv)} both; v {dv:.3e} "
        f"(<= {v_tol:g}), theta {dth:.3e} deg (<= {th_tol:g}); lock-step iterations "
        f"{lock_card} and {lock_cpu}; per-grid counts differ on {len(diff)} grids, {len(edge)} of "
        f"them decided at a gate's edge{': ' + str(sorted(int(g) for g in edge)) if edge else ''} "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{arm}: {what}")


def hold_oracle(arm: str, got: dict, ref_v, ref_th, bounds) -> None:
    """One arm against the scipy float64 oracle on every grid."""
    conv = got["converged"]
    check(bool(conv.all()), f"{arm}: {int((~conv).sum())} grids did not converge")
    dv = np.abs(got["v"] - ref_v)
    dth = np.abs(got["theta_deg"] - ref_th)
    ok = dv.max() <= bounds[0] and dth.max() <= bounds[1]
    log(f"[solve] {arm} vs the scipy float64 oracle, {len(conv)} grids: v {dv.max():.3e} worst, "
        f"{np.quantile(dv, 0.999):.3e} at p99.9 (<= {bounds[0]:g}); theta {dth.max():.3e} deg "
        f"worst, {np.quantile(dth, 0.999):.3e} at p99.9 (<= {bounds[1]:g}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{arm}: against the oracle")


def phase_solve(kern, seg, card) -> dict:
    """The exact-solver ladder on the card (module docstring, phase 11).
    Returns each arm's K1 / K2 counts for the kernels line."""
    from gns_torch.eval import nr_batched
    from gns_torch.eval.harness import run_nr_oracle
    from gns_torch.eval.newton_raphson import newton_raphson_pf
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.utils.augment import generate_cases

    torch.backends.cuda.matmul.allow_tf32 = False  # "f32 means f32" (ROADMAP)
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cases = list(generate_cases(CASE, SOLVE_GRIDS - 1, seed=0, scale=0.5, feasible_only=True))
    log(f"[solve] {len(cases)} feasible case{CASE} grids (generate_cases(300, 255, seed=0, "
        f"scale=0.5, feasible_only=True)) in {time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    refs = [newton_raphson_pf(c) for c in cases]
    scipy_ms = 1e3 * (time.perf_counter() - t0) / len(cases)
    check(all(r.success for r in refs), "the scipy oracle did not converge on every grid")
    ref_v = np.stack([r.vm for r in refs])
    ref_th = np.stack([r.va_deg for r in refs])
    log(f"[solve] scipy float64 oracle: {scipy_ms:.3f} ms per grid (host)")
    model, cfg = load_pretrained(CASE, device="cuda")
    model_cpu, _ = load_pretrained(CASE, device="cpu")
    forward = train_launches(cfg)[0]  # one forward's K1 / K2, serving's counts
    on_card, on_cpu = solve_arms(model, cfg, cases), solve_arms(model_cpu, cfg, cases)
    recorder = PathRecorder(kern, seg)
    results = {}
    for arm, run in on_card.items():
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with NoPlainTwins(kern), recorder:
            got = run()
            torch.cuda.synchronize()
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want_launches = solve_launches(arm, got, forward)
        t0 = time.perf_counter()
        run()  # the same solve again, timed: index sets built, libraries loaded
        ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = on_cpu[arm]()
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        per = f", of which one forward {forward}" if "hybrid" in arm else ""
        log(f"[solve] {arm}: launches {launches} (expected {want_launches}{per}); "
            + ("" if arm == "DC" else
               f"iterations {got['iterations']} (per grid {int(got['iterations_per_grid'].min())}-"
               f"{int(got['iterations_per_grid'].max())}), host syncs {got['host_syncs']}, "
               f"fallback grids {got.get('fallback_grids', 0)}, stalled "
               f"{int(got['stalled'].sum())}; ")
            + f"{ms:.3f} ms per chunk of {len(cases)}, {ms / len(cases):.4f} ms per grid on the card "
            f"(host wall, second run), scipy {scipy_ms:.3f} ms per grid; the port's CPU path "
            f"{cpu_ms:.1f} ms; peak device memory {peak:.3f} GiB (card: {card})")
        check(launches == want_launches, f"{arm}: launches {launches} != {want_launches}")
        hold_solve(arm, got, want)
        if arm == "DC":
            err = np.abs(got["theta_deg"] - ref_th)
            log(f"[solve] DC vs the AC oracle (an approximation): theta {err.max():.3f} deg worst, "
                f"{err.mean():.3f} mean (<= {DC_VS_ORACLE_DEG:g} worst)")
            check(err.max() <= DC_VS_ORACLE_DEG, "DC angles beyond the DC band")
        else:
            hold_oracle(arm, got, ref_v, ref_th,
                        SOLVE_VS_ORACLE["fdpf" if "FDPF" in arm or "auto" in arm else "nr"])
        if arm == "solve_ac auto":
            log(f"[solve] solve_ac auto resolved to warm_start {got['warm_start']!r}, method "
                f"{got['method']!r}, compact_after {got['compact_after']}")
        results[arm] = {k: launches[k] for k in ("K1", "K2")}
    del on_cpu, model_cpu

    # run_nr_oracle(backend="batched") on the eval phase's 64 grids (the
    # first 64 of these: generate_cases draws them in the same order)
    first = cases[:EVAL_GRIDS]
    reset_counts()
    with NoPlainTwins(kern), recorder:
        nr = run_nr_oracle(first, backend="batched", device="cuda")
        torch.cuda.synchronize()
    launches = counts()
    want_launches = {"K1": 2, "K2": 0, "K3": 0, "K4": 0}  # a warm pass and the timed pass
    log(f"[solve] run_nr_oracle(backend='batched') on the first {len(first)} grids: launches "
        f"{launches} (expected {want_launches}), {1e3 * float(nr['time'][0]):.4f} ms per grid "
        f"(the timed pass over the grid count; card: {card})")
    check(launches == want_launches, f"batched oracle launches {launches}")
    check(set(nr) == {"time", "v", "theta_deg", "line_flow", "converged"}, "batched oracle keys")
    hold_oracle("run_nr_oracle batched", dict(nr, theta_deg=nr["theta_deg"]), ref_v[:EVAL_GRIDS],
                ref_th[:EVAL_GRIDS], SOLVE_VS_ORACLE["nr"])
    results["run_nr_oracle batched"] = {k: launches[k] for k in ("K1", "K2")}
    held = hold_recorded(kern, recorder.inputs, "solve")
    log(f"[solve] all {held} distinct K1 / K2 launches of the phase bit-equal to their plain twins")

    # one Newton iteration's parts at this chunk's shape (CUDA events)
    bus, branch, gen, base = nr_batched.stack_cases(cases)
    ns = nr_batched.build_nr_small_stacked(bus, branch, gen, base)
    f = branch[0, :, 0].astype(np.int64) - 1
    t = branch[0, :, 1].astype(np.int64) - 1
    topo = nr_batched._topology(f, t, bus.shape[1], ns.pvpq, ns.pq, torch.device("cuda"))
    busj, branchj, basej, vm, va = nr_batched._on("cuda", bus, branch, base, ns.vm0, ns.va0)
    with torch.no_grad():
        gmat, bmat = nr_batched._assemble_gb(busj, branchj, basej, topo.pattern, True)
        terms = nr_batched._trig_terms(gmat, bmat, vm, va)
        jac = nr_batched._jacobian(gmat, bmat, vm, *terms, topo.pvpq, topo.pq)
        lu, piv = nr_batched.lu_factor(jac)
        rhs = torch.ones((jac.shape[0], jac.shape[1], 1), device="cuda")
        parts = {
            "trig terms": cuda_ms(lambda: nr_batched._trig_terms(gmat, bmat, vm, va), reps=10, warmup=2),
            "Jacobian build": cuda_ms(
                lambda: nr_batched._jacobian(gmat, bmat, vm, *terms, topo.pvpq, topo.pq),
                reps=10, warmup=2),
            "lu_factor_ex": cuda_ms(lambda: nr_batched.lu_factor(jac), reps=10, warmup=2),
            "lu_solve": cuda_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs), reps=10, warmup=2),
        }
    total = sum(parts.values())
    log(f"[solve] one Newton iteration's parts at S={jac.shape[0]}, M={jac.shape[1]} (CUDA events): "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f"; the LU's share {100 * parts['lu_factor_ex'] / total:.1f}% (card: {card})")
    rtt = nr_batched.measured_dispatch_rtt("cuda")
    log(f"[solve] measured_dispatch_rtt {1e3 * rtt:.4f} ms; compact_after='auto' resolves to "
        f"{nr_batched.resolve_compact_after('auto', device='cuda')} (break-even "
        f"{1e3 * nr_batched._COMPACT_RTT_BREAKEVEN:g} ms)")
    del gmat, bmat, terms, jac, lu

    # the busy and idle share of one flat solve, traced in a process of its
    # own (after the train phase this process's traces drop activities)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "solve_cases.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, bus=bus, branch=branch, gen=gen, base=base)
    t0 = time.perf_counter()
    run_child(["--solve-timing", path], "solve timing", 300)
    log(f"[solve timing] the flat solve's trace took {time.perf_counter() - t0:.1f} s in a process "
        f"of its own")
    log(f"[solve] phase took {time.perf_counter() - t_phase:.1f} s")
    return results


def cases_from_npz(path: str) -> list:
    """The case dicts of phase_solve's stacked arrays."""
    with np.load(path) as z:
        bus, branch, gen, base = z["bus"], z["branch"], z["gen"], z["base"]
    return [{"bus": bus[i], "branch": branch[i], "gen": gen[i], "baseMVA": float(base[i])}
            for i in range(len(base))]


def solve_timing_child(path: str) -> int:
    """`chip_smoke.py --solve-timing CASES.npz`: the device's busy and idle
    share of one flat Newton solve of the stacked cases, from one profiler
    trace (trace_busy), in a process of its own."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gns_torch.eval.nr_batched import solve_batched

    card = phase_device()
    cases = cases_from_npz(path)
    out = solve_batched(cases)  # warm: index sets, libraries
    untraced, traced, busy, spans, _ = trace_busy(lambda: solve_batched(cases), reps=2,
                                                  what="flat solve", expect={"segment_sum_": 1})
    log(f"[solve timing] flat NR, {len(cases)} case{CASE} grids, {out['iterations']} iterations, "
        f"{out['host_syncs']} host syncs: device windows {', '.join(f'{w:.3f}' for w in traced)} ms "
        f"traced, {', '.join(f'{w:.3f}' for w in untraced)} ms untraced; busy {busy / 2:.3f} ms per "
        f"solve in {len(spans) / 2:.1f} device activities; idle {100 * (1 - busy / sum(traced)):.1f}% "
        f"of the traced windows, {100 * (1 - busy / sum(untraced)):.1f}% of the untraced (card: {card})")
    return 0


class Compactions:
    """While active, counts the straggler sub-batch solves of
    nr_batched.solve_batched's per-grid exit (compact_after): the chunks
    that still held a grid not converged after the lock-step iterations."""

    def __init__(self):
        self.solves = 0

    def __enter__(self):
        from gns_torch.eval import nr_batched

        self.module, self.saved = nr_batched, nr_batched._compact_stragglers

        def counted(packed, k1, max_iter, *args):
            n = (packed.shape[1] - 4) // 2
            self.solves += int(k1 < max_iter and bool((packed[:, 2 * n] < 0.5).any()))
            return self.saved(packed, k1, max_iter, *args)

        nr_batched._compact_stragglers = counted
        return self

    def __exit__(self, *exc):
        self.module._compact_stragglers = self.saved
        return False


def screen_sev_bound(card_v, cpu_v, is_pq, score: str, card_base=None, cpu_base=None,
                     v_limits=(0.94, 1.06)):
    """Per-contingency bound on |severity(card) - severity(cpu)| from the
    predictions' own deviations (each already held to serving's float32
    bound). "rms": the rms of (v - v_intact) moves by at most
    max |dv| + max |dv_intact| (the triangle inequality). "depth": each PQ
    bus adds its excursion past a limit, a 1-Lipschitz function of v that
    is 0 unless v lies past the limit, so the sum moves by at most the
    |dv| of the buses past a limit in either run. A float32 rounding of
    the score (1e-6 of it) comes on top."""
    dv = np.abs(card_v.astype(np.float64) - cpu_v)
    if score == "rms":
        return dv.max(axis=1) + np.abs(card_base.astype(np.float64) - cpu_base).max()
    lo, hi = v_limits
    past = ((cpu_v < lo) | (cpu_v > hi) | (card_v < lo) | (card_v > hi)) & is_pq[None, :]
    return (dv * past).sum(axis=1)


def screen_group_iterations(variants, idx, itg) -> list:
    """The lock-step iteration count of each bus-type group's solve, in the
    screens' order (contingency._by_signature): the largest per-grid count
    of its members (a loop runs until its last grid converged or its
    budget ran out)."""
    from gns_torch.eval.contingency import _by_signature

    idx = np.asarray(idx)
    return [int(itg[idx[rows]].max()) for rows in _by_signature(variants, idx).values()]


def fdpf_launches(it: int) -> dict:
    """One fast-decoupled solve of `it` iterations: B' and B'' (two K1),
    the injections before the loop and twice per iteration (a K2 gather at
    the branch ends and a K1 sum at the buses each); solve_launches' FDPF."""
    return {"K1": 3 + 2 * it, "K2": 1 + 2 * it}


def add_launches(*parts) -> dict:
    return {k: sum(p[k] for p in parts) for k in ("K1", "K2")}


def island_injection(case, pair) -> float:
    """Sum of |Pd| + |Pg| (in-service) + |Gs| over the buses that the
    pair's two outages cut off from the slack: 0 for the balanced-island
    class (gns_torch/eval/n2.py n2_islanding_pairs)."""
    bus = np.asarray(case["bus"], np.float64)
    br = np.asarray(case["branch"], np.float64)
    gen = np.asarray(case["gen"], np.float64)
    n = bus.shape[0]
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for j in np.flatnonzero(br[:, 10] > 0):
        if j not in pair:
            parent[find(int(br[j, 0]) - 1)] = find(int(br[j, 1]) - 1)
    slack = find(int(np.flatnonzero(bus[:, 1] == 3)[0]))
    cut = np.array([find(i) != slack for i in range(n)])
    pg = np.zeros(n)
    np.add.at(pg, gen[:, 0].astype(int) - 1, np.abs(gen[:, 1]) * (gen[:, 7] > 0))
    return float((np.abs(bus[:, 2]) + pg + np.abs(bus[:, 4]))[cut].sum())


def hold_screen_states(tag, got, want, conv, skip_theta=None) -> None:
    """States of the contingencies both runs converged: v and theta
    (degrees) within SOLVE_CARD_VS_CPU; skip_theta masks angles that are
    indeterminate (a balanced island)."""
    v_tol, th_tol = SOLVE_CARD_VS_CPU
    keep = conv if skip_theta is None else conv & ~skip_theta
    dv = float(np.abs(got["v"] - want["v"])[conv].max())
    dth = float(np.abs(got["theta_deg"] - want["theta_deg"])[keep].max())
    ok = dv <= v_tol and dth <= th_tol
    log(f"[screen] {tag} card vs cpu on {int(conv.sum())} converged: v {dv:.3e} (<= {v_tol:g}), "
        f"theta {dth:.3e} deg (<= {th_tol:g}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{tag}: states card vs cpu")


def hold_counts(tag, got, want, conv, hold: bool = True, tol: float = 3e-5) -> None:
    """Per-grid iteration counts, card against the port's CPU run.
    hold_solve's rule lets a count differ, by one, where the run that
    stopped first accepted the grid at its gate's edge (mismatch >=
    SOLVE_EDGE x tol). On case118 the float32 mismatch floor (about
    2.5e-5, nr_batched._nr_solve) sits at tol: a converged grid's mismatch
    wanders between 1e-5 and 5e-5 from one iteration to the next, and
    which iteration first dips under tol, or passes the stall gate's
    progress test, is decided by rounding. So the screens hold a count
    that differs to this: either run accepted the grid at the floor
    (mismatch >= SOLVE_EDGE x tol). The port's CPU run and gns_tpu's on
    JAX's CPU differ so too (tests/test_torch_n2.py
    test_screen_n2_case118_at_the_float32_floor). hold=False (Newton,
    where even that rule missed a grid on the card) prints the counts
    only."""
    a, b = got["iterations_per_grid"].astype(int), want["iterations_per_grid"].astype(int)
    diff = np.flatnonzero(a != b)
    floor = SOLVE_EDGE * tol
    first = np.where(a < b, got["mismatch"], want["mismatch"])
    strict = diff[conv[diff] & (np.abs(a - b)[diff] == 1) & (first[diff] >= floor)]
    wide = diff[conv[diff] & (np.maximum(got["mismatch"], want["mismatch"])[diff] >= floor)]
    rest = sorted(set(diff.tolist()) - set(strict.tolist()))[:10]
    ok = len(wide) == len(diff)
    log(f"[screen] {tag}: per-grid iteration counts differ from the CPU run on {len(diff)} of "
        f"{len(a)}, by at most {int(np.abs(a - b).max())}; {len(strict)} within hold_solve's rule, "
        f"{len(wide)} accepted at the floor (mismatch >= {floor:g}) in either run"
        + (f"; beyond hold_solve's rule (index, card, cpu, mismatch card, cpu): "
           + ", ".join(f"({i}, {a[i]}, {b[i]}, {got['mismatch'][i]:.2e}, {want['mismatch'][i]:.2e})"
                       for i in rest) if rest else "")
        + f"; grids accepted at the floor: card {int((got['mismatch'][conv] >= floor).sum())}, "
        f"cpu {int((want['mismatch'][conv] >= floor).sum())} of {int(conv.sum())}"
        + ("" if hold else " (printed, not held)") + (" ok" if ok or not hold else " MISMATCH"))
    if hold:
        check(ok, f"{tag}: per-grid counts differ away from the float32 floor")


def hold_ranked(tag, got, want, score, is_pq, bases=(None, None), verified=True) -> None:
    """A ranked screen on the card against the port's CPU run: the
    structural flags equal; pred_v within serving's float32 bound; the
    severities within screen_sev_bound (`bases`: the card's and the CPU's
    intact predictions, for "rms"); with `verified`, the verified sets
    equal but for contingencies whose severity lies within that bound of
    the k-th severity (printed)."""
    check(np.array_equal(got["islanded"], want["islanded"]), f"{tag}: islanded flags differ")
    agree("screen", tag, got["pred_v"], want["pred_v"], SCREEN_V_RTOL, SCREEN_V_ATOL, "pred_v")
    bound = screen_sev_bound(got["pred_v"], want["pred_v"], is_pq, score, *bases)
    fin = ~want["islanded"]
    bound = bound + 1e-6 * np.abs(np.where(fin, want["severity"], 0.0))
    dsev = np.abs(got["severity"][fin] - want["severity"][fin])
    ok = bool((dsev <= bound[fin]).all())
    log(f"[screen] {tag} severity ({score}) card vs cpu: worst {dsev.max():.3e}, its bound "
        f"{bound[fin][np.argmax(dsev)]:.3e}, largest bound {bound[fin].max():.3e} (the predictions' "
        f"deviations carried through the score) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{tag}: severities beyond their bound")
    if not verified:
        return
    k = len(want["verified_idx"])
    rank = want["order"][~want["islanded"][want["order"]]]
    kth = rank[k - 1]
    near = np.flatnonzero(fin & (np.abs(want["severity"] - want["severity"][kth])
                                 <= bound + bound[kth]))
    diff = set(got["verified_idx"].tolist()) ^ set(want["verified_idx"].tolist())
    ok = diff <= set(near.tolist())
    log(f"[screen] {tag} verified sets of {k}: {len(diff)} contingencies differ, {len(near)} lie "
        f"within the severity bound of the k-th severity {want['severity'][kth]:.4e} "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{tag}: verified sets differ beyond near-ties")


def phase_screen(kern, seg, card) -> dict:
    """The contingency screens on the card (module docstring, phase 13).
    Returns each screen's K1 / K2 counts for the kernels line."""
    from gns_torch.eval import contingency, n2
    from gns_torch.eval.newton_raphson import newton_raphson_pf
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.serve import GNSPredictor
    from gns_torch.utils.cases import load_case

    t_phase = time.perf_counter()
    case = load_case(SCREEN_CASE)
    types = np.asarray(case["bus"])[:, 1].astype(int)
    bridges = set(contingency.find_bridges(case).tolist())
    variants = contingency.n1_variants(case, gen_outages=True)
    c = len(variants)
    recorder = PathRecorder(kern, seg)
    results = {}

    def drive(name, run, watch=None):
        """One run with the launches counted and recorded (and `watch`
        active), then the same run again, timed (host wall, index sets
        built)."""
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with NoPlainTwins(kern), recorder, watch or contextlib.nullcontext():
            got = run()
            torch.cuda.synchronize()
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = {k: launches[k] for k in ("K1", "K2")}
        return got, launches, peak, wall

    def report(name, launches, want, got, wall, peak, n, chunks=None):
        want = dict(want, K3=0, K4=0)
        per_chunk = f", {1e3 * wall / chunks:.3f} ms per chunk of {SCREEN_CHUNK}" if chunks else ""
        log(f"[screen] {name}: launches {launches} (expected {want}); host wall {1e3 * wall:.3f} ms "
            f"(second run) = {n / wall:.1f} contingencies/s{per_chunk}; host syncs "
            f"{got['host_syncs']}; peak device memory {peak:.3f} GiB (card: {card})")
        check(launches == want, f"{name}: launches {launches} != {want}")

    # (a) screen_n1, branch and generator outages, warm="base"
    t0 = time.perf_counter()
    refs = {i: newton_raphson_pf(va) for i, va in enumerate(variants)
            if not (va["outage"][0] == "branch" and va["outage"][1] in bridges)}
    check(all(r.success for r in refs.values()), "the oracle failed on a non-bridge outage")
    log(f"[screen] case{SCREEN_CASE}: {c} N-1 contingencies ({sum(o['outage'][0] == 'branch' for o in variants)} "
        f"branch, {sum(o['outage'][0] == 'gen' for o in variants)} generator), {len(bridges)} bridges; "
        f"the scipy oracle on the {len(refs)} others in {time.perf_counter() - t0:.2f} s (host)")
    for method in ("auto", "nr"):
        name = f"screen_n1 {method}"
        compactions = Compactions()
        got, launches, peak, wall = drive(
            name, lambda: contingency.screen_n1(case, gen_outages=True, method=method),
            compactions)
        want = contingency.screen_n1(case, gen_outages=True, method=method, device="cpu")
        its = screen_group_iterations(variants, range(c), got["iterations_per_grid"])
        if method == "auto":
            expect = add_launches({"K1": 1, "K2": 0}, *(fdpf_launches(it) for it in its))
        else:
            # compact_after=3: a group with a grid not converged after 3
            # lock-step iterations solves its stragglers again (one more
            # assembly); a group needing more than 3 iterations must have
            expect = {"K1": 1 + len(its) + compactions.solves, "K2": 0}
            check(compactions.solves >= sum(it > 3 for it in its),
                  f"{name}: fewer straggler solves than groups needing them")
        report(name, launches, expect, got, wall, peak, c)
        log(f"[screen] {name}: {len(its)} bus-type groups, lock-step iterations "
            f"{sorted(collections.Counter(its).items())} (count: groups); straggler sub-batch "
            f"solves {compactions.solves}")
        for key in ("converged", "worst", "v_violations", "flow_violations"):
            check(np.array_equal(got[key], want[key]), f"{name}: {key} differs from the CPU run")
        conv = want["converged"]
        hold_screen_states(name, got, want, conv)
        hold_counts(name, got, want, conv, hold=method == "auto")
        nonconv = {got["outages"][i][1] for i in np.flatnonzero(~got["converged"])
                   if got["outages"][i][0] == "branch"}
        gen_fail = [i for i in np.flatnonzero(~got["converged"]) if got["outages"][i][0] == "gen"]
        log(f"[screen] {name}: non-converged branch outages {sorted(nonconv)} = the {len(bridges)} "
            f"bridges: {nonconv == bridges}; generator outages non-converged: {len(gen_fail)}; "
            f"worst {len(got['worst'])}, voltage-violating {int((got['v_violations'] > 0).sum())}")
        check(nonconv == bridges and not gen_fail, f"{name}: non-converged set is not the bridges")
        ok = np.array(sorted(refs))
        hold_oracle(name, {k: got[k][ok] for k in ("converged", "v", "theta_deg")},
                    np.stack([refs[i].vm for i in ok]), np.stack([refs[i].va_deg for i in ok]),
                    SOLVE_VS_ORACLE["nr" if method == "nr" else "fdpf"])

    # (b) screen_n1_ranked with the outage-aware 118-n1 checkpoint
    model, cfg = load_pretrained(f"{SCREEN_CASE}-n1", device="cuda")
    model_cpu, _ = load_pretrained(f"{SCREEN_CASE}-n1", device="cpu")
    name = "screen_n1_ranked"
    got, launches, peak, wall = drive(name, lambda: contingency.screen_n1_ranked(
        case, model, cfg, gen_outages=True, top_k=N1_TOP_K))
    want = contingency.screen_n1_ranked(case, model_cpu, cfg, gen_outages=True, top_k=N1_TOP_K,
                                        device="cpu")
    its = screen_group_iterations(variants, got["verified_idx"], got["iterations_per_grid"])
    report(name, launches, add_launches(forward_launches(cfg), *(fdpf_launches(it) for it in its)),
           got, wall, peak, c)
    # the intact predictions, the rms score's reference, as the screen makes
    # them: the last row of one batch of every variant and the intact case
    enc = contingency.n1_variants(case, gen_outages=True, encode_impedance=True) + [case]
    bases = [GNSPredictor(m, cfg, batch_size=c + 1, device=d).predict(enc)["v"][c]
             for m, d in ((model, "cuda"), (model_cpu, "cpu"))]
    hold_ranked(name, got, want, "rms", types == 1, bases)
    vi = got["verified_idx"]
    conv = got["converged"][vi]
    ok = vi[conv]
    log(f"[screen] {name}: {len(vi)} verified ({len(its)} bus-type groups), {int(conv.sum())} "
        f"converged, worst {len(got['worst'])} ({int(got['islanded'].sum())} islanded by structure)")
    check(bool(conv.all()), f"{name}: a verified contingency did not converge")
    hold_oracle(name, {k: got[k][ok] for k in ("converged", "v", "theta_deg")},
                np.stack([refs[i].vm for i in ok]), np.stack([refs[i].va_deg for i in ok]),
                SOLVE_VS_ORACLE["fdpf"])
    del model, model_cpu

    # (c) screen_n2 over every in-service pair, chunks of SCREEN_CHUNK
    pairs = n2.n2_pairs(case)
    t0 = time.perf_counter()
    islanded = n2.n2_islanding_pairs(case, pairs)
    log(f"[screen] {len(pairs)} N-2 pairs, {int(islanded.sum())} structurally islanded "
        f"(n2_islanding_pairs, {1e3 * (time.perf_counter() - t0):.1f} ms on the host)")
    chunks = -(-len(pairs) // SCREEN_CHUNK)
    name = "screen_n2"
    full, launches, peak, wall = drive(name, lambda: n2.screen_n2(case, pairs, chunk_size=SCREEN_CHUNK))
    report(name, launches, add_launches(*(fdpf_launches(it) for it in full["iterations_per_chunk"])),
           full, wall, peak, len(pairs), chunks)
    log(f"[screen] {name}: iterations per chunk {full['iterations_per_chunk']}, converged "
        f"{int(full['converged'].sum())}, worst {len(full['worst'])}, voltage-violating "
        f"{int((full['v_violations'] > 0).sum())}")
    check(len(full["iterations_per_chunk"]) == chunks, "N-2 chunk count")
    first = slice(0, SCREEN_CHUNK)
    want = n2.screen_n2(case, pairs[first], chunk_size=SCREEN_CHUNK, device="cpu")
    got1 = {k: full[k][first] for k in ("converged", "islanded", "v_violations", "worst", "v",
                                         "theta_deg", "iterations_per_grid", "mismatch")}
    got1["worst"] = full["worst"][full["worst"] < SCREEN_CHUNK]
    for key in ("converged", "islanded", "v_violations", "worst"):
        check(np.array_equal(got1[key], want[key]), f"{name} first chunk: {key} differs from the CPU run")
    check(full["iterations_per_chunk"][0] == want["iterations_per_chunk"][0], "N-2 lock-step count")
    hold_screen_states(f"{name} first chunk", got1, want, want["converged"])
    hold_counts(f"{name} first chunk", got1, want, want["converged"])
    odd = np.flatnonzero(full["islanded"] & full["converged"])
    balanced = [i for i in odd if island_injection(case, set(pairs[i].tolist())) == 0.0]
    log(f"[screen] {name}: {int(islanded.sum())} structurally islanded pairs, "
        f"{int((islanded & ~full['converged']).sum())} non-converged; converged islands {len(odd)}, "
        f"of them the balanced-island class (no active injection cut off) {len(balanced)}"
        + (f": pairs {[tuple(pairs[i]) for i in balanced]}" if balanced else ""))
    check(len(balanced) == len(odd), f"{name}: a structurally islanded pair converged outside "
          "the balanced-island class")
    rng = np.random.default_rng(0)
    pool = np.flatnonzero(full["converged"] & ~islanded)
    draw = np.sort(rng.choice(pool, N2_ORACLE_PAIRS, replace=False))
    refs2 = []
    for i in draw:
        va = {k: (np.asarray(case[k], np.float64).copy() if k in ("bus", "branch", "gen") else case[k])
              for k in case}
        va["branch"][pairs[i], 10] = 0.0
        refs2.append(newton_raphson_pf(va))
    check(all(r.success for r in refs2), "the oracle failed on a converged N-2 pair")
    hold_oracle(f"{name} ({N2_ORACLE_PAIRS} pairs, rng seed 0)",
                {k: full[k][draw] for k in ("converged", "v", "theta_deg")},
                np.stack([r.vm for r in refs2]), np.stack([r.va_deg for r in refs2]),
                SOLVE_VS_ORACLE["fdpf"])

    # (d) screen_n2_ranked with 118-deep-n1, score "depth"
    deep, deep_cfg = load_pretrained(f"{SCREEN_CASE}-deep-n1", device="cuda")
    deep_cpu, _ = load_pretrained(f"{SCREEN_CASE}-deep-n1", device="cpu")
    name = "screen_n2_ranked"
    got, launches, peak, wall = drive(name, lambda: n2.screen_n2_ranked(
        case, deep, deep_cfg, pairs, top_k=N2_TOP_K, chunk_size=SCREEN_CHUNK))
    vi = got["verified_idx"]
    fwd = forward_launches(deep_cfg)
    expect = add_launches(*([fwd] * (2 * chunks)), fdpf_launches(int(got["iterations_per_grid"][vi].max())))
    report(name, launches, expect, got, wall, peak, len(pairs), chunks)
    want = n2.screen_n2_ranked(case, deep_cpu, deep_cfg, pairs[first], top_k=N2_TOP_K,
                               chunk_size=SCREEN_CHUNK, device="cpu")
    first_got = {k: got[k][first] for k in ("islanded", "pred_v", "severity")}
    hold_ranked(f"{name} first chunk", first_got, want, "depth", types == 1, verified=False)
    conv = got["converged"][vi]
    violating = int(np.isin(vi, got["worst"]).sum())
    truth = set(full["worst"].tolist()) - set(np.flatnonzero(islanded).tolist())
    hits = len(truth & set(vi.tolist()))
    log(f"[screen] {name}: {len(vi)} verified pairs, {int(conv.sum())} converged; precision at "
        f"k={N2_TOP_K}: {violating}/{len(vi)} = {violating / len(vi):.3f} verified pairs the exact "
        f"verdict finds violating; recall of the full screen's {len(truth)} non-islanded worst "
        f"pairs {hits / max(len(truth), 1):.3f} (ceiling {min(1.0, N2_TOP_K / max(len(truth), 1)):.3f}). "
        f"gns_tpu's record (docs/N1_SCREEN.md, the same checkpoint and k, an accuracy "
        f"comparison): precision 1.0 (256 of 256 true violators), recall 0.143 of 1788 true-worst")
    del deep, deep_cpu

    # the device's busy / idle share of one N-2 chunk, in a process of its own
    t0 = time.perf_counter()
    run_child(["--screen-timing"], "screen timing", 300)
    log(f"[screen timing] one N-2 chunk's traces took {time.perf_counter() - t0:.1f} s in a "
        f"process of its own")
    held = hold_recorded(kern, recorder.inputs, "screen")
    log(f"[screen] all {held} distinct K1 / K2 launches of the phase bit-equal to their plain twins")
    log(f"[screen] phase took {time.perf_counter() - t_phase:.1f} s")
    return results


def screen_timing_child() -> int:
    """`chip_smoke.py --screen-timing`: the device's busy and idle share of
    one N-2 chunk (the first SCREEN_CHUNK pairs of case118), traced twice:
    screen_n2 end to end (the host's structural islanding included), and
    its solve core alone (the device-built variants, the fast-decoupled
    loop, the fetch)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gns_torch.eval import n2, nr_batched
    from gns_torch.utils.cases import load_case

    card = phase_device()
    case = load_case(SCREEN_CASE)
    pairs = n2.n2_pairs(case)[:SCREEN_CHUNK]
    out = n2.screen_n2(case, pairs)  # warm: index sets, libraries
    bus, branch, gen, base = nr_batched.stack_cases([case])
    ns = nr_batched.build_nr_small_stacked(bus, branch, gen, base)
    f = branch[0, :, 0].astype(np.int64) - 1
    t = branch[0, :, 1].astype(np.int64) - 1
    topo = nr_batched._topology(f, t, bus.shape[1], ns.pvpq, ns.pq, torch.device("cuda"))
    args = (*nr_batched._on("cuda", bus[0], branch[0], base[0], ns.p_sched[0], ns.q_sched[0],
                            ns.vm0[0], ns.va0[0]),
            torch.as_tensor(pairs.astype(np.int64), device="cuda"))

    def core():
        return n2._n2_core(topo, *args, "fdpf", 3e-5, 60)[0].cpu()

    it = out["iterations_per_chunk"][0]
    expect = {"segment_sum_": 3 + 2 * it, "gns_gather_": 1 + 2 * it}
    for what, run in (("screen_n2, one chunk", lambda: n2.screen_n2(case, pairs)),
                      ("its solve core", core)):
        untraced, traced, busy, spans, _ = trace_busy(run, reps=2, what=what, expect=expect)
        log(f"[screen timing] {what} ({len(pairs)} case{SCREEN_CASE} pairs, {it} iterations): "
            f"device windows {', '.join(f'{w:.3f}' for w in traced)} ms traced, "
            f"{', '.join(f'{w:.3f}' for w in untraced)} ms untraced; busy {busy / 2:.3f} ms per run "
            f"in {len(spans) / 2:.1f} device activities; idle {100 * (1 - busy / sum(traced)):.1f}% "
            f"of the traced windows, {100 * (1 - busy / sum(untraced)):.1f}% of the untraced "
            f"(card: {card})")
    return 0


# Phase 14, the parallel layer: each world's ranks are processes of this
# script (`chip_smoke.py --parallel WORLD RANK STORE`) that all sit on the
# one card, cuda:0, joined by a process group of the backend named here.
# The card cannot hold two NCCL ranks, so NCCL runs a world of one.
PAR_WORLDS = {"pair": ("gloo", 2), "square": ("gloo", 4), "nccl": ("nccl", 1)}
PAR_TIMEOUT = 420  # seconds for every world to end
PAR_MICRO = 64  # the pipeline's microbatch: bench.py's 256 grids in 4
# Sharded against single-process, on the card. Solves: hold_solve's
# (SOLVE_CARD_VS_CPU, gates decided at their edge). The predictor and the
# pipeline's forward: tests/test_torch_solver_dp.py's and test_torch_tp_pp.py's
# bounds (v rtol 2e-5 / atol 1e-6; theta atol 1e-5 for the decoded gauge);
# the pipeline's and TP's gradients rtol 1e-3 / atol 2e-5 (test_torch_tp_pp.py);
# the sharded and edge-partitioned gradients par_hold_leaves's bound
# (tests/torch_parallel_ranks.py hold_leaves); losses rtol 2e-5.
PAR_FWD = dict(rtol=2e-5, atol=1e-6)
PAR_GRAD = dict(rtol=1e-3, atol=2e-5)


class Recorder:
    """An optimizer (train/trainer.py GradientTransformation) that keeps
    the gradients it is handed and moves no parameter, so a step's
    gradients can be held leaf by leaf."""

    def __init__(self):
        self.grads = None

    def transformation(self):
        from gns_torch.train.trainer import GradientTransformation

        def init(params):
            return {"count": torch.zeros((), dtype=torch.int32, device="cuda")}

        def update(grads, state, params=None):
            self.grads = [g.detach().cpu().numpy() for g in grads]
            return [torch.zeros_like(g) for g in grads], {"count": state["count"] + 1}

        return GradientTransformation(init, update)


def par_train_batch():
    """bench.py's 256 case300 grids, their 411 lines padded to 412 so that
    gp = 2 and 4 divide them (masks on), and the batch's topology."""
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    cases = list(generate_cases(CASE, S_TRAIN - 1, seed=0))
    g = np.asarray(cases[0]["gen"]).shape[0]
    batch = batch_from_cases(cases, pad_sizes=(CASE + 1, 412, g))
    return batch, extract_shared_topology(batch)


def par_configs() -> dict:
    """Config A (parity) for the sharded steps and TP, A in paper physics
    for the edge partition, and 300-deep's for the pipeline."""
    from gns_torch.models.pretrained import pretrained_config

    a = train_configs()["A"]
    return {"A": a, "A paper": a.replace(reference_parity=False),
            "deep": pretrained_config("300-deep")}


def par_step(step_fn, model, cfg):
    """One train step of `step_fn` over bench.py's padded batch with a
    Recorder: the gradients and the metrics, on the host."""
    from gns_torch.train.trainer import TrainState

    batch, _ = par_train_batch()
    rec = Recorder()
    opt = rec.transformation()
    state = TrainState(model, opt.init(None), torch.zeros((), dtype=torch.int32, device="cuda"))
    _, metrics = step_fn(opt)(state, batch)
    return {"grads": rec.grads, "loss": float(metrics["loss"]), "last_loss": float(metrics["last_loss"])}


def par_paths(world: str) -> dict:
    """The paths one world drives, by name, each a function of no
    argument; every rank runs them in this order (meshes are made by all
    ranks together)."""
    from gns_torch.eval import contingency
    from gns_torch.models.gns import GNS
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.parallel import pipeline, sharding, tensor_parallel
    from gns_torch.parallel.edge_partition import make_edge_partitioned_train_step
    from gns_torch.parallel.mesh import make_mesh
    from gns_torch.parallel.solver_dp import solver_mesh
    from gns_torch.serve import GNSPredictor
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.cases import load_case

    cfgs = par_configs()
    _, topo = par_train_batch()

    def sharded(cfg, mesh, **kw):
        return lambda: par_step(lambda opt: sharding.make_sharded_train_step(
            cfg, mesh, optimizer=opt, topo=topo, **kw), GNS(cfg, seed=0), cfg)

    paths = {}
    if world == "nccl":
        model, cfg = load_pretrained(CASE, device="cuda")
        cases = cases_from_npz(par_solve_cases())
        paths["solve/flat NR"] = solve_arms(model, cfg, cases, solver_mesh())["flat NR"]
        paths["train/dp1 parity"] = sharded(cfgs["A"], make_mesh(dp=1, gp=1), gp=None)
        return paths
    if world == "square":
        paths["train/dp2xgp2 parity"] = sharded(cfgs["A"], make_mesh(dp=2, gp=2))
        return paths
    model, cfg = load_pretrained(CASE, device="cuda")
    mesh = solver_mesh()
    cases = cases_from_npz(par_solve_cases())
    for arm, run in solve_arms(model, cfg, cases, mesh).items():
        paths[f"solve/{arm}"] = run
    serve_cases = list(generate_cases(CASE, S_SERVE - 1, seed=0))
    paths["serve/GNSPredictor"] = lambda: GNSPredictor(
        model, cfg, batch_size=S_SERVE, mesh=mesh).predict(serve_cases)
    paths["screen/screen_n1 auto"] = lambda: contingency.screen_n1(
        load_case(SCREEN_CASE), gen_outages=True, mesh=mesh)
    paths["train/dp2 parity"] = sharded(cfgs["A"], make_mesh(dp=2, gp=1))
    paths["train/gp2 parity"] = sharded(cfgs["A"], make_mesh(dp=1, gp=2))
    gp2 = make_mesh(dp=1, gp=2)
    paths["train/gp2 edge"] = lambda: par_step(lambda opt: make_edge_partitioned_train_step(
        cfgs["A paper"], gp2, optimizer=opt, topo=topo), GNS(cfgs["A paper"], seed=0),
        cfgs["A paper"])
    tp = make_mesh(dp=1, gp=2, axis_names=("dp", "tp"))
    paths["train/tp2 parity"] = lambda: dict(par_step(
        lambda opt: tensor_parallel.make_tp_train_step(cfgs["A"], tp, optimizer=opt, topo=topo),
        tensor_parallel.shard_params_tp(GNS(cfgs["A"], seed=0, device="cpu"), tp), cfgs["A"]),
        tp_index=tp.get_local_rank("tp"))
    pp = make_mesh(dp=2, gp=1, axis_names=("pp", "unused"))
    deep, deep_cfg = load_pretrained("300-deep", device="cuda")
    batch, _ = par_train_batch()
    paths["forward/pp2 300-deep"] = lambda: pipeline.make_pipelined_forward(
        deep_cfg, pp, microbatch=PAR_MICRO)(deep, batch)._asdict()
    paths["train/pp2 300-deep"] = lambda: dict(par_step(
        lambda opt: pipeline.make_pipelined_train_step(deep_cfg, pp, optimizer=opt,
                                                       microbatch=PAR_MICRO),
        deep, deep_cfg), stage=pp.get_local_rank("pp"),
        indices=pipeline.stage_param_indices(deep, deep_cfg, pp.get_local_rank("pp"), 2))
    return paths


def par_solve_cases() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "solve_cases.npz")


def par_out(world: str, rank: int) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parallel",
                        f"{world}.{rank}.pkl")


def par_host(x):
    """Results to host numpy (tensors, dicts, lists)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: par_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [par_host(v) for v in x]
    return x


def parallel_child(world: str, rank: int, store: str) -> int:
    """`chip_smoke.py --parallel WORLD RANK STORE`: one rank of a phase 14
    world on cuda:0. Drives par_paths(world) with every K1 / K2 launch
    counted and recorded, holds each recorded launch bit-equal to its plain
    twin, and pickles each path's output, launches, collectives and wall
    for the parent (par_out)."""
    import pickle

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gns_torch.ops import collectives
    from gns_torch.ops import segment as seg
    from gns_torch.ops import segment_kernels as kern

    backend, size = PAR_WORLDS[world]
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, size), rank=rank,
                            world_size=size)
    torch.backends.cuda.matmul.allow_tf32 = False  # "f32 means f32"
    torch.backends.cudnn.allow_tf32 = False
    recorder = PathRecorder(kern, seg)
    res = {}
    for path, run in par_paths(world).items():
        reset_counts()
        collectives.reset_counts()
        with NoPlainTwins(kern), recorder:
            out = run()
            torch.cuda.synchronize()
        res[path] = dict(out=par_host(out), launches=counts(),
                         collectives=dict(collectives.COUNTS))
        res[path]["wall"] = par_wall(run)  # after the counts: it runs the path again
    res["held"] = hold_recorded(kern, recorder.inputs, f"parallel {world} rank {rank}", quiet=True)
    os.makedirs(os.path.dirname(par_out(world, rank)), exist_ok=True)
    with open(par_out(world, rank), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    log(f"[parallel] {world} rank {rank}: {len(res) - 1} paths, {res['held']} distinct K1 / K2 "
        f"launches bit-equal to their plain twins")
    return 0


def par_collectives(path: str, out: dict, cfgs: dict, stage: int, screen: dict) -> dict:
    """The collectives one rank issues on `path`, as the code gives them.
    Solves: each exit test of a sharded loop is one all-reduce and each
    fetch of a packed chunk one all-gather, so the two add up to the
    solve's host syncs; the all-gathers are the chunks (a flat fallback
    adds one); broadcasts share compact_after's resolution (solve_batched,
    hybrid_solve, solve_ac; a fallback's solve_batched adds one). The
    predictor: one all-gather per batch. Train steps (tests/
    test_torch_parallel.py _collectives): under gp = 2 per K step four
    all-reduces (message aggregate, Joule sum, two mismatch sums) and
    their four backward sums, in parity mode one all-gather of the angle
    differences per step (its gradient summed in the backward) and one of
    the Q2 geometry; one all-reduce of the gradients. TP: per K step two
    forward all-reduces (phi, L) and two backward ones but for step 0's
    phi input, plus the gradients' over dp. The pipeline, stage 0: a carry
    out per microbatch (and its gradient back when training), one
    broadcast from the last stage. screen_n1: its one-grid base solve is
    unsharded (screen["base_syncs"] host syncs, no collective); each
    bus-type group is one solve_ac (a broadcast) of one chunk (an
    all-gather), with no rescue solve when every non-bridge outage
    converges, as phase 13 finds on case118."""
    if path.startswith("screen/"):
        groups = screen["groups"]
        return {"all_reduce": out["host_syncs"] - screen["base_syncs"] - groups,
                "all_gather": groups, "broadcast": groups}
    if path.startswith("solve/"):
        arm = path[len("solve/"):]
        if arm == "DC":
            return {"all_gather": 1}
        fallback = 1 if out.get("fallback_grids", 0) else 0
        gathers = len(out["iterations_per_chunk"]) + fallback
        want = {"all_reduce": out["host_syncs"] - gathers, "all_gather": gathers}
        agree = {"flat NR": 1, "FDPF": 0}.get(arm, 1) + fallback
        if agree:
            want["broadcast"] = agree
        return want
    if path.startswith("serve/"):
        return {"all_gather": 1}
    k, n_micro = None, S_TRAIN // PAR_MICRO
    if "pp2" in path:
        if path.startswith("forward/"):
            return {"send": n_micro, "broadcast": 1} if stage == 0 else {
                "recv": n_micro, "broadcast": 1}
        return {"send": n_micro, "recv": n_micro, "broadcast": 1}
    cfg = cfgs["A paper"] if "edge" in path else cfgs["A"]
    k = cfg.K
    if "tp2" in path:
        return {"all_reduce": 4 * k}
    if "gp2" in path:
        ar = 8 * k + 1 + int(cfg.resolved_fold_output)
        if cfg.reference_parity:
            return {"all_reduce": ar + k, "all_gather": k + 1}
        return {"all_reduce": ar}
    return {"all_reduce": 1}


def pp_stage_launches(cfg, n_stages: int, stage: int, n_micro: int, train: bool,
                      remat: bool = True) -> dict:
    """K1 / K2 launches of one pipeline stage (parallel/pipeline.py), from
    the single-process per-step counts (forward_launches, train_launches).
    Each microbatch runs gns_machinery on every stage: its once launches
    (generator init; Q2 geometry or in-degree) and the stage's K/S steps.
    Training adds, per microbatch, the steps' recompute under remat and
    their backward, every step's adjoints but m[dst]'s at stage 0's first
    step (m starts at 0 there; a later stage's m arrives from the carry,
    which needs its gradient)."""
    k, k_stage = cfg.K, cfg.K // n_stages
    fwd, bwd = train_launches(cfg)
    fwd_next, bwd_next = train_launches(cfg.replace(K=k + 1))
    want = {}
    for x in ("K1", "K2"):
        step = fwd_next[x] - fwd[x]  # a step's forward launches
        once = fwd[x] - k * step
        n = once + k_stage * step
        if train:
            back = bwd_next[x] - bwd[x]  # a step's adjoints
            skipped = k * back - bwd[x]  # m[dst]'s at the first step
            n += k_stage * step * int(remat) + k_stage * back - (skipped if stage == 0 else 0)
        want[x] = n_micro * n
    return want


def par_hold_leaves(tag: str, got, want) -> float:
    """Gradients leaf by leaf: each within 5e-5 of its own largest entry
    plus 1e-5 of the largest entry of all leaves (the floor for leaves
    whose exact gradient is 0, tests/torch_parallel_ranks.py hold_leaves).
    Returns the worst share of the bound used."""
    check(len(got) == len(want), f"{tag}: {len(got)} gradients for {len(want)} leaves")
    floor = 1e-5 * max(float(np.abs(b).max()) for b in want)
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        bound = 5e-5 * float(np.abs(b).max()) + floor
        err = float(np.abs(a - b).max())
        worst = max(worst, err / bound)
        check(err <= bound, f"{tag}: leaf {i} off by {err:.3e} > {bound:.3e}")
    return worst


def par_single() -> dict:
    """The single-process run of each path on the card: the references,
    with their K1 / K2 launches."""
    from gns_torch.eval import contingency, nr_batched
    from gns_torch.models.gns import GNS, batch_tensors, gns_forward_batch
    from gns_torch.models.pretrained import load_pretrained
    from gns_torch.physics.common import build_graph
    from gns_torch.serve import GNSPredictor
    from gns_torch.train.trainer import loss_and_grads
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.cases import load_case

    cfgs = par_configs()
    model, cfg = load_pretrained(CASE, device="cuda")
    cases = cases_from_npz(par_solve_cases())
    batch, topo = par_train_batch()
    bt = batch_tensors(batch, "cuda")
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, "cuda")
    runs = {f"solve/{arm}": run for arm, run in solve_arms(model, cfg, cases).items()}
    serve_cases = list(generate_cases(CASE, S_SERVE - 1, seed=0))
    runs["serve/GNSPredictor"] = lambda: GNSPredictor(model, cfg, batch_size=S_SERVE).predict(
        serve_cases)
    case118 = load_case(SCREEN_CASE)
    runs["screen/screen_n1 auto"] = lambda: contingency.screen_n1(case118, gen_outages=True)
    runs["screen base solve"] = lambda: nr_batched.solve_batched([case118])
    deep, deep_cfg = load_pretrained("300-deep", device="cuda")

    def grads(m, c):
        loss, last, g = loss_and_grads(m, c, bt, graph)
        return {"grads": [x.cpu().numpy() for x in g], "loss": float(loss), "last_loss": float(last)}

    runs["train A"] = lambda: grads(GNS(cfgs["A"], seed=0), cfgs["A"])
    runs["train A paper"] = lambda: grads(GNS(cfgs["A paper"], seed=0), cfgs["A paper"])
    runs["train deep"] = lambda: grads(deep, deep_cfg)

    def deep_forward():
        with torch.no_grad():
            return gns_forward_batch(deep, deep_cfg, batch, topo=topo)._asdict()

    runs["forward deep"] = deep_forward
    out = {}
    for name, run in runs.items():
        reset_counts()
        got = run()
        torch.cuda.synchronize()
        out[name] = dict(out=par_host(got), launches=counts())
        out[name]["wall"] = par_wall(run)  # after the counts: it runs the path again
    return out


def par_wall(run) -> float:
    """Host seconds of a second run of `run` (the first built the index
    sets, loaded the libraries and started autograd's and the
    checkpoint's machinery: a pipeline train step's first run takes
    several times its second)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_parallel(card) -> dict:
    """The parallel layer on the card (module docstring, phase 14).
    Returns each rank's K1 / K2 launches per path for the kernels line."""
    import pickle
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "parallel")
    shutil.rmtree(out_dir, ignore_errors=True)  # no result of an earlier run is read
    os.makedirs(out_dir)
    store_dir = tempfile.mkdtemp(dir=out_dir)
    procs = []
    for world, (backend, size) in PAR_WORLDS.items():
        store = os.path.join(store_dir, f"{world}.store")
        for rank in range(size):
            logf = open(os.path.join(out_dir, f"{world}.{rank}.log"), "w")
            procs.append((world, rank, logf, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel", world, str(rank), store],
                cwd=here, stdout=logf, stderr=subprocess.STDOUT)))
    log(f"[parallel] started {len(procs)} rank processes on cuda:0: "
        + ", ".join(f"{w} ({b}, {n} rank{'s' if n > 1 else ''})" for w, (b, n) in PAR_WORLDS.items()))
    try:
        single = par_single()
        deadline = time.perf_counter() + PAR_TIMEOUT
        for world, rank, logf, proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"[parallel] {world} rank {rank} did not end within {PAR_TIMEOUT} s")
    finally:
        for world, rank, logf, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()
    failed = []
    for world, rank, _, proc in procs:
        with open(os.path.join(out_dir, f"{world}.{rank}.log")) as f:
            lines = f.read().splitlines()
        if proc.returncode != 0:
            failed.append(f"{world} rank {rank}")
            for line in lines[-40:]:
                log(f"[parallel {world} {rank}] {line}")
        else:
            for line in lines:
                if line.startswith("[parallel]"):
                    log(line)
    check(not failed, f"[parallel] ranks failed: {failed}")
    log(f"[parallel] every world ended in {time.perf_counter() - t_phase:.1f} s")
    ranks = {}
    for world, rank, _, _ in procs:
        with open(par_out(world, rank), "rb") as f:
            ranks[(world, rank)] = pickle.load(f)
    cfgs = par_configs()
    from gns_torch.eval import contingency
    from gns_torch.utils.cases import load_case

    case118 = load_case(SCREEN_CASE)
    variants = contingency.n1_variants(case118, gen_outages=True)
    screen = {"base_syncs": single["screen base solve"]["out"]["host_syncs"],
              "groups": len(contingency._by_signature(variants, range(len(variants))))}
    # the pipeline's expected launches come from the per-step counts,
    # held here to the single-process 300-deep runs of this phase
    deep_fwd, deep_bwd = train_launches(cfgs["deep"])
    for name, want in (("forward deep", deep_fwd),
                       ("train deep", {x: deep_fwd[x] + deep_bwd[x] for x in ("K1", "K2")})):
        got = {x: single[name]["launches"][x] for x in ("K1", "K2")}
        log(f"[parallel] single-process {name}: K1/K2 launches {got}, expected {want}")
        check(got == want, f"single-process {name}: launches {got} != {want}")
    # every world runs at once, beside this script's single-process runs
    on_card = sum(n for _, n in PAR_WORLDS.values()) + 1
    par_launches = {}
    for (world, rank), res in ranks.items():
        size = PAR_WORLDS[world][1]
        for path, r in res.items():
            if path == "held":
                continue
            stage = r["out"].get("stage", rank) if isinstance(r["out"], dict) else rank
            want_coll = par_collectives(path, r["out"], cfgs, stage, screen)
            got_coll = r["collectives"]
            launches = {k: r["launches"][k] for k in ("K1", "K2")}
            par_launches[f"{world}/rank{rank}/{path}"] = launches
            ref_key = par_reference(path)
            ref = single[ref_key]
            if "pp2" in path:
                want_pp = pp_stage_launches(cfgs["deep"], 2, stage, S_TRAIN // PAR_MICRO,
                                            train=path.startswith("train/"))
                ok = launches == want_pp
                want_l = f"{want_pp} (stage {stage}'s steps, pp_stage_launches)"
            else:
                ok = launches == {k: ref["launches"][k] for k in ("K1", "K2")}
                want_l = f"{ {k: ref['launches'][k] for k in ('K1', 'K2')} } (the single-process run's)"
            log(f"[parallel] {world} rank {rank} {path}: K1/K2 launches {launches}, expected "
                f"{want_l}; collectives {got_coll}, predicted {want_coll}; host wall "
                f"{1e3 * r['wall']:.1f} ms, second run ({on_card} processes sharing one {card}: this "
                f"world's {size}, the other worlds' {on_card - 1 - size}, this script; the "
                f"single-process run {1e3 * ref['wall']:.1f} ms shared it too; not a scaling "
                f"figure)")
            check(ok, f"{world} rank {rank} {path}: launches {launches}")
            check(got_coll == want_coll, f"{world} rank {rank} {path}: collectives {got_coll} "
                  f"!= {want_coll}")
            par_hold(world, rank, path, r["out"], ref["out"], single)
    log(f"[parallel] phase took {time.perf_counter() - t_phase:.1f} s")
    return par_launches


def par_reference(path: str) -> str:
    """The single-process run (par_single) a path is held against."""
    if path.startswith(("solve/", "serve/", "screen/")):
        return path
    if path.startswith("forward/"):
        return "forward deep"
    if "pp2" in path:
        return "train deep"
    return "train A paper" if "edge" in path else "train A"


def par_hold(world, rank, path, got, want, single) -> None:
    """One rank's result of `path` against the single-process run."""
    tag = f"{world} rank {rank} {path}"
    if path.startswith("solve/"):
        hold_solve(path[len("solve/"):], got, want, tag="parallel",
                   what=f"{world} rank {rank}, sharded vs single")
        return
    if path.startswith("serve/"):
        for key, tol in (("v", PAR_FWD), ("theta", dict(rtol=2e-5, atol=1e-5)),
                         ("last_loss", dict(rtol=2e-5, atol=0.0))):
            err = float(np.abs(got[key] - want[key]).max())
            ok = got[key].shape == want[key].shape and np.allclose(got[key], want[key], **tol)
            log(f"[parallel] {tag} {key} max_abs_err {err:.3e} ({tol}) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"{tag} {key}")
        return
    if path.startswith("screen/"):
        for key in ("converged", "v_violations", "flow_violations", "worst"):
            check(np.array_equal(got[key], want[key]), f"{tag}: {key} differs")
        conv = want["converged"]
        dv = float(np.abs(got["v"] - want["v"])[conv].max())
        dth = float(np.abs(got["theta_deg"] - want["theta_deg"])[conv].max())
        ok = dv <= SOLVE_CARD_VS_CPU[0] and dth <= SOLVE_CARD_VS_CPU[1]
        log(f"[parallel] {tag}: verdicts equal ({int(conv.sum())} of {len(conv)} converged, "
            f"{len(want['worst'])} worst); v {dv:.3e}, theta {dth:.3e} deg (SOLVE_CARD_VS_CPU) "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, tag)
        base = single["screen base solve"]["out"]["host_syncs"]
        log(f"[parallel] {tag}: host syncs {got['host_syncs']} of which {base} the unsharded base "
            f"solve's")
        return
    if path.startswith("forward/"):
        for key in ("v", "theta", "total_loss", "last_loss"):
            err = float(np.abs(got[key] - want[key]).max())
            ok = np.allclose(got[key], want[key], **PAR_FWD)
            log(f"[parallel] {tag} {key} max_abs_err {err:.3e} ({PAR_FWD}) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"{tag} {key}")
        return
    for key in ("loss", "last_loss"):
        ok = abs(got[key] - want[key]) <= 2e-5 * abs(want[key])
        check(ok, f"{tag}: {key} {got[key]} against {want[key]}")
    if "pp2" in path:
        worst = 0.0
        for i, g in zip(got["indices"], got["grads"]):
            w = want["grads"][i]
            check(np.allclose(g, w, **PAR_GRAD), f"{tag}: gradient leaf {i}")
            worst = max(worst, float(np.abs(g - w).max()))
        log(f"[parallel] {tag}: loss {got['loss']:.6g} (single {want['loss']:.6g}); stage "
            f"{got['stage']}'s {len(got['indices'])} gradient leaves within {PAR_GRAD}, worst "
            f"{worst:.3e}")
        return
    if "tp2" in path:
        from gns_torch.models.gns import GNS
        from gns_torch.parallel.tensor_parallel import tp_param_shardings

        cfg = par_configs()["A"]
        model = GNS(cfg, seed=0, device="cpu")
        dims = list(tp_param_shardings(model).values())
        half = cfg.hidden_dim // 2
        part = slice(got["tp_index"] * half, (got["tp_index"] + 1) * half)
        worst = 0.0
        for i, (g, w, d) in enumerate(zip(got["grads"], want["grads"], dims)):
            w = w if d is None else (w[part] if d == 0 else w[:, part])
            check(np.allclose(g, w, **PAR_GRAD), f"{tag}: gradient leaf {i}")
            worst = max(worst, float(np.abs(g - w).max()))
        log(f"[parallel] {tag}: loss {got['loss']:.6g} (single {want['loss']:.6g}); "
            f"{len(dims)} gradient leaves (hidden units {part.start}-{part.stop - 1}) within "
            f"{PAR_GRAD}, worst {worst:.3e}")
        return
    share = par_hold_leaves(tag, got["grads"], want["grads"])
    log(f"[parallel] {tag}: loss {got['loss']:.6g} (single {want['loss']:.6g}); "
        f"{len(got['grads'])} gradient leaves within the leaf bound, worst at {share:.3f} of it")


# Data phase (15): the dataset CLI at full width, as phase 10's grids:
# feasible case300 grids at scale 0.5 (case300 leaves the AC-solvable
# region at full augmentation), 1023 augmentations and the base case.
DATA_NUM = 1023
DATA_SCALE = 0.5
DATA_EPOCHS = 2
DATA_EVAL = 64  # held-out pickles evaluated: the last 64 of the data set
DATA_REPLAY = 10  # steps per replayed epoch when the refresh's "degree" is timed
PACK_REPS = 5
PREDICT_PACKING_MS = 14.14  # predict's packing of 1024 requests on the H100's host (PERF.md section 5)
# the shipped case300 checkpoint's v MSE in the eval phase (a) on the H100 (PERF.md),
# on generate_cases' 64 grids, not the data set's
PRETRAINED_V_MSE = 0.010343


def data_dir() -> str:
    """The data phase's directory, under the checkout's build/ (ignored by
    git), emptied first."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "data_phase")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def ms_spread(fn, reps: int = PACK_REPS) -> list:
    """Host ms of `reps` calls of fn, one reading each."""
    readings = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        readings.append((time.perf_counter() - t0) * 1e3)
    return readings


def ms_text(readings) -> str:
    return (f"{statistics.median(readings):.3f} ms (range {min(readings):.3f} to "
            f"{max(readings):.3f}, n={len(readings)})")


def refresh_step(kern, seg, cfg, method, batch, topo, device):
    """One update step's forward and backward (loss_and_grads) on `device`
    from init_train_state(0, cfg) with the refresh's `method`: the
    forward's outputs, the gradients, and on the card the K1 / K2 launches
    (forward and backward apart) and their recordings."""
    from gns_torch.models.gns import batch_tensors, gns_forward, step_params
    from gns_torch.physics.common import build_graph
    from gns_torch.train.trainer import init_train_state

    state = init_train_state(0, cfg, device=device)
    graph = build_graph(batch.buses, batch.lines, batch.generators, topo, device)
    bt = batch_tensors(batch, device)
    params = list(state.model.parameters())
    rec_f, rec_b = PathRecorder(kern, seg), PathRecorder(kern, seg)
    reset_counts()
    with NoPlainTwins(kern):
        with rec_f:
            out = gns_forward(step_params(state.model, cfg), cfg, bt, graph, dense=True,
                              method=method)
            loss = out.total_loss.mean()
            sync(device)
        fwd = counts()
        with rec_b:
            grads = torch.autograd.grad(loss, params)
            sync(device)
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    outs = {k: getattr(out, k).detach().float().cpu().numpy()
            for k in ("v", "theta", "total_loss", "last_loss")}
    names = [n for n, _ in state.model.named_parameters()]
    return outs, dict(zip(names, (g.cpu() for g in grads))), fwd, bwd, {**rec_f.inputs, **rec_b.inputs}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def hold_refresh(tag, label, cfg, got, want, exact: bool) -> float:
    """got against want, (outputs, gradients) each: bit for bit (exact), or
    outputs within the bounds of the config's dtype (float32: serving's rtol
    / atol 2e-4; bfloat16: BF16_CARD_VS_CPU and the total loss as
    last_loss) and every gradient leaf within TRAIN_GRAD. Returns the
    largest share of TRAIN_GRAD's bound a leaf used."""
    (outs, grads), (w_outs, w_grads) = got, want
    if exact:
        same = all(np.array_equal(outs[k], w_outs[k]) for k in outs) and all(
            torch.equal(grads[k], w_grads[k]) for k in grads)
        log(f"[data] (f) {tag} {label}: outputs and {len(grads)} gradient leaves "
            f"{'bit-equal' if same else 'DIFFER'}")
        check(same, f"{tag}: {label} not bit-equal")
        return 0.0
    if cfg.compute_dtype == "float32":
        bounds = {k: (2e-4, 2e-4, None) for k in outs}
    else:
        b16 = {name: (0.0, atol, p999) for name, atol, p999 in BF16_CARD_VS_CPU}
        bounds = {**b16, "total_loss": b16["last_loss"]}
    for key, (rtol, atol, p999) in bounds.items():
        agree("data", f"(f) {tag} {label}", outs[key], w_outs[key].astype(np.float64), rtol, atol,
              key, p999)
    rel, atol = TRAIN_GRAD["A" if cfg.compute_dtype == "float32" else "B"]
    worst = (0.0, "")
    for name, g in grads.items():
        w = w_grads[name]
        share = (g - w).abs().max().item() / (rel * w.abs().max().item() + atol)
        worst = max(worst, (share, name))
    log(f"[data] (f) {tag} {label}: gradients, {len(grads)} leaves, the nearest to its bound "
        f"({rel:g} x max |want| + {atol:g}) {worst[1]} at {worst[0]:.3f} of it")
    check(worst[0] <= 1.0, f"{tag}: {label} gradients outside the bound")
    return worst[0]


def replay_ms(kern, cfg, method, topo, bt, reps: int = DATA_REPLAY):
    """A make_epoch_step of `reps` copies of the batch with the refresh's
    `method`, captured at its first call. Returns the launches while
    capturing and a closure timing one more epoch in CUDA-event ms per
    step."""
    from gns_torch.train.trainer import init_train_state, make_epoch_step
    from gns_torch.utils.prepare import GridBatch

    state = init_train_state(0, cfg, device="cuda")
    epoch = make_epoch_step(cfg, method=method, topo=topo, dense=True)
    xs = GridBatch(*(a.unsqueeze(0).expand((reps,) + tuple(a.shape)) for a in bt))
    reset_counts()
    with NoPlainTwins(kern):
        epoch(state, xs)
        torch.cuda.synchronize()
    return counts(), lambda: steps_ms(lambda: epoch(state, xs), reps=1)[1] / reps


def phase_data(kern, seg, card) -> dict:
    """The dataset path on the card (module docstring, phase 15). Returns
    the K1 / K2 counts of its in-process runs for the kernels line."""
    from gns_torch.eval.harness import evaluate, load_eval_cases
    from gns_torch.train.checkpoint import checkpoint_name, load_checkpoint
    from gns_torch.train.trainer import CAPTURE_WARMUP, train
    from gns_torch.utils import native
    from gns_torch.utils.augment import generate_cases
    from gns_torch.utils.prepare import (_stack_to_batch, extract_shared_topology,
                                         load_all_grids, load_prepared, prepare_case)

    torch.backends.cuda.matmul.allow_tf32 = False  # as the CLIs run: PyTorch's default
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = data_dir()
    out = {}

    # (a) build the packer
    info = native.build_packer()
    version = subprocess.run([info["compiler"], "--version"], capture_output=True, text=True,
                     timeout=60).stdout.splitlines()[:1]
    log(f"[data] (a) packer gns_torch/csrc/gridpack.cpp: {info['compiler']} "
        f"({version[0] if version else '?'}), flags {' '.join(info['flags'])}, "
        f"{info['seconds']:.2f} s -> {os.path.relpath(info['path'], here)}")

    # (b) generate through the CLI, and in this process meanwhile
    cli = [sys.executable, "-m", "gns_torch.utils", "--case", str(CASE), "--num", str(DATA_NUM),
           "--seed", "0", "--scale", str(DATA_SCALE), "--feasible-only", "--data-dir", tmp]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cli, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        cases = list(generate_cases(CASE, DATA_NUM, seed=0, scale=DATA_SCALE, feasible_only=True))
        t_own = time.perf_counter() - t0
        text, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    t_cli = time.perf_counter() - t0
    for line in text.splitlines():
        log(f"[data] (b) cli: {line}")
    check(proc.returncode == 0, f"python -m gns_torch.utils failed (exit {proc.returncode})")
    log(f"[data] (b) {' '.join(cli[1:])}: {t_cli:.2f} s host wall ({DATA_NUM + 1} grids, pickles "
        f"and npz); this process's generate_cases of the same grids meanwhile {t_own:.2f} s")
    case_dir = os.path.join(tmp, f"case{CASE}")
    triples = [prepare_case(c) for c in cases]
    with np.load(os.path.join(case_dir, f"prepared_case{CASE}.npz")) as z:
        npz = {k: z[k] for k in z.files}
    same = (sorted(npz) == ["buses", "generators", "lines", "scale", "seed"]
            and npz["seed"].dtype == np.int64 and int(npz["seed"]) == 0
            and npz["scale"].dtype == np.float64 and float(npz["scale"]) == DATA_SCALE)
    for i, key in enumerate(("buses", "lines", "generators")):
        want = np.stack([t[i] for t in triples])
        same = same and npz[key].dtype == np.float32 and np.array_equal(npz[key], want)
    log(f"[data] (b) npz {tuple(npz['buses'].shape)} buses, {tuple(npz['lines'].shape)} lines, "
        f"{tuple(npz['generators'].shape)} generators, seed / scale: "
        f"{'bit-equal' if same else 'DIFFER'} to prepare_case over this process's generate_cases")
    check(same, "the CLI's npz differs from prepare_case over generate_cases")
    t0 = time.perf_counter()
    from_pickles = load_all_grids(CASE, DATA_NUM, data_dir=tmp)
    from_npz = load_prepared(CASE, DATA_NUM, data_dir=tmp)
    same = all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(from_pickles, from_npz))
    log(f"[data] (b) load_all_grids (the {DATA_NUM} pickles) against load_prepared (the npz): "
        f"{'equal' if same else 'DIFFER'}, {time.perf_counter() - t0:.2f} s")
    check(same, "the pickles and the npz load to different batches")
    del npz, from_pickles

    # (c) the packers on the 1024 case dicts
    want = _stack_to_batch(triples)
    packed = native.pack_batch(cases)
    diff = [name for name, a, b in zip(want._fields, want, packed)
            if not (a.dtype == b.dtype and np.array_equal(a, b))]
    log(f"[data] (c) pack_batch of {len(cases)} case dicts against _stack_to_batch(prepare_case "
        f"...): {'bit-equal in every field' if not diff else 'DIFFER in ' + ', '.join(diff)}")
    check(not diff, f"pack_batch differs from the numpy packer in {diff}")
    n_bus = want.buses.shape[1]
    csr = native.csr_by_dst(want.lines[0], n_bus)
    csr_np = native.csr_by_dst_numpy(want.lines[0], n_bus)
    same = all(np.array_equal(a, b) for a, b in zip(csr, csr_np))
    log(f"[data] (c) csr_by_dst on the case{CASE} topology ({want.lines.shape[1]} lines): "
        f"{'equal' if same else 'DIFFERS'} to its numpy path")
    check(same, "csr_by_dst differs from its numpy path")
    native_ms = ms_spread(lambda: native.pack_batch(cases))
    numpy_ms = ms_spread(lambda: _stack_to_batch([prepare_case(c) for c in cases]))
    csr_ms = ms_spread(lambda: native.csr_by_dst(want.lines[0], n_bus))
    csr_np_ms = ms_spread(lambda: native.csr_by_dst_numpy(want.lines[0], n_bus))
    log(f"[data] (c) host ms, {len(cases)} case300 dicts: pack_batch {ms_text(native_ms)}, "
        f"prepare_case + _stack_to_batch {ms_text(numpy_ms)} (predict's packing of 1024 requests "
        f"read {PREDICT_PACKING_MS} ms, PERF.md section 5; a reading only); csr_by_dst "
        f"{ms_text(csr_ms)}, its numpy path {ms_text(csr_np_ms)} (card: {card})")
    out["pack"] = dict(native_ms=statistics.median(native_ms), numpy_ms=statistics.median(numpy_ms))
    del want, packed, triples

    # (d) train from the data set: the CLI, then the same run in this process
    cfg = train_configs()["A"].replace(epochs=DATA_EPOCHS, nr_samples=DATA_NUM + 1)
    name = checkpoint_name(cfg)
    t0 = time.perf_counter()
    run_child(["-m", "gns_torch.train", "--case", str(CASE), "--data-dir", tmp,
               "--nr-samples", str(DATA_NUM + 1), "--batch-size", str(S_TRAIN),
               "--epochs", str(DATA_EPOCHS), "--K", str(cfg.K), "--latent", str(cfg.latent_dim),
               "--hidden", str(cfg.hidden_dim), "--out-dir", os.path.join(tmp, "models"),
               "--runs-dir", os.path.join(tmp, "runs")], "train CLI", timeout=600, module=True)
    log(f"[data] (d) python -m gns_torch.train: {time.perf_counter() - t0:.2f} s host wall")
    with open(os.path.join(tmp, "runs", f"{name}.csv")) as f:
        cli_losses = [float(row["final_loss"]) for row in csv.DictReader(f)]
    data = load_prepared(CASE, DATA_NUM + 1, data_dir=tmp)
    check(extract_shared_topology(data) is not None and data.is_dense(),
          "the data set must be dense grids of one topology (the CUDA-graph epoch)")
    reset_counts()
    with NoPlainTwins(kern):
        best, history = train(cfg, data, device="cuda")
        torch.cuda.synchronize()
    got = counts()
    fwd, bwd = train_launches(cfg)
    per_step = {k: fwd[k] + bwd[k] for k in fwd}
    want_counts = {**{k: (CAPTURE_WARMUP + 1) * v for k, v in per_step.items()}, "K3": 0, "K4": 0}
    steps = DATA_EPOCHS * (data.batch_size // S_TRAIN)
    losses = [row["final_loss"] for row in history]
    log(f"[data] (d) train() in this process on load_prepared's {data.batch_size} grids: "
        f"{len(history)} epochs, {steps} steps; launches {got} (expected {want_counts}: "
        f"{CAPTURE_WARMUP} warm-up steps and the capture of train_launches' {per_step} a step; "
        f"the {steps} steps replay the graph and call no wrapper)")
    check(got == want_counts, f"the data set's training launches {got} != {want_counts}")
    log(f"[data] (d) epoch losses: CLI {cli_losses}, this process {losses}")
    check(cli_losses == losses and all(np.isfinite(losses)),
          "the CLI's logged losses differ from the in-process run's")
    cli_state = load_checkpoint(os.path.join(tmp, "models", f"{name}.pt"), cfg, device="cpu")
    same = all(torch.equal(a, b) for a, b in zip(cli_state.model.parameters(),
                                                 best.model.parameters()))
    log(f"[data] (d) the CLI's checkpoint against this process's best state: "
        f"{'bit-equal' if same else 'DIFFERS'}")
    check(same, "the CLI's checkpoint differs from the in-process training's")
    out["train"] = dict(launches=got, per_step=per_step, steps=steps, losses=losses)
    del data, best, cli_state

    # (e) evaluate from the data set: the CLI with the checkpoint and with
    # the shipped one, then the same in this process. --plot "" turns the
    # CLI's per-bus plot off: the card's machine has no matplotlib.
    total = DATA_NUM + 1
    held = cases[total - DATA_EVAL:]
    eval_cli = {}
    for tag, ckpt in (("trained", os.path.join(tmp, "models", f"{name}.pt")),
                      ("pretrained", "pretrained")):
        t0 = time.perf_counter()
        jpath = os.path.join(tmp, f"eval_{tag}.json")
        run_child(["-m", "gns_torch.eval", "--case", str(CASE), "--checkpoint", ckpt,
                   "--data-dir", tmp, "--total-grids", str(total), "--samples", str(DATA_EVAL),
                   "--plot", "", "--json-out", jpath],
                  f"eval CLI ({tag})", timeout=600, module=True)
        with open(jpath) as f:
            eval_cli[tag] = json.load(f)
        m = eval_cli[tag]
        log(f"[data] (e) python -m gns_torch.eval --checkpoint {tag}: {time.perf_counter() - t0:.2f} s "
            f"host wall; v MSE {m['v_mse']:.6g}, theta MSE {m['theta_mse']:.6g}"
            + (f" (the eval phase's record {PRETRAINED_V_MSE} is on other grids: not comparable)"
               if tag == "pretrained" else ""))
        check("fallback_from_base_case" not in m, f"the eval CLI ({tag}) fell back to generated grids")
        check(np.isfinite(m["v_mse"]) and np.isfinite(m["theta_mse"]), f"eval CLI ({tag}): non-finite MSE")
    read = load_eval_cases(CASE, DATA_EVAL, data_dir=tmp, total_grids=total)
    same = len(read) == len(held) and all(
        all(np.array_equal(np.asarray(r[k]), np.asarray(c[k])) for k in c) for r, c in zip(read, held))
    log(f"[data] (e) the {len(read)} held-out pickles the eval CLI reads (indices "
        f"{total - DATA_EVAL}..{total - 1}): {'equal' if same else 'DIFFER'} to the generated grids")
    check(same, "the eval pickles differ from the generated grids")
    model = load_checkpoint(os.path.join(tmp, "models", f"{name}.pt"), cfg, device="cuda").model
    reset_counts()
    with NoPlainTwins(kern):
        metrics = evaluate(model, cfg, read, plot_path=None, verbose=False)
        torch.cuda.synchronize()
    got = counts()
    per = forward_launches(cfg)
    forwards = len(read) + 1  # run_gns: one warm-up forward, then each grid
    want_counts = {"K1": forwards * per["K1"], "K2": forwards * per["K2"], "K3": 0, "K4": 0}
    keys = [k for k in metrics if not k.startswith("time") and k != "plot"]
    diff = [k for k in keys if metrics[k] != eval_cli["trained"][k]]
    log(f"[data] (e) evaluate() in this process: launches {got} (expected {want_counts}); "
        f"{len(keys)} accuracy metrics {'equal' if not diff else 'DIFFER in ' + ', '.join(diff)} "
        f"to the CLI's (v MSE {metrics['v_mse']:.6g}, theta MSE {metrics['theta_mse']:.6g}); "
        f"NR converged on {100 * metrics['nr_converged_frac']:.0f}%")
    check(got == want_counts, f"the data set's eval launches {got} != {want_counts}")
    check(not diff, f"the eval CLI's metrics differ from evaluate() in this process: {diff}")
    out["eval"] = dict(launches=got, forwards=forwards, v_mse=metrics["v_mse"],
                       theta_mse=metrics["theta_mse"],
                       pretrained_v_mse=eval_cli["pretrained"]["v_mse"])
    del model, cases, held, read

    # (f) the refresh's "degree" at bench.py's problem (config A)
    batch, topo, bt, _ = train_problem()
    cfg, tag = train_configs()["A"], "degree"
    auto_outs, auto_grads, *_ = refresh_step(kern, seg, cfg, "auto", batch, topo, "cuda")
    outs, grads, fwd, bwd, rec = refresh_step(kern, seg, cfg, "degree", batch, topo, "cuda")
    want_f, want_b = train_launches(cfg)
    want_f.update(K3=0, K4=0)
    want_b.update(K3=0, K4=0)
    log(f"[data] (f) {tag} (config A): one step's launches forward {fwd} (predicted {want_f}), "
        f"backward {bwd} (predicted {want_b})")
    check(fwd == want_f and bwd == want_b, f"{tag}: launches {fwd} / {bwd}")
    held_n = hold_recorded(kern, rec, f"data {tag}", quiet=True)
    log(f"[data] (f) {tag}: all {held_n} distinct K1 / K2 launches bit-equal to their twins")
    del rec
    hold_refresh(tag, 'card vs the card\'s "auto" run', cfg, (outs, grads),
                 (auto_outs, auto_grads), exact=True)
    cpu_outs, cpu_grads, *_ = refresh_step(kern, seg, cfg, "degree", batch, topo, "cpu")
    share = hold_refresh(tag, "card vs the port's CPU run", cfg, (outs, grads),
                         (cpu_outs, cpu_grads), exact=False)
    # one replayed step with "degree" and with "auto", a b b a
    auto_cap, auto = replay_ms(kern, cfg, "auto", topo, bt)
    deg_cap, deg = replay_ms(kern, cfg, "degree", topo, bt)
    want_cap = {k: (CAPTURE_WARMUP + 1) * (want_f[k] + want_b[k]) for k in want_f}
    check(deg_cap == want_cap, f"{tag}: launches while capturing {deg_cap} != {want_cap}")
    r_auto, r_deg = abba(auto, deg)
    log(f"[data] (f) {tag}: replayed step (CUDA events, {DATA_REPLAY} steps an epoch) "
        f"{ms_text(r_deg)}, \"auto\" {ms_text(r_auto)}; slower: {behind(r_deg, r_auto)} "
        f"(launches while capturing {deg_cap}, \"auto\" {auto_cap}; card: {card})")
    out["refresh"] = {tag: dict(forward=fwd, backward=bwd, grad_share=share,
                                replay_ms=statistics.median(r_deg),
                                replay_ms_auto=statistics.median(r_auto))}
    log(f"[data] phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def run_child(args, what: str, timeout: int, module: bool = False):
    """Run this script (or, with module=True, `python -m ...`) in a process
    of its own from the checkout's root, log its output, fail on a non-zero
    exit or a timeout; returns its stdout lines."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, *args] if module else [sys.executable, os.path.abspath(__file__), *args]
    try:
        run = subprocess.run(cmd, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        out = exc.output or b""
        log(out.decode(errors="replace") if isinstance(out, bytes) else out)
        fail(f"the {what} process did not end within {timeout} s")
    lines = run.stdout.splitlines()
    for line in lines:
        log(line)
    check(run.returncode == 0 and bool(lines), f"the {what} process failed (exit {run.returncode})")
    return lines


def phase_train_timing(kern, backward_launches: dict, card):
    """Each distinct K1 / K2 shape of the training backward: device us per
    launch (profiler, the kernel alone), its bound (bytes at 3.35 TB/s) and
    index_add_ / index_select at the same shape."""
    seen = set()
    for key, (args, _) in backward_launches.items():
        name, shape, dtype = key[:3]
        if (name, shape, dtype) in seen:  # the same shape at another index: timed once
            continue
        seen.add((name, shape, dtype))
        s, rows, d = shape
        esz = args[0].element_size()
        if name == "K1":
            data, order, indptr, n = args
            kept = order.numel()
            check(kept == rows, "a training backward sum dropped edges")
            ids = torch.empty(kept, dtype=torch.long, device="cuda")
            ids[order.long()] = torch.repeat_interleave(
                torch.arange(n, device="cuda"), (indptr[1:] - indptr[:-1]).long())
            xf = data.float()
            nbytes = s * kept * d * esz + s * n * d * 4 + (kept + n + 1) * 4

            def kernel():
                return kern.segment_sum_cuda(data, order, indptr, n)

            def library():
                return torch.zeros((s, n, d), device="cuda").index_add_(1, ids, xf)
            pattern, lib_name, what = "segment_sum_", "index_add_", f"n={n}"
        else:
            data, ids32, _ = args
            e = ids32.numel()
            ids = ids32.long()
            uniq = int(torch.unique(ids).numel())
            nbytes = s * uniq * d * esz + s * e * d * esz + e * 4

            def kernel():
                return kern.gather_cuda(data, ids32)

            def library():
                return data.index_select(1, ids)
            pattern, lib_name, what = "gns_gather_", "index_select", f"E={e}"
        dev, _ = device_us(kernel, pattern=pattern)
        lib, lib_acts = device_us(library)
        bound = nbytes / HBM_BYTES_PER_S * 1e6
        log(f"[train timing] backward {name} S={s} rows={rows} D={d} {what} {str(dtype)[6:]}: "
            f"{dev:.2f} us device (profiler), bound {bound:.2f} us ({nbytes / 1e6:.2f} MB), "
            f"{lib_name} {lib:.2f} us device (x{lib_acts:g} activities; card: {card})")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gns_torch.models.pretrained import load_pretrained
        from gns_torch.ops import segment as seg
        from gns_torch.ops import segment_kernels as kern

        wrappers()
    except ImportError as exc:
        fail(f"cannot import gns_torch next to this script: {exc}")
    t_start = time.perf_counter()
    card = phase_device()
    built = phase_build(kern)
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    phase_kernels(kern, seg, errs)
    phase_parity()
    cases, model, cfg, launches, recorded, bf16_readings = phase_serving(kern, seg)
    phase_path_inputs(kern, recorded, errs)
    del recorded
    launches["K3"] = phase_fused(kern, model, errs, built)
    deep, deep_cfg = load_pretrained("300-deep", device="cuda")
    deep_errs = {"K3": 0.0, "K4": 0.0}
    phase_fused_deep(kern, deep, deep_errs)
    launches["K4"] = phase_megakernel(kern, cases, model, cfg, errs, built, bf16_readings)
    phase_megakernel_deep(kern, cases, deep, deep_cfg, deep_errs)
    timing, forward_ms = phase_timing(kern, seg, cases, model, cfg, card)
    timing.update(phase_timing_k34(model, cfg, deep, deep_cfg, cases, forward_ms, card, built))
    del model, deep
    train = phase_train(kern, seg, card)
    phase_train_child(train)
    evals = phase_eval(kern, seg, card)
    solves = phase_solve(kern, seg, card)
    screens = phase_screen(kern, seg, card)
    parallel = phase_parallel(card)
    data = phase_data(kern, seg, card)
    # phase 7b last: after its widths the profiler leaves activities out of
    # later traces of the same process (see device_us)
    t0 = time.perf_counter()
    widths = phase_widths(kern, cases, built, card, NEW_WIDTHS)
    log(f"[widths] phase 7b took {time.perf_counter() - t0:.1f} s")
    del cases
    for k in ("K3", "K4"):
        widths[(k, (40, 10))] = dict(timing[k].pop("at_L40_H10"), max_abs_err=deep_errs[k],
                                     launches=1)
    kernels = []
    meta = {
        "K1": ("segment_sum_warp / segment_sum_narrow", "gns_torch/csrc/segment.cu", "gns_tpu/ops/pallas_segment.py:29"),
        "K2": ("gns_gather_narrow / gns_gather_wide", "gns_torch/csrc/segment.cu", "gns_tpu/ops/pallas_segment.py:45"),
        "K3": ("fused_edge_kernel", "gns_torch/csrc/fused_edge.cu", "gns_tpu/ops/pallas_fused.py:50"),
        "K4": ("megakernel", "gns_torch/csrc/megakernel.cu", "gns_tpu/ops/pallas_megakernel.py:88"),
    }
    # `launches` is each kernel's count on the path that first drives it:
    # K1 / K2 the float32 predict of 1024 requests, K3 one fused_edge_stage
    # forward, K4 one megakernel_forward_batch; `train_step_launches` the
    # counts of one update step of each training configuration
    launches_from = {"K1": "serving: float32 predict, b1024", "K2": "serving: float32 predict, b1024",
                     "K3": "fused_edge_stage forward", "K4": "megakernel_forward_batch"}
    for k, (name, source, replaces) in meta.items():
        kernels.append(dict(
            name=f"{k} {name}" + (" (L=20, H=10)" if k in ("K3", "K4") else ""),
            route="cuda", source=source,
            replaces=replaces, launches=launches[k], max_abs_err=errs[k], **timing[k],
            launches_from=launches_from[k],
            train_step_launches={tag: {"forward": r["forward"][k], "backward": r["backward"][k]}
                                 for tag, r in train.items()},
        ))
        if k in ("K1", "K2"):  # the eval path: run_gns per grid, a supervised update step
            kernels[-1]["eval_launches"] = dict(
                grids=evals["eval"]["grids"], forwards=evals["eval"]["forwards"],
                launches=evals["eval"]["launches"][k], per_forward=evals["eval"]["per_forward"][k],
                supervised_step=evals["supervised_step"][k])
            # the solve phase: each arm's launches over one chunk of 256 case300 grids
            kernels[-1]["solve_launches"] = {arm: c[k] for arm, c in solves.items()}
            # the screen phase: each screen's launches on case118
            kernels[-1]["screen_launches"] = {name: c[k] for name, c in screens.items()}
            # the parallel phase: each rank's launches per path ("world/rank/path")
            kernels[-1]["parallel_launches"] = {name: c[k] for name, c in parallel.items()}
            # the data phase: train() from the generated data set (its capture:
            # warm-up steps and the captured step; the replays call no
            # wrapper), evaluate() on its held-out pickles, and one step of
            # the refresh's "degree" (forward + backward)
            kernels[-1]["data_launches"] = dict(
                train_capture=data["train"]["launches"][k], train_per_step=data["train"]["per_step"][k],
                eval=data["eval"]["launches"][k],
                refresh_step={tag: r["forward"][k] + r["backward"][k]
                              for tag, r in data["refresh"].items()})
    # K3 / K4 at the other widths: launches from the one forward of phase
    # 7b (new widths; K3 forward and backward, K4 on the 1024 requests) or
    # of phase 6 / 7 (`300-deep`, (40, 10))
    for (k, (latent, hidden)), res in sorted(widths.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        name, source, replaces = meta[k]
        kernels.append(dict(
            name=f"{k} {name} (L={latent}, H={hidden})", route="cuda", source=source,
            replaces=replaces, **res,
            launches_from=("fused_edge_stage forward" if k == "K3" else
                           "megakernel_forward_batch") + (
                ", 300-deep" if (latent, hidden) == (40, 10) else ", random weights from a seed"),
        ))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-timing"]:
        sys.exit(train_timing_child())
    if sys.argv[1:2] == ["--solve-timing"] and len(sys.argv) == 3:
        sys.exit(solve_timing_child(sys.argv[2]))
    if sys.argv[1:] == ["--screen-timing"]:
        sys.exit(screen_timing_child())
    if sys.argv[1:2] == ["--parallel"] and len(sys.argv) == 5:
        sys.exit(parallel_child(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
