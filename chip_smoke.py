#!/usr/bin/env python3
"""Drive gns_torch's serving, training, evaluation and solver paths on one
NVIDIA GPU (an H100) and check them.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles the three CUDA sources of gns_torch/csrc (segment.cu:
     K1, K2; fused_edge.cu: K3; megakernel.cu: K4) with nvcc for sm_90a,
     one nvcc each, all started together, timed.
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
     instructions in its SASS, which must not be 0. Then `300-deep` (K=8,
     L=40, H=10) on the same requests: one K4 launch and no K1/K2, against
     its plain twin on the CPU (K4_DEEP_CARD_VS_CPU) and its float32
     forward (DEEP_VS_F32), its shared bytes per grid and grids per SM.
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
  9. train: the trainer (gns_torch/train/trainer.py) at bench.py's model,
     case300 K=4 latent 20 hidden 10 multiple phi, batch 256 (the grids of
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
 12. bench: `python -m gns_torch.bench` in a process of its own; its one
     JSON line must parse with bench.py's keys and finite values, and is
     printed beside the train phase's replay reading of config B.
Then one JSON line with every kernel's numbers, and last the
{"ok": true, "device": ...} line.
"""

from __future__ import annotations

import collections
import json
import os
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
K3_FWD = dict(rtol=1e-5, atol=1e-5)  # exact float32; dot products add in another order
K3_GRAD = dict(rtol=2e-4, atol=1e-5)  # tests/test_fused.py:61
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


def device_us(fn, reps: int = 20, pattern: str = ""):
    """Kernel-only device time of fn: the durations of the device
    activities the profiler traced over `reps` calls (host launch gaps
    excluded) whose name holds `pattern`, summed, per call, in us; and
    those activities per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # The profiler now and then leaves out a call's device activity: a trace
    # counts when each kind of activity numbers a whole multiple of `reps`;
    # else trace again, up to six times, and fail after six short traces.
    # (After the train phase it has left one activity out of nearly every
    # trace of the same process, so the train phase's readings are taken in
    # a process of their own: phase_train_child.)
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kinds = collections.defaultdict(list)
        for ev in prof.events():
            if (ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
                    and pattern in ev.name):
                kinds[ev.name].append(ev.time_range.end - ev.time_range.start)
        n = sum(map(len, kinds.values()))
        if n and all(len(spans) % reps == 0 for spans in kinds.values()):
            return sum(map(sum, kinds.values())) / reps, n / reps
        log(f"[timing] trace {attempt + 1} of 6 recorded {n} device activities matching "
            f"{pattern!r} over {reps} calls: not the same number per call")
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
    """fn's launches with the L2 as the previous launch left it (warm) and
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
    out["cold_device"], _ = device_us(lambda: (flush.fill_(1.0), fn()), reps=reps, pattern=pattern)
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
    """Builds every source; returns {name: (library path, ptxas lines)}."""
    t0 = time.perf_counter()
    info = kern.build_kernels()
    check(set(info) == set(kern.SOURCES), f"built {sorted(info)}, sources {sorted(kern.SOURCES)}")
    built = {}
    for name, one in info.items():
        log(f"[build] {os.path.relpath(one['path'])} built in {one['seconds']:.2f} s")
        lines = [line.strip() for line in one["log"].splitlines()
                 if "registers" in line or "spill" in line or "entry function" in line
                 or "error" in line.lower()]
        for line in lines:
            log(f"[build]   {line}")
        built[name] = (one["path"], lines)
    log(f"[build] {len(info)} sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    return built


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


def phase_fused(kern, model, errs, built):
    """K3 through its public entry point: forward and autograd backward on
    the card; returns the forward's K3 launch count."""
    from gns_torch.ops import fused
    from gns_torch.ops.segment import SegmentIndex

    m, feats, line_mask, idx, heads, topo = k3_problem(model)
    params = [m, feats, line_mask] + fused._weights(heads)
    for t in params:
        t.requires_grad_(True)
    reset_counts()
    with NoPlainTwins(kern):
        out = fused.fused_edge_stage(m, feats, line_mask, idx, heads)
        torch.cuda.synchronize()
        fwd = counts()
        want = {"K1": 0, "K2": 0, "K3": 1, "K4": 0}
        log(f"[fused] forward launches {fwd} (expected {want})")
        check(fwd == want, f"K3 forward launches {fwd} != {want}")
        sum((o * o).sum() for o in out).backward()
        torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    # the recompute: 1 K2 gather and 3 K1 sums; their adjoints: 3 K2 and 1 K1
    want = {"K1": 4, "K2": 4, "K3": 0, "K4": 0}
    log(f"[fused] backward launches {bwd} (expected {want}; no plain twin ran on the card)")
    check(bwd == want, f"K3 backward launches {bwd} != {want}")

    cpu = [t.detach().cpu().requires_grad_(True) for t in params]
    heads_cpu = {h: dict(zip(fused._PARAMS, cpu[3 + 6 * i: 9 + 6 * i]))
                 for i, h in enumerate(fused.PHI_HEADS)}
    idx_cpu = SegmentIndex(topo.dst, idx.n, "cpu")
    want_out = fused.fused_edge_stage_plain(cpu[0], cpu[1], cpu[2], idx_cpu, heads_cpu)
    sum((o * o).sum() for o in want_out).backward()
    with torch.no_grad():
        on_card = fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads)
    names = [f"sum_{h}" for h in fused.PHI_HEADS]
    for name, got, want_o, card in zip(names, out, want_out, on_card):
        got = got.detach()
        err = (got.cpu() - want_o.detach()).abs().max().item()
        card_err = (got - card).abs().max().item()
        errs["K3"] = max(errs["K3"], err, card_err)
        ok = torch.allclose(got.cpu(), want_o.detach(), **K3_FWD) and torch.allclose(got, card, **K3_FWD)
        log(f"[fused] {name} max_abs_err {err:.3e} vs the plain twin on the CPU, {card_err:.3e} "
            f"on the card (rtol {K3_FWD['rtol']:g} atol {K3_FWD['atol']:g}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"K3 {name} disagrees with its plain twin")
    labels = ["m", "feats", "line_mask"] + [f"{h}.{n}" for h in fused.PHI_HEADS for n in fused._PARAMS]
    worst, worst_label = 0.0, ""
    for label, t, c in zip(labels, params, cpu):
        # the share of the allowed error used: |got - want| / (atol + rtol |want|)
        share = ((t.grad.cpu() - c.grad).abs()
                 / (K3_GRAD["atol"] + K3_GRAD["rtol"] * c.grad.abs())).max().item()
        if share > worst:
            worst, worst_label = share, label
        ok = torch.allclose(t.grad.cpu(), c.grad, **K3_GRAD)
        if not ok:
            log(f"[fused] grad {label} uses {share:.3f} of its tolerance MISMATCH")
        check(ok, f"K3 backward: grad of {label} disagrees with the CPU autograd")
    log(f"[fused] backward: all {len(labels)} gradients within rtol {K3_GRAD['rtol']:g} "
        f"atol {K3_GRAD['atol']:g} of the plain twin's autograd on the CPU (the worst, "
        f"{worst_label}, uses {worst:.3f} of its tolerance)")

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
    for name, g, w, c in zip(names, got, want_h, on_card):
        err = max((g.cpu() - w).abs().max().item(), (g - c).abs().max().item())
        errs["K3"] = max(errs["K3"], err)
        ok = torch.allclose(g.cpu(), w, **K3_FWD) and torch.allclose(g, c, **K3_FWD)
        log(f"[fused] hub index (70-edge bus, S=64) {name} max_abs_err {err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"K3 {name} on the hub index disagrees with its plain twin")

    spills = [line for line in built["fused_edge"][1] if "spill" in line]
    log(f"[fused] ptxas: " + " | ".join(built["fused_edge"][1]))
    check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills),
          "K3's ptxas report shows spills (or none was printed)")
    return fwd["K3"]


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
    shared, per_sm, threads, sms = fused.fused_edge_occupancy(40, 10)
    log(f"[fused] L=40: {threads} threads and {shared} bytes of shared memory per block, "
        f"{per_sm} blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    check(per_sm >= 2, f"K3 at L=40 keeps {per_sm} blocks per SM, its launch bounds ask for 2")


def sass_hmma(library: str):
    """Count of HMMA (tensor-core) instructions in a built library's SASS,
    from cuobjdump, or None where the toolkit has no cuobjdump."""
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
    return sum(1 for line in run.stdout.splitlines() if "HMMA" in line)


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
    path, ptxas = built["megakernel"]
    shared, per_sm = megakernel_occupancy(megakernel_inputs(model, cfg, batch, topo))
    log(f"[megakernel] case300 grid: {shared} bytes of shared memory per grid, "
        f"{per_sm} grids resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    check(per_sm >= 1, f"K4 cannot keep a case300 grid resident ({per_sm})")
    for line in ptxas:
        log(f"[megakernel] ptxas: {line}")
    hmma = sass_hmma(path)
    if hmma is None:
        log("[megakernel] this toolkit has no cuobjdump: the SASS is not inspected")
    else:
        log(f"[megakernel] SASS of {os.path.basename(path)}: {hmma} HMMA instructions")
        check(hmma > 0, "K4's SASS has no HMMA instruction: its products are not on the tensor cores")

    reset_counts()
    with NoPlainTwins(kern), torch.no_grad():
        out = megakernel_forward_batch(model, cfg, batch, topo)
        torch.cuda.synchronize()
    got = counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 1}
    log(f"[megakernel] b{S_SERVE} launches {got} (expected {want})")
    check(got == want, f"K4 launches {got} != {want}")

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


def time_k3(m, feats, line_mask, idx, heads) -> dict:
    """K3 at these inputs: CUDA-event and device time per launch, its bound
    (bytes at 3.35 TB/s or float32 FMAs at 67 TFLOP/s) and its plain twin
    on the card."""
    from gns_torch.ops import fused

    weights = fused._weights(heads)
    s, n, latent = m.shape
    e, hidden = idx.edges, weights[0].shape[0]
    macs = s * e * 3 * (hidden * (latent + 5) + hidden * hidden + latent * hidden)
    nbytes = 4 * (m.numel() + feats.numel() + line_mask.numel() + sum(w.numel() for w in weights)
                  + idx.ids.numel() + idx.order.numel() + idx.indptr.numel() + 3 * s * n * latent)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / FP32_FLOPS
    with torch.no_grad():
        ms = cuda_ms(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01))
        plain = cuda_ms(lambda: fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads), reps=20)
        dev, acts = device_us(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01),
                              pattern="fused_edge_kernel")
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


def time_k4(model, cfg, inp) -> dict:
    """K4 on these inputs: CUDA-event and device time per launch, its bound
    (the model's own heads' MACs on the bf16 tensor cores, or bytes) and its
    plain twin on the card."""
    from gns_torch.models.gns import _block, head_dims
    from gns_torch.ops.megakernel import megakernel_cuda, megakernel_plain

    with torch.no_grad():
        ms = cuda_ms(lambda: megakernel_cuda(inp), reps=20, warmup=3)
        plain = cuda_ms(lambda: megakernel_plain(inp), reps=5, warmup=2)
        dev, acts = device_us(lambda: megakernel_cuda(inp), reps=10, pattern="megakernel")
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
    # phi tile 3 NH KP + 3 NH + 3 NL mma of 16 x 8 x 16 (27 at L=20), per
    # work item's 16-bus L tile 3 NH KL + 3 NH + 2 + NL (29 at L=20)
    latent = cfg.latent_dim
    kp, kl, nl = -(-(latent + 5) // 16), -(-(4 + 2 * latent) // 16), -(-latent // 8)
    per_phi, per_l = 6 * kp + 6 + 3 * nl, 6 * kl + 6 + 2 + nl
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
    shared, per_sm = megakernel_occupancy(megakernel_inputs(deep, deep_cfg, batch, topo))
    log(f"[megakernel] 300-deep (K=8, L=40, H=10) case300 grid: {shared} bytes of shared memory "
        f"per grid, {per_sm} grids resident per SM")
    check(per_sm >= 1, f"K4 cannot keep a case300 grid resident at L=40 ({per_sm})")
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
    shared, per_sm, threads, sms = fused.fused_edge_occupancy(latent, hidden)
    log(f"[timing] K3 occupancy: {threads} threads and {shared} bytes of shared memory per block, "
        f"{per_sm} blocks resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
        f"{sms} SMs; ptxas: " + " | ".join(built["fused_edge"][1]))
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
    for attempt in range(6):  # as device_us: a trace that missed activity is traced again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = windows()
        spans = sorted(
            (ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
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
        (r for r in prof.key_averages() if r.device_type == DeviceType.CUDA),
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
    """Config A: case300 K=4 latent 20 hidden 10 multiple phi (bench.py:35-84's
    model), float32, reference parity; B: bench.py's default
    (bench.py:50-52, 78-82), bfloat16 MLPs and the paper physics, the fold
    on by "auto"."""
    from gns_torch.utils.config import GNSConfig

    a = GNSConfig(case_nr=CASE, K=4, latent_dim=20, hidden_dim=10, multiple_phi=True,
                  reference_parity=True, batch_size=S_TRAIN)
    b = a.replace(compute_dtype="bfloat16", reference_parity=False)
    check(b.resolved_fold_output and not a.resolved_fold_output, "config B must fold, A must not")
    return {"A": a, "B": b}


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
        return {"K1": 1 + 4 * k, "K2": 2 + 5 * k}, {"K1": (k - 1) + 4 * k, "K2": 4 * k}
    return {"K1": 2 + 4 * k, "K2": 3 * k}, {"K1": (k - 1) + 2 * k, "K2": 4 * k}


def hold_recorded(kern, recorded: dict, tag: str) -> int:
    """Every recorded K1 / K2 launch replayed on its input: bit-equal to its
    plain twin on CPU copies (the same order of adds), and K2 also to its
    twin on the card (a copy). Returns the number of launches held."""
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
        log(f"[train] {tag} {name} {what} max_abs_err {err:.3e} {'bit-equal' if same else 'MISMATCH'}")
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


def solve_arms(model, cfg, cases):
    """The solve phase's arms on the model's device, by name: functions of
    no argument returning the result dict."""
    from gns_torch.eval import dcpf, fdpf, hybrid, nr_batched, solve

    dev = next(model.parameters()).device
    return {
        "flat NR": lambda: nr_batched.solve_batched(cases, device=dev),
        "FDPF": lambda: fdpf.solve_batched_fdpf(cases, device=dev),
        "hybrid NR": lambda: hybrid.hybrid_solve(model, cfg, cases),
        "hybrid FDPF": lambda: hybrid.hybrid_solve(model, cfg, cases, solver="fdpf", max_iter=60),
        "solve_ac auto": lambda: solve.solve_ac(cases, params=model, cfg=cfg, device=dev),
        "DC": lambda: dcpf.solve_batched_dc(cases, device=dev),
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
    fd = {"K1": 3 + 2 * it, "K2": 1 + 2 * it}
    want = {
        "flat NR": {"K1": 1, "K2": 0},
        "FDPF": fd,
        "hybrid NR": {"K1": forward["K1"] + 1 + fallback, "K2": forward["K2"]},
        "hybrid FDPF": {"K1": forward["K1"] + fd["K1"] + fallback, "K2": forward["K2"] + fd["K2"]},
        "solve_ac auto": {"K1": fd["K1"] + fallback, "K2": fd["K2"]},
        "DC": {"K1": 1, "K2": 1},
    }[arm]
    return dict(want, K3=0, K4=0)


def hold_solve(arm: str, got: dict, want: dict, tol: float = 3e-5) -> None:
    """One arm on the card (got) against the port's CPU run on the same
    grids (want): converged masks equal; v and theta within
    SOLVE_CARD_VS_CPU on the converged grids; per-grid iteration counts
    equal except on grids where a gate decided at its edge (module
    constant SOLVE_EDGE), and lock-step counts equal or off by exactly what
    those grids explain."""
    v_tol, th_tol = SOLVE_CARD_VS_CPU
    if arm == "DC":
        th = np.abs(np.deg2rad(got["theta_deg"]) - np.deg2rad(want["theta_deg"])).max()
        pf = np.abs(got["pf_mw"] - want["pf_mw"]).max()
        ok = th <= DC_CARD_VS_CPU[0] and pf <= DC_CARD_VS_CPU[1] * max(1.0, np.abs(want["pf_mw"]).max())
        log(f"[solve] {arm} card vs cpu: theta {th:.3e} rad, pf {pf:.3e} MW {'ok' if ok else 'MISMATCH'}")
        check(ok and np.isfinite(got["theta_deg"]).all(), f"{arm}: card vs cpu")
        return
    conv = want["converged"]
    check(np.array_equal(got["converged"], conv), f"{arm}: converged masks differ, card "
          f"{int(got['converged'].sum())} cpu {int(conv.sum())}")
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
    log(f"[solve] {arm} card vs cpu: converged {int(conv.sum())} of {len(conv)} both; v {dv:.3e} "
        f"(<= {v_tol:g}), theta {dth:.3e} deg (<= {th_tol:g}); lock-step iterations card "
        f"{lock_card} cpu {lock_cpu}; per-grid counts differ on {len(diff)} grids, {len(edge)} of "
        f"them decided at a gate's edge{': ' + str(sorted(int(g) for g in edge)) if edge else ''} "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{arm}: card vs cpu")


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


def solve_timing_child(path: str) -> int:
    """`chip_smoke.py --solve-timing CASES.npz`: the device's busy and idle
    share of one flat Newton solve of the stacked cases, from one profiler
    trace (trace_busy), in a process of its own."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gns_torch.eval.nr_batched import solve_batched

    card = phase_device()
    with np.load(path) as z:
        bus, branch, gen, base = z["bus"], z["branch"], z["gen"], z["base"]
    cases = [{"bus": bus[i], "branch": branch[i], "gen": gen[i], "baseMVA": float(base[i])}
             for i in range(len(base))]
    out = solve_batched(cases)  # warm: index sets, libraries
    untraced, traced, busy, spans, _ = trace_busy(lambda: solve_batched(cases), reps=2,
                                                  what="flat solve", expect={"segment_sum_": 1})
    log(f"[solve timing] flat NR, {len(cases)} case{CASE} grids, {out['iterations']} iterations, "
        f"{out['host_syncs']} host syncs: device windows {', '.join(f'{w:.3f}' for w in traced)} ms "
        f"traced, {', '.join(f'{w:.3f}' for w in untraced)} ms untraced; busy {busy / 2:.3f} ms per "
        f"solve in {len(spans) / 2:.1f} device activities; idle {100 * (1 - busy / sum(traced)):.1f}% "
        f"of the traced windows, {100 * (1 - busy / sum(untraced)):.1f}% of the untraced (card: {card})")
    return 0


def phase_bench(train: dict, card) -> dict:
    """`python -m gns_torch.bench` in a process of its own: its one JSON
    line must parse with bench.py's keys and finite values; it is printed
    beside the train phase's replay reading of config B, the same model,
    batch and dtype."""
    keys = {"metric", "value", "unit", "vs_baseline", "achieved_tflops", "mfu_bf16", "hbm_bw_util"}
    t0 = time.perf_counter()
    lines = run_child(["-m", "gns_torch.bench"], "bench", 600, module=True)
    printed = [x for x in lines if x.startswith('{"metric"')]
    check(len(printed) == 1, f"bench printed {len(printed)} JSON lines")
    line = json.loads(printed[0])
    check(set(line) == keys, f"bench printed keys {sorted(line)}")
    check(line["metric"] == f"train_edges_per_sec_case{CASE}_K4_b{S_TRAIN}", f"bench metric {line['metric']}")
    check(all(np.isfinite(line[k]) and line[k] > 0 for k in keys - {"metric", "unit"}),
          f"bench values not finite and positive: {line}")
    replay = train["B"]["replay_edges_per_s"]
    log(f"[bench] python -m gns_torch.bench: {json.dumps(line)} in {time.perf_counter() - t0:.1f} s; "
        f"the train phase's replay of config B (the same model, batch and dtype, {TRAIN_STEPS} steps): "
        f"{replay:.4e} train edges/s (card: {card})")
    return line


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
    for k in ("K3", "K4"):
        timing[k]["at_L40_H10"].update(max_abs_err=deep_errs[k], launches=1)
    del model, cases, deep
    train = phase_train(kern, seg, card)
    phase_train_child(train)
    evals = phase_eval(kern, seg, card)
    solves = phase_solve(kern, seg, card)
    phase_bench(train, card)
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
            name=f"{k} {name}", route="cuda", source=source,
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
    sys.exit(main())
