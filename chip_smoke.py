#!/usr/bin/env python3
"""Drive gns_torch's serving path on one NVIDIA GPU (an H100) and check it.

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
     tiles); ptxas must report no spill for K3.
  7. megakernel: gns_torch.ops.megakernel.megakernel_forward_batch (K4) on
     the same 1024 case300 requests and checkpoint as phase 5: one K4
     launch and no K1/K2 launch, against its plain twin on the CPU (worst
     value and 99.9th percentile, each beside the eager bfloat16 path's
     reading of phase 5) and against the float32 forward on the card (a
     sanity bound); its shared bytes per grid, grids resident per SM,
     ptxas registers and spills, and the count of HMMA (tensor-core)
     instructions in its SASS, which must not be 0.
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
     blocks per SM.
Then one JSON line with every kernel's numbers, and last the
{"ok": true, "device": ...} line.
"""

from __future__ import annotations

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
K3_FWD = dict(rtol=1e-5, atol=1e-5)  # exact float32; dot products add in another order
K3_GRAD = dict(rtol=2e-4, atol=1e-5)  # tests/test_fused.py:61


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
    # A trace now and then comes back without device activity, or without
    # some of it (seen in about one of a hundred traces of a run): a trace
    # counts only with the same number of activities for every call; else
    # trace again, up to six times in all.
    for attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [ev.time_range.end - ev.time_range.start for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
                 and pattern in ev.name]
        if spans and len(spans) % reps == 0:
            return sum(spans) / reps, len(spans) / reps
        log(f"[timing] trace {attempt + 1} of 6 recorded {len(spans)} device activities matching "
            f"{pattern!r} over {reps} calls: not the same number per call")
    fail("the profiler did not record every call's device activity")


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

    def gather_cuda(self, data, ids):
        self._keep(("K2", tuple(data.shape), data.dtype, ids.data_ptr()), (data, ids))
        return self.kern.gather_cuda(data, ids)

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
            data, ids = args
            got = kern.gather_cuda(data, ids)
            torch.cuda.synchronize()
            want = kern.gather_plain(data.cpu(), ids.cpu())
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


def phase_timing_k34(model, cfg, cases, forward_ms, card, built):
    """K3 and K4 at the main path's shapes, each against its bound and its
    plain twin on the card, and K4 beside the eager forwards."""
    from gns_torch.models.gns import _block, head_dims
    from gns_torch.ops import fused
    from gns_torch.ops.megakernel import STAGES, megakernel_cuda, megakernel_inputs, megakernel_plain
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    results = {}
    no_library = ("no single PyTorch call computes {}: it chains gathers, three MLPs "
                  "and segment-sums{}, so library_ms is null")
    m, feats, line_mask, idx, heads, _ = k3_problem(model, seed=1)
    weights = fused._weights(heads)
    s, n, latent = m.shape
    e, hidden = idx.edges, weights[0].shape[0]
    f_in = latent + 5
    macs = s * e * 3 * (hidden * f_in + hidden * hidden + latent * hidden)
    nbytes = 4 * (m.numel() + feats.numel() + line_mask.numel() + sum(w.numel() for w in weights)
                  + idx.ids.numel() + idx.order.numel() + idx.indptr.numel() + 3 * s * n * latent)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * macs / FP32_FLOPS
    with torch.no_grad():
        ms = cuda_ms(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01))
        plain = cuda_ms(lambda: fused.fused_edge_stage_plain(m, feats, line_mask, idx, heads), reps=20)
        dev, acts = device_us(lambda: fused.fused_edge_cuda(m, feats, line_mask, idx, weights, 0.01),
                              pattern="fused_edge_kernel")
    results["K3"] = dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                         device_ms=dev / 1e3)
    log(f"[timing] K3 fused edge stage case300 S={s} L={latent} H={hidden} float32: "
        f"{ms * 1e3:.2f} us (CUDA events), {dev:.2f} us device (profiler, the kernel alone, "
        f"x{acts:g} per call), bound {results['K3']['bound_ms'] * 1e3:.2f} us by "
        f"{results['K3']['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s = {t_bytes * 1e6:.2f} us; "
        f"{2 * macs / 1e9:.3f} GFLOP at 67 TFLOP/s float32 = {t_ops * 1e6:.2f} us), "
        f"plain twin on the card {plain * 1e3:.2f} us")
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
        ms = cuda_ms(lambda: megakernel_cuda(inp), reps=20, warmup=3)
        plain = cuda_ms(lambda: megakernel_plain(inp), reps=5, warmup=2)
    s, n = inp.bus_mask.shape
    e, g, k = inp.line_mask.shape[1], inp.gen_mask.shape[1], len(inp.steps)
    # MACs per grid and step of the model's own heads (phi per edge, L per
    # bus), not of the fused layout's block-diagonal zeros: 1650 per edge
    # and 1840 per bus at L=20, H=10
    macs = {"edge": 0, "bus": 0}
    for head, _, _ in head_dims(cfg):
        block = _block(getattr(model, head)[0])
        macs["edge" if head.startswith("phi") else "bus"] += sum(
            block[w].numel() for w in ("w1", "w2", "w4"))
    flops = 2 * s * k * (e * macs["edge"] + n * macs["bus"])
    # what K4's tiles multiply, padding included (not the bound): 27 mma of
    # 16 x 8 x 16 per 16-row phi tile, 29 per work item's 16-bus L tile
    items = inp.items.cpu().numpy()
    phi_tiles = int(sum(-(-int(r1 - r0) // 16) for r0, r1 in items[:, 2:]))
    tile_flops = 2 * s * k * 16 * 8 * 16 * (27 * phi_tiles + 29 * len(items))
    ints = [inp.src.ids, inp.dst.ids, inp.srcq, inp.dstq, inp.dst.order, inp.dst.indptr,
            inp.src.indptr, inp.gen.order, inp.gen.indptr, inp.dst_pos, inp.src_pos, inp.gen_pos,
            inp.items, inp.row_bus]
    nbytes = sum(t.numel() * t.element_size() for t in (
        inp.buses, inp.lines, inp.gens, inp.bus_mask, inp.line_mask, inp.gen_mask,
        inp.wpack, inp.bpack, inp.discounts, *ints)) + 4 * (4 * s * n + 2 * s)
    t_bytes, t_tc, t_f32 = nbytes / HBM_BYTES_PER_S, flops / BF16_TC_FLOPS, flops / FP32_FLOPS
    with torch.no_grad():
        dev, acts = device_us(lambda: megakernel_cuda(inp), reps=10, pattern="megakernel")
        one = inp._replace(wpack=inp.wpack[:1], bpack=inp.bpack[:1], discounts=inp.discounts[:1],
                           steps=inp.steps[:1])
        ms1 = cuda_ms(lambda: megakernel_cuda(one), reps=20, warmup=3)
    results["K4"] = dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_tc) * 1e3,
                         bound_by="bytes" if t_bytes >= t_tc else "operations", library_ms=None,
                         device_ms=dev / 1e3)
    log(f"[timing] K4 megakernel case300 b{s} K={k}: {ms:.3f} ms per forward (CUDA events) = "
        f"{s / ms * 1e3:.1f} grids/s, {dev / 1e3:.3f} ms device (profiler, x{acts:g} per call); "
        f"bound {results['K4']['bound_ms'] * 1e3:.2f} us by "
        f"{results['K4']['bound_by']}: {macs['edge']} MACs per edge and {macs['bus']} per bus "
        f"per step, {flops / 1e9:.2f} GFLOP of bf16-operand products at "
        f"989 TFLOP/s (tensor cores) = {t_tc * 1e6:.2f} us, {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{t_bytes * 1e6:.2f} us; on the float32 CUDA cores (67 TFLOP/s) the same products "
        f"take {t_f32 * 1e6:.2f} us; K4's tiles, padding included ({phi_tiles} phi tiles of 16 "
        f"rows, {len(items)} L tiles per grid and step), multiply {tile_flops / 1e9:.2f} GFLOP, "
        f"{tile_flops / BF16_TC_FLOPS * 1e6:.2f} us at 989 TFLOP/s; plain twin on the card "
        f"{plain:.3f} ms")
    with torch.no_grad():
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
    return results


def phase_profile(model, cfg, bt, graph, reps: int = 3):
    """Device busy and idle share of the float32 forward, from one trace.

    Each of `reps` forwards runs alone on an idle stream, between two CUDA
    events; the events' span is that forward's window on the device,
    launch gaps included. The kernels the profiler saw in the same trace
    give the busy time (the union of their intervals). Only device
    activity is traced; the same forwards untraced, just before, show what
    the tracing costs the host's launch pace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gns_torch.models.gns import gns_forward, step_params

    with torch.no_grad():
        steps = step_params(model, cfg)
        gns_forward(steps, cfg, bt, graph, dense=True)
    torch.cuda.synchronize()

    def windows():
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        with torch.no_grad():
            for start, end in marks:
                start.record()
                gns_forward(steps, cfg, bt, graph, dense=True)
                end.record()
                torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in marks]

    untraced = windows()
    for attempt in range(6):  # as device_us: a trace that missed activity is traced again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = windows()
        spans = sorted(
            (ev.time_range.start, ev.time_range.end) for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
        )
        if spans and len(spans) % reps == 0:
            break
        log(f"[profile] trace {attempt + 1} of 6 recorded {len(spans)} device activities over "
            f"{reps} forwards: not the same number per forward")
    check(bool(spans) and len(spans) % reps == 0,
          "the profiler did not record every forward's device activity")
    window_ms = sum(traced)
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:  # union of the intervals
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    busy_ms = busy_us / 1e3
    check(0 < busy_ms <= window_ms * 1.05, f"busy {busy_ms:.3f} ms outside windows {window_ms:.3f} ms")
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
        return fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), S_SERVE, rows, ids.numel(), 4,
                  kern._stream_of(dev))

    def old_gather():
        old_lookup()
        old_checks()
        o = torch.empty((S_SERVE, ids.numel(), 1), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), ids.data_ptr(), o.data_ptr(), S_SERVE, rows, ids.numel(), 4, stream)
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
         lambda: fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(), 0, rows, ids.numel(), 4,
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


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
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
    launches["K4"] = phase_megakernel(kern, cases, model, cfg, errs, built, bf16_readings)
    timing, forward_ms = phase_timing(kern, seg, cases, model, cfg, card)
    timing.update(phase_timing_k34(model, cfg, cases, forward_ms, card, built))
    kernels = []
    meta = {
        "K1": ("segment_sum_warp / segment_sum_narrow", "gns_torch/csrc/segment.cu", "gns_tpu/ops/pallas_segment.py:29"),
        "K2": ("gns_gather_narrow / gns_gather_wide", "gns_torch/csrc/segment.cu", "gns_tpu/ops/pallas_segment.py:45"),
        "K3": ("fused_edge_kernel", "gns_torch/csrc/fused_edge.cu", "gns_tpu/ops/pallas_fused.py:50"),
        "K4": ("megakernel", "gns_torch/csrc/megakernel.cu", "gns_tpu/ops/pallas_megakernel.py:88"),
    }
    for k, (name, source, replaces) in meta.items():
        kernels.append(dict(
            name=f"{k} {name}", route="cuda", source=source,
            replaces=replaces, launches=launches[k], max_abs_err=errs[k], **timing[k],
        ))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
