#!/usr/bin/env python3
"""Drive gns_torch's serving path on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles gns_torch/csrc/segment.cu with nvcc (sm_90a), timed.
  3. kernels: K1 (segment-sum) and K2 (gather) against their plain twins on
     random data at the serving path's case300 index sets (S=1024,
     D in {1, 2, 4, 20, 60}, float32 and bfloat16 data), and each kernel's
     autograd backward (the other kernel) against the plain gradient.
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
  6. timing: predict grids/s, forward grids/s, the device's busy and idle
     share of the forward from one profiler trace, and each kernel against
     its bound, its plain twin and one PyTorch library call.
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
S_SERVE = 1024
CASE = 300
# bfloat16 serving, card vs the port's CPU path on the same cases:
# (output, atol on every value, bound on the 99.9th percentile of the
# absolute error). Set from the NVIDIA H100 80GB HBM3 readings: v 3.714e-02
# worst and 4.883e-04 at p99.9, theta 2.441e-03 and 9.766e-04, last_loss
# 6.174e-04 and 3.970e-04; each bound is about twice to four times those.
BF16_CARD_VS_CPU = (("v", 7.5e-2, 2e-3), ("theta", 5e-3, 4e-3), ("last_loss", 2e-3, 1.5e-3))


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


def phase_build(kern):
    info = kern.build_kernels()
    log(f"[build] {os.path.relpath(info['path'])} built in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")


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
                got = kern.gather_cuda(x, ix.ids)
                torch.cuda.synchronize()
                want = kern.gather_plain(x.cpu(), ix.ids.cpu())
                on_card = kern.gather_plain(x, ix.ids)
                compare("K2", got, want, dtype, f"{iname} D={d} {str(dtype)[6:]}", on_card)

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


def phase_serving(kern, seg):
    """Returns the cases, the card's model, its config, the float32 run's
    launch counts and the inputs of every distinct kernel launch of both
    runs (PathRecorder)."""
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

    kern.reset_launch_counts()
    with recorder:
        out = pred.predict(cases)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kern.KERNELS.items()}
    want = {"K1": 1 + 4 * cfg.K, "K2": 2 + 5 * cfg.K}
    log(f"[serving] float32 b{S_SERVE} launches {launches} (expected {want})")
    check(launches == want, f"launch counts {launches} != {want}")

    def agree(label, a, b, rtol, atol, key, p999=None):
        err = np.abs(a.astype(np.float64) - b)
        q = float(np.quantile(err, 0.999))
        ok = bool(np.isfinite(a).all()) and a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol)
        ok = ok and (p999 is None or q <= p999)
        bound = "" if p999 is None else f" p99.9 <= {p999:g}"
        log(f"[serving] {label} {key} shape {a.shape} max_abs_err {float(err.max()):.3e} "
            f"p99.9 {q:.3e} (rtol {rtol:g} atol {atol:g}{bound}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{label} {key}")

    ref = GNSPredictor(model_cpu, cfg, batch_size=S_SERVE, device="cpu").predict(cases)
    for key, rtol, atol in (("v", 2e-4, 2e-4), ("theta", 2e-4, 2e-4), ("last_loss", 5e-4, 0.0)):
        agree("float32 card vs cpu", out[key], ref[key], rtol, atol, key)

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    pred16 = GNSPredictor(model, cfg16, batch_size=S_SERVE, device="cuda")
    kern.reset_launch_counts()
    with recorder:
        out16 = pred16.predict(cases)
        torch.cuda.synchronize()
    launches16 = {k: fn.launches for k, fn in kern.KERNELS.items()}
    want16 = {"K1": 2 + 4 * cfg.K, "K2": 2 + 5 * cfg.K}
    log(f"[serving] bfloat16 (fold on) launches {launches16} (expected {want16})")
    check(launches16 == want16, f"bf16 launch counts {launches16} != {want16}")
    # The card's bfloat16 path against the same port's bfloat16 path on
    # the CPU, same cases and weights: the two differ only where a GEMM's
    # order of adds flips a bfloat16 rounding, which the K steps carry on.
    ref16 = GNSPredictor(model_cpu, cfg16, batch_size=S_SERVE, device="cpu").predict(cases)
    for key, atol, p999 in BF16_CARD_VS_CPU:
        agree("bfloat16 card vs cpu", out16[key], ref16[key], 0.0, atol, key, p999)
    # Sanity bound against float32 only. On this trained checkpoint gns_tpu's
    # own bfloat16 path differs from its float32 path by up to 0.087 in v
    # (256 of these grids; ~4% of buses beyond test_megakernel's 2e-2), and
    # tests/test_torch_serve.py holds the port's bf16 deviation to the JAX
    # package's.
    for key, rtol, atol in (("v", 0.0, 0.15), ("theta", 0.0, 2e-2), ("last_loss", 0.1, 5e-2)):
        agree("bfloat16 vs float32", out16[key], out[key], rtol, atol, key)
    return cases, model, cfg, launches, recorder.inputs


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = windows()
    window_ms = sum(traced)
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == DeviceType.CUDA and ev.time_range.end > ev.time_range.start
    )
    check(bool(spans), "the profiler recorded no device activity")
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
    for label, pat in (("K1", "segment_sum_csr"), ("K2", "gather_rows")):
        mine = [r for r in rows if pat in r.key]
        t = sum(dev_us(r) for r in mine)
        log(f"[profile]   {label} {pat}: {t / reps / 1e3:.3f} ms per forward, "
            f"{100 * t / total:.1f}% of device time, x{sum(r.count for r in mine) // reps}")
    for r in rows[:12]:
        t = dev_us(r)
        if t > 0:
            log(f"[profile]   {t / reps / 1e3:8.3f} ms {100 * t / total:5.1f}% "
                f"x{r.count // reps:<4d} {r.key[:90]}")


def phase_timing(kern, seg, cases, model, cfg, card):
    from gns_torch.eval.harness import align_slack_angle
    from gns_torch.models.gns import batch_tensors, gns_forward
    from gns_torch.physics.common import build_graph
    from gns_torch.serve import GNSPredictor
    from gns_torch.utils.prepare import batch_from_cases, extract_shared_topology

    log(f"[timing] card: {card}")
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
        ms = cuda_ms(lambda: kern.segment_sum_cuda(x, ix.order, ix.indptr, ix.n))
        plain = cuda_ms(lambda: kern.segment_sum_plain(x, ix.order, ix.indptr, ix.n))
        ids_l = ix.ids.long()
        xf = x.float()
        lib = cuda_ms(lambda: torch.zeros((S_SERVE, ix.n, d), device="cuda").index_add_(1, ids_l, xf))
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
        log(f"[timing] K1 {label} D={d} {str(dtype)[6:]}: {ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB), plain {plain * 1e3:.2f} us, "
            f"index_add_ {lib * 1e3:.2f} us")
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib,
                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_FLOPS else "operations")

    def k2_case(ix, rows_in, d, dtype, label):
        x = torch.randn((S_SERVE, rows_in, d), generator=gen, device="cuda").to(dtype)
        esz = x.element_size()
        uniq = int(np.unique(ix.ids.cpu().numpy()).size)
        nbytes = S_SERVE * uniq * d * esz + S_SERVE * ix.edges * d * esz + ix.edges * 4
        ms = cuda_ms(lambda: kern.gather_cuda(x, ix.ids))
        plain = cuda_ms(lambda: kern.gather_plain(x, ix.ids))
        ids_l = ix.ids.long()
        lib = cuda_ms(lambda: x.index_select(1, ids_l))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[timing] K2 {label} D={d} {str(dtype)[6:]}: {ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB), plain {plain * 1e3:.2f} us, "
            f"index_select {lib * 1e3:.2f} us")
        return dict(ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib, bound_by="bytes")

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
    return results


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gns_torch.ops import segment as seg
        from gns_torch.ops import segment_kernels as kern
    except ImportError as exc:
        fail(f"cannot import gns_torch next to this script: {exc}")
    t_start = time.perf_counter()
    card = phase_device()
    phase_build(kern)
    errs = {"K1": 0.0, "K2": 0.0}
    phase_kernels(kern, seg, errs)
    phase_parity()
    cases, model, cfg, launches, recorded = phase_serving(kern, seg)
    phase_path_inputs(kern, recorded, errs)
    del recorded
    timing = phase_timing(kern, seg, cases, model, cfg, card)
    kernels = []
    meta = {
        "K1": ("segment_sum_csr", "gns_tpu/ops/pallas_segment.py:29"),
        "K2": ("gather_rows", "gns_tpu/ops/pallas_segment.py:45"),
    }
    for k, (name, replaces) in meta.items():
        kernels.append(dict(
            name=f"{k} {name}", route="cuda", source="gns_torch/csrc/segment.cu",
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
