"""Closed-loop serving of the single-phi GNS (a configuration with
`multiple_phi` false): drivers/serve.py's client, window, metrics and
traced part, with the configuration's own seeding and its own reference.

One client sends a request of `request` grids, drawn by the seed from a
pool of `pool` grids made in set-up, to the port's
GNSPredictor(model, cfg, batch_size=`batch`).predict, waits for the numpy
arrays, and sends the next, until the window's seconds have passed.

  serve_grids_per_s  grids returned in the window over the window
  setup_s            process start to the first timed request
  serve_p95_ms       the 95th percentile of the window's request times

Weights (`seed_weights`): harness.seed_weights, then the output layer
(linear4) of L_theta, L_v and L_m times the configuration's
`correction_scale`, given alike to the program and the reference.

A request that raises or returns a non-finite v or theta is failed. Once
the window has closed and the peak memory is read, the program is freed,
reference/gns_ref_1phi.py solves every grid of the pool in float32 and in
float64, and every answer of the window is compared as drivers/serve.py
compares (`compare`): v, theta (in the slack gauge) and last_loss, each in
units of the float32 reference's own widest gap from float64.

Traced (--trace 1): as drivers/serve.py, with the FLOPs of
lib/counts_1phi.py.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from benchmark import harness
from benchmark.drivers.serve import compare
from benchmark.harness import Context, Record, gns_config, reference_model


def seed_weights(ctx: Context, model, device) -> dict:
    """The configuration's weights in `model`, from the context's seed:
    torch.nn.Linear's distribution (harness.seed_weights), then linear4's
    weight and bias of each update head times `correction_scale`. Returns
    a copy by state_dict name, which the reference is given."""
    import torch

    from benchmark.reference.gns_ref_1phi import UPDATES

    harness.seed_weights(model, ctx.seed, device)
    scale = ctx.config["correction_scale"]
    with torch.no_grad():
        for head in UPDATES:
            for block in getattr(model, head):
                block.linear4.weight.mul_(scale)
                block.linear4.bias.mul_(scale)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def reference_answers(ctx: Context, pool, weights, mm_dtype=None, block: int = 256,
                      dtype=None, q1: bool = True) -> dict:
    """The single-phi reference's v, theta (slack gauge) and last_loss of
    every pool grid, in blocks, on the context's device, in `dtype`
    (float32 by default; the weights are cast to it); q1=False: the
    reference without quirk Q1 (a fault)."""
    import torch

    from benchmark.reference import gns_ref_1phi, grids

    dtype = dtype or torch.float32
    model = reference_model(ctx)
    w = {k: t.to(ctx.device, dtype) for k, t in weights.items()}
    out = {"v": [], "theta": [], "last_loss": []}
    with torch.no_grad():
        for lo in range(0, len(pool), block):
            cases = pool[lo:lo + block]
            arrays = grids.stack_cases(cases)
            block_t = tuple(torch.as_tensor(a, device=ctx.device) for a in arrays)
            block_t = tuple(a.to(dtype) for a in block_t[:3]) + block_t[3:]
            res = gns_ref_1phi.forward(w, model, block_t, mm_dtype, q1)
            theta = gns_ref_1phi.decode_theta(res["theta"], grids.slack_angles(cases))
            out["v"].append(res["v"].cpu().numpy())
            out["theta"].append(theta.cpu().numpy())
            out["last_loss"].append(res["last_loss"].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def run(ctx: Context) -> Record:
    import torch

    from gns_torch import serve as serve_mod
    from gns_torch.models.gns import GNS
    from gns_torch.ops import segment_kernels

    from benchmark.lib import counts_1phi
    from benchmark.reference import grids

    t = ctx.traffic
    cfg = gns_config(ctx)
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    pool = grids.make_cases(ctx.grid(), t["pool"], ctx.seed)
    model = GNS(cfg, seed=0, device=device)
    weights = seed_weights(ctx, model, device)
    predictor = serve_mod.GNSPredictor(model, cfg, batch_size=t["batch"], device=device)
    rng = np.random.default_rng(np.random.SeedSequence([int(ctx.seed) % 2**64, 2]))

    spans = launches = None
    events = []
    undo = []
    if ctx.trace:
        from benchmark.lib import trace as tr

        spans = tr.Spans()
        launches = tr.Launches(segment_kernels).install()
        undo.append(launches.uninstall)
        for attr, label in (("batch_from_cases", "pack"), ("extract_shared_topology", "pack"),
                            ("align_slack_angle", "decode")):
            undo.append(tr.wrap(serve_mod, attr, tr.in_span(spans, label)))

        def timed_forward(fn):
            def forward(*args, **kwargs):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with spans("forward"):
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
                events.append((start, end))
                return out
            return forward
        undo.append(tr.wrap(serve_mod, "gns_forward", timed_forward))

    answers, latencies, answered = [], [], []  # answered: each answer's request index
    failed = 0

    def request():
        nonlocal failed
        rows = rng.choice(t["pool"], size=t["request"], replace=False)
        cases = [pool[j] for j in rows]
        t0 = time.perf_counter()
        try:
            if spans is not None:
                with spans("request"):
                    out = predictor.predict(cases)
            else:
                out = predictor.predict(cases)
        except Exception as exc:  # a request that raises is failed, and the run goes on
            print(f"request failed: {exc!r}", file=sys.stderr, flush=True)
            failed += 1
            latencies.append(time.perf_counter() - t0)
            return
        latencies.append(time.perf_counter() - t0)
        if not (np.isfinite(out["v"]).all() and np.isfinite(out["theta"]).all()):
            failed += 1
        answers.append((rows, out))
        answered.append(len(latencies) - 1)

    for _ in range(t["warmup_requests"]):
        request()
    if cuda:
        torch.cuda.synchronize()
    answers.clear()
    latencies.clear()
    answered.clear()
    events.clear()
    failed = 0

    trace = None
    traced = range(0)  # the requests the profiler ran (their times are not the program's)
    traced_s = 0.0  # with the reading of their trace
    start = time.perf_counter()
    setup_s = start - ctx.t0
    while time.perf_counter() - start < ctx.seconds:
        if ctx.trace and trace is None and time.perf_counter() - start >= ctx.seconds / 3:
            from benchmark.lib import trace as tr

            def begin():
                launches.seen.clear()
                launches.armed = True

            first, t_prof = len(latencies), time.perf_counter()
            trace = tr.profile(
                request, t["traced_requests"],
                lambda device_acts: tr.count_kernels(device_acts, tr.K1_KERNELS, tr.K2_KERNELS)
                == len(launches.seen), before=begin)
            launches.armed = False
            traced = range(first, len(latencies))
            traced_s = time.perf_counter() - t_prof
        else:
            request()
    window_s = time.perf_counter() - start
    for fn in reversed(undo):
        fn()

    grids_done = sum(len(rows) for rows, _ in answers)
    untraced = sum(len(rows) for (rows, _), i in zip(answers, answered) if i not in traced)
    rec = Record(
        kind="serve",
        e2e={"serve_grids_per_s": grids_done / window_s, "setup_s": setup_s,
             "serve_p95_ms": 1e3 * float(np.percentile(latencies, 95))},
        attempted=len(latencies), failed=failed, checks={},
        memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
        window_s=window_s - traced_s,
        flops=untraced * counts_1phi.forward_flops(
            ctx.model(), len(pool[0]["bus"]), len(pool[0]["branch"])),
        spans=spans, units=len(latencies),
        forward_ms=[s.elapsed_time(e) for s, e in events] if cuda and events else [],
        launches=launches.seen if launches is not None else [],
        trace=trace,
    )
    del predictor, model
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref32 = reference_answers(ctx, pool, weights)
    ref64 = reference_answers(ctx, pool, weights, dtype=torch.float64)
    rec.checks = {name: {"value": value, "limit": ctx.limits[name]}
                  for name, value in compare(answers, ref32, ref64).items()}
    rec.detail = {"reference": ref32, "reference64": ref64, "weights": weights}
    return rec
