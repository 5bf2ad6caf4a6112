"""Chip smoke test of the PyTorch + CUDA port (fedmse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card. It
builds the CUDA kernels from fedmse_tpu_torch/csrc (one nvcc per source,
all started together, into build/fedmse_tpu_torch/), then:

  1. device     prints the card (nvidia-smi name and power limit), torch and
                CUDA versions and the kernels' build time;
  2. kernels    holds each kernel (the fused forward, the fused train step
                and the kNN distance tiles) against its plain PyTorch
                version on the card, at every listed shape and dtype (the
                forward under client-major, routed and single-model
                layouts; the forward and the train step also against a
                second call, bit for bit, and as exactly one CUDA kernel
                per call, their f32 cases on dyadic grids; the distance
                tiles' cases include the evaluation's shape, whose rows
                phase 3 then checks: each also bit-equal to a second
                call, one CUDA kernel per call in f32 and bf16, routed
                rows the client-major rows' bits);
  3. evaluate   per-client AUC of both model types in f32 and bf16 over a
                10-gateway synthetic federation at the paper's width
                (115 -> 27 -> 7), ~70k rows per evaluation, with the
                model's own score and with the kNN score (512-slot banks,
                k = 8, exact and approximate top-k);
  4. serve      ServingEngine.from_federation -> fit_calibration ->
                MicroBatcher over >= 8192 interleaved rows (scores held to
                the evaluator's oracle), then a 512-gateway engine with
                gather routing scoring 1024-row buckets; the same for the
                kNN score, plus a ContinuousBatcher stream with a
                build_banks(existing=...) bank swap in its middle;
  5. train      main.run_combination on the same federation with the
                quick-run schedule (3 rounds, 5 epochs, batch 12, 50%
                participation) on the driver's default path, the fused,
                pipelined schedule (each round's bodies CUDA graphs
                captured once per engine and replayed): all six
                combinations in f32 and hybrid / mse_avg in bf16; the
                trained hybrid checkpoint is then
                served by ServingEngine.from_checkpoint and held to the
                evaluator's oracle, and run through the CLI's --serve
                pass (serving.run_serve_smoke) with the kNN score and the
                continuous front, three times cold and once warm, after
                one forced full collection timed with and without the
                gc.freeze() the pass holds over its stream;
     orders     (after the main path) hybrid / mse_avg again in both
                dtypes at 4, 2 and 1 CTAs per client: bf16 is held to f32
                on the mean final AUC over the four summation orders;
     fused-hold the fused round held to the per-phase round from one
                init, cohort and data, tie-break off (hybrid / mse_avg
                and autoencoder / fedprox in f32, hybrid / mse_avg in
                bf16, one kNN-scored round): states and round results
                within 1e-6 scale-normalized, and a second fused round
                from the same state (a replay) the first's bits;
  6. card-cpu   one combination's first round, cut to one epoch, on the
                card and on the CPU (the plain versions) from one init;
  7. report     kernel time (per wrapper call by CUDA events, and the
                kernel's own device time by torch.profiler), plain-version
                time, library time where one PyTorch call computes the
                same function, and bound at the main path's shapes (the
                forward also at the training path's own launches; the
                distance kernel beside its predecessor, built from
                csrc/dist_tiles_baseline.cu, whose bits it reproduces, and
                inside the kNN score it starts, with a one-element fill
                as the floor of a launch), and
                one more training round on each path, fused and
                per-phase, timed and under the profiler (wall, device
                busy share, device ms per train step; for the fused round
                its host reads, graph replays, capture seconds and nodes),
                and 12 fused rounds in chunks of 2 with the chunk loop
                pipelined and serial (--no-pipeline): wall per round,
                the same final bits.

PERF.md's speed limits (served rows/s, verdict p99, round wall) are logged
as "[watch]" lines beside their limits and listed under "watched" in the
kernels line; they are not asserted (host-clock rates move 35-80% between
calls on the same code).

Phases 3 to 5 are the main path: the kernels' launch counters are set to 0
just before them and read just after, and each kernel must have launched
there. A launch inside a replayed CUDA graph counts: each graph keeps the
kernels it captured, and each replay adds them (ops/graphs.py). Prints,
as its last three lines, the card's name and power limit, one JSON line
of kernel numbers, and {"ok": true, "device": {...}}. Any
failure raises and exits non-zero with no result line; so does a machine
without CUDA.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DIMS = (115, 27, 7)  # the paper's width: ExperimentConfig's defaults
# scale-normalized tolerances (max |kernel - plain| / max |plain| per output)
# f32: the kernel and the plain version differ in summation order only.
# bf16: activations round to bf16 between layers; a last-bit difference in
# an f32 sum can round an activation one bf16 ulp (2**-8 relative) the
# other way, and four ulps cover such a flip carried through later layers.
TOL = {"f32": 1e-5, "bf16": 2.0 ** -6}
# the distance kernel's math is f32 in both dtypes (bf16 queries upcast
# exactly): summation order only
DIST_TOL = 1e-5
KNN = dict(knn_bank_size=512, knn_k=8)  # ExperimentConfig's kNN defaults
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


# PERF.md section 2's speed limits. They are watched, not asserted: these
# rates and latencies are taken on the host's clock, which moves them by
# 35-80% between calls on the same code (a one-card machine shares its
# host's cores), so a limit would fail on a slow host, not on slow code.
WATCHED = []


def watched(what: str, value: float, limit: float, at_least: bool) -> None:
    """Log a watched value beside its limit and keep it for the report."""
    within = value >= limit if at_least else value <= limit
    WATCHED.append({"what": what, "value": value, "limit": limit,
                    "at_least": at_least, "within": within})
    log(f"[watch] {what}: {value:.6g}, watched limit "
        f"{'>=' if at_least else '<='} {limit:g} "
        f"({'within' if within else 'outside'}; not asserted)")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def scaled_err(got, want) -> float:
    if want.numel() == 0:
        return 0.0
    diff = (got.double() - want.double()).abs().max().item()
    return diff / max(want.double().abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` calls after a warm-up,
    by CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds per call of the CUDA kernels whose name
    contains `kernel`, from torch.profiler over `reps` calls (the kernel's
    own time, without the host's time between launches); NaN when the
    profiler records no device time in two tries (it has dropped a whole
    window's device events once on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(_device_us(e) for e in prof.key_averages()
                    if kernel in e.key)
        if total > 0:
            return total / 1e3 / reps
    return float("nan")


def all_device_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call of every CUDA kernel and copy that
    fn() runs, from torch.profiler over `reps` calls; NaN when the profiler
    records no device event in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return float("nan")


def json_line(obj) -> str:
    """One line of strict JSON: a number that is not finite (a device time
    the profiler did not record) becomes null."""
    def clean(v):
        if isinstance(v, float) and not np.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(obj))


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value:
            return float(value)
    return 0.0


def bound(rows: int, models: int, precision: str, dims=DIMS):
    """Least time (ms) for the fused forward's work on an H100: FLOPs of the
    four matmuls over the peak for the input type, or the bytes it must
    move (x, model index and outputs once, every used model's weights once)
    over HBM bandwidth, whichever is larger."""
    d, h, lat = dims
    esize = 2 if precision == "bf16" else 4
    macs = d * h + h * lat + lat * h + h * d
    flops = 2.0 * macs * rows
    nbytes = (rows * (d * esize + 4 + 4 * (lat + 2))
              + min(models, rows) * (macs * esize + 4 * (2 * h + lat + d)))
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def random_params(torch, g, d, h, lat, gen, device, cdt):
    from fedmse_tpu_torch.ops.precision import cast_params

    def dense(i, o):
        return {"kernel": (torch.rand((g, i, o), generator=gen) * 2 - 1)
                / i ** 0.5,
                "bias": torch.randn((g, o), generator=gen) * 0.1}
    tree = {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


def grid_params(torch, g, d, h, lat, gen, device, cdt):
    """Stacked forward params with weights and biases in Z/16, |v| <= 1/4:
    with x in Z/4, |x| <= 1.5, every sum of the forward up to its last ReLU
    gate is exact in f32 at widths up to the paper's, whatever its order."""
    from fedmse_tpu_torch.ops.precision import cast_params

    def grid(shape):
        return torch.randint(-4, 5, shape, generator=gen) / 16.0

    def dense(i, o):
        return {"kernel": grid((g, i, o)), "bias": grid((g, o))}
    tree = {"encoder": {"Dense_0": dense(d, h), "Dense_1": dense(h, lat)},
            "decoder": {"Dense_0": dense(lat, h), "Dense_1": dense(h, d)}}
    return {c: {n: {k: v.to(device) for k, v in layer.items()}
                for n, layer in coder.items()}
            for c, coder in cast_params(tree, cdt).items()}


def forward_index(torch, kind, g, rows, gen, device):
    """A forward launch's model index: None (every row model 0),
    client-major (the evaluator's, the vote's and validation's layout: g
    equal runs, boundaries mid-tile where rows / g is not a multiple of the
    tile) or random (a routed serving bucket)."""
    if kind == "none":
        return None
    if kind == "client_major":
        idx = torch.arange(g, dtype=torch.int32).repeat_interleave(
            -(-rows // g))[:rows]
    else:
        idx = torch.randint(0, g, (rows,), generator=gen, dtype=torch.int32)
    return idx.to(device)


def phase_kernels(torch, device):
    """The forward kernel vs its plain version at every listed shape, dtype
    and index layout, each case also bit-equal to a second call; then one
    CUDA kernel per call at the main path's shapes.

    The f32 cases run on dyadic grids (grid_params, x in Z/4): with
    arbitrary floats a pre-activation within rounding of 0 takes its ReLU
    gate one way in one summation order and the other way in another (a
    tie of the function, PR 5); on the grids every gate is decided exactly.
    The bf16 cases keep arbitrary floats; their tolerance covers a flipped
    bf16 rounding between layers."""
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain)
    gen = torch.Generator().manual_seed(SEED)
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    checked = 0
    # (dims, models, rows, index kinds): a grid of both widths, every row
    # count under random routing (G = 512, R = 1024 is the 512-gateway
    # serving bucket) and, in turn, client-major or no index; then the main
    # path's own launches, client-major at the paper's width: the
    # evaluation (10 x 7,008 rows: 64-row tiles, boundaries mid-tile),
    # validation (5 x 1,008), the vote (10 x 1,000), mse_avg's dev scoring
    # (5 x 40,000), and a 1,001-row client layout with a partial last tile
    cases = [(dims, g, rows, ("random", ("client_major", "none")[i % 2]))
             for dims in (DIMS, (37, 9, 3)) for g in (1, 10, 512)
             for i, rows in enumerate((0, 1, 7, 256, 1024, 70_000))]
    cases += [(DIMS, 10, 70_080, ("client_major", "random")),
              (DIMS, 5, 5_040, ("client_major",)),
              (DIMS, 10, 10_000, ("client_major",)),
              (DIMS, 5, 200_000, ("client_major",)),
              (DIMS, 3, 3_003, ("client_major",)),
              ((128, 128, 126), 2, 4_100, ("client_major", "random"))]
    for dims, g, rows, case_kinds in cases:
        for precision, cdt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
            if precision == "f32":
                params = grid_params(torch, g, *dims, gen, device, cdt)
                x = (torch.randint(-6, 7, (rows, dims[0]), generator=gen)
                     / 4.0).to(device)
            else:
                params = random_params(torch, g, *dims, gen, device, cdt)
                x = (torch.randn((rows, dims[0]), generator=gen)
                     * 1.5).to(device=device, dtype=cdt)
            for kind in case_kinds:
                idx = forward_index(torch, kind, g, rows, gen, device)
                got = fused_forward_stats(params, x, idx, compute_dtype=cdt)
                again = fused_forward_stats(params, x, idx,
                                            compute_dtype=cdt)
                want = fused_forward_stats_plain(params, x, idx,
                                                 compute_dtype=cdt)
                torch.cuda.synchronize()
                what = f"dims={dims} {precision} G={g} R={rows} {kind}"
                for name, a, a2, b in zip(("latent", "mse", "znorm"),
                                          got, again, want):
                    if a.shape != b.shape or a.dtype != torch.float32:
                        raise AssertionError(f"{name} shape/dtype "
                                             f"{a.shape} {a.dtype}")
                    if rows and not torch.isfinite(a).all():
                        raise AssertionError(f"{name} not finite {what}")
                    if not torch.equal(a.view(torch.int32),
                                       a2.view(torch.int32)):
                        raise AssertionError(f"forward kernel {what}: two "
                                             f"calls differ in {name}")
                    err = scaled_err(a, b)
                    if err > TOL[precision]:
                        raise AssertionError(
                            f"kernel vs plain {name} {what}: scaled error "
                            f"{err:.3e} > {TOL[precision]:.1e}")
                    w = worst[precision]
                    w["scaled"] = max(w["scaled"], err)
                    if rows:
                        w["abs"] = max(w["abs"], (a - b).abs().max()
                                       .item())
                checked += 1
    for g, rows, kind, cdt in ((10, 70_080, "client_major", torch.float32),
                               (10, 70_080, "client_major", torch.bfloat16),
                               (10, 256, "random", torch.float32),
                               (512, 1024, "random", torch.float32)):
        params = random_params(torch, g, *DIMS, gen, device, cdt)
        x = torch.randn((rows, DIMS[0]), generator=gen).to(device, cdt)
        idx = forward_index(torch, kind, g, rows, gen, device)
        names = cuda_kernels(torch, lambda: fused_forward_stats(
            params, x, idx, compute_dtype=cdt))
        if len(names) != 1 or "fused_ae_forward_kernel" not in names[0]:
            raise AssertionError(f"one forward at G={g} R={rows} ran "
                                 f"{names}, not one fused_ae_forward_kernel")
    log(f"[kernels] {checked} kernel-vs-plain cases agree, each bitwise "
        f"equal to a second call; one CUDA kernel per call at the "
        f"evaluation and both serving buckets; worst {json.dumps(worst)}")
    return worst


def train_flops_per_row(dims=DIMS) -> int:
    """Forward 2(DH + HL + LH + HD) plus backward 2(2HD + 2LH + 2HL + DH)."""
    d, h, lat = dims
    return 2 * (d * h + h * lat + lat * h + h * d) \
        + 2 * (2 * h * d + 2 * lat * h + 2 * h * lat + d * h)


def train_bound(rows: int, clients: int, precision: str, dims=DIMS):
    """Least time (ms) for the fused train step's work on an H100: its
    FLOPs over the peak for the input type, or the bytes it must move (x
    and the mask once, each client's f32 parameters read once and its P
    f32 gradients and its loss written once) over HBM bandwidth."""
    d, h, lat = dims
    esize = 2 if precision == "bf16" else 4
    p = 2 * d * h + 2 * h * lat + 2 * h + lat + d
    flops = float(train_flops_per_row(dims)) * rows * clients
    nbytes = clients * (rows * (d * esize + 4) + 4 * p + 4 * (p + 1))
    t_ops, t_bytes = flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def random_flat(torch, layout, g, gen, device):
    """[G, P] f32 parameters: U(+-1/sqrt(fan_in)) kernels, N(0, 0.1) biases."""
    flat = torch.empty((g, layout.size))
    for sl, (path, _, shape) in zip(layout.slices(), layout.leaves()):
        n = sl.stop - sl.start
        if path[-1] == "kernel":
            flat[:, sl] = (torch.rand((g, n), generator=gen) * 2 - 1) \
                / shape[0] ** 0.5
        else:
            flat[:, sl] = torch.randn((g, n), generator=gen) * 0.1
    return flat.to(device)


def cuda_kernels(torch, fn) -> list:
    """Names of the CUDA kernels (and copies) that one call of fn() runs on
    the card, by torch.profiler, after a warm-up call. A window with no
    device event at all is taken again, up to three tries: the profiler
    has dropped a whole window's device events on an H100, and a call
    that launches nothing is still an empty list after the third."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def grid_inputs(torch, layout, g, rows, gen, device):
    """[G, P] parameters in Z/16 with |v| <= 1/4 and x [G, R, D] in Z/4 with
    |x| <= 1.5, f32: on these grids every sum of the forward up to the ReLU
    gates is exact in f32 whatever its order, so two correct summation
    orders decide every gate alike."""
    flat = torch.randint(-4, 5, (g, layout.size), generator=gen) / 16.0
    x = torch.randint(-6, 7, (g, rows, layout.dim), generator=gen) / 4.0
    return flat.to(device), x.to(device)


def phase_train_kernels(torch, device):
    """The train kernel vs its plain version: G in {1, 5, 133, 512} (8, 8, 1
    and 1 CTAs per client at H = 27), R in {0, 1, 12, 129, 200, 1008} (every
    R one launch: the cluster walks its row tiles), widths 115/27/7 and
    37/9/3 (hidden units split unevenly over the CTAs) and 16/3/2 (H < 8:
    clusters of 3), both dtypes, lambda in {0, 10}, with masked rows and
    (G > 1) an all-masked client, whose loss and grads must be NaN on both.
    Every case runs the kernel twice and the two results must be equal bit
    for bit; one call at the main path's step and at 1,008 rows must run
    exactly one CUDA kernel.

    The f32 cases run on grid_inputs. With arbitrary floats a pre-activation
    within rounding of 0 takes its ReLU gate one way in one summation order
    and the other way in another, and moves the gradients by ~1e-3 (seen at
    G = 512, R = 1,008: 28M gates): a tie of the function, which neither
    order gets wrong. On the grids the forward is exact and the gates agree,
    so 1e-5 holds what it is meant to hold, the backward's rounding. The
    bf16 cases keep arbitrary floats, so that the weights' rounding at load
    is exercised; their tolerance covers a flipped gate."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    checked = 0
    for dims in (DIMS, (37, 9, 3), (16, 3, 2)):
        layout = ParamLayout(*dims)
        for precision, cdt in (("f32", torch.float32),
                               ("bf16", torch.bfloat16)):
            for g in (1, 5, 133, 512):
                for rows in (0, 1, 12, 129, 200, 1008):
                    if precision == "f32":
                        flat, x = grid_inputs(torch, layout, g, rows, gen,
                                              device)
                    else:
                        flat = random_flat(torch, layout, g, gen, device)
                        x = (torch.randn((g, rows, dims[0]), generator=gen)
                             * 1.5).to(device=device, dtype=cdt)
                    m = (torch.rand((g, rows), generator=gen) < 0.85).float()
                    if g > 1:
                        m[-1] = 0.0
                    m = m.to(device)
                    for lam in (0.0, 10.0):
                        kw = dict(layout=layout, shrink_lambda=lam,
                                  compute_dtype=cdt)
                        got = fused_train_grads(flat, x, m, **kw)
                        again = fused_train_grads(flat, x, m, **kw)
                        want = fused_train_grads_plain(flat, x, m, **kw)
                        torch.cuda.synchronize()
                        what = (f"dims={dims} {precision} G={g} R={rows} "
                                f"lam={lam}")
                        for a, b in zip(got, again):
                            if not torch.equal(a.view(torch.int32),
                                               b.view(torch.int32)):
                                raise AssertionError(f"train kernel {what}: "
                                                     "two calls differ")
                        live = m.sum(dim=1) > 0
                        for name, a, b in zip(("loss", "grads"), got, want):
                            if a.dtype != torch.float32 or a.shape != b.shape:
                                raise AssertionError(f"train {name} shape/"
                                                     f"dtype {a.shape}")
                            if not (torch.isnan(a[~live]).all()
                                    and torch.isnan(b[~live]).all()):
                                raise AssertionError(
                                    f"train {name}: an all-masked client "
                                    "must give NaN")
                            a, b = a[live], b[live]
                            if not torch.isfinite(a).all():
                                raise AssertionError(f"train {name} not "
                                                     "finite")
                            err = scaled_err(a, b)
                            if err > TOL[precision]:
                                raise AssertionError(
                                    f"train kernel vs plain {name} {what}: "
                                    f"scaled error {err:.3e} > "
                                    f"{TOL[precision]:.1e}")
                            w = worst[precision]
                            w["scaled"] = max(w["scaled"], err)
                            if a.numel():
                                w["abs"] = max(w["abs"], (a - b).abs().max()
                                               .item())
                        checked += 1
    layout = ParamLayout(*DIMS)
    for g, rows in ((5, 12), (1, 1008)):
        flat = random_flat(torch, layout, g, gen, device)
        x = torch.randn((g, rows, DIMS[0]), generator=gen).to(device)
        m = torch.ones((g, rows), device=device)
        names = cuda_kernels(torch, lambda: fused_train_grads(
            flat, x, m, layout=layout, shrink_lambda=10.0))
        if len(names) != 1 or "fused_ae_train_kernel" not in names[0]:
            raise AssertionError(f"one train step at G={g} R={rows} ran "
                                 f"{names}, not one fused_ae_train_kernel")
    log(f"[kernels] {checked} train-kernel-vs-plain cases agree, each "
        f"bitwise equal to a second call; one CUDA kernel per call at "
        f"R = 12 and 1008; worst {json.dumps(worst)}")
    return worst


def dist_bound(rows: int, bank: int, banks_read: int, lat: int = DIMS[2]):
    """Least time (ms) for the distance tiles on an H100: the cross term's
    2 L T B f32 FLOPs over the f32 peak, or the bytes (the [T, B] f32
    output written once, q [T, L] and the bank index [T] read once, each
    distinct bank [B, L] read once) over HBM bandwidth."""
    flops = 2.0 * lat * rows * bank
    nbytes = 4.0 * (rows * bank + rows * (lat + 1) + banks_read * bank * lat)
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main_dist_shapes(eval_rows):
    """(what, banks N, rows T, bank-index kind) of the distance launches on
    the main path, each against 512-slot banks at L = 7."""
    return (("evaluate, 10 gateways", 10, eval_rows, "client_major"),
            ("serve bucket, 10 gateways", 10, 256, "random"),
            ("serve bucket, 512 gateways gather", 512, 1024, "random"))


def dist_inputs(torch, n, rows, bank, lat, gw_kind, gen, device, cdt):
    """Queries (bf16 or f32), f32 banks with ragged zeroed tails, and the
    bank index: absent, client-major (the evaluator's) or random (a
    serving bucket's)."""
    q = (torch.randn((rows, lat), generator=gen) * 1.5).to(device, cdt)
    banks = torch.randn((n, bank, lat), generator=gen)
    count = torch.randint(0, bank + 1, (n,), generator=gen)
    banks[torch.arange(bank)[None, :] >= count[:, None]] = 0.0
    gw = None
    if gw_kind == "client_major":
        gw = torch.arange(n, dtype=torch.int32).repeat_interleave(
            -(-rows // n))[:rows]
    elif gw_kind == "random":
        gw = torch.randint(0, n, (rows,), generator=gen, dtype=torch.int32)
    return q, banks.to(device), None if gw is None else gw.to(device)


def dist_check(torch, q, banks, gw, what):
    """One distance launch against its plain version on the same inputs;
    raises past DIST_TOL. Returns (kernel output, abs error, scaled
    error)."""
    from fedmse_tpu_torch.knn.score import dist_tiles, dist_tiles_plain
    got = dist_tiles(q, banks, gw)
    want = dist_tiles_plain(q, banks, gw)
    torch.cuda.synchronize()
    if got.shape != (q.shape[0], banks.shape[1]) or \
            got.dtype != torch.float32:
        raise AssertionError(f"dist {what}: shape/dtype {got.shape}")
    if not torch.isfinite(got).all() or (got < 0).any():
        raise AssertionError(f"dist {what}: distances not finite and >= 0")
    err = scaled_err(got, want)
    if err > DIST_TOL:
        raise AssertionError(f"dist kernel vs plain {what}: scaled error "
                             f"{err:.3e} > {DIST_TOL:.1e}")
    return got, (got - want).abs().max().item(), err


def phase_dist_kernels(torch, device, eval_rows):
    """The distance kernel vs its plain version: every (N, T, B) of N in
    {1, 10, 512}, T in {1, 17, 256, 1024, 30000}, B in {1, 8, 100, 512,
    1024}, cycling through f32 / bf16 queries, the three bank-index kinds
    and L in {7, 3, 16} (16 takes the kernel's streamed path), then the
    main path's three shapes at L = 7 in both dtypes: the evaluation
    (`eval_rows` client-major rows, 10 banks of 512) and the serving
    buckets (256 rows over 10 banks, 1024 rows over 512 banks, random
    routing). 81 cases, each also bit-equal to a second call. Then, at the
    main path's shapes in both dtypes, one CUDA kernel per call (bf16
    queries are upcast inside it), and the evaluation's rows permuted with
    their bank index (each row then loads its bank, as a routed bucket's
    does) give the client-major rows' bits."""
    from fedmse_tpu_torch.knn.score import dist_tiles
    gen = torch.Generator().manual_seed(SEED + 6)
    kinds = ("none", "client_major", "random")
    cases = []
    for n in (1, 10, 512):
        for rows in (1, 17, 256, 1024, 30_000):
            for bank in (1, 8, 100, 512, 1024):
                i = len(cases)
                cases.append((n, rows, bank, (7, 3, 16)[(i // 6) % 3],
                              ("f32", "bf16")[i % 2], kinds[(i // 2) % 3]))
    for _, n, rows, gw_kind in main_dist_shapes(eval_rows):
        for precision in ("f32", "bf16"):
            cases.append((n, rows, KNN["knn_bank_size"], DIMS[2], precision,
                          gw_kind))
    worst = {p: {"abs": 0.0, "scaled": 0.0} for p in TOL}
    for n, rows, bank, lat, precision, gw_kind in cases:
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        q, banks, gw = dist_inputs(torch, n, rows, bank, lat, gw_kind, gen,
                                   device, cdt)
        what = (f"N={n} T={rows} B={bank} L={lat} {precision} "
                f"gw={gw_kind}")
        got, abs_err, err = dist_check(torch, q, banks, gw, what)
        if not torch.equal(dist_tiles(q, banks, gw).view(torch.int32),
                           got.view(torch.int32)):
            raise AssertionError(f"dist {what}: a second call differs")
        w = worst[precision]
        w["scaled"] = max(w["scaled"], err)
        w["abs"] = max(w["abs"], abs_err)
    for what, n, rows, gw_kind in main_dist_shapes(eval_rows):
        for cdt in (torch.float32, torch.bfloat16):
            q, banks, gw = dist_inputs(torch, n, rows, KNN["knn_bank_size"],
                                       DIMS[2], gw_kind, gen, device, cdt)
            ran = cuda_kernels(torch, lambda: dist_tiles(q, banks, gw))
            if len(ran) != 1 or "dist_tiles" not in ran[0]:
                raise AssertionError(f"dist {what} {cdt}: one call ran "
                                     f"{ran}")
            if gw_kind != "client_major":
                continue
            perm = torch.randperm(rows, generator=gen).to(device)
            routed = dist_tiles(q[perm].contiguous(), banks,
                                gw[perm].contiguous())
            if not torch.equal(routed.view(torch.int32),
                               dist_tiles(q, banks, gw)[perm]
                               .view(torch.int32)):
                raise AssertionError(f"dist {what} {cdt}: routed rows "
                                     "differ from client-major rows")
    log(f"[kernels] {len(cases)} dist-kernel-vs-plain cases agree, each "
        f"bitwise equal to a second call; one CUDA kernel per call in f32 "
        f"and bf16 at the main path's shapes; routed = client-major bits "
        f"at the evaluation; worst {json.dumps(worst)}")
    return worst


def phase_evaluate(torch, device, cfg, clients):
    """Both model types x both precisions over the 10-gateway federation,
    each with its own score and with the kNN score (exact and approximate
    top-k); every kNN evaluation is one distance launch."""
    from fedmse_tpu_torch.data import stack_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.knn import dist_tiles
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    dev_x = np.concatenate([c.dev_raw[:100] for c in clients]).astype(
        np.float32)
    results, knn_report = {}, {}
    for model_type in ("autoencoder", "hybrid"):
        aucs = {}
        for precision in ("f32", "bf16"):
            model = make_model(model_type, *DIMS,
                               shrink_lambda=cfg.shrink_lambda,
                               precision=precision, device=device)
            params = init_stacked_params(
                model, len(clients), torch.Generator().manual_seed(SEED),
                device=device)
            data = stack_clients(clients, dev_x, cfg.batch_size,
                                 dtype=model.compute_dtype, device=device)
            args = (data.test_x, data.test_m, data.test_y, data.train_xb,
                    data.train_mb)
            for score in ("own", "knn/exact", "knn/approx"):
                kw = ({} if score == "own" else
                      dict(score_kind="knn", knn_topk=score[4:], **KNN))
                before = fused_forward_stats.launches
                before_dist = dist_tiles.launches
                t0 = time.perf_counter()
                auc = make_evaluate_all(model, model_type, **kw)(params,
                                                                 *args)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launched = fused_forward_stats.launches - before
                dist_launched = dist_tiles.launches - before_dist
                if launched < 1:
                    raise AssertionError("evaluation did not launch the "
                                         "kernel")
                if dist_launched != (0 if score == "own" else 1):
                    raise AssertionError(f"{score} evaluation launched the "
                                         f"distance kernel {dist_launched}"
                                         " times")
                if auc.shape != (len(clients),) or \
                        not torch.isfinite(auc).all():
                    raise AssertionError(f"AUC not finite: {auc}")
                aucs[(score, precision)] = auc.cpu().numpy()
                rows = data.test_x.shape[0] * (
                    data.test_x.shape[1]
                    + (data.train_xb.shape[1] * data.train_xb.shape[2]
                       if model_type == "hybrid" or score != "own" else 0))
                log(f"[evaluate] {model_type} {score} {precision}: "
                    f"{launched} forward + {dist_launched} distance "
                    f"launch(es) over {rows} rows in {secs * 1e3:.3f} ms; "
                    f"per-client AUC "
                    f"{np.round(aucs[(score, precision)], 6).tolist()}")
                if score != "own":
                    knn_report[f"{model_type}/{score}/{precision}"] = {
                        "ms": secs * 1e3,
                        "mean_auc": float(aucs[(score, precision)].mean()),
                        "test_rows": int(data.test_x.shape[0]
                                         * data.test_x.shape[1])}
                if precision == "f32":
                    check_card_vs_cpu(torch, device, model, model_type,
                                      params, args, kw)
            if precision == "f32":
                results[model_type] = (model, params, data)
        for score in ("own", "knn/exact", "knn/approx"):
            delta = np.abs(aucs[(score, "bf16")]
                           - aucs[(score, "f32")]).max()
            log(f"[evaluate] {model_type} {score}: max |AUC bf16 - AUC f32|"
                f" = {delta:.3e}")
            if delta > 2e-3:
                raise AssertionError(f"{model_type} {score}: bf16 AUC off "
                                     f"f32 by {delta:.3e} > 2e-3")
    return results, knn_report


def check_card_vs_cpu(torch, device, model, model_type, params, args, kw):
    """The same evaluation on the CPU (the plain path) agrees on a small
    slice: 2 clients, 200 test rows each, their train rows."""
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    cpu = lambda t: t[:2, :200].cpu()  # noqa: E731
    small = [cpu(t) for t in args[:3]] + \
        [args[3][:2].cpu(), args[4][:2].cpu()]
    fn = make_evaluate_all(model, model_type, metric="scores", **kw)
    on_card = fn(params, *(t.to(device) for t in small)).cpu()
    on_cpu = fn({c: {n: {k: v.cpu() for k, v in layer.items()}
                     for n, layer in coder.items()}
                 for c, coder in params.items()}, *small)
    err = scaled_err(on_card, on_cpu)
    if err > TOL["f32"]:
        raise AssertionError(f"card vs CPU scores {kw}: {err:.3e}")


def phase_serve(torch, device, cfg, evaluated, smi):
    """10-gateway micro-batched serving, then 512 gateways with gather
    routing at 1024-row buckets; scores held to the evaluator's oracle."""
    from fedmse_tpu_torch.data import stack_clients, synthetic_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.serving import (MicroBatcher, ServingEngine,
                                          fit_calibration, interleave_order)
    report = {}
    for model_type, (model, params, data) in evaluated.items():
        before = fused_forward_stats.launches
        oracle = make_evaluate_all(model, model_type, metric="scores")(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu().numpy()
        engine = ServingEngine.from_federation(
            model, model_type, params, data.train_xb, data.train_mb,
            max_bucket=cfg.serve_max_batch, device=device)
        calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                                data.valid_m.cpu().numpy())
        engine.warmup()
        test_x = data.test_x.cpu().numpy()
        gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
        rows = test_x[gws, ridx]
        batcher = MicroBatcher(engine, max_batch=cfg.serve_max_batch,
                               max_wait_ms=cfg.serve_latency_budget_ms,
                               calibration=calib)
        t0 = time.perf_counter()
        tickets = [batcher.submit(rows[i], int(gws[i]))
                   for i in range(len(rows))]
        batcher.drain()
        wall = time.perf_counter() - t0
        if len(tickets) < 8192 or not all(t.done for t in tickets):
            raise AssertionError("not every ticket was served")
        served = np.array([t.score for t in tickets], np.float32)
        want = oracle[gws, ridx]
        err = float(np.max(np.abs(served - want)
                           / np.maximum(1.0, np.abs(want))))
        if err > TOL["f32"]:
            raise AssertionError(f"{model_type} served scores off the "
                                 f"evaluator oracle by {err:.3e}")
        launched = fused_forward_stats.launches - before
        st = batcher.stats()
        report[f"serve10_{model_type}"] = {
            "rows": len(tickets), "rows_per_s": len(tickets) / wall,
            "latency_p50_ms": st["latency_p50_ms"],
            "latency_p99_ms": st["latency_p99_ms"],
            "dispatches": st["dispatches"], "launches": launched,
            "max_err_vs_oracle": err}
        log(f"[serve] {model_type} 10 gateways on {smi}: {len(tickets)} rows "
            f"in {st['dispatches']} buckets, {len(tickets) / wall:.1f} rows/s"
            f", latency p50 {st['latency_p50_ms']:.4f} ms p99 "
            f"{st['latency_p99_ms']:.4f} ms, {launched} launches, max err "
            f"vs oracle {err:.3e}")
        watched(f"rows/s, 10 gateways, {model_type}", len(tickets) / wall,
                1e5, True)
        watched(f"verdict p99 ms, 10 gateways, {model_type}",
                st["latency_p99_ms"], 4.0, False)

    clients = synthetic_clients(n_clients=512, dim=DIMS[0], n_normal=100,
                                n_abnormal=40, seed=SEED + 1)
    for model_type in ("autoencoder", "hybrid"):
        model = make_model(model_type, *DIMS,
                           shrink_lambda=cfg.shrink_lambda, device=device)
        params = init_stacked_params(
            model, 512, torch.Generator().manual_seed(SEED + 1),
            device=device)
        data = stack_clients(clients, np.zeros((1, DIMS[0]), np.float32),
                             cfg.batch_size, device=device)
        before = fused_forward_stats.launches
        oracle = make_evaluate_all(model, model_type, metric="scores")(
            params, data.test_x, data.test_m, data.test_y, data.train_xb,
            data.train_mb).cpu().numpy()
        engine = ServingEngine.from_federation(
            model, model_type, params, data.train_xb, data.train_mb,
            max_bucket=1024, routing="gather", device=device)
        engine.warmup()
        test_x = data.test_x.cpu().numpy()
        gws, ridx = interleave_order(data.test_m.cpu().numpy(), 1 << 30)
        rows = test_x[gws, ridx]
        served = np.empty(len(rows), np.float32)
        bucket_s = []
        for s in range(0, len(rows), 1024):
            t0 = time.perf_counter()
            served[s:s + 1024] = engine.score(rows[s:s + 1024],
                                              gws[s:s + 1024])
            bucket_s.append(time.perf_counter() - t0)
        want = oracle[gws, ridx]
        err = float(np.max(np.abs(served - want)
                           / np.maximum(1.0, np.abs(want))))
        if err > TOL["f32"] or not np.isfinite(served).all():
            raise AssertionError(f"512-gateway {model_type} scores off the "
                                 f"oracle by {err:.3e}")
        launched = fused_forward_stats.launches - before
        ms = np.array(bucket_s) * 1e3
        report[f"serve512_{model_type}"] = {
            "rows": len(rows), "buckets": len(bucket_s),
            "rows_per_s": len(rows) / sum(bucket_s),
            "bucket_p50_ms": float(np.percentile(ms, 50)),
            "bucket_p99_ms": float(np.percentile(ms, 99)),
            "launches": launched, "max_err_vs_oracle": err}
        log(f"[serve] {model_type} 512 gateways gather on {smi}: "
            f"{len(rows)} rows in {len(bucket_s)} buckets of 1024, "
            f"{len(rows) / sum(bucket_s):.1f} rows/s, bucket p50 "
            f"{np.percentile(ms, 50):.4f} ms p99 {np.percentile(ms, 99):.4f}"
            f" ms, {launched} launches, max err vs oracle {err:.3e}")
        watched(f"rows/s, 512 gateways, {model_type}", len(rows)
                / sum(bucket_s), 1e6, True)
    return report


def phase_serve_knn(torch, device, cfg, evaluated, smi):
    """kNN serving (512-slot banks, k = 8, approximate top-k): the hybrid
    10-gateway federation through MicroBatcher and through
    ContinuousBatcher with a build_banks(existing=...) swap in the middle
    of the stream, then 512 gateways with gather routing at 1024-row
    buckets; scores held to the evaluator's oracle (after the swap: to the
    plain CPU path on the refreshed bank)."""
    from fedmse_tpu_torch.data import stack_clients, synthetic_clients
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.knn import (build_banks, dist_tiles,
                                      routed_kth_distance)
    from fedmse_tpu_torch.models import init_stacked_params, make_model
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.serving import (ContinuousBatcher, MicroBatcher,
                                          ServingEngine, fit_calibration,
                                          interleave_order)
    kw = dict(score_kind="knn", knn_topk=cfg.knn_topk, **KNN)
    report = {}
    model, params, data = evaluated["hybrid"]
    oracle = make_evaluate_all(model, "hybrid", metric="scores", **kw)(
        params, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb).cpu().numpy()
    engine = ServingEngine.from_federation(
        model, "hybrid", params, data.train_xb, data.train_mb,
        max_bucket=cfg.serve_max_batch, device=device, **kw)
    calib = fit_calibration(engine, data.valid_x.cpu().numpy(),
                            data.valid_m.cpu().numpy())
    engine.warmup()
    test_x = data.test_x.cpu().numpy()
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
    rows, want = test_x[gws, ridx], oracle[gws, ridx]

    def held(served, ref, what):
        err = float(np.max(np.abs(served - ref)
                           / np.maximum(1.0, np.abs(ref))))
        if err > TOL["f32"] or not np.isfinite(served).all():
            raise AssertionError(f"{what} off its oracle by {err:.3e}")
        return err

    before = dist_tiles.launches
    batcher = MicroBatcher(engine, max_batch=cfg.serve_max_batch,
                           max_wait_ms=cfg.serve_latency_budget_ms,
                           calibration=calib)
    t0 = time.perf_counter()
    tickets = [batcher.submit(rows[i], int(gws[i])) for i in range(len(rows))]
    batcher.drain()
    wall = time.perf_counter() - t0
    err = held(np.array([t.score for t in tickets], np.float32), want,
               "knn micro-batched scores")
    st = batcher.stats()
    report["serve10_knn_sync"] = {
        "rows": len(tickets), "rows_per_s": len(tickets) / wall,
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "dispatches": st["dispatches"],
        "dist_launches": dist_tiles.launches - before,
        "max_err_vs_oracle": err}
    log(f"[serve] knn 10 gateways sync on {smi}: {len(tickets)} rows in "
        f"{st['dispatches']} buckets, {len(tickets) / wall:.1f} rows/s, "
        f"latency p50 {st['latency_p50_ms']:.4f} ms p99 "
        f"{st['latency_p99_ms']:.4f} ms, max err vs oracle {err:.3e}")
    watched("rows/s, 10 gateways, knn", len(tickets) / wall, 1e5, True)
    watched("verdict p99 ms, 10 gateways, knn", st["latency_p99_ms"], 4.0,
            False)

    # continuous front, the refreshed bank swapped in mid-stream
    refreshed = build_banks(model, params, data.valid_x, data.valid_m,
                            existing=engine.banks, seed=SEED + 7)
    front = ContinuousBatcher(engine, max_batch=cfg.serve_max_batch,
                              latency_budget_ms=cfg.serve_latency_budget_ms,
                              calibration=calib)
    half = len(rows) // 2
    t0 = time.perf_counter()
    tickets = [front.submit(rows[i], int(gws[i])) for i in range(half)]
    old_rows = front.rows_submitted - front.forming_rows
    event = front.swap(banks=refreshed)
    tickets += [front.submit(rows[i], int(gws[i]))
                for i in range(half, len(rows))]
    front.drain()
    wall = time.perf_counter() - t0
    st = front.stats()
    if not (st["rows_served"] == st["rows_submitted"] == len(rows)
            and sum(front.dispatch_batch_sizes) == len(rows)
            and all(t.done for t in tickets)):
        raise AssertionError(f"continuous front dropped or re-scored rows: "
                             f"{st['rows_served']} of {len(rows)}")
    served = np.array([t.score for t in tickets], np.float32)
    err_old = held(served[:old_rows], want[:old_rows],
                   "pre-swap continuous scores")
    installed = engine.banks
    if not (torch.equal(installed.latents.cpu(), refreshed.latents.cpu())
            and torch.equal(installed.count.cpu(), refreshed.count.cpu())):
        raise AssertionError("the swap did not install the refreshed bank")
    # the rows after the swap, scored independently: the plain forward and
    # plain distances on the CPU against a CPU copy of the refreshed bank
    cdt = engine.policy.compute_dtype
    gw_cpu = torch.from_numpy(gws[old_rows:].astype(np.int32))
    latent, _, _ = fused_forward_stats(
        {c: {n: {k: v.cpu() for k, v in layer.items()}
             for n, layer in coder.items()}
         for c, coder in engine.params.items()},
        torch.from_numpy(rows[old_rows:]).to(cdt), gw_cpu,
        compute_dtype=cdt)
    ref_new = torch.nan_to_num(routed_kth_distance(
        latent, gw_cpu, refreshed.to("cpu"), engine.knn_k,
        topk=engine.knn_topk)).numpy()
    err_new = held(served[old_rows:], ref_new, "post-swap continuous scores")
    report["serve10_knn_continuous"] = {
        "rows": len(rows), "rows_per_s": len(rows) / wall,
        "latency_p50_ms": st["latency_p50_ms"],
        "latency_p99_ms": st["latency_p99_ms"],
        "dispatches": st["dispatches"], "swap": event,
        "rows_before_swap": int(old_rows),
        "max_err_vs_oracle": max(err_old, err_new)}
    log(f"[serve] knn 10 gateways continuous on {smi}: {len(rows)} rows in "
        f"{st['dispatches']} buckets, {len(rows) / wall:.1f} rows/s, p99 "
        f"{st['latency_p99_ms']:.4f} ms, bank swap after {old_rows} rows "
        f"({event['kinds']}), rows_served == rows_submitted == "
        f"{st['rows_served']}, max err {max(err_old, err_new):.3e}")
    watched("verdict p99 ms, 10 gateways, knn, continuous front",
            st["latency_p99_ms"], 4.0, False)

    clients = synthetic_clients(n_clients=512, dim=DIMS[0], n_normal=100,
                                n_abnormal=40, seed=SEED + 1)
    model = make_model("autoencoder", *DIMS, shrink_lambda=cfg.shrink_lambda,
                       device=device)
    params = init_stacked_params(model, 512,
                                 torch.Generator().manual_seed(SEED + 1),
                                 device=device)
    data = stack_clients(clients, np.zeros((1, DIMS[0]), np.float32),
                         cfg.batch_size, device=device)
    oracle = make_evaluate_all(model, "autoencoder", metric="scores", **kw)(
        params, data.test_x, data.test_m, data.test_y, data.train_xb,
        data.train_mb).cpu().numpy()
    engine = ServingEngine.from_federation(
        model, "autoencoder", params, data.train_xb, data.train_mb,
        max_bucket=1024, routing="gather", device=device, **kw)
    engine.warmup()
    test_x = data.test_x.cpu().numpy()
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 1 << 30)
    rows = test_x[gws, ridx]
    served = np.empty(len(rows), np.float32)
    bucket_s = []
    before = dist_tiles.launches
    for s0 in range(0, len(rows), 1024):
        t0 = time.perf_counter()
        served[s0:s0 + 1024] = engine.score(rows[s0:s0 + 1024],
                                            gws[s0:s0 + 1024])
        bucket_s.append(time.perf_counter() - t0)
    err = held(served, oracle[gws, ridx], "512-gateway knn scores")
    ms = np.array(bucket_s) * 1e3
    report["serve512_knn"] = {
        "rows": len(rows), "buckets": len(bucket_s),
        "rows_per_s": len(rows) / sum(bucket_s),
        "bucket_p50_ms": float(np.percentile(ms, 50)),
        "bucket_p99_ms": float(np.percentile(ms, 99)),
        "dist_launches": dist_tiles.launches - before,
        "max_err_vs_oracle": err}
    log(f"[serve] knn 512 gateways gather on {smi}: {len(rows)} rows in "
        f"{len(bucket_s)} buckets of 1024, {len(rows) / sum(bucket_s):.1f} "
        f"rows/s, bucket p50 {np.percentile(ms, 50):.4f} ms p99 "
        f"{np.percentile(ms, 99):.4f} ms, max err vs oracle {err:.3e}")
    return report


def phase_train(torch, device, cfg, clients):
    """The training path at the paper's width through the driver's default,
    the fused, pipelined schedule (federation/fused.py, pipeline.py):
    every combination in f32, hybrid / mse_avg in bf16. Per round: the
    aggregator (or why there is none), mean AUC and wall time (the
    chunk's wall over its rounds: with the three quick-run rounds in one
    chunk, each carries a third of the graphs' capture, so the steady
    round is watched in phase_fused_hold and profile_round); per
    combination each kernel's launches
    (graph replays times the kernels each graph holds, and the eager
    warm-ups). The f32 hybrid / mse_avg run writes its checkpoint for
    phase_serve_trained."""
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    from fedmse_tpu_torch.ops.precision import get_policy
    if not (cfg.fused_rounds and cfg.fused_schedule and cfg.fused_pipeline):
        raise AssertionError("the driver's default is not the fused, "
                             "pipelined schedule")
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    names = [c.name for c in clients]
    ckpt = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    writer = ResultsWriter(ckpt, cfg.network_size, "chip-smoke",
                           cfg.scen_name, cfg.metric, cfg.num_participants)
    datas, report, outs = {}, {}, {}
    runs = [(mt, ut, "f32") for mt in ("hybrid", "autoencoder")
            for ut in ("avg", "fedprox", "mse_avg")]
    runs.append(("hybrid", "mse_avg", "bf16"))
    for model_type, update_type, precision in runs:
        c = cfg.replace(precision=precision)
        if precision not in datas:
            datas[precision] = stack_clients(
                clients, dev_x, c.batch_size,
                dtype=get_policy(precision).compute_dtype, device=device)
        tag = f"{model_type}/{update_type}/{precision}"
        last = [fused_train_grads.launches, fused_forward_stats.launches]
        counts = np.zeros(len(clients), np.int64)  # aggregations so far
        rows = []

        def on_round(result, sec, tag=tag, counts=counts, rows=rows,
                     thr=c.max_aggregation_threshold):
            auc = result.client_metrics
            if not np.isfinite(auc).all():
                raise AssertionError(f"{tag}: AUC not finite: {auc}")
            why = ""
            if result.aggregator is None:
                sel = result.selected
                if len(sel) > 1 and any(counts[i] < thr for i in sel):
                    raise AssertionError(f"{tag}: no aggregator though a "
                                         "cohort client is under the quota")
                why = (" (none: a cohort of one)" if len(sel) < 2 else
                       " (none: every cohort client is over the quota)")
            else:
                counts[result.aggregator] += 1
            rows.append({"round": result.round_index + 1,
                         "aggregator": result.aggregator,
                         "mean_auc": float(np.mean(auc)), "seconds": sec})
            log(f"[train] {tag} round {result.round_index + 1}: aggregator "
                f"{result.aggregator}{why}, mean AUC {np.mean(auc):.6f}, "
                f"{sec:.4f} s")

        serve = (model_type, update_type, precision) == \
            ("hybrid", "mse_avg", "f32")
        t0 = time.perf_counter()
        out = run_combination(c, datas[precision], len(clients), model_type,
                              update_type, 0, writer=writer,
                              device_names=names, save_checkpoints=serve,
                              on_round=on_round)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = [fused_train_grads.launches - last[0],
                    fused_forward_stats.launches - last[1]]
        outs[tag] = out
        fused = out["engine"].fused_round().stats()
        report[tag] = {"rounds": rows,
                       "final_mean_auc": float(np.mean(out["final_metrics"])),
                       "seconds": seconds, "train_launches": launched[0],
                       "forward_launches": launched[1], "fused": fused}
        log(f"[train] {tag}: final mean AUC "
            f"{report[tag]['final_mean_auc']:.6f} in {seconds:.2f} s; "
            f"fused_ae_train x{launched[0]}, fused_ae_forward "
            f"x{launched[1]}; epochs {fused['epochs_run']}, "
            f"{fused['host_reads']} host reads; graphs "
            f"{json.dumps(fused['graphs'])}")
    delta = abs(report["hybrid/mse_avg/bf16"]["final_mean_auc"]
                - report["hybrid/mse_avg/f32"]["final_mean_auc"])
    log(f"[train] hybrid/mse_avg: |final mean AUC bf16 - f32| = {delta:.3e} "
        f"(the pin is phase_train_orders')")
    return report, outs["hybrid/mse_avg/f32"], datas, writer, names


def _nan_scaled_err(torch, got, want) -> float:
    """scaled_err over two arrays whose NaNs (an unselected client's
    min_valid and curve) must sit at the same places."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    return scaled_err(torch.nan_to_num(got), torch.nan_to_num(want))


def _state_errs(torch, layout, got, want) -> dict:
    """Per-leaf scale-normalized errors of two ClientStates: params,
    prev_global and hist_params by leaf, the Adam state and the verifier's
    vectors."""
    errs = {}
    for name in ("params", "prev_global", "hist_params"):
        a, b = getattr(got, name).cpu(), getattr(want, name).cpu()
        errs[name] = max(scaled_err(a[:, sl], b[:, sl])
                         for sl in layout.slices())
    for name, a, b in zip(("count", "mu", "nu"), got.opt_state,
                          want.opt_state):
        errs[f"opt_{name}"] = max(
            scaled_err(a.cpu()[:, sl] if a.dim() == 2 else a.cpu(),
                       b.cpu()[:, sl] if b.dim() == 2 else b.cpu())
            for sl in layout.slices())
    for name in ("hist_perf", "hist_seen", "rejected", "waived"):
        errs[name] = scaled_err(getattr(got, name).cpu().double(),
                                getattr(want, name).cpu().double())
    return errs


def _same_bits(torch, a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(torch.equal(
        torch.nan_to_num(a.double(), nan=1e300),
        torch.nan_to_num(b.double(), nan=1e300)))


def phase_fused_hold(torch, device, cfg, clients):
    """The fused round (CUDA graphs) held to the per-phase round at the
    paper's width: 10 gateways, a 5-client cohort, the quick run's 5
    epochs, the same init, cohort and data, the vote tie-break off.
    hybrid / mse_avg and autoencoder / fedprox in f32, hybrid / mse_avg in
    bf16, and one kNN-scored hybrid / mse_avg round. After one round the
    states (every leaf, the Adam state, the verifier's history) and the
    RoundResult fields must agree within 1e-6 scale-normalized (the same
    kernels in the same order: bit-equal expected), with the same
    aggregator and verification rows; a second fused round from the same
    state replays the captured graphs and must give the first's bits."""
    import dataclasses
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.federation import (HostState, RoundEngine,
                                             init_client_states)
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.precision import get_policy
    from fedmse_tpu_torch.utils.seeding import ExperimentRngs
    base = cfg.replace(compat=dataclasses.replace(cfg.compat,
                                                  vote_tie_break=False))
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    layout, n = ParamLayout(*DIMS), len(clients)
    datas, report, worst = {}, {}, 0.0
    cases = [("hybrid", "mse_avg", "f32", "auto"),
             ("autoencoder", "fedprox", "f32", "auto"),
             ("hybrid", "mse_avg", "bf16", "auto"),
             ("hybrid", "mse_avg", "f32", "knn")]
    for model_type, update_type, precision, kind in cases:
        c = base.replace(precision=precision, score_kind=kind,
                         **(KNN if kind == "knn" else {}))
        if precision not in datas:
            datas[precision] = stack_clients(
                clients, dev_x, c.batch_size,
                dtype=get_policy(precision).compute_dtype, device=device)
        model = make_model(model_type, *DIMS, c.shrink_lambda,
                           precision=precision, device=device)
        init = init_client_states(model, n, torch.Generator().manual_seed(
            SEED + 5), device=device)

        def engine(fused):
            return RoundEngine(model, c, datas[precision], n_real=n,
                               rngs=ExperimentRngs(run=0),
                               model_type=model_type,
                               update_type=update_type, states=init,
                               fused=fused)
        per, fus = engine(False), engine(True)
        selected = per.select_clients()
        t0 = time.perf_counter()
        want = per.run_round(0, selected=selected)
        torch.cuda.synchronize()
        per_s = time.perf_counter() - t0
        got, seconds, states = [], [], []
        for _ in range(2):  # capture, then a replay from the same state
            fus.states, fus.host = init, HostState.create(n)
            t0 = time.perf_counter()
            got.append(fus.run_round(0, selected=selected))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            states.append(fus.states.clone())
        tag = f"{model_type}/{update_type}/{precision}/{kind}"
        for g in got:
            if (g.aggregator != want.aggregator
                    or g.verification_results != want.verification_results):
                raise AssertionError(f"[fused-hold] {tag}: aggregator "
                                     f"{g.aggregator} vs {want.aggregator}"
                                     " or verification rows differ")
        errs = _state_errs(torch, layout, states[0], per.states)
        for field in ("client_metrics", "mse_scores", "agg_weights",
                      "min_valid", "tracking"):
            errs[field] = _nan_scaled_err(torch, getattr(got[0], field),
                                          getattr(want, field))
        replay_bits = all(
            _same_bits(torch, getattr(got[1], f), getattr(got[0], f))
            for f in ("client_metrics", "mse_scores", "agg_weights",
                      "min_valid", "tracking")) and max(
            _state_errs(torch, layout, states[1], states[0]).values()) == 0
        err = max(errs.values())
        worst = max(worst, err)
        bitwise = err == 0.0
        stats = fus.fused_round().stats()
        report[tag] = {"max_scaled_err": err, "errs": errs,
                       "bit_equal": bitwise, "replay_bit_equal": replay_bits,
                       "aggregator": want.aggregator,
                       "per_phase_round_s": per_s,
                       "fused_round_s": seconds, "fused": stats}
        watched(f"fused round seconds (graphs replayed), {tag}",
                seconds[1], 0.5, False)
        log(f"[fused-hold] {tag}: aggregator {want.aggregator}, fused vs "
            f"per-phase max scaled error {err:.3e} (bit-equal: {bitwise}); "
            f"replay bit-equal: {replay_bits}; per-phase {per_s:.3f} s, "
            f"fused {seconds[0]:.3f} s (capture) / {seconds[1]:.3f} s; "
            f"graphs {json.dumps(stats['graphs'])}")
        if not err <= 1e-6 or not replay_bits:
            raise AssertionError(f"[fused-hold] {tag}: fused vs per-phase "
                                 f"{json.dumps(errs)}, replay bit-equal "
                                 f"{replay_bits}")
    log(f"[fused-hold] worst scaled error over {len(cases)} cases: "
        f"{worst:.3e} (limit 1e-6)")
    return {"cases": report, "worst_scaled_err": worst}


def phase_train_orders(torch, cfg, datas, n_clients, report):
    """hybrid / mse_avg trained again in f32 and in bf16 with the train
    kernel at 4, 2 and 1 CTAs per client: the same function in three more
    summation orders beside the main path's 8. The quick run's final AUC is
    chaotic (Adam on the loss plateau, early stops that flip; ROADMAP queue
    3): over these four orders the f32 final mean AUC spanned 0.99487 to
    0.99999 on an H100 (PERF.md), more than the pin. So bf16 is held to
    f32 on the mean over the four orders of each one's final mean AUC,
    within 2e-3."""
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.ops import fused_train
    finals = {p: [report[f"hybrid/mse_avg/{p}"]["final_mean_auc"]]
              for p in ("f32", "bf16")}
    sizes = [8]
    pick = fused_train.cluster_size
    try:
        for size in (4, 2, 1):
            fused_train.cluster_size = \
                lambda g, h, size=size: min(size, h, pick(g, h))
            sizes.append(size)
            for precision in finals:
                out = run_combination(cfg.replace(precision=precision),
                                      datas[precision], n_clients, "hybrid",
                                      "mse_avg", 0)
                finals[precision].append(
                    float(np.mean(out["final_metrics"])))
    finally:
        fused_train.cluster_size = pick
    torch.cuda.synchronize()
    means = {p: float(np.mean(v)) for p, v in finals.items()}
    delta = abs(means["bf16"] - means["f32"])
    log(f"[train] hybrid/mse_avg final mean AUC at {sizes} CTAs per client: "
        f"{json.dumps(finals)}; |mean bf16 - mean f32| = {delta:.3e}")
    if delta > 2e-3:
        raise AssertionError(f"bf16 training's AUC off f32 by {delta:.3e}")
    return {"cluster_sizes": sizes, "final_mean_auc": finals,
            "mean_abs_delta": delta}


def phase_serve_trained(torch, device, cfg, out, data, writer, names):
    """The trained hybrid federation's checkpoint, served: scores equal to
    the evaluator's oracle on the trained params."""
    from fedmse_tpu_torch.evaluation import make_evaluate_all
    from fedmse_tpu_torch.serving import ServingEngine, interleave_order
    engine = out["engine"]
    oracle = make_evaluate_all(engine.model, "hybrid", metric="scores")(
        engine.model_params(), data.test_x, data.test_m, data.test_y,
        data.train_xb, data.train_mb).cpu().numpy()
    served_engine = ServingEngine.from_checkpoint(
        writer, engine.model, "hybrid", "mse_avg", names, run=0,
        train_x=data.train_xb, train_m=data.train_mb,
        max_bucket=cfg.serve_max_batch, device=device)
    gws, ridx = interleave_order(data.test_m.cpu().numpy(), 8192)
    test_x = data.test_x.cpu().numpy()
    served = np.concatenate([
        served_engine.score(test_x[gws[s:s + 256], ridx[s:s + 256]],
                            gws[s:s + 256])
        for s in range(0, len(gws), 256)])
    want = oracle[gws, ridx]
    err = float(np.max(np.abs(served - want) / np.maximum(1.0, np.abs(want))))
    if err > TOL["f32"] or not np.isfinite(served).all():
        raise AssertionError(f"served trained checkpoint off the oracle by "
                             f"{err:.3e}")
    log(f"[train] trained hybrid/mse_avg checkpoint served: {len(served)} "
        f"rows, max error vs the evaluator oracle {err:.3e}")
    return err


def forced_gc_ms() -> dict:
    """Milliseconds of one forced full collection in this process as it
    stands (after training): without a freeze, under gc.freeze() (what
    run_serve_smoke does for its stream) and without one again."""
    def timed():
        t0 = time.perf_counter()
        gc.collect()
        return (time.perf_counter() - t0) * 1e3
    gc.collect()  # the garbage that training left
    out = {"tracked_objects": len(gc.get_objects()), "unfrozen": timed()}
    gc.freeze()
    try:
        out["frozen"] = timed()
    finally:
        gc.unfreeze()
    out["unfrozen_again"] = timed()
    return out


def phase_serve_pass(torch, cfg, data, writer, names):
    """The CLI's --serve pass (serving.run_serve_smoke) on the trained
    hybrid / mse_avg checkpoint, with the kNN score and the continuous
    front, cold (the CLI's default) three times and then with
    --serve-warmup: the bank npz and the calibration JSON must be written.
    First, one forced full collection timed with and without the freeze
    the pass puts around its stream; each pass records every GC pause."""
    from fedmse_tpu_torch.knn import dist_tiles, load_bank
    from fedmse_tpu_torch.serving import run_serve_smoke
    c = cfg.replace(score_kind="knn", **KNN)
    gc_ms = forced_gc_ms()
    log(f"[serve-pass] one forced full collection after training: "
        f"{json.dumps(gc_ms)} ms ({gc_ms['tracked_objects']} objects "
        f"tracked)")
    watched("forced full collection under gc.freeze / without, ratio",
            gc_ms["frozen"] / max(gc_ms["unfrozen"], 1e-9), 0.5, False)
    out = {"forced_gc_ms": gc_ms, "cold_passes": []}
    for tag in ("cold", "cold", "cold", "warm"):
        warmup = tag == "warm"
        before = dist_tiles.launches
        pauses = []  # the garbage collector's pauses during the pass

        def on_gc(phase, info, pauses=pauses, t=[0.0]):
            if phase == "start":
                t[0] = time.perf_counter()
            else:
                pauses.append((info["generation"],
                               (time.perf_counter() - t[0]) * 1e3))
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        rep = run_serve_smoke(c, data, len(names), writer, names, "hybrid",
                              "mse_avg", run=0, max_rows=8192,
                              max_batch=c.serve_max_batch,
                              max_wait_ms=c.serve_latency_budget_ms,
                              warmup=warmup, continuous=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
        if gc.get_freeze_count() != 0:
            raise AssertionError("the --serve pass left the collector "
                                 "frozen")
        bank = load_bank(rep["knn_bank_path"], device=data.train_xb.device)
        if not (rep["score_kind"] == "knn" and rep["front"] == "continuous"
                and os.path.exists(rep["calibration_path"])
                and bank.num_gateways == len(names)
                and bank.bank_size == c.knn_bank_size
                and rep["batcher"]["rows_served"] == rep["rows"] > 0
                and rep["verdict_label_agreement"] is not None):
            raise AssertionError(f"--serve pass report: "
                                 f"{json.dumps(rep)[:800]}")
        entry = {
            "rows": rep["rows"], "seconds": secs,
            "rows_per_sec_wall": rep["batcher"]["rows_per_sec_wall"],
            "latency_p50_ms": rep["batcher"]["latency_p50_ms"],
            "latency_p99_ms": rep["batcher"]["latency_p99_ms"],
            "mean_batch": rep["batcher"]["mean_batch"],
            "verdict_label_agreement": rep["verdict_label_agreement"],
            "drifted_gateways": rep["drift"]["drifted_gateways"],
            "dist_launches": dist_tiles.launches - before,
            "latency_max_ms_by_eighth": rep["latency_max_ms_by_eighth"],
            "warmup_sec_per_bucket": rep["warmup_sec_per_bucket"],
            "gc_pauses": len(pauses),
            "gc_max_pause_ms": max((ms for _, ms in pauses), default=0.0),
            "gc_full_collections": sum(g == 2 for g, _ in pauses)}
        if warmup:
            out["warm"] = entry
        else:
            out["cold_passes"].append(entry)
            tag = f"cold {len(out['cold_passes'])}"
        log(f"[serve-pass] --serve ({tag}) on the trained hybrid/mse_avg "
            f"checkpoint, knn, continuous front: {json.dumps(entry)}; "
            f"bank {os.path.basename(rep['knn_bank_path'])} and calibration"
            f" written")
        watched(f"verdict p99 ms, --serve pass ({tag})",
                entry["latency_p99_ms"], 4.0, False)
    return out


def baseline_dist(torch):
    """fn(q, banks, gw) -> [T, B] launching the distance kernel's
    predecessor (csrc/dist_tiles_baseline.cu, f32 queries) on the current
    stream: the yardstick the redesign is timed against."""
    import ctypes
    from fedmse_tpu_torch.ops import native
    lib = native.load("dist_tiles_baseline")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dist_tiles.argtypes = [ptr] * 4 + [ctypes.c_longlong] + [i32] * 3 \
        + [ptr]
    lib.dist_tiles.restype = i32

    def call(q, banks, gw):
        out = torch.empty((q.shape[0], banks.shape[1]), device=q.device)
        rc = lib.dist_tiles(q.data_ptr(), banks.data_ptr(),
                            None if gw is None else gw.data_ptr(),
                            out.data_ptr(), q.shape[0], banks.shape[0],
                            banks.shape[1], q.shape[1],
                            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the baseline distance launch failed ({rc})")
        return out
    return call


def report_dist(torch, device, launches, worst, eval_rows):
    """The distance kernel's, its predecessor's (csrc/dist_tiles_baseline.cu,
    whose bits it must reproduce), its plain version's and torch.cdist's
    times and the bound at the main path's shapes: the 10-gateway
    evaluation (its `eval_rows` test rows client-major against 512-slot
    banks) and the two serving buckets. At each shape also the kNN score
    around the kernel (routed_kth_distance with exact and approximate
    top-k: the launch, the padding mask, the top-k and the gather) on the
    device, the kernel's share of it, and a one-element fill as the floor
    of any launch. Each timed call's output is first held to the plain
    version on the same inputs."""
    from fedmse_tpu_torch.knn.bank import ReferenceBank
    from fedmse_tpu_torch.knn.score import (dist_tiles, dist_tiles_plain,
                                            routed_kth_distance)
    gen = torch.Generator().manual_seed(SEED + 8)
    bank = KNN["knn_bank_size"]
    parent = baseline_dist(torch)
    one = torch.zeros(1, device=device)
    fill_ms = all_device_ms(torch, lambda: one.fill_(1.0), 50)
    log(f"[report] one-element fill on the device {fill_ms:.5f} ms (the "
        f"floor of any launch)")
    rows_out = []
    for what, n, rows, gw_kind in main_dist_shapes(eval_rows):
        q, banks, gw = dist_inputs(torch, n, rows, bank, DIMS[2], gw_kind,
                                   gen, device, torch.float32)
        got, _, err = dist_check(torch, q, banks, gw, f"timed {what}")
        if not torch.equal(parent(q, banks, gw).view(torch.int32),
                           got.view(torch.int32)):
            raise AssertionError(f"dist {what}: the kernel's bits differ "
                                 "from its predecessor's")
        call = lambda: dist_tiles(q, banks, gw)  # noqa: E731
        k_ms = cuda_ms(call, 200)
        d_ms = device_ms(call, "dist_tiles", 50)
        parent_ms = device_ms(lambda: parent(q, banks, gw), "dist_tiles", 50)
        d2_ms = device_ms(call, "dist_tiles", 50)
        p_ms = cuda_ms(lambda: dist_tiles_plain(q, banks, gw), 10)
        lib_ms = None
        if gw_kind == "client_major":
            # one library call on the batched [N, T/N, L] x [N, B, L] shape;
            # it computes the square root of the same function
            qb = q.view(n, rows // n, DIMS[2])
            lib_ms = cuda_ms(lambda: torch.cdist(
                qb, banks, compute_mode="use_mm_for_euclid_dist"), 50)
        count = torch.randint(bank // 2, bank + 1, (n,), generator=gen,
                              dtype=torch.int32).to(device)
        ref = ReferenceBank(latents=banks, count=count)
        g = gw if gw is not None else torch.zeros(rows, dtype=torch.int32,
                                                  device=device)
        path_ms = {topk: all_device_ms(torch, lambda topk=topk:
                                       routed_kth_distance(
                                           q, g, ref, KNN["knn_k"],
                                           topk=topk), 20)
                   for topk in ("exact", "approx")}
        used = n if gw is None else int(torch.unique(gw).numel())
        b_ms, b_by = dist_bound(rows, bank, used)
        rows_out.append({
            "what": what, "rows": rows, "banks": n, "bank_size": bank,
            "ms": k_ms, "device_ms": d_ms, "device_ms_again": d2_ms,
            "parent_device_ms": parent_ms, "plain_ms": p_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "knn_path_device_ms": path_ms,
            "kernel_share_of_knn_path": {
                k: d_ms / v for k, v in path_ms.items()},
            "fill_device_ms": fill_ms,
            "scaled_err_vs_plain": err})
        log(f"[report] dist {what} T={rows} B={bank} N={n}: wrapper call "
            f"{k_ms:.5f} ms, kernel on the device {d_ms:.5f} / {d2_ms:.5f} "
            f"ms against its predecessor's {parent_ms:.5f} (same bits), "
            f"plain {p_ms:.5f} ms, torch.cdist {lib_ms} ms, bound "
            f"{b_ms:.6f} ms ({b_by}); kNN score on the device "
            f"{path_ms['exact']:.5f} (exact) / {path_ms['approx']:.5f} "
            f"(approx) ms, the kernel {d_ms / path_ms['exact']:.1%} / "
            f"{d_ms / path_ms['approx']:.1%} of it; scaled error vs plain "
            f"{err:.3e}")
    main = rows_out[0]
    return {
        "name": "dist_tiles",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/dist_tiles.cu",
        "replaces": "fedmse_tpu/knn/score.py:51 (_dist_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "parent_device_ms": main["parent_device_ms"],
        "parent_source": "fedmse_tpu_torch/csrc/dist_tiles_baseline.cu",
        "knn_path_ms": main["knn_path_device_ms"]["exact"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.cdist(q [N, T/N, L], banks [N, B, L], "
                        "compute_mode='use_mm_for_euclid_dist')",
        "fill_device_ms": fill_ms,
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": DIST_TOL,
        "shapes": rows_out,
    }


def _profile_path(torch, engine, path, states, host, k, selected):
    """One round on `path` from (states, host), twice: timed on the host
    clock, then under torch.profiler for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from fedmse_tpu_torch.ops.fused_train import fused_train_grads
    fused = engine.fused_round()
    engine.profile = path == "per_phase"  # profile forces per-phase
    engine.states, engine.host = states, host.copy()
    bodies = (fused.enter, fused.epoch, fused.leave)
    reads = fused.host_reads
    replays = sum(b.replays for b in bodies)
    epoch_s = (fused.epoch.replays, fused.epoch.replay_seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_round(k, selected=selected)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    reads = fused.host_reads - reads
    replays = sum(b.replays for b in bodies) - replays
    # the host's milliseconds in one replay() of the epoch graph
    epoch_replay_ms = ((fused.epoch.replay_seconds - epoch_s[1]) * 1e3
                       / max(fused.epoch.replays - epoch_s[0], 1))
    engine.states, engine.host = states, host.copy()
    before = fused_train_grads.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.run_round(k, selected=selected)
        torch.cuda.synchronize()
    steps = fused_train_grads.launches - before
    engine.profile = False
    by_name, calls = {}, {}
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
            calls[e.key] = calls.get(e.key, 0) + e.count
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    r = {"wall_ms": wall_ms, "device_busy_ms": busy,
         "device_busy_share": busy / wall_ms, "train_steps": steps,
         "host_ms_per_step": wall_ms / max(steps, 1),
         "device_ms_per_step": busy / max(steps, 1),
         "device_ops_per_step": sum(calls.values()) / max(steps, 1),
         # kernel name (cut to 80 characters): [device ms, launches]
         "top_kernels": {n[:80]: [v, calls[n]] for n, v in top}}
    if path != "per_phase":
        r.update({"host_reads": reads, "graph_replays": replays,
                  "epoch_replay_host_ms": epoch_replay_ms,
                  "epochs_run": fused.epochs_run[-1],
                  "graphs": fused.stats()["graphs"]})
    return r, {n[:60]: [round(v, 3), calls[n]] for n, v in top}


def profile_round(torch, out):
    """One more round of the trained hybrid / mse_avg federation on each
    path, the fused round (CUDA graphs) and the per-phase round, each
    twice from the same state and cohort: timed on the host clock, then
    under torch.profiler (whose per-launch cost inflates the wall clock)
    for the device time by kernel. Busy share = device time / unprofiled
    wall. For the fused round also the host's reads (one early-stop flag
    per epoch but the first), the graph replays, the host's time per
    epoch replay, the epochs run and the capture seconds and nodes of its
    graphs (captured in phase_train)."""
    engine = out["engine"]
    states, host = engine.states.clone(), engine.host.copy()
    selected = engine.select_clients()
    results = {}
    for path in ("fused", "per_phase"):
        r, tops = _profile_path(torch, engine, path, states, host,
                                engine.cfg.num_rounds, selected)
        results[path] = r
        log(f"[profile] one hybrid/mse_avg round, {path}: wall "
            f"{r['wall_ms']:.2f} ms, {r['train_steps']} train steps "
            f"({r['host_ms_per_step']:.4f} ms of wall and "
            f"{r['device_ms_per_step']:.4f} ms of device time each, "
            f"{r['device_ops_per_step']:.2f} device ops), device busy "
            f"{r['device_busy_ms']:.2f} ms "
            f"({100 * r['device_busy_share']:.1f}%)"
            + (f", {r['epochs_run']} epochs, {r['host_reads']} host "
               f"reads, {r['graph_replays']} graph replays "
               f"({r['epoch_replay_host_ms']:.3f} ms of host time per "
               f"epoch replay)" if path == "fused" else "")
            + f"; top kernels {json.dumps(tops)}")
    engine.states, engine.host = states, host
    watched("fused round wall seconds, profiled round",
            results["fused"]["wall_ms"] / 1e3, 0.5, False)
    watched("device-busy share of a fused round",
            results["fused"]["device_busy_share"], 0.5, True)
    return results


def profile_pipeline(torch, out):
    """The fused schedule's chunk loop pipelined (the driver's default)
    against serial (--no-pipeline), on the trained hybrid / mse_avg
    engine, whose graphs phase_train captured: 12 rounds in chunks of 2,
    each run from the engine's init and fresh streams (the same
    selections, draws and work), in the order pipelined, serial, serial,
    pipelined. `consume` does the driver's per-round host work (a
    ResultsWriter appends the round's metrics and verification rows).
    Reports each run's wall per round and the pipelined runs' host gaps;
    the two loops' final states must be the same bits."""
    from fedmse_tpu_torch.checkpointing import ResultsWriter
    from fedmse_tpu_torch.federation import run_pipelined_schedule
    engine = out["engine"]
    cfg = engine.cfg
    keep = engine.states.clone(), engine.host.copy(), engine.rngs
    root = os.path.join(ROOT, "build", "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    writer = ResultsWriter(root, cfg.network_size, "chip-smoke",
                           cfg.scen_name, cfg.metric, cfg.num_participants)
    rounds, chunk = 12, 2

    def consume(results, sec):
        for r in results:
            writer.append_round_metrics(0, r.round_index, r.client_metrics,
                                        engine.model_type,
                                        engine.update_type)
            writer.append_verification(0, r.round_index,
                                       r.verification_results)
        return None

    runs, final = [], {}
    for pipelined in (True, False, False, True):
        engine.reset_federation()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_pipelined_schedule(engine, 0, rounds, chunk, consume,
                                       can_rewind=False, pipelined=pipelined)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        final.setdefault(pipelined, engine.states.params.clone())
        runs.append({"pipelined": pipelined, "wall_s": wall,
                     "round_ms": wall * 1e3 / rounds,
                     "host_gap_ms": [g * 1e3 for g in stats.host_gaps]})
        log(f"[pipeline] {rounds} fused rounds in chunks of {chunk}, "
            f"{'pipelined' if pipelined else 'serial'}: {wall:.4f} s, "
            f"{wall * 1e3 / rounds:.3f} ms a round; host gaps (ms) "
            f"{[round(g * 1e3, 3) for g in stats.host_gaps]}")
    engine.states, engine.host, engine.rngs = keep
    shutil.rmtree(root, ignore_errors=True)
    if not torch.equal(final[True], final[False]):
        raise AssertionError("[pipeline] pipelined and serial chunk loops "
                             "ended on different params")
    ms = {p: [r["round_ms"] for r in runs if r["pipelined"] == p]
          for p in (True, False)}
    log(f"[pipeline] mean ms a round: pipelined "
        f"{np.mean(ms[True]):.3f}, serial {np.mean(ms[False]):.3f}")
    return {"rounds": rounds, "chunk": chunk, "runs": runs}


def phase_card_vs_cpu(torch, device, cfg, clients):
    """hybrid / fedprox, round 1 cut to one epoch (334 steps of the 5-client
    cohort), on the card and on the CPU's plain versions from one init:
    params 1e-4 scale-normalized per leaf. One epoch, because the quick-run
    schedule's later epochs sit on a loss plateau where Adam's normalized
    step turns a last-bit difference of a gradient into an O(1) parameter
    difference and flips early-stop decisions (a 1e-7 relative gradient
    perturbation on the CPU alone: 4e-7 after one epoch, 2.0 after five)."""
    from fedmse_tpu_torch.data import build_dev_dataset, stack_clients
    from fedmse_tpu_torch.federation import init_client_states
    from fedmse_tpu_torch.main import run_combination
    from fedmse_tpu_torch.models import make_model
    from fedmse_tpu_torch.models.flat import ParamLayout
    c = cfg.replace(num_rounds=1, epochs=1)
    dev_x = build_dev_dataset(clients, np.random.default_rng(cfg.data_seed))
    init = init_client_states(make_model("hybrid", *DIMS, device="cpu"),
                              len(clients),
                              torch.Generator().manual_seed(SEED + 4),
                              device="cpu")
    params = []
    t0 = time.perf_counter()
    for where in (device, torch.device("cpu")):
        data = stack_clients(clients, dev_x, c.batch_size, device=where)
        out = run_combination(c, data, len(clients), "hybrid", "fedprox", 0,
                              states=init.to(where))
        params.append(out["engine"].states.params.cpu())
    card, cpu = params
    layout = ParamLayout(*DIMS)
    err = max(float((card[:, sl] - cpu[:, sl]).abs().max()
                    / cpu[:, sl].abs().max()) for sl in layout.slices())
    log(f"[card-cpu] hybrid/fedprox round 1, one epoch, from one init: "
        f"worst per-leaf "
        f"scaled param error {err:.3e} ({time.perf_counter() - t0:.1f} s)")
    if err > 1e-4:
        raise AssertionError(f"card vs CPU training: {err:.3e} > 1e-4")
    return err


def report_train(torch, device, launches, worst):
    """The train kernel's and its plain version's times and bounds at the
    main path's step shape (5 clients x 12 rows) and at 512 clients."""
    from fedmse_tpu_torch.models.flat import ParamLayout
    from fedmse_tpu_torch.ops.fused_train import (cluster_size,
                                                  fused_train_grads,
                                                  fused_train_grads_plain)
    gen = torch.Generator().manual_seed(SEED + 5)
    layout = ParamLayout(*DIMS)
    rows_out = []
    for what, g, rows, precision in (
            ("train step, main path", 5, 12, "f32"),
            ("train step, main path", 5, 12, "bf16"),
            ("train step, 512 clients", 512, 12, "f32")):
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        flat = random_flat(torch, layout, g, gen, device)
        x = torch.randn((g, rows, DIMS[0]), generator=gen).to(device, cdt)
        m = torch.ones((g, rows), device=device)
        kw = dict(layout=layout, shrink_lambda=10.0, compute_dtype=cdt)
        call = lambda: fused_train_grads(flat, x, m, **kw)  # noqa: E731
        k_ms = cuda_ms(call, 500)
        d_ms = device_ms(call, "fused_ae_train_kernel", 100)
        p_ms = cuda_ms(lambda: fused_train_grads_plain(flat, x, m, **kw), 50)
        b_ms, b_by = train_bound(rows, g, precision)
        c = cluster_size(g, DIMS[1])
        rows_out.append({"what": what, "rows": rows, "clients": g,
                         "precision": precision, "cluster_size": c,
                         "ctas": g * c, "ms": k_ms,
                         "device_ms": d_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by})
        log(f"[report] {what} {precision} G={g} R={rows} ({c} CTAs per "
            f"client, {g * c} CTAs): wrapper call {k_ms:.5f} ms (kernel on "
            f"the device {d_ms:.5f} ms), plain {p_ms:.5f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
    main = rows_out[0]
    return {
        "name": "fused_ae_train",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/fused_train.cu",
        "replaces": "fedmse_tpu/ops/pallas_ae.py:309 (_train_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused loss and "
                        "grads",
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": TOL,
        "shapes": rows_out,
    }


def phase_report(torch, device, launches, worst):
    """The forward kernel's wrapper-call time (CUDA events, back to back),
    its own device time (torch.profiler), its plain version's time, its
    bound and device time over bound at the main path's shapes: the
    evaluation and the two serving buckets, then the training path's own
    launches."""
    from fedmse_tpu_torch.ops.fused_ae import (fused_forward_stats,
                                               fused_forward_stats_plain,
                                               tile_plan)
    gen = torch.Generator().manual_seed(SEED + 2)
    shapes = [  # (what, rows, models, precision)
        ("evaluate hybrid, 10 gateways", 70_080, 10, "f32"),
        ("evaluate hybrid, 10 gateways", 70_080, 10, "bf16"),
        ("serve bucket, 10 gateways", 256, 10, "f32"),
        ("serve bucket, 512 gateways gather", 1024, 512, "f32"),
    ]
    # the training path's own launches, client-major: validation (5
    # clients x 1,008 rows), the vote (10 models x 1,000), mse_avg's dev
    # scoring (5 models x 40,000)
    shapes += [("validation", 5_040, 5, "f32"), ("vote", 10_000, 10, "f32"),
               ("dev scoring", 200_000, 5, "f32")]
    rows_out = []
    for what, rows, g, precision in shapes:
        cdt = torch.bfloat16 if precision == "bf16" else torch.float32
        params = random_params(torch, g, *DIMS, gen, device, cdt)
        x = torch.randn((rows, DIMS[0]), generator=gen).to(device=device,
                                                            dtype=cdt)
        idx = torch.randint(0, g, (rows,), generator=gen,
                            dtype=torch.int32).to(device)
        if what.startswith("evaluate"):
            idx = torch.sort(idx).values  # the evaluator's rows are grouped
        elif not what.startswith("serve"):
            idx = torch.arange(g, dtype=torch.int32, device=device
                               ).repeat_interleave(rows // g)
        call = lambda: fused_forward_stats(  # noqa: E731
            params, x, idx, compute_dtype=cdt)
        k_ms = cuda_ms(call, 200)
        d_ms = device_ms(call, "fused_ae_forward_kernel", 50)
        p_ms = cuda_ms(lambda: fused_forward_stats_plain(
            params, x, idx, compute_dtype=cdt), 5)
        b_ms, b_by = bound(rows, g, precision)
        tile, ctas = tile_plan(rows, torch.cuda.get_device_properties(
            device).multi_processor_count)
        rows_out.append({"what": what, "rows": rows, "models": g,
                         "precision": precision, "tile": tile, "ctas": ctas,
                         "ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "x_bound": d_ms / b_ms})
        log(f"[report] {what} {precision} R={rows} G={g} ({tile}-row tiles, "
            f"{ctas} CTAs): wrapper call {k_ms:.5f} ms (kernel on the device "
            f"{d_ms:.5f} ms, {d_ms / b_ms:.2f}x its bound), plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by})")
    main = rows_out[0]
    return {"kernels": [{
        "name": "fused_ae_forward",
        "route": "cuda",
        "source": "fedmse_tpu_torch/csrc/fused_ae.cu",
        "replaces": "fedmse_tpu/ops/pallas_ae.py:130 (_kernel)",
        "launches": launches,
        "max_abs_err": worst["f32"]["abs"],
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused forward "
                        "with its per-row MSE and latent norm",
        "max_abs_err_by_dtype": {p: worst[p]["abs"] for p in worst},
        "max_scaled_err_by_dtype": {p: worst[p]["scaled"] for p in worst},
        "tolerance_scaled": TOL,
        "shapes": rows_out,
    }]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs an NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fedmse_tpu_torch.config import ExperimentConfig
    from fedmse_tpu_torch.data import synthetic_clients
    from fedmse_tpu_torch.ops import native
    from fedmse_tpu_torch.knn import dist_tiles
    from fedmse_tpu_torch.ops.fused_ae import fused_forward_stats
    from fedmse_tpu_torch.ops.fused_train import fused_train_grads

    t_start = time.perf_counter()
    cfg = ExperimentConfig()
    if (cfg.dim_features, cfg.hidden_neus, cfg.latent_dim) != DIMS:
        raise AssertionError(f"config widths differ from {DIMS}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    smi = smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    built = native.build(native.KERNEL_SOURCES + native.BASELINE_SOURCES)
    log(f"[device] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({json.dumps(built)})")
    for name in native.KERNEL_SOURCES:
        for line in native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] {name}: {line.strip()}")

    worst = phase_kernels(torch, device)
    worst_train = phase_train_kernels(torch, device)
    clients = synthetic_clients(n_clients=10, dim=DIMS[0], n_normal=10_000,
                                n_abnormal=2_000, seed=SEED)
    # the evaluation's distance launch: every client's test rows, padded
    eval_rows = len(clients) * max(len(c.test_x) for c in clients)
    worst_dist = phase_dist_kernels(torch, device, eval_rows)

    # the main path starts here
    fused_forward_stats.launches = 0
    fused_train_grads.launches = 0
    dist_tiles.launches = 0
    evaluated, knn_eval = phase_evaluate(torch, device, cfg, clients)
    if knn_eval["hybrid/knn/approx/f32"]["test_rows"] != eval_rows:
        raise AssertionError("the evaluation's distance launch is not the "
                             f"{eval_rows} rows phase_dist_kernels held")
    serve = phase_serve(torch, device, cfg, evaluated, smi)
    serve.update(phase_serve_knn(torch, device, cfg, evaluated, smi))
    training, trained, datas, writer, names = phase_train(torch, device,
                                                          cfg, clients)
    data = datas["f32"]
    serve["trained_checkpoint_max_err"] = phase_serve_trained(
        torch, device, cfg, trained, data, writer, names)
    serve["serve_pass_knn_continuous"] = phase_serve_pass(
        torch, cfg, data, writer, names)
    torch.cuda.synchronize()
    launches = {"fused_ae_forward": fused_forward_stats.launches,
                "fused_ae_train": fused_train_grads.launches,
                "dist_tiles": dist_tiles.launches}
    # ... and ends here
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {name}")
    log(f"[main path] launches {json.dumps(launches)}")
    training["orders"] = phase_train_orders(torch, cfg, datas, len(clients),
                                            training)
    training["fused_hold"] = phase_fused_hold(torch, device, cfg, clients)
    round_profile = profile_round(torch, trained)
    round_profile["pipeline"] = profile_pipeline(torch, trained)
    card_vs_cpu = phase_card_vs_cpu(torch, device, cfg, clients)

    line = phase_report(torch, device, launches["fused_ae_forward"], worst)
    line["kernels"].append(report_train(torch, device,
                                        launches["fused_ae_train"],
                                        worst_train))
    line["kernels"].append(report_dist(
        torch, device, launches["dist_tiles"], worst_dist, eval_rows))
    line["evaluate_knn"] = knn_eval
    line["serving"] = serve
    line["training"] = training
    line["card_vs_cpu_param_err"] = card_vs_cpu
    line["round_profile"] = round_profile
    line["watched"] = WATCHED
    shutil.rmtree(writer.root, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json_line(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
