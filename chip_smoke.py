#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (npe_pfn_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds the row flash-attention kernel from the checkout;
  3. the kernel against its plain PyTorch version on the card, over the
     main-path shapes, ragged lengths, per-batch and empty masks, head_dim
     16/32/128 and f32 inputs;
  4. the kernel's time at the main-path decode shape beside its bound, the
     plain version's time and scaled_dot_product_attention's (a yardstick
     only: the port never calls it);
  5. the main path at full width: the shipped checkpoint in bf16, 10k
     gaussian_linear simulations, NPEPFN(filter_context_size=2048,
     qry_chunk=2048) serving three sample(10_240) requests, each of which
     must launch the kernel 480 times (10 dims x 8 layers x (1 encode + 5
     decode chunks)); samples are checked against the analytic posterior;
  6. autoregressive_log_prob of one request's samples through the kernel
     (flash="auto") against the dense path (flash="off").
Then one JSON line per the kernels, and last {"ok": true, "device": {...}}.
Any failure exits non-zero without the last line. It imports nothing of JAX.
"""

import dataclasses
import faulthandler
import json
import math
import signal
import subprocess
import sys
import time

# The whole run, nvcc build included, took 33-38 s on an H100; 240 s leaves a
# margin of about 6x and still ends a hang (exit != 0, with a message) long
# before any outer time limit would cut the run.
DEADLINE_S = 240

# Peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Phase 3 tolerances on max |kernel - plain|: f32 inputs 1e-5 (order of the
# f32 sums); bf16 1e-2 x max(1, max|plain|) (bf16 output rounding and P cast
# to bf16 before P.V, where the plain version normalizes first).
TOL_F32 = 1e-5
TOL_BF16 = 1e-2

# Phase 5: |sample mean - posterior mean| / posterior std per dim, and the
# sample std over the posterior std. Calibrated on the CPU with the plain
# path (PERF.md, "Posterior check"); loose by design: the bound catches a
# broken path, not a weak model.
MAX_MEAN_Z = 1.0
STD_RATIO = (0.6, 1.6)

# Phase 6: kernel path vs dense path, autoregressive log_prob of 10_240
# samples summed over 10 dims. The paths round scores differently (f32 in
# the kernel, bf16 scores_dtype in the dense path), so they agree to the
# model's bf16 noise, not to f32 precision. Calibrated on the H100: median
# 0.014 and p99 0.059 nats against a log_prob spread (std) of 2.45 (PERF.md).
MAX_MEDIAN_ABS_LP_DIFF = 0.05
MAX_P99_ABS_LP_DIFF = 0.25


def log(*parts):
    print(*parts, flush=True)


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke.py exceeded its {DEADLINE_S} s deadline")


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def phase_build():
    from npe_pfn_tpu_torch.ops import _build

    path, seconds, build_log = _build.build("flash_row_attention.cu")
    regs = sorted({line.split("Used")[1].split(",")[0].strip()
                   for line in build_log.splitlines() if "Used" in line and "registers" in line})
    spills = [line.strip() for line in build_log.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    log(f"build: {path.name} nvcc {seconds:.1f} s ({'built' if seconds else 'cached'}); "
        f"registers per thread {regs}; spills: {spills or 'none'}")


def _inputs(b, lq, lk, h, hd, dtype, mask_kind, gen):
    import torch

    dev = "cuda"
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, lq, h, hd), (b, lk, h, hd), (b, lk, h, hd)))
    if mask_kind == "shared":  # the last keys padded, as a filtered context would be
        m = torch.arange(lk, device=dev) < lk - max(1, lk // 20)
    elif mask_kind == "batch":
        m = torch.arange(lk, device=dev)[None] < torch.randint(
            1, lk + 1, (b, 1), generator=gen, device=dev)
    elif mask_kind == "batch_empty_row":
        m = torch.arange(lk, device=dev)[None] < torch.randint(
            1, lk + 1, (b, 1), generator=gen, device=dev)
        m[1] = False
    elif mask_kind == "shared_empty":
        m = torch.zeros(lk, dtype=torch.bool, device=dev)
    else:
        m = torch.ones(lk, dtype=torch.bool, device=dev)
    return q, k, v, m


def phase_kernel_parity():
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("encode/decode B17", 17, 2048, 2048, 2, 128, bf16, "shared"),
        ("encode/decode B25", 25, 2048, 2048, 2, 128, bf16, "shared"),
        ("ragged 1000x1500", 3, 1000, 1500, 2, 128, bf16, "shared"),
        ("per-batch mask", 4, 300, 700, 2, 128, bf16, "batch"),
        ("empty row", 4, 200, 333, 2, 128, bf16, "batch_empty_row"),
        ("empty shared mask", 2, 64, 100, 2, 32, bf16, "shared_empty"),
        ("hd16", 3, 500, 777, 2, 16, bf16, "batch"),
        ("hd32", 3, 500, 777, 2, 32, bf16, "shared"),
        ("f32 hd128", 2, 300, 700, 2, 128, f32, "batch"),
        ("f32 hd16 ragged", 3, 1000, 1500, 2, 16, f32, "shared"),
        ("f32 hd32 empty row", 4, 100, 250, 2, 32, f32, "batch_empty_row"),
    ]
    main_err = None
    for name, b, lq, lk, h, hd, dtype, mask_kind in cases:
        q, k, v, m = _inputs(b, lq, lk, h, hd, dtype, mask_kind, gen)
        out = fa.flash_row_attention(q, k, v, m)
        torch.cuda.synchronize()
        ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
        ref = ref * fa._any_valid_gate(m, torch.float32)
        err = (out.float() - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        tol = TOL_F32 if dtype == f32 else TOL_BF16 * scale
        ok = math.isfinite(err) and err <= tol
        if mask_kind == "batch_empty_row":
            ok = ok and bool((out[1] == 0).all())
        if mask_kind == "shared_empty":
            ok = ok and bool((out == 0).all())
        log(f"kernel vs plain [{name}] B{b} Lq{lq} Lk{lk} H{h} hd{hd} {str(dtype)[6:]} "
            f"{mask_kind}: max_abs_err {err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")
        if name == "encode/decode B25":
            main_err = err
    return main_err


def phase_kernel_time():
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    b, lq, lk, h, hd = 25, 2048, 2048, 2, 128  # one decode chunk of a width-24 step
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, m = _inputs(b, lq, lk, h, hd, torch.bfloat16, "all", gen)
    ms = cuda_time_ms(lambda: fa.flash_row_attention(q, k, v, m))
    plain_ms = cuda_time_ms(lambda: fa.reference_row_attention(q, k, v, m), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask4 = m[None, None, None, :]
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4))
    flops = 4.0 * b * h * lq * int(m.sum()) * hd
    nbytes = 2.0 * (2 * b * lq * h * hd + 2 * b * lk * h * hd) + m.numel()
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    log(f"kernel time [B{b} Lq{lq} Lk{lk} H{h} hd{hd} bf16]: {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s); bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops:.3e} FLOP, {nbytes:.3e} B); plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_main_path():
    import torch

    from npe_pfn_tpu_torch import NPEPFN, get_task, load_default
    from npe_pfn_tpu_torch.models import checkpoint
    from npe_pfn_tpu_torch.ops.flash_attention import flash_row_attention

    dev = torch.device("cuda")
    model = load_default(dev)
    cfg = model.cfg
    log(f"main path: checkpoint {checkpoint.default_checkpoint_path()}: d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}, {cfg.num_layers} layers, {cfg.num_bars} bars, "
        f"dtype {cfg.dtype}, scores {cfg.scores_dtype}")
    task = get_task("gaussian_linear", dim=10, device=dev)
    # Simulated from a CPU generator (10k x 10 numbers), so that the CPU
    # calibration of the posterior bound sees the same observations.
    cpu_task = get_task("gaussian_linear", dim=10, device="cpu")
    theta, x = (a.to(dev) for a in cpu_task.simulate(torch.Generator().manual_seed(0), 10_000))
    est = NPEPFN(prior=task.prior, model=model, filter_type="standardized_euclidean_filtering",
                 filter_context_size=2048, qry_chunk=2048, seed=0)
    est.append_simulations(theta, x)
    num = 10_240

    t0 = time.perf_counter()
    est.sample(num, x[0])  # warm-up: cuBLAS handles, caching allocator
    torch.cuda.synchronize()
    log(f"main path: warm-up sample({num}) {time.perf_counter() - t0:.3f} s")

    flash_row_attention.launches = 0
    requests = []
    for i in range(3):
        before = flash_row_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = est.sample(num, x[i + 1], generator=torch.Generator(dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_row_attention.launches - before
        requests.append((x[i + 1], samples, seconds, launches))
    total_launches = flash_row_attention.launches

    for i, (x_o, samples, seconds, launches) in enumerate(requests):
        if samples.shape != (num, 10) or not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"request {i}: bad samples {tuple(samples.shape)}")
        if launches != 480:
            raise AssertionError(f"request {i}: {launches} kernel launches, expected 480")
        mu, sd = task.posterior_moments(x_o)
        mean_z = ((samples.mean(0) - mu).abs() / sd).max().item()
        ratio = samples.std(0) / sd
        ok = mean_z <= MAX_MEAN_Z and STD_RATIO[0] <= ratio.min().item() \
            and ratio.max().item() <= STD_RATIO[1]
        log(f"request {i}: sample({num}) {seconds:.4f} s = {num / seconds:.1f} samples/s; "
            f"kernel launches {launches}; max |mean - posterior mean| / posterior std "
            f"{mean_z:.3f} (bound {MAX_MEAN_Z}); std / posterior std "
            f"{ratio.min().item():.3f}..{ratio.max().item():.3f} (bound {STD_RATIO}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"request {i}: samples disagree with the analytic posterior")
    return est, requests[0], total_launches


def phase_path_parity(est, request):
    import torch

    from npe_pfn_tpu_torch import estimator
    from npe_pfn_tpu_torch.ops.flash_attention import flash_row_attention

    x_o, samples, _, _ = request
    theta_ctx, x_ctx, ctx_mask = est.get_context(x_o)
    x_qry = x_o.broadcast_to((samples.shape[0], x_o.shape[0]))
    lps = {}
    for flash in ("auto", "off"):
        model = dataclasses.replace(est.model, cfg=dataclasses.replace(est.model.cfg, flash=flash))
        before = flash_row_attention.launches
        lps[flash] = estimator.autoregressive_log_prob(
            model, theta_ctx, x_ctx, ctx_mask, x_qry, samples, qry_chunk=est.qry_chunk)
        torch.cuda.synchronize()
        used = flash_row_attention.launches - before
        if (used > 0) != (flash == "auto"):
            raise AssertionError(f"flash={flash!r} launched the kernel {used} times")
    diff = (lps["auto"] - lps["off"]).abs()
    if not bool(torch.isfinite(lps["auto"]).all() and torch.isfinite(lps["off"]).all()):
        raise AssertionError("non-finite log_prob")
    med, p99, mx = (diff.median().item(), diff.quantile(0.99).item(), diff.max().item())
    spread = lps["off"].std().item()
    ok = med <= MAX_MEDIAN_ABS_LP_DIFF and p99 <= MAX_P99_ABS_LP_DIFF
    log(f"kernel path vs dense path: autoregressive_log_prob of {samples.shape[0]} samples: "
        f"|diff| median {med:.4f} (bound {MAX_MEDIAN_ABS_LP_DIFF}), p99 {p99:.4f} "
        f"(bound {MAX_P99_ABS_LP_DIFF}), max {mx:.4f}; log_prob std across samples "
        f"{spread:.3f}; mean log_prob kernel {lps['auto'].mean().item():.4f} dense "
        f"{lps['off'].mean().item():.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel path disagrees with the dense path")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this check runs on a CUDA card",
              file=sys.stderr)
        return 2
    import npe_pfn_tpu_torch  # noqa: F401  (fails at once outside the checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    max_abs_err = phase_kernel_parity()
    timing = phase_kernel_time()
    est, request, launches = phase_main_path()
    phase_path_parity(est, request)
    kernels = [{
        "name": "flash_row_attention",
        "route": "cuda",
        "source": "npe_pfn_tpu_torch/ops/csrc/flash_row_attention.cu",
        "replaces": "npe_pfn_tpu/ops/flash_attention.py:34",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing,
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(DEADLINE_S)
    # A hang inside a CUDA call never returns to Python; this ends it anyway.
    faulthandler.dump_traceback_later(DEADLINE_S + 30, exit=True)
    sys.exit(main())
