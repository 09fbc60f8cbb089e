#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (npe_pfn_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Each kernel source holds two designs, picked by dtype and head_dim
(flash_attention.kernel_design): "wgmma" (Hopper: TMA, mbarrier ring, wgmma
with register accumulators) for bf16 at head_dim 128, the shape both paths
run, and "wmma" for f32 and head_dim 16/32.

Phases, each printing its own lines:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds the kernel sources from the checkout, in parallel;
     registers and spills per kernel from the -Xptxas -v log;
  3. the kernel against its plain PyTorch version on the card, over the
     main-path shapes, ragged lengths, per-batch and empty masks, head_dim
     16/32/128 and f32 inputs (both designs);
  4. the kernel's time at the two main-path shapes (B 17 and 25) beside its
     bound, TFLOP/s, share of the bound, registers and spills, the plain
     version's time and scaled_dot_product_attention's (a yardstick only:
     the port never calls it);
  5. the main path at full width: the shipped checkpoint in bf16, 10k
     gaussian_linear simulations, NPEPFN(filter_context_size=2048,
     qry_chunk=2048) serving three sample(10_240) requests, each of which
     must launch the kernel 480 times (10 dims x 8 layers x (1 encode + 5
     decode chunks)), every launch the wgmma design's; samples are checked
     against the analytic posterior;
  6. autoregressive_log_prob of one request's samples through the kernel
     (flash="auto") against the dense path (flash="off");
  7. the training kernels (the lse forward and the backward) against their
     plain versions: the two training shapes, ragged, per-batch and empty
     masks, head_dim 16/32/128, bf16 and f32, and two backward calls that
     must agree bit for bit;
  8. their times at the training shapes beside their bounds, TFLOP/s, share
     of the bound, registers and spills, the plain versions' and
     scaled_dot_product_attention's (a yardstick only);
  9. the training path at full width: tabica_v6_best warm-started into the
     pretrain_v7 recipe (8 datasets of 768 + 128 rows, bf16, remat), 1 + 20
     train_steps with finite loss and gradient norm and exactly 32 lse and 15
     backward launches per step, all of the wgmma design; then train.train()
     for 3 steps with a validation and checkpoints in a temporary directory;
 10. one fixed batch: loss and gradients through the kernels against the
     dense path with f32 scores;
 11. the NLL of tabica_v6_best on 4 x 32 tasks of the port's prior at lr 0,
     inside a band calibrated on the CPU against the JAX prior, and a random
     model's outside it.
Then one JSON line of the kernels, and last {"ok": true, "device": {...}}.
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

# The whole run, nvcc builds included, took 70-89 s on an H100 (PERF.md);
# 450 s leaves a margin of about 5x and still ends a hang (exit != 0, with a
# message) long before any outer time limit would cut the run.
DEADLINE_S = 450

SOURCES = ("flash_row_attention.cu", "flash_row_attention_bwd.cu")

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


# The wgmma design's kernels, by a piece of their mangled names in the ptxas log.
WGMMA_KERNELS = {"fwd": "2wg10fwd_kernelILb0E", "fwd_lse": "2wg10fwd_kernelILb1E",
                 "dkdv": "2wg11dkdv_kernel", "dq": "2wg9dq_kernel"}


def ptxas_kernels(build_log):
    """{mangled entry name: (registers, spill store bytes, spill load bytes)}
    from an ``-Xptxas -v`` log."""
    out, name, spill = {}, None, (0, 0)
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif "bytes spill stores" in line and name:
            parts = line.replace(",", "").split()
            spill = (int(parts[parts.index("spill") - 2]), int(parts[-4]))
        elif "Used" in line and "registers" in line and name:
            out[name] = (int(line.split("Used")[1].split("registers")[0]), *spill)
            name = None
    return out


def phase_build():
    """Build every kernel source at once, one nvcc process each; returns the
    wgmma kernels' registers and spills, {short name: (regs, stores, loads)}."""
    from concurrent.futures import ThreadPoolExecutor

    from npe_pfn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(_build.build, SOURCES))
    regs_of = {}
    for path, seconds, build_log in results:
        kernels = ptxas_kernels(build_log)
        regs = sorted({r for r, _, _ in kernels.values()})
        spills = sorted({(st, ld) for _, st, ld in kernels.values() if st or ld})
        log(f"build: {path.name} nvcc {seconds:.1f} s ({'built' if seconds else 'cached'}); "
            f"{len(kernels)} kernels, registers per thread {regs}; spill stores/loads (bytes) "
            f"{spills or 'none'}")
        for short, piece in WGMMA_KERNELS.items():
            for name, info in kernels.items():
                if piece in name:
                    regs_of[short] = info
        for line in build_log.splitlines():
            if "C7512" in line or "C7508" in line:  # wgmma serialised / setmaxnreg ignored
                log(f"build: ptxas: {line.split(':', 1)[1].strip()[:160]}")
    for short, (r, st, ld) in regs_of.items():
        log(f"build: wgmma design {short}: {r} registers at launch, spill stores {st} B, "
            f"spill loads {ld} B")
    if set(regs_of) != set(WGMMA_KERNELS):
        raise AssertionError(f"ptxas log lacks wgmma kernels: {set(WGMMA_KERNELS) - set(regs_of)}")
    log(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.1f} s wall")
    return regs_of


def _regs(regs_of, *names):
    return "; ".join(f"{n} {regs_of[n][0]} regs, spills {regs_of[n][1]}/{regs_of[n][2]} B"
                     for n in names)


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
    elif mask_kind == "batch_one_key":
        m = torch.arange(lk, device=dev)[None] < torch.randint(
            1, lk + 1, (b, 1), generator=gen, device=dev)
        m[0] = torch.arange(lk, device=dev) < 1
    elif mask_kind == "shared_empty":
        m = torch.zeros(lk, dtype=torch.bool, device=dev)
    elif mask_kind == "batch_full":
        m = torch.ones((b, lk), dtype=torch.bool, device=dev)
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


def phase_kernel_time(regs_of):
    """The inference kernel at the path's two shapes: B 25 (one decode chunk
    of a width-24 step, the kernels line's main shape) and B 17."""
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    rows = {}
    for b in (25, 17):
        lq, lk, h, hd = 2048, 2048, 2, 128
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
        bound_ms, bound_by = _attention_bound(flops, nbytes)
        log(f"kernel time [B{b} Lq{lq} Lk{lk} H{h} hd{hd} bf16, "
            f"{fa.kernel_design(q.dtype, hd)}]: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / ms:.1%} of the bound); bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops:.3e} FLOP, {nbytes:.3e} B); plain {plain_ms:.4f} ms; "
            f"scaled_dot_product_attention {library_ms:.4f} ms; {_regs(regs_of, 'fwd')}")
        rows[f"B{b}"] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
    return rows


# Phase 7 tolerances. lse (f32 either way): 1e-5 x max(1, |lse|), the
# order of f32 sums. Output: f32 1e-5 absolute; bf16 1e-2 per slice (bf16
# output rounding, P cast to bf16 before P.V). Gradients per slice: f32 1e-5
# (f32 FMA in both, sums in another order); bf16 2e-2 (the kernel rounds P
# and dS to bf16 before their products, the plain version keeps f32). "Per
# slice" is max |kernel - plain| / max |plain| within each (batch row, head),
# then the largest: with per-batch masks a row with few keys has gradients
# hundreds of times those of a row with many, so one scale for the whole
# tensor would hide a wrong long row. The exception is dq and dk of a row
# with one valid key: P is one-hot there, so delta = dP and dS = 0, and the
# exact gradients are zero. The plain version holds only f32 rounding there
# (about 1e-6), so those rows are read against the whole tensor's max |plain|.
TOL_LSE = 1e-5
TOL_GRAD_F32 = 1e-5
TOL_GRAD_BF16 = 2e-2

# The training shapes of the pretrain_v7 recipe: 8 datasets x 33 cell
# tokens = 264 batch rows, 2 heads of 128, 768 context rows, 128 queries.
TRAIN_B, TRAIN_H, TRAIN_HD, TRAIN_CTX, TRAIN_QRY = 264, 2, 128, 768, 128


def _rel_err(out, ref, zero_rows=None):
    """Largest max |out - ref| / max |ref| over the (batch row, head) slices
    of two [B, L, H, hd] tensors; a slice whose ref is all zero must match
    it exactly. Batch rows where ``zero_rows`` ([B] bool) is set, whose exact
    value is zero, are read against the whole tensor's max |ref|."""
    import torch

    err = (out.float() - ref.float()).abs().amax(dim=(1, 3))
    scale = ref.float().abs().amax(dim=(1, 3))
    if zero_rows is not None:
        scale = torch.where(zero_rows[:, None], ref.float().abs().max(), scale)
    exact = torch.where(err == 0, 0.0, math.inf)
    return torch.where(scale > 0, err / scale.clamp_min(1e-30), exact).max().item()


def phase_train_kernel_parity():
    """The lse forward and the backward against their plain versions."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("train context", TRAIN_B, TRAIN_CTX, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
        ("train query", TRAIN_B, TRAIN_QRY, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
        ("ragged 1000x1500", 3, 1000, 1500, 2, 128, bf16, "shared"),
        ("empty row", 4, 200, 333, 2, 128, bf16, "batch_empty_row"),
        ("empty shared mask", 2, 64, 100, 2, 32, bf16, "shared_empty"),
        ("hd16", 3, 500, 777, 2, 16, bf16, "batch"),
        ("hd32", 3, 500, 777, 2, 32, bf16, "shared"),
        ("f32 hd128", 2, 300, 700, 2, 128, f32, "batch"),
        ("f32 hd16 ragged", 3, 1000, 1500, 2, 16, f32, "shared"),
        ("f32 hd32 empty row", 4, 100, 250, 2, 32, f32, "batch_empty_row"),
        ("one-key row", 4, 200, 333, 2, 128, bf16, "batch_one_key"),
        ("f32 hd128 one-key row", 4, 200, 333, 2, 128, f32, "batch_one_key"),
    ]
    errs = {}
    for name, b, lq, lk, h, hd, dtype, mask_kind in cases:
        q, k, v, m = _inputs(b, lq, lk, h, hd, dtype, mask_kind, gen)
        d_out = torch.randn((b, lq, h, hd), generator=gen, device="cuda").to(dtype)
        out, lse = fa.flash_row_attention_lse(q, k, v, m)
        grads = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.reference_row_attention_lse(q.float(), k.float(), v.float(), m)
        gate = fa._any_valid_gate(m, torch.float32)
        ref_out = ref_out * gate
        # The plain backward gets the kernel's own out and lse, so that it
        # holds the backward alone.
        ref_grads = fa.reference_row_attention_bwd(q, k, v, m, out, lse, d_out)
        if dtype == f32:
            out_err = (out - ref_out).abs().max().item()
        else:
            out_err = _rel_err(out, ref_out)
        out_tol = TOL_F32 if dtype == f32 else TOL_BF16
        valid_rows = (gate.reshape(-1) > 0) if m.dim() == 2 else (gate > 0).reshape(1)
        lse_v, ref_lse_v = (x[valid_rows] if m.dim() == 2 else x for x in (lse, ref_lse))
        lse_err = ((lse_v - ref_lse_v).abs() / ref_lse_v.abs().clamp_min(1.0)).max().item() \
            if lse_v.numel() else 0.0
        one_key = (m.sum(dim=-1) == 1).reshape(-1).expand(b)  # per batch row
        grad_errs = [_rel_err(g, r, z) for g, r, z in zip(grads, ref_grads,
                                                         (one_key, one_key, None))]
        grad_tol = TOL_GRAD_F32 if dtype == f32 else TOL_GRAD_BF16
        ok = (out_err <= out_tol and lse_err <= TOL_LSE and max(grad_errs) <= grad_tol
              and all(math.isfinite(e) for e in (out_err, lse_err, *grad_errs)))
        if mask_kind in ("batch_empty_row", "shared_empty"):
            rows = slice(1, 2) if mask_kind == "batch_empty_row" else slice(None)
            ok = ok and all(bool((g[rows] == 0).all()) for g in (out, *grads))
        log(f"lse fwd + bwd vs plain [{name}] B{b} Lq{lq} Lk{lk} H{h} hd{hd} {str(dtype)[6:]} "
            f"{mask_kind}: out {'abs' if dtype == f32 else 'rel'} {out_err:.3e} "
            f"(tol {out_tol:.0e}), lse rel {lse_err:.3e} "
            f"(tol {TOL_LSE:.0e}), dq/dk/dv rel {grad_errs[0]:.3e}/{grad_errs[1]:.3e}/"
            f"{grad_errs[2]:.3e} (tol {grad_tol:.0e}); {int(one_key.sum())} one-key rows "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"lse forward or backward disagrees with its plain version: {name}")
        if name == "train context":
            errs = {"lse": (out.float() - ref_out).abs().max().item(),
                    "bwd": max((g.float() - r.float()).abs().max().item()
                               for g, r in zip(grads, ref_grads))}
    # Bitwise repeatability of the backward (no atomics) at the context shape.
    q, k, v, m = _inputs(TRAIN_B, TRAIN_CTX, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch", gen)
    d_out = torch.randn(q.shape, generator=gen, device="cuda").to(bf16)
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    first = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    second = fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"backward repeats bit for bit at the context shape: {same}")
    if not same:
        raise AssertionError("two backward calls on the same inputs differ")
    return errs


def _attention_bound(flops, nbytes):
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if bound_flops_ms >= bound_bytes_ms else "bytes"
    return max(bound_flops_ms, bound_bytes_ms), by


def phase_train_kernel_time(regs_of):
    """Times of the lse forward and the backward at the two training shapes,
    beside their bounds, plain versions and scaled_dot_product_attention
    (forward, and forward + backward through autograd; a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for shape, lq in (("context", TRAIN_CTX), ("query", TRAIN_QRY)):
        b, lk, h, hd = TRAIN_B, TRAIN_CTX, TRAIN_H, TRAIN_HD
        q, k, v, m = _inputs(b, lq, lk, h, hd, torch.bfloat16, "batch_full", gen)
        d_out = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa.flash_row_attention_lse(q, k, v, m)
        fwd_ms = cuda_time_ms(lambda: fa.flash_row_attention_lse(q, k, v, m))
        bwd_ms = cuda_time_ms(lambda: fa.flash_row_attention_bwd(q, k, v, m, out, lse, d_out))
        plain_fwd_ms = cuda_time_ms(lambda: fa.reference_row_attention_lse(q, k, v, m), iters=3)
        plain_bwd_ms = cuda_time_ms(
            lambda: fa.reference_row_attention_bwd(q, k, v, m, out, lse, d_out), iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        mask4 = m[:, None, None, :]
        dot = d_out.transpose(1, 2).contiguous()
        with torch.no_grad():
            lib_fwd_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4))

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        lib_fwd_bwd_ms = cuda_time_ms(lib_fwd_bwd)
        # Work this run's data needs: masked keys do no useful work.
        pairs = float(m.float().sum(dim=-1).sum().item()) * h * lq
        qo_bytes = b * lq * h * hd * 2  # bf16
        kv_bytes = b * lk * h * hd * 2
        small = 4 * b * h * lq + m.numel() * m.element_size()  # lse (f32) and the mask
        fwd_work = (4.0 * pairs * hd, 2 * qo_bytes + 2 * kv_bytes + small)
        bwd_work = (10.0 * pairs * hd, 4 * qo_bytes + 4 * kv_bytes + small)
        fwd_bound, bwd_bound = _attention_bound(*fwd_work), _attention_bound(*bwd_work)
        design = fa.kernel_design(q.dtype, hd)
        log(f"lse forward [{shape} B{b} Lq{lq} Lk{lk} H{h} hd{hd} bf16, {design}]: "
            f"{fwd_ms:.4f} ms ({fwd_work[0] / fwd_ms / 1e9:.1f} TFLOP/s, "
            f"{fwd_bound[0] / fwd_ms:.1%} of the bound); bound {fwd_bound[0]:.4f} ms by "
            f"{fwd_bound[1]} ({fwd_work[0]:.3e} FLOP, {fwd_work[1]:.3e} B); plain "
            f"{plain_fwd_ms:.4f} ms; scaled_dot_product_attention forward {lib_fwd_ms:.4f} ms; "
            f"{_regs(regs_of, 'fwd_lse')}")
        log(f"backward [{shape}, {design}]: {bwd_ms:.4f} ms ({bwd_work[0] / bwd_ms / 1e9:.1f} "
            f"TFLOP/s of the five products, {bwd_bound[0] / bwd_ms:.1%} of the bound); bound "
            f"{bwd_bound[0]:.4f} ms by {bwd_bound[1]} ({bwd_work[0]:.3e} FLOP, "
            f"{bwd_work[1]:.3e} B); plain {plain_bwd_ms:.4f} ms; scaled_dot_product_attention "
            f"forward + backward {lib_fwd_bwd_ms:.4f} ms, backward alone "
            f"{lib_fwd_bwd_ms - lib_fwd_ms:.4f} ms (port forward + backward "
            f"{fwd_ms + bwd_ms:.4f} ms); {_regs(regs_of, 'dkdv', 'dq')}")
        rows[shape] = {
            "lse": dict(ms=fwd_ms, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms,
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1]),
            "bwd": dict(ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=lib_fwd_bwd_ms,
                        bound_ms=bwd_bound[0], bound_by=bwd_bound[1]),
        }
    return rows


def train_recipe():
    """The pretrain_v7 fine-tune (scripts/pretrain_v7.sh), at full width:
    tabica_v6_best's trunk, 1024 bars, bf16, 8 datasets of 768 + 128 rows."""
    from npe_pfn_tpu_torch.models import TabICAConfig
    from npe_pfn_tpu_torch.pretrain import prior, train

    cfg = TabICAConfig(d_model=256, num_heads=2, num_layers=8, mlp_ratio=4, max_features=32,
                       num_bars=1024, dtype="bfloat16", scores_dtype="bfloat16")
    tcfg = train.TrainConfig(num_datasets=8, lr=1.5e-4, warmup_steps=1000, max_steps=24_000,
                             b2=0.95, weight_decay=1e-4, grad_clip=1.0, ckpt_every=500)
    pcfg = prior.PriorConfig(num_features=32, num_ctx=TRAIN_CTX, num_qry=TRAIN_QRY,
                             **PRIOR_V7)
    return cfg, tcfg, pcfg


# pretrain_v7's prior knobs (the rest at PriorConfig's defaults).
PRIOR_V7 = dict(p_heteroscedastic=0.3, p_heavy_tail=0.2, p_categorical_feats=0.2,
                p_multimodal=0.3, p_sym_fold=0.7, mm_mu_input_scale=0.3, mm_sig_lo=-1.7,
                p_marginal_mixture=0.5)
TRAIN_STEPS = 20  # timed, after one warm-up step


def _shipped_checkpoint():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                        "tabica_v6_best.npz")


def phase_train():
    """Warm-start tabica_v6_best and take 1 + 20 train_steps of the recipe;
    then run train.train() briefly, checkpoints into a temporary directory."""
    import os
    import tempfile

    import torch

    from npe_pfn_tpu_torch.models import checkpoint
    from npe_pfn_tpu_torch.ops import flash_attention as fa
    from npe_pfn_tpu_torch.pretrain import train, warmstart

    dev = torch.device("cuda")
    cfg, tcfg, pcfg = train_recipe()
    model = warmstart.load_warmstart(_shipped_checkpoint(), cfg, dev)
    params, borders = model.params, model.borders
    opt_state = train.make_optimizer(tcfg).init(params)
    tokens = tcfg.num_datasets * (pcfg.num_ctx + pcfg.num_qry) * (pcfg.num_features + 1)

    def step(i, params, opt_state):
        gen = torch.Generator(dev).manual_seed(train.derive_seed(tcfg.seed, i))
        return train.train_step(cfg, tcfg, pcfg, params, opt_state, borders, gen)

    t0 = time.perf_counter()
    params, opt_state, loss, gnorm = step(0, params, opt_state)
    torch.cuda.synchronize()
    log(f"train: warm-up step {time.perf_counter() - t0:.3f} s, loss {loss.item():.4f}, "
        f"gnorm {gnorm.item():.4f}")

    counters = (fa.flash_row_attention, fa.flash_row_attention_lse, fa.flash_row_attention_bwd)
    for c in counters:
        c.launches = c.wgmma_launches = c.wmma_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, gnorms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS + 1):
        params, opt_state, loss, gnorm = step(i, params, opt_state)
        losses.append(loss)
        gnorms.append(gnorm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    by_design = {c.__name__: (c.wgmma_launches, c.wmma_launches) for c in counters}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses, gnorms = torch.stack(losses).tolist(), torch.stack(gnorms).tolist()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or gnorm: {losses} {gnorms}")
    # Per step and layer: the context and the query row attention, each run
    # forward under remat and again in the backward's recomputation, then
    # back; except the last layer's context row attention, whose output
    # (the final context state) the loss never reads, so autograd skips its
    # backward (XLA drops it as dead code in the JAX package).
    want = {"flash_row_attention": 0,
            "flash_row_attention_lse": TRAIN_STEPS * 4 * cfg.num_layers,
            "flash_row_attention_bwd": TRAIN_STEPS * (2 * cfg.num_layers - 1)}
    log(f"train: {TRAIN_STEPS} steps in {seconds:.4f} s = {TRAIN_STEPS / seconds:.4f} steps/s = "
        f"{TRAIN_STEPS * tokens / seconds:.1f} tokens/s ({tokens} cell tokens per step); peak "
        f"memory {peak_gb:.3f} GB; loss {losses[0]:.4f}..{losses[-1]:.4f} (mean "
        f"{sum(losses) / len(losses):.4f}); gnorm {min(gnorms):.4f}..{max(gnorms):.4f}; "
        f"launches {launches} (expected {want}); (wgmma, wmma) {by_design}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if any(by_design[n] != (want[n], 0) for n in want):
        raise AssertionError(f"launches by design {by_design}: every one must be wgmma")

    # The trainer as a user runs it: warm start, log, validate, checkpoint.
    short = dataclasses.replace(tcfg, max_steps=3, warmup_steps=1, log_every=1, val_every=3,
                                ckpt_every=2)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "tabica_torch.npz")
        t0 = time.perf_counter()
        trained = train.train(cfg, short, pcfg, ckpt_path=ckpt, init_from=_shipped_checkpoint(),
                              log_path=os.path.join(tmp, "log.jsonl"), device=dev)
        back = checkpoint.load(ckpt, dev)
        same = all(torch.equal(back.params["head"][k].float(), trained.params["head"][k].float())
                   for k in ("w2", "b2"))
        files = sorted(os.listdir(tmp))
        log(f"train.train: 3 steps with a validation and checkpoints in "
            f"{time.perf_counter() - t0:.1f} s; files {files}; reloaded head equal: {same}")
        if not same or "tabica_torch.npz.train_state.npz" not in files:
            raise AssertionError("train.train did not write a checkpoint that loads back")
    return dict(steps_per_s=TRAIN_STEPS / seconds, launches=launches, peak_gb=peak_gb)


# Phase 10 bounds: kernel path vs dense path (scores in f32) on one batch,
# bf16 model. The first reading on an H100 was a relative loss difference of
# 2.1e-4, a global relative gradient error of 0.0317 and a cosine of 0.99951
# (1 - cosine 4.9e-4); the bounds sit at about 4x it (PERF.md).
MAX_REL_LOSS_DIFF = 8e-4
MAX_REL_GRAD_ERR = 0.12
MIN_GRAD_COSINE = 0.998


def phase_train_path_parity():
    """Loss and gradients of one fixed batch through the kernels against the
    dense path with f32 scores, same weights (tabica_v6_best, bf16)."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa
    from npe_pfn_tpu_torch.pretrain import prior, train, warmstart
    from npe_pfn_tpu_torch.utils import pytree_io

    dev = torch.device("cuda")
    cfg, tcfg, pcfg = train_recipe()
    model = warmstart.load_warmstart(_shipped_checkpoint(), cfg, dev)
    batch = prior.sample_tasks(torch.Generator(dev).manual_seed(123), tcfg.num_datasets, pcfg)
    out = {}
    for name, over in (("kernel", dict(flash="auto")),
                       ("dense", dict(flash="off", scores_dtype="float32"))):
        named = {n: p.detach().requires_grad_(True)
                 for n, p in pytree_io.flatten(model.params).items()}
        before = fa.flash_row_attention_bwd.launches
        loss = train.batch_loss(dataclasses.replace(cfg, **over), model.borders,
                                pytree_io.unflatten(named), batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        if (fa.flash_row_attention_bwd.launches > before) != (name == "kernel"):
            raise AssertionError(f"the {name} path took the wrong row attention")
        out[name] = (loss.item(), torch.cat([g.float().reshape(-1) for g in grads]))
    (lk, gk), (ld, gd) = out["kernel"], out["dense"]
    rel_loss = abs(lk - ld) / abs(ld)
    rel_grad = ((gk - gd).norm() / gd.norm()).item()
    cosine = (torch.dot(gk, gd) / (gk.norm() * gd.norm())).item()
    ok = rel_loss <= MAX_REL_LOSS_DIFF and rel_grad <= MAX_REL_GRAD_ERR and cosine >= MIN_GRAD_COSINE
    log(f"train path, kernel vs dense (f32 scores): loss {lk:.6f} vs {ld:.6f}, rel diff "
        f"{rel_loss:.3e} (bound {MAX_REL_LOSS_DIFF:.0e}); gradient rel err {rel_grad:.4f} "
        f"(bound {MAX_REL_GRAD_ERR}), cosine {cosine:.6f} (bound {MIN_GRAD_COSINE}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the training path through the kernels disagrees with the dense path")
    return dict(rel_loss=rel_loss, rel_grad=rel_grad, cosine=cosine)


# Phase 11: NLL of tabica_v6_best on the port's prior at 256 + 64 rows, read
# by train_step at lr 0: the mean over 4 batches of 32 tasks (one 32-task
# batch reads anywhere in about 0.5-1.0). The band is the pooled mean +- 4
# standard errors of such a mean over the JAX and the port priors, from
# scripts/calibrate_torch_prior_nll.py on the CPU (PERF.md).
NLL_BAND = (0.1902, 1.1132)
NLL_ROWS = (256, 64)
NLL_BATCHES = 4


def phase_prior_nll():
    import torch

    from npe_pfn_tpu_torch.models import TabICAModel
    from npe_pfn_tpu_torch.pretrain import prior, train, warmstart
    from npe_pfn_tpu_torch.utils import pytree_io

    dev = torch.device("cuda")
    cfg, tcfg, _ = train_recipe()
    pcfg = prior.PriorConfig(num_features=32, num_ctx=NLL_ROWS[0], num_qry=NLL_ROWS[1], **PRIOR_V7)
    still = dataclasses.replace(tcfg, num_datasets=32, lr=0.0)
    reads = {}
    for name in ("tabica_v6_best", "random init"):
        if name == "random init":
            model = TabICAModel.create(torch.Generator(dev).manual_seed(0), cfg, dev)
        else:
            model = warmstart.load_warmstart(_shipped_checkpoint(), cfg, dev)
        params, opt_state = model.params, train.make_optimizer(still).init(model.params)
        losses = []
        for i in range(NLL_BATCHES):
            gen = torch.Generator(dev).manual_seed(train.derive_seed(2024, i))
            params, opt_state, loss, _ = train.train_step(cfg, still, pcfg, params, opt_state,
                                                          model.borders, gen)
            losses.append(loss.item())
        before = pytree_io.flatten(model.params)
        moved = max((a - before[n]).abs().max().item()
                    for n, a in pytree_io.flatten(params).items())
        if moved != 0.0:
            raise AssertionError(f"lr 0 moved the parameters by {moved}")
        reads[name] = sum(losses) / len(losses)
        log(f"prior NLL at lr 0, {name}: batches {[round(x, 4) for x in losses]}, mean "
            f"{reads[name]:.4f}")
    lo, hi = NLL_BAND
    ok = lo <= reads["tabica_v6_best"] <= hi and not lo <= reads["random init"] <= hi
    log(f"prior NLL at lr 0, {NLL_BATCHES} x 32 tasks of {NLL_ROWS[0]} + {NLL_ROWS[1]} rows: "
        f"tabica_v6_best {reads['tabica_v6_best']:.4f}, random init {reads['random init']:.4f}; "
        f"band [{lo}, {hi}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("prior NLL outside its band (or a random model inside it)")
    return reads


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
    flash_row_attention.wgmma_launches = flash_row_attention.wmma_launches = 0
    requests = []
    for i in range(3):
        before = (flash_row_attention.launches, flash_row_attention.wgmma_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = est.sample(num, x[i + 1], generator=torch.Generator(dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (flash_row_attention.launches - before[0],
                    flash_row_attention.wgmma_launches - before[1])
        requests.append((x[i + 1], samples, seconds, launches))
    total_launches = flash_row_attention.launches
    if flash_row_attention.wmma_launches:
        raise AssertionError(f"{flash_row_attention.wmma_launches} launches of the wmma design")

    for i, (x_o, samples, seconds, launches) in enumerate(requests):
        if samples.shape != (num, 10) or not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"request {i}: bad samples {tuple(samples.shape)}")
        if launches != (480, 480):
            raise AssertionError(f"request {i}: (all, wgmma) kernel launches {launches}, "
                                 f"expected (480, 480)")
        mu, sd = task.posterior_moments(x_o)
        mean_z = ((samples.mean(0) - mu).abs() / sd).max().item()
        ratio = samples.std(0) / sd
        ok = mean_z <= MAX_MEAN_Z and STD_RATIO[0] <= ratio.min().item() \
            and ratio.max().item() <= STD_RATIO[1]
        log(f"request {i}: sample({num}) {seconds:.4f} s = {num / seconds:.1f} samples/s; "
            f"kernel launches {launches[0]} ({launches[1]} wgmma); max |mean - posterior mean| "
            f"/ posterior std "
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
    regs_of = phase_build()
    max_abs_err = phase_kernel_parity()
    timing = phase_kernel_time(regs_of)
    est, request, launches = phase_main_path()
    phase_path_parity(est, request)
    del est, request
    train_errs = phase_train_kernel_parity()
    train_times = phase_train_kernel_time(regs_of)
    trained = phase_train()
    phase_train_path_parity()
    phase_prior_nll()
    csrc = "npe_pfn_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_row_attention",
        "route": "cuda",
        "source": csrc + "flash_row_attention.cu",
        "replaces": "npe_pfn_tpu/ops/flash_attention.py:34",
        "design": "wgmma",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing["B25"], "B17": timing["B17"],
        "registers": regs_of["fwd"][0], "spill_bytes": regs_of["fwd"][1],
    }]
    # Training kernels: launches over the 20 timed steps; times at the context
    # shape (B 264, 768 x 768), the query shape's under "query".
    for name, key, source, replaces, parts in (
        ("flash_row_attention_lse", "lse", "flash_row_attention.cu",
         "npe_pfn_tpu/ops/flash_attention.py:257", ("fwd_lse",)),
        ("flash_row_attention_bwd", "bwd", "flash_row_attention_bwd.cu",
         "npe_pfn_tpu/ops/flash_attention.py:284", ("dkdv", "dq")),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
            "design": "wgmma", "launches": trained["launches"][name],
            "max_abs_err": train_errs[key],
            **train_times["context"][key], "query": train_times["query"][key],
            "registers": max(regs_of[p][0] for p in parts),
            "spill_bytes": sum(regs_of[p][1] for p in parts),
        })
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
