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
  4. the kernel's time at the main path's two shapes (B 17 and 25), the
     ensemble decode's (B 100, 2048 x 512), the precompute's (B 250) and the
     evaluation harness's smallest and largest (B 9 and 33) beside its
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
     pretrain_v7 recipe (8 datasets of 768 + 128 rows, bf16, remat), 1 + 5
     train_steps with finite loss and gradient norm and exactly 32 lse and 15
     backward launches per step, all of the wgmma design; then train.train()
     for 2 steps with a validation and checkpoints in a temporary directory;
 10. one fixed batch: loss and gradients through the kernels against the
     dense path with f32 scores;
 11. the NLL of tabica_v6_best on 4 x 32 tasks of the port's prior at lr 0,
     inside a band calibrated on the CPU against the JAX prior, and a random
     model's outside it;
 12. sample_batched(1024) over 16 observations on a shared random context:
     the Normal prior (one round) and a box prior that forces three rounds
     and the escape hatch;
 13. log_prob of phase 5's samples against their own log-probs, and
     log_prob_batched of phase 12's draws against theirs;
 14. sample_batched_filtered(1024) over 8 observations, each on its own
     filtered context, in one stacked pass;
 15. sample(10_240) with 4 context members (quantile target and feature
     maps) and with 2 factorization orders;
 16. serving.CachedPosterior: all 10 dims encoded in one call, then
     decode-only sample(10_240) and log_prob;
 17. the evaluation metrics on the card: c2st reads chance on two draws of
     one Gaussian and on a paired joint sample sharing x, and detects shifted
     Gaussians; c2st_conv detects a bump image against noise; sinkhorn_w2
     lies within 10% of the exact W2;
 18. eval.harness.evaluate_task on all twelve tasks with the shipped
     checkpoint at num_cal 1000 (two_moons and slcp also at 10_000, filtered
     to 2048 rows), seed 0, after one timed call of each kind of reference
     sampler (grid, MCMC): every metric finite, every row attention on the
     wgmma design, and each task's c2st inside the band that
     scripts/calibrate_torch_eval.py calibrated on the CPU against the JAX
     package over seeds 0-9 (scripts/torch_eval_bands.json); the num_cal
     10_000 cells no higher than that band's upper edge;
 19. run_tsnpe on 10-D gaussian_linear (2 rounds x 1024 simulations,
     rejection truncation, 4096 support samples, candidate batches of
     16,384) with exact launches per step, sample(10_240) from the fitted
     estimator under phase 5's check, and one SIR round (oversample 32);
 20. sample_refined on two_moons and the ratio-based log_prob on 10-D
     gaussian_linear (scripts/torch_sequential_protocols.py, seed 0), each
     reading inside its band from the JAX package over seeds
     0-9 (scripts/torch_sequential_bands.json);
 21. audit_binary's ECE, RestrictedPrior, the unconditional estimator (4
     clusters on 4096 draws of N(0, I)) against their bands, and
     `python -m npe_pfn_tpu_torch tsnpe` in-process;
 22. the inference kernel at each new shape phases 19-21 launched, against
     its plain version and timed as in phase 4;
 23. pretraining at full width for a row-pooled model (row_pool_slots 8) and
     a mixture-of-experts model (num_experts 4, moe_top_k 2) on the
     pretrain_v7 trunk, from init_params (no checkpoint of either exists):
     1 + 3 train_steps each with finite loss and gradient norm and exact lse
     and backward launches, all wgmma; the MoE aux at init inside [0.95,
     2.05]; phase 10's kernel-vs-dense check on one batch for each;
 24. sample(10_240) from both models (phase 23's last weights) on phase 5's
     simulations: 480 launches a request; log_prob of a request's samples
     through the kernels against the dense path (phase 6's bounds) and
     against sample's own log-probs (the density bounds); with an f32 copy,
     encode + decode against the joint forward (1e-3 x max(1, |logit|));
 25. FlowNPE, the trained-flow baseline: on 2-D gaussian_linear (2000
     simulations) against the analytic posterior at tests/test_baselines.py's
     tolerances; on 10-D (10k simulations, 10 epochs) timed only;
 26. npe_pfn_tpu_torch.parallel in one NCCL group of one rank (the card
     holds one; NCCL takes a card per rank): sharded_autoregressive_sample
     of phase 5's first request (bit for bit, 480 launches); context
     sharding (gathered and ring), tensor, pipeline and expert parallelism
     on a 2048-row context against the single-device logits; 2 dp steps of
     the pretrain_v7 recipe against train_step (loss and gnorm equal);
     exact launches per kernel and design; the inference and lse kernels at
     H 1 (a 2-way tensor-parallel rank's shape) against their plain
     versions; the ring's lse merge against one kernel call.
Phase 20 also scores the committed classifier context of
scripts/torch_ratio_context.npz and holds the classifier's probabilities to
the CPU plain path's. Phases 3-4 and 7-8 include the row-pooled model's
kernel shapes (B 8 x 2048 x 2048 inference, B 64 x 768 x 768 and 64 x 128 x
768 training). Phases 12-16 and 19-21 time each call (phases 12-16 after a
warm-up call of their own) and assert that it launches only the wgmma
inference kernel (no wmma, no training kernel), in exact counts where
the loops fix them (every path but the refinement, the unconditional
estimator and the CLI, whose rejection rounds depend on the draws); phases
12-16 hold samples to phase 5's posterior check and log-probs to a second
reading of the same density.
Then one JSON line of the kernels, and last {"ok": true, "device": {...}}.
Any failure exits non-zero without the last line. It imports nothing of JAX.
"""

import dataclasses
import faulthandler
import functools
import json
import math
import signal
import subprocess
import sys
import time

# The whole run, nvcc builds included, takes 345-362 s on an H100 at 700 W
# (PERF.md), and over 450 s on a slow host. 1050 s leaves a margin of about
# 3x and still ends a hang (exit != 0, with the phases' times so far) before
# a 1200 s outer limit would cut the run.
DEADLINE_S = 1050

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


# Wall seconds of each finished phase, in order, and the phase running now.
PHASE_SECONDS = {}
RUNNING = [None]


def timed_phase(fn):
    """A phase: its wall time is logged and kept in PHASE_SECONDS."""
    @functools.wraps(fn)
    def phase(*args):
        RUNNING[0] = fn.__name__
        t0 = time.perf_counter()
        out = fn(*args)
        PHASE_SECONDS[fn.__name__] = round(time.perf_counter() - t0, 1)
        log(f"[{fn.__name__}] {PHASE_SECONDS[fn.__name__]} s")
        return out
    return phase


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke.py exceeded its {DEADLINE_S} s deadline in "
                       f"{RUNNING[0]}; finished phases (s): {PHASE_SECONDS}")


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


@timed_phase
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


@timed_phase
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
    elif mask_kind.startswith("first"):  # a context of n simulations padded to lk rows
        m = torch.arange(lk, device=dev) < int(mask_kind[len("first"):])
    else:
        m = torch.ones(lk, dtype=torch.bool, device=dev)
    return q, k, v, m


@timed_phase
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
        # the shapes of the rest of the API (phases 12-16)
        ("ensemble decode B100", 100, 2048, 512, 2, 128, bf16, "batch"),
        ("filtered decode B200", 200, 1024, 2048, 2, 128, bf16, "batch"),
        ("precompute B250", 250, 2048, 2048, 2, 128, bf16, "shared"),
        # the evaluation harness's (phase 18): B 9 (two_moons' 9 tokens) to 33
        # (gaussian_bump_image's 24 projected x + 3 θ, rounded up, + 1),
        # contexts of 10 to 1000 simulations (1000 padded to 1024 rows), 256
        # posterior samples per query chunk
        ("harness encode 10x10", 9, 10, 10, 2, 128, bf16, "all"),
        ("harness decode 256x10", 9, 256, 10, 2, 128, bf16, "all"),
        ("harness encode 1000x1000", 33, 1000, 1000, 2, 128, bf16, "all"),
        ("harness decode 256x1000", 33, 256, 1000, 2, 128, bf16, "all"),
        ("harness encode num_cal 1000", 9, 1024, 1024, 2, 128, bf16, "first1000"),
        ("harness decode num_cal 1000", 33, 256, 1024, 2, 128, bf16, "first1000"),
        # the row-pooled model's encode and decode chunks (phase 24): 8 slots
        ("pooled encode/decode B8", 8, 2048, 2048, 2, 128, bf16, "shared"),
    ]
    main_err = None
    for name, b, lq, lk, h, hd, dtype, mask_kind in cases:
        q, k, v, m = _inputs(b, lq, lk, h, hd, dtype, mask_kind, gen)
        design = fa.kernel_design(dtype, hd)
        counter = f"{design}_launches"
        before = getattr(fa.flash_row_attention, counter)
        out = fa.flash_row_attention(q, k, v, m)
        torch.cuda.synchronize()
        if getattr(fa.flash_row_attention, counter) != before + 1:
            raise AssertionError(f"[{name}] did not launch the {design} design")
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
            f"{mask_kind}, {design}: max_abs_err {err:.3e} (tol {tol:.1e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")
        if name == "encode/decode B25":
            main_err = err
    return main_err


# Phase 4's shapes (bf16, H 2, hd 128): B 25 (one decode chunk of a width-24
# step of sample(), the kernels line's main shape), B 17 (a width-16 step),
# the context-ensemble decode (4 members x 25 tokens, 2048 queries against
# 512 keys) and the CachedPosterior precompute (10 dims x 25 tokens).
TIME_SHAPES = (("B25", 25, 2048, 2048), ("B17", 17, 2048, 2048),
               ("B100_ensemble", 100, 2048, 512), ("B250_precompute", 250, 2048, 2048),
               # the evaluation harness's smallest and largest (phase 18)
               ("B9_encode_10x10", 9, 10, 10), ("B9_decode_256x10", 9, 256, 10),
               ("B33_encode_1000x1000", 33, 1000, 1000),
               ("B33_decode_256x1000", 33, 256, 1000),
               # the row-pooled model's encode and decode chunks (phase 24)
               ("B8_pooled", 8, 2048, 2048))


@timed_phase
def phase_kernel_time(regs_of):
    """The inference kernel at the paths' shapes, beside its bound, its plain
    version and scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    rows = {}
    for name, b, lq, lk in TIME_SHAPES:
        h, hd = 2, 128
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
        log(f"kernel time [{name}: B{b} Lq{lq} Lk{lk} H{h} hd{hd} bf16, "
            f"{fa.kernel_design(q.dtype, hd)}]: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / ms:.1%} of the bound); bound {bound_ms:.4f} ms by {bound_by} "
            f"({flops:.3e} FLOP, {nbytes:.3e} B); plain {plain_ms:.4f} ms; "
            f"scaled_dot_product_attention {library_ms:.4f} ms; {_regs(regs_of, 'fwd')}")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, qt, kt, vt
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
# The row-pooled model's (row_pool_slots 8): 8 datasets x 8 slots.
POOL_B = 64


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


@timed_phase
def phase_train_kernel_parity():
    """The lse forward and the backward against their plain versions."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("train context", TRAIN_B, TRAIN_CTX, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
        ("train query", TRAIN_B, TRAIN_QRY, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
        ("pooled context", POOL_B, TRAIN_CTX, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
        ("pooled query", POOL_B, TRAIN_QRY, TRAIN_CTX, TRAIN_H, TRAIN_HD, bf16, "batch"),
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


@timed_phase
def phase_train_kernel_time(regs_of):
    """Times of the lse forward and the backward at the two training shapes,
    beside their bounds, plain versions and scaled_dot_product_attention
    (forward, and forward + backward through autograd; a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for shape, b, lq in (("context", TRAIN_B, TRAIN_CTX), ("query", TRAIN_B, TRAIN_QRY),
                         ("pooled_context", POOL_B, TRAIN_CTX),
                         ("pooled_query", POOL_B, TRAIN_QRY)):
        lk, h, hd = TRAIN_CTX, TRAIN_H, TRAIN_HD
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
# Timed, after one warm-up step: 20 until phases 23-25 came, 5 since, to
# keep the whole script inside its deadline on a slow host (PERF.md §4).
TRAIN_STEPS = 5


def _shipped_checkpoint():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                        "tabica_v6_best.npz")


@timed_phase
def phase_train():
    """Warm-start tabica_v6_best and take 1 + TRAIN_STEPS train_steps of the recipe;
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
    short = dataclasses.replace(tcfg, max_steps=2, warmup_steps=1, log_every=1, val_every=2,
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
        log(f"train.train: 2 steps with a validation and checkpoints in "
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


@timed_phase
def phase_train_path_parity():
    """Loss and gradients of one fixed batch through the kernels against the
    dense path with f32 scores, same weights (tabica_v6_best, bf16)."""
    import torch

    from npe_pfn_tpu_torch.pretrain import warmstart

    cfg, _, _ = train_recipe()
    model = warmstart.load_warmstart(_shipped_checkpoint(), cfg, torch.device("cuda"))
    return train_path_parity("train path", cfg, model.params, model.borders)


def train_path_parity(label, cfg, params, borders):
    """Phase 10's check: the loss and gradients of one fixed batch of the
    recipe through the kernels against the dense path with f32 scores."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa
    from npe_pfn_tpu_torch.pretrain import prior, train
    from npe_pfn_tpu_torch.utils import pytree_io

    dev = torch.device(DEVICE)
    _, tcfg, pcfg = train_recipe()
    batch = prior.sample_tasks(torch.Generator(dev).manual_seed(123), tcfg.num_datasets, pcfg)
    out = {}
    for name, over in (("kernel", dict(flash="auto")),
                       ("dense", dict(flash="off", scores_dtype="float32"))):
        named = {n: p.detach().requires_grad_(True) for n, p in pytree_io.flatten(params).items()}
        before = fa.flash_row_attention_bwd.launches
        loss = train.batch_loss(dataclasses.replace(cfg, **over), borders,
                                pytree_io.unflatten(named), batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        if (fa.flash_row_attention_bwd.launches > before) != (name == "kernel"):
            raise AssertionError(f"the {name} path took the wrong row attention")
        out[name] = (loss.item(), torch.cat([g.float().reshape(-1) for g in grads]))
        del named, loss, grads
    (lk, gk), (ld, gd) = out["kernel"], out["dense"]
    rel_loss = abs(lk - ld) / abs(ld)
    rel_grad = ((gk - gd).norm() / gd.norm()).item()
    cosine = (torch.dot(gk, gd) / (gk.norm() * gd.norm())).item()
    ok = rel_loss <= MAX_REL_LOSS_DIFF and rel_grad <= MAX_REL_GRAD_ERR and cosine >= MIN_GRAD_COSINE
    log(f"{label}, kernel vs dense (f32 scores): loss {lk:.6f} vs {ld:.6f}, rel diff "
        f"{rel_loss:.3e} (bound {MAX_REL_LOSS_DIFF:.0e}); gradient rel err {rel_grad:.4f} "
        f"(bound {MAX_REL_GRAD_ERR}), cosine {cosine:.6f} (bound {MIN_GRAD_COSINE}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the kernels disagree with the dense path")
    return dict(rel_loss=rel_loss, rel_grad=rel_grad, cosine=cosine)


# Phase 11: NLL of tabica_v6_best on the port's prior at 256 + 64 rows, read
# by train_step at lr 0: the mean over 4 batches of 32 tasks (one 32-task
# batch reads anywhere in about 0.5-1.0). The band is the pooled mean +- 4
# standard errors of such a mean over the JAX and the port priors, from
# scripts/calibrate_torch_prior_nll.py on the CPU (PERF.md).
NLL_BAND = (0.1902, 1.1132)
NLL_ROWS = (256, 64)
NLL_BATCHES = 4


@timed_phase
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


@timed_phase
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
        gen = torch.Generator(dev).manual_seed(100 + i)
        samples, lps = est.sample(num, x[i + 1], generator=gen, return_log_probs=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (flash_row_attention.launches - before[0],
                    flash_row_attention.wgmma_launches - before[1])
        requests.append((x[i + 1], samples, seconds, launches, lps))
    total_launches = flash_row_attention.launches
    if flash_row_attention.wmma_launches:
        raise AssertionError(f"{flash_row_attention.wmma_launches} launches of the wmma design")

    for i, (x_o, samples, seconds, launches, _) in enumerate(requests):
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
    return est, task, x, requests[0], total_launches


@timed_phase
def phase_path_parity(est, request):
    import torch

    from npe_pfn_tpu_torch import estimator
    from npe_pfn_tpu_torch.ops.flash_attention import flash_row_attention

    x_o, samples = request[:2]
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
    lp_parity("autoregressive_log_prob", lps["auto"], lps["off"])


def lp_parity(label, kernel, dense):
    """Phase 6's bounds on |kernel - dense| over the rows of two log_prob
    readings of the same samples."""
    import torch

    if not bool(torch.isfinite(kernel).all() and torch.isfinite(dense).all()):
        raise AssertionError("non-finite log_prob")
    diff = (kernel - dense).abs()
    med, p99, mx = (diff.median().item(), diff.quantile(0.99).item(), diff.max().item())
    ok = med <= MAX_MEDIAN_ABS_LP_DIFF and p99 <= MAX_P99_ABS_LP_DIFF
    log(f"kernel path vs dense path: {label} of {kernel.shape[0]} samples: "
        f"|diff| median {med:.4f} (bound {MAX_MEDIAN_ABS_LP_DIFF}), p99 {p99:.4f} "
        f"(bound {MAX_P99_ABS_LP_DIFF}), max {mx:.4f}; log_prob std across samples "
        f"{dense.std().item():.3f}; mean log_prob kernel {kernel.mean().item():.4f} dense "
        f"{dense.mean().item():.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the kernel path disagrees with the dense path")


# Phases 12-16: the rest of the inference API at full width (the phase-5
# estimator and simulations). Each path runs with every kernel counter at 0
# and must launch the inference kernel exactly as often as its loops say, all
# of the wgmma design:
#   sample_batched(1024) over 16 observations, Normal prior: one round of
#     16 x 1536 = 24,576 rows = 12 chunks of 2048: 10 dims x 8 layers x
#     (1 encode + 12 decode) = 1040 per round;
#   log_prob of 10,240 rows: 10 x 8 x (1 + 5) = 480; log_prob_batched of
#     16 x 1024 rows, chunks of 10,240 and 6,144: 10 x 8 x (6 + 4) = 800;
#   sample_batched_filtered(1024) over 8 observations, one stacked pass of
#     1024 rows each: 10 x 8 x (1 + 1) = 160;
#   sample(10_240) with 4 context members: 10 x 8 x (1 + 5) = 480 (all
#     members in each launch); with 2 orders, 6,144 rows each: 2 x 10 x 8 x
#     (1 + 3) = 640;
#   CachedPosterior: 8 to encode all 10 dims at once, then 10 x 8 x 5 = 400
#     per sample(10_240).
BATCHED_OBS, FILTERED_OBS, PER_OBS, SAMPLES = 16, 8, 1024, 10_240
DEVICE = "cuda"
LAUNCHES = {"sample_batched": 1040, "log_prob": 480, "log_prob_batched": 800,
            "sample_batched_filtered": 160, "sample_ensembles_4": 480,
            "sample_order_ensembles_2": 640, "cached_precompute": 8, "cached_sample": 400}

# Posterior checks of the new paths, in the form of phase 5's (max over dims
# of |mean - posterior mean| / posterior std; std / posterior std), read on
# the same observations by scripts/calibrate_torch_posterior_check.py
# (--paths ... --first ...) on the CPU with the plain path (PERF.md). Phase
# 5's bounds where that reading sits inside them: ensembles, orders and the
# cache at 512 context rows (worst std ratio 1.106), sample_batched_filtered
# at the card's 2048 rows (mean z 0.462, std ratio 0.934..1.481; at 512 rows
# one observation read 1.634). sample_batched's shared random context gives
# observations far out in x a wider posterior (std ratio 1.815 at |x_o| 3.25
# at 512 rows; 2.102 on the card), beyond phase 5's 1.6, so its bounds are
# about 4x the CPU reading (mean z 0.807; std ratio 0.854..1.815, i.e. 4x
# the distance from 1 on each side).
POSTERIOR_BOUNDS = {
    "sample_batched": (3.2, (0.42, 4.26)),
    "sample_batched_filtered": (MAX_MEAN_Z, STD_RATIO),
    "sample_ensembles_4": (MAX_MEAN_Z, STD_RATIO),
    "sample_order_ensembles_2": (MAX_MEAN_Z, STD_RATIO),
    "cached_sample": (MAX_MEAN_Z, STD_RATIO),
}

# Density checks: |difference| of two readings of log q(θ | x) of the same
# rows on the same context and weights (the draw's own log-prob against
# log_prob; log_prob_batched against sample_batched's; CachedPosterior
# against log_prob, whose dims run at the full width where log_prob slices
# prefix widths). Bounded like phase 6, by the median and p99 over rows, at
# about 4x the first H100 reading: where the two readings run the same
# shapes they agreed to the bit; where the shapes differ (full width, or 8
# stacked contexts against one) the bf16 model read a median of 5.9e-3 and a
# p99 of 2.5e-2 nats (PERF.md).
MAX_MEDIAN_DENSITY_DIFF = 0.025
MAX_P99_DENSITY_DIFF = 0.1


def count_kernels(fn):
    """``fn()`` with every kernel counter at 0 just before it and read just
    after: (result, seconds, {kernel: (all, wgmma, wmma)})."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    counters = (fa.flash_row_attention, fa.flash_row_attention_lse, fa.flash_row_attention_bwd)
    for c in counters:
        c.launches = c.wgmma_launches = c.wmma_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        c.__name__: (c.launches, c.wgmma_launches, c.wmma_launches) for c in counters}


def run_counted(fn):
    """``fn()`` with every kernel counter set to 0 just before it and read
    just after: (result, seconds, inference kernel (all, wgmma, wmma))."""
    out, seconds, counts = count_kernels(fn)
    if counts["flash_row_attention_lse"][0] or counts["flash_row_attention_bwd"][0]:
        raise AssertionError("an inference path launched a training kernel")
    return out, seconds, counts["flash_row_attention"]


# The launches each path of phases 12-16 made, as counted, for the kernels line.
MEASURED_LAUNCHES = {}


def expect_launches(path, counts, rounds=1, key=None):
    want = LAUNCHES[path] * rounds
    if counts != (want, want, 0):
        raise AssertionError(f"{path}: (all, wgmma, wmma) launches {counts}, "
                             f"expected ({want}, {want}, 0)")
    MEASURED_LAUNCHES[key or path] = counts[0]


def posterior_check(path, task, xs, draws):
    """Phase 5's check on each observation's draws; returns the worst reading
    (max mean z, min and max std ratio) and logs the observations it came from."""
    import torch

    max_z, (lo, hi) = POSTERIOR_BOUNDS[path]
    reads = []
    for x_o, s in zip(xs, draws):
        if not bool(torch.isfinite(s).all()):
            raise AssertionError(f"{path}: non-finite samples")
        mu, sd = task.posterior_moments(x_o)
        r = s.std(0) / sd
        reads.append((((s.mean(0) - mu).abs() / sd).max().item(), r.min().item(), r.max().item()))
    worst = (max(z for z, _, _ in reads), min(a for _, a, _ in reads), max(b for _, _, b in reads))
    where = [max(range(len(reads)), key=lambda i: reads[i][0]),
             min(range(len(reads)), key=lambda i: reads[i][1]),
             max(range(len(reads)), key=lambda i: reads[i][2])]
    ok = worst[0] <= max_z and lo <= worst[1] and worst[2] <= hi
    log(f"{path}: posterior check over {len(draws)} observation(s): max |mean - posterior mean| "
        f"/ posterior std {worst[0]:.3f} (bound {max_z}); std / posterior std "
        f"{worst[1]:.3f}..{worst[2]:.3f} (bound {(lo, hi)}); worst at observations {where} of "
        f"the {len(draws)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{path}: samples disagree with the analytic posterior")
    return worst


def density_check(name, a, b):
    """Median and p99 of |a - b| over rows, against the density bounds."""
    import torch

    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError(f"{name}: non-finite log-probs")
    diff = (a - b).abs().flatten()
    med, p99, mx = diff.median().item(), diff.quantile(0.99).item(), diff.max().item()
    ok = med <= MAX_MEDIAN_DENSITY_DIFF and p99 <= MAX_P99_DENSITY_DIFF
    log(f"density check [{name}]: |diff| over {diff.numel()} rows: median {med:.3e} (bound "
        f"{MAX_MEDIAN_DENSITY_DIFF}), p99 {p99:.3e} (bound {MAX_P99_DENSITY_DIFF}), max "
        f"{mx:.3e}; mean log_prob {a.mean().item():.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the two readings of the density disagree")
    return dict(median=med, p99=p99, max=mx)


def _path_line(path, seconds, rows, counts, smi):
    log(f"{path}: {seconds:.4f} s per call, {rows / seconds:.1f} samples/s; kernel launches "
        f"{counts[0]} ({counts[1]} wgmma, {counts[2]} wmma), expected {LAUNCHES[path]} per "
        f"round; {smi}")


@timed_phase
def phase_sample_batched(est, task, x, smi):
    """sample_batched(1024) over 16 observations: Normal prior (one round),
    then a box that accepts few draws (three rounds and the escape hatch)."""
    import torch

    from npe_pfn_tpu_torch import NPEPFN
    from npe_pfn_tpu_torch.distributions import BoxUniform

    dev = torch.device(DEVICE)
    xs = x[10:10 + BATCHED_OBS]
    gen = lambda: torch.Generator(dev).manual_seed(200)  # noqa: E731
    est.sample_batched(PER_OBS, xs, generator=gen())  # warm-up
    (theta, lp), seconds, counts = run_counted(
        lambda: est.sample_batched(PER_OBS, xs, generator=gen(), return_log_probs=True))
    _path_line("sample_batched", seconds, BATCHED_OBS * PER_OBS, counts, smi)
    expect_launches("sample_batched", counts)
    diag = est.last_diagnostics
    if (theta.shape != (BATCHED_OBS, PER_OBS, 10) or diag["rounds"] != 1
            or int(diag["topped_up"].sum()) or diag["acceptance_rate"] != 1.0):
        raise AssertionError(f"sample_batched: shape {tuple(theta.shape)}, diagnostics {diag}")
    posterior_check("sample_batched", task, xs, theta)

    # θ_0 in [-0.05, 0.05], the other dims free: a few percent of the draws
    # land inside, so every observation is still short after max_iters rounds.
    low = torch.full((10,), -1e9, device=dev)
    high = torch.full((10,), 1e9, device=dev)
    low[0], high[0] = -0.05, 0.05
    box = NPEPFN(prior=BoxUniform(low, high), model=est.model, filter_context_size=2048,
                 qry_chunk=2048, seed=0)
    box.append_simulations(est._theta_train, est._x_train)
    boxed, box_seconds, counts = run_counted(
        lambda: box.sample_batched(PER_OBS, xs, generator=gen(), max_iters=3))
    diag = box.last_diagnostics
    log(f"sample_batched with a box prior: {box_seconds:.4f} s, {diag['rounds']} rounds, "
        f"acceptance {diag['acceptance_rate']:.4f}, topped up {diag['topped_up'].tolist()}; "
        f"kernel launches {counts}; {smi}")
    expect_launches("sample_batched", counts, rounds=diag["rounds"], key="sample_batched_box")
    inside = ((boxed >= low) & (boxed <= high)).all(dim=-1)
    for j in range(BATCHED_OBS):
        n_acc = PER_OBS - int(diag["topped_up"][j])
        unique = torch.unique(boxed[j], dim=0).shape[0]
        if not (bool(inside[j, :n_acc].all()) and not bool(inside[j, n_acc:].any())
                and unique == PER_OBS):
            raise AssertionError(f"sample_batched with a box prior: observation {j} has "
                                 f"accepted rows out of the box, fills inside it or duplicates")
    if diag["rounds"] != 3 or not bool((diag["topped_up"] > 0).all()):
        raise AssertionError(f"the box run did not take 3 rounds and the hatch: {diag}")
    return dict(seconds=seconds, box_seconds=box_seconds, xs=xs, theta=theta, lp=lp, gen=gen)


@timed_phase
def phase_densities(est, request, batched, smi):
    """log_prob of phase 5's first request against its own log-probs, and
    log_prob_batched of the sample_batched draws against theirs (the same
    random context, from the same generator seed)."""
    x_o, samples, _, _, lps = request
    est.log_prob(samples, x_o)  # warm-up
    lp, seconds, counts = run_counted(lambda: est.log_prob(samples, x_o))
    log(f"log_prob: {seconds:.4f} s for {samples.shape[0]} rows; kernel launches {counts}; {smi}")
    expect_launches("log_prob", counts)
    out = {"log_prob": density_check("log_prob vs sample's own log-probs", lp, lps)}
    lpb, seconds_b, counts = run_counted(
        lambda: est.log_prob_batched(batched["theta"], batched["xs"], generator=batched["gen"]()))
    log(f"log_prob_batched: {seconds_b:.4f} s for {lpb.numel()} rows; kernel launches {counts}; "
        f"{smi}")
    expect_launches("log_prob_batched", counts)
    out["log_prob_batched"] = density_check("log_prob_batched vs sample_batched's log-probs",
                                            lpb, batched["lp"])
    return lp, dict(log_prob=seconds, log_prob_batched=seconds_b, checks=out)


@timed_phase
def phase_filtered(est, task, x, smi):
    """sample_batched_filtered(1024) over 8 observations, each on its own
    nearest-2048 context; two observations' log-probs rescored by log_prob."""
    import torch

    xs = x[30:30 + FILTERED_OBS]
    gen = lambda: torch.Generator(DEVICE).manual_seed(300)  # noqa: E731
    est.sample_batched_filtered(PER_OBS, xs, generator=gen())  # warm-up
    (theta, lp), seconds, counts = run_counted(
        lambda: est.sample_batched_filtered(PER_OBS, xs, generator=gen(), return_log_probs=True))
    _path_line("sample_batched_filtered", seconds, FILTERED_OBS * PER_OBS, counts, smi)
    expect_launches("sample_batched_filtered", counts)
    posterior_check("sample_batched_filtered", task, xs, theta)
    again = torch.stack([est.log_prob(theta[j], xs[j]) for j in range(2)])
    check = density_check("sample_batched_filtered vs log_prob on each own context", lp[:2], again)
    return dict(seconds=seconds, check=check)


@timed_phase
def phase_ensembles(est, task, x_o, smi):
    """sample(SAMPLES) with 4 context members (quantile target and feature
    maps), its log-probs against log_prob; then with 2 factorization orders."""
    import torch

    from npe_pfn_tpu_torch import NPEPFN

    out = {}
    for path, kw in (("sample_ensembles_4", dict(num_ensembles=4, target_transform="quantile",
                                                 feature_transform="quantile")),
                     ("sample_order_ensembles_2", dict(num_order_ensembles=2))):
        ens = NPEPFN(prior=est.prior, model=est.model, filter_context_size=2048, qry_chunk=2048,
                     seed=0, **kw)
        ens.append_simulations(est._theta_train, est._x_train)
        ens.sample(SAMPLES, x_o)  # warm-up
        (s, lp), seconds, counts = run_counted(lambda: ens.sample(
            SAMPLES, x_o, generator=torch.Generator(DEVICE).manual_seed(400),
            return_log_probs=True))
        _path_line(path, seconds, SAMPLES, counts, smi)
        expect_launches(path, counts)
        posterior_check(path, task, [x_o], [s])
        out[path] = dict(seconds=seconds)
        if path == "sample_ensembles_4":
            out[path]["check"] = density_check("4-member mixture: sample vs log_prob", lp,
                                               ens.log_prob(s, x_o))
    return out


@timed_phase
def phase_cached(est, task, request, lp_ref, smi):
    """CachedPosterior on phase 5's first observation: one encode of all 10
    dims, sample(SAMPLES) decode-only, and log_prob against est.log_prob."""
    import torch

    from npe_pfn_tpu_torch.serving import CachedPosterior

    x_o, samples = request[:2]
    cp, pre_s, counts = run_counted(lambda: CachedPosterior(est, x_o))
    log(f"cached_precompute: {pre_s:.4f} s (first call); kernel launches {counts}; {smi}")
    expect_launches("cached_precompute", counts)
    cp.sample(SAMPLES)  # warm-up
    s, seconds, counts = run_counted(
        lambda: cp.sample(SAMPLES, generator=torch.Generator(DEVICE).manual_seed(500)))
    _path_line("cached_sample", seconds, SAMPLES, counts, smi)
    expect_launches("cached_sample", counts)
    posterior_check("cached_sample", task, [x_o], [s])
    check = density_check("CachedPosterior.log_prob vs log_prob", cp.log_prob(samples), lp_ref)
    return dict(precompute=pre_s, seconds=seconds, check=check)


# Phase 17: the metrics' checks. c2st of 256 + 256 rows: two draws of one 5-D
# Gaussian and a paired joint sample sharing x read chance (bound 0.6); a
# shift of 2 per dim (Bayes accuracy Φ(√20 / 2) = 0.987) reads >= 0.95, a
# shift of 1 per dim (Bayes Φ(√5 / 2) = 0.868) >= 0.8. c2st_conv tells 32 x 32
# bump images from noise (>= 0.9). sinkhorn_w2 within 10% of the exact W2 at
# n 256 (2-D Gaussians shifted by 1).
C2ST_NULL_MAX, C2ST_SHIFT2_MIN, C2ST_SHIFT1_MIN, C2ST_CONV_MIN = 0.6, 0.95, 0.8, 0.9
SINKHORN_REL = 0.1


@timed_phase
def phase_metrics(smi):
    import torch

    from npe_pfn_tpu_torch.eval import metrics as M

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(700)

    def normal(n, d, shift=0.0):
        return torch.randn((n, d), generator=gen, device=dev) + shift

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = float(fn())
        return out, time.perf_counter() - t0

    reads = {}
    reads["c2st_null"] = timed(lambda: M.c2st(gen, normal(256, 5), normal(256, 5)))
    reads["c2st_shift2"] = timed(lambda: M.c2st(gen, normal(256, 5), normal(256, 5, 2.0)))
    reads["c2st_shift1"] = timed(lambda: M.c2st(gen, normal(256, 5), normal(256, 5, 1.0)))
    x = normal(256, 4)
    reads["c2st_paired_null"] = timed(lambda: M.c2st(
        gen, torch.cat([normal(256, 1), x], 1), torch.cat([normal(256, 1), x], 1), paired=True))
    ii = torch.arange(32, device=dev)
    centre = torch.exp(-((ii[:, None] - 16.0) ** 2 + (ii[None, :] - 16.0) ** 2) / 18.0)
    noise = normal(256, 1024) * 0.3
    bump = (noise[128:] + centre.reshape(1, -1))
    reads["c2st_conv_bump"] = timed(lambda: M.c2st_conv(gen, noise[:128], bump, shape=(32, 32)))
    a, b = normal(256, 2), normal(256, 2, 1.0)
    reads["sinkhorn_w2"] = timed(lambda: M.sinkhorn_w2(a, b))
    exact = M.wasserstein2_exact(a, b)
    ok = {"c2st_null": reads["c2st_null"][0] <= C2ST_NULL_MAX,
          "c2st_shift2": reads["c2st_shift2"][0] >= C2ST_SHIFT2_MIN,
          "c2st_shift1": reads["c2st_shift1"][0] >= C2ST_SHIFT1_MIN,
          "c2st_paired_null": reads["c2st_paired_null"][0] <= C2ST_NULL_MAX,
          "c2st_conv_bump": reads["c2st_conv_bump"][0] >= C2ST_CONV_MIN,
          "sinkhorn_w2": abs(reads["sinkhorn_w2"][0] - exact) <= SINKHORN_REL * exact}
    for name, (value, seconds) in reads.items():
        log(f"metrics [{name}]: {value:.4f} in {seconds:.3f} s {'ok' if ok[name] else 'FAIL'}")
    log(f"metrics: exact W2 (scipy, host) {exact:.4f}; bounds: null <= {C2ST_NULL_MAX}, shift 2 "
        f">= {C2ST_SHIFT2_MIN}, shift 1 >= {C2ST_SHIFT1_MIN}, conv >= {C2ST_CONV_MIN}, "
        f"sinkhorn within {SINKHORN_REL:.0%} of exact; {smi}")
    if not all(ok.values()):
        raise AssertionError(f"metric checks failed: {[n for n, v in ok.items() if not v]}")
    return {n: v for n, (v, _) in reads.items()}


# Phase 18: evaluate_task on every task at the calibration's protocol
# (scripts/calibrate_torch_eval.py PROTOCOL: num_cal 1000, num_test 128, 8
# observations, 256 posterior samples, qry_chunk 256; seed 0). A task's c2st
# must lie inside its band in scripts/torch_eval_bands.json (the JAX
# package's reading on the CPU, mean +- max(0.05, 3 x std over seeds 0-9));
# a task the CPU calibration did not cover inside UNCALIBRATED_BAND. A
# num_cal 10_000 cell (filtered to 2048 rows) must score no worse than the
# upper edge of its task's num_cal 1000 band: more simulations must not
# leave the posterior further from the reference.
EVAL_LARGE = {"two_moons": 10_000, "slcp": 10_000}  # filtered to the 2048-row context
EVAL_PROTOCOL = dict(num_test=128, num_posterior_samples=256, n_obs_eval=8)
EVAL_QRY_CHUNK = 256
UNCALIBRATED_BAND = (0.4, 1.0)


def _eval_bands():
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_eval_bands.json")
    with open(path) as f:
        return {name: e["band"] for name, e in json.load(f)["tasks"].items() if "band" in e}


@timed_phase
def phase_evaluate(model, smi):
    import torch

    from npe_pfn_tpu_torch.eval import harness
    from npe_pfn_tpu_torch.tasks import get_task, list_tasks

    dev = torch.device(DEVICE)
    bands = _eval_bands()
    # One call of each kind of reference sampler, timed: the grid (512 x 512
    # cells) and the random-walk Metropolis (256 chains x 4000 steps).
    sampler_s = {}
    for name in ("two_moons", "slcp", "bernoulli_glm"):
        task = get_task(name, device=dev)
        _, x_o = task.simulate(torch.Generator(dev).manual_seed(800), 1)
        draws, seconds, _ = run_counted(lambda: task.posterior_sampler(
            torch.Generator(dev).manual_seed(801), x_o[0], 256))
        if draws.shape != (256, task.dim_theta) or not bool(torch.isfinite(draws).all()):
            raise AssertionError(f"{name}: bad reference posterior draws")
        sampler_s[name] = seconds
        log(f"reference sampler [{name}]: 256 draws in {seconds:.3f} s; {smi}")
    out, failed = {}, []
    for name in list_tasks():
        task = get_task(name, device=dev)
        grid = (1000,) + ((EVAL_LARGE[name],) if name in EVAL_LARGE else ())
        res, seconds, counts = run_counted(lambda: harness.evaluate_task(
            task, num_cal_grid=grid, seeds=(0,), estimator_kwargs=dict(
                model=model, qry_chunk=EVAL_QRY_CHUNK), device=dev, **EVAL_PROTOCOL))
        for key, cell in sorted(res["cells"].items()):
            num_cal = int(key.split("/")[0].split("=")[1])
            lo, hi = bands.get(name, UNCALIBRATED_BAND)
            kind = "calibrated" if name in bands else "uncalibrated"
            if num_cal != 1000:
                lo, kind = UNCALIBRATED_BAND[0], "num_cal 1000 upper edge"
            finite = all(math.isfinite(cell[m]) for m in ("c2st", "wasserstein", "mmd"))
            ok = finite and lo <= cell["c2st"] <= hi
            log(f"evaluate_task [{name} {key}]: c2st {cell['c2st']:.4f} ({kind} band "
                f"[{lo:.4f}, {hi:.4f}]), wasserstein {cell['wasserstein']:.4f}, mmd "
                f"{cell['mmd']:.4f}, wall_s {cell['wall_s']:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{name} {key}")
        log(f"evaluate_task [{name}]: {seconds:.3f} s; row-attention launches {counts[0]} "
            f"({counts[1]} wgmma, {counts[2]} wmma); {smi}")
        if counts[0] == 0 or counts != (counts[0], counts[0], 0):
            failed.append(f"{name}: launches {counts}, all must be wgmma")
        out[name] = dict(seconds=seconds, launches=counts[0], cells=res["cells"])
    if failed:
        raise AssertionError(f"evaluate_task checks failed: {failed}")
    return out, sampler_s



# Phases 19-22: sequential inference at full width (the shipped checkpoint in
# bf16). Every path runs through run_counted (all counters at 0 just before,
# read just after) and must launch only the wgmma inference kernel; each
# launch's (B, Lq, Lk) is recorded (record_shapes) for phase 22.
#   19. run_tsnpe on 10-D gaussian_linear: 2 rounds x 1024 simulations,
#       no_filtering (1024, then 2048 context rows), rejection truncation
#       (allowed false negatives 1e-4, 4096 support samples, candidate batches
#       of 16,384), qry_chunk 2048, collect_diagnostics. Launches per round: 8
#       for the CachedPosterior precompute (all 10 dims in one encode), 160
#       for the 4096 threshold draws (10 dims x 8 layers x 2 chunks), 640 per
#       rejection round of a proposal draw (16,384 candidates = 8 chunks); then
#       sample(10_240) under phase 5's posterior check (480). One round again
#       in SIR mode (oversample 32): 8 + 160 to build, 1280 for 1024 draws
#       (32,768 rows = 16 chunks).
#   20. scripts/torch_sequential_protocols.py at seed 0:
#       sample_refined on two_moons (1024 of 8192 proposals) and the ratio
#       log_prob on 10-D gaussian_linear (4096 draws: 240 launches; the
#       512-row classifier against 10,000 rows padded to 10,240: 16), each
#       reading inside its band from the JAX package on the CPU over seeds 0-9
#       (scripts/torch_sequential_bands.json).
#   21. audit_binary (8 tasks x (8 + 8) launches; ECE under its band's upper
#       edge), RestrictedPrior (one labelled round of 4096 prior draws, then
#       4096 draws, 16 launches per round of 16,384 candidates, the rounds
#       as RestrictedPrior.last_diagnostics records them), the
#       unconditional estimator (4 clusters on 4096 N(0, I) draws: moments and
#       median |log_prob - prior log_prob| inside their bands) and
#       `python -m npe_pfn_tpu_torch tsnpe` run in-process.
#   22. the inference kernel at each new (B, Lq, Lk) those phases launched,
#       against its plain version (phase 3's tolerance), timed as phase 4.
SEQ_DIM = 10
TSNPE_KW = dict(num_rounds=2, num_simulations=2048, sampling_method="rejection",
                allowed_false_negatives=1e-4, num_samples_to_estimate_support=4096,
                support_batch_size=16_384, filtering="no_filtering")
SEQ_QRY_CHUNK = 2048
SIR_DRAWS = 1024
LAUNCHES_SEQ = {"support_precompute": 8, "support_threshold_draws": 160,
                "support_rejection_round": 640, "sample_10240": 480,
                "sir_draws_1024": 1280, "ratio_log_prob": 256, "audit_binary": 128,
                "restricted_round": 16}


def _seqcal():
    """scripts/torch_sequential_protocols.py: the protocols and their bands."""
    import importlib
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    return importlib.import_module("torch_sequential_protocols")


def _seq_bands():
    with open(_seqcal().BANDS) as f:
        return json.load(f)["bands"]


class record_shapes:
    """Within the block, the (B, Lq, Lk) of every wgmma forward launch, in a
    Counter; the launch itself is the wrapped one, so the counters count as
    before."""

    def __enter__(self):
        from collections import Counter

        from npe_pfn_tpu_torch.ops import flash_attention as fa

        self.shapes, self._fa = Counter(), fa
        self._launch = fa.FWD_LAUNCHERS["wgmma"]

        def launch(q, k, *rest):
            self.shapes[(q.shape[0], q.shape[1], k.shape[1])] += 1
            return self._launch(q, k, *rest)

        fa.FWD_LAUNCHERS["wgmma"] = launch
        return self.shapes

    def __exit__(self, *exc):
        self._fa.FWD_LAUNCHERS["wgmma"] = self._launch


def expect_counts(path, counts, want):
    if counts != (want, want, 0):
        raise AssertionError(f"{path}: (all, wgmma, wmma) launches {counts}, expected "
                             f"({want}, {want}, 0)")


def _all_wgmma(path, counts):
    if counts[0] == 0 or counts != (counts[0], counts[0], 0):
        raise AssertionError(f"{path}: (all, wgmma, wmma) launches {counts}; the path must "
                             f"launch the kernel, all of the wgmma design")


def _in_band(name, value, band, side="both"):
    lo, hi = band
    ok = math.isfinite(value) and (value <= hi if side == "upper" else lo <= value <= hi)
    edge = f"<= {hi:.4f}" if side == "upper" else f"[{lo:.4f}, {hi:.4f}]"
    log(f"  {name} {value:.4f} (band {edge}) {'ok' if ok else 'FAIL'}")
    return ok


def fa_launches():
    from npe_pfn_tpu_torch.ops import flash_attention as fa

    return fa.flash_row_attention.launches


@timed_phase
def phase_tsnpe(model, smi):
    """run_tsnpe at full width with exact launches per step, sample(10_240)
    from the fitted estimator under phase 5's check, and one SIR round."""
    import torch

    from npe_pfn_tpu_torch import NPEPFN, PosteriorSupport, get_task
    from npe_pfn_tpu_torch.tsnpe import run_tsnpe

    dev = torch.device(DEVICE)
    task = get_task("gaussian_linear", dim=SEQ_DIM, device=dev)
    x_o = task.simulate(torch.Generator(dev).manual_seed(900), 1)[1][0]
    est = NPEPFN(prior=task.prior, model=model, filter_type="no_filtering",
                 qry_chunk=SEQ_QRY_CHUNK, seed=0)
    # Marks (what, time, launches so far) after each bind of the context, each
    # PosteriorSupport built and each draw from it, read after a synchronize.
    marks = []

    def marked(fn, what):
        def call(*a, **k):
            out = fn(*a, **k)
            torch.cuda.synchronize()
            marks.append((what(*a), time.perf_counter(), fa_launches()))
            return out
        return call

    est.append_simulations = marked(est.append_simulations,
                                    lambda theta, x: f"bind {theta.shape[0]} simulations")
    init, draw = PosteriorSupport.__init__, PosteriorSupport.sample
    PosteriorSupport.__init__ = marked(init, lambda *a: "build the truncation")
    PosteriorSupport.sample = marked(draw, lambda s, g, shape: f"draw {shape[0]} from it")
    diags = []
    t0 = time.perf_counter()
    try:
        (_, proposals), seconds, counts = run_counted(lambda: run_tsnpe(
            task.simulator, task.prior, x_o, generator=torch.Generator(dev).manual_seed(901),
            estimator=est, collect_diagnostics=diags, return_proposals=True, **TSNPE_KW))
    finally:
        del est.append_simulations
        PosteriorSupport.__init__, PosteriorSupport.sample = init, draw
    support = proposals[1]
    sim_diag = support.last_diagnostics  # the draw of round 2's simulations
    want = (LAUNCHES_SEQ["support_precompute"] + LAUNCHES_SEQ["support_threshold_draws"]
            + LAUNCHES_SEQ["support_rejection_round"] * (diags[0]["rounds"]
                                                         + sim_diag["rounds"]))
    prev_t, prev_n = t0, 0
    for what, at, n in marks:
        log(f"tsnpe: {what}: {at - prev_t:.4f} s, {n - prev_n} launches")
        prev_t, prev_n = at, n
    for d in diags:
        log(f"tsnpe round {d['round']} truncation: threshold {d['log_prob_threshold']:.4f}, "
            f"acceptance {d['acceptance_rate']:.4f}, pre-reject keep rate "
            f"{d['prereject_keep_rate']:.4f}, padded {d['padded']}, rounds {d['rounds']} "
            f"(the diagnostics draw)")
    log(f"tsnpe round 2 simulations from the truncation: acceptance "
        f"{sim_diag['acceptance_rate']:.4f}, pre-reject keep rate "
        f"{sim_diag['prereject_keep_rate']:.4f}, padded {sim_diag['padded']}, rounds "
        f"{sim_diag['rounds']}")
    log(f"tsnpe: run_tsnpe {seconds:.4f} s, {est.num_simulations} simulations; kernel launches "
        f"{counts} (expected {want}); {smi}")
    expect_counts("tsnpe", counts, want)
    launches = counts[0]
    if est.num_simulations != TSNPE_KW["num_simulations"] or sim_diag["padded"]:
        raise AssertionError(f"tsnpe: {est.num_simulations} simulations, diagnostics {sim_diag}")
    # Scored again at another batch size, a row near the threshold may round
    # to the other side of it (cuBLAS picks its GEMM by shape): 99% must stay.
    per_round = TSNPE_KW["num_simulations"] // TSNPE_KW["num_rounds"]
    inside = float(support.support_check(est._theta_train[per_round:]).float().mean())
    log(f"tsnpe: round 2 simulations inside the truncation, rescored: {inside:.4f} "
        f"(bound >= 0.99) {'ok' if inside >= 0.99 else 'FAIL'}")
    if inside < 0.99:
        raise AssertionError("tsnpe: round 2 simulated outside the truncated support")

    gen = torch.Generator(dev).manual_seed(902)
    samples, s_seconds, counts = run_counted(lambda: est.sample(SAMPLES, x_o, generator=gen))
    log(f"tsnpe sample({SAMPLES}) from the fitted estimator: {s_seconds:.4f} s, kernel "
        f"launches {counts}; {smi}")
    expect_counts("tsnpe sample", counts, LAUNCHES_SEQ["sample_10240"])
    mu, sd = task.posterior_moments(x_o)
    mean_z = ((samples.mean(0) - mu).abs() / sd).max().item()
    ratio = samples.std(0) / sd
    ok = (bool(torch.isfinite(samples).all()) and mean_z <= MAX_MEAN_Z
          and STD_RATIO[0] <= ratio.min().item() and ratio.max().item() <= STD_RATIO[1])
    log(f"tsnpe posterior check: max |mean - posterior mean| / posterior std {mean_z:.3f} "
        f"(bound {MAX_MEAN_Z}); std / posterior std {ratio.min().item():.3f}.."
        f"{ratio.max().item():.3f} (bound {STD_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("tsnpe: samples disagree with the analytic posterior")

    sir, b_seconds, b_counts = run_counted(lambda: PosteriorSupport(
        task.prior, est, x_o, generator=torch.Generator(dev).manual_seed(903),
        sampling_method="sir", oversample_sir=32, allowed_false_negatives=1e-4,
        num_samples_to_estimate_support=4096, batch_size=16_384))
    expect_counts("sir build", b_counts, LAUNCHES_SEQ["support_precompute"]
                  + LAUNCHES_SEQ["support_threshold_draws"])
    draws, d_seconds, d_counts = run_counted(
        lambda: sir.sample(torch.Generator(dev).manual_seed(904), (SIR_DRAWS,)))
    expect_counts("sir draws", d_counts, LAUNCHES_SEQ["sir_draws_1024"])
    diag = sir.last_diagnostics
    log(f"tsnpe SIR round (oversample 32, {SIR_DRAWS} draws of {32 * SIR_DRAWS}): build "
        f"{b_seconds:.4f} s ({b_counts[0]} launches), draw {d_seconds:.4f} s ({d_counts[0]} "
        f"launches); ESS fraction {diag['ess_fraction']:.4f}, dead groups {diag['dead_groups']}; "
        f"{smi}")
    if draws.shape != (SIR_DRAWS, SEQ_DIM) or not bool(torch.isfinite(draws).all()) \
            or not 0.0 < diag["ess_fraction"] <= 1.0:
        raise AssertionError(f"SIR: draws {tuple(draws.shape)}, diagnostics {diag}")
    return dict(seconds=seconds, launches=launches, sample_seconds=s_seconds,
                sample_launches=counts[0], sir_launches=d_counts[0], rounds=[d for d in diags],
                sim_round=sim_diag, sir=diag, sir_seconds=d_seconds,
                est=est, task=task, x_o=x_o, support=support)


@timed_phase
def phase_refine_ratio(model, smi):
    """The refine and ratio protocols of scripts/torch_sequential_protocols.py
    at seed 0, each inside its JAX band."""
    seqcal, bands = _seqcal(), _seq_bands()
    out, failed = {}, []
    for what, want in (("refine", None), ("ratio", LAUNCHES_SEQ["ratio_log_prob"])):
        reads, seconds, counts = run_counted(lambda: getattr(seqcal, f"torch_{what}")(model, 0))
        log(f"{what} (seed 0): {seconds:.4f} s, kernel launches {counts}; {smi}")
        if want is None:
            _all_wgmma(what, counts)
        else:
            expect_counts(what, counts, want)
        for m in seqcal.BANDED[what]:
            if not _in_band(f"{what}.{m}", reads[m], bands[f"{what}.{m}"]["band"]):
                failed.append(f"{what}.{m}")
        extra = {k: v for k, v in reads.items() if k not in seqcal.BANDED[what]}
        if extra:
            log(f"  unbanded: {extra}")
        out[what] = dict(reads, seconds=seconds, launches=counts[0])
    out["ratio_context"] = ratio_context_check(model, seqcal, smi)
    if failed:
        raise AssertionError(f"readings outside their JAX bands: {failed}")
    return out


# Phase 20, the committed classifier context (scripts/torch_ratio_context.npz,
# from scripts/export_ratio_context.py): the card's ratio_log_probs against
# the CPU plain path's, read as the classifier's probability p = sigmoid(lp -
# log u) over the θ inside its box (outside, both give the same floor). On
# the CPU the same reading with f32 scores moved p by a median of 3.0e-4 and
# at most 0.0137 (the rounding noise of the bf16 scores; in log-ratio terms a
# p99 of 5.2 nats, where p nears its 1e-6 clamp). The bounds sit at about 4x
# the largest and 15x the median of that noise; a classifier that has broken
# moves p by tenths. The θ outside the box take the floor log u + log ε -
# log(1 + ε), where each device sums log u in f32 from the box's widths: a
# few f32 ulps apart (the first card run read them unequal to the bit).
# Launches: 8 layers x (1 encode + 1 decode chunk).
MAX_MEDIAN_RATIO_P_DIFF = 0.005
MAX_RATIO_P_DIFF = 0.05
MAX_RATIO_FLOOR_REL = 1e-5
RATIO_CONTEXT_LAUNCHES = 16


def ratio_context_check(model, seqcal, smi):
    import torch

    ratio, theta, lp_cpu = seqcal.ratio_context(model)
    lp, seconds, counts = run_counted(lambda: ratio.ratio_log_probs(theta))
    expect_counts("ratio context", counts, RATIO_CONTEXT_LAUNCHES)
    inside = ((theta >= ratio._low) & (theta <= ratio._high)).all(dim=-1)
    p, p_cpu = (torch.sigmoid(a[inside] - ratio._log_u) for a in (lp, lp_cpu))
    diff = (p - p_cpu).abs()
    med, mx = diff.median().item(), diff.max().item()
    floor_diff = ((lp[~inside] - lp_cpu[~inside]).abs() / lp_cpu[~inside].abs()).max().item()
    ok = (bool(torch.isfinite(lp).all()) and floor_diff <= MAX_RATIO_FLOOR_REL
          and med <= MAX_MEDIAN_RATIO_P_DIFF and mx <= MAX_RATIO_P_DIFF)
    log(f"ratio_log_probs on the committed classifier context ({ratio._ctx_theta.shape[1]} rows, "
        f"{theta.shape[0]} θ, {int(inside.sum())} inside its box): {seconds:.4f} s, launches "
        f"{counts}; |p card - p CPU plain| median {med:.3e} (bound {MAX_MEDIAN_RATIO_P_DIFF}), "
        f"max {mx:.3e} (bound {MAX_RATIO_P_DIFF}); floor rows' relative diff {floor_diff:.3e} "
        f"(bound {MAX_RATIO_FLOOR_REL}) {'ok' if ok else 'FAIL'}; {smi}")
    if not ok:
        raise AssertionError("the card's ratio density disagrees with the CPU plain path's")
    return dict(seconds=seconds, launches=counts[0], median_p_diff=med, max_p_diff=mx,
                floor_rel_diff=floor_diff)


@timed_phase
def phase_heads(model, tsnpe, smi):
    """audit_binary, RestrictedPrior, the unconditional estimator and the CLI."""
    import torch

    from npe_pfn_tpu_torch import RestrictedPrior
    from npe_pfn_tpu_torch import __main__ as cli

    seqcal, bands = _seqcal(), _seq_bands()
    out, failed = {}, []
    reads, seconds, counts = run_counted(lambda: seqcal.torch_ece(model, 0))
    log(f"audit_binary (seed 0): {seconds:.4f} s, kernel launches {counts}; {smi}")
    expect_counts("audit_binary", counts, LAUNCHES_SEQ["audit_binary"])
    if not _in_band("ece.ece", reads["ece"], bands["ece.ece"]["band"], side="upper"):
        failed.append("ece.ece")
    log(f"  mean |p - p_true| {reads['mean_abs_prob_error']:.4f} (unbanded)")
    out["audit_binary"] = dict(reads, seconds=seconds, launches=counts[0])

    # RestrictedPrior on the TSNPE task: θ labelled 1 inside the truncation of
    # phase 19, 0 outside; then 4096 draws. All must lie in the prior's
    # support, and more of them inside the truncation than of the prior's.
    task, support = tsnpe["task"], tsnpe["support"]
    dev = torch.device(DEVICE)
    theta = task.prior.sample(torch.Generator(dev).manual_seed(910), (4096,))
    labels = support.support_check(theta).float()
    rp = RestrictedPrior(task.prior, model=model, seed=0)
    rp.append_simulations(theta, labels)
    draws, seconds, counts = run_counted(
        lambda: rp.sample(torch.Generator(dev).manual_seed(911), (4096,)))
    rounds = rp.last_diagnostics["rounds"]
    expect_counts("restricted_prior", counts, LAUNCHES_SEQ["restricted_round"] * rounds)
    acceptance = float(rp.accept_reject_fn(task.prior.sample(
        torch.Generator(dev).manual_seed(912), (rp.batch_size,))).float().mean())
    in_prior = bool(task.prior.support_check(draws).all())
    share = float(support.support_check(draws).float().mean())
    prior_share = float(labels.mean())
    ok = draws.shape == (4096, SEQ_DIM) and in_prior and share > prior_share
    log(f"restricted_prior: context {rp._ctx_theta.shape[0]} rows "
        f"({int(rp._ctx_labels.sum())} positive), 4096 draws in {seconds:.4f} s, {rounds} "
        f"round(s) of {rp.batch_size} candidates, padded {rp.last_diagnostics['padded']}, "
        f"acceptance {acceptance:.4f}, kernel launches {counts}; all in the prior's support "
        f"{in_prior}; inside the truncation {share:.4f} of the draws vs {prior_share:.4f} of "
        f"the prior's {'ok' if ok else 'FAIL'}; {smi}")
    if not ok:
        failed.append("restricted_prior")
    out["restricted_prior"] = dict(seconds=seconds, launches=counts[0], share=share,
                                   prior_share=prior_share, acceptance=acceptance)

    reads, seconds, counts = run_counted(lambda: seqcal.torch_uncond(model, 0))
    log(f"unconditional (seed 0): {seconds:.4f} s, kernel launches {counts}; {smi}")
    _all_wgmma("unconditional", counts)
    for m in seqcal.BANDED["uncond"]:
        side = "both" if m.startswith("std") else "upper"
        if not _in_band(f"uncond.{m}", reads[m], bands[f"uncond.{m}"]["band"], side):
            failed.append(f"uncond.{m}")
    out["unconditional"] = dict(reads, seconds=seconds, launches=counts[0])

    argv = ["tsnpe", "--task", "gaussian_linear", "--num-sims", "1024", "--num-rounds", "2",
            "--num-samples", "1024", "--seed", "0"]
    _, seconds, counts = run_counted(lambda: cli.main(argv))
    log(f"python -m npe_pfn_tpu_torch {' '.join(argv)}: exit 0 in {seconds:.4f} s, kernel "
        f"launches {counts}; {smi}")
    _all_wgmma("cli tsnpe", counts)
    out["cli_tsnpe"] = dict(seconds=seconds, launches=counts[0])
    if failed:
        raise AssertionError(f"checks failed: {failed}")
    return out


@timed_phase
def phase_seq_kernel(shapes):
    """The inference kernel at every new (B, Lq, Lk) of phases 19-21 (all keys
    valid): against its plain version with phase 3's tolerance, then timed
    as phase 4 times its shapes."""
    import torch
    import torch.nn.functional as F

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    known = {(b, lq, lk) for _, b, lq, lk in TIME_SHAPES}
    rows, max_err = {}, 0.0
    for (b, lq, lk), n in sorted(shapes.items()):
        if (b, lq, lk) in known:
            continue
        name = f"B{b}_{lq}x{lk}"
        h, hd = 2, 128
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        q, k, v, m = _inputs(b, lq, lk, h, hd, torch.bfloat16, "all", gen)
        out = fa.flash_row_attention(q, k, v, m)
        ref = fa.reference_row_attention(q.float(), k.float(), v.float(), m)
        err = (out.float() - ref).abs().max().item()
        tol = TOL_BF16 * max(1.0, ref.abs().max().item())
        del out, ref
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"kernel disagrees with its plain version at {name}: "
                                 f"{err:.3e} > {tol:.1e}")
        max_err = max(max_err, err)
        ms = cuda_time_ms(lambda: fa.flash_row_attention(q, k, v, m))
        plain_ms = cuda_time_ms(lambda: fa.reference_row_attention(q, k, v, m), iters=3,
                                warmup=1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m[None, None, None, :]))
        flops = 4.0 * b * h * lq * lk * hd
        nbytes = 2.0 * (2 * b * lq * h * hd + 2 * b * lk * h * hd) + m.numel()
        bound_ms, bound_by = _attention_bound(flops, nbytes)
        log(f"kernel at a sequential shape [{name}, {n} launches in phases 19-21]: "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the bound); "
            f"bound {bound_ms:.4f} ms by {bound_by}; plain {plain_ms:.4f} ms; "
            f"scaled_dot_product_attention {library_ms:.4f} ms; max_abs_err {err:.3e} "
            f"(tol {tol:.1e})")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, launches=n, max_abs_err=err)
        del q, k, v, qt, kt, vt
    return rows, max_err


# Phases 23-24: the row-pooled and the MoE model on the pretrain_v7 trunk
# (d_model 256, 2 heads of 128, 8 layers, 1024 bars, bf16), from init_params
# with a seeded generator: the repository has no checkpoint of either.
POOL_MOE = (("pooled", dict(row_pool_slots=8)), ("moe", dict(num_experts=4, moe_top_k=2)))
POOL_MOE_STEPS = 3  # timed, after one warm-up step
# Launches a step: 4 lse per layer (the context's and the queries' row
# attention, forward and again in the remat recomputation) = 32, and 2
# backward per layer less the last layer's context row attention, whose
# output the loss never reads = 15 (phase 9's counts). The MoE aux does read
# it: the last layer's context state goes through its router, so the MoE
# model runs that backward too, 16 (tests/test_torch_cuda.py counts both).
POOL_MOE_LAUNCHES = {"pooled": (32, 15), "moe": (32, 16)}
# The aux at init: 1 under uniform routing, E/k = 2 under collapse
# (tests/test_moe.py's anchors), with 0.05 of slack each side.
MOE_AUX_INIT = (0.95, 2.05)
# Phase 24: a request's launches (10 dims x 8 layers x (1 encode + 5 decode
# chunks), as the dense model's: the pooled model's kernel batch is its 8
# slots where the dense model's is its 17 or 25 cell tokens), and encode +
# decode against the joint forward with an f32 copy.
POOL_MOE_SAMPLE_LAUNCHES = 480
MAX_ENCODE_DECODE_REL = 1e-3


@timed_phase
def phase_pool_moe_train(smi):
    """1 + POOL_MOE_STEPS train_steps of each model, then phase 10's check."""
    import torch

    from npe_pfn_tpu_torch.models import TabICAModel
    from npe_pfn_tpu_torch.ops import flash_attention as fa
    from npe_pfn_tpu_torch.pretrain import prior, train

    dev = torch.device(DEVICE)
    base, tcfg, pcfg = train_recipe()
    tokens = tcfg.num_datasets * (pcfg.num_ctx + pcfg.num_qry) * (pcfg.num_features + 1)
    counters = (fa.flash_row_attention, fa.flash_row_attention_lse, fa.flash_row_attention_bwd)
    out = {}
    for i, (name, over) in enumerate(POOL_MOE):
        cfg = dataclasses.replace(base, **over)
        model = TabICAModel.create(torch.Generator(dev).manual_seed(train.derive_seed(23, i)),
                                   cfg, dev)
        params, borders = model.params, model.borders
        opt_state = train.make_optimizer(tcfg).init(params)

        def gen(step):
            return torch.Generator(dev).manual_seed(train.derive_seed(tcfg.seed, step))

        aux0 = None
        if cfg.num_experts:  # the aux of the first step's batch at init
            batch = prior.sample_tasks(gen(0), tcfg.num_datasets, pcfg)
            with torch.no_grad():
                aux0 = (train.batch_loss(cfg, borders, params, batch, moe_aux_weight=1.0)
                        - train.batch_loss(cfg, borders, params, batch, moe_aux_weight=0.0)
                        ).item()
            del batch
        t0 = time.perf_counter()
        params, opt_state, loss, gnorm = train.train_step(cfg, tcfg, pcfg, params, opt_state,
                                                          borders, gen(0))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        losses, gnorms = [loss], [gnorm]
        for c in counters:
            c.launches = c.wgmma_launches = c.wmma_launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(1, POOL_MOE_STEPS + 1):
            params, opt_state, loss, gnorm = train.train_step(cfg, tcfg, pcfg, params,
                                                              opt_state, borders, gen(step))
            losses.append(loss)
            gnorms.append(gnorm)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        by_design = {c.__name__: (c.wgmma_launches, c.wmma_launches) for c in counters}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        losses, gnorms = torch.stack(losses).tolist(), torch.stack(gnorms).tolist()
        n_lse, n_bwd = POOL_MOE_LAUNCHES[name]
        want = {"flash_row_attention": 0,
                "flash_row_attention_lse": POOL_MOE_STEPS * n_lse,
                "flash_row_attention_bwd": POOL_MOE_STEPS * n_bwd}
        log(f"{name} train ({over}): warm-up step {warm:.3f} s; {POOL_MOE_STEPS} steps in "
            f"{seconds:.4f} s = {POOL_MOE_STEPS / seconds:.4f} steps/s = "
            f"{POOL_MOE_STEPS * tokens / seconds:.1f} tokens/s ({tokens} cell tokens per step); "
            f"peak memory {peak_gb:.3f} GB; loss {losses[0]:.4f}..{losses[-1]:.4f}; gnorm "
            f"{min(gnorms):.4f}..{max(gnorms):.4f}; launches {launches} (expected {want}: "
            f"{n_lse} lse and {n_bwd} backward a step); (wgmma, wmma) {by_design}"
            + (f"; MoE aux at init {aux0:.4f} (band {MOE_AUX_INIT})" if aux0 is not None else "")
            + f"; {smi}")
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"{name}: non-finite loss or gnorm: {losses} {gnorms}")
        if launches != want or any(by_design[n] != (want[n], 0) for n in want):
            raise AssertionError(f"{name}: launches {launches} by design {by_design}, "
                                 f"expected {want}, all wgmma")
        if aux0 is not None and not MOE_AUX_INIT[0] <= aux0 <= MOE_AUX_INIT[1]:
            raise AssertionError(f"{name}: MoE aux at init {aux0} outside {MOE_AUX_INIT}")
        parity = train_path_parity(f"{name} train path", cfg, params, borders)
        out[name] = dict(model=TabICAModel(cfg=cfg, params=params, borders=borders),
                         steps_per_s=POOL_MOE_STEPS / seconds,
                         tokens_per_s=POOL_MOE_STEPS * tokens / seconds, peak_gb=peak_gb,
                         launches=launches, aux0=aux0, parity=parity)
        del opt_state
    return out


@timed_phase
def phase_pool_moe_sample(trained, smi):
    """sample(10_240) from each of phase 23's models, with phase 6's check,
    the density check and the encode + decode identity."""
    import torch

    from npe_pfn_tpu_torch import NPEPFN, get_task
    from npe_pfn_tpu_torch.models import transformer

    dev = torch.device(DEVICE)
    task = get_task("gaussian_linear", dim=10, device=dev)
    cpu_task = get_task("gaussian_linear", dim=10, device="cpu")
    theta, x = (a.to(dev) for a in cpu_task.simulate(torch.Generator().manual_seed(0), 10_000))
    out = {}
    for name, tr in trained.items():
        model = tr["model"]
        est = NPEPFN(prior=task.prior, model=model, filter_type="standardized_euclidean_filtering",
                     filter_context_size=2048, qry_chunk=2048, seed=0)
        est.append_simulations(theta, x)
        est.sample(SAMPLES, x[0])  # warm-up
        requests = []
        for i in range(3):
            gen = torch.Generator(dev).manual_seed(300 + i)
            (samples, lps), seconds, counts = run_counted(
                lambda: est.sample(SAMPLES, x[i + 1], generator=gen, return_log_probs=True))
            expect_counts(f"{name} sample", counts, POOL_MOE_SAMPLE_LAUNCHES)
            launched = counts[0]
            if samples.shape != (SAMPLES, 10) or not bool(torch.isfinite(samples).all()):
                raise AssertionError(f"{name}: bad samples {tuple(samples.shape)}")
            requests.append((x[i + 1], samples, seconds, lps))
        times = [r[2] for r in requests]
        median = sorted(times)[1]
        log(f"{name} sample({SAMPLES}): {[round(t, 4) for t in times]} s, median {median:.4f} s "
            f"= {SAMPLES / median:.1f} samples/s; {launched} launches a request, all wgmma; "
            f"{smi}")
        x_o, samples, _, lps = requests[0]
        # One log_prob reading through the kernels serves phase 6's check (the
        # dense path with the model's bf16 scores) and the density check.
        lp, _, counts = run_counted(lambda: est.log_prob(samples, x_o))
        expect_counts(f"{name} log_prob", counts, POOL_MOE_SAMPLE_LAUNCHES)
        est.model = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg, flash="off"))
        lp_dense, _, counts = run_counted(lambda: est.log_prob(samples, x_o))
        est.model = model
        if counts[0]:
            raise AssertionError(f"{name}: the dense path launched the kernel {counts[0]} times")
        lp_parity(f"{name}: log_prob", lp, lp_dense)
        density = density_check(f"{name}: sample's log-probs vs log_prob", lps, lp)

        # encode + decode against the joint forward, f32 copy, on the
        # request's context: x and θ_1..9 as 19 features, θ_0 the target;
        # 2048 query rows of x_o and the request's θ_1..9.
        cfg32 = dataclasses.replace(model.cfg, dtype="float32", scores_dtype="float32")
        theta_ctx, x_ctx, ctx_mask = est.get_context(x_o)
        x_c = torch.cat([x_ctx, theta_ctx[:, 1:]], dim=-1)
        x_q = torch.cat([x_o.expand(2048, -1), samples[:2048, 1:]], dim=-1)
        pad = cfg32.max_features - x_c.shape[-1]
        x_c, x_q = (torch.nn.functional.pad(a, (0, pad)) for a in (x_c, x_q))
        feat_mask = torch.arange(cfg32.max_features, device=dev) < 19
        with torch.no_grad():
            joint = transformer.forward(cfg32, model.params, x_c, theta_ctx[:, 0], x_q,
                                        feat_mask, ctx_mask)
            cache = transformer.encode_context(cfg32, model.params, x_c, theta_ctx[:, 0],
                                               feat_mask, ctx_mask)
            split = transformer.decode_queries(cfg32, model.params, cache, x_q, feat_mask,
                                               ctx_mask)
        rel = ((split - joint).abs() / joint.abs().clamp_min(1.0)).max().item()
        ok = math.isfinite(rel) and rel <= MAX_ENCODE_DECODE_REL
        log(f"{name} f32 copy, encode + decode vs joint forward ({x_c.shape[0]} context rows, "
            f"{x_q.shape[0]} queries, cache slot axis {cache[0][0].shape[-4]}): max |diff| / "
            f"max(1, |logit|) {rel:.3e} (bound {MAX_ENCODE_DECODE_REL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: encode + decode disagrees with the joint forward")
        out[name] = dict(median_s=median, samples_per_s=SAMPLES / median,
                         launches=launched, density=density,
                         encode_decode_rel=rel)
    return out


# Phase 25: FlowNPE. 2-D gaussian_linear, 2000 simulations, max_epochs 150,
# patience 15, against the analytic posterior at tests/test_baselines.py's
# tolerances; 10-D, 10k simulations, 10 epochs (100 until the warm-up calls
# of phases 12-16 came back; PERF.md §4), timed, unbanded.
FLOW_MAX_MEAN_SDS, FLOW_STD_RATIO, FLOW_MAX_LP_OFFSET = 3.5, 0.35, 0.5


@timed_phase
def phase_flow_npe(smi):
    import torch

    from npe_pfn_tpu_torch import FlowNPE, get_task

    dev = torch.device(DEVICE)
    out = {}
    for dim, num, epochs, patience in ((2, 2000, 150, 15), (10, 10_000, 10, 20)):
        task = get_task("gaussian_linear", dim=dim, device=dev)
        theta, x = task.simulate(torch.Generator(dev).manual_seed(0), num)
        flow = FlowNPE(dim_theta=dim, dim_x=dim, max_epochs=epochs, patience=patience, seed=0,
                       device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = flow.fit(theta, x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        line = (f"FlowNPE {dim}-D gaussian_linear, {num} simulations: {trained} epochs "
                f"(max {epochs}, patience {patience}) in {seconds:.3f} s = "
                f"{seconds / trained:.4f} s per epoch")
        row = dict(epochs=trained, seconds=seconds, s_per_epoch=seconds / trained)
        if dim == 2:
            x_o = torch.tensor([0.8, -0.5], device=dev)
            s = flow.sample(4000, x_o, generator=torch.Generator(dev).manual_seed(1))
            gt = task.posterior_sampler(torch.Generator(dev).manual_seed(2), x_o, 4000)
            mean_sds = ((s.mean(0) - gt.mean(0)).abs().max() / gt.std(0).max()).item()
            std_dev = (s.std(0) / gt.std(0) - 1).abs().max().item()
            lp, exact = flow.log_prob(gt[:512], x_o), task.posterior_log_prob(x_o, gt[:512])
            offset = (lp - exact).mean().abs().item()
            ok = (bool(torch.isfinite(lp).all()) and mean_sds < FLOW_MAX_MEAN_SDS
                  and std_dev < FLOW_STD_RATIO and offset < FLOW_MAX_LP_OFFSET)
            line += (f"; |mean - posterior mean| {mean_sds:.3f} posterior sds (bound "
                     f"{FLOW_MAX_MEAN_SDS}), |std ratio - 1| {std_dev:.3f} (bound "
                     f"{FLOW_STD_RATIO}), |mean(log_prob - exact)| {offset:.3f} (bound "
                     f"{FLOW_MAX_LP_OFFSET}) {'ok' if ok else 'FAIL'}")
            row.update(mean_sds=mean_sds, std_dev=std_dev, lp_offset=offset)
            if not ok:
                log(line)
                raise AssertionError("FlowNPE disagrees with the analytic posterior")
        log(f"{line}; {smi}")
        out[f"{dim}d"] = row
    return out


# Phase 26: npe_pfn_tpu_torch.parallel at world size 1 on the nccl backend.
# NCCL takes one card per rank and the machine has one, so the all_reduce,
# all_gather and broadcast run through NCCL while a ring or a pipeline of one
# rank sends nothing. Every path runs once at full width against its
# single-device counterpart on the same inputs: the query-sharded request
# must equal phase 5's first request bit for bit, the dp steps' loss and
# gnorm train_step's; logits agree within phase 24's 1e-3 x max(1, |logit|).
# Launches per path, (inference, lse, backward), all wgmma: the request 10 x
# 8 x (1 + 5); encode + decode of a 2048-row context and 2048 queries 8 + 8
# (the pipeline's decode in 2 microbatches: 8 + 16; the ring's hops call
# the lse kernel); two dp steps of the pretrain_v7 recipe 2 x (32, 15).
MAX_PARALLEL_REL = 1e-3
PARALLEL_LAUNCHES = {"sharded_sample_10240": (480, 0, 0), "sp_gather": (16, 0, 0),
                     "sp_ring": (0, 16, 0), "tp": (16, 0, 0), "pp_2_microbatches": (24, 0, 0),
                     "ep": (16, 0, 0), "dp_2_steps": (0, 64, 30)}
# The ring's merge: the lse kernel over 2048 keys in 4 slices of 512 (one
# fully masked), merged in f32, against one call over all keys. Output:
# phase 3's bf16 bound (each slice's output is rounded to bf16 before the
# merge); lse: 1e-4 x max(1, |lse|) (a few f32 roundings of the merge).
# Its shape: B, queries, keys.
RING_SLICES, MAX_RING_LSE_REL, RING_SHAPE = 4, 1e-4, (25, 2048, 2048)


def check_parallel_launches(path, counts):
    names = ("flash_row_attention", "flash_row_attention_lse", "flash_row_attention_bwd")
    want = {n: (w, w, 0) for n, w in zip(names, PARALLEL_LAUNCHES[path])}
    if counts != want:
        raise AssertionError(f"{path}: launches (all, wgmma, wmma) {counts}, expected {want}")


def _rel(got, ref):
    return ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max().item()


NARROW_SHAPES = (("inference B20 2048x2048", 20, 2048, 2048), ("lse B264 768x768", 264, 768, 768))


def _narrow_kernels(dev):
    """The inference and lse kernels at H = 1, a 2-way tensor-parallel
    rank's shape of the shipped checkpoint (bf16, hd 128), against their
    plain versions at phases 3 and 7's tolerances."""
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(dev).manual_seed(26)
    errs = {}
    for name, b, lq, lk in NARROW_SHAPES:
        q, k, v = (torch.randn((b, n, 1, 128), generator=gen, device=dev).bfloat16()
                   for n in (lq, lk, lk))
        m = torch.arange(lk, device=dev)[None] < torch.randint(lk // 2, lk + 1, (b, 1),
                                                               generator=gen, device=dev)
        ref, ref_lse = fa.reference_row_attention_lse(q, k, v, m)
        if name.startswith("lse"):
            out, lse = fa.flash_row_attention_lse(q, k, v, m)
            lse_err = ((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0)).max().item()
            if lse_err > 1e-5:
                raise AssertionError(f"H 1 {name}: lse rel err {lse_err:.3e} > 1e-5")
        else:
            out = fa.flash_row_attention(q, k, v, m)
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= TOL_BF16 * max(1.0, ref.float().abs().max().item()):
            raise AssertionError(f"H 1 {name}: max |kernel - plain| {err:.3e}")
        errs[name] = err
    return errs


def _ring_merge(dev):
    import torch

    from npe_pfn_tpu_torch.ops import flash_attention as fa
    from npe_pfn_tpu_torch.parallel.context_sharded import merge_partials

    b, lq, lk = RING_SHAPE
    gen = torch.Generator(dev).manual_seed(27)
    q, k, v = (torch.randn((b, n, 2, 128), generator=gen, device=dev).bfloat16()
               for n in (lq, lk, lk))
    m = torch.rand(lk, generator=gen, device=dev) > 0.2
    m[lk // RING_SLICES:2 * lk // RING_SLICES] = False
    out, lse = fa.flash_row_attention_lse(q, k, v, m)
    o_acc = lse_acc = None
    for sl in torch.arange(lk, device=dev).chunk(RING_SLICES):
        o_acc, lse_acc = merge_partials(o_acc, lse_acc, *fa.flash_row_attention_lse(
            q, k[:, sl], v[:, sl], m[sl]))
    out_err = (o_acc - out.float()).abs().max().item()
    lse_rel = ((lse_acc - lse).abs() / lse.abs().clamp_min(1.0)).max().item()
    ok = (bool(torch.isfinite(o_acc).all()) and out_err <= TOL_BF16 * max(
        1.0, out.float().abs().max().item()) and lse_rel <= MAX_RING_LSE_REL)
    log(f"parallel: ring merge of the lse kernel over {lk} keys in {RING_SLICES} slices (one "
        f"fully masked) vs one call, B {b}: max |out diff| {out_err:.3e} (bound {TOL_BF16} x "
        f"max(1, |out|)), lse rel {lse_rel:.3e} (bound {MAX_RING_LSE_REL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ring's merge disagrees with one kernel call")
    return dict(out_err=out_err, lse_rel=lse_rel)


@timed_phase
def phase_parallel(est, request, smi):
    """npe_pfn_tpu_torch.parallel on one card: one NCCL group of one rank,
    destroyed at the end of the phase."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from npe_pfn_tpu_torch.parallel import init_distributed

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(0, 1, "file://" + os.path.join(tmp, "rendezvous"),
                         None if dev.type == "cuda" else dev)
        try:
            out = _parallel_paths(est, request, smi, dev)
        finally:
            dist.destroy_process_group()
    out["narrow_kernels_max_abs_err"] = _narrow_kernels(dev)
    out["ring_merge"] = _ring_merge(dev)
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"phase 26 in {out['phase_seconds']:.1f} s")
    return out


def _parallel_paths(est, request, smi, dev):
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from npe_pfn_tpu_torch.models import regressor
    from npe_pfn_tpu_torch.models.regressor import TabICAModel
    from npe_pfn_tpu_torch.parallel import (ep_place, get_mesh, make_sharded_train_step,
                                            pp_decode, pp_fit_encode,
                                            sharded_autoregressive_sample, tp_place)
    from npe_pfn_tpu_torch.parallel.context_sharded import sp_decode, sp_fit_encode
    from npe_pfn_tpu_torch.pretrain import prior, train

    model = est.model
    seconds, launches, rel = {}, {}, {}

    def run(path, fn):
        result, seconds[path], counts = count_kernels(fn)
        check_parallel_launches(path, counts)
        launches[path] = counts
        return result

    # Phase 5's first request, query rows sharded over a mesh of one rank.
    x_o, samples_ref, _, _, lps_ref = request
    mesh = get_mesh(1, device=dev)
    gen = torch.Generator(dev).manual_seed(100)
    ctx = est.get_context(x_o, gen)
    x_qry = x_o.broadcast_to((samples_ref.shape[0], x_o.shape[-1]))
    samples, lps = run("sharded_sample_10240", lambda: sharded_autoregressive_sample(
        mesh, model, *ctx, x_qry, gen, qry_chunk=est.qry_chunk,
        target_transform=est.target_transform))
    same = torch.equal(samples, samples_ref) and torch.equal(lps, lps_ref)
    log(f"parallel: sharded_autoregressive_sample({samples.shape[0]}) on 1 rank "
        f"{seconds['sharded_sample_10240']:.4f} s; equal to phase 5's first request bit for "
        f"bit: {same}; launches {launches['sharded_sample_10240']}")
    if not same:
        raise AssertionError("the sharded request at one rank differs from phase 5's")

    # One regression step of that request at full width: the context's x and
    # θ_1..9 as 19 features, θ_0 the target; 2048 queries.
    theta_ctx, x_ctx, ctx_mask = ctx
    feats = torch.cat([x_ctx, theta_ctx[:, 1:]], dim=-1)
    y = theta_ctx[:, 0]
    rows = samples_ref[:2048]
    xq = torch.cat([x_o.expand(rows.shape[0], -1), rows[:, 1:]], dim=-1)

    def logits_of(m):
        return regressor.predict_logits(m, regressor.fit_encode(m, feats, y, ctx_mask=ctx_mask),
                                        xq)

    ref = logits_of(model) * model.temperature
    meshes = {a: get_mesh(1, axis=a, device=dev) for a in ("tp", "pp", "ep")}
    mesh_sp = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "sp"))
    for mode in ("gather", "ring"):
        got = run(f"sp_{mode}", lambda: sp_decode(mesh_sp, model, sp_fit_encode(
            mesh_sp, model, feats, y, ctx_mask=ctx_mask, row_attn=mode), xq, row_attn=mode))
        rel[f"sp_{mode}"] = _rel(got, ref)
    got = run("tp", lambda: logits_of(tp_place(meshes["tp"], model)))
    rel["tp"] = _rel(got * model.temperature, ref)
    got = run("pp_2_microbatches", lambda: pp_decode(meshes["pp"], model, pp_fit_encode(
        meshes["pp"], model, feats, y, ctx_mask=ctx_mask), xq, num_microbatches=2))
    rel["pp_2_microbatches"] = _rel(got, ref)

    cfg, tcfg, pcfg = train_recipe()
    moe = TabICAModel.create(torch.Generator(dev).manual_seed(7), dataclasses.replace(
        cfg, num_experts=4, moe_top_k=2))
    ref_moe = logits_of(moe)
    rel["ep"] = _rel(run("ep", lambda: logits_of(ep_place(meshes["ep"], moe))), ref_moe)
    del moe
    log(f"parallel: logits of a 2048-row context and 2048 queries against the single-device "
        f"path, max |diff| / max(1, |logit|): "
        + ", ".join(f"{k} {v:.3e} ({seconds[k]:.4f} s)" for k, v in rel.items())
        + f" (bound {MAX_PARALLEL_REL})")
    bad = {k: v for k, v in rel.items() if not v <= MAX_PARALLEL_REL}
    if bad:
        raise AssertionError(f"parallel paths disagree with the single-device logits: {bad}")

    # Two data-parallel steps of the pretrain_v7 recipe against train_step.
    base = TabICAModel.create(torch.Generator(dev).manual_seed(11), cfg)
    opt_state = train.make_optimizer(tcfg).init(base.params)
    step, place = make_sharded_train_step(mesh, cfg, tcfg, pcfg)
    dp_state = place(base.params, opt_state)

    def gen_of(i):
        return torch.Generator(dev).manual_seed(train.derive_seed(tcfg.seed, i))

    def dp_steps():
        nonlocal dp_state
        reads = []
        for i in range(2):
            params, state, loss, gnorm = step(*dp_state, base.borders, gen_of(i))
            dp_state = (params, state)
            reads.append((loss, gnorm))
        return reads

    dp_reads = run("dp_2_steps", dp_steps)
    one, single = (base.params, opt_state), []
    for i in range(2):
        params, state, loss, gnorm = train.train_step(cfg, tcfg, pcfg, *one, base.borders,
                                                      gen_of(i))
        one = (params, state)
        single.append((loss, gnorm))
    dp_reads = [(a.item(), b.item()) for a, b in dp_reads]
    single = [(a.item(), b.item()) for a, b in single]
    # Every dp rank draws the step's whole batch and keeps its share: the
    # prior's time per step stays as the ranks' model work shrinks.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prior.sample_tasks(gen_of(0), tcfg.num_datasets, pcfg)
    torch.cuda.synchronize()
    seconds["prior_draw"] = time.perf_counter() - t0
    log(f"parallel: 2 dp steps of the pretrain_v7 recipe on 1 rank in "
        f"{seconds['dp_2_steps']:.4f} s; (loss, gnorm) {dp_reads}, train_step {single}; "
        f"launches {launches['dp_2_steps']}; one prior draw of the step's "
        f"{tcfg.num_datasets} tasks {seconds['prior_draw']:.4f} s "
        f"({200 * seconds['prior_draw'] / seconds['dp_2_steps']:.1f}% of a step); {smi}")
    if dp_reads != single:
        raise AssertionError("the dp steps' loss and gnorm differ from train_step's")
    return dict(seconds=seconds, rel=rel, dp=dp_reads,
                launches={k: {n: c[0] for n, c in v.items()} for k, v in launches.items()})


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
    est, task, x, request, launches = phase_main_path()
    phase_path_parity(est, request)
    train_errs = phase_train_kernel_parity()
    train_times = phase_train_kernel_time(regs_of)
    trained = phase_train()
    phase_train_path_parity()
    phase_prior_nll()
    batched = phase_sample_batched(est, task, x, smi)
    lp_ref, _ = phase_densities(est, request, batched, smi)
    phase_filtered(est, task, x, smi)
    phase_ensembles(est, task, request[0], smi)
    phase_cached(est, task, request, lp_ref, smi)
    phase_metrics(smi)
    evaluated, _ = phase_evaluate(est.model, smi)
    with record_shapes() as seq_shapes:
        tsnpe = phase_tsnpe(est.model, smi)
        refined = phase_refine_ratio(est.model, smi)
        heads = phase_heads(est.model, tsnpe, smi)
    seq_rows, _ = phase_seq_kernel(seq_shapes)
    pool_moe = phase_pool_moe_train(smi)
    pool_moe_sample = phase_pool_moe_sample(pool_moe, smi)
    flows = phase_flow_npe(smi)
    parallel = phase_parallel(est, request, smi)
    par = parallel["launches"]
    csrc = "npe_pfn_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_row_attention",
        "route": "cuda",
        "source": csrc + "flash_row_attention.cu",
        "replaces": "npe_pfn_tpu/ops/flash_attention.py:34",
        "design": "wgmma",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing["B25"], "B17": timing["B17"], "B100_ensemble": timing["B100_ensemble"],
        "B250_precompute": timing["B250_precompute"],
        **{name: timing[name] for name, *_ in TIME_SHAPES[4:]},
        "launches_per_path": {"sample": launches // 3, **MEASURED_LAUNCHES,
                              **{f"evaluate_task {name}": e["launches"]
                                 for name, e in evaluated.items()},
                              "run_tsnpe": tsnpe["launches"],
                              "tsnpe sample_10240": tsnpe["sample_launches"],
                              "tsnpe sir_draws_1024": tsnpe["sir_launches"],
                              "sample_refined two_moons": refined["refine"]["launches"],
                              "ratio_log_prob": refined["ratio"]["launches"],
                              **{name: h["launches"] for name, h in heads.items()},
                              "ratio_context": refined["ratio_context"]["launches"],
                              **{f"sample_10240 {name}": r["launches"]
                                 for name, r in pool_moe_sample.items()},
                              **{f"parallel {path}": c["flash_row_attention"]
                                 for path, c in par.items() if c["flash_row_attention"]}},
        "sequential_shapes": seq_rows,
        "registers": regs_of["fwd"][0], "spill_bytes": regs_of["fwd"][1],
    }]
    # Training kernels: launches over phase 9's timed steps; times at the context
    # shape (B 264, 768 x 768), the query shape's under "query".
    for name, key, source, replaces, parts in (
        ("flash_row_attention_lse", "lse", "flash_row_attention.cu",
         "npe_pfn_tpu/ops/flash_attention.py:258", ("fwd_lse",)),
        ("flash_row_attention_bwd", "bwd", "flash_row_attention_bwd.cu",
         "npe_pfn_tpu/ops/flash_attention.py:284", ("dkdv", "dq")),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source, "replaces": replaces,
            "design": "wgmma", "launches": trained["launches"][name],
            "max_abs_err": train_errs[key],
            **train_times["context"][key], "query": train_times["query"][key],
            "pooled_context": train_times["pooled_context"][key],
            "pooled_query": train_times["pooled_query"][key],
            "launches_per_path": {**{f"{model} train {POOL_MOE_STEPS} steps": tr["launches"][name]
                                     for model, tr in pool_moe.items()},
                                  **{f"parallel {path}": c[name] for path, c in par.items()
                                     if c[name]}},
            "registers": max(regs_of[p][0] for p in parts),
            "spill_bytes": sum(regs_of[p][1] for p in parts),
        })
    log(json.dumps({"pool_moe": {
        name: {"train": {k: v for k, v in tr.items() if k != "model"},
               "sample": pool_moe_sample[name]}
        for name, tr in pool_moe.items()}, "flow_npe": flows, "parallel": parallel}))
    log(f"phase seconds {json.dumps(PHASE_SECONDS)}")
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
