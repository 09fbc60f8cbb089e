#!/usr/bin/env python3
"""Where the time of one pretraining step goes, on a CUDA card.

Builds chip_smoke.py's training path (tabica_v6_best warm-started into the
pretrain_v7 recipe: 8 datasets of 768 + 128 rows, bf16, remat), takes
--warmup steps, then:

  1. times --steps steps (host wall time ending in a synchronize): steps/s
     and cell tokens/s, and the peak of torch.cuda.max_memory_allocated;
  2. times the layers of one step with a synchronize around each: prior
     sampling (sample_tasks), forward (batch_loss), backward (the gradient),
     optimizer (clip, AdamW, apply);
  3. traces one step with torch.profiler and prints the device time by
     kernel and the device's busy share of the step's wall time (device
     events only, as scripts/profile_torch_sample.py counts them).

    python3 scripts/profile_torch_train_step.py [--steps 20] [--table PATH]

``--table`` writes the profiler's full table to PATH. It imports nothing of
JAX.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from npe_pfn_tpu_torch.ops import flash_attention as fa  # noqa: E402
from npe_pfn_tpu_torch.pretrain import prior, train, warmstart  # noqa: E402
from npe_pfn_tpu_torch.utils import pytree_io  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--table", default=None, help="write the profiler table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg, tcfg, pcfg = chip_smoke.train_recipe()
    model = warmstart.load_warmstart(chip_smoke._shipped_checkpoint(), cfg, dev)
    params, borders = model.params, model.borders
    opt_state = train.make_optimizer(tcfg).init(params)
    tokens = tcfg.num_datasets * (pcfg.num_ctx + pcfg.num_qry) * (pcfg.num_features + 1)

    def gen(i):
        return torch.Generator(dev).manual_seed(train.derive_seed(tcfg.seed, i))

    for i in range(args.warmup):
        params, opt_state, _, _ = train.train_step(cfg, tcfg, pcfg, params, opt_state, borders, gen(i))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _, _ = train.train_step(cfg, tcfg, pcfg, params, opt_state, borders,
                                                   gen(args.warmup + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    print(f"steps: {len(ts)}; seconds min {ts[0]:.4f} median {ts[len(ts) // 2]:.4f} max "
          f"{ts[-1]:.4f}; {len(ts) / sum(ts):.4f} steps/s = {tokens * len(ts) / sum(ts):.1f} "
          f"tokens/s; peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB", flush=True)

    # Layers of one step, synchronized at each boundary.
    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    wall0 = time.perf_counter()
    batch, t_prior = synced(lambda: prior.sample_tasks(gen(10_000), tcfg.num_datasets, pcfg))
    named = {n: p.detach().requires_grad_(True) for n, p in pytree_io.flatten(params).items()}
    tree = pytree_io.unflatten(named)
    loss, t_fwd = synced(lambda: train.batch_loss(cfg, borders, tree, batch))
    grads, t_bwd = synced(lambda: torch.autograd.grad(loss, list(named.values())))

    def optimize():
        with torch.no_grad():
            g = pytree_io.unflatten(dict(zip(named, grads)))
            upd, _ = train.make_optimizer(tcfg).update(g, opt_state, params, train.global_norm(g))
            return train.apply_updates(params, upd)

    _, t_opt = synced(optimize)
    wall = time.perf_counter() - wall0
    print(f"layers of one step, synchronized at each boundary ({wall:.4f} s in all):")
    for label, sec in (("forward (batch_loss, remat)", t_fwd),
                       ("backward (recompute + grads)", t_bwd),
                       ("optimizer (clip, AdamW, apply)", t_opt),
                       ("prior sampling", t_prior)):
        print(f"  {label:32s} {sec:.4f} s  {100 * sec / wall:5.1f}%")
    rest = wall - (t_prior + t_fwd + t_bwd + t_opt)
    print(f"  {'rest':32s} {rest:.4f} s  {100 * rest / wall:5.1f}%", flush=True)
    del grads, loss, tree, named, batch

    from torch.profiler import ProfilerActivity, profile

    before = (fa.flash_row_attention_lse.launches, fa.flash_row_attention_bwd.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _, _ = train.train_step(cfg, tcfg, pcfg, params, opt_state, borders,
                                                   gen(20_000))
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    launches = (fa.flash_row_attention_lse.launches - before[0],
                fa.flash_row_attention_bwd.launches - before[1])
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, attr, 0) > 0]
    busy_us = sum(getattr(e, attr) for e in kernels)
    print(f"profiled step: {traced_wall:.4f} s wall (profiler on); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / traced_wall:.1f}% of wall; "
          f"lse forward / backward launches {launches}")
    if not kernels:
        print("the profiler recorded no device time")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:20]:
        sec = getattr(e, attr) / 1e6
        print(f"  {sec:8.4f} s {100 * sec / (busy_us / 1e6):5.1f}% of device  x{e.count:6d}  "
              f"{e.key[:90]}")
    if args.table:
        with open(args.table, "w") as f:
            f.write(events.table(sort_by=attr, row_limit=80))


if __name__ == "__main__":
    main()
