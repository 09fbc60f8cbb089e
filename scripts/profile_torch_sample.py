"""Where the time of one sample(10_240) request goes, on a CUDA card.

Builds the chip_smoke.py main path (shipped checkpoint in bf16, 10-D
gaussian_linear, 10k simulations, 2048 context rows, qry_chunk 2048), warms
it up, then:

  1. times --requests requests (host wall time ending in a synchronize), for
     the spread of the end-to-end metric;
  2. times each layer of one request with a synchronize around it (filter,
     encode = fit_encode, decode = predict_logits, bar sampling + log_prob,
     rejection bookkeeping as the rest), which serializes the host and the
     device at each boundary;
  3. traces one request with torch.profiler and prints the device time by
     kernel and the device's busy share of the request's wall time.

    python3 scripts/profile_torch_sample.py [--requests 8]

Writes the profiler table to chiprun_out/profile_sample.txt when that
directory exists. It imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from npe_pfn_tpu_torch import NPEPFN, estimator, filters, get_task, load_default  # noqa: E402
from npe_pfn_tpu_torch.ops.flash_attention import flash_row_attention  # noqa: E402


def synced(fn, totals, name):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0
        return out
    return wrapper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    task = get_task("gaussian_linear", dim=10, device=dev)
    cpu_task = get_task("gaussian_linear", dim=10, device="cpu")
    theta, x = (a.to(dev) for a in cpu_task.simulate(torch.Generator().manual_seed(0), 10_000))
    est = NPEPFN(prior=task.prior, model=load_default(dev), filter_context_size=2048,
                 qry_chunk=2048, seed=0)
    est.append_simulations(theta, x)
    num = 10_240
    for _ in range(2):
        est.sample(num, x[0])
    torch.cuda.synchronize()

    times = []
    for i in range(args.requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.sample(num, x[1 + i % 3])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ts = sorted(times)
    print(f"requests: {len(ts)} x sample({num}); seconds min {ts[0]:.4f} median "
          f"{ts[len(ts) // 2]:.4f} max {ts[-1]:.4f}; samples/s at median "
          f"{num / ts[len(ts) // 2]:.1f}", flush=True)

    totals = defaultdict(float)
    patches = [
        (estimator.regressor, "fit_encode", "encode (fit_encode)"),
        (estimator.regressor, "predict_logits", "decode (predict_logits)"),
        (estimator.regressor, "sample_y", "bar sample"),
        (estimator.regressor, "log_prob_y", "bar log_prob"),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, label in patches:
        setattr(mod, name, synced(getattr(mod, name), totals, label))
    est.filter_fn = synced(filters.standardized_euclidean_filtering, totals, "filter")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.sample(num, x[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    est.filter_fn = filters.standardized_euclidean_filtering
    print(f"layers of one request, synchronized at each boundary ({wall:.4f} s in all):")
    for label, sec in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {label:26s} {sec:.4f} s  {100 * sec / wall:5.1f}%")
    rest = wall - sum(totals.values())
    print(f"  {'rest (loop, rejection)':26s} {rest:.4f} s  {100 * rest / wall:5.1f}%", flush=True)

    from torch.profiler import ProfilerActivity, profile

    before = flash_row_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.sample(num, x[2])
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    launches = flash_row_attention.launches - before
    events = prof.key_averages()
    attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    # Device-side events only: the aten:: ops that launched them carry the
    # same device time again.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, attr, 0) > 0]
    busy_us = sum(getattr(e, attr) for e in kernels)
    print(f"profiled request: {traced_wall:.4f} s wall (profiler on); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / traced_wall:.1f}% of wall; "
          f"row-attention kernel launches {launches}")
    if not kernels:
        print("the profiler recorded no device time")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:15]:
        sec = getattr(e, attr) / 1e6
        print(f"  {sec:8.4f} s {100 * sec / (busy_us / 1e6):5.1f}% of device  x{e.count:6d}  "
              f"{e.key[:90]}")
    table = events.table(sort_by=attr, row_limit=60)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "profile_sample.txt"), "w") as f:
            f.write(table)


if __name__ == "__main__":
    main()
