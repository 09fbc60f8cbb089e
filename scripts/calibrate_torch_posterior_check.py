"""Calibrate chip_smoke.py's posterior check on the CPU with the plain path.

Runs the PyTorch port (npe_pfn_tpu_torch) with the shipped checkpoint on the
CPU, where row attention takes the dense path, on the 10-D gaussian_linear
task (10k simulations) and prints, per observation, the statistics that
chip_smoke.py bounds: max over dims of |sample mean - posterior mean| /
posterior std, and the range of sample std / posterior std. The context is
cut to --context rows and the draw to --samples so that it runs in minutes on
a CPU; chip_smoke.py runs 2048 rows and 10_240 samples on the card.

    python3 scripts/calibrate_torch_posterior_check.py [--context 512] [--samples 2048]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from npe_pfn_tpu_torch import NPEPFN, get_task, load_default  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--observations", type=int, default=6)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    model = load_default("cpu", dtype=args.dtype, scores_dtype=args.dtype)
    task = get_task("gaussian_linear", dim=10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    theta, x = task.simulate(gen, 10_000)
    est = NPEPFN(prior=task.prior, model=model, filter_context_size=args.context,
                 qry_chunk=min(2048, args.samples), seed=0, device="cpu")
    est.append_simulations(theta, x)
    worst_z, lo, hi = 0.0, float("inf"), 0.0
    for i in range(args.observations):
        t0 = time.perf_counter()
        s = est.sample(args.samples, x[i + 1], generator=torch.Generator().manual_seed(100 + i))
        mu, sd = task.posterior_moments(x[i + 1])
        z = ((s.mean(0) - mu).abs() / sd).max().item()
        r = s.std(0) / sd
        worst_z, lo, hi = max(worst_z, z), min(lo, r.min().item()), max(hi, r.max().item())
        print(f"obs {i + 1}: max mean z {z:.3f}; std ratio {r.min().item():.3f}.."
              f"{r.max().item():.3f}; {time.perf_counter() - t0:.1f} s (CPU)", flush=True)
    print(f"worst over {args.observations} observations: mean z {worst_z:.3f}; "
          f"std ratio {lo:.3f}..{hi:.3f} (context {args.context}, {args.samples} samples, "
          f"{args.dtype}, CPU plain path)")


if __name__ == "__main__":
    main()
