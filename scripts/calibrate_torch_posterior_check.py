"""Calibrate chip_smoke.py's posterior checks on the CPU with the plain path.

Runs the PyTorch port (npe_pfn_tpu_torch) with the shipped checkpoint on the
CPU, where row attention takes the dense path, on the 10-D gaussian_linear
task (10k simulations) and prints, per observation and sampling path, the
statistics that chip_smoke.py bounds: max over dims of |sample mean -
posterior mean| / posterior std, and the range of sample std / posterior
std. The context is cut to --context rows and the draw to --samples so that
it runs in minutes on a CPU; chip_smoke.py runs 2048 rows and 10_240 samples
(1024 per observation on the batched paths) on the card.

Paths (--paths, comma-separated): "sample" (NPEPFN.sample, phase 5),
"batched" (sample_batched on a shared random context), "filtered"
(sample_batched_filtered), "ensembles" (num_ensembles=4 with quantile
target and feature transforms), "orders" (num_order_ensembles=2) and
"cached" (serving.CachedPosterior).

    python3 scripts/calibrate_torch_posterior_check.py [--context 512] [--samples 2048]
        [--paths sample,batched,filtered,ensembles,orders,cached] [--first 1]
        [--observations 6]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from npe_pfn_tpu_torch import NPEPFN, get_task, load_default  # noqa: E402
from npe_pfn_tpu_torch.serving import CachedPosterior  # noqa: E402

PATHS = ("sample", "batched", "filtered", "ensembles", "orders", "cached")


def draws(path, est, xs, n, seed):
    """Samples for each observation in ``xs`` ([M, dx]) along ``path``."""
    gen = torch.Generator().manual_seed(seed)
    if path == "batched":
        return list(est.sample_batched(n, xs, generator=gen))
    if path == "filtered":
        return list(est.sample_batched_filtered(n, xs, generator=gen))
    if path == "cached":
        return [CachedPosterior(est, x).sample(n, generator=gen) for x in xs]
    return [est.sample(n, x, generator=gen) for x in xs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--context", type=int, default=512)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--observations", type=int, default=6)
    ap.add_argument("--first", type=int, default=1,
                    help="index of the first observation (chip_smoke.py phase 5 uses 1-3, "
                         "phase 12 10-25, phase 14 30-37)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--paths", default="sample")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    model = load_default("cpu", dtype=args.dtype, scores_dtype=args.dtype)
    task = get_task("gaussian_linear", dim=10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    theta, x = task.simulate(gen, 10_000)
    options = {"ensembles": dict(num_ensembles=4, target_transform="quantile",
                                 feature_transform="quantile"),
               "orders": dict(num_order_ensembles=2)}
    xs = x[args.first:args.first + args.observations]
    for path in args.paths.split(","):
        if path not in PATHS:
            raise SystemExit(f"unknown path {path!r}; choose from {PATHS}")
        est = NPEPFN(prior=task.prior, model=model, filter_context_size=args.context,
                     qry_chunk=min(2048, args.samples), seed=0, device="cpu",
                     **options.get(path, {}))
        est.append_simulations(theta, x)
        t0 = time.perf_counter()
        worst_z, lo, hi = 0.0, float("inf"), 0.0
        for i, s in enumerate(draws(path, est, xs, args.samples, 100)):
            mu, sd = task.posterior_moments(xs[i])
            zs = (s.mean(0) - mu).abs() / sd
            z = zs.max().item()
            r = s.std(0) / sd
            worst_z, lo, hi = max(worst_z, z), min(lo, r.min().item()), max(hi, r.max().item())
            print(f"{path} obs {args.first + i}: max mean z {z:.3f} (dim {int(zs.argmax())}); "
                  f"std ratio {r.min().item():.3f}..{r.max().item():.3f} (max at dim "
                  f"{int(r.argmax())}); |x_o| max {xs[i].abs().max().item():.2f}", flush=True)
        print(f"{path}: worst over {len(xs)} observations: mean z {worst_z:.3f}; std ratio "
              f"{lo:.3f}..{hi:.3f} (context {args.context}, {args.samples} samples, "
              f"{args.dtype}, CPU plain path, {time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
