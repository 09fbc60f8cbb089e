#!/usr/bin/env python3
"""Calibrate the c2st bands that chip_smoke.py's evaluation phase holds the port to.

Runs ``eval.harness.evaluate_task`` of the JAX package (``npe_pfn_tpu``) and,
for a second reading, of the PyTorch port on the CPU (its plain path), with
the shipped checkpoint (tabica_v6_best, bf16), at the protocol that
chip_smoke.py runs on the card (``PROTOCOL`` below): num_cal 1000, num_test
128, 8 observations, 256 posterior samples, ``qry_chunk`` 256, one cell per
seed (seeds 0-9). Each (package, task) keeps its cells in ``<workdir>/<package>_<task>.json``,
the harness's own resume file, so an interrupted run resumes and tasks can run
in separate processes; seeds of one task can run in separate processes with
their own ``--workdir`` below the default one (``--bands`` merges them).

``--bands`` then writes ``scripts/torch_eval_bands.json`` (or ``--out``): for
each task with JAX readings on every seed of ``--seeds`` (at least
``MIN_SEEDS``), the band mean ± max(0.05, 3 × std over seeds) of the JAX
c2st, beside every reading of both packages and its wall time, and prints
each package's mean and std. A task without them is gated only to
``DEFAULT_BAND``. ``--device cuda`` runs the port on the card instead, to
read the spread of its c2st over seeds there; ``--bands`` on such a workdir
gathers those readings (``scripts/torch_eval_card_readings.json``).

    JAX_PLATFORMS=cpu python3 scripts/calibrate_torch_eval.py --package jax --tasks two_moons,slcp
    python3 scripts/calibrate_torch_eval.py --package torch --tasks two_moons --seeds 0,1,2
    python3 scripts/calibrate_torch_eval.py --bands
    python3 scripts/calibrate_torch_eval.py --package torch --device cuda \
        --workdir chiprun_out/card_eval
    python3 scripts/calibrate_torch_eval.py --bands --workdir chiprun_out/card_eval \
        --out scripts/torch_eval_card_readings.json
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TASKS = ("two_moons", "gaussian_linear", "slcp", "lotka_volterra", "sir", "pendulum",
         "wind_tunnel", "gaussian_bump_image", "gaussian_mixture", "bernoulli_glm",
         "gaussian_linear_uniform", "high_dim_gaussian")
PROTOCOL = dict(num_cal_grid=(1000,), num_test=128, num_posterior_samples=256, n_obs_eval=8)
QRY_CHUNK = 256
BANDS = os.path.join(REPO, "scripts", "torch_eval_bands.json")
DEFAULT_BAND = (0.4, 1.0)
MIN_HALF_WIDTH = 0.05
MIN_SEEDS = 10
SEEDS = ",".join(str(s) for s in range(MIN_SEEDS))


def run(package, tasks, seeds, workdir, threads, device):
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        from npe_pfn_tpu.eval import harness
        from npe_pfn_tpu.models import checkpoint
        from npe_pfn_tpu.tasks import get_task

        model, _ = checkpoint.load_default()
        kwargs = {}
    else:
        import torch

        torch.set_num_threads(threads)
        from npe_pfn_tpu_torch.eval import harness
        from npe_pfn_tpu_torch.models import checkpoint
        from npe_pfn_tpu_torch.tasks import get_task

        model = checkpoint.load_default(device)
        kwargs = dict(device=device)
    os.makedirs(workdir, exist_ok=True)
    for name in tasks:
        task = get_task(name, **kwargs)
        t0 = time.perf_counter()
        harness.evaluate_task(task, seeds=seeds, results_path=os.path.join(
            workdir, f"{package}_{name}.json"), estimator_kwargs=dict(
                model=model, qry_chunk=QRY_CHUNK), **PROTOCOL, **kwargs)
        print(f"[calibrate] {package} {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def _readings(cell_file):
    with open(cell_file) as f:
        cells = json.load(f)["cells"]
    return {k: {m: cell[m] for m in ("c2st", "wasserstein", "mmd", "wall_s")}
            for k, cell in cells.items()}


def _mean_std(entry, package, seeds):
    reads = [entry.get(package, {}).get(f"num_cal=1000/seed={s}", {}).get("c2st")
             for s in seeds]
    return None if None in reads else (float(np.mean(reads)), float(np.std(reads)))


def bands(seeds, workdir, path):
    if len(seeds) < MIN_SEEDS:
        raise SystemExit(f"bands need at least {MIN_SEEDS} seeds, got {len(seeds)}")
    out = {"protocol": dict(PROTOCOL, qry_chunk=QRY_CHUNK, seeds=list(seeds),
                            checkpoint="tabica_v6_best (bf16)"),
           "rule": f"JAX mean +- max({MIN_HALF_WIDTH}, 3 x std over seeds), at least "
                   f"{MIN_SEEDS} seeds; uncalibrated tasks {list(DEFAULT_BAND)}",
           "tasks": {}}
    for cell_file in sorted(glob.glob(os.path.join(workdir, "**", "*_*.json"), recursive=True)):
        package, name = os.path.basename(cell_file)[:-5].split("_", 1)
        out["tasks"].setdefault(name, {}).setdefault(package, {}).update(_readings(cell_file))
    for name, entry in out["tasks"].items():
        for package in ("jax", "torch"):
            if package in entry:
                entry[package] = dict(sorted(entry[package].items()))
        jax_ms = _mean_std(entry, "jax", seeds)
        if jax_ms is not None:
            half = max(MIN_HALF_WIDTH, 3 * jax_ms[1])
            entry["band"] = [jax_ms[0] - half, jax_ms[0] + half]
            entry["jax_mean_std"] = list(jax_ms)
        torch_ms = _mean_std(entry, "torch", seeds)
        if torch_ms is not None:
            entry["torch_mean_std"] = list(torch_ms)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    for name, entry in sorted(out["tasks"].items()):
        print(name, entry.get("band"), entry.get("jax_mean_std"), entry.get("torch_mean_std"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--tasks", default=",".join(TASKS))
    ap.add_argument("--seeds", default=SEEDS)
    ap.add_argument("--workdir", default=os.path.join(REPO, "_eval_calibration"))
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--device", default="cpu", help="the port's device (--package torch)")
    ap.add_argument("--bands", action="store_true", help="write the bands from the readings")
    ap.add_argument("--out", default=BANDS, help="where --bands writes")
    args = ap.parse_args()
    seeds = tuple(int(s) for s in args.seeds.split(","))
    if args.bands:
        bands(seeds, args.workdir, args.out)
        return
    if args.package is None:
        ap.error("--package or --bands")
    tasks = args.tasks.split(",")
    unknown = set(tasks) - set(TASKS)
    if unknown:
        ap.error(f"unknown tasks {sorted(unknown)}")
    run(args.package, tasks, seeds, args.workdir, args.threads, args.device)


if __name__ == "__main__":
    main()
