#!/usr/bin/env python3
"""Calibrate the bands that chip_smoke.py's sequential-inference phases hold the port to.

Four protocols, each a function of a seed, run by the JAX package
(``npe_pfn_tpu``, on the CPU) or by the PyTorch port (``--device``, the CPU's
plain path or the card), with the shipped checkpoint (tabica_v6_best, bf16):

- ``refine``: two_moons, 1000 simulations, ``sample_refined`` of 1024 draws
  from 8192 proposals (``qry_chunk`` 2048); its ESS, ε and c2st against 1024
  reference-posterior draws (and, unbanded, the plain ``sample``'s c2st);
- ``ratio``: 10-D gaussian_linear, 10k simulations filtered to 2048 rows,
  ``log_prob(mode="ratio_based")`` (4096 posterior draws, 512-row classifier)
  of 10,000 analytic-posterior draws; Pearson r against the analytic
  posterior log-density;
- ``ece``: ``eval.calibration.audit_binary`` (8 logistic tasks, 256 + 256
  rows, 5 features); its ECE and mean |p̂ − p|;
- ``uncond``: ``UnconditionalEstimator`` (4 clusters) on 4096 draws of the
  10-D N(0, 1) prior; of 4096 samples the largest |mean| and the std range
  over dims, and the median |log_prob − prior log_prob| over 4096 fresh prior
  draws.

Every reading lands in ``<workdir>/<package>_<protocol>_seed<k>.json`` as soon
as it is taken, and taken readings are skipped, so runs resume and seeds can
be split over processes. ``--bands`` writes ``scripts/torch_sequential_bands.json``
(or ``--out``): for each protocol and metric with JAX readings on seeds 0-9,
the band mean ± max(0.05, 3 × std over seeds), beside every reading.
The protocols and the port's side of them (the ``torch_*`` functions, which
chip_smoke.py calls on the card at seed 0) are in
``scripts/torch_sequential_protocols.py``; the JAX side is here.

    JAX_PLATFORMS=cpu python3 scripts/calibrate_torch_sequential.py --package jax \
        --protocols refine,ece,uncond --seeds 0,1,2,3,4
    python3 scripts/calibrate_torch_sequential.py --package torch --seeds 0
    python3 scripts/calibrate_torch_sequential.py --bands
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
sys.path.insert(0, os.path.join(REPO, "scripts"))
from torch_sequential_protocols import (  # noqa: E402
    BANDED, BANDS, CAL, GT, METRIC, MIN_HALF_WIDTH, MIN_SEEDS, OBS, PROTOCOLS, RATIO, REFINE,
    RUN, UNCOND, _uncond_readings, pearson, torch_ece, torch_ratio, torch_refine,
    torch_uncond)


# -- the JAX package ---------------------------------------------------------


def _jax_keys(seed):
    import jax

    return jax.random.split(jax.random.PRNGKey(seed), 5)


def jax_refine(model, seed):
    from npe_pfn_tpu import NPEPFN
    from npe_pfn_tpu.eval import metrics as M
    from npe_pfn_tpu.tasks import get_task

    keys = _jax_keys(seed)
    task = get_task("two_moons")
    theta, x = task.simulate(keys[CAL], REFINE["num_cal"])
    x_o = task.simulate(keys[OBS], 1)[1][0]
    est = NPEPFN(prior=task.prior, model=model, qry_chunk=REFINE["qry_chunk"])
    est.append_simulations(theta, x)
    post = est.sample_refined(REFINE["num_samples"], x_o, task.simulator, rng=keys[RUN],
                              num_proposals=REFINE["num_proposals"])
    diag = est.last_refine_diagnostics
    plain = est.sample(REFINE["num_samples"], x_o, rng=keys[RUN])
    ref = task.posterior_sampler(keys[GT], x_o, REFINE["num_samples"])
    return {"c2st": float(M.c2st(keys[METRIC], post, ref)), "ess": diag["ess"],
            "eps": diag["eps"], "c2st_plain": float(M.c2st(keys[METRIC], plain, ref))}


def jax_ratio(model, seed):
    from npe_pfn_tpu import NPEPFN
    from npe_pfn_tpu.tasks import get_task

    keys = _jax_keys(seed)
    task = get_task("gaussian_linear")
    theta, x = task.simulate(keys[CAL], RATIO["num_cal"])
    x_o = task.simulate(keys[OBS], 1)[1][0]
    est = NPEPFN(prior=task.prior, model=model, filter_context_size=RATIO["context"],
                 qry_chunk=RATIO["qry_chunk"])
    est.append_simulations(theta, x)
    theta_eval = task.posterior_sampler(keys[GT], x_o, RATIO["num_eval"])
    lp = est.log_prob(theta_eval, x_o, rng=keys[RUN], mode="ratio_based")
    return {"pearson_r": pearson(lp, task.posterior_log_prob(x_o, theta_eval))}


def jax_ece(model, seed):
    import jax

    from npe_pfn_tpu.eval import calibration

    out = calibration.audit_binary(model, jax.random.PRNGKey(seed))
    return {"ece": out["ece"], "mean_abs_prob_error": out["mean_abs_prob_error"]}


def jax_uncond(model, seed):
    from npe_pfn_tpu import UnconditionalEstimator
    from npe_pfn_tpu.tasks import get_task

    keys = _jax_keys(seed)
    prior = get_task("gaussian_linear").prior
    est = UnconditionalEstimator(num_clusters=UNCOND["clusters"], model=model, seed=seed)
    est.append_simulations(prior.sample(keys[CAL], (UNCOND["num"],)))
    samples = est.sample(UNCOND["num"], rng=keys[RUN])
    theta_eval = prior.sample(keys[GT], (UNCOND["num"],))
    lp = est.log_prob(theta_eval, rng=keys[METRIC])
    return _uncond_readings(samples, lp, prior.log_prob(theta_eval))


# -- running the protocols -----------------------------------------------------


def run(package, protocols, seeds, workdir, threads, device):
    if package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        from npe_pfn_tpu.models import checkpoint

        model, _ = checkpoint.load_default()
    else:
        import torch

        torch.set_num_threads(threads)
        from npe_pfn_tpu_torch.models import checkpoint

        model = checkpoint.load_default(device)
    fns = globals()
    os.makedirs(workdir, exist_ok=True)
    for what in protocols:
        for seed in seeds:
            path = os.path.join(workdir, f"{package}_{what}_seed{seed}.json")
            if os.path.exists(path):
                continue
            t0 = time.perf_counter()
            reads = fns[f"{package}_{what}"](model, seed)
            reads["wall_s"] = time.perf_counter() - t0
            with open(path + ".tmp", "w") as f:
                json.dump(reads, f)
            os.replace(path + ".tmp", path)
            print(f"[calibrate] {package} {what} seed {seed}: {reads}", flush=True)


def bands(workdir, path):
    out = {"protocols": {"refine": REFINE, "ratio": RATIO, "uncond": UNCOND,
                         "ece": "audit_binary defaults", "checkpoint": "tabica_v6_best (bf16)"},
           "rule": f"JAX mean +- max({MIN_HALF_WIDTH}, 3 x std over seeds 0-{MIN_SEEDS - 1})",
           "readings": {}, "bands": {}}
    for f in sorted(glob.glob(os.path.join(workdir, "**", "*_seed*.json"), recursive=True)):
        package, what, seed = os.path.basename(f)[:-5].split("_")
        with open(f) as fh:
            out["readings"].setdefault(what, {}).setdefault(package, {})[seed] = json.load(fh)
    for what, metrics in BANDED.items():
        jax_reads = out["readings"].get(what, {}).get("jax", {})
        if any(f"seed{s}" not in jax_reads for s in range(MIN_SEEDS)):
            continue
        for m in metrics:
            vals = [jax_reads[f"seed{s}"][m] for s in range(MIN_SEEDS)]
            half = max(MIN_HALF_WIDTH, 3 * float(np.std(vals)))
            mean = float(np.mean(vals))
            out["bands"][f"{what}.{m}"] = {"band": [mean - half, mean + half],
                                           "jax_mean_std": [mean, float(np.std(vals))]}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    for name, b in out["bands"].items():
        print(name, b)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--protocols", default=",".join(PROTOCOLS))
    ap.add_argument("--seeds", default=",".join(str(s) for s in range(MIN_SEEDS)))
    ap.add_argument("--workdir", default=os.path.join(REPO, "_seq_calibration"))
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--device", default="cpu", help="the port's device (--package torch)")
    ap.add_argument("--bands", action="store_true", help="write the bands from the readings")
    ap.add_argument("--out", default=BANDS, help="where --bands writes")
    args = ap.parse_args()
    if args.bands:
        bands(args.workdir, args.out)
        return
    if args.package is None:
        ap.error("--package or --bands")
    protocols = args.protocols.split(",")
    if set(protocols) - set(PROTOCOLS):
        ap.error(f"unknown protocols {sorted(set(protocols) - set(PROTOCOLS))}")
    run(args.package, protocols, [int(s) for s in args.seeds.split(",")], args.workdir,
        args.threads, args.device)


if __name__ == "__main__":
    main()
