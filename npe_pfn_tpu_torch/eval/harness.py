"""Evaluation harness: the task grid of the reference's evaluation scripts.

Counterpart of ``npe_pfn_tpu/eval/harness.py``. Per task, seed and
calibration-set size, fit the estimator on ``num_cal`` simulations, sample
the posterior for test observations and score it against ground truth:
against the task's reference posterior sampler where it has one (C2ST,
Sinkhorn-W2 and MMD averaged over ``n_obs_eval`` observations), else by the
joint diagnostic {(θ̂, x*)} vs {(θ*, x*)}. Each (num_cal, seed) cell is
written to ``results_path`` as soon as it is done, and cells already there
are skipped, so an interrupted run resumes. Cells have the JAX package's
keys (``num_cal=…/seed=…``) and metric names.

Where the JAX package splits and folds a PRNG key per seed, stream and
observation, each stream here is a ``torch.Generator`` seeded by
``derive_seed(seed, stream, …)``: the calibration set by num_cal, the
posterior draws and the metric's classifier by num_cal and observation, the
reference posterior by observation only (it is cached across the num_cal
grid), the test set by seed only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..estimator import NPEPFN
from ..tasks import Task
from ..utils.seeding import derive_seed
from . import metrics as M

# Stream tags of derive_seed(seed, tag, ...).
_CAL, _TEST, _POST, _METRIC, _GT, _JOINT_POST, _JOINT_METRIC = range(7)


def _cell_key(num_cal: int, seed: int) -> str:
    return f"num_cal={num_cal}/seed={seed}"


def _generator(device, *ints) -> torch.Generator:
    return torch.Generator(device).manual_seed(derive_seed(*ints))


def evaluate_task(
    task: Task,
    num_cal_grid: Sequence[int] = (10, 50, 200, 1000),
    seeds: Sequence[int] = (0, 1, 2, 3, 4),
    num_test: int = 128,
    num_posterior_samples: int = 256,
    estimator_kwargs: Optional[dict] = None,
    results_path: Optional[str] = None,
    metric_subsample: int = 512,
    n_obs_eval: int = 8,
    refine_num_proposals: int = 0,
    refine_kwargs: Optional[dict] = None,
    device=None,
) -> Dict:
    """Full grid evaluation on ``device`` (CUDA unless the caller passes
    ``device="cpu"``; the task's prior must live there too); returns (and
    optionally checkpoints) the results. An x wider than the model's feature
    budget goes through a seeded random projection to at most 24 features.

    ``refine_num_proposals > 0`` samples the posteriors of tasks with a
    reference posterior by simulator-in-the-loop ABC-SIR
    (``NPEPFN.sample_refined``): each observation costs that many extra
    simulations, which the cell records (``sims_refine_per_obs``,
    ``sims_total_per_obs``) beside the mean ESS (``refine_ess_mean``). Tasks
    scored by the joint diagnostic raise: it draws one θ per test observation,
    so refinement would multiply the budget by num_test with no matched plain
    arm."""
    device = resolve_device(device)
    estimator_kwargs = dict(estimator_kwargs or {})
    estimator_kwargs.setdefault("device", device)
    if "embedding_net" not in estimator_kwargs:
        from ..embeddings import RandomProjectionEmbedding

        model = estimator_kwargs.get("model")
        f_budget = model.cfg.max_features if model is not None else 32
        if task.dim_x + task.dim_theta > f_budget:
            dout = min(f_budget - task.dim_theta, 24)
            if dout < 1:
                raise ValueError(
                    f"task {task.name!r}: dim_theta={task.dim_theta} leaves no room for x "
                    f"features in the model budget ({f_budget}); use a model with larger "
                    "max_features")
            estimator_kwargs["embedding_net"] = RandomProjectionEmbedding(
                task.dim_x, dout, seed=0, device=device)
    results: Dict = {"task": task.name, "cells": {}}
    if results_path and os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)

    for seed in seeds:
        theta_test, x_test = task.simulate(_generator(device, seed, _TEST), num_test)
        # Reference posteriors depend on (seed, observation) only: cached
        # across the num_cal grid (the MCMC samplers are the expensive ones).
        gt_cache: Dict = {}
        for num_cal in num_cal_grid:
            key = _cell_key(num_cal, seed)
            if key in results["cells"]:
                continue
            t0 = time.time()
            theta_cal, x_cal = task.simulate(_generator(device, seed, _CAL, num_cal), num_cal)
            est = NPEPFN(prior=task.prior, **estimator_kwargs)
            est.append_simulations(theta_cal, x_cal)

            cell: Dict = {"wall_s": None}
            if task.posterior_sampler is not None:
                n_obs = min(n_obs_eval, num_test)
                c2sts, w2s, mmds, esss = [], [], [], []
                for j in range(n_obs):
                    gen = _generator(device, seed, _POST, num_cal, j)
                    if refine_num_proposals:
                        post = est.sample_refined(
                            num_posterior_samples, x_test[j], task.simulator, generator=gen,
                            num_proposals=refine_num_proposals, **(refine_kwargs or {}))
                        esss.append(est.last_refine_diagnostics["ess"])
                    else:
                        post = est.sample(num_posterior_samples, x_test[j], generator=gen)
                    if j not in gt_cache:
                        gt_cache[j] = task.posterior_sampler(
                            _generator(device, seed, _GT, j), x_test[j], num_posterior_samples)
                    gt = gt_cache[j]
                    c2sts.append(M.c2st(_generator(device, seed, _METRIC, num_cal, j), post, gt))
                    w2s.append(M.sinkhorn_w2(post, gt))
                    mmds.append(M.mmd(post, gt))
                cell["c2st"] = float(torch.stack(c2sts).mean())
                cell["wasserstein"] = float(torch.stack(w2s).mean())
                cell["mmd"] = float(torch.stack(mmds).mean())
                if refine_num_proposals:
                    cell["sims_refine_per_obs"] = int(refine_num_proposals)
                    cell["sims_total_per_obs"] = int(num_cal + refine_num_proposals)
                    cell["refine_ess_mean"] = float(np.mean(esss))
            else:
                if refine_num_proposals:
                    raise ValueError(
                        f"task {task.name!r} has no ground-truth sampler: the joint diagnostic "
                        "draws 1 θ per test obs, so refined sampling has no budget-matched "
                        "plain arm there")
                # Joint diagnostic: one posterior draw per test observation;
                # {(θ̂, x*)} against {(θ*, x*)}, both copies of an x in one fold.
                post = est.sample_batched(1, x_test, generator=_generator(
                    device, seed, _JOINT_POST, num_cal))[:, 0, :]
                joint_est = torch.cat([post, x_test], dim=1)
                joint_true = torch.cat([theta_test, x_test], dim=1)
                n = min(metric_subsample, num_test)
                gen = _generator(device, seed, _JOINT_METRIC, num_cal)
                if task.x_image_shape is not None:
                    # Image-shaped x: a trained conv discriminator over the
                    # image part, plus the plain θ dims.
                    c2st = M.c2st_conv(gen, joint_est[:n], joint_true[:n],
                                       shape=tuple(task.x_image_shape), d_extra=task.dim_theta,
                                       paired=True)
                else:
                    c2st = M.c2st(gen, joint_est[:n], joint_true[:n], paired=True)
                cell["c2st"] = float(c2st)
                cell["wasserstein"] = float(M.sinkhorn_w2(post[:n], theta_test[:n]))
                cell["mmd"] = float(M.mmd(post[:n], theta_test[:n]))
            cell["wall_s"] = time.time() - t0
            results["cells"][key] = cell
            print(f"[eval] {task.name} {key}: {cell}", flush=True)
            if results_path:
                _atomic_json(results_path, results)
    return results


def _atomic_json(path: str, obj) -> None:
    """Write ``obj`` as JSON and as a pickle beside it, each atomically."""
    import pickle

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)
    pkl = path.rsplit(".", 1)[0] + ".pkl"
    with open(pkl + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(pkl + ".tmp", pkl)


def summarize(results: Dict) -> Dict:
    """Mean ± std per num_cal across seeds."""
    agg: Dict = {}
    for key, cell in results["cells"].items():
        num_cal = int(key.split("/")[0].split("=")[1])
        agg.setdefault(num_cal, []).append(cell)
    out = {}
    for num_cal, cells in sorted(agg.items()):
        out[num_cal] = {
            m: {
                "mean": float(np.mean([c[m] for c in cells])),
                "std": float(np.std([c[m] for c in cells])),
            }
            for m in ("c2st", "wasserstein", "mmd")
            if all(m in c for c in cells)
        }
    return out
