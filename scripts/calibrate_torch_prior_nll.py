#!/usr/bin/env python3
"""Calibrate the NLL band that chip_smoke.py's prior check holds the port to.

Scores the shipped checkpoint (tabica_v6_best) with the pretraining loss
(mean query-row NLL, ``batch_loss``) on batches of 32 tasks of the
pretrain_v7 prior at reduced rows (256 context + 64 query rows), on the CPU
in f32:

  1. JAX: ``npe_pfn_tpu.pretrain.train.batch_loss`` on batches of the JAX
     prior (``jax.random.PRNGKey(seed)``);
  2. port: ``npe_pfn_tpu_torch.pretrain.train.batch_loss`` on batches of the
     port's prior (``torch.Generator().manual_seed(seed)``);
  3. both losses on one shared batch, to show that the two forwards agree
     and any gap between 1 and 2 comes from the priors;
  4. a randomly initialized model on the port's first two batches, which a
     check must tell apart from the trained one.

A single 32-task batch reads anywhere in about 0.5-1.0 (tasks differ a lot),
so the check reads the mean of 4 batches, as the JAX package's validation
does. The script prints each batch's NLL and the band for such a mean:
pooled mean +- 4 standard errors, std(batch NLL) / sqrt(4), pooled over both
priors. Run from the repository root (needs JAX, on the CPU):

    JAX_PLATFORMS=cpu python3 scripts/calibrate_torch_prior_nll.py [--batches 6]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

V7 = dict(num_features=32, num_ctx=256, num_qry=64, p_heteroscedastic=0.3, p_heavy_tail=0.2,
          p_categorical_feats=0.2, p_multimodal=0.3, p_sym_fold=0.7, mm_mu_input_scale=0.3,
          mm_sig_lo=-1.7, p_marginal_mixture=0.5)
TASKS = 32
CHECK_BATCHES = 4  # batches the card's check averages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from npe_pfn_tpu.models import checkpoint as jck
    from npe_pfn_tpu.pretrain import prior as jprior
    from npe_pfn_tpu.pretrain import train as jtrain
    from npe_pfn_tpu_torch.models import TabICAModel, checkpoint
    from npe_pfn_tpu_torch.pretrain import prior, train

    torch.set_num_threads(args.threads)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints", "tabica_v6_best.npz")
    jm = jck.load(path)
    jcfg = dataclasses.replace(jm.cfg, dtype="float32", scores_dtype="float32")
    model = checkpoint.load(path, "cpu", dtype="float32", scores_dtype="float32")
    cfg = model.cfg
    jloss = jax.jit(lambda p, b: jtrain.batch_loss(jcfg, jm.borders, p, b, remat=False))

    def port_loss(params, batch):
        with torch.no_grad():
            return float(train.batch_loss(cfg, model.borders, params, batch, remat=False))

    rows = {"jax prior": [], "port prior": [], "random init": []}
    rand = TabICAModel.create(torch.Generator().manual_seed(0), cfg, "cpu")
    for seed in range(args.batches):
        t0 = time.perf_counter()
        jb = jprior.sample_tasks(jax.random.PRNGKey(seed), TASKS, jprior.PriorConfig(**V7))
        rows["jax prior"].append(float(jloss(jm.params, jb)))
        tb = prior.sample_tasks(torch.Generator().manual_seed(seed), TASKS, prior.PriorConfig(**V7))
        rows["port prior"].append(port_loss(model.params, tb))
        if seed < 2:
            rows["random init"].append(port_loss(rand.params, tb))
        if seed == 0:
            shared = prior.TaskBatch(*(torch.tensor(np.asarray(a)) for a in (
                jb.x_ctx, jb.y_ctx, jb.x_qry, jb.y_qry, jb.feat_mask, jb.ctx_mask)))
            same = port_loss(model.params, shared)
            print(f"shared JAX batch 0: JAX loss {rows['jax prior'][0]:.6f}, port loss "
                  f"{same:.6f}, |diff| {abs(same - rows['jax prior'][0]):.2e}", flush=True)
        rand_txt = f", random init {rows['random init'][-1]:.4f}" if seed < 2 else ""
        print(f"batch {seed}: JAX prior {rows['jax prior'][-1]:.4f}, port prior "
              f"{rows['port prior'][-1]:.4f}{rand_txt} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    for name, vals in rows.items():
        v = np.asarray(vals)
        print(f"{name}: mean {v.mean():.4f} std {v.std(ddof=1):.4f} min {v.min():.4f} "
              f"max {v.max():.4f} over {len(v)} batches of {TASKS} tasks")
    pooled = np.asarray(rows["jax prior"] + rows["port prior"])
    se = pooled.std(ddof=1) / np.sqrt(CHECK_BATCHES)
    lo, hi = pooled.mean() - 4 * se, pooled.mean() + 4 * se
    print(f"band for the mean of {CHECK_BATCHES} batches (pooled mean {pooled.mean():.4f} +- 4 x "
          f"{se:.4f}): [{lo:.4f}, {hi:.4f}]; random init mean {np.mean(rows['random init']):.4f}")


if __name__ == "__main__":
    main()
