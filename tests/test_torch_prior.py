"""Port parity: the synthetic task prior vs npe_pfn_tpu's, by distribution.

The two packages draw different random bits (``torch.Generator`` against
``jax.random``), so the batches are compared by distribution: 400 tiny tasks
from each, both seeded (the test is deterministic), and a two-sample KS test
on four per-task statistics (active context rows, active features, the
target's std and the features' std over the active context). The bound is
the KS critical value at alpha = 1e-3 for 400 + 400 samples,
1.949 * sqrt(2 / 400) = 0.138; the binary-task share must agree within 3.3
standard errors of a difference of two proportions (0.08 at 400 + 400).
"""

import math

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from npe_pfn_tpu.pretrain import prior as jprior
from npe_pfn_tpu_torch.pretrain import prior

torch.set_num_threads(2)
TINY = dict(num_features=8, num_ctx=32, num_qry=16, max_active_features=6, hidden=16)
V7 = dict(p_heteroscedastic=0.3, p_heavy_tail=0.2, p_categorical_feats=0.2, p_multimodal=0.3,
          p_sym_fold=0.7, mm_mu_input_scale=0.3, mm_sig_lo=-1.7, p_marginal_mixture=0.5)
N_TASKS = 400
KS_BOUND = 1.949 * math.sqrt(2 / N_TASKS)


def _sample(cfg_kwargs, n=8, seed=0):
    return prior.sample_tasks(torch.Generator().manual_seed(seed), n, prior.PriorConfig(**cfg_kwargs))


@pytest.mark.parametrize("knobs", [{}, V7], ids=["default", "v7"])
def test_shapes_dtypes_and_masks(knobs):
    cfg = prior.PriorConfig(**TINY, **knobs)
    b = _sample({**TINY, **knobs}, n=64)
    d, n, q, f = 64, cfg.num_ctx, cfg.num_qry, cfg.num_features
    assert b.x_ctx.shape == (d, n, f) and b.x_qry.shape == (d, q, f)
    assert b.y_ctx.shape == (d, n) and b.y_qry.shape == (d, q)
    assert b.feat_mask.shape == (d, f) and b.ctx_mask.shape == (d, n)
    assert b.feat_mask.dtype == torch.bool and b.ctx_mask.dtype == torch.bool
    assert all(x.dtype == torch.float32 for x in (b.x_ctx, b.y_ctx, b.x_qry, b.y_qry))
    assert all(bool(torch.isfinite(x).all()) for x in (b.x_ctx, b.y_ctx, b.x_qry, b.y_qry))
    n_ctx, n_feat = b.ctx_mask.sum(1), b.feat_mask.sum(1)
    # Masks are prefixes: the first n_active rows and f_active columns.
    assert torch.equal(b.ctx_mask, torch.arange(n)[None] < n_ctx[:, None])
    assert torch.equal(b.feat_mask, torch.arange(f)[None] < n_feat[:, None])
    assert int(n_ctx.min()) >= cfg.min_ctx and int(n_feat.min()) >= 1
    assert int(n_feat.max()) <= f
    # Inactive feature columns are zero, in context and query rows alike.
    off = ~b.feat_mask[:, None, :]
    assert bool((b.x_ctx.masked_select(off) == 0).all())
    assert bool((b.x_qry.masked_select(off) == 0).all())


@pytest.mark.parametrize("max_feat", [2, torch.tensor(3, dtype=torch.int32)])
def test_max_feat_caps_the_active_features(max_feat):
    # With one theta dim (j = 0) inverse tasks keep f_active columns too, so
    # every task's active-feature count is capped by max_feat.
    cfg = prior.PriorConfig(**TINY, **V7, max_theta_dim=1)
    free = prior.sample_tasks(torch.Generator().manual_seed(1), 128, cfg)
    capped = prior.sample_tasks(torch.Generator().manual_seed(1), 128, cfg, max_feat=max_feat)
    assert int(free.feat_mask.sum(1).max()) > 3
    assert int(capped.feat_mask.sum(1).max()) <= int(max_feat)


def test_same_generator_seed_same_batch_and_device_check():
    a, b = _sample(TINY, seed=5), _sample(TINY, seed=5)
    assert all(torch.equal(x, y) for x, y in zip(vars(a).values(), vars(b).values()))
    with pytest.raises(ValueError):
        prior.sample_tasks(torch.Generator().manual_seed(0), 2, prior.PriorConfig(**TINY),
                           device="meta")


def _task_stats(x_ctx, y_ctx, y_qry, feat_mask, ctx_mask):
    out = {k: [] for k in ("active context rows", "active features", "target std",
                           "feature std", "binary")}
    for i in range(len(feat_mask)):
        n, f = int(ctx_mask[i].sum()), int(feat_mask[i].sum())
        out["active context rows"].append(n)
        out["active features"].append(f)
        out["target std"].append(float(np.std(y_ctx[i, :n])))
        out["feature std"].append(float(np.std(x_ctx[i, :n, :f])))
        y = np.concatenate([y_ctx[i], y_qry[i]])
        out["binary"].append(bool(np.all((y == 0) | (y == 1))))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("knobs", [{}, V7], ids=["default", "v7"])
def test_matches_jax_prior_by_distribution(knobs):
    cfg = dict(**TINY, **knobs)
    jb = jprior.sample_tasks(jax.random.PRNGKey(0), N_TASKS, jprior.PriorConfig(**cfg))
    tb = _sample(cfg, n=N_TASKS, seed=0)
    ref = _task_stats(*(np.asarray(a) for a in (jb.x_ctx, jb.y_ctx, jb.y_qry, jb.feat_mask,
                                                jb.ctx_mask)))
    got = _task_stats(*(a.numpy() for a in (tb.x_ctx, tb.y_ctx, tb.y_qry, tb.feat_mask,
                                            tb.ctx_mask)))
    for key in ("active context rows", "active features", "target std", "feature std"):
        stat = ks_2samp(got[key], ref[key]).statistic
        assert stat < KS_BOUND, f"{key}: KS {stat:.3f} >= {KS_BOUND:.3f}"
    p_got, p_ref = got["binary"].mean(), ref["binary"].mean()
    p = (p_got + p_ref) / 2
    se = math.sqrt(2 * p * (1 - p) / N_TASKS)
    assert abs(p_got - p_ref) <= 3.3 * se, (p_got, p_ref)
