"""Serving layer: a posterior bound to one observation, its context encoded once.

Counterpart of ``npe_pfn_tpu/serving.py``. The per-dimension context
encodings depend only on the bound context, never on the query rows or the
values sampled so far, so all dθ of them are computed once
(``_precompute_dim_caches``, one batched encode with a leading ``[dθ]``
axis) and every later ``sample`` / ``log_prob`` call only decodes. Every
dimension runs at the full width, with the feature mask ``col < dx + i``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import preprocessing as pp
from .estimator import NPEPFN, _chunked_logits, _context_columns, _eff_features, _round_up
from .models import regressor
from .models.regressor import ContextStats, FittedContext, TabICAModel


@torch.no_grad()
def _precompute_dim_caches(model: TabICAModel, theta_ctx, x_ctx, ctx_mask,
                           target_transform: str = "zscore"):
    """Encode the context for every θ-dimension in one call: a
    ``FittedContext`` with a leading ``[dθ]`` axis, the per-dimension
    quantile maps (batch ``[dθ]``) or None, and the "+featq" per-column maps
    or None."""
    target, feat_q = pp.parse_transform(target_transform)
    n, dth = theta_ctx.shape
    dx = x_ctx.shape[1]
    f = _eff_features(model, dx, dth)
    xc = _context_columns(theta_ctx, x_ctx, f)
    qts_f = None
    if feat_q:
        qts_f = pp.quantile_fit_cols(xc, ctx_mask)
        xc = pp.quantile_forward_cols(qts_f, xc)
    col = torch.arange(f, device=xc.device)
    feat_masks = col[None, :] < (dx + torch.arange(dth, device=xc.device))[:, None]  # [dθ, f]
    y_enc, qts = theta_ctx.T, None
    if target == "quantile":
        qts = pp.quantile_fit(y_enc, ctx_mask)
        y_enc = pp.quantile_forward(qts, y_enc)
    fitted = regressor.fit_encode(model, xc.expand(dth, n, f), y_enc, feat_masks, ctx_mask)
    return fitted, qts, qts_f


def _dim(caches: FittedContext, i: int) -> FittedContext:
    """Dimension ``i``'s slice of the stacked caches (the context mask is shared)."""
    s = caches.stats
    return FittedContext(
        cache=[(k[i], v[i]) for k, v in caches.cache],
        stats=ContextStats(s.mu_x[i], s.sd_x[i], s.mu_y[i], s.sd_y[i]),
        feat_mask=caches.feat_mask[i], ctx_mask=caches.ctx_mask)


def _query_columns(caches, qts_f, x_qry, theta):
    xq = _context_columns(theta, x_qry, caches.feat_mask.shape[-1])
    return pp.quantile_forward_cols(qts_f, xq) if qts_f is not None else xq


@torch.no_grad()
def _cached_sample(model: TabICAModel, caches: FittedContext, qts, qts_f, x_qry,
                   generator: torch.Generator, qry_chunk: int):
    """``autoregressive_sample`` against the precomputed caches: decode only."""
    dth = caches.stats.mu_y.shape[0]
    q = x_qry.shape[0]
    theta = x_qry.new_zeros((q, dth))
    lp = x_qry.new_zeros((q,))
    for i in range(dth):
        fitted = _dim(caches, i)
        logits = _chunked_logits(model, fitted, _query_columns(caches, qts_f, x_qry, theta),
                                 qry_chunk)
        th_i = regressor.sample_y(generator, model, fitted, logits)
        lp_i = regressor.log_prob_y(model, fitted, logits, th_i)
        if qts is not None:
            th_i = pp.quantile_inverse(qts.select(i), th_i)
            lp_i = lp_i + pp.quantile_log_det(qts.select(i), th_i)
        lp = lp + lp_i
        theta[:, i] = th_i
    return theta, lp


@torch.no_grad()
def _cached_log_prob(model: TabICAModel, caches: FittedContext, qts, qts_f, x_qry, theta_eval,
                     qry_chunk: int):
    """``autoregressive_log_prob`` against the precomputed caches."""
    dth = caches.stats.mu_y.shape[0]
    xq = _query_columns(caches, qts_f, x_qry, theta_eval)
    lp = 0.0
    for i in range(dth):
        fitted = _dim(caches, i)
        logits = _chunked_logits(model, fitted, xq, qry_chunk)
        th_i = theta_eval[:, i]
        if qts is None:
            lp = lp + regressor.log_prob_y(model, fitted, logits, th_i)
        else:
            qt = qts.select(i)
            lp = lp + (regressor.log_prob_y(model, fitted, logits, pp.quantile_forward(qt, th_i))
                       + pp.quantile_log_det(qt, th_i))
    return lp


class CachedPosterior:
    """A posterior bound to one observation with all dθ context encodings
    precomputed; ``sample`` and ``log_prob`` only decode. Like the JAX
    package's, it serves the estimator's target and feature transforms on
    one context (no ensembles)."""

    def __init__(self, estimator: NPEPFN, x_o, generator: Optional[torch.Generator] = None):
        self.estimator = estimator
        self.x_o = estimator._one_obs(x_o)
        theta_ctx, x_ctx, ctx_mask = estimator.get_context(self.x_o, generator)
        self.dx = int(x_ctx.shape[1])
        self.dim_theta = int(theta_ctx.shape[1])
        self.caches, self.qts, self.qts_f = _precompute_dim_caches(
            estimator.model, theta_ctx, x_ctx, ctx_mask, estimator.target_transform)

    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None,
               return_log_probs: bool = False):
        est = self.estimator
        q = _round_up(num_samples, est.qry_chunk)
        theta, lp = _cached_sample(est.model, self.caches, self.qts, self.qts_f,
                                   self.x_o.broadcast_to((q, self.dx)),
                                   generator or est._generator, est.qry_chunk)
        theta, lp = theta[:num_samples], lp[:num_samples]
        return (theta, lp) if return_log_probs else theta

    def log_prob(self, theta):
        est = self.estimator
        theta = est._tensor(theta)
        n = theta.shape[0]
        q = _round_up(n, est.qry_chunk)
        theta_pad = torch.nn.functional.pad(theta, (0, 0, 0, q - n))
        lp = _cached_log_prob(est.model, self.caches, self.qts, self.qts_f,
                              self.x_o.broadcast_to((q, self.dx)), theta_pad, est.qry_chunk)
        return lp[:n]
