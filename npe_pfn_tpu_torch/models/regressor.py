"""Functional regressor interface over the TabICA transformer.

Counterpart of ``npe_pfn_tpu/models/regressor.py``: ``fit_encode`` binds a
context (normalize + encode once), ``predict_logits`` decodes query rows
against it, and ``sample_y`` / ``log_prob_y`` read the bar distribution in the
original target space. Features and targets are z-scored with masked context
statistics; densities carry the ``-log sd_y`` correction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import bar_distribution as bar
from . import transformer
from .config import TabICAConfig

_FEATURE_CLIP = 12.0
_MIN_STD = 1e-6


@dataclasses.dataclass
class TabICAModel:
    """Config, parameters (nested dict of tensors), bar borders and the
    calibration temperature that divides the bar logits."""

    cfg: TabICAConfig
    params: dict
    borders: torch.Tensor
    temperature: float = 1.0

    @property
    def device(self) -> torch.device:
        return self.borders.device

    @classmethod
    def create(cls, generator: torch.Generator, cfg: TabICAConfig, device=None) -> "TabICAModel":
        """A randomly initialized model (``transformer.init_params``) on
        ``device`` (default: the generator's)."""
        device = generator.device if device is None else torch.device(device)
        return cls(cfg=cfg, params=transformer.init_params(generator, cfg, device),
                   borders=bar.make_borders(cfg.num_bars, cfg.bar_range, device=device))


@dataclasses.dataclass
class ContextStats:
    mu_x: torch.Tensor  # [..., F]
    sd_x: torch.Tensor  # [..., F]
    mu_y: torch.Tensor  # [...]
    sd_y: torch.Tensor  # [...]


@dataclasses.dataclass
class FittedContext:
    """What predictions need: the per-layer K/V cache and normalization."""

    cache: list  # L x (k, v), each [..., T, N, H, hd]
    stats: ContextStats
    feat_mask: torch.Tensor  # [..., F]
    ctx_mask: torch.Tensor  # [..., N]


def compute_stats(x_ctx, y_ctx, ctx_mask) -> ContextStats:
    w = ctx_mask.float()
    denom = w.sum(dim=-1).clamp_min(1.0)
    mu_x = (x_ctx * w[..., :, None]).sum(dim=-2) / denom[..., None]
    var_x = ((x_ctx - mu_x[..., None, :]).square() * w[..., :, None]).sum(dim=-2) / denom[..., None]
    mu_y = (y_ctx * w).sum(dim=-1) / denom
    var_y = ((y_ctx - mu_y[..., None]).square() * w).sum(dim=-1) / denom
    return ContextStats(
        mu_x=mu_x,
        sd_x=var_x.sqrt().clamp_min(_MIN_STD),
        mu_y=mu_y,
        sd_y=var_y.sqrt().clamp_min(_MIN_STD),
    )


def normalize_x(stats: ContextStats, x):
    z = (x - stats.mu_x[..., None, :]) / stats.sd_x[..., None, :]
    return z.clamp(-_FEATURE_CLIP, _FEATURE_CLIP)


def normalize_y(stats: ContextStats, y):
    return (y - stats.mu_y[..., None]) / stats.sd_y[..., None]


def fit_encode(model: TabICAModel, x_ctx, y_ctx,
               feat_mask: Optional[torch.Tensor] = None,
               ctx_mask: Optional[torch.Tensor] = None) -> FittedContext:
    """Normalize the context ``[N, F]`` / ``[N]`` and encode it once."""
    n, f = x_ctx.shape[-2], x_ctx.shape[-1]
    dev = x_ctx.device
    if feat_mask is None:
        feat_mask = torch.ones(x_ctx.shape[:-2] + (f,), dtype=torch.bool, device=dev)
    if ctx_mask is None:
        ctx_mask = torch.ones(x_ctx.shape[:-2] + (n,), dtype=torch.bool, device=dev)
    stats = compute_stats(x_ctx, y_ctx, ctx_mask)
    xn = normalize_x(stats, x_ctx) * feat_mask[..., None, :]
    yn = normalize_y(stats, y_ctx) * ctx_mask
    cache = transformer.encode_context(model.cfg, model.params, xn, yn, feat_mask, ctx_mask)
    return FittedContext(cache=cache, stats=stats, feat_mask=feat_mask, ctx_mask=ctx_mask)


def predict_logits(model: TabICAModel, fitted: FittedContext, x_qry):
    """Bar logits in normalized target space, ``[..., Q, num_bars]``,
    divided by the calibration temperature."""
    xq = normalize_x(fitted.stats, x_qry) * fitted.feat_mask[..., None, :]
    logits = transformer.decode_queries(
        model.cfg, model.params, fitted.cache, xq, fitted.feat_mask, fitted.ctx_mask
    )
    return logits / model.temperature


def sample_y(generator: torch.Generator, model: TabICAModel, fitted: FittedContext, logits):
    """One draw per logit row, in the original target space."""
    yn = bar.sample(generator, model.borders, logits)
    return yn * fitted.stats.sd_y + fitted.stats.mu_y


def log_prob_y(model: TabICAModel, fitted: FittedContext, logits, y):
    """log p(y) in the original space: log p_norm((y - mu) / sd) - log sd."""
    yn = (y - fitted.stats.mu_y) / fitted.stats.sd_y
    return bar.log_prob(model.borders, logits, yn) - torch.log(fitted.stats.sd_y)
