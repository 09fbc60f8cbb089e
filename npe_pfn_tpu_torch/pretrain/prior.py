"""Synthetic task prior for pretraining TabICA.

Counterpart of ``npe_pfn_tpu/pretrain/prior.py``: the same three task
families, the same knobs and defaults, the same shapes and masks.

1. **Stochastic-conditional regression**: y = g(x, z) + noise for a random
   sparse MLP g and a latent z.
2. **SBI inverse problems**: θ ~ N(0, I), x = s(θ) + noise; the features are
   (x dims, θ_{<j}) and the target is θ_j.
3. **Explicit mixture conditionals** (family C, ``p_multimodal``), and
   thresholded binary tasks (``p_binary``) on top of any family.

The JAX package vmaps one dataset's sampler over the dataset axis; here every
tensor carries a leading dataset dimension ``D`` and every per-dataset draw is
a ``[D]`` tensor. A ``lax.switch`` under vmap (the random activation) becomes
all four activations computed and one selected per dataset. Every draw comes
from one explicit ``torch.Generator`` on the device where the batch is born,
so a batch is made on the card without touching the host. The bits differ
from ``jax.random``'s; the distribution is the same (tests compare the two by
distribution). ``jax.random.gamma(k, 2.0)`` is drawn as -log U1 - log U2 (a
shape-2 gamma is the sum of two unit exponentials) and ``categorical`` as
Gumbel-max.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    num_features: int = 32        # static feature width F (mask selects active)
    num_ctx: int = 384            # static context slots per dataset
    num_qry: int = 128            # query rows per dataset
    max_active_features: int = 24
    min_ctx: int = 8
    hidden: int = 64              # random-MLP width
    max_theta_dim: int = 6        # for inverse problems
    latent_dim: int = 4           # z dim for stochastic conditionals
    p_inverse: float = 0.4        # mixture weights
    p_binary: float = 0.15
    p_heteroscedastic: float = 0.0    # input-dependent noise scale
    p_heavy_tail: float = 0.0         # student-t-ish feature marginals
    p_categorical_feats: float = 0.0  # quantize a random subset of features
    p_multimodal: float = 0.0         # family C share: mixture conditionals
    p_sym_fold: float = 0.0           # |.| fold of theta combos (family B)
    max_mixture_components: int = 4   # K range for family C (2..K)
    mm_mu_input_scale: float = 1.0    # x scale before the family-C MLPs
    mm_sig_lo: float = -2.5           # log10 lower bound of family-C scales
    p_marginal_mixture: float = 0.0   # family-C tasks with y independent of x


@dataclasses.dataclass
class TaskBatch:
    x_ctx: torch.Tensor   # [D, N, F]
    y_ctx: torch.Tensor   # [D, N]
    x_qry: torch.Tensor   # [D, Q, F]
    y_qry: torch.Tensor   # [D, Q]
    feat_mask: torch.Tensor  # [D, F] bool
    ctx_mask: torch.Tensor   # [D, N] bool


class _Draws:
    """Draws of per-dataset shapes from one generator on one device."""

    def __init__(self, generator: torch.Generator, num_datasets: int):
        self.gen = generator
        self.d = num_datasets
        self.dev = generator.device

    def uniform(self, shape=(), lo=0.0, hi=1.0):
        u = torch.rand((self.d, *shape), generator=self.gen, device=self.dev)
        return lo + (hi - lo) * u

    def normal(self, shape=()):
        return torch.randn((self.d, *shape), generator=self.gen, device=self.dev)

    def bernoulli(self, p, shape=()):
        """p: a float or a ``[D]`` tensor of probabilities."""
        u = self.uniform(shape)
        if isinstance(p, torch.Tensor):
            p = p.reshape(p.shape + (1,) * len(shape))
        return u < p

    def randint(self, lo, hi, shape=()):
        return torch.randint(lo, hi, (self.d, *shape), generator=self.gen, device=self.dev)

    def gamma2(self, shape):
        """Gamma(shape 2, scale 1): the sum of two unit exponentials."""
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform((2, *shape)).clamp_min(tiny)
        return -torch.log(u[:, 0]) - torch.log(u[:, 1])

    def categorical(self, logits):
        """One index per row of ``logits`` [D, R, K] by Gumbel-max."""
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(logits.shape[1:]).clamp_min(tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _bcast(t, ndim):
    """A ``[D]`` tensor shaped to broadcast against a ``[D, ...]`` of ``ndim`` dims."""
    return t.reshape(t.shape + (1,) * (ndim - 1))


def _where(cond, a, b):
    """``jnp.where`` of a per-dataset ``[D]`` condition over ``[D, ...]`` values."""
    return torch.where(_bcast(cond, max(a.dim(), b.dim())), a, b)


def _std(x, dims):
    """Population standard deviation (``jnp.std``) over ``dims``."""
    return x.std(dim=dims, correction=0, keepdim=True)


def _rand_act(rnd: _Draws, h):
    """Random activation per dataset: tanh, relu, sin or identity."""
    idx = _bcast(rnd.randint(0, 4), h.dim())
    return torch.where(idx == 0, torch.tanh(h),
                       torch.where(idx == 1, torch.relu(h),
                                   torch.where(idx == 2, torch.sin(h), h)))


def _random_mlp(rnd: _Draws, x, out_dim: int, hidden: int):
    """A per-dataset random sparse 2-hidden-layer MLP: [D, R, Din] -> [D, R, out_dim]."""
    din = x.shape[-1]
    scale1 = rnd.uniform((), 0.5, 2.5)
    w1 = rnd.normal((din, hidden)) * _bcast(scale1, 3) / math.sqrt(din)
    keep = rnd.bernoulli(1.0 - 0.7 * rnd.uniform(), (din, hidden))
    w1 = w1 * keep
    b1 = rnd.normal((hidden,)) * 0.3
    h = _rand_act(rnd, x @ w1 + b1[:, None, :])
    w2 = rnd.normal((hidden, hidden)) * (1.0 / math.sqrt(hidden))
    b2 = rnd.normal((hidden,)) * 0.3
    h = _rand_act(rnd, h @ w2 + b2[:, None, :])
    w3 = rnd.normal((hidden, out_dim)) * (1.0 / math.sqrt(hidden))
    return h @ w3


def _family_c(rnd: _Draws, cfg: PriorConfig, xin):
    """Family C: a K-component mixture conditional p(y|x) per dataset.

    xin ``[D, R, F]``. Returns ``(y [D, R], (mu [D, R, K], sig [D, K],
    wlog [D, R, K]))``, the draw and the exact conditional.
    """
    k = cfg.max_mixture_components
    r = xin.shape[1]
    mu_raw = _random_mlp(rnd, xin * cfg.mm_mu_input_scale, k, cfg.hidden)  # [D, R, K]
    mu_sd = _std(mu_raw, 1).clamp_min(1e-6)
    mu = (mu_raw - mu_raw.mean(dim=1, keepdim=True)) / mu_sd
    sep = rnd.uniform((), 0.3, 2.0)
    mu = mu * _bcast(sep, 3)
    collapse = rnd.bernoulli(0.3)
    mu = _where(collapse, mu[:, :, :1].expand_as(mu), mu)
    sig = 10.0 ** rnd.uniform((k,), cfg.mm_sig_lo, -0.2)  # [D, K]
    k_live = rnd.randint(2, k + 1)
    comp_alive = torch.arange(k, device=xin.device)[None, :] < k_live[:, None]  # [D, K]
    wlog_x = _random_mlp(rnd, xin * cfg.mm_mu_input_scale, k, cfg.hidden)
    temp = rnd.uniform((), 0.5, 2.0)
    use_xw = rnd.bernoulli(0.5)
    wlog_g = rnd.normal((k,))  # [D, K]
    wlog = _where(use_xw, wlog_x / _bcast(temp, 3), wlog_g[:, None, :].expand_as(wlog_x))
    if cfg.p_marginal_mixture > 0:
        # Marginal-mixture branch: y independent of x, row-constant means
        # (collapsed to a shared zero mean with probability 0.5) and weights.
        is_marg = rnd.bernoulli(cfg.p_marginal_mixture)
        mu_marg = rnd.normal((1, k)) * _bcast(sep, 3)
        collapse_m = rnd.bernoulli(0.5)
        mu_marg = _where(collapse_m, torch.zeros_like(mu_marg), mu_marg)
        mu = _where(is_marg, mu_marg.expand_as(mu), mu)
        wlog = _where(is_marg, wlog_g[:, None, :].expand_as(wlog), wlog)
    wlog = torch.where(comp_alive[:, None, :], wlog, -math.inf)
    comp = rnd.categorical(wlog)  # [D, R]
    eps = rnd.normal((r,))
    y = torch.gather(mu, 2, comp[..., None])[..., 0] + torch.gather(sig, 1, comp) * eps
    return y, (mu, sig, wlog)


def _quantile(y, q):
    """Per-dataset ``jnp.quantile(y[d], q[d])`` with linear interpolation."""
    ys = torch.sort(y, dim=-1).values
    pos = q * (y.shape[-1] - 1)
    lo = pos.floor().long()
    hi = pos.ceil().long()
    y_lo = torch.gather(ys, 1, lo[:, None])[:, 0]
    y_hi = torch.gather(ys, 1, hi[:, None])[:, 0]
    return y_lo + (pos - lo) * (y_hi - y_lo)


def _sample(rnd: _Draws, cfg: PriorConfig, max_feat=None):
    """``num_datasets`` datasets of ``R = num_ctx + num_qry`` rows: the JAX
    ``_sample_one``, for every dataset at once."""
    d = rnd.d
    dev = rnd.dev
    r = cfg.num_ctx + cfg.num_qry
    f = cfg.num_features
    mf = cfg.max_active_features if max_feat is None else max_feat
    if isinstance(mf, torch.Tensor):
        mf = mf.to(dev)

    # --- active feature count / context size (biased toward small) ---------
    u_f = rnd.uniform()
    f_active = 1 + torch.floor(u_f**1.5 * (mf - 1)).to(torch.int32)
    u_n = rnd.uniform()
    n_active = cfg.min_ctx + torch.floor(u_n**1.2 * (cfg.num_ctx - cfg.min_ctx)).to(torch.int32)
    col = torch.arange(f, device=dev, dtype=torch.int32)[None, :]  # [1, F]
    feat_mask = col < f_active[:, None]
    ctx_mask = torch.arange(cfg.num_ctx, device=dev, dtype=torch.int32)[None, :] < n_active[:, None]

    # =========== family A: forward stochastic-conditional regression =======
    x_raw = rnd.normal((r, f))
    mix_w = rnd.normal((f, f)) / math.sqrt(f)
    alpha = _bcast(rnd.uniform(), 3)
    x_fwd = x_raw * (1 - alpha) + (x_raw @ mix_w) * alpha
    uniformize = rnd.bernoulli(0.3, (f,))[:, None, :]
    x_fwd = torch.where(uniformize, torch.special.ndtr(x_fwd) * 2 - 1, x_fwd)
    if cfg.p_heavy_tail > 0:
        heavy = rnd.bernoulli(cfg.p_heavy_tail, (f,))[:, None, :]
        mix = 1.0 / torch.sqrt(rnd.gamma2((r, f)) / 2.0 + 1e-3)
        x_fwd = torch.where(heavy, x_fwd * mix, x_fwd)
    if cfg.p_categorical_feats > 0:
        cat = rnd.bernoulli(cfg.p_categorical_feats, (f,))[:, None, :]
        n_levels = rnd.randint(2, 8, (f,)).to(torch.float32)[:, None, :]
        x_quant = torch.round(torch.special.ndtr(x_fwd) * n_levels - 0.5)
        x_fwd = torch.where(cat, x_quant, x_fwd)
    fm = feat_mask[:, None, :].to(x_fwd.dtype)
    z = rnd.normal((r, cfg.latent_dim))
    z_scale = _bcast(rnd.uniform((), 0.0, 1.5), 3)
    g_in = torch.cat([x_fwd * fm, z * z_scale], dim=-1)
    y_fwd = _random_mlp(rnd, g_in, 1, cfg.hidden)[..., 0]  # [D, R]
    sd_y = _std(y_fwd, 1).clamp_min(1e-6)
    noise_scale = _bcast(10.0 ** rnd.uniform((), -3.0, -0.3), 2)
    noise = rnd.normal((r,)) * noise_scale * sd_y
    if cfg.p_heteroscedastic > 0:
        het = rnd.bernoulli(cfg.p_heteroscedastic)
        gate = torch.sigmoid(_random_mlp(rnd, x_fwd * fm, 1, cfg.hidden)[..., 0])
        noise = _where(het, noise * 2.0 * gate, noise)
    y_fwd = y_fwd + noise

    # =========== family B: SBI inverse problem ==============================
    dth = cfg.max_theta_dim
    theta = rnd.normal((r, dth))
    j = rnd.randint(0, dth)
    n_sim_feats = torch.clamp_min(f_active - j, 1)
    if cfg.p_sym_fold > 0:
        do_fold = rnd.bernoulli(cfg.p_sym_fold)
        a_mix = rnd.normal((dth, dth)) / math.sqrt(dth)
        v = theta @ a_mix
        fold_mask = rnd.bernoulli(0.5, (dth,))
        fold_mask[torch.arange(d, device=dev), rnd.randint(0, dth)] = True
        folded = torch.where(fold_mask[:, None, :], v.abs(), v)
        theta_sim_in = _where(do_fold, folded, theta)
    else:
        theta_sim_in = theta
    x_sim = _random_mlp(rnd, theta_sim_in, f, cfg.hidden)
    sim_noise = _bcast(10.0 ** rnd.uniform((), -3.0, -0.5), 3)
    x_sim = x_sim + rnd.normal((r, f)) * sim_noise * _std(x_sim, (1, 2)).clamp_min(1e-6)
    # Columns [0, n_sim_feats) are simulator outputs, then theta_{<j}.
    theta_col = torch.clamp(col - n_sim_feats[:, None], 0, dth - 1).long()  # [D, F]
    theta_feats = torch.gather(theta, 2, theta_col[:, None, :].expand(d, r, f))
    x_inv = torch.where((col < n_sim_feats[:, None])[:, None, :], x_sim, theta_feats)
    f_active_inv = torch.clamp_max(n_sim_feats + j, f)
    feat_mask_inv = col < f_active_inv[:, None]
    y_inv = torch.gather(theta, 2, j.long()[:, None, None].expand(d, r, 1))[..., 0]

    # =========== family C: explicit mixture conditionals ===================
    if cfg.p_multimodal > 0:
        y_mm, _ = _family_c(rnd, cfg, x_fwd * fm)
    # =========== mixture selection ==========================================
    is_inv = rnd.bernoulli(cfg.p_inverse)
    x_all = _where(is_inv, x_inv, x_fwd)
    y_all = _where(is_inv, y_inv, y_fwd)
    feat_mask_a = feat_mask
    feat_mask = _where(is_inv, feat_mask_inv, feat_mask)
    if cfg.p_multimodal > 0:
        is_mm = rnd.bernoulli(cfg.p_multimodal)
        x_all = _where(is_mm, x_fwd, x_all)
        y_all = _where(is_mm, y_mm, y_all)
        feat_mask = _where(is_mm, feat_mask_a, feat_mask)

    # =========== optional binarization (classifier calibration) ============
    is_bin = rnd.bernoulli(cfg.p_binary)
    thr_q = rnd.uniform((), 0.15, 0.85)
    thr = _quantile(y_all, thr_q)
    y_all = _where(is_bin, (y_all > thr[:, None]).to(y_all.dtype), y_all)

    x_all = x_all * feat_mask[:, None, :].to(x_all.dtype)
    n = cfg.num_ctx
    return TaskBatch(x_all[:, :n], y_all[:, :n], x_all[:, n:], y_all[:, n:], feat_mask, ctx_mask)


def sample_tasks(generator: torch.Generator, num_datasets: int, cfg: PriorConfig,
                 max_feat=None, device=None) -> TaskBatch:
    """A batch of ``num_datasets`` synthetic tasks, born on ``generator``'s
    device (``device``, if given, must be that device). ``max_feat`` (an int
    or a 0-d tensor) overrides ``cfg.max_active_features`` (the feature-count
    curriculum)."""
    if device is not None and torch.device(device) != generator.device:
        raise ValueError(f"the generator lives on {generator.device}, not on {device}")
    with torch.no_grad():
        return _sample(_Draws(generator, num_datasets), cfg, max_feat)
