"""NPE-PFN posterior estimator.

Counterpart of ``npe_pfn_tpu/estimator.py`` for a dense model: the
autoregressive samplers and scorers over θ-dimensions (plain, with quantile
target / feature transforms, and the context-subset ensemble), and ``NPEPFN``
with ``sample``, ``sample_batched``, ``sample_batched_filtered``, ``log_prob``
(autoregressive, or ratio-based through ``DensityRatioEstimator``),
``log_prob_batched`` and ``sample_refined`` (simulator-in-the-loop ABC-SIR),
with an optional embedding net on x.

Where the JAX package scans (``lax.scan`` over dimensions, ``lax.map`` over
query chunks, ``lax.while_loop`` over rejection rounds) the port loops in
Python, reading one value from the device per rejection round. Where it
``vmap``s over contexts (ensemble members, per-observation contexts), the
port carries the contexts as leading tensor dims, so that one kernel launch
per layer and query chunk serves all of them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from . import filters as filters_mod
from . import preprocessing as pp
from . import rejection
from ._device import resolve_device
from .distributions import BoxUniform, Distribution
from .models import checkpoint as ckpt_mod
from .models import regressor
from .models.regressor import TabICAModel


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _eff_features(model: TabICAModel, dx: int, dth: int) -> int:
    """Feature width the AR loop computes at: ``dx + dθ`` rounded up to 8,
    capped at ``max_features``. Exact, because columns past the conditioning
    prefix are zero cells and masked keys (tests/test_feature_slice.py pins
    this for the JAX package)."""
    return min(model.cfg.max_features, max(8, _round_up(dx + dth, 8)))


def _order_prefix_masks(order, dx: int, f: int):
    """``[dθ, f]`` bool: row i = the x columns and the θ columns sampled
    before step i under ``order``."""
    onehot = F.one_hot(dx + order, f)
    before = torch.cumsum(onehot, dim=0) - onehot
    return (torch.arange(f, device=order.device)[None, :] < dx) | (before > 0)


def _step_widths(dx: int, dth: int, f: int, dim_order, feature_width):
    """Per-step feature widths. With the identity order step i conditions on
    the first ``dx + i`` columns, so it runs at that width rounded up to 8
    (at dx = dθ = 10: steps 0-6 at width 16, steps 7-9 at 24). An explicit
    order or ``feature_width``, or steps that would all share one width, keep
    the full width ``f`` for every step, as in the JAX package."""
    widths = [min(f, max(8, _round_up(max(dx + i, 1), 8))) for i in range(dth)]
    if dim_order is not None or feature_width is not None or len(set(widths)) == 1:
        return [f] * dth
    return widths


def _context_columns(theta, x, f: int):
    """``[..., R, f]``: x in the first dx columns, θ in the next dθ, zeros after."""
    dth, dx = theta.shape[-1], x.shape[-1]
    lead = torch.broadcast_shapes(theta.shape[:-1], x.shape[:-1])
    xc = theta.new_zeros(lead + (f,))
    xc[..., :dx] = x
    xc[..., dx:dx + dth] = theta
    return xc


def _check_width(model, dx: int, dth: int):
    if dx + dth > model.cfg.max_features:
        raise ValueError(
            f"dx+dtheta = {dx + dth} exceeds model feature budget {model.cfg.max_features}"
        )


def _check_chunks(q: int, qry_chunk: int):
    if q % qry_chunk:
        raise ValueError("pad query rows to a multiple of qry_chunk")


def _encode_target(y_raw, ctx_mask, target: str):
    """The context targets the model sees, and the quantile map (or None)."""
    if target == "quantile":
        qt = pp.quantile_fit(y_raw, ctx_mask)
        return pp.quantile_forward(qt, y_raw), qt
    return y_raw, None


def _feature_maps(xc, ctx_mask, feat_q: bool):
    """The "+featq" per-column maps fitted on the full-width context, and the
    mapped context (or None and the context unchanged)."""
    if not feat_q:
        return None, xc
    qts_f = pp.quantile_fit_cols(xc, ctx_mask)
    return qts_f, pp.quantile_forward_cols(qts_f, xc)


def _chunked_logits(model, fitted, xq, qry_chunk: int):
    """Bar logits of query rows ``[..., Q, w]``, decoded ``qry_chunk`` rows at a time."""
    return torch.cat([regressor.predict_logits(model, fitted, c)
                      for c in xq.split(qry_chunk, dim=-2)], dim=-2)


def _order(dim_order, dth: int, device):
    return (torch.arange(dth) if dim_order is None else torch.as_tensor(dim_order)).to(device)


@torch.no_grad()
def autoregressive_sample(
    model: TabICAModel,
    theta_ctx,  # [*C, N, dθ]
    x_ctx,  # [*C, N, dx]
    ctx_mask,  # [N] or [*C, N]
    x_qry,  # [*C, Q, dx], one observation per query row
    generator: torch.Generator,
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    dim_order=None,
    feature_width: Optional[int] = None,
):
    """Draw θ ~ q(θ | x) one dimension at a time; returns (theta [*C, Q, dθ],
    log_prob [*C, Q]). Leading dims ``C`` batch independent contexts (the
    JAX package ``vmap``s them). ``target_transform`` is "zscore" or
    "quantile", optionally with "+featq": quantile targets are mapped back
    after the draw and their log-probs carry the Jacobian; "+featq" maps
    every feature column with maps fitted once on the full-width context,
    each step slicing them to its width."""
    target, feat_q = pp.parse_transform(target_transform)
    dth = theta_ctx.shape[-1]
    q, dx = x_qry.shape[-2:]
    _check_width(model, dx, dth)
    _check_chunks(q, qry_chunk)
    f = feature_width or _eff_features(model, dx, dth)
    qts_f, xc = _feature_maps(_context_columns(theta_ctx, x_ctx, f), ctx_mask, feat_q)
    order = _order(dim_order, dth, theta_ctx.device)
    prefix_masks = _order_prefix_masks(order, dx, f)
    widths = _step_widths(dx, dth, f, dim_order, feature_width)

    lead = torch.broadcast_shapes(theta_ctx.shape[:-2], x_qry.shape[:-2])
    theta = x_qry.new_zeros(lead + (q, dth))
    lp = x_qry.new_zeros(lead + (q,))
    for i, oi in enumerate(order.tolist()):
        w = widths[i]
        y_ctx, qt = _encode_target(theta_ctx[..., oi], ctx_mask, target)
        fitted = regressor.fit_encode(model, xc[..., :w], y_ctx, prefix_masks[i, :w], ctx_mask)
        xq = x_qry.new_zeros(lead + (q, w))
        xq[..., :dx] = x_qry
        nset = min(w - dx, dth)
        if nset > 0:
            xq[..., dx:dx + nset] = theta[..., :nset]
        if feat_q:
            xq = pp.quantile_forward_cols(qts_f.first_cols(w), xq)
        logits = _chunked_logits(model, fitted, xq, qry_chunk)
        th_i = regressor.sample_y(generator, model, fitted, logits)
        lp_i = regressor.log_prob_y(model, fitted, logits, th_i)
        if qt is not None:
            th_i = pp.quantile_inverse(qt, th_i)
            lp_i = lp_i + pp.quantile_log_det(qt, th_i)
        lp = lp + lp_i
        theta[..., oi] = th_i
    return theta, lp


@torch.no_grad()
def autoregressive_log_prob(
    model: TabICAModel,
    theta_ctx,  # [*C, N, dθ]
    x_ctx,  # [*C, N, dx]
    ctx_mask,  # [N] or [*C, N]
    x_qry,  # [*C, Q, dx]
    theta_eval,  # [*C, Q, dθ]
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    dim_order=None,
    feature_width: Optional[int] = None,
):
    """Score log q(θ | x) autoregressively, ``[*C, Q]``; quantile targets
    map θ forward before scoring and add the Jacobian."""
    target, feat_q = pp.parse_transform(target_transform)
    dth = theta_ctx.shape[-1]
    q, dx = x_qry.shape[-2:]
    _check_chunks(q, qry_chunk)
    f = feature_width or _eff_features(model, dx, dth)
    qts_f, xc = _feature_maps(_context_columns(theta_ctx, x_ctx, f), ctx_mask, feat_q)
    xq_full = _context_columns(theta_eval, x_qry, f)
    if feat_q:
        xq_full = pp.quantile_forward_cols(qts_f, xq_full)
    order = _order(dim_order, dth, theta_ctx.device)
    prefix_masks = _order_prefix_masks(order, dx, f)
    widths = _step_widths(dx, dth, f, dim_order, feature_width)

    lp = 0.0
    for i, oi in enumerate(order.tolist()):
        w = widths[i]
        y_ctx, qt = _encode_target(theta_ctx[..., oi], ctx_mask, target)
        th_i = theta_eval[..., oi]
        fitted = regressor.fit_encode(model, xc[..., :w], y_ctx, prefix_masks[i, :w], ctx_mask)
        logits = _chunked_logits(model, fitted, xq_full[..., :w], qry_chunk)
        if qt is None:
            lp = lp + regressor.log_prob_y(model, fitted, logits, th_i)
        else:
            lp = lp + (regressor.log_prob_y(model, fitted, logits, pp.quantile_forward(qt, th_i))
                       + pp.quantile_log_det(qt, th_i))
    return lp


def _mixture_log_prob(model, fitted, logits, qts, th_i):
    """log of the equal-weight mixture of the E member densities at θ_i:
    logits ``[*C, E, Q, B]``, θ_i ``[*C, Q]`` → ``[*C, Q]``."""
    th_b = th_i.unsqueeze(-2).broadcast_to(logits.shape[:-1])
    if qts is None:
        lp_e = regressor.log_prob_y(model, fitted, logits, th_b)
    else:
        lp_e = (regressor.log_prob_y(model, fitted, logits, pp.quantile_forward(qts, th_b))
                + pp.quantile_log_det(qts, th_b))
    return torch.logsumexp(lp_e, dim=-2) - math.log(logits.shape[-3])


@torch.no_grad()
def autoregressive_sample_ensemble(
    model: TabICAModel,
    theta_ctx,  # [*C, E, Ne, dθ]: the context split into E members
    x_ctx,  # [*C, E, Ne, dx]
    ctx_mask,  # [*C, E, Ne]
    x_qry,  # [*C, Q, dx]
    generator: torch.Generator,
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    feature_width: Optional[int] = None,
):
    """Sample the equal-weight mixture of E context-subset members: each
    member encodes its own rows and normalization; each query row draws its
    member, and its log-prob is the mixture density (logsumexp). Every step
    runs the full width with the feature mask ``col < dx + i``. The members
    are a leading ``[E]`` axis: one kernel launch per layer and query chunk
    serves all of them."""
    target, feat_q = pp.parse_transform(target_transform)
    e, dth = theta_ctx.shape[-3], theta_ctx.shape[-1]
    q, dx = x_qry.shape[-2:]
    _check_width(model, dx, dth)
    _check_chunks(q, qry_chunk)
    f = feature_width or _eff_features(model, dx, dth)
    qts_f, xc = _feature_maps(_context_columns(theta_ctx, x_ctx, f), ctx_mask, feat_q)
    col = torch.arange(f, device=theta_ctx.device)
    lead = x_qry.shape[:-2]
    theta = x_qry.new_zeros(lead + (q, dth))
    lp = x_qry.new_zeros(lead + (q,))
    for i in range(dth):
        y_ctx, qts = _encode_target(theta_ctx[..., i], ctx_mask, target)
        fitted = regressor.fit_encode(model, xc, y_ctx, col < dx + i, ctx_mask)
        xq = _context_columns(theta, x_qry, f).unsqueeze(-3)  # [*C, 1, Q, f]
        if feat_q:
            xq = pp.quantile_forward_cols(qts_f, xq)  # per-member maps: [*C, E, Q, f]
        logits = _chunked_logits(model, fitted, xq, qry_chunk)  # [*C, E, Q, B]
        member = torch.randint(0, e, lead + (q,), generator=generator, device=x_qry.device)
        y_e = regressor.sample_y(generator, model, fitted, logits)  # [*C, E, Q]
        if qts is not None:
            y_e = pp.quantile_inverse(qts, y_e)
        th_i = y_e.gather(-2, member.unsqueeze(-2)).squeeze(-2)
        lp = lp + _mixture_log_prob(model, fitted, logits, qts, th_i)
        theta[..., i] = th_i
    return theta, lp


@torch.no_grad()
def autoregressive_log_prob_ensemble(
    model: TabICAModel,
    theta_ctx,  # [*C, E, Ne, dθ]
    x_ctx,  # [*C, E, Ne, dx]
    ctx_mask,  # [*C, E, Ne]
    x_qry,  # [*C, Q, dx]
    theta_eval,  # [*C, Q, dθ]
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    feature_width: Optional[int] = None,
):
    """Score log q(θ | x) under the mixture ``autoregressive_sample_ensemble``
    draws from, ``[*C, Q]``."""
    target, feat_q = pp.parse_transform(target_transform)
    dth = theta_ctx.shape[-1]
    q, dx = x_qry.shape[-2:]
    _check_chunks(q, qry_chunk)
    f = feature_width or _eff_features(model, dx, dth)
    qts_f, xc = _feature_maps(_context_columns(theta_ctx, x_ctx, f), ctx_mask, feat_q)
    xq = _context_columns(theta_eval, x_qry, f).unsqueeze(-3)
    if feat_q:
        xq = pp.quantile_forward_cols(qts_f, xq)
    col = torch.arange(f, device=theta_ctx.device)
    lp = 0.0
    for i in range(dth):
        y_ctx, qts = _encode_target(theta_ctx[..., i], ctx_mask, target)
        fitted = regressor.fit_encode(model, xc, y_ctx, col < dx + i, ctx_mask)
        logits = _chunked_logits(model, fitted, xq, qry_chunk)
        lp = lp + _mixture_log_prob(model, fitted, logits, qts, theta_eval[..., i])
    return lp


def split_context_ensemble(theta_ctx, x_ctx, ctx_mask, num_ensembles: int):
    """Round-robin split of a (possibly distance-ordered) context ``[..., N]``
    into E members ``[..., E, N // E]``, so that every member sees the full
    distance range."""
    n_e = theta_ctx.shape[-2] // num_ensembles
    idx = torch.arange(n_e * num_ensembles, device=theta_ctx.device)
    idx = idx.reshape(n_e, num_ensembles).T
    return theta_ctx[..., idx, :], x_ctx[..., idx, :], ctx_mask[..., idx]


# ---------------------------------------------------------------------------
# Density-ratio log_prob (classifier path)
# ---------------------------------------------------------------------------


class DensityRatioEstimator:
    """Ratio-based log_prob through a posterior-vs-uniform in-context classifier.

    Posterior samples get label 1 and uniform draws from their padded bounding
    box label 0; then log p(θ | x) ≈ log u(θ) + log(p₁ + ε) − log(p₀ + ε), with
    p the classifier head ``regressor.predict_proba``. The fit is cached on
    (x, context version, number of samples, padding). ``num_fits > 1`` ensembles
    classifier contexts (disjoint posterior subsets, fresh negatives) and
    averages their probabilities; the contexts are one leading dim, so all of
    them share one kernel launch per layer.
    """

    def __init__(self, model: TabICAModel, context_size: int = 512, num_fits: int = 1,
                 eps: float = 1e-12):
        self.model = model
        self.context_size = context_size
        self.num_fits = num_fits
        self.eps = eps
        self._cache_key = None
        self._ctx_theta = None  # [num_fits, context_size, dθ]
        self._ctx_labels = None  # [num_fits, context_size]
        self._low = self._high = None
        self._log_u = 0.0

    def refit_necessary(self, x, ctx_fingerprint, n_samples: int, padding: float) -> bool:
        if self._cache_key is None:
            return True
        kx, kf, kn, kp = self._cache_key
        return not (kn == n_samples and kp == padding and kf == ctx_fingerprint
                    and kx.shape == x.shape and bool(torch.allclose(kx, x)))

    def fit(self, generator: torch.Generator, posterior_samples, x, ctx_fingerprint,
            padding: float = 0.1):
        """Build the classifier contexts from ``posterior_samples [n, dθ]``:
        one permutation sliced (wrapping) into disjoint positive halves, and a
        uniform negative half per fit."""
        n_half = self.context_size // 2
        lo, hi = posterior_samples.amin(dim=0), posterior_samples.amax(dim=0)
        span = hi - lo
        self._low, self._high = lo - padding * span, hi + padding * span
        self._log_u = float(-torch.log((self._high - self._low).clamp_min(1e-12)).sum())
        n_post = posterior_samples.shape[0]
        dev = posterior_samples.device
        perm = torch.randperm(n_post, generator=generator, device=generator.device).to(dev)
        box = BoxUniform(self._low, self._high)
        rows = torch.arange(n_half, device=dev)
        ctxs = [torch.cat([posterior_samples[perm[(rows + f_i * n_half) % n_post]],
                           box.sample(generator, (n_half,))]) for f_i in range(self.num_fits)]
        labels = torch.cat([torch.ones(n_half, device=dev), torch.zeros(n_half, device=dev)])
        self._ctx_theta = torch.stack(ctxs)
        self._ctx_labels = labels.expand(self.num_fits, -1).contiguous()
        self._cache_key = (x.clone(), ctx_fingerprint, n_post, padding)

    @torch.no_grad()
    def ratio_log_probs(self, theta, chunk_size: int = 10_000):
        """log p(θ | x) ``[n]``: θ outside the box gets the floor
        log u + log ε − log(1 + ε). θ is classified ``chunk_size`` rows at a
        time, each chunk padded to a multiple of 256 rows; the fits' class
        probabilities (not their log-ratios) are averaged."""
        p1 = []
        for chunk in theta.split(chunk_size):
            nc = chunk.shape[0]
            chunk = F.pad(chunk, (0, 0, 0, _round_up(nc, 256) - nc))
            qry = chunk.expand((self._ctx_theta.shape[0],) + chunk.shape)
            probs = regressor.predict_proba(self.model, self._ctx_theta, self._ctx_labels, qry)
            p1.append(probs[..., 1].mean(dim=0)[:nc])
        p1 = torch.cat(p1)
        inside = ((theta >= self._low) & (theta <= self._high)).all(dim=-1)
        lp = self._log_u + torch.log(p1 + self.eps) - torch.log(1.0 - p1 + self.eps)
        floor = self._log_u + math.log(self.eps) - math.log(1 + self.eps)
        return torch.where(inside, lp, torch.full_like(lp, floor))


# ---------------------------------------------------------------------------
# Simulator-in-the-loop refinement (ABC-SIR)
# ---------------------------------------------------------------------------


def run_simulator(simulator, generator: torch.Generator, theta):
    """``simulator(generator, theta [N, dθ]) -> x [N, ...]``, float32 (the JAX
    ``NPEPFN._run_simulator``).

    The port's simulators are batched maps (``tasks.registry.Simulator``). A
    simulator that does not return one row per θ row is not batched, and it
    raises: there is no per-row host loop to fall back on."""
    x = simulator(generator, theta)
    x = torch.as_tensor(x, dtype=torch.float32, device=theta.device)
    if x.dim() == 0 or x.shape[0] != theta.shape[0]:
        raise ValueError(
            f"the simulator must be batched, simulator(generator, theta [N, d]) -> x [N, ...]: "
            f"theta {tuple(theta.shape)} gave x {tuple(x.shape)}")
    return x


def abc_log_weights(d, eps: Optional[float] = None, eps_quantile: float = 0.02,
                    kernel: str = "gaussian", log_correction=None):
    """ABC-SIR log-weights of proposals at simulated distances ``d [P]``.

    ε is ``eps`` or the ``eps_quantile`` of ``d`` (at least 1e-8); the kernel
    is "gaussian" (−½ (d/ε)²) or "hard" (0 where d ≤ ε, else −inf), plus
    ``log_correction`` (importance correction) where given. Non-finite weights
    become −inf; if every weight is −inf they all become 0 (uniform over the
    proposals). Returns (logw, eps, ess, all_dead), eps / ess / all_dead as
    0-dim tensors."""
    if kernel not in ("gaussian", "hard"):
        raise ValueError("kernel must be 'gaussian' or 'hard'")
    eps_val = torch.quantile(d, eps_quantile) if eps is None else torch.as_tensor(
        eps, dtype=d.dtype, device=d.device)
    eps_val = eps_val.clamp_min(1e-8)
    if kernel == "gaussian":
        logw = -0.5 * (d / eps_val) ** 2
    else:
        logw = torch.where(d <= eps_val, 0.0, -math.inf)
    if log_correction is not None:
        logw = logw + log_correction
    logw = torch.where(torch.isfinite(logw), logw, -math.inf)
    all_dead = torch.isinf(logw).all()
    logw = torch.where(all_dead, torch.zeros_like(logw), logw)
    w = torch.softmax(logw, dim=0)
    return logw, eps_val, 1.0 / (w**2).sum(), all_dead


def _interleave(parts):
    """Per-order draws ``[(theta [..., P, dθ], lp [..., P]), ...]`` interleaved
    row by row into ``[..., P·K, dθ]``, so that a trimmed tail stays balanced
    across the K orders."""
    theta = torch.stack([t for t, _ in parts], dim=-2).flatten(-3, -2)
    lp = torch.stack([lp for _, lp in parts], dim=-1).flatten(-2)
    return theta, lp


class NPEPFN:
    """Training-free neural posterior estimator over a pretrained TabICA.

    Simulations are the in-context table. ``sample`` filters them per
    observation, draws posterior samples autoregressively and rejects those
    outside the prior's support; ``sample_batched`` shares one random context
    across observations; ``log_prob`` scores θ (autoregressively or through
    the ratio classifier); ``sample_refined`` resamples draws by how well
    their simulations match the observation. ``num_ensembles`` mixes
    context-subset members, ``num_order_ensembles`` factorization orders;
    ``target_transform`` / ``feature_transform`` "quantile" add normal-score
    maps. Runs on ``device`` (CUDA unless the caller passes ``device="cpu"``),
    or on the device of ``model``.
    """

    def __init__(
        self,
        prior: Optional[Distribution] = None,
        model: Optional[TabICAModel] = None,
        filter_type: Union[str, Callable] = "standardized_euclidean_filtering",
        filter_context_size: int = 2048,
        embedding_net: Optional[Callable] = None,
        log_prob_mode: str = "autoregressive",
        qry_chunk: int = 1024,
        ratio_context_size: int = 512,
        num_ratio_fits: int = 1,
        seed: int = 0,
        show_progress_bars: bool = False,
        x_shape=None,
        num_ensembles: int = 1,
        num_order_ensembles: int = 1,
        target_transform: str = "zscore",
        feature_transform: str = "none",
        device=None,
    ):
        if target_transform not in ("zscore", "quantile"):
            raise ValueError(f"unknown target_transform {target_transform!r}")
        if feature_transform not in ("none", "quantile"):
            raise ValueError(f"unknown feature_transform {feature_transform!r}")
        if num_ensembles > 1 and num_order_ensembles > 1:
            raise ValueError("num_ensembles and num_order_ensembles cannot both exceed 1")
        self.device = model.device if model is not None else resolve_device(device)
        self.model = model if model is not None else ckpt_mod.load_default(self.device)
        self.prior = prior
        self.embedding_net = embedding_net
        self.x_shape = tuple(x_shape) if x_shape is not None else None
        self.filter_fn = filters_mod.get_filtering_method(filter_type)
        self.filter_context_size = int(filter_context_size)
        self.log_prob_mode = log_prob_mode
        self.qry_chunk = int(qry_chunk)
        self.show_progress_bars = show_progress_bars
        self.num_ensembles = int(num_ensembles)
        self.num_order_ensembles = int(num_order_ensembles)
        self.feature_transform = feature_transform
        self.target_transform = target_transform + (
            "+featq" if feature_transform == "quantile" else "")
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._theta_train = None
        self._x_train = None
        self._ctx_version = 0
        self.ratio_context_size = int(ratio_context_size)
        self.num_ratio_fits = int(num_ratio_fits)
        self._ratio = self._new_ratio()

    def _new_ratio(self):
        return DensityRatioEstimator(self.model, context_size=self.ratio_context_size,
                                     num_fits=self.num_ratio_fits)

    # -- state ---------------------------------------------------------------

    def __getstate__(self):
        """A ``torch.Generator`` does not pickle: keep its state instead. The
        fitted ratio classifier is dropped and rebuilt empty."""
        state = self.__dict__.copy()
        state["_generator"] = self._generator.get_state()
        state["_ratio"] = None
        return state

    def __setstate__(self, state):
        gen_state = state.pop("_generator")
        self.__dict__.update(state)
        self._generator = torch.Generator(device=self.device)
        self._generator.set_state(gen_state)
        self._ratio = self._new_ratio()

    # -- data ----------------------------------------------------------------

    def append_simulations(self, theta, x) -> "NPEPFN":
        """Store (θ, x) simulations as the context pool (replaces earlier data).
        With an embedding net the context holds the embedded x; with
        ``x_shape`` the net gets the rows in that shape."""
        theta = self._validate(self._tensor(theta), "theta")
        x = self._validate(self._tensor(x), "x")
        if theta.shape[0] != x.shape[0]:
            raise ValueError("theta and x must have the same number of rows")
        if self.embedding_net is not None:
            x = self._prep_obs(x).reshape(theta.shape[0], -1)
        self._theta_train, self._x_train = theta, x
        self._ctx_version += 1
        return self

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @staticmethod
    def _validate(arr, name: str):
        if arr.dim() == 1:
            arr = arr[:, None]
        if arr.dim() != 2:
            raise ValueError(f"{name} must be 2D [num_sims, dim], got {tuple(arr.shape)}")
        return arr

    def _prep_obs(self, x):
        """An observation (or rows of them) through the embedding net; with
        ``x_shape`` the net gets them in that shape, and one row comes back
        as ``[d]``."""
        x = self._tensor(x)
        if self.embedding_net is None:
            return x
        if self.x_shape is not None:
            x = self._tensor(self.embedding_net(x.reshape(-1, *self.x_shape)))
            return x[0] if x.shape[0] == 1 else x
        if x.dim() == 1:
            return self._tensor(self.embedding_net(x[None]))[0]
        return self._tensor(self.embedding_net(x))

    def _one_obs(self, x):
        """One observation ``[dx]``, embedded (a ``[1, dx]`` row is accepted)."""
        x = self._prep_obs(x)
        if x.dim() == 2:
            if x.shape[0] != 1:
                raise ValueError("this call takes a single observation; use the batched "
                                 "calls for several")
            x = x[0]
        return x

    def _obs_rows(self, x):
        """Observations ``[M, dx]``, embedded (one ``[dx]`` is accepted)."""
        x = self._tensor(x)
        x = self._prep_obs(x[None] if x.dim() == 1 else x)
        return x[None] if x.dim() == 1 else x

    @staticmethod
    def _num_from_shape(num) -> int:
        """An int, or a torch-style sample_shape tuple."""
        return math.prod(int(d) for d in num) if isinstance(num, (tuple, list)) else int(num)

    @property
    def num_simulations(self) -> int:
        return 0 if self._theta_train is None else int(self._theta_train.shape[0])

    @property
    def _effective_context_size(self) -> int:
        """filter_context_size clamped to the dataset size rounded up to 256."""
        return min(self.filter_context_size, _round_up(self._theta_train.shape[0], 256))

    def _check_data(self):
        if self._theta_train is None:
            raise RuntimeError("call append_simulations first")

    def get_context(self, x_o, generator: Optional[torch.Generator] = None):
        """The filtered, padded context for one observation."""
        self._check_data()
        return self.filter_fn(
            x_o, self._theta_train, self._x_train, self._effective_context_size,
            generator=generator or self._generator,
        )

    def _shared_context(self, generator):
        """The random context that the batched calls share across observations."""
        self._check_data()
        return filters_mod.random_filtering(
            None, self._theta_train, self._x_train, self._effective_context_size,
            generator=generator)

    # -- ensemble modes ------------------------------------------------------

    def _dim_orders(self, dth: int):
        """The factorization orders of order-ensembling: the identity first,
        then permutations from a CPU ``torch.Generator`` seeded 714, fixed
        across calls so that sampling and scoring mix the same set. (The JAX
        package draws them from ``PRNGKey(714)``, which torch cannot
        reproduce: ROADMAP Queue 3.)"""
        g = torch.Generator().manual_seed(714)
        return [torch.arange(dth)] + [torch.randperm(dth, generator=g)
                                      for _ in range(1, self.num_order_ensembles)]

    def _orders(self, dth: int):
        return self._dim_orders(dth) if self.num_order_ensembles > 1 else [None]

    def _sample_rows(self, generator, ctx, x_qry, dim_order=None, qry_chunk=None):
        """θ and log q for query rows ``[*C, Q, dx]`` against context ``ctx``
        (leading ``C`` too), through the context-subset ensemble or the
        plain sampler along ``dim_order``."""
        qry_chunk = qry_chunk or self.qry_chunk
        if self.num_ensembles > 1:
            members = split_context_ensemble(*ctx, self.num_ensembles)
            return autoregressive_sample_ensemble(self.model, *members, x_qry, generator,
                                                  qry_chunk, self.target_transform)
        return autoregressive_sample(self.model, *ctx, x_qry, generator, qry_chunk,
                                     self.target_transform, dim_order=dim_order)

    def _score_rows(self, ctx, x_qry, theta_eval):
        """log q(θ | x) under the configured mixture: members (logsumexp in
        the ensemble scorer) or factorization orders (logsumexp here)."""
        if self.num_ensembles > 1:
            members = split_context_ensemble(*ctx, self.num_ensembles)
            return autoregressive_log_prob_ensemble(self.model, *members, x_qry, theta_eval,
                                                    self.qry_chunk, self.target_transform)
        lps = [autoregressive_log_prob(self.model, *ctx, x_qry, theta_eval, self.qry_chunk,
                                       self.target_transform, dim_order=od)
               for od in self._orders(theta_eval.shape[-1])]
        if len(lps) == 1:
            return lps[0]
        return torch.logsumexp(torch.stack(lps), dim=0) - math.log(len(lps))

    # -- sampling ------------------------------------------------------------

    def _raw_sample(self, generator, x_o, num: int, theta_ctx, x_ctx, ctx_mask):
        """One proposal draw of ``num`` samples for one observation. With
        order-ensembling each order draws its padded share and the shares
        are interleaved; each row's log-prob is under its own order."""
        ctx = (theta_ctx, x_ctx, ctx_mask)
        orders = self._orders(theta_ctx.shape[-1])
        per = _round_up(-(-num // len(orders)), self.qry_chunk)
        x_qry = x_o.broadcast_to((per, x_o.shape[-1]))
        theta, lp = _interleave([self._sample_rows(generator, ctx, x_qry, od) for od in orders])
        return theta[:num], lp[:num]

    def _draw_group(self, generator, x, n_over: int, ctx):
        """``n_over`` proposals for EACH of the m observations ``x [m, dx]``
        in one pass against the shared context: ``(theta [m, n_over, dθ],
        lp [m, n_over])``. The rows of all observations are one query axis,
        padded to ``qry_chunk``. With order-ensembling the pool interleaves
        the K orders (``n_over`` is a multiple of K)."""
        m, dx = x.shape
        dth = ctx[0].shape[-1]
        orders = self._orders(dth)
        per = n_over // len(orders)
        x_qry = F.pad(x.repeat_interleave(per, dim=0),
                      (0, 0, 0, _round_up(m * per, self.qry_chunk) - m * per))
        parts = []
        for od in orders:
            t, lp = self._sample_rows(generator, ctx, x_qry, od)
            parts.append((t[:m * per].reshape(m, per, dth), lp[:m * per].reshape(m, per)))
        return _interleave(parts)

    def _within_support(self, theta):
        if self.prior is None:
            return torch.ones(theta.shape[:-1], dtype=torch.bool, device=theta.device)
        return self.prior.support_check(theta)

    @torch.no_grad()
    def sample(
        self,
        num_samples,
        x,
        generator: Optional[torch.Generator] = None,
        max_iters: int = 10,
        show_progress: Optional[bool] = None,
        return_acceptance_rate: bool = False,
        return_log_probs: bool = False,
        with_log_prob: bool = False,
        max_sampling_batch_size: int = 10_000,
    ):
        """Posterior samples ``[num_samples, dθ]`` for ONE observation, with
        rejection against the prior support (``rejection.accept_reject_sample``,
        one device read per round, and its escape hatch). The proposal batch
        is ``min(num_samples, max_sampling_batch_size)`` rounded up to a
        multiple of ``qry_chunk``. With ``num_order_ensembles > 1`` the
        returned log-probs are each row's density under its own order, not
        the mixture ``log_prob`` scores."""
        num_samples = self._num_from_shape(num_samples)
        if max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        show_progress = self.show_progress_bars if show_progress is None else show_progress
        x = self._one_obs(x)
        generator = generator or self._generator
        ctx = self.get_context(x, generator)
        batch = _round_up(min(num_samples, max_sampling_batch_size), self.qry_chunk)
        theta, lp, acceptance = rejection.accept_reject_sample(
            generator,
            proposal_fn=lambda g, n: self._raw_sample(g, x, n, *ctx),
            accept_reject_fn=self._within_support,
            num_samples=num_samples,
            batch_size=batch,
            max_iters=max_iters,
            show_progress=show_progress,
        )
        out = [theta]
        if return_log_probs or with_log_prob:
            out.append(lp)
        if return_acceptance_rate:
            out.append(acceptance)
        return out[0] if len(out) == 1 else tuple(out)

    @torch.no_grad()
    def sample_refined(
        self,
        num_samples,
        x,
        simulator,
        generator: Optional[torch.Generator] = None,
        num_proposals: Optional[int] = None,
        eps: Optional[float] = None,
        eps_quantile: float = 0.02,
        kernel: str = "gaussian",
        importance_correct: bool = False,
        max_iters: int = 10,
        max_sampling_batch_size: int = 10_000,
    ):
        """Simulator-in-the-loop (ABC-SIR) refinement of posterior samples.

        Draws ``num_proposals`` (default max(8 · num_samples, 8192)) proposals
        from ``sample``, simulates each once with the batched ``simulator``,
        weights them by the ABC kernel of their z-scored distance to the
        observation (``abc_log_weights``; with ``importance_correct`` also by
        prior / AR density) and resamples ``num_samples`` rows. Costs
        ``num_proposals`` simulations. Diagnostics (ess, eps, num_proposals,
        min_distance, fallback_uniform) land in ``last_refine_diagnostics``."""
        num_samples = self._num_from_shape(num_samples)
        if kernel not in ("gaussian", "hard"):
            raise ValueError("kernel must be 'gaussian' or 'hard'")
        if self._x_train is None:
            raise RuntimeError("call append_simulations before sample_refined")
        if num_proposals is None:
            num_proposals = max(8 * num_samples, 8192)
        generator = generator or self._generator
        proposals = self.sample(num_proposals, x, generator=generator, max_iters=max_iters,
                                max_sampling_batch_size=max_sampling_batch_size)
        x_o = self._one_obs(x)
        x_sim = run_simulator(simulator, generator, proposals)
        if self.embedding_net is not None:
            x_sim = x_sim.reshape((-1,) + self.x_shape) if self.x_shape is not None \
                else x_sim.reshape(num_proposals, -1)
            x_sim = self._tensor(self.embedding_net(x_sim))
        x_sim = x_sim.reshape(num_proposals, -1)
        sd_x = torch.std(self._x_train, dim=0, correction=0).clamp_min(1e-6)
        d = torch.linalg.vector_norm((x_sim - x_o) / sd_x, dim=-1)
        correction = None
        if importance_correct:
            logq = self.log_prob(proposals, x, generator=generator, mode="autoregressive",
                                 max_sampling_batch_size=max_sampling_batch_size)
            correction = self.prior.log_prob(proposals) - logq
        logw, eps_val, ess, all_dead = abc_log_weights(d, eps, eps_quantile, kernel, correction)
        idx = torch.multinomial(torch.softmax(logw, dim=0), num_samples, replacement=True,
                                generator=generator)
        self.last_refine_diagnostics = {
            "ess": float(ess),
            "eps": float(eps_val),
            "num_proposals": int(num_proposals),
            "min_distance": float(d.min()),
            "fallback_uniform": bool(all_dead),
        }
        return proposals[idx]

    def _batched_rejection(self, generator, x, ctx, num_samples: int, n_over: int,
                           max_iters: int):
        """The JAX ``_fused_batched_rejection`` on the device, one host read
        per round: each round draws ``n_over`` proposals per observation,
        stable-partitions the accepted rows to the front and writes them at
        per-observation fill offsets (a ``scatter``). A still-short
        observation then takes its final sorted batch rotated past its
        accepted count (rejected rows first), tiled to the deficit.
        Returns (theta [m, num, dθ], lp [m, num], topped_up [m], accepted,
        drawn, rounds)."""
        m = x.shape[0]
        dth = ctx[0].shape[-1]
        dev = x.device
        slack = num_samples + max(n_over, num_samples)
        reps = -(-num_samples // n_over)
        acc_s = torch.zeros((m, slack, dth), device=dev)
        acc_lp = torch.zeros((m, slack), device=dev)
        filled = torch.zeros((m,), dtype=torch.int64, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        cols = torch.arange(n_over, device=dev)

        def write(s, lp, offset):
            idx = offset[:, None] + torch.arange(s.shape[1], device=dev)
            acc_s.scatter_(1, idx[..., None].expand(-1, -1, dth), s)
            acc_lp.scatter_(1, idx, lp)

        rounds = 0
        while True:
            s, lp = self._draw_group(generator, x, n_over, ctx)
            mask = self._within_support(s.reshape(-1, dth)).reshape(m, n_over)
            order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
            last_s = s.gather(1, order[..., None].expand(-1, -1, dth))
            last_lp = lp.gather(1, order)
            last_na = mask.sum(dim=1)
            write(last_s, last_lp, filled)
            filled = filled + torch.minimum(last_na, num_samples - filled)
            accepted = accepted + last_na.sum()
            rounds += 1
            if rounds >= max_iters or bool((filled >= num_samples).all()):  # one read
                break
        roll = (cols[None, :] + last_na[:, None]) % n_over
        fill_s = last_s.gather(1, roll[..., None].expand(-1, -1, dth)).repeat(1, reps, 1)
        fill_lp = last_lp.gather(1, roll).repeat(1, reps)
        write(fill_s[:, :num_samples], fill_lp[:, :num_samples], filled)
        topped_up = (num_samples - filled).clamp_min(0)
        return (acc_s[:, :num_samples], acc_lp[:, :num_samples], topped_up, accepted,
                rounds * m * n_over, rounds)

    @torch.no_grad()
    def sample_batched(
        self,
        num_samples,
        x,
        generator: Optional[torch.Generator] = None,
        max_iters: int = 10,
        oversample: float = 1.5,
        return_log_probs: bool = False,
        with_log_prob: bool = False,
        obs_chunk: int = 128,
    ):
        """Samples for M observations at once, ``[M, num_samples, dθ]``, from
        one random context shared by all of them, ``obs_chunk`` observations
        per pass. With a prior each observation draws ``oversample`` x
        ``num_samples`` proposals per round; a still-short observation is
        topped up from its final round's unused rows.
        ``last_diagnostics``: ``topped_up`` per observation (CPU tensor),
        ``acceptance_rate`` and ``rounds`` (summed over chunks)."""
        num_samples = self._num_from_shape(num_samples)
        if max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        x = self._obs_rows(x)
        generator = generator or self._generator
        ctx = self._shared_context(generator)
        with_prior = self.prior is not None
        n_over = math.ceil(num_samples * (max(oversample, 1.0) if with_prior else 1.0))
        n_over = _round_up(n_over, self.num_order_ensembles)
        iters = max_iters if with_prior else 1
        thetas, lps, topups, accepted, drawn, rounds = [], [], [], 0, 0, 0
        for chunk in x.split(obs_chunk):
            t, lp, tu, na, nd, it = self._batched_rejection(generator, chunk, ctx, num_samples,
                                                            n_over, iters)
            thetas.append(t)
            lps.append(lp)
            topups.append(tu)
            accepted, drawn, rounds = accepted + na, drawn + nd, rounds + it
        self.last_diagnostics = {
            "topped_up": torch.cat(topups).cpu(),
            "acceptance_rate": int(accepted) / max(drawn, 1),
            "rounds": rounds,
        }
        theta = torch.cat(thetas)
        return (theta, torch.cat(lps)) if return_log_probs or with_log_prob else theta

    @torch.no_grad()
    def sample_batched_filtered(
        self,
        num_samples,
        x,
        generator: Optional[torch.Generator] = None,
        obs_chunk: int = 8,
        return_log_probs: bool = False,
    ):
        """Samples for M observations, each from its OWN filtered context,
        ``[M, num_samples, dθ]``. The contexts of ``obs_chunk`` observations
        are stacked to ``[M, N, ...]`` and drawn in one batched pass (one
        kernel launch per layer and query chunk for all of them). No prior
        rejection here; apply the prior's support check downstream."""
        num_samples = self._num_from_shape(num_samples)
        x = self._obs_rows(x)
        generator = generator or self._generator
        self._check_data()
        orders = self._orders(self._theta_train.shape[1])
        per_raw = -(-num_samples // len(orders))
        chunk = min(self.qry_chunk, _round_up(per_raw, 256))
        s_pad = _round_up(per_raw, chunk)
        outs, lps = [], []
        for xs in x.split(obs_chunk):
            ctxs = [self.get_context(x_o, generator) for x_o in xs]
            ctx = tuple(torch.stack(c) for c in zip(*ctxs))
            x_qry = xs[:, None, :].expand(-1, s_pad, -1)
            theta, lp = _interleave([self._sample_rows(generator, ctx, x_qry, od, chunk)
                                     for od in orders])
            outs.append(theta[:, :num_samples])
            lps.append(lp[:, :num_samples])
        theta = torch.cat(outs)
        return (theta, torch.cat(lps)) if return_log_probs else theta

    # -- densities ------------------------------------------------------------

    def _score_chunked(self, ctx, x_rows, theta_rows, max_sampling_batch_size: int):
        """Score rows in chunks of ``max_sampling_batch_size`` rounded up to
        ``qry_chunk``, each padded to a chunk multiple."""
        cap = _round_up(max_sampling_batch_size, self.qry_chunk)
        out = []
        for xr, tr in zip(x_rows.split(cap), theta_rows.split(cap)):
            pad = _round_up(tr.shape[0], self.qry_chunk) - tr.shape[0]
            lp = self._score_rows(ctx, F.pad(xr, (0, 0, 0, pad)), F.pad(tr, (0, 0, 0, pad)))
            out.append(lp[:tr.shape[0]])
        return torch.cat(out)

    @torch.no_grad()
    def log_prob(self, theta, x, generator: Optional[torch.Generator] = None,
                 mode: Optional[str] = None, num_ratio_samples: int = 4096,
                 padding: float = 0.1, max_sampling_batch_size: int = 10_000):
        """log q(θ | x) ``[n]`` for one observation. "autoregressive": on the
        observation's filtered context (with ensembles, the mixture density).
        "ratio_based": ``num_ratio_samples`` posterior draws against uniform
        draws from their box padded by ``padding``, classified in context
        (``DensityRatioEstimator``); the fit is reused while x, the
        simulations, the sample count and the padding stay the same."""
        mode = mode or self.log_prob_mode
        if mode not in ("autoregressive", "ratio_based"):
            raise ValueError(f"unknown log_prob mode {mode!r}")
        theta = self._validate(self._tensor(theta), "theta")
        x_raw = x  # sample() embeds the observation itself
        x = self._one_obs(x)
        generator = generator or self._generator
        if mode == "ratio_based":
            self._check_data()
            if self._ratio.refit_necessary(x, self._ctx_version, num_ratio_samples, padding):
                post = self.sample(num_ratio_samples, x_raw, generator=generator)
                self._ratio.model = self.model
                self._ratio.fit(generator, post, x, self._ctx_version, padding)
            return self._ratio.ratio_log_probs(theta, chunk_size=max_sampling_batch_size)
        ctx = self.get_context(x, generator)
        x_rows = x.broadcast_to((theta.shape[0], x.shape[-1]))
        return self._score_chunked(ctx, x_rows, theta, max_sampling_batch_size)

    @torch.no_grad()
    def log_prob_batched(self, theta, x, generator: Optional[torch.Generator] = None,
                         max_sampling_batch_size: int = 10_000):
        """log q(θ | x) for M observations: θ ``[M, S, dθ]``, x ``[M, dx]`` →
        ``[M, S]``, on one random context shared by all of them. The
        embedding net gets x as given, without ``x_shape`` (as in the JAX
        package)."""
        theta = self._tensor(theta)
        x = self._tensor(x)
        if self.embedding_net is not None:
            x = self._tensor(self.embedding_net(x))
        x = x[None] if x.dim() == 1 else x
        m, s, dth = theta.shape
        ctx = self._shared_context(generator or self._generator)
        lp = self._score_chunked(ctx, x.repeat_interleave(s, dim=0), theta.reshape(m * s, dth),
                                 max_sampling_batch_size)
        return lp.reshape(m, s)
