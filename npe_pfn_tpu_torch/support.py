"""Posterior-support estimation: truncated proposals for sequential NPE.

Counterpart of ``npe_pfn_tpu/support.py``. Two truncation modes:

- ``rejection``: the posterior log-prob threshold is the
  ``allowed_false_negatives`` quantile over posterior samples; sampling draws
  prior candidates inside the samples' bounding box (``prereject_with_bounds``)
  and keeps those above the threshold, padding with prior samples when the
  round budget runs out;
- ``sir``: sampling-importance-resampling of posterior draws with
  truncated-prior / posterior weights, one categorical draw per group, a
  uniform fallback for groups with no candidate inside the truncation, and
  the ESS.

Accept/reject masks stay on the device: each round partitions its accepted
rows to the front and writes them at the fill offset, and reads one count
back to the host. Rejection mode's ``last_diagnostics`` also carry the
number of ``rounds`` (the JAX package's do not).
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import torch

from .distributions import BoxUniform, Distribution, intersect_boxes

logger = logging.getLogger(__name__)


class _Filler:
    """Accepted rows gathered on the device: ``add`` writes a candidate batch
    with its accepted rows first at the fill offset and returns the batch's
    accepted count (the one host read of a round)."""

    def __init__(self, num: int):
        self.num = num
        self.filled = 0
        self.buf = None

    def add(self, cand, keep) -> int:
        if self.buf is None:  # slack for a whole batch written at offset num - 1
            self.buf = cand.new_zeros((self.num + cand.shape[0],) + cand.shape[1:])
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        self.buf[self.filled:self.filled + cand.shape[0]] = cand[order]
        n_keep = int(keep.sum())
        self.filled += min(n_keep, self.num - self.filled)
        return n_keep

    def done(self) -> bool:
        return self.filled >= self.num

    def result(self, pad=None):
        """The ``num`` rows, the unfilled tail taken from ``pad``."""
        if self.filled < self.num:
            self.buf[self.filled:self.num] = pad
        return self.buf[:self.num]


def prereject_with_bounds(
    generator: torch.Generator,
    proposal: Distribution,
    num_samples: int,
    low,
    high,
    batch_size: int = 262_144,
    max_iters: int = 32,
    return_num_drawn: bool = False,
):
    """``num_samples`` draws from ``proposal`` restricted to the box [low, high].

    A ``BoxUniform`` proposal is intersected with the box and sampled
    directly (no rejection) unless the intersection is empty. Otherwise
    rounds of ``batch_size`` candidates; if ``max_iters`` rounds fall short,
    the rest are raw proposal draws (the escape hatch). With
    ``return_num_drawn`` also returns the number of proposal draws made.
    """
    if isinstance(proposal, BoxUniform):
        inter = intersect_boxes(proposal, low, high)
        if bool((inter.high > inter.low).all()):
            s = inter.sample(generator, (num_samples,))
            return (s, num_samples) if return_num_drawn else s
    fill = _Filler(num_samples)
    n_drawn = 0
    for _ in range(max_iters):
        cand = proposal.sample(generator, (batch_size,))
        n_drawn += batch_size
        fill.add(cand, ((cand >= low) & (cand <= high)).all(dim=-1))
        if fill.done():
            break
    pad = None
    if not fill.done():
        pad = proposal.sample(generator, (num_samples - fill.filled,))
        n_drawn += num_samples - fill.filled
    s = fill.result(pad)
    return (s, n_drawn) if return_num_drawn else s


def support_threshold_and_box(samples, log_probs, allowed_false_negatives: float,
                              use_constrained_prior: bool = False,
                              constrained_prior_quantile: float = 0.0):
    """The log-prob threshold (the ``allowed_false_negatives`` quantile of the
    samples' log-probs) and the pre-rejection box: the samples' min/max padded
    by 5% of the span, or with ``use_constrained_prior`` the
    [q, 1 - q] quantile box. Returns (threshold float, low, high)."""
    threshold = float(torch.quantile(log_probs, allowed_false_negatives))
    if use_constrained_prior and constrained_prior_quantile > 0:
        q = constrained_prior_quantile
        return (threshold, torch.quantile(samples, q, dim=0),
                torch.quantile(samples, 1.0 - q, dim=0))
    lo, hi = samples.amin(dim=0), samples.amax(dim=0)
    span = (hi - lo).clamp_min(1e-12)
    return threshold, lo - 0.05 * span, hi + 0.05 * span


def sir_log_weights(post_lp, prior_lp, allowed_false_negatives: float, num_groups: int):
    """SIR weights of ``num_groups`` x m posterior draws: the truncated prior
    (prior inside the ``allowed_false_negatives`` threshold of ``post_lp``, else
    −inf) over the posterior. Returns (log_w [num_groups, m], dead groups
    [num_groups] with no finite weight, ESS fraction of all draws)."""
    thr = torch.quantile(post_lp, allowed_false_negatives)
    trunc_lp = torch.where(post_lp > thr, prior_lp, torch.full_like(prior_lp, -torch.inf))
    log_w = (trunc_lp - post_lp).reshape(num_groups, -1)
    dead = ~torch.isfinite(log_w).any(dim=-1)
    w = torch.softmax(log_w.reshape(-1), dim=0)
    return log_w, dead, 1.0 / (w**2).sum() / log_w.numel()


class PosteriorSupport(Distribution):
    """A proposal truncated to the estimated posterior support.

    The constructor draws ``num_samples_to_estimate_support`` posterior
    samples at ``x_o`` and tunes the threshold and box once; ``sample``
    dispatches on ``sampling_method``. For an estimator without ensembles the
    draws and scores go through ``serving.CachedPosterior`` (every context
    encoding computed once); under order ensembles the samples' log-probs are
    re-scored as the mixture density that ``support_check`` reads.
    """

    def __init__(
        self,
        prior: Distribution,
        posterior,  # NPEPFN
        x_o,
        generator: Optional[torch.Generator] = None,
        num_samples_to_estimate_support: int = 4096,
        allowed_false_negatives: float = 0.0001,
        use_constrained_prior: bool = False,
        constrained_prior_quanitle: float = 0.0,  # (sic) the reference's spelling
        sampling_method: str = "rejection",
        oversample_sir: int = 32,
        max_iters: int = 32,
        batch_size: int = 16_384,
    ):
        self.prior = prior
        self.posterior = posterior
        self.x_o = posterior._tensor(x_o)
        self.sampling_method = sampling_method
        self.oversample_sir = oversample_sir
        self.max_iters = max_iters
        self.batch_size = batch_size
        self.allowed_false_negatives = allowed_false_negatives
        self.use_constrained_prior = use_constrained_prior
        self.constrained_prior_quantile = constrained_prior_quanitle
        self._generator = generator if generator is not None else torch.Generator(
            posterior.device).manual_seed(0)
        self._cached = None
        ensembled = (getattr(posterior, "num_ensembles", 1) > 1
                     or getattr(posterior, "num_order_ensembles", 1) > 1)
        if not ensembled and hasattr(posterior, "model") and hasattr(posterior, "get_context"):
            from .serving import CachedPosterior

            self._cached = CachedPosterior(posterior, self.x_o, generator=self._generator)
        samples, log_probs = self._draw(self._generator, num_samples_to_estimate_support)
        self._fit(samples, log_probs)
        self.last_diagnostics: dict = {}

    def _fit(self, samples, log_probs):
        """Threshold and box from posterior ``samples`` and their log-probs."""
        self._posterior_samples = samples
        self.log_prob_threshold, self._box_low, self._box_high = support_threshold_and_box(
            samples, log_probs, self.allowed_false_negatives, self.use_constrained_prior,
            self.constrained_prior_quantile)

    def _draw(self, generator, n: int):
        """n posterior draws and the density ``support_check`` reads for them."""
        if self._cached is not None:
            samples, lp = self._cached.sample(n, generator=generator, return_log_probs=True)
        else:
            samples, lp = self.posterior.sample(n, self.x_o, generator=generator,
                                                return_log_probs=True)
        if getattr(self.posterior, "num_order_ensembles", 1) > 1:
            # sample() reports each row's density under its own order;
            # log_prob reads the mixture over orders.
            lp = self._posterior_log_prob(samples)
        return samples, lp

    @property
    def event_dim(self) -> int:
        return self.prior.event_dim

    # -- Distribution protocol -------------------------------------------------

    def _posterior_log_prob(self, theta):
        if self._cached is not None:
            return self._cached.log_prob(theta)
        return self.posterior.log_prob(theta, self.x_o, mode="autoregressive")

    def log_prob(self, theta):
        """Unnormalized truncated prior: the prior's density where the
        posterior log-prob exceeds the threshold, −inf elsewhere."""
        inside = self._posterior_log_prob(theta) > self.log_prob_threshold
        prior_lp = self.prior.log_prob(theta)
        return torch.where(inside, prior_lp, torch.full_like(prior_lp, -torch.inf))

    def support_check(self, theta):
        return (self._posterior_log_prob(theta) > self.log_prob_threshold) \
            & self.prior.support_check(theta)

    def sample(self, generator_or_shape=None, shape: Tuple[int, ...] = (),
               return_acceptance_rate: bool = False):
        """``sample((n,))`` or ``sample(generator, (n,))``: ``[*shape, d]``
        draws (and the acceptance rate, or the ESS fraction in SIR mode)."""
        if isinstance(generator_or_shape, (tuple, list)):
            generator, shape = None, tuple(generator_or_shape)
        else:
            generator = generator_or_shape
        n = math.prod(int(d) for d in shape)
        generator = generator or self._generator
        if self.sampling_method == "rejection":
            out, acc = self._sample_rejection(generator, n)
        elif self.sampling_method == "sir":
            out, acc = self._sample_sir(generator, n)
        else:
            raise ValueError(f"unknown sampling_method {self.sampling_method!r}")
        out = out.reshape(tuple(shape) + (self.event_dim,)) if shape else out[0]
        return (out, acc) if return_acceptance_rate else out

    # -- rejection mode --------------------------------------------------------

    def _sample_rejection(self, generator, num_samples: int):
        fill = _Filler(num_samples)
        drawn = kept_pre = kept_post = rounds = 0
        for _ in range(self.max_iters):
            rounds += 1
            cand, n_raw = prereject_with_bounds(generator, self.prior, self.batch_size,
                                                self._box_low, self._box_high,
                                                return_num_drawn=True)
            drawn += n_raw
            kept_pre += cand.shape[0]
            kept_post += fill.add(cand, self._posterior_log_prob(cand) > self.log_prob_threshold)
            if fill.done():
                break
        padded = num_samples - fill.filled
        pad = None
        if padded:
            pad = self.prior.sample(generator, (padded,))
            logger.warning("PosteriorSupport.rejection: padding %d/%d with prior samples",
                           padded, num_samples)
        acc = kept_post / max(drawn, 1)
        self.last_diagnostics = {"acceptance_rate": acc,
                                 "prereject_keep_rate": kept_pre / max(drawn, 1),
                                 "padded": padded, "rounds": rounds}
        return fill.result(pad), acc

    # -- SIR mode --------------------------------------------------------------

    def _sample_sir(self, generator, num_samples: int):
        m = self.oversample_sir
        samples, post_lp = self._draw(generator, num_samples * m)
        log_w, dead, ess = sir_log_weights(post_lp, self.prior.log_prob(samples),
                                           self.allowed_false_negatives, num_samples)
        log_w = torch.where(dead[:, None], torch.zeros_like(log_w), log_w)
        idx = torch.multinomial(torch.softmax(log_w, dim=-1), 1, generator=generator)[:, 0]
        out = samples.reshape(num_samples, m, -1)[torch.arange(num_samples, device=idx.device),
                                                  idx]
        ess, n_dead = float(ess), int(dead.sum())
        self.last_diagnostics = {"ess_fraction": ess, "dead_groups": n_dead}
        if n_dead:
            logger.warning("PosteriorSupport.sir: %d/%d groups had no in-truncation candidate; "
                           "resampled uniformly", n_dead, num_samples)
        logger.info("PosteriorSupport.sir: ESS fraction %.4f", ess)
        return out, ess
