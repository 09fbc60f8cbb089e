"""NPE-PFN posterior sampling core.

Counterpart of ``npe_pfn_tpu/estimator.py`` for the main path: the
autoregressive sampler and scorer over θ-dimensions, and ``NPEPFN`` with
context filtering and rejection against the prior support. Where the JAX
package scans (``lax.scan`` over dimensions, ``lax.map`` over query chunks,
``lax.while_loop`` over rejection rounds) the port loops in Python; the
rejection loop reads one scalar from the device per round.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from . import filters as filters_mod
from ._device import resolve_device
from .distributions import Distribution
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


def _check_transform(target_transform: str):
    if target_transform != "zscore":
        raise NotImplementedError(
            f"target_transform={target_transform!r} is not ported yet "
            "(ROADMAP Queue 1: quantile / featq preprocessing)"
        )


def _context_columns(theta_ctx, x_ctx, f: int):
    n, dth = theta_ctx.shape
    dx = x_ctx.shape[1]
    xc = theta_ctx.new_zeros((n, f))
    xc[:, :dx] = x_ctx
    xc[:, dx:dx + dth] = theta_ctx
    return xc


def _chunked_logits(model, fitted, xq, qry_chunk: int):
    return torch.cat(
        [regressor.predict_logits(model, fitted, c) for c in xq.split(qry_chunk)], dim=0
    )


@torch.no_grad()
def autoregressive_sample(
    model: TabICAModel,
    theta_ctx,  # [N, dθ]
    x_ctx,  # [N, dx]
    ctx_mask,  # [N]
    x_qry,  # [Q, dx], one observation per query row
    generator: torch.Generator,
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    dim_order=None,
    feature_width: Optional[int] = None,
):
    """Draw θ ~ q(θ | x) one dimension at a time; returns (theta [Q, dθ],
    log_prob [Q])."""
    _check_transform(target_transform)
    n, dth = theta_ctx.shape
    q, dx = x_qry.shape
    if dx + dth > model.cfg.max_features:
        raise ValueError(
            f"dx+dtheta = {dx + dth} exceeds model feature budget {model.cfg.max_features}"
        )
    if q % qry_chunk:
        raise ValueError("pad query rows to a multiple of qry_chunk")
    f = feature_width or _eff_features(model, dx, dth)
    xc = _context_columns(theta_ctx, x_ctx, f)
    order = (torch.arange(dth) if dim_order is None else torch.as_tensor(dim_order)).to(
        theta_ctx.device
    )
    prefix_masks = _order_prefix_masks(order, dx, f)
    widths = _step_widths(dx, dth, f, dim_order, feature_width)

    theta = x_qry.new_zeros((q, dth))
    lp = x_qry.new_zeros((q,))
    for i, oi in enumerate(order.tolist()):
        w = widths[i]
        fitted = regressor.fit_encode(
            model, xc[:, :w], theta_ctx[:, oi], prefix_masks[i, :w], ctx_mask
        )
        xq = x_qry.new_zeros((q, w))
        xq[:, :dx] = x_qry
        nset = min(w - dx, dth)
        if nset > 0:
            xq[:, dx:dx + nset] = theta[:, :nset]
        logits = _chunked_logits(model, fitted, xq, qry_chunk)
        th_i = regressor.sample_y(generator, model, fitted, logits)
        lp = lp + regressor.log_prob_y(model, fitted, logits, th_i)
        theta[:, oi] = th_i
    return theta, lp


@torch.no_grad()
def autoregressive_log_prob(
    model: TabICAModel,
    theta_ctx,
    x_ctx,
    ctx_mask,
    x_qry,  # [Q, dx]
    theta_eval,  # [Q, dθ]
    qry_chunk: int = 1024,
    target_transform: str = "zscore",
    dim_order=None,
    feature_width: Optional[int] = None,
):
    """Score log q(θ | x) autoregressively, ``[Q]``."""
    _check_transform(target_transform)
    n, dth = theta_ctx.shape
    q, dx = x_qry.shape
    if q % qry_chunk:
        raise ValueError("pad query rows to a multiple of qry_chunk")
    f = feature_width or _eff_features(model, dx, dth)
    xc = _context_columns(theta_ctx, x_ctx, f)
    xq_full = _context_columns(theta_eval, x_qry, f)
    order = (torch.arange(dth) if dim_order is None else torch.as_tensor(dim_order)).to(
        theta_ctx.device
    )
    prefix_masks = _order_prefix_masks(order, dx, f)
    widths = _step_widths(dx, dth, f, dim_order, feature_width)

    lp = x_qry.new_zeros((q,))
    for i, oi in enumerate(order.tolist()):
        w = widths[i]
        fitted = regressor.fit_encode(
            model, xc[:, :w], theta_ctx[:, oi], prefix_masks[i, :w], ctx_mask
        )
        logits = _chunked_logits(model, fitted, xq_full[:, :w], qry_chunk)
        lp = lp + regressor.log_prob_y(model, fitted, logits, theta_eval[:, oi])
    return lp


class NPEPFN:
    """Training-free neural posterior estimator over a pretrained TabICA.

    Simulations are the in-context table; ``sample`` filters them per
    observation, then draws posterior samples autoregressively and rejects
    those outside the prior's support. Runs on ``device`` (CUDA unless the
    caller passes ``device="cpu"``), or on the device of ``model``.
    """

    def __init__(
        self,
        prior: Optional[Distribution] = None,
        model: Optional[TabICAModel] = None,
        filter_type: Union[str, Callable] = "standardized_euclidean_filtering",
        filter_context_size: int = 2048,
        qry_chunk: int = 1024,
        seed: int = 0,
        num_ensembles: int = 1,
        num_order_ensembles: int = 1,
        target_transform: str = "zscore",
        feature_transform: str = "none",
        device=None,
    ):
        if num_ensembles > 1 or num_order_ensembles > 1:
            raise NotImplementedError(
                "context and order ensembles are not ported yet (ROADMAP Queue 1: ensembles)"
            )
        if feature_transform != "none":
            raise NotImplementedError(
                "feature_transform='quantile' is not ported yet "
                "(ROADMAP Queue 1: quantile / featq preprocessing)"
            )
        _check_transform(target_transform)
        self.device = model.device if model is not None else resolve_device(device)
        self.model = model if model is not None else ckpt_mod.load_default(self.device)
        self.prior = prior
        self.filter_fn = filters_mod.get_filtering_method(filter_type)
        self.filter_context_size = int(filter_context_size)
        self.qry_chunk = int(qry_chunk)
        self.target_transform = target_transform
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._theta_train = None
        self._x_train = None

    # -- data ----------------------------------------------------------------

    def append_simulations(self, theta, x) -> "NPEPFN":
        """Store (θ, x) simulations as the context pool (replaces earlier data)."""
        theta = self._validate(torch.as_tensor(theta, dtype=torch.float32, device=self.device),
                               "theta")
        x = self._validate(torch.as_tensor(x, dtype=torch.float32, device=self.device), "x")
        if theta.shape[0] != x.shape[0]:
            raise ValueError("theta and x must have the same number of rows")
        self._theta_train, self._x_train = theta, x
        return self

    @staticmethod
    def _validate(arr, name: str):
        if arr.dim() == 1:
            arr = arr[:, None]
        if arr.dim() != 2:
            raise ValueError(f"{name} must be 2D [num_sims, dim], got {tuple(arr.shape)}")
        return arr

    @property
    def num_simulations(self) -> int:
        return 0 if self._theta_train is None else int(self._theta_train.shape[0])

    @property
    def _effective_context_size(self) -> int:
        """filter_context_size clamped to the dataset size rounded up to 256."""
        return min(self.filter_context_size, _round_up(self._theta_train.shape[0], 256))

    def get_context(self, x_o, generator: Optional[torch.Generator] = None):
        """The filtered, padded context for one observation."""
        if self._theta_train is None:
            raise RuntimeError("call append_simulations first")
        return self.filter_fn(
            x_o, self._theta_train, self._x_train, self._effective_context_size,
            generator=generator or self._generator,
        )

    # -- sampling -------------------------------------------------------------

    def _raw_sample(self, generator, x_o, num: int, theta_ctx, x_ctx, ctx_mask):
        """One proposal draw of ``num`` samples for one observation."""
        q = _round_up(num, self.qry_chunk)
        x_qry = x_o.broadcast_to((q, x_o.shape[-1]))
        theta, lp = autoregressive_sample(
            self.model, theta_ctx, x_ctx, ctx_mask, x_qry, generator,
            self.qry_chunk, self.target_transform,
        )
        return theta[:num], lp[:num]

    def _within_support(self, theta):
        if self.prior is None:
            return torch.ones(theta.shape[:-1], dtype=torch.bool, device=theta.device)
        return self.prior.support_check(theta)

    def _rejection(self, generator, x_o, ctx, num_samples: int, batch: int, max_iters: int):
        """Draw → support mask → stable partition → accumulate, then the
        escape-hatch fill of ``_fused_rejection``: after ``max_iters`` rounds
        the shortfall is filled with the last round's unused rows."""
        theta_ctx, x_ctx, ctx_mask = ctx
        dth = theta_ctx.shape[1]
        slack = num_samples + max(batch, num_samples)
        reps = -(-num_samples // batch)
        acc_s = torch.zeros((slack, dth), device=self.device)
        acc_lp = torch.zeros((slack,), device=self.device)
        filled = tot = it = last_na = 0
        last_s = torch.zeros((batch, dth), device=self.device)
        last_lp = torch.zeros((batch,), device=self.device)
        while filled < num_samples and it < max_iters:
            s, lp = self._raw_sample(generator, x_o, batch, theta_ctx, x_ctx, ctx_mask)
            mask = self._within_support(s)
            order = torch.argsort((~mask).to(torch.int8), stable=True)
            last_s, last_lp = s[order], lp[order]
            last_na = int(mask.sum())  # the round's one host sync
            acc_s[filled:filled + batch] = last_s
            acc_lp[filled:filled + batch] = last_lp
            filled += min(last_na, num_samples - filled)
            tot += last_na
            it += 1
        roll = (torch.arange(batch, device=self.device) + last_na) % batch
        acc_s[filled:filled + num_samples] = last_s[roll].repeat(reps, 1)[:num_samples]
        acc_lp[filled:filled + num_samples] = last_lp[roll].repeat(reps)[:num_samples]
        acceptance = tot / (max(it, 1) * batch)
        return acc_s[:num_samples], acc_lp[:num_samples], acceptance

    @torch.no_grad()
    def sample(
        self,
        num_samples: int,
        x,
        generator: Optional[torch.Generator] = None,
        max_iters: int = 10,
        return_acceptance_rate: bool = False,
        return_log_probs: bool = False,
        max_sampling_batch_size: int = 10_000,
    ):
        """Posterior samples ``[num_samples, dθ]`` for ONE observation, with
        rejection against the prior support. The proposal batch is
        ``min(num_samples, max_sampling_batch_size)`` rounded up to a multiple
        of ``qry_chunk``."""
        num_samples = int(num_samples)
        if max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() == 2:
            if x.shape[0] != 1:
                raise ValueError("sample() takes a single observation")
            x = x[0]
        generator = generator or self._generator
        ctx = self.get_context(x, generator)
        batch = _round_up(min(num_samples, max_sampling_batch_size), self.qry_chunk)
        theta, lp, acceptance = self._rejection(generator, x, ctx, num_samples, batch,
                                                max_iters)
        out = [theta]
        if return_log_probs:
            out.append(lp)
        if return_acceptance_rate:
            out.append(acceptance)
        return out[0] if len(out) == 1 else tuple(out)
