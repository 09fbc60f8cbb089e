"""Full-support piecewise-constant ("bar") output distribution.

Counterpart of ``npe_pfn_tpu/models/bar_distribution.py``. ``B`` buckets are
delimited by ``B + 1`` borders at equal-mass quantiles of a standard normal
over ``[-range, range]``; the two edge buckets carry half-normal tails to
±inf. Everything is a function of ``(borders, logits, ...)`` on tensors.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def make_borders(num_bars: int, bar_range: float = 6.0, device=None) -> torch.Tensor:
    """Equal-normal-mass borders, shape ``[num_bars + 1]``, in float32.

    The linspace is written as ``lo * (1 - t) + hi * t`` (the JAX package's
    formula) so that the float32 borders agree with it to the ulp.
    """
    f32 = torch.float32
    lo = torch.special.ndtr(torch.tensor(-bar_range, dtype=f32))
    hi = torch.special.ndtr(torch.tensor(bar_range, dtype=f32))
    t = torch.arange(num_bars, dtype=f32) / torch.tensor(num_bars, dtype=f32)
    probs = torch.cat([lo * (1 - t) + hi * t, hi[None]])
    borders = torch.special.ndtri(probs)
    borders[0] = -bar_range
    borders[-1] = bar_range
    return borders.to(device) if device is not None else borders


def _widths(borders):
    return borders[1:] - borders[:-1]


def _halfnorm_logpdf(dist, scale):
    """log pdf of |N(0, scale^2)| at dist >= 0."""
    return _HALF_LOG_2_OVER_PI - torch.log(scale) - 0.5 * (dist / scale) ** 2


def _bucket(borders, y):
    num_bars = borders.shape[0] - 1
    k = torch.searchsorted(borders[1:-1].contiguous(), y.contiguous(), side="right")
    return k.clamp(0, num_bars - 1)


def _take_last(t, k):
    return torch.gather(t, -1, k[..., None])[..., 0]


def _broadcast(logits, y):
    batch = torch.broadcast_shapes(logits.shape[:-1], y.shape)
    return batch, y.broadcast_to(batch)


def log_prob(borders, logits, y):
    """log p(y): logits ``[..., B]``, y broadcastable to ``logits[..., 0]``."""
    num_bars = borders.shape[0] - 1
    widths = _widths(borders)
    y = torch.as_tensor(y, dtype=logits.dtype, device=logits.device)
    batch, y = _broadcast(logits, y)
    log_bucket = torch.log_softmax(logits, dim=-1).broadcast_to(batch + (num_bars,))
    k = _bucket(borders, y)
    log_pk = _take_last(log_bucket, k)
    interior = -torch.log(widths[k])
    lo_tail = _halfnorm_logpdf(torch.clamp(borders[1] - y, min=0.0), widths[0])
    hi_tail = _halfnorm_logpdf(torch.clamp(y - borders[-2], min=0.0), widths[-1])
    cond = torch.where(k == 0, lo_tail, torch.where(k == num_bars - 1, hi_tail, interior))
    return log_pk + cond


def nll(borders, logits, y):
    """Negative log likelihood."""
    return -log_prob(borders, logits, y)


def sample(generator: torch.Generator, borders, logits):
    """One draw per logit row (``[..., B] -> [...]``).

    The bucket is drawn by Gumbel-max (as ``jax.random.categorical`` does),
    the position inside an interior bucket is uniform and the edge buckets
    draw half-normal tails. The random bits come from ``generator`` and do
    not match JAX's; the distribution does.
    """
    num_bars = logits.shape[-1]
    widths = _widths(borders)
    dev, f32 = logits.device, torch.float32
    u_gumbel = torch.rand(logits.shape, generator=generator, device=dev, dtype=f32)
    gumbel = -torch.log(-torch.log(u_gumbel.clamp_min(torch.finfo(f32).tiny)))
    k = torch.argmax(logits.float() + gumbel, dim=-1)
    u = torch.rand(k.shape, generator=generator, device=dev, dtype=f32)
    tail = torch.randn(k.shape, generator=generator, device=dev, dtype=f32).abs()
    interior = borders[k] + u * widths[k]
    lo = borders[1] - tail * widths[0]
    hi = borders[-2] + tail * widths[-1]
    return torch.where(k == 0, lo, torch.where(k == num_bars - 1, hi, interior))


def mean(borders, logits):
    """E[y] under the bar distribution."""
    widths = _widths(borders)
    mids = (borders[:-1] + borders[1:]) / 2.0
    mids[0] = borders[1] - widths[0] * _SQRT_2_OVER_PI
    mids[-1] = borders[-2] + widths[-1] * _SQRT_2_OVER_PI
    return torch.sum(torch.softmax(logits, dim=-1) * mids, dim=-1)


def cdf(borders, logits, y):
    """P(Y <= y). Interior buckets are uniform; tails are half-normal."""
    num_bars = borders.shape[0] - 1
    widths = _widths(borders)
    y = torch.as_tensor(y, dtype=logits.dtype, device=logits.device)
    batch, y = _broadcast(logits, y)
    probs = torch.softmax(logits, dim=-1).broadcast_to(batch + (num_bars,))
    cum = torch.cumsum(probs, dim=-1)
    k = _bucket(borders, y)
    below = torch.where(k > 0, _take_last(cum, (k - 1).clamp_min(0)), 0.0)
    pk = _take_last(probs, k)
    frac_interior = ((y - borders[k]) / widths[k]).clamp(0.0, 1.0)
    z_lo = torch.clamp(borders[1] - y, min=0.0) / widths[0]
    frac_lo = 2.0 * (1.0 - torch.special.ndtr(z_lo))
    z_hi = torch.clamp(y - borders[-2], min=0.0) / widths[-1]
    frac_hi = 2.0 * torch.special.ndtr(z_hi) - 1.0
    frac = torch.where(k == 0, frac_lo, torch.where(k == num_bars - 1, frac_hi, frac_interior))
    return below + pk * frac


def icdf(borders, logits, q):
    """Quantile function."""
    num_bars = borders.shape[0] - 1
    widths = _widths(borders)
    q = torch.as_tensor(q, dtype=logits.dtype, device=logits.device)
    batch, q = _broadcast(logits, q)
    probs = torch.softmax(logits, dim=-1).broadcast_to(batch + (num_bars,))
    cum = torch.cumsum(probs, dim=-1)
    k = (cum < q[..., None]).sum(dim=-1).clamp(0, num_bars - 1)
    below = torch.where(k > 0, _take_last(cum, (k - 1).clamp_min(0)), 0.0)
    pk = _take_last(probs, k)
    frac = ((q - below) / pk.clamp_min(1e-12)).clamp(0.0, 1.0)
    interior = borders[k] + frac * widths[k]
    z_lo = torch.special.ndtri((1.0 - frac / 2.0).clamp(1e-7, 1 - 1e-7))
    lo = borders[1] - z_lo * widths[0]
    z_hi = torch.special.ndtri(((frac + 1.0) / 2.0).clamp(1e-7, 1 - 1e-7))
    hi = borders[-2] + z_hi * widths[-1]
    return torch.where(k == 0, lo, torch.where(k == num_bars - 1, hi, interior))
