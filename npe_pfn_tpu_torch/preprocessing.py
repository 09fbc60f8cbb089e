"""Quantile (normal-score) transforms of targets and features.

Counterpart of ``npe_pfn_tpu/preprocessing.py``. A ``QuantileTransform`` is a
strictly monotone piecewise-linear map θ ↔ z ≈ Φ⁻¹(F̂(θ)) with a fixed number
of knots at evenly spaced quantile levels of the masked context, and linear
tails at the z-score slope 1/sd, so it has full support.

Where the JAX package ``vmap``s a single transform (over the F feature
columns, the E ensemble members or the dθ dimensions), the port keeps those
axes as leading batch dims of the transform's tensors. The convention: a
transform with batch shape ``S`` maps values shaped ``[*S, Q]`` (one trailing
axis of query values per transform); the ``_cols`` forms take a table
``[*S, R, F]`` and a transform of batch shape ``[*S, F]``, broadcasting ``S``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

_MIN_STD = 1e-6
_BIG = 3.4e38  # masked rows sort last

# Cephes' rational approximations of ndtri (the JAX package's coefficients).
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
       1.39312609387279679503E1, -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
       -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
       4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
       1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
       1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
       2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coeffs, x):
    """Horner in f32 with each step fused (one rounding per multiply-add)."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = (out.double() * x.double() + float(torch.tensor(c, dtype=torch.float32))).float()
    return out


def _ndtri(p):
    """Φ⁻¹ of f32 levels in (0, 1), the JAX package's Cephes evaluation.
    ``torch.special.ndtri`` differs from it by an ulp at some levels, and the
    map's log-slope (dz / dθ over one knot segment) turns that ulp into a
    relative error of some 1e-6; with fused Horner steps the knots agree
    with the JAX package's to the bit at the default 64 knots."""
    mcp = torch.where(p > -math.expm1(-2.0), 1.0 - p, p)
    w = mcp - 0.5
    ww = w * w
    big = (w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))) * -math.sqrt(2.0 * math.pi)
    z = torch.sqrt(-2.0 * torch.log(mcp))
    first = z - torch.log(z) / z
    tail = torch.where(z >= 8.0, _polyval(_P2, 1 / z) / _polyval(_Q2, 1 / z),
                       _polyval(_P1, 1 / z) / _polyval(_Q1, 1 / z))
    x = torch.where(mcp > math.exp(-2.0), big, first - tail / z)
    return torch.where(p > 1.0 - math.exp(-2.0), x, -x)


@dataclasses.dataclass
class QuantileTransform:
    """knots / zknots ``[*S, K]``: strictly increasing θ-values at quantile
    levels (k+½)/K of the masked context, and the normal scores Φ⁻¹((k+½)/K);
    slope_lo / slope_hi ``[*S]``: dz/dθ beyond the outer knots (1/sd)."""

    knots: torch.Tensor
    zknots: torch.Tensor
    slope_lo: torch.Tensor
    slope_hi: torch.Tensor

    def select(self, idx) -> "QuantileTransform":
        """Index the leading batch dims (``qts.select(i)`` is JAX's
        ``tree_map(lambda a: a[i], qts)``)."""
        return QuantileTransform(self.knots[idx], self.zknots[idx], self.slope_lo[idx],
                                 self.slope_hi[idx])

    def first_cols(self, w: int) -> "QuantileTransform":
        """The first ``w`` columns of a per-column transform (batch ``[*S, F]``)."""
        return QuantileTransform(self.knots[..., :w, :], self.zknots[..., :w, :],
                                 self.slope_lo[..., :w], self.slope_hi[..., :w])


def quantile_fit(y, mask, num_knots: int = 64) -> QuantileTransform:
    """Fit from masked context targets ``y [*S, N]``; ``mask`` broadcastable
    to ``y``. Works for any valid count n ≤ N (n ≤ 1 degrades to an affine
    map through the strictly-increasing repair and the z-score tails)."""
    n_total = y.shape[-1]
    k_n = min(num_knots, n_total)
    mask = mask.bool()
    w = mask.to(y.dtype)
    n = (w.sum(dim=-1).clamp_min(1.0)).broadcast_to(y.shape[:-1])
    mu = (y * w).sum(dim=-1) / n
    sd = torch.sqrt(((y - mu[..., None]).square() * w).sum(dim=-1) / n).clamp_min(_MIN_STD)
    ys = torch.sort(torch.where(mask, y, torch.full_like(y, _BIG)), dim=-1).values
    k = torch.arange(k_n, device=y.device)
    level = (k.to(y.dtype) + 0.5) / k_n
    idx = torch.floor(level * n[..., None]).to(torch.int64)
    idx = torch.minimum(idx.clamp_min(0), (n - 1).clamp_min(0).to(torch.int64)[..., None])
    knots = torch.gather(ys, -1, idx)
    # Repair ties and tiny spacing so the map is strictly monotone.
    knots = torch.cummax(knots, dim=-1).values + (1e-5 * sd)[..., None] * k.to(y.dtype)
    zknots = _ndtri(level).broadcast_to(knots.shape)
    inv_sd = 1.0 / sd
    return QuantileTransform(knots=knots, zknots=zknots, slope_lo=inv_sd, slope_hi=inv_sd)


def _segments(xp, x):
    """``jnp.interp``'s segment: i = clip(searchsorted(xp, x, right), 1, K-1)
    per value, with ``xp [*S, K]`` broadcast to ``x [*S, Q]``'s batch dims."""
    batch = torch.broadcast_shapes(xp.shape[:-1], x.shape[:-1])
    xp = xp.broadcast_to(batch + xp.shape[-1:]).contiguous()
    x = x.broadcast_to(batch + x.shape[-1:]).contiguous()
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[-1] - 1)
    return xp, x, i


def _interp_core(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` inside ``[xp[0], xp[-1]]`` (its formula, with
    the same guard for a zero-width segment), batched; the tails are the
    caller's."""
    xp, x, i = _segments(xp, x)
    fp = fp.broadcast_to(xp.shape)
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    return torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))


def quantile_forward(qt: QuantileTransform, y):
    """θ → z for ``y [*S, Q]``."""
    core = _interp_core(y, qt.knots, qt.zknots)
    k0, k1 = qt.knots[..., :1], qt.knots[..., -1:]
    lo = qt.zknots[..., :1] + (y - k0) * qt.slope_lo[..., None]
    hi = qt.zknots[..., -1:] + (y - k1) * qt.slope_hi[..., None]
    return torch.where(y < k0, lo, torch.where(y > k1, hi, core))


def quantile_inverse(qt: QuantileTransform, z):
    """z → θ for ``z [*S, Q]`` (the exact inverse of ``quantile_forward``)."""
    core = _interp_core(z, qt.zknots, qt.knots)
    z0, z1 = qt.zknots[..., :1], qt.zknots[..., -1:]
    lo = qt.knots[..., :1] + (z - z0) / qt.slope_lo[..., None]
    hi = qt.knots[..., -1:] + (z - z1) / qt.slope_hi[..., None]
    return torch.where(z < z0, lo, torch.where(z > z1, hi, core))


def parse_transform(spec: str) -> Tuple[str, bool]:
    """Split a transform spec into (target_transform, feature_quantile):
    ``"zscore+featq"`` / ``"quantile+featq"`` add the feature-side map."""
    if spec.endswith("+featq"):
        return spec[: -len("+featq")], True
    return spec, False


def quantile_fit_cols(x, mask) -> QuantileTransform:
    """Per-column fit: ``x [*S, N, F]``, ``mask [*S, N]`` → batch ``[*S, F]``."""
    return quantile_fit(x.transpose(-1, -2), mask[..., None, :])


def quantile_forward_cols(qts: QuantileTransform, x):
    """Per-column maps (batch ``[*S, F]``) applied to ``x [*S, R, F]``."""
    return quantile_forward(qts, x.transpose(-1, -2)).transpose(-1, -2)


def quantile_log_det(qt: QuantileTransform, y):
    """log |dz/dθ| at θ = y ``[*S, Q]``: log p_θ(θ) = log p_z(z(θ)) + this."""
    knots, y_b, i = _segments(qt.knots, y)
    zknots = qt.zknots.broadcast_to(knots.shape)
    seg = ((torch.gather(zknots, -1, i) - torch.gather(zknots, -1, i - 1))
           / (torch.gather(knots, -1, i) - torch.gather(knots, -1, i - 1)))
    slope = torch.where(y_b < knots[..., :1], qt.slope_lo[..., None].broadcast_to(y_b.shape),
                        torch.where(y_b > knots[..., -1:], qt.slope_hi[..., None], seg))
    return torch.log(slope)
