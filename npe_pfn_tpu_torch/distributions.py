"""Priors over R^d: the protocol, ``BoxUniform``, ``Normal``,
``MultivariateNormal``, ``Logistic``, ``TruncatedByBounds``, the
``LogitBoxBijection`` and ``intersect_boxes``.

Counterpart of ``npe_pfn_tpu/distributions.py``. ``sample`` takes a
``torch.Generator`` in place of a PRNG key; parameters live on the device of
the first one given.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


class Distribution:
    """Event-dim-1 distribution over R^d.

    sample(generator, shape) -> [*shape, d]; log_prob(x[..., d]) -> [...];
    support_check(x[..., d]) -> bool[...]; bounds() -> (low, high) or None.
    """

    @property
    def event_dim(self) -> int:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def support_check(self, x: torch.Tensor) -> torch.Tensor:
        """Default: finite log-prob."""
        return torch.isfinite(self.log_prob(x))

    def bounds(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        return None


class BoxUniform(Distribution):
    """Uniform over an axis-aligned box."""

    def __init__(self, low, high):
        self.low = torch.as_tensor(low, dtype=torch.float32)
        self.high = torch.as_tensor(high, dtype=torch.float32).to(self.low.device)

    @property
    def event_dim(self) -> int:
        return self.low.shape[-1]

    def sample(self, generator, shape=()):
        u = torch.rand(tuple(shape) + tuple(self.low.shape), generator=generator,
                       device=self.low.device)
        return self.low + u * (self.high - self.low)

    def log_prob(self, x):
        logp = -torch.log(self.high - self.low).sum()
        return torch.where(self.support_check(x), logp, -math.inf)

    def support_check(self, x):
        return ((x >= self.low) & (x <= self.high)).all(dim=-1)

    def bounds(self):
        return self.low, self.high


class Normal(Distribution):
    """Independent (diagonal) normal over R^d."""

    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32).to(self.loc.device)

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, generator, shape=()):
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape), generator=generator,
                          device=self.loc.device)
        return self.loc + eps * self.scale

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return (-0.5 * z**2 - torch.log(self.scale) - 0.5 * math.log(2 * math.pi)).sum(dim=-1)

    def support_check(self, x):
        return torch.isfinite(x).all(dim=-1)


class MultivariateNormal(Distribution):
    """Full-covariance normal: Cholesky in the sampler, a triangular solve in
    ``log_prob``."""

    def __init__(self, loc, cov):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.cov = torch.as_tensor(cov, dtype=torch.float32).to(self.loc.device)
        self.chol = torch.linalg.cholesky(self.cov)

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, generator, shape=()):
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape), generator=generator,
                          device=self.loc.device)
        return self.loc + eps @ self.chol.T

    def log_prob(self, x):
        d = self.event_dim
        diff = x - self.loc
        sol = torch.linalg.solve_triangular(self.chol, diff.reshape(-1, d).T, upper=False)
        maha = sol.square().sum(dim=0).reshape(diff.shape[:-1])
        logdet = 2.0 * torch.log(torch.diagonal(self.chol)).sum()
        return -0.5 * (maha + logdet + d * math.log(2 * math.pi))

    def support_check(self, x):
        return torch.isfinite(x).all(dim=-1)


class Logistic(Distribution):
    """Independent logistic: the pushforward of ``BoxUniform`` under
    ``LogitBoxBijection`` is ``Logistic(0, 1)`` per dimension."""

    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32).to(self.loc.device)

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, generator, shape=()):
        u = torch.rand(tuple(shape) + tuple(self.loc.shape), generator=generator,
                       device=self.loc.device)
        u = 1e-7 + u * (1 - 2e-7)  # uniform on [1e-7, 1 - 1e-7), as the JAX package draws
        return self.loc + self.scale * (torch.log(u) - torch.log1p(-u))

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return (-z - 2 * F.softplus(-z) - torch.log(self.scale)).sum(dim=-1)

    def support_check(self, x):
        return torch.isfinite(x).all(dim=-1)


class TruncatedByBounds(Distribution):
    """``base`` truncated to an axis-aligned box; ``log_prob`` is the base's
    inside the box (unnormalized) and -inf outside."""

    def __init__(self, base: Distribution, low, high):
        self.base = base
        self.low = torch.as_tensor(low, dtype=torch.float32)
        self.high = torch.as_tensor(high, dtype=torch.float32).to(self.low.device)

    @property
    def event_dim(self) -> int:
        return self.base.event_dim

    def _inside(self, x):
        return ((x >= self.low) & (x <= self.high)).all(dim=-1)

    def sample(self, generator, shape=()):
        """Rejection against ``base`` in 32 fixed-shape rounds, each redrawing
        the still-rejected slots; stragglers after the last are clamped to
        the box."""
        shape = tuple(shape)
        cur = self.base.sample(generator, shape)
        ok = self._inside(cur)
        for _ in range(31):
            cand = self.base.sample(generator, shape)
            inside = self._inside(cand)
            cur = torch.where((~ok & inside)[..., None], cand, cur)
            ok = ok | inside
        return torch.where(ok[..., None], cur, cur.clamp(self.low, self.high))

    def log_prob(self, x):
        return torch.where(self._inside(x), self.base.log_prob(x), -math.inf)

    def support_check(self, x):
        return self._inside(x) & self.base.support_check(x)

    def bounds(self):
        return self.low, self.high


class LogitBoxBijection:
    """θ ↔ logit((θ − low)/(high − low)): box-constrained parameters
    estimated in unbounded logit space, where the pushforward of
    ``BoxUniform(low, high)`` is ``Logistic(0, 1)`` per dimension."""

    def __init__(self, low, high):
        self.low = torch.as_tensor(low, dtype=torch.float32)
        self.high = torch.as_tensor(high, dtype=torch.float32).to(self.low.device)

    def _unit(self, x):
        return ((x - self.low) / (self.high - self.low)).clamp(1e-7, 1 - 1e-7)

    def forward(self, x):
        u = self._unit(x)
        return torch.log(u) - torch.log1p(-u)

    def inverse(self, z):
        return self.low + (self.high - self.low) * torch.sigmoid(z)

    def forward_log_det(self, x):
        """Σ log |dz/dθ|: log p_z(z) = log p_θ(θ) − forward_log_det(θ)."""
        u = self._unit(x)
        return (-torch.log(u) - torch.log1p(-u) - torch.log(self.high - self.low)).sum(dim=-1)


def intersect_boxes(a: BoxUniform, low, high) -> BoxUniform:
    """``a`` intersected with the bounds ``(low, high)``."""
    low = torch.as_tensor(low, dtype=torch.float32, device=a.low.device)
    high = torch.as_tensor(high, dtype=torch.float32, device=a.low.device)
    return BoxUniform(torch.maximum(a.low, low), torch.minimum(a.high, high))
