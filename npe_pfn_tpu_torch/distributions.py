"""Priors over R^d: the protocol, ``Normal`` and ``BoxUniform``.

Counterpart of ``npe_pfn_tpu/distributions.py`` for the distributions the
main path uses. ``sample`` takes a ``torch.Generator`` in place of a PRNG key.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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
