"""Embedding nets for high-dimensional observations.

Counterpart of ``npe_pfn_tpu/embeddings.py``: fixed random feature maps that
the estimator applies to x in ``append_simulations`` and at observation time
(``NPEPFN._prep_obs``), so that an x wider than the model's feature budget
(``cfg.max_features`` caps dx + dθ) is projected down. Each is an
``nn.Module`` on an explicit device whose weights are drawn from a CPU
``torch.Generator`` seeded by ``seed`` (the same weights on every device), or
given (``weights=``, numpy or tensors: how the tests carry the JAX package's
weights across).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._device import resolve_device


def _weights(weights: Optional[dict], name: str, draw, device):
    w = draw() if weights is None else torch.as_tensor(weights[name])
    return w.to(device=device, dtype=torch.float32)


class RandomProjectionEmbedding(nn.Module):
    """Seeded Gaussian random projection R^din → R^dout, scaled by
    1/sqrt(dout); with ``standardize`` each output row is z-scored (the
    population std, floored at 1e-9)."""

    def __init__(self, din: int, dout: int, seed: int = 0, standardize: bool = True,
                 device=None, weights: Optional[dict] = None):
        super().__init__()
        self.din, self.dout, self.standardize = din, dout, standardize
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("w", _weights(
            weights, "w", lambda: torch.randn((din, dout), generator=gen) / math.sqrt(dout),
            resolve_device(device)))

    def forward(self, x):
        out = torch.as_tensor(x, dtype=torch.float32, device=self.w.device) @ self.w
        if self.standardize:
            mu = out.mean(dim=-1, keepdim=True)
            sd = out.std(dim=-1, keepdim=True, correction=0).clamp_min(1e-9)
            out = (out - mu) / sd
        return out


class MLPEmbedding(nn.Module):
    """A fixed random two-layer ReLU MLP, R^din → R^dout (He-scaled weights)."""

    def __init__(self, din: int, dout: int, hidden: int = 256, seed: int = 0, device=None,
                 weights: Optional[dict] = None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        device = resolve_device(device)
        self.register_buffer("w1", _weights(
            weights, "w1", lambda: torch.randn((din, hidden), generator=gen) * (2.0 / din) ** 0.5,
            device))
        self.register_buffer("w2", _weights(
            weights, "w2",
            lambda: torch.randn((hidden, dout), generator=gen) * (1.0 / hidden) ** 0.5, device))

    def forward(self, x):
        h = torch.relu(torch.as_tensor(x, dtype=torch.float32, device=self.w1.device) @ self.w1)
        return h @ self.w2


class Conv1DEmbedding(nn.Module):
    """A fixed random conv feature map for sequence-shaped x [..., length]:
    ``channels`` valid convolutions of width ``kernel``, ReLU, average pooling
    by ``pool``, then a linear readout to ``dout``."""

    def __init__(self, length: int, dout: int, channels: int = 16, kernel: int = 9,
                 pool: int = 4, seed: int = 0, device=None, weights: Optional[dict] = None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        device = resolve_device(device)
        self.length, self.pool = length, pool
        pooled = ((length - kernel + 1) // pool) * channels
        self.register_buffer("kernel", _weights(
            weights, "kernel",
            lambda: torch.randn((channels, 1, kernel), generator=gen) / math.sqrt(kernel), device))
        self.register_buffer("w_out", _weights(
            weights, "w_out",
            lambda: torch.randn((pooled, dout), generator=gen) / math.sqrt(pooled), device))

    def forward(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.kernel.device)
        batch = x.shape[:-1]
        h = torch.relu(F.conv1d(x.reshape(-1, 1, self.length), self.kernel))
        c, length = h.shape[1], h.shape[2]
        l_p = (length // self.pool) * self.pool
        h = h[:, :, :l_p].reshape(-1, c, l_p // self.pool, self.pool).mean(dim=-1)
        out = h.reshape(h.shape[0], -1) @ self.w_out
        return out.reshape(batch + (out.shape[-1],))


def chain(*nets: Callable) -> Callable:
    """Compose embedding nets left to right."""

    def apply(x):
        for net in nets:
            x = net(x)
        return x

    return apply
