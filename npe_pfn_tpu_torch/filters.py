"""Context-filtering strategies.

Counterpart of ``npe_pfn_tpu/filters.py``: given the observation, all
simulations (θ, x) and a target context size, choose the rows that become the
TabICA context. Every filter returns fixed-size padded tensors and a row mask,
``(theta_ctx, x_ctx, ctx_mask)``.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

FilterFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _pad_to(arr, size: int):
    n = arr.shape[0]
    if n >= size:
        return arr[:size]
    pad = arr.new_zeros((size - n,) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad], dim=0)


def _mask_for(n: int, size: int, device):
    return torch.arange(size, device=device) < min(n, size)


def no_filtering(obs, theta, x, context_size: int, generator=None):
    """Keep everything, truncated or padded to ``context_size``."""
    n = theta.shape[0]
    return (_pad_to(theta, context_size), _pad_to(x, context_size),
            _mask_for(n, context_size, theta.device))


def latest_filtering(obs, theta, x, context_size: int, generator=None):
    """The most recent ``context_size`` simulations."""
    n = theta.shape[0]
    if n > context_size:
        theta, x = theta[-context_size:], x[-context_size:]
    return (_pad_to(theta, context_size), _pad_to(x, context_size),
            _mask_for(n, context_size, theta.device))


def random_filtering(obs, theta, x, context_size: int, generator=None):
    """A uniform random subset drawn with ``generator``."""
    n = theta.shape[0]
    if n <= context_size:
        return no_filtering(obs, theta, x, context_size)
    if generator is None:
        raise ValueError("random_filtering needs a torch.Generator")
    idx = torch.randperm(n, generator=generator, device=generator.device)[:context_size]
    idx = idx.to(theta.device)
    return theta[idx], x[idx], _mask_for(context_size, context_size, theta.device)


def standardized_euclidean_filtering(obs, theta, x, context_size: int, generator=None):
    """The ``context_size`` simulations nearest to ``obs`` in z-scored x space.
    The std is the population std (``jnp.std``), floored at 1e-9."""
    n = theta.shape[0]
    if n <= context_size:
        return no_filtering(obs, theta, x, context_size)
    sd = torch.std(x, dim=0, correction=0).clamp_min(1e-9)
    d2 = ((x - obs) / sd).square().sum(dim=-1)
    idx = torch.topk(-d2, context_size).indices
    return theta[idx], x[idx], _mask_for(context_size, context_size, theta.device)


_FILTERS = {
    "no_filtering": no_filtering,
    "latest_filtering": latest_filtering,
    "random_filtering": random_filtering,
    "standardized_euclidean_filtering": standardized_euclidean_filtering,
}


def get_filtering_method(name_or_fn: Union[str, FilterFn]) -> FilterFn:
    """A filter by name, or the callable itself."""
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn not in _FILTERS:
        raise ValueError(
            f"unknown filter {name_or_fn!r}; available: {sorted(_FILTERS)} or a callable"
        )
    return _FILTERS[name_or_fn]
