"""Task definitions: prior, simulator, dimensions and analytic posterior.

Counterpart of ``npe_pfn_tpu/tasks/registry.py`` for the main path's task,
``gaussian_linear``. Simulators are ``sim(generator, theta) -> x`` on tensors;
the noise comes from a ``torch.Generator`` in place of a PRNG key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..distributions import Distribution, Normal


@dataclasses.dataclass
class Task:
    name: str
    prior: Distribution
    simulator: Callable[[torch.Generator, torch.Tensor], torch.Tensor]
    dim_theta: int
    dim_x: int
    # Analytic posterior sampler, if one exists: (generator, x_o, n) -> [n, dim_theta]
    posterior_sampler: Optional[Callable] = None
    # Exact posterior log-density: (x_o, theta [n, dim_theta]) -> [n]
    posterior_log_prob: Optional[Callable] = None
    # Analytic posterior mean and std: x_o -> ([dim_theta], [dim_theta])
    posterior_moments: Optional[Callable] = None

    def simulate(self, generator: torch.Generator, num: int):
        """Draw ``num`` (θ, x) pairs on the generator's device."""
        theta = self.prior.sample(generator, (num,))
        return theta, self.simulator(generator, theta)


def gaussian_linear(dim: int = 10, prior_scale: float = 1.0, noise_scale: float = 0.6,
                    device=None) -> Task:
    """θ ~ N(0, prior_scale² I), x = θ + noise_scale · ε; conjugate posterior
    N(x · s_p²/(s_p²+s_n²), (1/s_p² + 1/s_n²)^-1)."""
    device = resolve_device(device)
    prior = Normal(torch.zeros(dim, device=device), prior_scale * torch.ones(dim, device=device))

    def sim(generator, theta):
        noise = torch.randn(theta.shape, generator=generator, device=theta.device)
        return theta + noise_scale * noise

    post_var = 1.0 / (1.0 / prior_scale**2 + 1.0 / noise_scale**2)
    coef = post_var / noise_scale**2

    def posterior_sampler(generator, x_o, n):
        eps = torch.randn((n, dim), generator=generator, device=x_o.device)
        return coef * x_o + math.sqrt(post_var) * eps

    def posterior_log_prob(x_o, theta):
        mu = coef * x_o
        return (-0.5 * (theta - mu) ** 2 / post_var
                - 0.5 * math.log(2 * math.pi * post_var)).sum(dim=-1)

    def posterior_moments(x_o):
        return coef * x_o, torch.full_like(x_o, math.sqrt(post_var))

    return Task(
        f"gaussian_linear_{dim}d", prior, sim, dim, dim, posterior_sampler,
        posterior_log_prob=posterior_log_prob, posterior_moments=posterior_moments,
    )


_TASKS = {"gaussian_linear": gaussian_linear}


def list_tasks():
    return sorted(_TASKS)


def get_task(name: str, **kwargs) -> Task:
    """A task by name; ``kwargs`` go to its constructor (``device=...``)."""
    if name not in _TASKS:
        raise ValueError(f"unknown task {name!r}; available: {list_tasks()}")
    return _TASKS[name](**kwargs)
