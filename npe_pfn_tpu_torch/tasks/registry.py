"""Task definitions: prior, simulator, dimensions and reference posterior.

Counterpart of ``npe_pfn_tpu/tasks/registry.py``, with the same twelve tasks
under the same names and dimensions. Where the JAX package runs a per-row
simulator under ``jit(vmap(sim))`` with a key per row, a port simulator is a
``Simulator``: a deterministic batched map of (θ [N, dθ], noise) and a
function that draws the noise from a ``torch.Generator``. The ODE simulators
loop over their RK4 steps on ``[N, state]`` tensors; the MCMC reference
samplers loop over their Metropolis steps on ``[chains, dθ]`` tensors.

bernoulli_glm's design matrix and high_dim_gaussian's parameters are the JAX
package's own draws, loaded from ``constants.npz`` (written by
``scripts/export_task_constants.py``); torch cannot reproduce threefry, and
other draws would make other tasks.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..distributions import BoxUniform, Distribution, MultivariateNormal, Normal
from ..preprocessing import _ndtri

CONSTANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "constants.npz")


@dataclasses.dataclass
class Simulator:
    """x = ``map(theta [N, dθ], noise)``, noise = ``draw(generator, N, device)``."""

    draw: Callable
    map: Callable

    def __call__(self, generator: torch.Generator, theta: torch.Tensor) -> torch.Tensor:
        return self.map(theta, self.draw(generator, theta.shape[0], theta.device))


@dataclasses.dataclass
class Task:
    name: str
    prior: Distribution
    simulator: Callable[[torch.Generator, torch.Tensor], torch.Tensor]
    dim_theta: int
    dim_x: int
    # Reference posterior sampler, where one exists: (generator, x_o, n) -> [n, dim_theta]
    posterior_sampler: Optional[Callable] = None
    # Exact posterior log-density: (x_o, theta [n, dim_theta]) -> [n]
    posterior_log_prob: Optional[Callable] = None
    # Analytic posterior mean and std: x_o -> ([dim_theta], [dim_theta])
    posterior_moments: Optional[Callable] = None
    # Set when x is a flattened image: the harness scores the joint C2ST
    # with a trained conv discriminator.
    x_image_shape: Optional[tuple] = None

    def simulate(self, generator: torch.Generator, num: int):
        """Draw ``num`` (θ, x) pairs on the generator's device."""
        theta = self.prior.sample(generator, (num,))
        return theta, self.simulator(generator, theta)


def _randn(*shape):
    return lambda g, n, dev: torch.randn((n,) + shape, generator=g, device=dev)


def _rand(*shape):
    return lambda g, n, dev: torch.rand((n,) + shape, generator=g, device=dev)


def _box(low, high, device):
    return BoxUniform(torch.tensor(low, dtype=torch.float32, device=device),
                      torch.tensor(high, dtype=torch.float32, device=device))


def _obs_index(num_steps: int, num_obs: int):
    """``linspace(0, num_steps - 1, num_obs)`` truncated to int: the steps observed."""
    return [k * (num_steps - 1) // (num_obs - 1) for k in range(num_obs)]


def _rk4(deriv, state, dt: float, num_steps: int, clip=None):
    """Fixed-step RK4 over ``[N, S]`` states; returns the trajectory [num_steps, N, S]."""
    traj = []
    for _ in range(num_steps):
        k1 = deriv(state)
        k2 = deriv(state + 0.5 * dt * k1)
        k3 = deriv(state + 0.5 * dt * k2)
        k4 = deriv(state + dt * k3)
        state = state + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if clip is not None:
            state = state.clamp(*clip)
        traj.append(state)
    return torch.stack(traj)


def _grid_log_density(log_likelihood, x_o, low: float, high: float, grid: int):
    """The cell centres of a ``grid x grid`` lattice over the box [low, high]²
    ([grid², 2], the first axis slowest) and the log-likelihood of x_o at each."""
    g = (torch.arange(grid, device=x_o.device) + 0.5) / grid * (high - low) + low
    tt = torch.stack(torch.meshgrid(g, g, indexing="ij"), dim=-1).reshape(-1, 2)
    return tt, log_likelihood(tt, x_o)


def _grid_sampler(log_likelihood, low: float, high: float, grid: int = 512):
    """Exact posterior draws under a box-uniform prior: a cell by its
    posterior mass (``multinomial``; the JAX package draws it by Gumbel-max),
    then a uniform jitter within the cell."""

    def sample(generator, x_o, n):
        tt, logp = _grid_log_density(log_likelihood, x_o, low, high, grid)
        idx = torch.multinomial(torch.softmax(logp, dim=0), n, replacement=True,
                                generator=generator)
        cell = (high - low) / grid
        jitter = (torch.rand((n, 2), generator=generator, device=x_o.device) - 0.5) * cell
        return tt[idx] + jitter

    return sample


def _metropolis(generator, log_density, pos, num_steps: int, step_scale: float, n: int):
    """Vectorized random-walk Metropolis from ``pos`` [chains, d]: the second
    half of the chains, shuffled, first ``n`` rows."""
    chains, d = pos.shape
    logp = log_density(pos)
    keep = num_steps - num_steps // 2
    kept = pos.new_empty((keep, chains, d))
    for step in range(num_steps):
        prop = pos + step_scale * torch.randn(pos.shape, generator=generator, device=pos.device)
        logp_prop = log_density(prop)
        u = torch.rand((chains,), generator=generator, device=pos.device)
        accept = torch.log(u) < logp_prop - logp
        pos = torch.where(accept[:, None], prop, pos)
        logp = torch.where(accept, logp_prop, logp)
        if step >= num_steps // 2:
            kept[step - num_steps // 2] = pos
    flat = kept.reshape(-1, d)
    idx = torch.randperm(flat.shape[0], generator=generator, device=pos.device)[:n]
    return flat[idx]


def _load_constants(prefix: str):
    if not os.path.exists(CONSTANTS):
        raise FileNotFoundError(f"{CONSTANTS} is missing; write it with "
                                "scripts/export_task_constants.py")
    with np.load(CONSTANTS) as data:
        return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


# --------------------------------------------------------------------------
# Two Moons (2D θ, 2D x), sbibm formulation.
# --------------------------------------------------------------------------


def _two_moons_ang(theta):
    s2 = math.sqrt(2.0)
    return torch.stack([-(theta[..., 0] + theta[..., 1]).abs() / s2,
                        (-theta[..., 0] + theta[..., 1]) / s2], dim=-1)


def _two_moons_map(theta, noise):
    """noise [N, 2]: a uniform draw on [0, 1) for the angle, a standard normal for the radius."""
    alpha = noise[:, 0] * math.pi + (-math.pi / 2)
    r = 0.1 + 0.01 * noise[:, 1]
    p = torch.stack([r * torch.cos(alpha) + 0.25, r * torch.sin(alpha)], dim=-1)
    return p + _two_moons_ang(theta)


def _two_moons_noise(g, n, dev):
    return torch.stack([torch.rand((n,), generator=g, device=dev),
                        torch.randn((n,), generator=g, device=dev)], dim=-1)


def two_moons_log_likelihood(theta, x):
    """Exact log p(x|θ): the crescent point p = x - ang(θ) has polar density
    N(r; 0.1, 0.01)·U(α; ±π/2) with Jacobian 1/r. theta [..., 2]; x [2]."""
    p = x - _two_moons_ang(theta)
    px, py = p[..., 0] - 0.25, p[..., 1]
    r = torch.sqrt(px**2 + py**2)
    alpha = torch.atan2(py, px)
    log_r = -0.5 * ((r - 0.1) / 0.01) ** 2 - math.log(0.01 * math.sqrt(2 * math.pi))
    log_alpha = torch.where((alpha > -math.pi / 2) & (alpha < math.pi / 2),
                            -math.log(math.pi), -math.inf)
    return log_r + log_alpha - torch.log(r.clamp_min(1e-12))


def two_moons(device=None) -> Task:
    device = resolve_device(device)
    return Task("two_moons", _box([-1.0, -1.0], [1.0, 1.0], device),
                Simulator(_two_moons_noise, _two_moons_map), 2, 2,
                _grid_sampler(two_moons_log_likelihood, -1.0, 1.0))


# --------------------------------------------------------------------------
# Gaussian Linear (10D), conjugate posterior.
# --------------------------------------------------------------------------


def gaussian_linear(dim: int = 10, prior_scale: float = 1.0, noise_scale: float = 0.6,
                    device=None) -> Task:
    """θ ~ N(0, prior_scale² I), x = θ + noise_scale · ε; conjugate posterior
    N(x · s_p²/(s_p²+s_n²), (1/s_p² + 1/s_n²)^-1)."""
    device = resolve_device(device)
    prior = Normal(torch.zeros(dim, device=device), prior_scale * torch.ones(dim, device=device))
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
        f"gaussian_linear_{dim}d", prior,
        Simulator(_randn(dim), lambda theta, z: theta + noise_scale * z), dim, dim,
        posterior_sampler, posterior_log_prob=posterior_log_prob,
        posterior_moments=posterior_moments,
    )


# --------------------------------------------------------------------------
# SLCP (5D θ, 8D x): simple likelihood, complex posterior (sbibm).
# --------------------------------------------------------------------------


def _slcp_map(theta, eps):
    """eps [N, 4, 2] standard normal: four draws of a bivariate normal."""
    s1, s2 = theta[:, 2] ** 2, theta[:, 3] ** 2
    rho = torch.tanh(theta[:, 4])
    a, b, c = s1**2 + 1e-6, rho * s1 * s2, s2**2 + 1e-6
    l11 = torch.sqrt(a)  # the 2 x 2 Cholesky factor, closed form
    l21 = b / l11
    l22 = torch.sqrt(c - l21 * l21)
    e0, e1 = eps[..., 0], eps[..., 1]
    x0 = theta[:, None, 0] + e0 * l11[:, None]
    x1 = theta[:, None, 1] + (e0 * l21[:, None] + e1 * l22[:, None])
    return torch.stack([x0, x1], dim=-1).reshape(-1, 8)


def slcp_log_likelihood(theta, x):
    """Exact log p(x|θ): four iid bivariate normals. theta [..., 5], x [8]."""
    s1, s2 = theta[..., 2] ** 2, theta[..., 3] ** 2
    rho = torch.tanh(theta[..., 4])
    v11, v22, v12 = s1**2 + 1e-6, s2**2 + 1e-6, rho * s1 * s2
    det = v11 * v22 - v12**2
    obs = x.reshape(4, 2)
    d1 = obs[:, 0] - theta[..., None, 0]
    d2 = obs[:, 1] - theta[..., None, 1]
    maha = (v22[..., None] * d1**2 - 2 * v12[..., None] * d1 * d2
            + v11[..., None] * d2**2) / det[..., None]
    return (-0.5 * maha - 0.5 * torch.log(det[..., None]) - math.log(2 * math.pi)).sum(dim=-1)


def slcp_posterior_sampler(generator, x_o, n, num_chains: int = 256, num_steps: int = 4000):
    """Random-walk Metropolis over the box prior [-3, 3]^5 with the exact
    likelihood; burn-in half."""
    pos = torch.rand((num_chains, 5), generator=generator, device=x_o.device) * 6.0 - 3.0

    def log_density(th):
        inside = ((th >= -3.0) & (th <= 3.0)).all(dim=-1)
        return torch.where(inside, slcp_log_likelihood(th, x_o), -math.inf)

    return _metropolis(generator, log_density, pos, num_steps, 0.25, n)


def slcp(device=None) -> Task:
    device = resolve_device(device)
    return Task("slcp", _box([-3.0] * 5, [3.0] * 5, device), Simulator(_randn(4, 2), _slcp_map),
                5, 8, slcp_posterior_sampler)


# --------------------------------------------------------------------------
# Lotka-Volterra (4D θ -> 20D x): RK4 over 200 steps, 10 observed steps.
# --------------------------------------------------------------------------


def _lv_map(theta, z, t_max=20.0, num_steps=200, num_obs=10):
    """z [N, num_obs, 2] standard normal."""
    alpha, beta, gamma, delta = torch.exp(theta).unbind(-1)

    def deriv(state):
        x, y = state[:, 0], state[:, 1]
        return torch.stack([alpha * x - beta * x * y, -gamma * y + delta * x * y], dim=-1)

    init = theta.new_tensor([30.0, 1.0]).expand(theta.shape[0], 2)
    traj = _rk4(deriv, init, t_max / num_steps, num_steps, clip=(1e-4, 1e4))
    obs = traj[_obs_index(num_steps, num_obs)].transpose(0, 1)  # [N, num_obs, 2]
    return (torch.log(obs + 1.0) + z * 0.1).reshape(theta.shape[0], -1)


def lotka_volterra(device=None) -> Task:
    device = resolve_device(device)
    loc = torch.log(torch.tensor([0.8, 0.08, 0.8, 0.02], device=device))
    prior = Normal(loc, 0.3 * torch.ones(4, device=device))
    return Task("lotka_volterra", prior, Simulator(_randn(10, 2), _lv_map), 4, 20)


# --------------------------------------------------------------------------
# SIR epidemic (2D θ: log beta, log gamma -> 10D x).
# --------------------------------------------------------------------------


def _sir_map(theta, z, population=1000.0, t_max=50.0, num_steps=200, num_obs=10):
    """z [N, num_obs] standard normal: Gaussian approximation of binomial noise."""
    beta, gamma = torch.exp(theta).unbind(-1)

    def deriv(state):
        s, i = state[:, 0], state[:, 1]
        return torch.stack([-beta * s * i / population,
                            beta * s * i / population - gamma * i], dim=-1)

    init = theta.new_tensor([population - 1.0, 1.0]).expand(theta.shape[0], 2)
    traj = _rk4(deriv, init, t_max / num_steps, num_steps, clip=(0.0, population))
    infected = traj[_obs_index(num_steps, num_obs), :, 1].T  # [N, num_obs]
    p = (infected / population).clamp(1e-6, 1 - 1e-6)
    n_trials = 1000.0
    obs = n_trials * p + torch.sqrt(n_trials * p * (1 - p)) * z
    return obs / n_trials


def sir(device=None) -> Task:
    device = resolve_device(device)
    prior = Normal(torch.log(torch.tensor([0.4, 0.125], device=device)),
                   torch.tensor([0.5, 0.2], device=device))
    return Task("sir", prior, Simulator(_randn(10), _sir_map), 2, 10)


# --------------------------------------------------------------------------
# Damped pendulum (3D θ: log length, log damping, initial angle -> 20D x).
# --------------------------------------------------------------------------


def _pendulum_map(theta, z, t_max=10.0, num_steps=200, num_obs=20, g=9.81):
    """z [N, num_obs] standard normal."""
    length, damping = torch.exp(theta[:, 0]), torch.exp(theta[:, 1])

    def deriv(state):
        ang, vel = state[:, 0], state[:, 1]
        return torch.stack([vel, -(g / length) * torch.sin(ang) - damping * vel], dim=-1)

    init = torch.stack([theta[:, 2], torch.zeros_like(theta[:, 2])], dim=-1)
    traj = _rk4(deriv, init, t_max / num_steps, num_steps)
    obs = traj[_obs_index(num_steps, num_obs), :, 0].T
    return obs + 0.05 * z


def pendulum(device=None) -> Task:
    device = resolve_device(device)
    return Task("pendulum", _box([-0.7, -3.0, 0.2], [0.7, -0.5, 1.5], device),
                Simulator(_randn(20), _pendulum_map), 3, 20)


# --------------------------------------------------------------------------
# Wind tunnel analog (1D θ: angle of attack in degrees -> 16 pressure taps).
# --------------------------------------------------------------------------


def _wind_tunnel_map(theta, z, num_taps=16, noise=0.05):
    """z [N, num_taps] standard normal."""
    alpha = theta * math.pi / 180.0  # [N, 1]
    s = torch.linspace(0.05, 0.95, num_taps, device=theta.device)
    stall = torch.sigmoid((theta - 20.0) / 2.5)
    cl = ((1.0 - stall) * 2.0 * math.pi * torch.sin(alpha) * torch.cos(alpha)
          + stall * 1.1 * torch.sin(2.0 * alpha))
    g = torch.sqrt((1.0 - s).clamp_min(0.0) / (s + 0.05))
    g = g / g.sum() * num_taps / 4.0
    cp = -cl * g * (1.0 - 0.5 * stall) - 0.2 * (1.0 - s) - 0.45 * stall * s
    return cp + noise * (1.0 + 2.0 * stall) * z


def wind_tunnel(device=None) -> Task:
    device = resolve_device(device)
    return Task("wind_tunnel", _box([0.0], [45.0], device), Simulator(_randn(16), _wind_tunnel_map),
                1, 16)


# --------------------------------------------------------------------------
# Gaussian bump image (3D θ -> 32 x 32 image, flattened to 1024).
# --------------------------------------------------------------------------


def _bump_map(theta, z, size=32):
    """z [N, size, size] standard normal."""
    cx = (theta[:, 0] * 10.0 + 16.0)[:, None, None]
    cy = (theta[:, 1] * 10.0 + 16.0)[:, None, None]
    sig = (torch.exp(theta[:, 2]) * 3.0 + 1.0)[:, None, None]
    ii = torch.arange(size, device=theta.device)[:, None]
    jj = torch.arange(size, device=theta.device)[None, :]
    img = torch.exp(-((ii - cy) ** 2 + (jj - cx) ** 2) / (2.0 * sig**2))
    return (img + 0.05 * z).reshape(theta.shape[0], -1)


def gaussian_bump_image(device=None) -> Task:
    device = resolve_device(device)
    return Task("gaussian_bump_image", _box([-1.0] * 3, [1.0] * 3, device),
                Simulator(_randn(32, 32), _bump_map), 3, 1024, x_image_shape=(32, 32))


# --------------------------------------------------------------------------
# Gaussian Mixture (2D θ), sbibm formulation: exact grid posterior.
# --------------------------------------------------------------------------


def _gaussian_mixture_map(theta, noise, scale_wide=1.0, scale_narrow=0.1):
    """noise [N, 3]: a uniform draw (narrow component when < 0.5), then a
    standard normal per dim."""
    scale = torch.where(noise[:, :1] < 0.5, scale_narrow, scale_wide)
    return theta + scale * noise[:, 1:]


def _gaussian_mixture_noise(g, n, dev):
    return torch.cat([torch.rand((n, 1), generator=g, device=dev),
                      torch.randn((n, 2), generator=g, device=dev)], dim=-1)


def gaussian_mixture_log_likelihood(theta, x, scale_wide=1.0, scale_narrow=0.1):
    """log ½[N(x; θ, s_w²I) + N(x; θ, s_n²I)]. theta [..., 2]."""
    d2 = (x - theta).square().sum(dim=-1)
    lw = -0.5 * d2 / scale_wide**2 - 2 * math.log(scale_wide)
    ln = -0.5 * d2 / scale_narrow**2 - 2 * math.log(scale_narrow)
    both = torch.stack([lw, ln], dim=-1) - math.log(2 * math.pi) - math.log(2.0)
    return torch.logsumexp(both, dim=-1)


def gaussian_mixture(device=None) -> Task:
    device = resolve_device(device)
    return Task("gaussian_mixture", _box([-10.0] * 2, [10.0] * 2, device),
                Simulator(_gaussian_mixture_noise, _gaussian_mixture_map), 2, 2,
                _grid_sampler(gaussian_mixture_log_likelihood, -10.0, 10.0))


# --------------------------------------------------------------------------
# Bernoulli GLM (10D θ): spike-train GLM with sufficient statistic x = Vᵀz;
# MCMC reference posterior.
# --------------------------------------------------------------------------


def bernoulli_glm_log_likelihood(theta, x_o, design):
    """log p(z|θ) through the sufficient statistic: x·θ − Σ_t softplus(V_t·θ)."""
    return (x_o * theta).sum(dim=-1) - F.softplus(theta @ design.T).sum(dim=-1)


def bernoulli_glm(dim: int = 10, device=None) -> Task:
    if dim != 10:
        raise ValueError(f"bernoulli_glm has its design matrix only at dim 10, not {dim}: "
                         "write other sizes with scripts/export_task_constants.py")
    device = resolve_device(device)
    design = torch.tensor(_load_constants("glm_")["design"], device=device)
    prior_scale = 2.0

    def sim_map(theta, u):
        """u [N, T] uniform on [0, 1): spike where u < sigmoid(V θ)."""
        z = (u < torch.sigmoid(theta @ design.T)).float()
        return z @ design

    def posterior_sampler(generator, x_o, n, num_chains: int = 256, num_steps: int = 4000):
        pos = prior_scale * torch.randn((num_chains, dim), generator=generator,
                                        device=x_o.device)

        def log_density(th):
            lp_prior = -0.5 * (th / prior_scale).square().sum(dim=-1)
            return lp_prior + bernoulli_glm_log_likelihood(th, x_o, design)

        return _metropolis(generator, log_density, pos, num_steps, 0.15, n)

    prior = Normal(torch.zeros(dim, device=device), prior_scale * torch.ones(dim, device=device))
    return Task("bernoulli_glm", prior, Simulator(_rand(design.shape[0]), sim_map), dim, dim,
                posterior_sampler)


# --------------------------------------------------------------------------
# Gaussian Linear Uniform (sbibm): box prior, Gaussian likelihood; the
# posterior is a per-dimension truncated normal, sampled by inverse CDF.
# --------------------------------------------------------------------------


def gaussian_linear_uniform(dim: int = 10, noise_scale: float = 0.316227766,
                            device=None) -> Task:
    device = resolve_device(device)
    prior = _box([-1.0] * dim, [1.0] * dim, device)

    def posterior_sampler(generator, x_o, n):
        lo = torch.special.ndtr((-1.0 - x_o) / noise_scale)
        hi = torch.special.ndtr((1.0 - x_o) / noise_scale)
        u = torch.rand((n, dim), generator=generator, device=x_o.device)
        u = torch.maximum(lo, u * (hi - lo) + lo).clamp(1e-7, 1.0 - 1e-7)
        return (x_o + noise_scale * _ndtri(u)).clamp(-1.0, 1.0)

    def posterior_log_prob(x_o, theta):
        z = (theta - x_o) / noise_scale
        mass = (torch.special.ndtr((1.0 - x_o) / noise_scale)
                - torch.special.ndtr((-1.0 - x_o) / noise_scale))
        log_norm = torch.log(mass.clamp_min(1e-300))
        per_dim = (-0.5 * z**2 - math.log(noise_scale) - 0.5 * math.log(2 * math.pi)
                   - log_norm)
        inside = (theta.abs() <= 1.0).all(dim=-1)
        return torch.where(inside, per_dim.sum(dim=-1), -math.inf)

    return Task(
        f"gaussian_linear_uniform_{dim}d", prior,
        Simulator(_randn(dim), lambda theta, z: theta + noise_scale * z), dim, dim,
        posterior_sampler, posterior_log_prob=posterior_log_prob,
    )


# --------------------------------------------------------------------------
# High-dim Gaussian: a two-stage linear-Gaussian process with an analytic
# MVN posterior; its parameters are the JAX package's fixed draws.
# --------------------------------------------------------------------------

HDG_NAMES = ("prior_loc", "prior_cov", "a_mat", "b_vec", "lik_cov", "c_mat", "d_vec",
             "noise_cov")


def high_dim_gaussian(theta_dim: int = 3, obs_dim: int = 3, device=None) -> Task:
    if (theta_dim, obs_dim) != (3, 3):
        raise ValueError(f"high_dim_gaussian has its parameters only at theta_dim 3, obs_dim 3, "
                         f"not {theta_dim}, {obs_dim}: write other sizes with "
                         "scripts/export_task_constants.py")
    device = resolve_device(device)
    arrays = _load_constants("hdg_")
    (prior_loc, prior_cov, a_mat, b_vec, lik_cov, c_mat, d_vec,
     noise_cov) = (torch.tensor(arrays[k], device=device) for k in HDG_NAMES)
    prior = MultivariateNormal(prior_loc, prior_cov)
    chol_lik = torch.linalg.cholesky(lik_cov)
    chol_noise = torch.linalg.cholesky(noise_cov)

    def sim_map(theta, z):
        """z [N, 2, obs_dim] standard normal: the likelihood's, then the noise's."""
        x_lik = theta @ a_mat.T + b_vec + z[:, 0] @ chol_lik.T
        return x_lik @ c_mat.T + d_vec + z[:, 1] @ chol_noise.T

    # y = Fθ + c + ε with ε ~ N(0, Σ_y): the linear-Gaussian conjugate update.
    f_mat = c_mat @ a_mat
    c_vec = c_mat @ b_vec + d_vec
    sigma_y_inv = torch.linalg.inv(c_mat @ lik_cov @ c_mat.T + noise_cov)
    prior_cov_inv = torch.linalg.inv(prior_cov)
    post_cov = torch.linalg.inv(prior_cov_inv + f_mat.T @ sigma_y_inv @ f_mat)
    post_chol = torch.linalg.cholesky(0.5 * (post_cov + post_cov.T)
                                      + 1e-9 * torch.eye(theta_dim, device=device))

    def post_mean(x_o):
        return post_cov @ (prior_cov_inv @ prior_loc + f_mat.T @ (sigma_y_inv @ (x_o - c_vec)))

    def posterior_sampler(generator, x_o, n):
        eps = torch.randn((n, theta_dim), generator=generator, device=x_o.device)
        return post_mean(x_o) + eps @ post_chol.T

    def posterior_log_prob(x_o, theta):
        diff = theta - post_mean(x_o)
        z = torch.linalg.solve_triangular(post_chol, diff.T, upper=False).T
        logdet = torch.log(torch.diagonal(post_chol)).sum()
        return -0.5 * z.square().sum(dim=-1) - logdet - 0.5 * theta_dim * math.log(2 * math.pi)

    # The noise of the two stages as one [N, 2, obs_dim] draw.
    return Task("high_dim_gaussian", prior, Simulator(_randn(2, obs_dim), sim_map), theta_dim,
                obs_dim, posterior_sampler, posterior_log_prob=posterior_log_prob)


_TASKS = {
    "two_moons": two_moons,
    "gaussian_linear": gaussian_linear,
    "slcp": slcp,
    "lotka_volterra": lotka_volterra,
    "sir": sir,
    "pendulum": pendulum,
    "gaussian_bump_image": gaussian_bump_image,
    "gaussian_mixture": gaussian_mixture,
    "bernoulli_glm": bernoulli_glm,
    "high_dim_gaussian": high_dim_gaussian,
    "gaussian_linear_uniform": gaussian_linear_uniform,
    "wind_tunnel": wind_tunnel,
}


def list_tasks():
    return sorted(_TASKS)


def get_task(name: str, **kwargs) -> Task:
    """A task by name; ``kwargs`` go to its constructor (``device=...``)."""
    if name not in _TASKS:
        raise ValueError(f"unknown task {name!r}; available: {list_tasks()}")
    return _TASKS[name](**kwargs)
