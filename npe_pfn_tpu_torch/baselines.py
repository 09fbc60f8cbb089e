"""Trained-NPE baseline: a conditional normalizing flow trained by maximum likelihood.

Counterpart of ``npe_pfn_tpu/baselines.py``: a RealNVP-style conditional
coupling flow q(θ | x) with alternating binary masks, trained with Adam on the
same (θ, x) simulations the estimator takes as its context, with a validation
split and early stopping. It is the trained side of the comparison against
NPE-PFN's in-context inference (epochs trained against none).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._device import resolve_device


def _mlp_init(generator, sizes, device):
    """He-normal weights and zero biases; the last layer's weights are zero,
    so the flow starts at the identity map."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator, device=generator.device)
        layers.append(((w * math.sqrt(2.0 / fan_in)).to(device),
                       torch.zeros(fan_out, device=device)))
    w, b = layers[-1]
    layers[-1] = (torch.zeros_like(w), b)
    return layers


def _mlp_apply(layers, h):
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = F.gelu(h, approximate="tanh")
    return h


def coupling_masks(dim: int, num_layers: int, device=None):
    """Alternating binary masks ``[num_layers, dim]``; every dim is
    transformed by half the layers."""
    base = (torch.arange(dim, device=device) % 2).float()
    return torch.stack([base if i % 2 == 0 else 1.0 - base for i in range(num_layers)])


def params_from_numpy(layers, device="cuda"):
    """The JAX ``FlowNPE.params`` (per coupling network, a list of ``(w, b)``
    arrays) as the port's: the same nesting, f32 tensors on ``device``."""
    device = resolve_device(device)
    return [[(torch.tensor(np.asarray(w), dtype=torch.float32, device=device),
              torch.tensor(np.asarray(b), dtype=torch.float32, device=device))
             for w, b in net] for net in layers]


def _coupling(net, mask, z, x):
    h = _mlp_apply(net, torch.cat([z * mask, x], dim=-1))
    shift, log_s = h.chunk(2, dim=-1)
    return shift, 2.0 * torch.tanh(log_s / 2.0)  # bounded scales


def flow_forward(params, masks, theta, x):
    """θ -> z and log|det dz/dθ| (``[N]``)."""
    z, ldj = theta, theta.new_zeros(theta.shape[:-1])
    for net, mask in zip(params, masks):
        shift, log_s = _coupling(net, mask, z, x)
        z = mask * z + (1.0 - mask) * (z * torch.exp(log_s) + shift)
        ldj = ldj + ((1.0 - mask) * log_s).sum(dim=-1)
    return z, ldj


def flow_inverse(params, masks, z, x):
    """z -> θ, the inverse of ``flow_forward``."""
    theta = z
    for net, mask in zip(reversed(params), reversed(list(masks))):
        shift, log_s = _coupling(net, mask, theta, x)
        theta = mask * theta + (1.0 - mask) * (theta - shift) * torch.exp(-log_s)
    return theta


def flow_nll(params, masks, theta, x):
    """-log q(θ | x) in the standardized space, ``[N]``."""
    z, ldj = flow_forward(params, masks, theta, x)
    log_base = -0.5 * z.square().sum(dim=-1) - 0.5 * theta.shape[-1] * math.log(2 * math.pi)
    return -(log_base + ldj)


class FlowNPE:
    """Conditional coupling flow q(θ | x) trained on simulations.

    ``fit`` returns the number of epochs trained; ``sample(n, x_o)`` and
    ``log_prob(theta, x_o)`` read the fitted flow in the original θ space.
    θ and x are standardized with the training set's mean and (population)
    std + 1e-6. Training: a shuffled ``val_frac`` validation split, Adam at
    ``lr`` over shuffled batches of ``batch_size`` (the remainder of an epoch
    dropped), and early stopping once the validation NLL has not improved by
    1e-4 for ``patience`` epochs; the best epoch's parameters are kept.
    Random draws come from a ``torch.Generator`` (default: seeded ``seed``
    for ``fit``, 1 for ``sample``). Runs on ``device`` (default CUDA).
    """

    def __init__(self, dim_theta: int, dim_x: int, num_layers: int = 6, hidden: int = 64,
                 lr: float = 1e-3, batch_size: int = 128, max_epochs: int = 500,
                 patience: int = 20, val_frac: float = 0.1, seed: int = 0, device=None):
        self.dim_theta, self.dim_x = dim_theta, dim_x
        self.num_layers, self.hidden = num_layers, hidden
        self.lr, self.batch_size = lr, batch_size
        self.max_epochs, self.patience, self.val_frac = max_epochs, patience, val_frac
        self.seed = seed
        self.device = resolve_device(device)
        self.params: Optional[list] = None
        # (θ mean, θ std, x mean, x std) of the training set.
        self.stats: Optional[tuple] = None
        self.epochs_trained = 0
        self.masks = coupling_masks(dim_theta, num_layers, self.device)

    def _init_params(self, generator):
        sizes = [self.dim_theta + self.dim_x, self.hidden, self.hidden, 2 * self.dim_theta]
        return [_mlp_init(generator, sizes, self.device) for _ in range(self.num_layers)]

    def fit(self, theta, x, generator: Optional[torch.Generator] = None,
            verbose: bool = False) -> int:
        """Train on ``theta [N, dθ]``, ``x [N, dx]``; returns the epochs trained."""
        dev = self.device
        gen = generator if generator is not None else \
            torch.Generator(dev).manual_seed(self.seed)
        theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        t_mu, t_sd = theta.mean(0), theta.std(0, unbiased=False) + 1e-6
        x_mu, x_sd = x.mean(0), x.std(0, unbiased=False) + 1e-6
        self.stats = (t_mu, t_sd, x_mu, x_sd)
        n = theta.shape[0]
        n_val = max(1, int(n * self.val_frac))
        perm = torch.randperm(n, generator=gen, device=gen.device).to(dev)
        th, xs = ((theta - t_mu) / t_sd)[perm], ((x - x_mu) / x_sd)[perm]
        th_tr, xs_tr, th_va, xs_va = th[n_val:], xs[n_val:], th[:n_val], xs[:n_val]

        params = self._init_params(gen)
        leaves = [t.requires_grad_() for net in params for wb in net for t in wb]
        opt = torch.optim.Adam(leaves, lr=self.lr, eps=1e-8, fused=dev.type == "cuda")
        n_tr = th_tr.shape[0]
        bs = min(self.batch_size, n_tr)
        steps = max(1, n_tr // bs)

        def snapshot():
            return [[(w.detach().clone(), b.detach().clone()) for w, b in net] for net in params]

        best_val, best_params, bad = math.inf, snapshot(), 0
        for epoch in range(self.max_epochs):
            idx = torch.randperm(n_tr, generator=gen, device=gen.device).to(dev)[: steps * bs]
            tr_loss = 0.0
            for tb, xb in zip(th_tr[idx].split(bs), xs_tr[idx].split(bs)):
                loss = flow_nll(params, self.masks, tb, xb).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                tr_loss = tr_loss + loss.detach()
            with torch.no_grad():
                val = flow_nll(params, self.masks, th_va, xs_va).mean().item()
            self.epochs_trained = epoch + 1
            if val < best_val - 1e-4:
                best_val, best_params, bad = val, snapshot(), 0
            else:
                bad += 1
                if bad >= self.patience:
                    break
            if verbose and (epoch + 1) % 25 == 0:
                print(f"[flow-npe] epoch {epoch + 1} train {float(tr_loss) / steps:.4f} "
                      f"val {val:.4f}")
        self.params = best_params
        return self.epochs_trained

    def _prep_x(self, x_o, n):
        _, _, x_mu, x_sd = self.stats
        xn = (torch.as_tensor(x_o, dtype=torch.float32, device=self.device).reshape(-1)
              - x_mu) / x_sd
        return xn.broadcast_to((n, self.dim_x))

    @torch.no_grad()
    def sample(self, num_samples: int, x_o, generator: Optional[torch.Generator] = None):
        """``num_samples`` draws of θ ``[n, dθ]`` from q(θ | x_o)."""
        if self.params is None:
            raise RuntimeError("call fit() first")
        gen = generator if generator is not None else torch.Generator(self.device).manual_seed(1)
        t_mu, t_sd = self.stats[:2]
        z = torch.randn((num_samples, self.dim_theta), generator=gen,
                        device=gen.device).to(self.device)
        th = flow_inverse(self.params, self.masks, z, self._prep_x(x_o, num_samples))
        return th * t_sd + t_mu

    @torch.no_grad()
    def log_prob(self, theta, x_o):
        """log q(θ | x_o) ``[N]`` in the original θ space."""
        if self.params is None:
            raise RuntimeError("call fit() first")
        t_mu, t_sd = self.stats[:2]
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        nll = flow_nll(self.params, self.masks, (theta - t_mu) / t_sd,
                       self._prep_x(x_o, theta.shape[0]))
        return -nll - torch.log(t_sd).sum()
