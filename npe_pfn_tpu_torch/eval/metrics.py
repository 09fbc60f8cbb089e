"""Sample-quality metrics: C2ST, MMD, Wasserstein.

Counterpart of ``npe_pfn_tpu/eval/metrics.py``. The JAX package trains one
C2ST classifier per cross-validation fold and ``vmap``s the folds; here every
parameter has a leading ``[folds]`` dimension and one Adam trains them all
full-batch on the sum of the per-fold losses (each the mean over that fold's
training rows). Adam is elementwise, so this is ``folds`` independent runs of
optax's ``adam(lr)``. The classifier's initial parameters and the row
permutation come from a ``torch.Generator``, or are given (``params=``,
``perm=``: how the tests carry the JAX package's across). Sinkhorn runs its
200 log-domain iterations on the device; the exact Wasserstein distance and
the KS test are scipy on the host.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import pytree_io


def _standardize(a, b):
    both = torch.cat([a, b], dim=0)
    mu = both.mean(dim=0)
    sd = both.std(dim=0, correction=0).clamp_min(1e-9)
    return (a - mu) / sd, (b - mu) / sd


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# C2ST
# ---------------------------------------------------------------------------


def _mlp_init(generator, folds: int, din: int, hidden: int, device):
    def normal(*shape):
        return torch.randn((folds,) + shape, generator=generator, device=device)

    return {
        "w1": normal(din, hidden) * (2.0 / din) ** 0.5,
        "b1": torch.zeros((folds, hidden), device=device),
        "w2": normal(hidden, hidden) * (2.0 / hidden) ** 0.5,
        "b2": torch.zeros((folds, hidden), device=device),
        "w3": normal(hidden, 1) * (2.0 / hidden) ** 0.5,
        "b3": torch.zeros((folds, 1), device=device),
    }


def _mlp_logit(p, x):
    """Per-fold logits ``[folds, N]`` of rows ``x`` ([N, d] or [folds, N, d])."""
    h = torch.relu(torch.matmul(x, p["w1"]) + p["b1"][:, None])
    h = torch.relu(torch.matmul(h, p["w2"]) + p["b2"][:, None])
    return (torch.matmul(h, p["w3"]) + p["b3"][:, None])[..., 0]


def sigmoid_ce(logits, labels):
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _folds(generator, a, b, folds: int, paired: bool, perm):
    """Standardized, permuted rows x [R, d], labels y [R] and the test mask
    [folds, R] of each fold. ``paired`` keeps a[i] and b[i] in one fold."""
    n = min(a.shape[0], b.shape[0])
    n = (n // folds) * folds
    a, b = _standardize(a[:n].float(), b[:n].float())
    dev = a.device
    y = torch.cat([torch.zeros(n, device=dev), torch.ones(n, device=dev)])
    if perm is None:
        perm = torch.randperm(n if paired else 2 * n, generator=generator, device=generator.device)
    perm = torch.as_tensor(perm, device=dev, dtype=torch.int64)
    if paired:
        x = torch.cat([a[perm], b[perm]], dim=0)
        pos = torch.cat([torch.arange(n, device=dev), torch.arange(n, device=dev)])
        fold_size = n // folds
    else:
        x = torch.cat([a, b], dim=0)[perm]
        y = y[perm]
        pos = torch.arange(2 * n, device=dev)
        fold_size = (2 * n) // folds
    f = torch.arange(folds, device=dev)[:, None]
    test_mask = (pos >= f * fold_size) & (pos < (f + 1) * fold_size)
    return x, y, test_mask


def _train_and_score(params, logit_fn, y, test_mask, epochs: int, lr: float):
    """Adam on the sum over folds of each fold's mean training loss; the
    mean over folds of the held-out accuracy, a 0-d tensor."""
    named = {k: p.detach().clone().requires_grad_(True)
             for k, p in pytree_io.flatten(params).items()}
    params = pytree_io.unflatten(named)
    train_w = (~test_mask).float()
    opt = torch.optim.Adam(list(named.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(epochs):
            loss = ((sigmoid_ce(logit_fn(params), y) * train_w).sum(dim=1)
                    / train_w.sum(dim=1)).sum()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    with torch.no_grad():
        correct = ((logit_fn(params) > 0).float() == y).float()
        test = test_mask.float()
        return ((correct * test).sum(dim=1) / test.sum(dim=1)).mean()


def _as_params(params, device):
    """Given parameters (numpy arrays or tensors, ``[folds, ...]``) as f32 tensors."""
    if isinstance(params, dict):
        return {k: _as_params(v, device) for k, v in params.items()}
    return torch.as_tensor(params, dtype=torch.float32, device=device)


def c2st(
    generator: torch.Generator,
    a: torch.Tensor,
    b: torch.Tensor,
    folds: int = 5,
    epochs: int = 300,
    hidden: int = 64,
    lr: float = 1e-2,
    paired: bool = False,
    params: Optional[dict] = None,
    perm=None,
) -> torch.Tensor:
    """Classifier two-sample test accuracy in [0.5, 1]; 0.5 = indistinguishable.

    A ``folds``-fold cross-validated MLP classifier (two hidden ReLU layers)
    trained full-batch with Adam for ``epochs`` steps. a, b: [n, d] sample
    sets. ``paired=True``: rows a[i] and b[i] share identifying features (the
    joint diagnostic's {(θ̂, x_i)} vs {(θ*, x_i)}), so both copies of a pair
    go to the same fold; row-level folds would reward memorizing x_i.
    ``params`` ({w1, b1, w2, b2, w3, b3}, each ``[folds, ...]``) and ``perm``
    replace the generator's draws. Returns a 0-d tensor on a's device.
    """
    x, y, test_mask = _folds(generator, a, b, folds, paired, perm)
    if params is None:
        params = _mlp_init(generator, folds, x.shape[1], hidden, x.device)
    return _train_and_score(_as_params(params, x.device), lambda p: _mlp_logit(p, x), y,
                            test_mask, epochs, lr)


def c2st_embedded(generator, a, b, embed_fn, **kwargs):
    """C2ST through a fixed feature embedding (``npe_pfn_tpu_torch.embeddings``)."""
    return c2st(generator, torch.as_tensor(embed_fn(a)), torch.as_tensor(embed_fn(b)), **kwargs)


# ---------------------------------------------------------------------------
# Trained convolutional C2ST discriminators
# ---------------------------------------------------------------------------


def _conv_trunk_init(generator, folds: int, shape, channels: int, device):
    def normal(*s):
        return torch.randn((folds,) + s, generator=generator, device=device)

    if len(shape) == 1:
        w1 = normal(channels, 1, 5) / math.sqrt(5.0)
        w2 = normal(2 * channels, channels, 5) / math.sqrt(5.0 * channels)
    else:
        w1 = normal(channels, 1, 3, 3) / 3.0
        w2 = normal(2 * channels, channels, 3, 3) / (3.0 * math.sqrt(channels))
    return {"w1": w1, "b1": torch.zeros((folds, channels), device=device), "w2": w2,
            "b2": torch.zeros((folds, 2 * channels), device=device)}


def _same_pad(h, kernel: int, stride: int):
    """XLA's "SAME" padding on every spatial axis of h [N, C, *spatial]: the
    output has ceil(L / stride) positions, and of the padding needed the low
    side takes the floor of half (so 3-wide stride-2 windows on even lengths
    pad 0 low and 1 high, 5-wide ones 1 low and 2 high)."""
    pads = []
    for length in reversed(h.shape[2:]):  # F.pad lists the last axis first
        total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


def _conv_trunk_apply(p, x, shape):
    """x [N, prod(shape)] → pooled features [folds, N, 4·channels]: two
    stride-2 convolutions with ReLU (1D or 2D by the rank of ``shape``), then
    the spatial mean and max. Each fold's filters are one group of a grouped
    convolution, so all folds run in one call per layer."""
    nd = len(shape)
    conv = F.conv1d if nd == 1 else F.conv2d
    folds, c = p["w1"].shape[:2]
    k = p["w1"].shape[-1]
    h = x.reshape((x.shape[0], 1) + tuple(shape))
    w1 = p["w1"].reshape((folds * c,) + tuple(p["w1"].shape[2:]))
    w2 = p["w2"].reshape((folds * 2 * c,) + tuple(p["w2"].shape[2:]))
    h = conv(_same_pad(h, k, 2), w1, stride=2)
    h = torch.relu(h + p["b1"].reshape((1, -1) + (1,) * nd))
    h = conv(_same_pad(h, k, 2), w2, stride=2, groups=folds)
    h = torch.relu(h + p["b2"].reshape((1, -1) + (1,) * nd))
    spatial = tuple(range(2, 2 + nd))
    pooled = torch.cat([h.mean(dim=spatial).reshape(-1, folds, 2 * c),
                        h.amax(dim=spatial).reshape(-1, folds, 2 * c)], dim=-1)
    return pooled.transpose(0, 1)


def c2st_conv(
    generator: torch.Generator,
    a: torch.Tensor,
    b: torch.Tensor,
    shape: tuple,
    d_extra: int = 0,
    folds: int = 5,
    epochs: int = 200,
    channels: int = 8,
    hidden: int = 64,
    lr: float = 2e-3,
    paired: bool = False,
    params: Optional[dict] = None,
    perm=None,
) -> torch.Tensor:
    """C2ST with a trained conv discriminator for image-shaped samples.

    a, b: [n, d_extra + prod(shape)]: the first d_extra columns are plain
    dims (θ in joint tests), the rest a flattened image of ``shape`` ((L,) →
    1D convolutions, (H, W) → 2D). ``paired`` as in ``c2st``; ``params``
    ({"conv": {w1, b1, w2, b2}, "mlp": {...}}, each ``[folds, ...]``) and
    ``perm`` replace the generator's draws. Returns a 0-d tensor.
    """
    x, y, test_mask = _folds(generator, a, b, folds, paired, perm)
    x_extra, x_img = x[:, :d_extra], x[:, d_extra:]
    if params is None:
        params = {"conv": _conv_trunk_init(generator, folds, shape, channels, x.device),
                  "mlp": _mlp_init(generator, folds, 4 * channels + d_extra, hidden, x.device)}

    def logit_fn(p):
        feats = _conv_trunk_apply(p["conv"], x_img, shape)
        feats = torch.cat([x_extra.expand(folds, -1, -1), feats], dim=-1)
        return _mlp_logit(p["mlp"], feats)

    return _train_and_score(_as_params(params, x.device), logit_fn, y, test_mask, epochs, lr)


# ---------------------------------------------------------------------------
# MMD (multiscale and rbf kernels)
# ---------------------------------------------------------------------------


def mmd(a: torch.Tensor, b: torch.Tensor, kernel: str = "multiscale") -> torch.Tensor:
    """Squared maximum mean discrepancy between sample sets; a 0-d tensor."""
    if kernel == "multiscale":
        scales, fn = (0.2, 0.5, 0.9, 1.3), lambda d2, s: s**2 / (s**2 + d2)
    elif kernel == "rbf":
        scales, fn = (10.0, 15.0, 20.0, 50.0), lambda d2, s: torch.exp(-0.5 * d2 / s)
    else:
        raise ValueError(kernel)

    def k(d2):
        out = 0.0
        for s in scales:
            out = out + fn(d2, s)
        return out

    d_aa = (a[:, None] - a[None]).square().sum(dim=-1)
    d_bb = (b[:, None] - b[None]).square().sum(dim=-1)
    d_ab = (a[:, None] - b[None]).square().sum(dim=-1)
    return k(d_aa).mean() + k(d_bb).mean() - 2.0 * k(d_ab).mean()


# ---------------------------------------------------------------------------
# Wasserstein
# ---------------------------------------------------------------------------


def _sinkhorn_cost(a, b, eps: float = 0.05, num_iters: int = 200):
    """Entropic-regularized squared-W2 transport cost (log-domain Sinkhorn)."""
    n, m = a.shape[0], b.shape[0]
    cost = (a[:, None] - b[None]).square().sum(dim=-1)
    c = cost / cost.mean().clamp_min(1e-12)
    log_mu = torch.full((n,), -math.log(n), device=a.device)
    log_nu = torch.full((m,), -math.log(m), device=a.device)
    f, g = torch.zeros(n, device=a.device), torch.zeros(m, device=a.device)
    for _ in range(num_iters):
        f = eps * (log_mu - torch.logsumexp((g[None, :] - c) / eps, dim=1))
        g = eps * (log_nu - torch.logsumexp((f[:, None] - c) / eps, dim=0))
    log_plan = (f[:, None] + g[None, :]) / eps - c / eps + log_mu[:, None] + log_nu[None, :]
    plan = torch.exp(log_plan)
    plan = plan / plan.sum().clamp_min(1e-12)
    return (plan * cost).sum()


def sinkhorn_w2(a, b, eps: float = 0.05, num_iters: int = 200) -> torch.Tensor:
    """Debiased Sinkhorn-divergence estimate of the 2-Wasserstein distance,
    on the device: S(a,b) − ½S(a,a) − ½S(b,b) removes the entropic offset,
    so identical samples score about 0."""
    ab = _sinkhorn_cost(a, b, eps, num_iters)
    aa = _sinkhorn_cost(a, a, eps, num_iters)
    bb = _sinkhorn_cost(b, b, eps, num_iters)
    return torch.sqrt((ab - 0.5 * (aa + bb)).clamp_min(0.0))


def wasserstein2_exact(a, b) -> float:
    """Exact W2 by Hungarian assignment (equal sizes); scipy on the host."""
    from scipy.optimize import linear_sum_assignment

    a, b = _np(a), _np(b)
    n = min(a.shape[0], b.shape[0])
    cost = ((a[:n, None] - b[None, :n]) ** 2).sum(-1)
    r, c = linear_sum_assignment(cost)
    return float(np.sqrt(cost[r, c].mean()))


def ks_test_per_dim(a, b) -> np.ndarray:
    """Per-dimension two-sample KS p-values; scipy on the host."""
    from scipy.stats import ks_2samp

    a, b = _np(a), _np(b)
    return np.array([ks_2samp(a[:, d], b[:, d]).pvalue for d in range(a.shape[1])])
