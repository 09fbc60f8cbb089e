"""Unconditional density estimation p(θ) via cluster-conditioned TabICA.

Counterpart of ``npe_pfn_tpu/unconditional.py``: k-means-cluster θ, give the
in-context regressor a dummy feature column so that it works
unconditionally, sample clusters multinomially by size, and score θ under
its nearest cluster plus the log of that cluster's weight. ``kmeans`` is a
Lloyd iteration on the device.

The dummy columns are standard normal draws. JAX draws a cluster's context
column from ``PRNGKey(c)``, which torch cannot reproduce: here it comes from a
CPU ``torch.Generator`` seeded ``c`` and lives in ``context_dummies``, which a
caller may replace. The query columns come from the call's generator;
``log_prob_given`` scores θ against query columns the caller hands in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ._device import resolve_device
from .estimator import _round_up, autoregressive_log_prob, autoregressive_sample
from .models import checkpoint as ckpt_mod
from .models.regressor import TabICAModel


def lloyd(points, centroids, num_iters: int = 25):
    """``num_iters`` Lloyd steps from ``centroids [K, d]``; an empty cluster
    keeps its centroid. Returns (centroids, labels [N])."""
    k = centroids.shape[0]
    for _ in range(num_iters):
        onehot = F.one_hot(_nearest(points, centroids), k).to(points.dtype)
        counts = onehot.sum(0)
        new_c = (onehot.T @ points) / counts.clamp_min(1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], new_c, centroids)
    return centroids, _nearest(points, centroids)


def _nearest(points, centroids):
    """The nearest centroid of each point (squared Euclidean distance)."""
    return (points[:, None, :] - centroids[None]).square().sum(-1).argmin(dim=-1)


def kmeans(generator: torch.Generator, points, num_clusters: int, num_iters: int = 25):
    """Lloyd's algorithm from ``num_clusters`` random points. Returns
    (centroids [K, d], labels [N])."""
    init = torch.randperm(points.shape[0], generator=generator,
                          device=generator.device)[:num_clusters].to(points.device)
    return lloyd(points, points[init], num_iters)


class UnconditionalEstimator:
    """p(θ): k-means clusters, a dummy feature column, and the multinomial
    mixture of the per-cluster in-context densities."""

    def __init__(
        self,
        num_clusters: int = 1,
        model: Optional[TabICAModel] = None,
        context_size: int = 512,
        qry_chunk: int = 1024,
        min_cluster_size: int = 2,
        seed: int = 0,
        target_transform: str = "zscore",
        device=None,
    ):
        self.device = model.device if model is not None else resolve_device(device)
        self.model = model if model is not None else ckpt_mod.load_default(self.device)
        self.num_clusters = num_clusters
        self.context_size = context_size
        self.qry_chunk = qry_chunk
        self.target_transform = target_transform
        self.min_cluster_size = min_cluster_size
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._theta = self._labels = self._centroids = self._weights = None
        self.context_dummies = torch.stack([
            torch.randn((context_size, 1), generator=torch.Generator().manual_seed(c))
            for c in range(num_clusters)]).to(self.device)

    def set_cluster_state(self, centroids, labels):
        """Precomputed clustering: centroids ``[K, d]`` and a label per θ row."""
        self._centroids = torch.as_tensor(centroids, dtype=torch.float32, device=self.device)
        self._labels = torch.as_tensor(labels, device=self.device).long()
        counts = torch.bincount(self._labels, minlength=self.num_clusters).double().cpu()
        self._weights = counts / counts.sum()

    def append_simulations(self, theta) -> "UnconditionalEstimator":
        """Shuffle and cluster θ; every cluster needs ``min_cluster_size``
        members."""
        theta = self._theta_rows(theta)
        g = self._generator
        theta = theta[torch.randperm(theta.shape[0], generator=g, device=g.device).to(self.device)]
        self._theta = theta
        centroids, labels = kmeans(g, theta, self.num_clusters)
        counts = torch.bincount(labels, minlength=self.num_clusters)
        if int(counts.min()) < self.min_cluster_size:
            raise ValueError(f"smallest cluster has {int(counts.min())} < "
                             f"{self.min_cluster_size} members; reduce num_clusters")
        self.set_cluster_state(centroids, labels)
        return self

    def _cluster_context(self, c: int):
        """Cluster c's first ``context_size`` members, padded, with its dummy column."""
        idx = torch.nonzero(self._labels == c)[:self.context_size, 0]
        theta_c = self._theta[idx]
        n = theta_c.shape[0]
        mask = torch.arange(self.context_size, device=self.device) < n
        return (F.pad(theta_c, (0, 0, 0, self.context_size - n)), self.context_dummies[c],
                mask)

    def _query_dummies(self, generator, n: int):
        return torch.randn((_round_up(n, self.qry_chunk), 1), generator=generator,
                           device=generator.device).to(self.device)

    @torch.no_grad()
    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None):
        """Cluster counts from the multinomial of the cluster weights, then
        each cluster's draws; returned in a random order."""
        g = generator or self._generator
        weights = self._weights.float().to(g.device)
        pick = torch.multinomial(weights, num_samples, replacement=True, generator=g)
        counts = torch.bincount(pick, minlength=self.num_clusters).tolist()
        outs = []
        for c, n_c in enumerate(counts):
            if n_c == 0:
                continue
            theta, _ = autoregressive_sample(self.model, *self._cluster_context(c),
                                             self._query_dummies(g, n_c), g, self.qry_chunk,
                                             self.target_transform)
            outs.append(theta[:n_c])
        out = torch.cat(outs)
        return out[torch.randperm(out.shape[0], generator=g, device=g.device).to(out.device)]

    def log_prob(self, theta, generator: Optional[torch.Generator] = None):
        """Each θ scored under its nearest cluster's density plus the log of
        that cluster's weight; fresh query dummies from ``generator``."""
        theta = self._theta_rows(theta)
        g = generator or self._generator
        route = _nearest(theta, self._centroids)
        counts = torch.bincount(route, minlength=self.num_clusters).tolist()
        return self.log_prob_given(
            theta, {c: self._query_dummies(g, n_c) for c, n_c in enumerate(counts) if n_c})

    def _theta_rows(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        return theta[:, None] if theta.dim() == 1 else theta

    @torch.no_grad()
    def log_prob_given(self, theta, query_dummies: Dict[int, torch.Tensor]):
        """``log_prob`` with the query dummy column of each cluster given:
        ``{c: [round_up(members, qry_chunk), 1]}``."""
        theta = self._theta_rows(theta)
        route = _nearest(theta, self._centroids)
        lp = torch.zeros(theta.shape[0], device=self.device)
        for c in range(self.num_clusters):
            idx = torch.nonzero(route == c)[:, 0]
            if idx.numel() == 0:
                continue
            x_qry = torch.as_tensor(query_dummies[c], dtype=torch.float32, device=self.device)
            theta_eval = F.pad(theta[idx], (0, 0, 0, x_qry.shape[0] - idx.numel()))
            lp_c = autoregressive_log_prob(self.model, *self._cluster_context(c), x_qry,
                                           theta_eval, self.qry_chunk, self.target_transform)
            lp[idx] = lp_c[:idx.numel()] + math.log(float(self._weights[c]))
        return lp
