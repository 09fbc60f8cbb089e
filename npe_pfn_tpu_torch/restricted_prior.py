"""Classifier-based restricted prior.

Counterpart of ``npe_pfn_tpu/restricted_prior.py``: an in-context classifier
(the TabICA regressor's posterior mean of {0, 1} labels,
``regressor.predict_proba``) decides whether θ lies in the posterior
support, and θ is accepted when P(valid) exceeds ``accept_threshold``.
Labelled θ accumulate across rounds; the classifier context is a
class-balanced subsample capped at ``max_context`` rows.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .distributions import Distribution
from .models import checkpoint as ckpt_mod
from .models import regressor
from .models.regressor import TabICAModel
from .support import _Filler


class RestrictedPrior(Distribution):
    def __init__(
        self,
        prior: Distribution,
        model: Optional[TabICAModel] = None,
        accept_threshold: float = 0.3,
        max_context: int = 512,
        max_iters: int = 32,
        batch_size: int = 16_384,
        seed: int = 0,
        device=None,
    ):
        self.device = model.device if model is not None else resolve_device(device)
        self.prior = prior
        self.model = model if model is not None else ckpt_mod.load_default(self.device)
        self.accept_threshold = accept_threshold
        self.max_context = max_context
        self.max_iters = max_iters
        self.batch_size = batch_size
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._theta = self._labels = None  # accumulated labelled θ
        self._ctx_theta = self._ctx_labels = None  # the balanced classifier context
        self.last_diagnostics: dict = {}

    @property
    def event_dim(self) -> int:
        return self.prior.event_dim

    def append_simulations(self, theta, labels) -> "RestrictedPrior":
        """Accumulate labelled θ (1 = in the support) and rebuild the classifier
        context: up to ``max_context // 2`` positives, then negatives up to
        ``max_context`` rows, each a random subset."""
        theta = torch.as_tensor(theta, dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=self.device).reshape(-1)
        if self._theta is None:
            self._theta, self._labels = theta, labels
        else:
            self._theta = torch.cat([self._theta, theta])
            self._labels = torch.cat([self._labels, labels])
        lab = self._labels.cpu().numpy()
        pos, neg = np.nonzero(lab == 1)[0], np.nonzero(lab == 0)[0]
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self._generator, device=self.device))
        rng = np.random.default_rng(seed)
        take_pos = rng.permutation(pos)[:min(self.max_context // 2, pos.size)]
        take_neg = rng.permutation(neg)[:min(self.max_context - take_pos.size, neg.size)]
        idx = torch.as_tensor(np.concatenate([take_pos, take_neg]), device=self.device)
        self._ctx_theta, self._ctx_labels = self._theta[idx], self._labels[idx]
        return self

    @torch.no_grad()
    def accept_reject_fn(self, theta):
        """P(valid | θ) > accept_threshold; everything is accepted before any
        labelled θ exist."""
        if self._ctx_theta is None:
            return torch.ones(theta.shape[:-1], dtype=torch.bool, device=theta.device)
        probs = regressor.predict_proba(self.model, self._ctx_theta, self._ctx_labels, theta)
        return probs[..., 1] > self.accept_threshold

    def sample(self, generator: Optional[torch.Generator] = None, shape=()):
        """Prior candidates in rounds of ``batch_size``, kept where accepted;
        after ``max_iters`` rounds the rest are unrestricted prior draws.
        ``last_diagnostics`` records the rounds drawn and the padded count."""
        n = math.prod(int(d) for d in shape)
        generator = generator or self._generator
        fill = _Filler(n)
        rounds = 0
        for rounds in range(1, self.max_iters + 1):
            cand = self.prior.sample(generator, (self.batch_size,))
            fill.add(cand, self.accept_reject_fn(cand))
            if fill.done():
                break
        self.last_diagnostics = {"rounds": rounds, "padded": n - fill.filled}
        pad = None if fill.done() else self.prior.sample(generator, (n - fill.filled,))
        flat = fill.result(pad)
        return flat.reshape(tuple(shape) + (self.event_dim,)) if shape else flat[0]

    def log_prob(self, theta):
        """Unnormalized: the prior's density where accepted, −inf where rejected."""
        prior_lp = self.prior.log_prob(theta)
        return torch.where(self.accept_reject_fn(theta), prior_lp,
                           torch.full_like(prior_lp, -torch.inf))

    def support_check(self, theta):
        return self.accept_reject_fn(theta) & self.prior.support_check(theta)
