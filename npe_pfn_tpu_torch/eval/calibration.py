"""Classifier calibration audit.

Counterpart of ``npe_pfn_tpu/eval/calibration.py``. The restricted prior
accepts θ at P(valid) > 0.3 and the ratio log_prob turns class probabilities
straight into densities, so both need CALIBRATED probabilities. Synthetic
tasks with a known P(y = 1 | x) (logistic and random-MLP links) give the
label-based reliability curve and ECE, and the direct error E|p̂ − p_true|.

The tasks are drawn from a ``torch.Generator`` (``binary_task``); the
scoring (``score_binary``, ``score_multiclass``) takes given tasks, so that
another package's draws can be scored the same way.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..models import regressor
from ..models.regressor import TabICAModel


def reliability_curve(p_hat, y, bins: int = 15) -> Dict:
    """Equal-width reliability bins over predicted P(y = 1)."""
    p_hat = np.asarray(p_hat, np.float64)
    y = np.asarray(y, np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    idx = np.clip(np.digitize(p_hat, edges[1:-1]), 0, bins - 1)
    conf, acc, frac = [], [], []
    for b in range(bins):
        m = idx == b
        if m.sum() == 0:
            conf.append(np.nan)
            acc.append(np.nan)
            frac.append(0.0)
        else:
            conf.append(float(p_hat[m].mean()))
            acc.append(float(y[m].mean()))
            frac.append(float(m.mean()))
    return {"confidence": conf, "empirical": acc, "fraction": frac, "edges": edges.tolist()}


def ece(p_hat, y, bins: int = 15) -> float:
    """Expected calibration error: bin-mass-weighted |confidence − accuracy|."""
    curve = reliability_curve(p_hat, y, bins)
    out = 0.0  # a plain running sum, as the JAX package's (not sum()'s compensated one)
    for c, a, f in zip(curve["confidence"], curve["empirical"], curve["fraction"]):
        if f > 0:
            out += f * abs(c - a)
    return float(out)


def binary_task(generator: torch.Generator, n_ctx: int, n_qry: int, dim: int, link: str):
    """One binary task with known P(y = 1 | x), on the generator's device:
    (x_ctx, y_ctx, x_qry, y_qry, p_true of the queries)."""
    def randn(*shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    x = randn(n_ctx + n_qry, dim)
    if link == "logistic":
        logit = x @ (randn(dim) * (2.0 / math.sqrt(dim))) + 0.5 * randn()
    else:  # a random two-layer MLP link
        h = 16
        w1 = randn(dim, h) * (2.0 / math.sqrt(dim))
        w2 = randn(h) / math.sqrt(h)
        logit = 2.0 * (torch.tanh(x @ w1) @ w2)
    p_true = torch.sigmoid(logit)
    y = torch.bernoulli(p_true, generator=generator)
    return x[:n_ctx], y[:n_ctx], x[n_ctx:], y[n_ctx:], p_true[n_ctx:]


def _host(t):
    return np.asarray(torch.as_tensor(t).detach().cpu(), np.float64)


def score_binary(model: TabICAModel, tasks: Sequence, link: str = "logistic",
                 bins: int = 15) -> Dict:
    """Audit ``regressor.predict_proba`` on given binary tasks, each
    (x_ctx, y_ctx, x_qry, y_qry, p_true)."""
    dev = model.device
    ps, ys, pts = [], [], []
    for x_ctx, y_ctx, x_qry, y_qry, p_true in tasks:
        x_ctx, y_ctx, x_qry = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                               for a in (x_ctx, y_ctx, x_qry))
        probs = regressor.predict_proba(model, x_ctx, y_ctx, x_qry)
        ps.append(_host(probs[:, 1]))
        ys.append(_host(y_qry))
        pts.append(_host(p_true))
    p_hat, y, p_true = np.concatenate(ps), np.concatenate(ys), np.concatenate(pts)
    return {
        "link": link,
        "n": int(p_hat.size),
        "ece": ece(p_hat, y, bins),
        "mean_abs_prob_error": float(np.mean(np.abs(p_hat - p_true))),
        "brier": float(np.mean((p_hat - y) ** 2)),
        "brier_true_p": float(np.mean((p_true - y) ** 2)),  # the irreducible floor
        "curve": reliability_curve(p_hat, y, bins),
    }


def audit_binary(model: TabICAModel, generator: torch.Generator, num_tasks: int = 8,
                 n_ctx: int = 256, n_qry: int = 256, dim: int = 5, link: str = "logistic",
                 bins: int = 15) -> Dict:
    """Audit the posterior-mean binary classifier (the engine of the ratio
    log_prob and the restricted prior) on ``num_tasks`` drawn tasks."""
    tasks = [binary_task(generator, n_ctx, n_qry, dim, link) for _ in range(num_tasks)]
    return score_binary(model, tasks, link, bins)


def score_multiclass(model: TabICAModel, tasks: Sequence, num_classes: int,
                     bins: int = 15) -> Dict:
    """Audit ``regressor.predict_proba_multiclass`` on given tasks, each
    (x_ctx, labels_ctx, x_qry, labels_qry): top-class ECE and accuracy."""
    dev = model.device
    confs, hits, accs = [], [], []
    for x_ctx, l_ctx, x_qry, l_qry in tasks:
        probs = regressor.predict_proba_multiclass(
            model, torch.as_tensor(x_ctx, dtype=torch.float32, device=dev),
            torch.as_tensor(l_ctx, device=dev), torch.as_tensor(x_qry, dtype=torch.float32,
                                                                device=dev), num_classes)
        conf, pred = (_host(t) for t in probs.max(dim=-1))
        hit = (pred == _host(l_qry)).astype(np.float64)
        confs.append(conf)
        hits.append(hit)
        accs.append(float(hit.mean()))
    conf, hit = np.concatenate(confs), np.concatenate(hits)
    return {
        "num_classes": num_classes,
        "n": int(conf.size),
        "accuracy": float(np.mean(accs)),
        "top_class_ece": ece(conf, hit, bins),
        "curve": reliability_curve(conf, hit, bins),
    }


def audit_multiclass(model: TabICAModel, generator: torch.Generator, num_tasks: int = 4,
                     n_ctx: int = 256, n_qry: int = 256, dim: int = 5, num_classes: int = 3,
                     bins: int = 15) -> Dict:
    """Audit ``predict_proba_multiclass`` on tasks with softmax ground truth."""
    tasks = []
    for _ in range(num_tasks):
        x = torch.randn((n_ctx + n_qry, dim), generator=generator, device=generator.device)
        w = torch.randn((dim, num_classes), generator=generator,
                        device=generator.device) * (2.0 / math.sqrt(dim))
        labels = torch.multinomial(torch.softmax(x @ w, dim=-1), 1, generator=generator)[:, 0]
        tasks.append((x[:n_ctx], labels[:n_ctx], x[n_ctx:], labels[n_ctx:]))
    return score_multiclass(model, tasks, num_classes, bins)
