"""Port parity: RestrictedPrior vs npe_pfn_tpu's (the shipped checkpoint in f32, CPU).

Given the same balanced classifier context (JAX's, handed across), the
accept mask and the unnormalized log_prob agree with JAX's: the classifier
probabilities to rtol 1e-3 / atol 2e-5 (tests/test_golden.py's f32
tolerance), the mask wherever the probability is more than 1e-3 from the
accept threshold. The context builder takes the same class-balanced counts.
Samples are held by distribution: per-dim KS p > 0.01 between the two
packages' draws. ``last_diagnostics`` records the rounds that ``sample``
drew, which chip_smoke.py checks the kernel launches against.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu import distributions as jd
from npe_pfn_tpu.models import checkpoint as jckpt
from npe_pfn_tpu.models import regressor as jr
from npe_pfn_tpu.restricted_prior import RestrictedPrior as JaxRestrictedPrior
from npe_pfn_tpu_torch import distributions as td
from npe_pfn_tpu_torch.models import regressor as tr
from npe_pfn_tpu_torch.restricted_prior import RestrictedPrior
from torch_parity import SHIPPED, port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=2e-5)
DIM, THRESHOLD = 2, 0.3


@pytest.fixture(scope="module")
def models():
    """The shipped checkpoint in f32: a classifier that tells the disc apart."""
    jm = jckpt.load(SHIPPED)
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, dtype="float32",
                                                         scores_dtype="float32"))
    return jm, port_model(jm)


def _labelled(n=160, seed=0):
    """θ on [-2, 2]² labelled 1 inside the disc of radius 1."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-2.0, 2.0, (n, DIM)).astype(np.float32)
    return theta, (np.linalg.norm(theta, axis=1) < 1.0).astype(np.float32)


def _pair(models, theta, labels, max_context=64, batch_size=256):
    jm, tm = models
    low, high = -2.0 * np.ones(DIM, np.float32), 2.0 * np.ones(DIM, np.float32)
    jrp = JaxRestrictedPrior(jd.BoxUniform(jnp.asarray(low), jnp.asarray(high)), model=jm,
                             accept_threshold=THRESHOLD, max_context=max_context,
                             batch_size=batch_size, seed=0)
    trp = RestrictedPrior(td.BoxUniform(t(low), t(high)), model=tm,
                          accept_threshold=THRESHOLD, max_context=max_context,
                          batch_size=batch_size, seed=0, device="cpu")
    jrp.append_simulations(jnp.asarray(theta), jnp.asarray(labels))
    trp.append_simulations(t(theta), t(labels))
    return jrp, trp


def test_context_is_class_balanced_like_jax(models):
    """Up to max_context // 2 positives, negatives up to max_context, drawn
    from the accumulated θ; a second round accumulates."""
    theta, labels = _labelled()
    jrp, trp = _pair(models, theta, labels)
    for rp in (jrp, trp):
        assert np.asarray(rp._ctx_theta).shape == (64, DIM)
    assert float(trp._ctx_labels.sum()) == float(jnp.sum(jrp._ctx_labels))
    rows = {tuple(r) for r in theta}
    assert all(tuple(r) in rows for r in trp._ctx_theta.numpy())
    np.testing.assert_array_equal(
        trp._ctx_labels.numpy(), (np.linalg.norm(trp._ctx_theta.numpy(), axis=1) < 1.0))
    theta2, labels2 = _labelled(seed=1)
    jrp.append_simulations(jnp.asarray(theta2), jnp.asarray(labels2))
    trp.append_simulations(t(theta2), t(labels2))
    assert trp._theta.shape == (320, DIM) == np.asarray(jrp._theta).shape
    assert float(trp._ctx_labels.sum()) == float(jnp.sum(jrp._ctx_labels))


def test_accept_mask_and_log_prob_match_given_jax_context(models):
    theta, labels = _labelled()
    jrp, trp = _pair(models, theta, labels)
    trp._ctx_theta, trp._ctx_labels = t(jrp._ctx_theta), t(jrp._ctx_labels)
    q = np.random.default_rng(3).uniform(-2.0, 2.0, (200, DIM)).astype(np.float32)
    p_j = np.asarray(jr.predict_proba(jrp.model, jrp._ctx_theta, jrp._ctx_labels,
                                      jnp.asarray(q)))[..., 1]
    p_t = tr.predict_proba(trp.model, trp._ctx_theta, trp._ctx_labels, t(q))[..., 1].numpy()
    np.testing.assert_allclose(p_t, p_j, **TOL)
    clear = np.abs(p_j - THRESHOLD) > 1e-3
    acc_j = np.asarray(jrp.accept_reject_fn(jnp.asarray(q)))
    acc_t = trp.accept_reject_fn(t(q)).numpy()
    assert 0 < acc_j.sum() < acc_j.size  # the mask is not trivial
    np.testing.assert_array_equal(acc_t[clear], acc_j[clear])
    lp_j = np.asarray(jrp.log_prob(jnp.asarray(q)))
    lp_t = trp.log_prob(t(q)).numpy()
    np.testing.assert_allclose(lp_t[clear], lp_j[clear], **TOL)
    assert np.isneginf(lp_t[~acc_t]).all()
    np.testing.assert_array_equal(trp.support_check(t(q)).numpy(), acc_t)


def test_samples_match_jax_by_distribution(models):
    theta, labels = _labelled()
    jrp, trp = _pair(models, theta, labels)
    trp._ctx_theta, trp._ctx_labels = t(jrp._ctx_theta), t(jrp._ctx_labels)
    s_j = np.asarray(jrp.sample(jax.random.PRNGKey(4), (512,)))
    s_t = trp.sample(torch.Generator().manual_seed(4), (512,)).numpy()
    assert s_t.shape == (512, DIM) and trp.accept_reject_fn(t(s_t)).all()
    assert trp.last_diagnostics["padded"] == 0
    for d in range(DIM):
        assert stats.ks_2samp(s_t[:, d], s_j[:, d]).pvalue > 0.01, d


def test_last_diagnostics_count_rounds_and_padding(models, monkeypatch):
    """The rounds recorded are the rounds of candidates classified; when no
    candidate is accepted, every round is drawn and all rows are padded."""
    theta, labels = _labelled()
    _, trp = _pair(models, theta, labels, batch_size=64)
    calls = []
    fn = trp.accept_reject_fn
    monkeypatch.setattr(trp, "accept_reject_fn", lambda th: calls.append(1) or fn(th))
    trp.sample(torch.Generator().manual_seed(5), (100,))
    assert trp.last_diagnostics["rounds"] == len(calls) >= 2
    assert trp.last_diagnostics["padded"] == 0
    trp.accept_threshold, trp.max_iters = 1.5, 3
    calls.clear()
    out = trp.sample(torch.Generator().manual_seed(6), (10,))
    assert trp.last_diagnostics == {"rounds": 3, "padded": 10} and len(calls) == 3
    assert out.shape == (10, DIM) and trp.prior.support_check(out).all()
