"""Port parity: the ratio-based log_prob (DensityRatioEstimator and
NPEPFN.log_prob(mode="ratio_based")) vs npe_pfn_tpu's (f32, CPU).

Deterministic parts are held to rtol 1e-3 / atol 2e-5 (tests/test_golden.py's
f32 tolerance): ``ratio_log_probs`` given JAX's fitted classifier contexts
(one and two fits; inside the box and the out-of-box floor, over chunks padded
to 256 rows), and ``fit``'s box and log u given the same posterior samples.
The refit cache follows JAX's key (x, context version, sample count,
padding); pickling drops the fitted ratio state, as JAX does.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu.estimator import DensityRatioEstimator as JaxRatio
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch.distributions import BoxUniform
from npe_pfn_tpu_torch.estimator import DensityRatioEstimator
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=2e-5)
DTH, DX = 3, 4


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(2), cfg)
    return jm, port_model(jm)


def _posterior_like(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((n, DTH)) + np.array([1.0, -0.5, 0.2])).astype(np.float32)


def _sims(n=300, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, DTH)).astype(np.float32)
    a = rng.standard_normal((DTH, DX)).astype(np.float32) / np.sqrt(DTH)
    return theta, (theta @ a + 0.3 * rng.standard_normal((n, DX))).astype(np.float32)


def _jax_fitted(jm, num_fits, seed=0):
    jr = JaxRatio(jm, context_size=64, num_fits=num_fits)
    jr.fit(jax.random.PRNGKey(seed), jnp.asarray(_posterior_like()), jnp.zeros(DX), 1, 0.1)
    return jr


def _port_with(tm, jr):
    """A port estimator holding JAX's fitted contexts and box."""
    r = DensityRatioEstimator(tm, context_size=jr.context_size, num_fits=jr.num_fits)
    r._ctx_theta, r._ctx_labels = t(jr._ctx_theta), t(jr._ctx_labels)
    r._low, r._high, r._log_u = t(jr._low), t(jr._high), jr._log_u
    return r


@pytest.mark.parametrize("num_fits", [1, 2])
def test_ratio_log_probs_match_given_jax_context(models, num_fits):
    jm, tm = models
    jr = _jax_fitted(jm, num_fits)
    rng = np.random.default_rng(4)
    theta = np.concatenate([_posterior_like(290, seed=5),
                            rng.uniform(-4, 4, (10, DTH)).astype(np.float32)])  # some outside
    want = np.asarray(jr.ratio_log_probs(jnp.asarray(theta), chunk_size=128))
    got = _port_with(tm, jr).ratio_log_probs(t(theta), chunk_size=128)
    assert got.shape == (300,)
    floor = jr._log_u + np.log(1e-12) - np.log(1 + 1e-12)
    outside = np.isclose(want, floor)
    assert 0 < outside.sum() < 300
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fit_box_and_contexts_follow_jax(models):
    """Given the same posterior samples: the padded box and log u equal JAX's;
    each fit's context is 32 positives from the samples (disjoint across
    fits) and 32 uniform negatives inside the box, labelled 1 then 0."""
    jm, tm = models
    post = _posterior_like()
    jr = _jax_fitted(jm, 2)
    r = DensityRatioEstimator(tm, context_size=64, num_fits=2)
    r.fit(torch.Generator().manual_seed(0), t(post), torch.zeros(DX), 1, 0.1)
    np.testing.assert_allclose(r._low.numpy(), np.asarray(jr._low), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r._high.numpy(), np.asarray(jr._high), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r._log_u, jr._log_u, rtol=1e-6)
    assert r._ctx_theta.shape == (2, 64, DTH) and r._ctx_labels.shape == (2, 64)
    np.testing.assert_array_equal(r._ctx_labels.numpy(), np.asarray(jr._ctx_labels))
    rows = {tuple(row) for row in post.tolist()}
    pos = r._ctx_theta[:, :32].reshape(-1, DTH).tolist()
    assert all(tuple(p) in rows for p in pos) and len({tuple(p) for p in pos}) == 64
    assert bool(BoxUniform(r._low, r._high).support_check(r._ctx_theta[:, 32:]).all())


def test_log_prob_ratio_based_and_refit_cache(models):
    """The JAX test_ratio_based_log_prob_and_cache, on the port: the cache
    holds for the same x and refits for another x or new simulations; the
    out-of-box floor lies below every in-box value. A context version bump
    comes from append_simulations."""
    _, tm = models
    theta, x = _sims()
    est = NPEPFN(model=tm, filter_context_size=64, qry_chunk=32, ratio_context_size=64)
    est.append_simulations(t(theta), t(x))
    assert est._ctx_version == 1
    lp1 = est.log_prob(torch.zeros(9, DTH), t(x[0]), mode="ratio_based", num_ratio_samples=64)
    assert lp1.shape == (9,) and bool(torch.isfinite(lp1).all())
    x0 = est._one_obs(t(x[0]))
    assert not est._ratio.refit_necessary(x0, est._ctx_version, 64, 0.1)
    assert est._ratio.refit_necessary(est._one_obs(t(x[1])), est._ctx_version, 64, 0.1)
    assert est._ratio.refit_necessary(x0, est._ctx_version, 65, 0.1)
    assert est._ratio.refit_necessary(x0, est._ctx_version, 64, 0.2)
    again = est.log_prob(torch.zeros(9, DTH), t(x[0]), mode="ratio_based", num_ratio_samples=64)
    assert torch.equal(again, lp1)  # no refit, the same classifier
    est.append_simulations(t(theta), t(x))
    assert est._ctx_version == 2
    assert est._ratio.refit_necessary(x0, est._ctx_version, 64, 0.1)
    far = est.log_prob(100.0 * torch.ones(1, DTH), t(x[0]), mode="ratio_based",
                       num_ratio_samples=64)
    assert bool(torch.isfinite(far).all()) and float(far[0]) < float(lp1.min())
    jest = JaxNPEPFN(model=models[0], filter_context_size=64, qry_chunk=32,
                     ratio_context_size=64)
    jest.append_simulations(theta, x)
    assert jest._ctx_version == 1  # the same versioning as the JAX estimator


def test_log_prob_mode_default_and_unknown(models):
    _, tm = models
    theta, x = _sims()
    est = NPEPFN(model=tm, filter_context_size=64, qry_chunk=32, ratio_context_size=64,
                 log_prob_mode="ratio_based")
    est.append_simulations(t(theta), t(x))
    assert est.log_prob(t(theta[:5]), t(x[0]), num_ratio_samples=64).shape == (5,)
    assert est._ratio._cache_key is not None
    with pytest.raises(ValueError, match="unknown log_prob mode"):
        est.log_prob(t(theta[:5]), t(x[0]), mode="bogus")


def test_pickle_drops_the_ratio_state(models):
    _, tm = models
    theta, x = _sims()
    est = NPEPFN(model=tm, filter_context_size=64, qry_chunk=32, ratio_context_size=64,
                 num_ratio_fits=2)
    est.append_simulations(t(theta), t(x))
    est.log_prob(t(theta[:5]), t(x[0]), mode="ratio_based", num_ratio_samples=64)
    back = pickle.loads(pickle.dumps(est))
    assert back._ratio._cache_key is None and back._ratio._ctx_theta is None
    assert (back._ratio.context_size, back._ratio.num_fits) == (64, 2)
    assert back._ctx_version == est._ctx_version
    assert back.log_prob(t(theta[:5]), t(x[0]), mode="ratio_based",
                         num_ratio_samples=64).shape == (5,)


def test_committed_ratio_context_reads_its_cpu_log_probs():
    """scripts/torch_ratio_context.npz (chip_smoke.py phase 20 holds the
    card's reading on it to these) reproduces on the CPU: the shipped
    checkpoint's ratio_log_probs on its context give its stored log-probs,
    to 1e-4 in the classifier's probability (CPU GEMMs may sum in another
    order on another machine), and the floor rows to f32 rounding."""
    import os
    import sys

    from npe_pfn_tpu_torch import load_default

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import torch_sequential_protocols as seqcal

    assert os.path.getsize(seqcal.RATIO_CONTEXT) < 16_000
    ratio, theta, lp_cpu = seqcal.ratio_context(load_default("cpu"))
    lp = ratio.ratio_log_probs(theta)
    inside = ((theta >= ratio._low) & (theta <= ratio._high)).all(dim=-1)
    assert 0 < int(inside.sum()) < theta.shape[0]
    p, p_ref = (torch.sigmoid(a[inside] - ratio._log_u) for a in (lp, lp_cpu))
    assert (p - p_ref).abs().max().item() <= 1e-4
    torch.testing.assert_close(lp[~inside], lp_cpu[~inside], rtol=1e-5, atol=0)
