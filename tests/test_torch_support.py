"""Port parity: posterior-support truncation (support.prereject_with_bounds,
PosteriorSupport in rejection and SIR modes) vs npe_pfn_tpu.support (f32, CPU).

Given the same posterior samples, the threshold (the allowed-false-negatives
quantile of their log-probs) is held to rtol 1e-3 / atol 2e-5, the box
(padded min/max, or the constrained-prior quantile box) to 1e-6; given JAX's
threshold, ``log_prob`` and ``support_check`` agree with JAX's wherever the
posterior log-prob is not within 1e-3 of it. SIR's ESS fraction and dead
groups given the same draws match JAX's to rtol 1e-5 and exactly. Draws are
held by their constraints: inside the box, above the threshold, or padded
with prior draws when the round budget runs out.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npe_pfn_tpu as jpkg
from npe_pfn_tpu import distributions as jd
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN, distributions as td, support
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=2e-5)
DTH, DX = 2, 3
LOW, HIGH = -3.0, 3.0


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(4), cfg)
    return jm, port_model(jm)


def _sims(n=200, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-2, 2, (n, DTH)).astype(np.float32)
    a = rng.standard_normal((DTH, DX)).astype(np.float32)
    return theta, (theta @ a + 0.2 * rng.standard_normal((n, DX))).astype(np.float32)


def _priors():
    lo, hi = LOW * np.ones(DTH, np.float32), HIGH * np.ones(DTH, np.float32)
    return jd.BoxUniform(jnp.asarray(lo), jnp.asarray(hi)), td.BoxUniform(t(lo), t(hi))


@pytest.fixture(scope="module")
def fitted(models):
    """Both packages' estimators on the same simulations and weights; the
    filter is deterministic (the nearest 128 rows)."""
    jm, tm = models
    theta, x = _sims()
    jprior, tprior = _priors()
    jest = jpkg.NPEPFN(prior=jprior, model=jm, filter_context_size=128, qry_chunk=64)
    jest.append_simulations(theta, x)
    test = NPEPFN(prior=tprior, model=tm, filter_context_size=128, qry_chunk=64)
    test.append_simulations(t(theta), t(x))
    return jest, test, x[3]


def _supports(fitted, **kw):
    jest, test, x_o = fitted
    jprior, tprior = _priors()
    kw = dict(num_samples_to_estimate_support=256, batch_size=512, max_iters=4, **kw)
    js = jpkg.PosteriorSupport(jprior, jest, jnp.asarray(x_o), rng=jax.random.PRNGKey(1), **kw)
    ts = support.PosteriorSupport(tprior, test, t(x_o),
                                  generator=torch.Generator().manual_seed(1), **kw)
    return js, ts


@pytest.mark.parametrize("constrained", [False, True])
def test_threshold_and_box_match_given_the_same_samples(fitted, constrained):
    kw = dict(use_constrained_prior=True, constrained_prior_quanitle=0.05) if constrained else {}
    js, ts = _supports(fitted, **kw)
    samples = np.asarray(js._posterior_samples)
    lp = ts._cached.log_prob(t(samples))
    thr, low, high = support.support_threshold_and_box(
        t(samples), lp, 1e-4, constrained, 0.05 if constrained else 0.0)
    np.testing.assert_allclose(thr, js.log_prob_threshold, **TOL)
    np.testing.assert_allclose(low.numpy(), np.asarray(js._box_low), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(high.numpy(), np.asarray(js._box_high), rtol=1e-6, atol=1e-6)
    ts._fit(t(samples), lp)  # the constructor's own step, on JAX's samples
    np.testing.assert_allclose(ts.log_prob_threshold, js.log_prob_threshold, **TOL)


def test_log_prob_and_support_check_match_given_jax_threshold(fitted):
    js, ts = _supports(fitted)
    ts.log_prob_threshold = js.log_prob_threshold
    rng = np.random.default_rng(2)
    theta = rng.uniform(-3.5, 3.5, (300, DTH)).astype(np.float32)
    post_lp = ts._posterior_log_prob(t(theta)).numpy()
    np.testing.assert_allclose(post_lp, np.asarray(js._posterior_log_prob(jnp.asarray(theta))),
                               **TOL)
    clear = np.abs(post_lp - js.log_prob_threshold) > 1e-3
    want_lp = np.asarray(js.log_prob(jnp.asarray(theta)))
    got_lp = ts.log_prob(t(theta)).numpy()
    np.testing.assert_array_equal(np.isinf(got_lp)[clear], np.isinf(want_lp)[clear])
    np.testing.assert_allclose(got_lp[clear], want_lp[clear], rtol=1e-6)
    np.testing.assert_array_equal(ts.support_check(t(theta)).numpy()[clear],
                                  np.asarray(js.support_check(jnp.asarray(theta)))[clear])
    assert 0 < np.isinf(want_lp).sum() < 300


def test_rejection_draws_lie_in_the_truncation(fitted):
    _, ts = _supports(fitted)
    s, acc = ts.sample(torch.Generator().manual_seed(3), (200,), return_acceptance_rate=True)
    assert s.shape == (200, DTH) and 0 < acc <= 1
    assert set(ts.last_diagnostics) == {"acceptance_rate", "prereject_keep_rate", "padded",
                                        "rounds"}
    assert ts.last_diagnostics["padded"] == 0 and ts.last_diagnostics["rounds"] >= 1
    assert bool(((s >= ts._box_low) & (s <= ts._box_high)).all())
    assert bool(ts.support_check(s).all())
    assert ts.sample((3,)).shape == (3, DTH) and ts.sample().shape == (DTH,)


def test_rejection_pads_with_prior_draws_past_the_budget(fitted, caplog):
    _, ts = _supports(fitted)
    ts.log_prob_threshold = 1e9  # nothing passes
    with caplog.at_level(logging.WARNING, logger="npe_pfn_tpu_torch.support"):
        s = ts.sample(torch.Generator().manual_seed(4), (50,))
    assert ts.last_diagnostics["padded"] == 50 and ts.last_diagnostics["acceptance_rate"] == 0
    assert ts.last_diagnostics["rounds"] == ts.max_iters
    assert "padding 50/50" in caplog.text
    assert bool(((s >= LOW) & (s <= HIGH)).all())


def test_sir_weights_and_ess_match_jax_given_the_same_draws(fitted):
    """JAX's _sample_sir and the port's on the same 16 x 8 draws and
    log-probs: equal ESS fraction and dead groups (rows outside the prior and
    groups below the threshold are dead), and each returned row is a member of
    its own group, a live one where the group has any."""
    js, ts = _supports(fitted, sampling_method="sir", oversample_sir=8)
    rng = np.random.default_rng(5)
    samples = rng.uniform(-2, 2, (128, DTH)).astype(np.float32)
    samples[:8] = 5.0  # group 0 outside the prior: dead
    post_lp = rng.normal(-3.0, 1.0, 128).astype(np.float32)
    post_lp[8:16] = -50.0  # group 1 below the threshold: dead
    js._cached.sample = lambda n, rng=None, return_log_probs=False: (jnp.asarray(samples),
                                                                     jnp.asarray(post_lp))
    ts._cached.sample = lambda n, generator=None, return_log_probs=False: (t(samples),
                                                                          t(post_lp))
    js.sample(jax.random.PRNGKey(0), (16,))
    out = ts.sample(torch.Generator().manual_seed(0), (16,))
    assert js.last_diagnostics["dead_groups"] == ts.last_diagnostics["dead_groups"] == 2
    np.testing.assert_allclose(ts.last_diagnostics["ess_fraction"],
                               js.last_diagnostics["ess_fraction"], rtol=1e-5)
    log_w, dead, ess = support.sir_log_weights(t(post_lp), ts.prior.log_prob(t(samples)), 1e-4,
                                               16)
    assert dead.tolist() == [True, True] + [False] * 14
    np.testing.assert_allclose(float(ess), js.last_diagnostics["ess_fraction"], rtol=1e-5)
    groups = samples.reshape(16, 8, DTH)
    for g in range(16):
        member = np.where((groups[g] == out[g].numpy()).all(-1))[0]
        assert member.size >= 1
        if g >= 2:
            assert np.isfinite(log_w[g, member[0]].item())


def test_order_ensembles_rescore_with_the_mixture(models):
    """Under order ensembles there is no cache, and the threshold reads the
    mixture density log_prob scores, not each draw's own-order density."""
    _, tm = models
    theta, x = _sims()
    est = NPEPFN(prior=_priors()[1], model=tm, filter_context_size=128, qry_chunk=64,
                 num_order_ensembles=2)
    est.append_simulations(t(theta), t(x))
    ts = support.PosteriorSupport(est.prior, est, t(x[3]), num_samples_to_estimate_support=128,
                                  generator=torch.Generator().manual_seed(6))
    assert ts._cached is None
    lp = est.log_prob(ts._posterior_samples, t(x[3]))
    np.testing.assert_allclose(ts.log_prob_threshold, float(torch.quantile(lp, 1e-4)),
                               rtol=1e-6)


def test_prereject_box_uniform_shortcut_and_rejection():
    """A BoxUniform proposal is sampled on its intersection with the box, no
    rejection (as in JAX's test_prereject_uniform_shortcut); a Normal one by
    rejection rounds, counting every draw; a box the proposal never reaches
    pads with raw proposal draws."""
    g = torch.Generator().manual_seed(7)
    lo, hi = torch.tensor([-0.5, -0.5]), torch.tensor([0.5, 0.5])
    box = td.BoxUniform(-torch.ones(2), torch.ones(2))
    s, n = support.prereject_with_bounds(g, box, 256, lo, hi, return_num_drawn=True)
    assert s.shape == (256, 2) and n == 256 and bool(((s >= lo) & (s <= hi)).all())
    normal = td.Normal(torch.zeros(2), torch.ones(2))
    # The box holds 14.7% of the normal's mass: one round of 4096 suffices,
    # rounds of 256 need about eight.
    s, n = support.prereject_with_bounds(g, normal, 300, lo, hi, batch_size=4096,
                                         return_num_drawn=True)
    assert s.shape == (300, 2) and n == 4096 and bool(((s >= lo) & (s <= hi)).all())
    s, n = support.prereject_with_bounds(g, normal, 300, lo, hi, batch_size=256,
                                         return_num_drawn=True)
    assert n % 256 == 0 and 5 * 256 <= n <= 12 * 256
    assert len({tuple(r) for r in s.tolist()}) == 300 and bool(((s >= lo) & (s <= hi)).all())
    far_lo, far_hi = torch.tensor([40.0, 40.0]), torch.tensor([41.0, 41.0])
    s, n = support.prereject_with_bounds(g, box, 10, far_lo, far_hi, batch_size=32,
                                         max_iters=2, return_num_drawn=True)
    assert n == 2 * 32 + 10 and bool(box.support_check(s).all())
    js = jpkg.prereject_with_bounds(jax.random.PRNGKey(0), jd.BoxUniform(-jnp.ones(2),
                                                                         jnp.ones(2)),
                                    10, jnp.asarray(far_lo), jnp.asarray(far_hi),
                                    batch_size=32, max_iters=2, return_num_drawn=True)
    assert js[1] == n
