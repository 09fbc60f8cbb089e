"""Port parity: MultivariateNormal, Logistic, TruncatedByBounds,
LogitBoxBijection and intersect_boxes of npe_pfn_tpu_torch.distributions
against npe_pfn_tpu's, on the same numpy inputs.

log_prob, support checks, bounds and the bijection (forward, inverse,
log-det) at rtol 1e-6 (atol 1e-6 where values cross 0); the bijection's
round trip at 1e-5 (the logit's slope near the box edges); samples by
distribution (per-dim two-sample KS p > 1e-3 against JAX's draws), and
truncated draws all inside their box.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from npe_pfn_tpu import distributions as jd
from npe_pfn_tpu_torch import distributions as td
from torch_parity import t

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
KS_P = 1e-3


def _ks_same(a, b):
    p = [scipy.stats.ks_2samp(a[:, d], b[:, d]).pvalue for d in range(a.shape[1])]
    assert min(p) > KS_P, p


def _points(d, n=64, scale=3.0, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


def test_multivariate_normal():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((3, 3)).astype(np.float32) * 2
    loc = np.array([1.0, -2.0, 0.5], np.float32)
    cov = (s @ s.T + np.eye(3, dtype=np.float32)).astype(np.float32)
    jm, tm = jd.MultivariateNormal(jnp.asarray(loc), jnp.asarray(cov)), td.MultivariateNormal(
        t(loc), t(cov))
    x = _points(3)
    assert tm.event_dim == 3
    np.testing.assert_allclose(tm.log_prob(t(x)).numpy(), np.asarray(jm.log_prob(x)), rtol=1e-5)
    np.testing.assert_allclose(tm.log_prob(t(x.reshape(4, 16, 3))).numpy(),
                               np.asarray(jm.log_prob(x)).reshape(4, 16), rtol=1e-5)
    np.testing.assert_array_equal(tm.support_check(t(x)).numpy(),
                                  np.asarray(jm.support_check(x)))
    assert tm.bounds() is None
    draws = tm.sample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000, 3)
    _ks_same(draws.numpy(), np.asarray(jm.sample(jax.random.PRNGKey(0), (4000,))))


def test_logistic():
    loc, scale = np.array([0.0, 1.5], np.float32), np.array([2.0, 0.5], np.float32)
    jl, tl = jd.Logistic(jnp.asarray(loc), jnp.asarray(scale)), td.Logistic(t(loc), t(scale))
    x = _points(2, scale=10.0)
    np.testing.assert_allclose(tl.log_prob(t(x)).numpy(), np.asarray(jl.log_prob(x)), **TOL)
    np.testing.assert_allclose(tl.log_prob(t(x)).numpy(),
                               scipy.stats.logistic.logpdf(x, loc, scale).sum(-1), rtol=1e-5)
    np.testing.assert_array_equal(tl.support_check(t(x)).numpy(), np.asarray(jl.support_check(x)))
    draws = tl.sample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000, 2) and bool(torch.isfinite(draws).all())
    _ks_same(draws.numpy(), np.asarray(jl.sample(jax.random.PRNGKey(0), (4000,))))


@pytest.mark.parametrize("base_kind", ["normal", "mvn"])
def test_truncated_by_bounds(base_kind):
    low, high = np.array([0.0, -0.5], np.float32), np.array([1.0, 2.0], np.float32)
    if base_kind == "normal":
        args = (np.zeros(2, np.float32), np.ones(2, np.float32))
        jb, tb = jd.Normal(*map(jnp.asarray, args)), td.Normal(*map(t, args))
    else:
        cov = np.array([[1.0, 0.6], [0.6, 2.0]], np.float32)
        jb = jd.MultivariateNormal(jnp.zeros(2), jnp.asarray(cov))
        tb = td.MultivariateNormal(torch.zeros(2), t(cov))
    jt = jd.TruncatedByBounds(base=jb, low=jnp.asarray(low), high=jnp.asarray(high))
    tt = td.TruncatedByBounds(tb, t(low), t(high))
    x = _points(2, scale=1.0)
    want = np.asarray(jt.log_prob(x))
    got = tt.log_prob(t(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], rtol=1e-5)
    np.testing.assert_array_equal(tt.support_check(t(x)).numpy(), np.asarray(jt.support_check(x)))
    for a, b in zip(tt.bounds(), jt.bounds()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tt.event_dim == 2
    draws = tt.sample(torch.Generator().manual_seed(0), (3000,))
    assert bool(tt.support_check(draws).all())
    _ks_same(draws.numpy(), np.asarray(jt.sample(jax.random.PRNGKey(0), (3000,))))


def test_truncated_stragglers_are_clamped():
    """A box the base almost never reaches: after 32 rounds the draws still
    outside are clamped to it, as in the JAX package."""
    base = td.Normal(torch.zeros(1), torch.ones(1))
    tt = td.TruncatedByBounds(base, torch.tensor([6.0]), torch.tensor([7.0]))
    draws = tt.sample(torch.Generator().manual_seed(0), (100,))
    assert bool(((draws >= 6.0) & (draws <= 7.0)).all())
    assert bool((draws == 6.0).all())


def test_logit_box_bijection():
    low, high = np.array([-1.0, 0.0, 2.0], np.float32), np.array([1.0, 45.0, 2.5], np.float32)
    jb = jd.LogitBoxBijection(low=jnp.asarray(low), high=jnp.asarray(high))
    tb = td.LogitBoxBijection(t(low), t(high))
    u = np.random.default_rng(3).uniform(0.001, 0.999, (64, 3)).astype(np.float32)
    theta = (low + u * (high - low)).astype(np.float32)
    theta[0] = low  # the edges, where the clamp acts
    theta[1] = high
    z = tb.forward(t(theta))
    np.testing.assert_allclose(z.numpy(), np.asarray(jb.forward(theta)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tb.inverse(z).numpy(), np.asarray(jb.inverse(np.asarray(z))),
                               **TOL)
    np.testing.assert_allclose(tb.forward_log_det(t(theta)).numpy(),
                               np.asarray(jb.forward_log_det(theta)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tb.inverse(z).numpy()[2:], theta[2:], rtol=1e-5, atol=1e-5)
    # The pushforward of the box-uniform is Logistic(0, 1) per dim.
    box = td.BoxUniform(t(low), t(high))
    zs = tb.forward(box.sample(torch.Generator().manual_seed(1), (4000,)))
    logistic = td.Logistic(torch.zeros(3), torch.ones(3))
    _ks_same(zs.numpy(), logistic.sample(torch.Generator().manual_seed(2), (4000,)).numpy())


def test_intersect_boxes():
    a = np.array([-1.0, 0.0], np.float32), np.array([1.0, 3.0], np.float32)
    lo, hi = np.array([-0.5, -1.0], np.float32), np.array([2.0, 2.0], np.float32)
    want = jd.intersect_boxes(jd.BoxUniform(*map(jnp.asarray, a)), jnp.asarray(lo),
                              jnp.asarray(hi))
    got = td.intersect_boxes(td.BoxUniform(*map(t, a)), t(lo), t(hi))
    assert isinstance(got, td.BoxUniform)
    np.testing.assert_array_equal(got.low.numpy(), np.asarray(want.low))
    np.testing.assert_array_equal(got.high.numpy(), np.asarray(want.high))
    got = td.intersect_boxes(td.BoxUniform(*map(t, a)), lo, hi)  # numpy bounds
    np.testing.assert_array_equal(got.high.numpy(), np.asarray(want.high))
