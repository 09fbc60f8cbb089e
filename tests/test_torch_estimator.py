"""Port parity for the whole slice: autoregressive scoring and sampling, and
``NPEPFN.sample`` with its rejection loop, vs npe_pfn_tpu (f32, CPU).

Deterministic outputs are held to rtol 1e-4 / atol 1e-4 (sums of ~10
per-dimension log densities, each at the transformer's tolerance). Samples
are held by distribution: per-dimension two-sample KS against JAX's samples
from the same model and context, p > 1e-3 for each dimension.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu import estimator as je
from npe_pfn_tpu.distributions import BoxUniform as JaxBox
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch import estimator as te
from npe_pfn_tpu_torch.distributions import BoxUniform
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=32, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    return jm, port_model(jm)


def _sims(n, dth, dx, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, dth)).astype(np.float32)
    a = rng.standard_normal((dth, dx)).astype(np.float32) / np.sqrt(dth)
    x = (theta @ a + 0.5 * rng.standard_normal((n, dx))).astype(np.float32)
    return theta, x


def test_step_widths_and_masks_match_jax(models):
    jm, tm = models
    for dx, dth in [(10, 10), (10, 8), (14, 4), (10, 3), (4, 3)]:
        f = te._eff_features(tm, dx, dth)
        assert f == je._eff_features(jm, dx, dth)
        order = np.arange(dth)
        np.testing.assert_array_equal(
            te._order_prefix_masks(torch.arange(dth), dx, f).numpy(),
            np.asarray(je._order_prefix_masks(jnp.asarray(order), dx, f)))
    # the bench shape: steps 0-6 at width 16 (T 17), steps 7-9 at 24 (T 25)
    assert te._step_widths(10, 10, 24, None, None) == [16] * 7 + [24] * 3
    assert te._step_widths(10, 10, 24, None, 24) == [24] * 10
    perm = torch.tensor([2, 0, 1])
    np.testing.assert_array_equal(
        te._order_prefix_masks(perm, 4, 8).numpy(),
        np.asarray(je._order_prefix_masks(jnp.asarray([2, 0, 1]), 4, 8)))


@pytest.mark.parametrize("dx,dth", [(10, 8), (14, 4)])
def test_autoregressive_log_prob_matches_jax(models, dx, dth):
    """Prefix-width slicing is active at both shapes (widths 16 then 24)."""
    jm, tm = models
    theta, x = _sims(128, dth, dx)
    cm = np.arange(128) < 120
    rng = np.random.default_rng(1)
    xq = rng.standard_normal((64, dx)).astype(np.float32)
    th_eval = rng.standard_normal((64, dth)).astype(np.float32)
    ref = np.asarray(je.autoregressive_log_prob(jm, theta, x, cm, xq, th_eval, qry_chunk=32))
    out = te.autoregressive_log_prob(tm, t(theta), t(x), t(cm), t(xq), t(th_eval), qry_chunk=32)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    full = te.autoregressive_log_prob(tm, t(theta), t(x), t(cm), t(xq), t(th_eval),
                                      qry_chunk=32, feature_width=32)
    np.testing.assert_allclose(full.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)


def test_autoregressive_log_prob_dim_order_matches_jax(models):
    """An explicit factorization order runs every step at the full width."""
    jm, tm = models
    theta, x = _sims(96, 3, 6, seed=6)
    rng = np.random.default_rng(7)
    xq = rng.standard_normal((32, 6)).astype(np.float32)
    th_eval = rng.standard_normal((32, 3)).astype(np.float32)
    cm = np.ones(96, bool)
    order = np.array([2, 0, 1])
    ref = np.asarray(je.autoregressive_log_prob(jm, theta, x, cm, xq, th_eval, qry_chunk=32,
                                                dim_order=jnp.asarray(order)))
    out = te.autoregressive_log_prob(tm, t(theta), t(x), t(cm), t(xq), t(th_eval), qry_chunk=32,
                                     dim_order=t(order))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_sample_log_probs_score_their_own_samples(models):
    """autoregressive_sample's by-product log-probs equal
    autoregressive_log_prob of the samples it drew."""
    _, tm = models
    theta, x = _sims(128, 8, 10, seed=2)
    cm = torch.ones(128, dtype=torch.bool)
    xq = t(x[:1]).expand(64, -1).contiguous()
    g = torch.Generator().manual_seed(0)
    s, lp = te.autoregressive_sample(tm, t(theta), t(x), cm, xq, g, qry_chunk=32)
    assert s.shape == (64, 8) and torch.isfinite(s).all()
    again = te.autoregressive_log_prob(tm, t(theta), t(x), cm, xq, s, qry_chunk=32)
    np.testing.assert_allclose(lp.numpy(), again.numpy(), rtol=1e-5, atol=1e-5)


def test_npepfn_sample_matches_jax_in_distribution(models):
    jm, tm = models
    theta, x = _sims(400, 3, 5, seed=3)
    x_o = x[0] + 0.1
    n = 2048
    ref = JaxNPEPFN(model=jm, filter_context_size=256, qry_chunk=256)
    ref.append_simulations(theta, x)
    js = np.asarray(ref.sample(n, x_o, rng=jax.random.PRNGKey(1)))
    est = NPEPFN(model=tm, filter_context_size=256, qry_chunk=256, seed=1)
    est.append_simulations(t(theta), t(x))
    ts, lp, acc = est.sample(n, t(x_o), return_log_probs=True, return_acceptance_rate=True)
    assert ts.shape == (n, 3) and lp.shape == (n,) and acc == 1.0
    for d in range(3):
        assert stats.ks_2samp(ts[:, d].numpy(), js[:, d]).pvalue > 1e-3, d


def _fixed_proposals(batch, dth, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-2, 2, (batch, dth)).astype(np.float32)
    return s, (-np.arange(batch)).astype(np.float32)


@pytest.mark.parametrize("num,max_iters", [(100, 2), (100, 10), (40, 1)])
def test_rejection_loop_and_escape_hatch_match_jax(models, num, max_iters):
    """With the proposal stubbed to one fixed batch in both packages, the
    accept / partition / accumulate loop and the escape-hatch fill of
    _fused_rejection give identical rows, log-probs and acceptance."""
    jm, tm = models
    theta, x = _sims(64, 2, 3, seed=4)
    batch = 112 if num == 100 else 48  # sample() rounds num up to a qry_chunk multiple
    s, lp = _fixed_proposals(batch, 2, seed=num + max_iters)
    ref = JaxNPEPFN(prior=JaxBox(-jnp.ones(2), jnp.ones(2)), model=jm,
                    filter_context_size=64, qry_chunk=16)
    ref.append_simulations(theta, x)
    ref._raw_sample = lambda k, x_o, m, tc, xc, cm, model=None: (jnp.asarray(s), jnp.asarray(lp))
    js, jlp, jacc = ref.sample(num, x[0], rng=jax.random.PRNGKey(0), max_iters=max_iters,
                               return_log_probs=True, return_acceptance_rate=True)
    est = NPEPFN(prior=BoxUniform(-torch.ones(2), torch.ones(2)), model=tm,
                 filter_context_size=64, qry_chunk=16)
    est.append_simulations(t(theta), t(x))
    est._raw_sample = lambda g, x_o, m, tc, xc, cm: (t(s), t(lp))
    ts, tlp, tacc = est.sample(num, t(x[0]), max_iters=max_iters, return_log_probs=True,
                               return_acceptance_rate=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    assert tacc == pytest.approx(float(jacc), rel=1e-6)


def test_sample_aligns_batch_to_qry_chunk(models):
    """sample(10_240) with the 10_000 cap draws one 10_240-row batch at
    qry_chunk 2048, as the JAX estimator does (five decode chunks)."""
    _, tm = models
    est = NPEPFN(model=tm, qry_chunk=2048)
    theta, x = _sims(64, 2, 3, seed=5)
    est.append_simulations(t(theta), t(x))
    seen = []

    def stub(g, x_o, m, tc, xc, cm):
        seen.append(m)
        return torch.zeros(m, 2), torch.zeros(m)

    est._raw_sample = stub
    assert est.sample(10_240, t(x[0])).shape == (10_240, 2)
    assert seen == [10_240]
    assert est._effective_context_size == 256  # 64 sims -> 256-row granule


@pytest.mark.parametrize("kwargs", [
    dict(num_ensembles=2), dict(num_order_ensembles=2), dict(target_transform="quantile"),
    dict(feature_transform="quantile"),
])
def test_unported_options_raise(models, kwargs):
    _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NPEPFN(model=tm, **kwargs)


def test_input_validation(models):
    _, tm = models
    est = NPEPFN(model=tm)
    with pytest.raises(RuntimeError):
        est.get_context(torch.zeros(3))
    with pytest.raises(ValueError):
        est.append_simulations(torch.zeros(5, 2), torch.zeros(4, 3))
    est.append_simulations(torch.zeros(5, 2), torch.zeros(5, 3))
    with pytest.raises(ValueError):
        est.sample(10, torch.zeros(2, 3))
    with pytest.raises(ValueError):
        est.sample(10, torch.zeros(3), max_iters=0)
