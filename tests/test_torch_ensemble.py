"""Port parity for context and order ensembles in the autoregressive sampler
and scorer, vs npe_pfn_tpu (f32, CPU); tests/test_torch_transforms.py holds
the transforms without ensembles.

Deterministic outputs (``autoregressive_log_prob_ensemble`` under every
transform spec, the order-ensemble mixture) are held to rtol 1e-4 / atol 1e-4, the
``test_torch_estimator.py`` tolerance; the context split is exact. Samples
are held by distribution: per-dimension two-sample KS against JAX's samples
from the same model and context, p > 1e-3 for each dimension.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import logsumexp

from npe_pfn_tpu import estimator as je
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch import estimator as te
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
SPECS = ["zscore", "quantile", "zscore+featq", "quantile+featq"]
DX, DTH = 6, 4  # widths 8, 8, 8, 16: prefix slicing is active


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=16, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    return jm, port_model(jm)


def _sims(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, DTH)).astype(np.float32)
    theta[:, 1] = np.where(rng.random(n) < 0.5, -2.0, 2.0) + 0.2 * theta[:, 1]  # bimodal
    a = rng.standard_normal((DTH, DX)).astype(np.float32) / np.sqrt(DTH)
    x = (theta @ a + 0.3 * rng.standard_normal((n, DX))).astype(np.float32)
    return theta, x


def _eval_rows(q, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, DX)).astype(np.float32),
            (1.5 * rng.standard_normal((q, DTH))).astype(np.float32))


def test_split_context_ensemble_is_exact():
    theta, x = _sims(130)
    cm = np.arange(130) < 120
    ref = je.split_context_ensemble(jnp.asarray(theta), jnp.asarray(x), jnp.asarray(cm), 4)
    out = te.split_context_ensemble(t(theta), t(x), t(cm), 4)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # leading context dims (the per-observation contexts of sample_batched_filtered)
    batched = te.split_context_ensemble(t(theta)[None].expand(3, -1, -1), t(x)[None].expand(
        3, -1, -1), t(cm)[None].expand(3, -1), 4)
    for a, b in zip(batched, out):
        assert a.shape == (3,) + b.shape
        np.testing.assert_array_equal(a[2].numpy(), b.numpy())


@pytest.mark.parametrize("spec", SPECS)
def test_autoregressive_log_prob_ensemble_matches_jax(models, spec):
    jm, tm = models
    theta, x = _sims(128, seed=2)
    cm = np.arange(128) < 116
    xq, th_eval = _eval_rows(64, seed=3)
    tc, xc, cmm = je.split_context_ensemble(jnp.asarray(theta), jnp.asarray(x),
                                            jnp.asarray(cm), 3)
    ref = np.asarray(je.autoregressive_log_prob_ensemble(jm, tc, xc, cmm, xq, th_eval,
                                                         qry_chunk=32, target_transform=spec))
    members = te.split_context_ensemble(t(theta), t(x), t(cm), 3)
    out = te.autoregressive_log_prob_ensemble(tm, *members, t(xq), t(th_eval), qry_chunk=32,
                                              target_transform=spec)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_order_ensemble_log_prob_matches_jax_over_port_orders(models):
    """NPEPFN(num_order_ensembles=3).log_prob is the logsumexp mixture over
    the port's own orders: the same orders handed to JAX's
    autoregressive_log_prob(dim_order=...) give the same mixture."""
    jm, tm = models
    theta, x = _sims(200, seed=4)
    x_o = x[0] + 0.05
    th_eval = _eval_rows(40, seed=5)[1]
    est = NPEPFN(model=tm, filter_context_size=256, qry_chunk=32, num_order_ensembles=3,
                 target_transform="quantile")
    est.append_simulations(t(theta), t(x))
    orders = est._dim_orders(DTH)
    assert [o.tolist() for o in orders] == [o.tolist() for o in est._dim_orders(DTH)]
    assert orders[0].tolist() == list(range(DTH)) and len({tuple(o.tolist()) for o in orders}) == 3
    out = est.log_prob(t(th_eval), t(x_o))
    tc, xc, cm = (np.asarray(a) for a in est.get_context(t(x_o)))
    xq = np.broadcast_to(x_o, (64, DX))
    th_pad = np.concatenate([th_eval, np.zeros((24, DTH), np.float32)])
    lps = [np.asarray(je.autoregressive_log_prob(jm, tc, xc, cm, xq, th_pad, qry_chunk=32,
                                                 target_transform="quantile",
                                                 dim_order=jnp.asarray(o.numpy())))[:40]
           for o in orders]
    ref = logsumexp(np.stack(lps), axis=0) - np.log(3)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _ks_all_dims(a, b):
    for d in range(a.shape[1]):
        p = stats.ks_2samp(a[:, d], b[:, d]).pvalue
        assert p > 1e-3, (d, p)


@pytest.mark.parametrize("spec,members", [("quantile+featq", 3), ("zscore", 2)])
def test_samples_match_jax_in_distribution(models, spec, members):
    """NPEPFN.sample with context ensembles against JAX's ensemble sampler
    on the same model and (unfiltered) context."""
    check_samples(models, spec, members)


def check_samples(models, spec, members):
    """NPEPFN.sample in one transform and ensemble mode against JAX's
    sampler for that mode on the same model and (unfiltered) context, and
    the draw's log-probs against the scorer's."""
    jm, tm = models
    theta, x = _sims(128, seed=6)
    x_o = x[3] + 0.1
    n = 768
    target, featq = spec.split("+")[0], spec.endswith("+featq")
    est = NPEPFN(model=tm, filter_context_size=256, qry_chunk=256, num_ensembles=members,
                 target_transform=target, feature_transform="quantile" if featq else "none",
                 seed=2)
    est.append_simulations(t(theta), t(x))
    assert est.target_transform == spec
    ts, lp = est.sample(n, t(x_o), return_log_probs=True)
    assert ts.shape == (n, DTH) and torch.isfinite(lp).all()
    ctx = tuple(jnp.asarray(a.numpy()) for a in est.get_context(t(x_o)))
    xq = np.broadcast_to(x_o, (n, DX))
    if members > 1:
        js = je.autoregressive_sample_ensemble(jm, *je.split_context_ensemble(*ctx, members), xq,
                                               jax.random.PRNGKey(1), 256, spec)[0]
    else:
        js = je.autoregressive_sample(jm, *ctx, xq, jax.random.PRNGKey(1), 256, spec)[0]
    _ks_all_dims(ts.numpy(), np.asarray(js))
    # the draw's log-probs are the density the scorer gives the same rows
    np.testing.assert_allclose(lp.numpy(), est.log_prob(ts, t(x_o)).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_order_ensemble_samples_match_jax_in_distribution(models):
    """Order-ensembled samples against JAX's autoregressive_sample along the
    port's orders, an equal share each (the same mixture)."""
    jm, tm = models
    theta, x = _sims(128, seed=7)
    x_o = x[5]
    est = NPEPFN(model=tm, filter_context_size=256, qry_chunk=256, num_order_ensembles=2,
                 seed=3)
    est.append_simulations(t(theta), t(x))
    ts = est.sample(768, t(x_o)).numpy()
    tc, xc, cm = (np.asarray(a) for a in est.get_context(t(x_o)))
    xq = np.broadcast_to(x_o, (512, DX))  # 2 x 512 JAX rows against 768 of the port
    js = np.concatenate([np.asarray(je.autoregressive_sample(
        jm, tc, xc, cm, xq, jax.random.PRNGKey(k), qry_chunk=256,
        dim_order=jnp.asarray(o.numpy()))[0]) for k, o in enumerate(est._dim_orders(DTH))])
    _ks_all_dims(ts, js)
