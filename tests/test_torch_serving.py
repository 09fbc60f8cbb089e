"""Port parity for the serving layer: npe_pfn_tpu_torch.serving.CachedPosterior
vs npe_pfn_tpu.serving.CachedPosterior and vs the port's own estimator (f32,
CPU), under every transform spec.

Tolerances: ``CachedPosterior.log_prob`` against JAX's and against the
port's ``NPEPFN.log_prob`` on the same context at rtol 1e-4 / atol 1e-4 (the
``test_torch_estimator.py`` tolerance; the cache runs every dimension at the
full width, the estimator slices prefix widths, which is exact up to f32
rounding). Samples: per-dimension two-sample KS against ``NPEPFN.sample``,
p > 1e-3, and each draw's log-prob against ``log_prob`` of the same rows.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu import serving as jserving
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN, serving
from npe_pfn_tpu_torch.models import transformer
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
DX, DTH = 6, 4


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=16, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    return jm, port_model(jm)


def _sims(n=300, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, DTH)).astype(np.float32)
    a = rng.standard_normal((DTH, DX)).astype(np.float32) / np.sqrt(DTH)
    return theta, (theta @ a + 0.3 * rng.standard_normal((n, DX))).astype(np.float32)


@pytest.mark.parametrize("target,feature", [("zscore", "none"), ("quantile", "none"),
                                            ("zscore", "quantile"), ("quantile", "quantile")])
def test_cached_log_prob_matches_jax_and_estimator(models, target, feature):
    """Nearest 128 of 300 simulations (a deterministic filter) in both."""
    jm, tm = models
    theta, x = _sims()
    th_eval = (1.2 * np.random.default_rng(1).standard_normal((70, DTH))).astype(np.float32)
    kw = dict(filter_context_size=128, qry_chunk=32, target_transform=target,
              feature_transform=feature)
    ref = JaxNPEPFN(model=jm, **kw)
    ref.append_simulations(theta, x)
    want = np.asarray(jserving.CachedPosterior(ref, x[2], rng=jax.random.PRNGKey(0))
                      .log_prob(th_eval))
    est = NPEPFN(model=tm, **kw)
    est.append_simulations(t(theta), t(x))
    cp = serving.CachedPosterior(est, t(x[2]))
    got = cp.log_prob(t(th_eval))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), est.log_prob(t(th_eval), t(x[2])).numpy(), **TOL)


def test_precompute_encodes_all_dims_in_one_batched_call(models, monkeypatch):
    """The dθ encodings are one encode_context call with a leading [dθ] axis."""
    _, tm = models
    theta, x = _sims()
    est = NPEPFN(model=tm, filter_context_size=128, qry_chunk=32)
    est.append_simulations(t(theta), t(x))
    shapes = []
    encode = transformer.encode_context
    monkeypatch.setattr(transformer, "encode_context",
                        lambda cfg, p, xc, *a: shapes.append(tuple(xc.shape)) or encode(cfg, p,
                                                                                          xc, *a))
    cp = serving.CachedPosterior(est, t(x[0]))
    assert shapes == [(DTH, 128, 16)]
    assert cp.caches.cache[0][0].shape[:3] == (DTH, 17, 128)


@pytest.mark.parametrize("target,feature", [("zscore", "none"), ("quantile", "quantile")])
def test_cached_sample_matches_sample_in_distribution(models, target, feature):
    _, tm = models
    theta, x = _sims(seed=2)
    est = NPEPFN(model=tm, filter_context_size=128, qry_chunk=256, target_transform=target,
                 feature_transform=feature, seed=1)
    est.append_simulations(t(theta), t(x))
    cp = serving.CachedPosterior(est, t(x[5]))
    s, lp = cp.sample(1000, generator=torch.Generator().manual_seed(3), return_log_probs=True)
    assert s.shape == (1000, DTH) and lp.shape == (1000,)
    np.testing.assert_allclose(lp.numpy(), cp.log_prob(s).numpy(), **TOL)
    ref = est.sample(1000, t(x[5]), generator=torch.Generator().manual_seed(4))
    for d in range(DTH):
        p = stats.ks_2samp(s[:, d].numpy(), ref[:, d].numpy()).pvalue
        assert p > 1e-3, (d, p)
