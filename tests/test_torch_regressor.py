"""Port parity: the regressor interface vs npe_pfn_tpu's (f32, CPU).

Context statistics and normalization to 1e-6; fit_encode + predict_logits
and log_prob_y to rtol 1e-4 / atol 2e-5 (the transformer's tolerance);
sample_y by its first two moments against the bar distribution's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.models import regressor as jr
from npe_pfn_tpu_torch.models import bar_distribution as tbar
from npe_pfn_tpu_torch.models import regressor as tr
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(3), cfg)
    jm = jm.replace(temperature=jax.numpy.asarray(1.3, jax.numpy.float32))
    return jm, port_model(jm)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((50, 8)) + 1.0).astype(np.float32)
    x[:, 5] = 2.0  # a context-constant feature (sd floored at 1e-6)
    y = (0.5 * x[:, 0] + rng.standard_normal(50)).astype(np.float32)
    xq = (3.0 * rng.standard_normal((12, 8))).astype(np.float32)
    xq[0, 5] = 50.0  # far outside the context: clipped at ±12
    return x, y, xq, np.arange(50) < 44, np.arange(8) < 7


def test_stats_and_normalization_match(models):
    x, y, xq, cm, _ = _data()
    js = jr.compute_stats(x, y, cm)
    ts = tr.compute_stats(t(x), t(y), t(cm))
    for name in ("mu_x", "sd_x", "mu_y", "sd_y"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tr.normalize_x(ts, t(xq)).numpy(),
                               np.asarray(jr.normalize_x(js, xq)), rtol=1e-5, atol=1e-5)
    assert tr.normalize_x(ts, t(xq)).abs().max() == 12.0
    np.testing.assert_allclose(tr.normalize_y(ts, t(y)[None]).numpy(),
                               np.asarray(jr.normalize_y(js, y[None])), rtol=1e-5, atol=1e-5)


def test_fit_predict_and_log_prob_match(models):
    jm, tm = models
    x, y, xq, cm, fm = _data(1)
    jf = jr.fit_encode(jm, x, y, fm, cm)
    ref = np.asarray(jr.predict_logits(jm, jf, xq))
    tf = tr.fit_encode(tm, t(x), t(y), t(fm), t(cm))
    out = tr.predict_logits(tm, tf, t(xq))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    yq = np.random.default_rng(2).standard_normal(12).astype(np.float32) * 3
    ref_lp = np.asarray(jr.log_prob_y(jm, jf, ref, yq))
    np.testing.assert_allclose(tr.log_prob_y(tm, tf, out, t(yq)).numpy(), ref_lp, **TOL)


def test_flash_on_matches_dense(models):
    _, tm = models
    x, y, xq, cm, fm = _data(2)
    on = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, flash="on"))
    a = tr.predict_logits(tm, tr.fit_encode(tm, t(x), t(y), t(fm), t(cm)), t(xq))
    b = tr.predict_logits(on, tr.fit_encode(on, t(x), t(y), t(fm), t(cm)), t(xq))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_sample_y_moments(models):
    """sample_y draws in the original space: the mean of 100k draws of one
    row against the bar distribution's mean, mapped to that space, to 3
    standard errors."""
    _, tm = models
    x, y, xq, cm, fm = _data(3)
    tf = tr.fit_encode(tm, t(x), t(y), t(fm), t(cm))
    logits = tr.predict_logits(tm, tf, t(xq[:1])).expand(100_000, -1).contiguous()
    g = torch.Generator().manual_seed(1)
    s = tr.sample_y(g, tm, tf, logits).double()
    mu = float(tbar.mean(tm.borders, logits[:1])[0]) * float(tf.stats.sd_y) + float(tf.stats.mu_y)
    se = float(s.std()) / np.sqrt(s.numel())
    assert abs(float(s.mean()) - mu) < 3 * se
