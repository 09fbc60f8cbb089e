"""Port parity: the regressor's prediction and classifier heads vs npe_pfn_tpu's
(f32, CPU): predict_mean, predict_quantiles, predict_full, predict_proba and
predict_proba_multiclass.

Deterministic outputs are held to rtol 1e-3 / atol 2e-5 (tests/test_golden.py's
f32 tolerance), on a small random model and on the shipped checkpoint in f32
at 128 context rows. The multi-class head runs its K classes as one leading
dim: one encode of ``[K, N, F]``, not K encodes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.models import checkpoint as jckpt
from npe_pfn_tpu.models import regressor as jr
from npe_pfn_tpu_torch.models import regressor as tr
from npe_pfn_tpu_torch.models import transformer
from torch_parity import SHIPPED, port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(5), cfg)
    jm = jm.replace(temperature=jax.numpy.asarray(1.2, jax.numpy.float32))
    return jm, port_model(jm)


@pytest.fixture(scope="module")
def shipped():
    jm = jckpt.load(SHIPPED)
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, dtype="float32",
                                                         scores_dtype="float32"))
    return jm, port_model(jm)


def _binary(n=120, q=40, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + q, f)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(x @ rng.standard_normal(f))))
    y = (rng.uniform(size=n + q) < p).astype(np.float32)
    return x[:n], y[:n], x[n:]


def test_predict_mean_and_quantiles_match(models):
    jm, tm = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((90, 6)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 2] + 0.3 * rng.standard_normal(90)).astype(np.float32)
    xq = rng.standard_normal((25, 6)).astype(np.float32)
    jl, jf = jr.predict_full(jm, x, y, xq)
    tl, tf = tr.predict_full(tm, t(x), t(y), t(xq))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tr.predict_mean(tm, tf, tl).numpy(),
                               np.asarray(jr.predict_mean(jm, jf, jl)), **TOL)
    qs = np.array([0.05, 0.25, 0.5, 0.9, 0.999], np.float32)
    want = np.asarray(jr.predict_quantiles(jm, jf, jl, qs))
    got = tr.predict_quantiles(tm, tf, tl, t(qs))
    assert got.shape == (25, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("which", ["small", "shipped"])
def test_predict_proba_matches(models, shipped, which):
    jm, tm = models if which == "small" else shipped
    x, y, xq = _binary(n=128 if which == "shipped" else 120)
    want = np.asarray(jr.predict_proba(jm, x, y, xq))
    got = tr.predict_proba(tm, t(x), t(y), t(xq))
    assert got.shape == (xq.shape[0], 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_predict_proba_masks_and_leading_contexts(models):
    """Masked context rows and features as in JAX; two contexts as a leading
    dim read what each reads alone."""
    jm, tm = models
    x, y, xq = _binary()
    cm, fm = np.arange(120) < 100, np.arange(5) < 4
    want = np.asarray(jr.predict_proba(jm, x, y, xq, fm, cm))
    got = tr.predict_proba(tm, t(x), t(y), t(xq), t(fm), t(cm))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    x2, y2, _ = _binary(seed=7)
    both = tr.predict_proba(tm, torch.stack([t(x), t(x2)]), torch.stack([t(y), t(y2)]),
                            t(xq).expand(2, -1, -1))
    np.testing.assert_allclose(both[0].numpy(), tr.predict_proba(tm, t(x), t(y), t(xq)).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(both[1].numpy(),
                               tr.predict_proba(tm, t(x2), t(y2), t(xq)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_predict_proba_multiclass_matches_in_one_encode(models, monkeypatch):
    jm, tm = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((150, 5)).astype(np.float32)
    labels = np.argmax(x[:, :3] + 0.5 * rng.standard_normal((150, 3)), axis=1).astype(np.int32)
    xq = rng.standard_normal((30, 5)).astype(np.float32)
    want = np.asarray(jr.predict_proba_multiclass(jm, x, labels, xq, 3))
    shapes = []
    encode = transformer.encode_context
    monkeypatch.setattr(transformer, "encode_context", lambda cfg, p, xc, *a: shapes.append(
        tuple(xc.shape)) or encode(cfg, p, xc, *a))
    got = tr.predict_proba_multiclass(tm, t(x), t(labels), t(xq), 3)
    assert shapes == [(3, 150, 5)]
    assert got.shape == (30, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)
