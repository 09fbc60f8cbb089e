"""Port parity: the TabICA transformer's inference path vs npe_pfn_tpu's.

JAX weights are carried into the port (``params_from_numpy``) and the same
numpy inputs go through both packages in f32, held to rtol 1e-4 / atol 2e-5
(``tests/test_golden.py`` holds the JAX forward to rtol 1e-3 / atol 2e-5).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.models import checkpoint as jax_ckpt
from npe_pfn_tpu.models import transformer as jt
from npe_pfn_tpu_torch.models import checkpoint as tck
from npe_pfn_tpu_torch.models import transformer as tt
from torch_parity import SHIPPED, port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module", params=[(32, 2, 8), (64, 2, 12)], ids=["d32", "d64"])
def models(request):
    d, h, f = request.param
    cfg = JaxConfig(d_model=d, num_heads=h, num_layers=2, max_features=f, num_bars=16,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(d), cfg)
    return jm, port_model(jm)


def _data(n, q, f, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x_ctx = rng.standard_normal(lead + (n, f)).astype(np.float32)
    y_ctx = rng.standard_normal(lead + (n,)).astype(np.float32)
    x_qry = rng.standard_normal(lead + (q, f)).astype(np.float32)
    return x_ctx, y_ctx, x_qry


@pytest.mark.parametrize("flash", ["auto", "on", "off"])
def test_forward_matches_jax(models, flash):
    jm, tm = models
    f = jm.cfg.max_features
    x_ctx, y_ctx, x_qry = _data(40, 16, f)
    ctx_mask = np.arange(40) < 33
    feat_mask = np.arange(f) < f - 3
    ref = np.asarray(jt.forward(jm.cfg, jm.params, x_ctx, y_ctx, x_qry, feat_mask, ctx_mask))
    cfg = dataclasses.replace(tm.cfg, flash=flash)
    out = tt.forward(cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry), t(feat_mask), t(ctx_mask))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("flash", ["auto", "on"])
def test_encode_decode_matches_joint_and_jax(models, flash):
    jm, tm = models
    f = jm.cfg.max_features
    x_ctx, y_ctx, x_qry = _data(48, 24, f, seed=1)
    ctx_mask = np.arange(48) < 45
    cfg = dataclasses.replace(tm.cfg, flash=flash)
    cache = tt.encode_context(cfg, tm.params, t(x_ctx), t(y_ctx), ctx_mask=t(ctx_mask))
    assert len(cache) == cfg.num_layers
    k, v = cache[0]
    assert k.shape == (f + 1, 48, cfg.num_heads, cfg.head_dim) and v.shape == k.shape
    out = tt.decode_queries(cfg, tm.params, cache, t(x_qry), ctx_mask=t(ctx_mask))
    joint = tt.forward(cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry), ctx_mask=t(ctx_mask))
    np.testing.assert_allclose(out.numpy(), joint.numpy(), rtol=1e-6, atol=1e-6)
    jcache = jt.encode_context(jm.cfg, jm.params, x_ctx, y_ctx, ctx_mask=ctx_mask)
    np.testing.assert_allclose(k.numpy(), np.asarray(jcache[0][0]), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jcache[1][0]), **TOL)
    ref = np.asarray(jt.decode_queries(jm.cfg, jm.params, jcache, x_qry, ctx_mask=ctx_mask))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_batched_forward_per_member_masks(models):
    """Leading batch dims [E, ...] with per-member context masks: the
    kernel's function takes them as [B, Lk] mask rows."""
    jm, tm = models
    f = jm.cfg.max_features
    x_ctx, y_ctx, x_qry = _data(40, 16, f, lead=(3,), seed=2)
    ctx_mask = np.arange(40)[None, :] < np.array([33, 40, 21])[:, None]
    ref = np.asarray(jt.forward(jm.cfg, jm.params, x_ctx, y_ctx, x_qry, ctx_mask=ctx_mask))
    for flash in ("on", "off"):
        cfg = dataclasses.replace(tm.cfg, flash=flash)
        out = tt.forward(cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry), ctx_mask=t(ctx_mask))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_bf16_policy_close_to_jax(models):
    """cfg.dtype bfloat16 with bf16 scores: the port keeps JAX's dtype policy
    (f32 layer norms, head and residual accumulation); both round in bf16, so
    the logits agree to bf16 precision (1% of the largest logit)."""
    jm, tm = models
    jcfg = dataclasses.replace(jm.cfg, dtype="bfloat16", scores_dtype="bfloat16")
    tcfg = dataclasses.replace(tm.cfg, dtype="bfloat16", scores_dtype="bfloat16")
    x_ctx, y_ctx, x_qry = _data(40, 16, jm.cfg.max_features, seed=3)
    ref = np.asarray(jt.forward(jcfg, jm.params, x_ctx, y_ctx, x_qry))
    out = tt.forward(tcfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def test_shipped_checkpoint_f32_at_128_rows():
    """tabica_v6_best (d 256, 2 heads of 128, 8 layers, 1024 bars) in f32 at
    128 context rows, encode + decode against the JAX package."""
    jm = jax_ckpt.load(SHIPPED)
    jm = jm.replace(cfg=dataclasses.replace(jm.cfg, dtype="float32", scores_dtype="float32"))
    tm = tck.load(SHIPPED, "cpu", dtype="float32", scores_dtype="float32")
    f = 24
    x_ctx, y_ctx, x_qry = _data(128, 32, f, seed=4)
    feat_mask = np.arange(f) < 17
    jcache = jt.encode_context(jm.cfg, jm.params, x_ctx, y_ctx, feat_mask)
    ref = np.asarray(jt.decode_queries(jm.cfg, jm.params, jcache, x_qry, feat_mask))
    cache = tt.encode_context(tm.cfg, tm.params, t(x_ctx), t(y_ctx), t(feat_mask))
    for flash in ("auto", "on"):
        cfg = dataclasses.replace(tm.cfg, flash=flash)
        out = tt.decode_queries(cfg, tm.params, cache, t(x_qry), t(feat_mask)).numpy()
        assert out.shape == (32, 1024)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("field", ["num_experts", "row_pool_slots"])
def test_unported_options_raise(models, field):
    _, tm = models
    cfg = dataclasses.replace(tm.cfg, **{field: 2})
    x_ctx, y_ctx, x_qry = _data(8, 4, tm.cfg.max_features)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.forward(cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry))
