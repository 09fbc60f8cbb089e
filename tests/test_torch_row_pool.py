"""Port parity: the row-pooled TabICA model (``row_pool_slots``) vs npe_pfn_tpu's.

A tiny pooled model (d_model 32, 2 heads, 2 layers, 8 features, K 3 slots, as
tests/test_row_pool.py) made by the JAX package, its weights carried into the
port, the same numpy inputs through both in f32. Logits are held to the
golden tolerance, rtol 1e-3 / atol 2e-5, with the row attention dense
(flash "off") and through the kernels' function (flash "on"; JAX runs its
Pallas kernel in interpret mode); the batch loss and its gradients to the
tolerances of tests/test_torch_train.py.
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
from npe_pfn_tpu_torch.pretrain import warmstart
from torch_parity import check_batch_loss_against_jax, port_model, t

torch.set_num_threads(2)
GOLDEN = dict(rtol=1e-3, atol=2e-5)
CFG = dict(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=16,
           dtype="float32", row_pool_slots=3)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel.create(jax.random.PRNGKey(0), JaxConfig(**CFG))
    return jm, port_model(jm)


def _data(n=20, q=7, f=8, lead=(), seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (n, f)).astype(np.float32),
            rng.standard_normal(lead + (n,)).astype(np.float32),
            rng.standard_normal(lead + (q, f)).astype(np.float32))


def _flash(jm, tm, flash):
    jcfg = dataclasses.replace(jm.cfg, flash=flash, flash_interpret=flash == "on")
    return jcfg, dataclasses.replace(tm.cfg, flash=flash)


@pytest.mark.parametrize("flash", ["off", "on"])
def test_pooled_forward_and_encode_decode_match_jax(models, flash):
    """Joint forward and encode + decode against JAX's; the cache's slot axis
    is K, not F + 1; encode + decode equals the joint forward."""
    jm, tm = models
    jcfg, cfg = _flash(jm, tm, flash)
    x_ctx, y_ctx, x_qry = _data()
    ref = np.asarray(jt.forward(jcfg, jm.params, x_ctx, y_ctx, x_qry))
    joint = tt.forward(cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry)).detach().numpy()
    np.testing.assert_allclose(joint, ref, **GOLDEN)
    jcache = jt.encode_context(jcfg, jm.params, x_ctx, y_ctx)
    cache = tt.encode_context(cfg, tm.params, t(x_ctx), t(y_ctx))
    assert len(cache) == 2 and tuple(cache[0][0].shape) == (3, 20, 2, 16)
    np.testing.assert_allclose(cache[1][0].numpy(), np.asarray(jcache[0][1]), **GOLDEN)
    split = tt.decode_queries(cfg, tm.params, cache, t(x_qry)).numpy()
    np.testing.assert_allclose(split, np.asarray(jt.decode_queries(jcfg, jm.params, jcache, x_qry)),
                               **GOLDEN)
    np.testing.assert_allclose(split, joint, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("flash", ["off", "on"])
def test_pooled_query_rows_are_independent(models, flash):
    _, tm = models
    cfg = dataclasses.replace(tm.cfg, flash=flash)
    x_ctx, y_ctx, x_qry = (t(a) for a in _data())
    full = tt.forward(cfg, tm.params, x_ctx, y_ctx, x_qry)
    solo = tt.forward(cfg, tm.params, x_ctx, y_ctx, x_qry[3:4])
    np.testing.assert_allclose(full[3].detach().numpy(), solo[0].detach().numpy(),
                               rtol=2e-4, atol=2e-5)


def test_pooled_masks_and_leading_dims_match_jax(models):
    """Padded feature tokens are masked out of the pooling keys, padded
    context rows out of the row attention (junk in them changes nothing), and
    two contexts as a leading dim give JAX's logits for each."""
    jm, tm = models
    x_ctx, y_ctx, x_qry = _data(lead=(2,), seed=2)
    feat_mask = np.arange(8) < 5
    ctx_mask = np.stack([np.arange(20) < 12, np.arange(20) < 20])
    ref = np.asarray(jt.forward(jm.cfg, jm.params, x_ctx, y_ctx, x_qry, feat_mask, ctx_mask))
    x_ctx[..., 5:] = 99.0
    x_qry[..., 5:] = -99.0
    x_ctx[0, 12:] = 55.0
    y_ctx[0, 12:] = -55.0
    out = tt.forward(tm.cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry), t(feat_mask), t(ctx_mask))
    np.testing.assert_allclose(out.detach().numpy(), ref, **GOLDEN)


@pytest.mark.parametrize("remat", [False, True])
def test_pool_batch_loss_and_gradients_match_jax(remat):
    """The pooled training path, gradients of the slots and the pooling and
    unpooling attentions included."""
    check_batch_loss_against_jax(dict(row_pool_slots=3), remat)


def test_pooled_checkpoints_cross_between_packages(models, tmp_path):
    """A pooled checkpoint the JAX package saves loads in the port and gives
    JAX's logits; one the port saves loads in JAX and gives the port's."""
    jm, tm = models
    x_ctx, y_ctx, x_qry = _data(seed=3)
    ref = np.asarray(jt.forward(jm.cfg, jm.params, x_ctx, y_ctx, x_qry))
    jax_ckpt.save(str(tmp_path / "jax.npz"), jm)
    back = tck.load(str(tmp_path / "jax.npz"), "cpu")
    assert back.cfg.row_pool_slots == 3
    out = tt.forward(back.cfg, back.params, t(x_ctx), t(y_ctx), t(x_qry)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    tck.save(str(tmp_path / "torch.npz"), tm)
    jback = jax_ckpt.load(str(tmp_path / "torch.npz"))
    again = np.asarray(jt.forward(jback.cfg, jback.params, x_ctx, y_ctx, x_qry))
    np.testing.assert_allclose(again, out, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("field,subtree", [("row_pool_slots", "blocks/pool"),
                                           ("num_experts", "blocks/mlp/router")])
def test_warmstart_into_a_pooled_or_moe_target_names_the_missing_subtree(
        models, tmp_path, field, subtree):
    """A dense checkpoint cannot start a pooled or MoE model: the load raises
    and names the subtree the checkpoint lacks."""
    _, tm = models
    dense = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, row_pool_slots=0),
                                params={**tm.params, "blocks": {
                                    k: v for k, v in tm.params["blocks"].items() if k != "pool"}})
    tck.save(str(tmp_path / "dense.npz"), dense)
    target = dataclasses.replace(dense.cfg, **{field: 4})
    with pytest.raises(ValueError, match=subtree):
        warmstart.load_warmstart(str(tmp_path / "dense.npz"), target, "cpu")
    assert warmstart.load_warmstart(str(tmp_path / "dense.npz"), dense.cfg, "cpu").cfg == dense.cfg
