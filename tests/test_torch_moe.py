"""Port parity: the mixture-of-experts MLP (``num_experts``) vs npe_pfn_tpu's.

``_moe_mlp`` on the same numpy inputs and weights in both packages (f32):
output and load-balance aux at rtol 1e-5 / atol 1e-6, a routing tie (JAX
selects every expert at or above the k-th logit), and the aux's anchors of
tests/test_moe.py (1 under uniform routing, E/k under collapse, each within
0.05). The model (d_model 32, 2 heads, 2 layers, E 4, top-2, as
tests/test_moe.py): the per-dataset aux of ``forward(with_moe_aux=True)``
against JAX's vmap over datasets, the batch loss with its gradients, and
checkpoints saved by either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.models import checkpoint as jax_ckpt
from npe_pfn_tpu.models import transformer as jt
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
from npe_pfn_tpu_torch.models import checkpoint as tck
from npe_pfn_tpu_torch.models import transformer as tt
from npe_pfn_tpu_torch.pretrain import prior, train
from npe_pfn_tpu_torch.utils.seeding import derive_seed
from torch_parity import (TINY_PRIOR, TINY_TRAIN, check_batch_loss_against_jax, port_model, t,
                          task_batches)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
GOLDEN = dict(rtol=1e-3, atol=2e-5)
CFG = dict(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=16,
           dtype="float32", num_experts=4, moe_top_k=2)


def _experts(rng, router, d=32, e=4, hid=128, scale=0.02):
    """An expert-major MLP parameter dict as numpy arrays."""
    return {"router": np.asarray(router, np.float32),
            "w1": (scale * rng.standard_normal((e, d, hid))).astype(np.float32),
            "b1": (0.1 * rng.standard_normal((e, hid))).astype(np.float32),
            "w2": (scale * rng.standard_normal((e, hid, d))).astype(np.float32),
            "b2": (0.1 * rng.standard_normal((e, d))).astype(np.float32)}


def _both(p_np, x_np, cfg=None):
    cfg = cfg or TabICAConfig(**CFG)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    dims = tuple(range(x_np.ndim - 1))  # every leading dim, as JAX reduces
    out, aux = tt._moe_mlp(cfg, {k: t(v) for k, v in p_np.items()}, t(x_np), dims)
    jout, jaux = jt._moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x_np))
    return (out.numpy(), aux.item()), (np.asarray(jout), float(jaux))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_mlp_matches_jax(top_k):
    rng = np.random.default_rng(top_k)
    p = _experts(rng, rng.standard_normal((32, 4)))
    x = rng.standard_normal((3, 5, 7, 32)).astype(np.float32)
    cfg = TabICAConfig(**{**CFG, "moe_top_k": top_k})
    (out, aux), (jout, jaux) = _both(p, x, cfg)
    np.testing.assert_allclose(out, jout, **TOL)
    assert aux == pytest.approx(jaux, rel=1e-5)
    # Per leading dim over the two token axes: JAX's vmap over the first.
    _, per = tt._moe_mlp(cfg, {k: t(v) for k, v in p.items()}, t(x), (-3, -2))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jper = jax.vmap(lambda xi: jt._moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, xi)[1])(
        jnp.asarray(x))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-5)


def test_moe_routing_tie_selects_every_tied_expert():
    """Two router columns tie at the k-th logit: JAX's ``>=`` rule routes each
    token to three experts at k 2, and the port does the same."""
    rng = np.random.default_rng(0)
    router = np.outer(np.ones(32), [40.0, 20.0, 20.0, -40.0])
    p = _experts(rng, router)
    x = np.abs(rng.standard_normal((16, 32))).astype(np.float32)
    (out, aux), (jout, jaux) = _both(p, x)
    np.testing.assert_allclose(out, jout, **TOL)
    assert aux == pytest.approx(jaux, rel=1e-5)
    glog = t(x) @ t(router).float()
    kth = torch.topk(glog, 2, dim=-1).values[..., -1:]
    assert bool(((glog >= kth).sum(-1) == 3).all())


def test_moe_aux_anchors():
    """Near-uniform routing reads 1, full collapse E/k = 2 (tests/test_moe.py)."""
    rng = np.random.default_rng(1)
    zeros = {k: np.zeros_like(v) for k, v in _experts(rng, np.zeros((32, 4))).items()}
    x = rng.standard_normal((256, 32)).astype(np.float32)
    (_, aux_u), (_, jaux_u) = _both({**zeros, "router": 1e-4 * rng.standard_normal((32, 4))}, x)
    router = np.outer(np.ones(32), [40.0, 20.0, -40.0, -40.0])
    (_, aux_c), (_, jaux_c) = _both({**zeros, "router": router}, np.abs(x))
    assert abs(aux_u - 1.0) < 0.05 and aux_u == pytest.approx(jaux_u, rel=1e-5)
    assert abs(aux_c - 4 / 2) < 0.05 and aux_c == pytest.approx(jaux_c, rel=1e-5)


def test_tied_experts_equal_the_dense_mlp():
    rng = np.random.default_rng(2)
    p = _experts(rng, rng.standard_normal((32, 4)), scale=0.05)
    for k in ("w1", "b1", "w2", "b2"):
        p[k] = np.broadcast_to(p[k][0], p[k].shape).copy()
    cfg = TabICAConfig(**CFG)
    x = t(rng.standard_normal((24, 32)).astype(np.float32))
    out, _ = tt._moe_mlp(cfg, {k: t(v) for k, v in p.items()}, x)
    dense = tt._mlp(cfg, {k: t(p[k][0]) for k in ("w1", "b1", "w2", "b2")}, x)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = JaxModel.create(jax.random.PRNGKey(0), JaxConfig(**CFG))
    return jm, port_model(jm)


def _data(lead=(), n=24, q=6, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (n, 8)).astype(np.float32),
            rng.standard_normal(lead + (n,)).astype(np.float32),
            rng.standard_normal(lead + (q, 8)).astype(np.float32))


@pytest.mark.parametrize("remat", [False, True])
def test_moe_forward_aux_per_dataset_matches_jax(models, remat):
    """Three datasets as a leading dim: logits and one aux per dataset, each
    what JAX returns for that dataset alone; encode + decode as the joint."""
    jm, tm = models
    x_ctx, y_ctx, x_qry = _data(lead=(3,))
    ref, jaux = jax.vmap(lambda a, b, c: jt.forward(jm.cfg, jm.params, a, b, c, None, None,
                                                    remat, True))(x_ctx, y_ctx, x_qry)
    out, aux = tt.forward(tm.cfg, tm.params, t(x_ctx), t(y_ctx), t(x_qry), remat=remat,
                          with_moe_aux=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **GOLDEN)
    assert aux.shape == (3,)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux), rtol=1e-5)
    assert bool(((aux > 0.9) & (aux < 4)).all())
    cache = tt.encode_context(tm.cfg, tm.params, t(x_ctx), t(y_ctx))
    split = tt.decode_queries(tm.cfg, tm.params, cache, t(x_qry))
    np.testing.assert_allclose(split.numpy(), out.detach().numpy(), rtol=2e-4, atol=2e-5)
    dense = dataclasses.replace(tm.cfg, num_experts=0)
    _, aux0 = tt.forward(dense, tt.init_params(torch.Generator().manual_seed(0), dense, "cpu"),
                         t(x_ctx), t(y_ctx), t(x_qry), remat=remat, with_moe_aux=True)
    assert aux0.shape == (3,) and bool((aux0 == 0).all())


@pytest.mark.parametrize("over,remat", [(dict(num_experts=4), True),
                                         (dict(num_experts=4, moe_top_k=1, row_pool_slots=3),
                                          False)],
                         ids=["moe_remat", "moe_top1_pool"])
def test_moe_batch_loss_and_gradients_match_jax(over, remat):
    """The aux weighs in at 0.5 on three datasets; the port's loss is the JAX
    loss, whose aux is a mean of per-dataset auxes."""
    loss, _ = check_batch_loss_against_jax(over, remat, moe_aux_weight=0.5, seed=3,
                                           num_datasets=3)
    cfg = TabICAConfig(**{**TINY_TRAIN, **over})
    tbatch, _ = task_batches(seed=3, num_datasets=3)
    model = TabICAModel.create(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        aux_only = [train.batch_loss(cfg, model.borders, model.params, tbatch, remat,
                                     moe_aux_weight=w) for w in (0.0, 1.0)]
    assert (aux_only[1] - aux_only[0]).item() > 0.9  # the aux of a random router, about 1
    assert np.isfinite(loss)


def test_moe_eval_step_excludes_the_aux_and_train_step_moves_the_router():
    cfg = TabICAConfig(**{**TINY_TRAIN, "num_experts": 4})
    pcfg = prior.PriorConfig(**TINY_PRIOR)
    model = TabICAModel.create(torch.Generator().manual_seed(0), cfg)
    val = train.eval_step(cfg, model.params, pcfg, model.borders, seed=5, num_batches=1)
    batch = prior.sample_tasks(torch.Generator().manual_seed(derive_seed(5, 0)), 32, pcfg)
    with torch.no_grad():
        pure = train.batch_loss(cfg, model.borders, model.params, batch, remat=False,
                                moe_aux_weight=0.0)
        weighted = train.batch_loss(cfg, model.borders, model.params, batch, remat=False)
    assert val.item() == pytest.approx(pure.item(), rel=1e-6)
    assert weighted.item() > pure.item()
    tcfg = train.TrainConfig(num_datasets=2, warmup_steps=1, max_steps=4)
    state = train.make_optimizer(tcfg).init(model.params)
    params = model.params
    for seed in (1, 2):  # the first update has lr 0
        params, state, loss, gnorm = train.train_step(cfg, tcfg, pcfg, params, state,
                                                      model.borders,
                                                      torch.Generator().manual_seed(seed))
    assert np.isfinite(loss.item()) and np.isfinite(gnorm.item())
    moved = params["blocks"]["mlp"]["router"] - model.params["blocks"]["mlp"]["router"]
    assert moved.abs().max().item() > 0


def test_moe_checkpoints_cross_between_packages(models, tmp_path):
    jm, tm = models
    x_ctx, y_ctx, x_qry = _data(seed=4)
    ref = np.asarray(jt.forward(jm.cfg, jm.params, x_ctx, y_ctx, x_qry))
    jax_ckpt.save(str(tmp_path / "jax.npz"), jm)
    back = tck.load(str(tmp_path / "jax.npz"), "cpu")
    assert (back.cfg.num_experts, back.cfg.moe_top_k) == (4, 2)
    out = tt.forward(back.cfg, back.params, t(x_ctx), t(y_ctx), t(x_qry)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    tck.save(str(tmp_path / "torch.npz"), tm)
    jback = jax_ckpt.load(str(tmp_path / "torch.npz"))
    again = np.asarray(jt.forward(jback.cfg, jback.params, x_ctx, y_ctx, x_qry))
    np.testing.assert_allclose(again, out, rtol=1e-6, atol=1e-7)
