"""Port parity: npe_pfn_tpu_torch.embeddings and NPEPFN's embedding_net /
x_shape contract against npe_pfn_tpu's.

Each embedding, given the JAX package's weights, maps the same numpy inputs
to the JAX output at rtol / atol 1e-5. The slice as a whole: NPEPFN.log_prob
and log_prob_batched on gaussian_bump_image (1024-D x) through JAX's random
projection to 24 features, port against JAX on the same deterministic
context and tiny model (d_model 32, 2 layers, f32), at rtol / atol 1e-4 (the
tolerance of tests/test_torch_estimator.py), with and without x_shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu import embeddings as je
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.tasks import get_task as jax_get_task
from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch import embeddings as te
from npe_pfn_tpu_torch.serving import CachedPosterior
from npe_pfn_tpu_torch.tasks import get_task
from torch_parity import port_model, t

torch.set_num_threads(2)
EMB_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("standardize", [True, False])
def test_random_projection_matches_jax(standardize):
    jp = je.RandomProjectionEmbedding(40, 8, seed=3, standardize=standardize)
    tp = te.RandomProjectionEmbedding(40, 8, standardize=standardize, device="cpu",
                                      weights={"w": np.asarray(jp.w)})
    for x in (_x(50, 40), _x(40, seed=1), _x(2, 3, 40, seed=2)):
        np.testing.assert_allclose(tp(t(x)).numpy(), np.asarray(jp(x)), **EMB_TOL)


def test_mlp_and_conv1d_and_chain_match_jax():
    jm = je.MLPEmbedding(40, 6, hidden=16, seed=1)
    tm = te.MLPEmbedding(40, 6, hidden=16, device="cpu",
                         weights={"w1": np.asarray(jm.w1), "w2": np.asarray(jm.w2)})
    x = _x(30, 40)
    np.testing.assert_allclose(tm(t(x)).numpy(), np.asarray(jm(x)), **EMB_TOL)
    jc = je.Conv1DEmbedding(30, 5, channels=4, kernel=5, pool=3, seed=2)
    tc = te.Conv1DEmbedding(30, 5, channels=4, kernel=5, pool=3, device="cpu",
                            weights={"kernel": np.asarray(jc.kernel),
                                     "w_out": np.asarray(jc.w_out)})
    for xs in (_x(7, 30), _x(2, 3, 30, seed=1), _x(30, seed=2)):
        np.testing.assert_allclose(tc(t(xs)).numpy(), np.asarray(jc(xs)), **EMB_TOL)
    jp = je.RandomProjectionEmbedding(6, 3, seed=4)
    tp = te.RandomProjectionEmbedding(6, 3, device="cpu", weights={"w": np.asarray(jp.w)})
    np.testing.assert_allclose(te.chain(tm, tp)(t(x)).numpy(), np.asarray(je.chain(jm, jp)(x)),
                               **EMB_TOL)


def test_seeded_draws():
    """Weights come from a CPU generator seeded by ``seed``: equal per seed,
    different across seeds, scaled as the JAX package scales them."""
    a, b = (te.RandomProjectionEmbedding(1024, 24, seed=0, device="cpu") for _ in range(2))
    assert torch.equal(a.w, b.w)
    assert not torch.equal(a.w, te.RandomProjectionEmbedding(1024, 24, seed=1, device="cpu").w)
    np.testing.assert_allclose(a.w.std().item(), 1 / np.sqrt(24), rtol=0.05)
    c = te.Conv1DEmbedding(64, 8, device="cpu")
    assert c.kernel.shape == (16, 1, 9) and c.w_out.shape == ((64 - 9 + 1) // 4 * 16, 8)
    assert te.MLPEmbedding(10, 4, device="cpu").w1.shape == (10, 256)


@pytest.fixture(scope="module")
def bump():
    """Tiny model with the JAX weights, gaussian_bump_image simulations and
    JAX's random projection 1024 -> 24."""
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=32, num_bars=32,
                    dtype="float32")
    jmodel = JaxModel.create(jax.random.PRNGKey(0), cfg)
    task = jax_get_task("gaussian_bump_image")
    theta, x = (np.asarray(a) for a in task.simulate(jax.random.PRNGKey(1), 200))
    jproj = je.RandomProjectionEmbedding(1024, 24, seed=0)
    tproj = te.RandomProjectionEmbedding(1024, 24, device="cpu", weights={"w": np.asarray(jproj.w)})
    return jmodel, port_model(jmodel), task, theta, x, jproj, tproj


@pytest.mark.parametrize("shaped", [False, True])
def test_log_prob_through_embedding_matches_jax(bump, shaped):
    jmodel, tmodel, jtask, theta, x, jproj, tproj = bump
    if shaped:  # the net gets images [N, 32, 32]
        jnet = je.chain(lambda v: jnp.reshape(v, (v.shape[0], -1)), jproj)
        tnet = te.chain(lambda v: v.reshape(v.shape[0], -1), tproj)
        kw = dict(x_shape=(32, 32))
    else:
        jnet, tnet, kw = jproj, tproj, {}
    common = dict(filter_context_size=256, qry_chunk=64, seed=0)
    jest = JaxNPEPFN(prior=jtask.prior, model=jmodel, embedding_net=jnet, **common, **kw)
    test = NPEPFN(prior=get_task("gaussian_bump_image", device="cpu").prior, model=tmodel,
                  embedding_net=tnet, **common, **kw)
    jest.append_simulations(theta, x)
    test.append_simulations(t(theta), t(x))
    np.testing.assert_allclose(test._x_train.numpy(), np.asarray(jest._x_train), **EMB_TOL)
    assert test._x_train.shape == (200, 24)
    x_o = x[-1]
    theta_q = np.asarray(jtask.prior.sample(jax.random.PRNGKey(5), (64,)))
    want = np.asarray(jest.log_prob(theta_q, x_o))
    np.testing.assert_allclose(test.log_prob(t(theta_q), t(x_o)).numpy(), want, **TOL)
    np.testing.assert_allclose(test.log_prob(t(theta_q), t(x_o[None])).numpy(), want, **TOL)
    if not shaped:  # log_prob_batched applies the net without x_shape, as the JAX package does
        th = theta_q.reshape(2, 32, 3)
        np.testing.assert_allclose(
            test.log_prob_batched(t(th), t(x[-2:])).numpy(),
            np.asarray(jest.log_prob_batched(th, x[-2:])), **TOL)
    # The samplers and the cache take raw observations too.
    gen = torch.Generator().manual_seed(0)
    assert test.sample(64, t(x_o), generator=gen).shape == (64, 3)
    assert test.sample_batched(8, t(x[:3]), generator=gen).shape == (3, 8, 3)
    assert test.sample_batched_filtered(8, t(x[:2]), generator=gen).shape == (2, 8, 3)
    cached = CachedPosterior(test, t(x_o))
    np.testing.assert_allclose(cached.log_prob(t(theta_q)).numpy(), want, **TOL)
