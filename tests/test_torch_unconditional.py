"""Port parity: the unconditional estimator (unconditional.kmeans / lloyd and
UnconditionalEstimator) vs npe_pfn_tpu.unconditional (f32, CPU).

``lloyd`` from JAX's initial centroids (its ``permutation(rng)[:K]``) gives
JAX's ``kmeans`` centroids to 1e-5 and its labels exactly. Given JAX's
cluster state and its dummy columns (the context column of cluster c from
``PRNGKey(c)``, the query columns from the key sequence JAX's ``log_prob``
splits), ``log_prob_given`` equals JAX's ``log_prob`` to rtol 1e-3 / atol
2e-5 (tests/test_golden.py's f32 tolerance). Samples are held by shape,
finiteness and the cluster they come from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import UnconditionalEstimator as JaxUncond
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.unconditional import kmeans as jax_kmeans
from npe_pfn_tpu_torch.unconditional import UnconditionalEstimator, kmeans, lloyd
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(6), cfg)
    return jm, port_model(jm)


def _blobs(n=240, seed=0):
    rng = np.random.default_rng(seed)
    centres = np.array([[-3.0, 0.0, 1.0], [3.0, 1.0, -1.0], [0.0, -3.0, 0.0]], np.float32)
    lab = rng.integers(0, 3, n)
    return (centres[lab] + 0.7 * rng.standard_normal((n, 3))).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_lloyd_from_the_same_initial_centroids_matches_jax(k):
    pts = _blobs()
    key = jax.random.PRNGKey(k)
    init = np.asarray(jax.random.permutation(key, pts.shape[0])[:k])
    jc, jl = jax_kmeans(key, jnp.asarray(pts), k)
    tc, tl = lloyd(t(pts), t(pts[init]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    c, lab = kmeans(torch.Generator().manual_seed(0), t(pts), k)
    assert c.shape == (k, 3) and lab.shape == (240,) and int(lab.max()) < k


def test_empty_cluster_keeps_its_centroid():
    pts = t(_blobs())
    far = torch.tensor([[100.0, 100.0, 100.0]])
    c, lab = lloyd(pts, torch.cat([pts[:2], far]), num_iters=3)
    assert torch.equal(c[2], far[0]) and not bool((lab == 2).any())


def _jax_state(jm, n_clusters=2):
    je = JaxUncond(num_clusters=n_clusters, model=jm, context_size=64, qry_chunk=32, seed=0)
    je.append_simulations(jnp.asarray(_blobs(200, seed=1)[:, :2]))
    return je


def test_log_prob_given_jax_state_and_dummies_matches(models):
    jm, tm = models
    je = _jax_state(jm)
    te = UnconditionalEstimator(num_clusters=2, model=tm, context_size=64, qry_chunk=32)
    te._theta = t(je._theta)
    te.set_cluster_state(np.array(je._centroids), np.array(je._labels))
    np.testing.assert_allclose(te._weights.numpy(), je._weights, rtol=1e-12)
    te.context_dummies = torch.stack([
        t(jax.random.normal(jax.random.PRNGKey(c), (64, 1))) for c in range(2)])
    theta = _blobs(70, seed=2)[:, :2]
    want = np.asarray(je.log_prob(jnp.asarray(theta), rng=jax.random.PRNGKey(7)))
    d2 = ((theta[:, None] - np.asarray(je._centroids)[None]) ** 2).sum(-1)
    route = d2.argmin(-1)
    rng, dummies = jax.random.PRNGKey(7), {}
    for c in range(2):
        n_c = int((route == c).sum())
        if n_c:
            rng, k_dummy = jax.random.split(rng)
            dummies[c] = t(jax.random.normal(k_dummy, (-(-n_c // 32) * 32, 1)))
    assert len(dummies) == 2
    got = te.log_prob_given(t(theta), dummies)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sample_and_log_prob_on_the_port(models):
    _, tm = models
    te = UnconditionalEstimator(num_clusters=3, model=tm, context_size=64, qry_chunk=32, seed=1)
    te.append_simulations(t(_blobs(300, seed=3)))
    assert te._weights.sum().item() == pytest.approx(1.0)
    s = te.sample(100, generator=torch.Generator().manual_seed(2))
    assert s.shape == (100, 3) and bool(torch.isfinite(s).all())
    lp = te.log_prob(s, generator=torch.Generator().manual_seed(3))
    assert lp.shape == (100,) and bool(torch.isfinite(lp).all())
    assert te.sample(5).shape == (5, 3)
    assert te.log_prob(torch.zeros(1, 3)).shape == (1,)


def test_dummies_are_fixed_per_cluster_and_small_clusters_raise(models):
    _, tm = models
    a = UnconditionalEstimator(num_clusters=2, model=tm, context_size=16)
    b = UnconditionalEstimator(num_clusters=3, model=tm, context_size=16, seed=5)
    assert torch.equal(a.context_dummies, b.context_dummies[:2])
    with pytest.raises(ValueError, match="smallest cluster"):
        UnconditionalEstimator(num_clusters=4, model=tm, min_cluster_size=2).append_simulations(
            torch.tensor([[0.0], [0.0], [0.0], [5.0]]))
