"""Port parity: npe_pfn_tpu_torch.eval.metrics against npe_pfn_tpu.eval.metrics.

Tolerances: mmd (both kernels) and sinkhorn_w2 at rtol 1e-4 on the same
numpy samples; the conv trunk's features ("SAME" padding at stride 2, 1D and
2D) at rtol / atol 1e-5 on the same parameters; wasserstein2_exact and
ks_test_per_dim exactly (both scipy). c2st, c2st_embedded and c2st_conv,
given JAX's initial parameters, fold permutation and projection weights, train for hundreds of Adam steps in
f32 with sums in another order, so their held-out accuracies are held to
within 2 / fold_size of JAX's. The null and signal cases bound the port
alone, in 5-D: two draws of one Gaussian read ≤ 0.6; Gaussians shifted by 2
per dim (Bayes accuracy Φ(√20 / 2) = 0.987) ≥ 0.95; shifted by 1 per dim
(Bayes Φ(√5 / 2) = 0.868, so never 0.95) ≥ 0.8; a bump image against
noise reads ≥ 0.9 through the conv C2ST and ≥ 0.8 through a 16-dim random
projection (Bayes 0.93).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import embeddings as je
from npe_pfn_tpu.eval import metrics as jm
from npe_pfn_tpu_torch.embeddings import RandomProjectionEmbedding
from npe_pfn_tpu_torch.eval import metrics as tm
from torch_parity import t

torch.set_num_threads(2)


def _gauss(n, d, shift=0.0, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, d)) + shift).astype(np.float32)


@pytest.mark.parametrize("kernel", ["multiscale", "rbf"])
def test_mmd_matches_jax(kernel):
    a, b = _gauss(200, 3, seed=1), _gauss(150, 3, 0.3, seed=2) * 1.5
    want = float(jm.mmd(a, b, kernel=kernel))
    got = float(tm.mmd(t(a), t(b), kernel=kernel))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(ValueError):
        tm.mmd(t(a), t(b), kernel="laplace")


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_sinkhorn_matches_jax(shift):
    a, b = _gauss(128, 3, seed=3), _gauss(96, 3, shift, seed=4)
    np.testing.assert_allclose(float(tm._sinkhorn_cost(t(a), t(b))),
                               float(jm._sinkhorn_cost(a, b)), rtol=1e-4)
    np.testing.assert_allclose(float(tm.sinkhorn_w2(t(a), t(b))),
                               float(jm.sinkhorn_w2(a, b)), rtol=1e-4, atol=1e-6)


def test_exact_wasserstein_and_ks_match_jax():
    a, b = _gauss(64, 2, seed=5), _gauss(64, 2, 0.4, seed=6)
    assert tm.wasserstein2_exact(t(a), t(b)) == jm.wasserstein2_exact(a, b)
    np.testing.assert_array_equal(tm.ks_test_per_dim(t(a), t(b)), jm.ks_test_per_dim(a, b))


def test_sinkhorn_near_exact_w2():
    """The debiased Sinkhorn estimate within 10% of the exact W2 (chip_smoke's
    phase 17 check, at a smaller n)."""
    a, b = _gauss(128, 2, seed=7), _gauss(128, 2, 1.0, seed=8)
    exact = tm.wasserstein2_exact(a, b)
    assert abs(float(tm.sinkhorn_w2(t(a), t(b))) - exact) <= 0.1 * exact


def _jax_c2st_draws(key, n, paired, folds, init):
    """The permutation and the stacked per-fold initial parameters that the
    JAX c2st / c2st_conv draw from ``key``."""
    perm_rng, rng = jax.random.split(key)
    perm = jax.random.permutation(perm_rng, n if paired else 2 * n)
    params = jax.vmap(init)(jax.random.split(rng, folds))
    return np.asarray(perm), jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_c2st_given_jax_init_matches(paired, shift):
    n, d, folds = 200, 3, 5
    a = _gauss(n, d, seed=9)
    b = _gauss(n, d, shift, seed=10)
    if paired:  # joint rows sharing the last two columns, as the harness builds them
        b[:, 1:] = a[:, 1:]
    key = jax.random.PRNGKey(11)
    want = float(jm.c2st(key, a, b, paired=paired))
    perm, params = _jax_c2st_draws(key, n, paired, folds, lambda k: jm._mlp_init(k, d, 64))
    got = float(tm.c2st(None, t(a), t(b), paired=paired, params=params, perm=perm))
    fold_size = (n if paired else 2 * n) // folds
    assert abs(got - want) <= 2 / fold_size, (got, want)


@pytest.mark.parametrize("shape", [(8, 8), (9, 7), (16,), (15,)])
def test_conv_trunk_matches_jax(shape):
    """The trunk's pooled features on the same parameters: explicit "SAME"
    padding at stride 2 must shift no window."""
    folds, channels = 3, 4
    keys = jax.random.split(jax.random.PRNGKey(12), folds)
    params = jax.vmap(lambda k: jm._conv_trunk_init(k, shape, channels))(keys)
    x = _gauss(10, int(np.prod(shape)), seed=13)
    want = np.stack([np.asarray(jm._conv_trunk_apply(
        jax.tree_util.tree_map(lambda p: p[f], params), jnp.asarray(x), shape))
        for f in range(folds)])
    got = tm._conv_trunk_apply({k: t(v) for k, v in params.items()}, t(x), shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_c2st_conv_given_jax_init_matches():
    """Paired folds, as the harness runs it (c2st's test covers both fold kinds)."""
    paired = True
    n, shape, d_extra, folds, channels = 100, (8, 8), 2, 5, 8
    rng = np.random.default_rng(14)
    imgs = rng.standard_normal((2 * n,) + shape).astype(np.float32)
    imgs[n:, 2:6, 2:6] += 0.8  # a bump in b's images
    a = np.concatenate([rng.standard_normal((n, d_extra)), imgs[:n].reshape(n, -1)], 1)
    b = np.concatenate([rng.standard_normal((n, d_extra)), imgs[n:].reshape(n, -1)], 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    key = jax.random.PRNGKey(15)
    want = float(jm.c2st_conv(key, a, b, shape=shape, d_extra=d_extra, paired=paired))

    def init(k):
        k1, k2 = jax.random.split(k)
        return {"conv": jm._conv_trunk_init(k1, shape, channels),
                "mlp": jm._mlp_init(k2, 4 * channels + d_extra, 64)}

    perm, params = _jax_c2st_draws(key, n, paired, folds, init)
    got = float(tm.c2st_conv(None, t(a), t(b), shape=shape, d_extra=d_extra, paired=paired,
                             params=params, perm=perm))
    fold_size = (n if paired else 2 * n) // folds
    assert abs(got - want) <= 2 / fold_size, (got, want)


def test_c2st_null_and_signal():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    same = float(tm.c2st(gen(0), t(_gauss(256, 5, seed=16)), t(_gauss(256, 5, seed=17))))
    shifted = float(tm.c2st(gen(1), t(_gauss(256, 5, seed=18)), t(_gauss(256, 5, 2.0, seed=19))))
    unit = float(tm.c2st(gen(1), t(_gauss(256, 5, seed=18)), t(_gauss(256, 5, 1.0, seed=19))))
    x = _gauss(256, 4, seed=20)
    joint_a = np.concatenate([_gauss(256, 1, seed=21), x], 1)
    joint_b = np.concatenate([_gauss(256, 1, seed=22), x], 1)
    paired = float(tm.c2st(gen(2), t(joint_a), t(joint_b), paired=True))
    assert same <= 0.6 and paired <= 0.6, (same, paired)
    assert shifted >= 0.95 and unit >= 0.8, (shifted, unit)


def test_c2st_embedded_and_conv_detect_a_bump():
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(23)
    noise = rng.standard_normal((200, 16, 16)).astype(np.float32) * 0.3
    bump = noise.copy()
    ii, jj = np.mgrid[:16, :16]
    bump[100:] += np.exp(-((ii - 8.0) ** 2 + (jj - 8.0) ** 2) / 8.0)
    a, b = t(noise[:100].reshape(100, -1)), t(bump[100:].reshape(100, -1))
    assert float(tm.c2st_conv(gen, a, b, shape=(16, 16))) >= 0.9
    # Projected to 16 dims the bump is a mean shift of Mahalanobis length
    # about 3 (energy 4π over noise 0.3² per pixel), Bayes accuracy Φ(1.5) = 0.93.
    proj = RandomProjectionEmbedding(256, 16, seed=0, standardize=False, device="cpu")
    assert float(tm.c2st_embedded(gen, a, b, proj)) >= 0.8


def test_c2st_embedded_given_jax_init_matches():
    """Through JAX's projection weights, initial parameters and permutation,
    the held-out accuracy within 2 / fold_size of JAX's, on a bump that the
    projected features show (so both read far above chance)."""
    n, side, dout, folds = 100, 12, 16, 5
    rng = np.random.default_rng(24)
    imgs = rng.standard_normal((2 * n, side, side)).astype(np.float32) * 0.3
    imgs[n:, 3:9, 3:9] += 0.5
    a, b = imgs[:n].reshape(n, -1), imgs[n:].reshape(n, -1)
    jproj = je.RandomProjectionEmbedding(side * side, dout, seed=5)
    key = jax.random.PRNGKey(25)
    want = float(jm.c2st_embedded(key, a, b, jproj))
    perm, params = _jax_c2st_draws(key, n, False, folds, lambda k: jm._mlp_init(k, dout, 64))
    tproj = RandomProjectionEmbedding(side * side, dout, device="cpu",
                                      weights={"w": np.asarray(jproj.w)})
    got = float(tm.c2st_embedded(None, t(a), t(b), tproj, params=params, perm=perm))
    assert abs(got - want) <= 2 / (2 * n // folds), (got, want)
    assert want >= 0.9, want
