"""Port parity: context filters, priors and the gaussian_linear task vs
npe_pfn_tpu's. Deterministic filters are compared row for row, the top-k
filter by the SET of selected rows (ties may come out in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import distributions as jd
from npe_pfn_tpu import filters as jf
from npe_pfn_tpu.tasks import get_task as jax_get_task
from npe_pfn_tpu_torch import distributions as td
from npe_pfn_tpu_torch import filters as tf
from npe_pfn_tpu_torch.tasks import get_task
from torch_parity import t

torch.set_num_threads(2)


def _sims(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, 3)).astype(np.float32)
    x = (theta @ rng.standard_normal((3, 5)) + 0.3 * rng.standard_normal((n, 5))).astype(np.float32)
    x[:, 4] *= 40.0  # unequal feature scales: the z-scoring matters
    return theta, x, x[7] + 0.1


@pytest.mark.parametrize("name", ["no_filtering", "latest_filtering"])
@pytest.mark.parametrize("n,size", [(300, 128), (100, 128)])
def test_deterministic_filters_match(name, n, size):
    theta, x, obs = _sims(n)
    ref = jf.get_filtering_method(name)(obs, theta, x, size)
    out = tf.get_filtering_method(name)(t(obs), t(theta), t(x), size)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("n,size", [(1000, 256), (200, 256)])
def test_standardized_euclidean_selects_same_rows(n, size):
    theta, x, obs = _sims(n, seed=1)
    rt, rx, rm = jf.standardized_euclidean_filtering(obs, theta, x, size)
    ot, ox, om = tf.standardized_euclidean_filtering(t(obs), t(theta), t(x), size)
    np.testing.assert_array_equal(om.numpy(), np.asarray(rm))
    rows = lambda a, b: {tuple(r) for r in np.concatenate([a, b], 1)[: int(np.asarray(rm).sum())]}
    assert rows(ot.numpy(), ox.numpy()) == rows(np.asarray(rt), np.asarray(rx))


def test_population_std_is_used():
    """jnp.std is the population std: the port's distances use correction=0."""
    theta, x, obs = _sims(40, seed=2)
    sd = torch.std(t(x), dim=0, correction=0)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jnp.std(x, axis=0)), rtol=1e-6)


def test_random_filtering_draws_a_subset():
    theta, x, obs = _sims(500, seed=3)
    g = torch.Generator().manual_seed(0)
    ot, ox, om = tf.random_filtering(t(obs), t(theta), t(x), 128, generator=g)
    assert ot.shape == (128, 3) and om.all()
    pool = {tuple(r) for r in theta}
    picked = {tuple(r) for r in ot.numpy()}
    assert len(picked) == 128 and picked <= pool
    with pytest.raises(ValueError):
        tf.random_filtering(t(obs), t(theta), t(x), 128)
    with pytest.raises(ValueError):
        tf.get_filtering_method("nearest")


def test_priors_match():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    pts[0, 1] = np.inf
    jn, tn = jd.Normal(jnp.zeros(3), 2 * jnp.ones(3)), td.Normal(torch.zeros(3), 2 * torch.ones(3))
    np.testing.assert_allclose(tn.log_prob(t(pts[1:])).numpy(), np.asarray(jn.log_prob(pts[1:])),
                               rtol=1e-6)
    np.testing.assert_array_equal(tn.support_check(t(pts)).numpy(), np.asarray(jn.support_check(pts)))
    jb = jd.BoxUniform(-jnp.ones(3), jnp.ones(3))
    tb = td.BoxUniform(-torch.ones(3), torch.ones(3))
    np.testing.assert_array_equal(tb.support_check(t(pts)).numpy(), np.asarray(jb.support_check(pts)))
    np.testing.assert_allclose(tb.log_prob(t(pts)).numpy(), np.asarray(jb.log_prob(pts)))
    g = torch.Generator().manual_seed(0)
    s = tb.sample(g, (20_000,))
    assert s.shape == (20_000, 3) and tb.support_check(s).all()
    z = tn.sample(g, (20_000,))
    assert abs(float(z.std()) - 2.0) < 0.05 and abs(float(z.mean())) < 0.05


def test_gaussian_linear_matches_jax():
    task, jtask = get_task("gaussian_linear", dim=10, device="cpu"), jax_get_task("gaussian_linear", dim=10)
    assert (task.dim_theta, task.dim_x) == (jtask.dim_theta, jtask.dim_x) == (10, 10)
    rng = np.random.default_rng(5)
    x_o = rng.standard_normal(10).astype(np.float32)
    th = rng.standard_normal((16, 10)).astype(np.float32)
    np.testing.assert_allclose(task.posterior_log_prob(t(x_o), t(th)).numpy(),
                               np.asarray(jtask.posterior_log_prob(x_o, th)), rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    theta, x = task.simulate(g, 50_000)
    assert theta.shape == x.shape == (50_000, 10)
    # x - θ is the simulator's noise: std 0.6
    assert abs(float((x - theta).std()) - 0.6) < 0.01
    mean, std = task.posterior_moments(t(x_o))
    post = task.posterior_sampler(g, t(x_o), 50_000)
    np.testing.assert_allclose(post.mean(0).numpy(), mean.numpy(), atol=0.02)
    np.testing.assert_allclose(post.std(0).numpy(), std.numpy(), atol=0.02)
    jpost = np.asarray(jtask.posterior_sampler(jax.random.PRNGKey(0), x_o, 50_000))
    np.testing.assert_allclose(jpost.mean(0), mean.numpy(), atol=0.02)
