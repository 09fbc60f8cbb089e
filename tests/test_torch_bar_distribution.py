"""Port parity: npe_pfn_tpu_torch bar distribution vs npe_pfn_tpu's.

Deterministic functions (log_prob, cdf, icdf, mean) are held to 1e-5 on the
same borders and logits; the borders themselves to 1e-6 (both packages build
them in float32, with their own ndtri); ``sample`` by a chi-square test on
bucket frequencies, since torch cannot reproduce JAX's random bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu.models import bar_distribution as jbar
from npe_pfn_tpu_torch.models import bar_distribution as tbar
from torch_parity import t

torch.set_num_threads(2)


@pytest.mark.parametrize("num_bars", [16, 64, 1024])
def test_borders_match(num_bars):
    ref = np.asarray(jbar.make_borders(num_bars, 6.0))
    out = tbar.make_borders(num_bars, 6.0)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert out[0] == -6.0 and out[-1] == 6.0


def _inputs(num_bars, seed=0):
    rng = np.random.default_rng(seed)
    borders = np.asarray(jbar.make_borders(num_bars, 6.0))
    logits = (2.0 * rng.standard_normal((5, 7, num_bars))).astype(np.float32)
    # interior points, both tails, far tails and the points next to the borders
    y = np.concatenate([
        rng.uniform(-7, 7, 25), [-30.0, -6.5, -6.0, 6.0, 6.5, 30.0],
        [borders[1] - 1e-4, borders[1] + 1e-4, borders[-2] - 1e-4, borders[-2] + 1e-4],
    ]).astype(np.float32)[:35].reshape(5, 7)
    return borders, logits, y


@pytest.mark.parametrize("fn", ["log_prob", "cdf"])
@pytest.mark.parametrize("num_bars", [16, 1024])
def test_density_functions_match(fn, num_bars):
    borders, logits, y = _inputs(num_bars)
    ref = np.asarray(getattr(jbar, fn)(jnp.asarray(borders), jnp.asarray(logits), jnp.asarray(y)))
    out = getattr(tbar, fn)(t(borders), t(logits), t(y)).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_log_prob_broadcasts_scalar_y():
    borders, logits, _ = _inputs(32)
    ref = np.asarray(jbar.log_prob(jnp.asarray(borders), jnp.asarray(logits), 0.3))
    out = tbar.log_prob(t(borders), t(logits), torch.tensor(0.3)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbar.nll(t(borders), t(logits), torch.tensor(0.3)).numpy(), -ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_bars", [16, 1024])
def test_icdf_and_mean_match(num_bars):
    borders, logits, _ = _inputs(num_bars, seed=1)
    q = np.random.default_rng(2).uniform(1e-4, 0.99, (5, 7)).astype(np.float32)
    q[0, :2] = [1e-6, 0.5]  # lower-tail probe; the upper tail is the test below
    ref = np.asarray(jbar.icdf(jnp.asarray(borders), jnp.asarray(logits), jnp.asarray(q)))
    out = tbar.icdf(t(borders), t(logits), t(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref_m = np.asarray(jbar.mean(jnp.asarray(borders), jnp.asarray(logits)))
    np.testing.assert_allclose(tbar.mean(t(borders), t(logits)).numpy(), ref_m, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("num_bars", [16, 1024])
def test_icdf_upper_tail_round_trip(num_bars):
    """Near q = 1 the float32 cumulative mass (resolution 6e-8) decides icdf,
    and the two packages' cumsums round differently, so the upper tail is
    held by the round trip cdf(icdf(q)) = q, to 2e-6, in both packages."""
    borders, logits, _ = _inputs(num_bars, seed=1)
    q = np.broadcast_to(np.float32([0.99, 0.999, 0.9999, 1 - 1e-5, 0.995, 0.9995, 0.99995]),
                        (5, 7)).copy()
    y = tbar.icdf(t(borders), t(logits), t(q))
    np.testing.assert_allclose(tbar.cdf(t(borders), t(logits), y).numpy(), q, rtol=0, atol=2e-6)
    yj = jbar.icdf(jnp.asarray(borders), jnp.asarray(logits), jnp.asarray(q))
    np.testing.assert_allclose(np.asarray(jbar.cdf(jnp.asarray(borders), jnp.asarray(logits), yj)),
                               q, rtol=0, atol=2e-6)


def test_sample_bucket_frequencies_chi_square():
    """200k draws from one logit row: bucket counts against the softmax
    probabilities (chi-square, p > 1e-3), tail draws beyond the edge borders."""
    num_bars, n = 16, 200_000
    borders = tbar.make_borders(num_bars)
    logits = torch.tensor(np.random.default_rng(3).standard_normal(num_bars), dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    y = tbar.sample(g, borders, logits.expand(n, num_bars).contiguous())
    assert y.shape == (n,) and torch.isfinite(y).all()
    k = torch.searchsorted(borders[1:-1], y, side="right").clamp(0, num_bars - 1)
    counts = torch.bincount(k, minlength=num_bars).numpy()
    p = torch.softmax(logits.double(), -1).numpy()
    expected = p / p.sum() * counts.sum()
    assert stats.chisquare(counts, expected).pvalue > 1e-3
    # tails: the edge buckets extend past borders[1] / borders[-2] half-normally
    assert (y[k == 0] <= borders[1]).all() and (y[k == num_bars - 1] >= borders[-2]).all()
    assert (y < borders[0]).any() and (y > borders[-1]).any()
