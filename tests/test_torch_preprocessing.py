"""Port parity for the quantile transforms: npe_pfn_tpu_torch.preprocessing vs
npe_pfn_tpu.preprocessing on the same numpy inputs (f32, CPU).

Tolerance: rtol 1e-6 / atol 1e-6 on every output (f32 sorts, gathers and one
interpolation per value); the knot scores ``ndtri((k + ½) / K)`` agree to the
bit at K 16 and 64.
Inputs cover random masks, tied values, contexts with n <= 1 valid rows,
queries in the core and both tails, and the batched (``_cols``) forms, which
the JAX package ``vmap``s and the port runs with leading batch dims.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import preprocessing as jp
from npe_pfn_tpu_torch import preprocessing as tp
from torch_parity import t

TOL = dict(rtol=1e-6, atol=1e-6)


def _context(kind, n=300, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        y = rng.integers(-3, 4, n).astype(np.float32)  # 7 distinct values
        mask = rng.random(n) < 0.8
    elif kind == "one_valid":
        y = rng.standard_normal(n).astype(np.float32)
        mask = np.zeros(n, bool)
        mask[17] = True
    elif kind == "none_valid":
        y = rng.standard_normal(n).astype(np.float32)
        mask = np.zeros(n, bool)
    else:  # a bimodal sample with a random mask and junk in the masked rows
        y = np.where(rng.random(n) < 0.4, rng.normal(-2, 0.1, n), rng.normal(3, 0.7, n))
        mask = rng.random(n) < 0.7
        y = np.where(mask, y, 1e6).astype(np.float32)
    return y.astype(np.float32), mask


def _queries(y, mask, seed=1):
    """Values inside the knot range, in both tails, and on the data points."""
    rng = np.random.default_rng(seed)
    v = y[mask] if mask.any() else np.zeros(1, np.float32)
    lo, hi = float(v.min()), float(v.max())
    return np.concatenate([rng.uniform(lo - 3, hi + 3, 200), v[:20]]).astype(np.float32)


def _fields(qt):
    return [np.asarray(a) for a in (qt.knots, qt.zknots, qt.slope_lo, qt.slope_hi)]


def _same_transform(tqt, jqt):
    for a, b in zip(_fields(tqt), _fields(jqt)):
        np.testing.assert_allclose(np.broadcast_to(a, b.shape), b, **TOL)


@pytest.mark.parametrize("kind", ["mixture", "ties", "one_valid", "none_valid"])
@pytest.mark.parametrize("num_knots", [64, 16])
def test_fit_forward_inverse_log_det_match_jax(kind, num_knots):
    y, mask = _context(kind)
    jqt = jp.quantile_fit(jnp.asarray(y), jnp.asarray(mask), num_knots)
    tqt = tp.quantile_fit(t(y), t(mask), num_knots)
    _same_transform(tqt, jqt)
    # the knot scores are the JAX package's to the bit (its f32 Cephes ndtri)
    np.testing.assert_array_equal(tqt.zknots.numpy(), np.asarray(jqt.zknots))
    yq = _queries(y, mask)
    z_ref = np.asarray(jp.quantile_forward(jqt, jnp.asarray(yq)))
    np.testing.assert_allclose(tp.quantile_forward(tqt, t(yq)).numpy(), z_ref, **TOL)
    zq = np.linspace(-7, 7, 301).astype(np.float32)
    np.testing.assert_allclose(tp.quantile_inverse(tqt, t(zq)).numpy(),
                               np.asarray(jp.quantile_inverse(jqt, jnp.asarray(zq))), **TOL)
    np.testing.assert_allclose(tp.quantile_log_det(tqt, t(yq)).numpy(),
                               np.asarray(jp.quantile_log_det(jqt, jnp.asarray(yq))), **TOL)


def test_fewer_rows_than_knots_match_jax():
    y, mask = _context("mixture", n=24, seed=3)
    jqt = jp.quantile_fit(jnp.asarray(y), jnp.asarray(mask))
    tqt = tp.quantile_fit(t(y), t(mask))
    assert tqt.knots.shape == (24,)
    _same_transform(tqt, jqt)


def test_batched_fit_matches_vmapped_jax():
    """A [E, N] batch of contexts with per-member masks (the ensemble members)
    against JAX's vmap, and forward / inverse / log_det on [E, Q] values."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((4, 128)).astype(np.float32) * np.array([[1], [3], [0.1], [2]],
                                                                   np.float32)
    mask = rng.random((4, 128)) < 0.9
    jqt = jax.vmap(jp.quantile_fit)(jnp.asarray(y), jnp.asarray(mask))
    tqt = tp.quantile_fit(t(y), t(mask))
    _same_transform(tqt, jqt)
    yq = rng.uniform(-8, 8, (4, 50)).astype(np.float32)
    for tf, jf in ((tp.quantile_forward, jp.quantile_forward),
                   (tp.quantile_inverse, jp.quantile_inverse),
                   (tp.quantile_log_det, jp.quantile_log_det)):
        np.testing.assert_allclose(tf(tqt, t(yq)).numpy(),
                                   np.asarray(jax.vmap(jf)(jqt, jnp.asarray(yq))), **TOL)
    np.testing.assert_allclose(tp.quantile_forward(tqt.select(2), t(yq[2])).numpy(),
                               np.asarray(jp.quantile_forward(
                                   jax.tree_util.tree_map(lambda a: a[2], jqt),
                                   jnp.asarray(yq[2]))), **TOL)


def test_cols_forms_match_jax():
    """quantile_fit_cols / quantile_forward_cols on a context with zero
    (padding) columns and a shared row mask, and the first-w column slice."""
    rng = np.random.default_rng(5)
    x = np.zeros((200, 16), np.float32)
    x[:, :10] = rng.standard_normal((200, 10)) * rng.uniform(0.1, 5, 10)
    x[:, 3] = np.round(x[:, 3])  # ties
    mask = np.arange(200) < 180
    jqts = jp.quantile_fit_cols(jnp.asarray(x), jnp.asarray(mask))
    tqts = tp.quantile_fit_cols(t(x), t(mask))
    _same_transform(tqts, jqts)
    xq = rng.standard_normal((64, 16)).astype(np.float32) * 4
    np.testing.assert_allclose(tp.quantile_forward_cols(tqts, t(xq)).numpy(),
                               np.asarray(jp.quantile_forward_cols(jqts, jnp.asarray(xq))), **TOL)
    jw = jax.tree_util.tree_map(lambda a: a[:8], jqts)
    np.testing.assert_allclose(
        tp.quantile_forward_cols(tqts.first_cols(8), t(xq[:, :8])).numpy(),
        np.asarray(jp.quantile_forward_cols(jw, jnp.asarray(xq[:, :8]))), **TOL)


def test_batched_cols_match_vmapped_jax():
    """Per-member feature maps (batch [E, F]) applied to one shared query
    table, as the featq ensemble does: [E, Q, F] out."""
    rng = np.random.default_rng(6)
    xc = rng.standard_normal((3, 64, 8)).astype(np.float32)
    mask = rng.random((3, 64)) < 0.85
    xq = rng.standard_normal((40, 8)).astype(np.float32) * 2
    jqts = jax.vmap(jp.quantile_fit_cols)(jnp.asarray(xc), jnp.asarray(mask))
    ref = jax.vmap(lambda qm: jp.quantile_forward_cols(qm, jnp.asarray(xq)))(jqts)
    tqts = tp.quantile_fit_cols(t(xc), t(mask))
    out = tp.quantile_forward_cols(tqts, t(xq)[None])
    assert out.shape == (3, 40, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("spec", ["zscore", "quantile", "zscore+featq", "quantile+featq"])
def test_parse_transform_matches_jax(spec):
    assert tp.parse_transform(spec) == jp.parse_transform(spec)


def test_round_trip_and_log_det_against_autograd():
    """Inverse undoes forward, and log_det is log of the forward's slope."""
    y, mask = _context("mixture")
    qt = tp.quantile_fit(t(y), t(mask))
    z = torch.linspace(-6, 6, 301)
    np.testing.assert_allclose(tp.quantile_forward(qt, tp.quantile_inverse(qt, z)).numpy(),
                               z.numpy(), atol=1e-4)
    yq = torch.tensor([-3.0, -2.05, -1.0, 0.5, 2.8, 3.3, 7.0], requires_grad=True)
    slope = torch.autograd.grad(tp.quantile_forward(qt, yq).sum(), yq)[0]
    np.testing.assert_allclose(tp.quantile_log_det(qt, yq.detach()).numpy(),
                               torch.log(slope).numpy(), atol=1e-4)
