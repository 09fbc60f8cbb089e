"""Port parity for the batched and density API of NPEPFN: sample_batched (and
its rejection with the per-observation escape hatch), sample_batched_filtered,
log_prob, log_prob_batched, accept_reject_sample and pickling, vs
npe_pfn_tpu (f32, CPU).

Tolerances: the rejection loops, fed the same fixed proposals in both
packages, must agree exactly (rows, log-probs, top-ups, acceptance); log_prob
and log_prob_batched against JAX at rtol 1e-4 / atol 1e-4 (the
``test_torch_estimator.py`` tolerance), on contexts both packages build alike
(a deterministic filter, or n <= context size); the port's own rescoring at
the same tolerance. Samples are held by distribution: per-dimension
two-sample KS, p > 1e-3 for each dimension.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu import rejection as jrej
from npe_pfn_tpu.distributions import BoxUniform as JaxBox
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN, rejection
from npe_pfn_tpu_torch.distributions import BoxUniform, Normal
from torch_parity import port_model, t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    return jm, port_model(jm)


def _sims(n, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n, 2)).astype(np.float32)
    x = (theta @ np.array([[1.0, 0.3, -0.5], [0.2, -1.0, 0.7]], np.float32)
         + 0.2 * rng.standard_normal((n, 3))).astype(np.float32)
    return theta, x


def _est(tm, prior=None, n=256, ctx=128, qry_chunk=64, seed=0, **kw):
    theta, x = _sims(n)
    est = NPEPFN(prior=prior, model=tm, filter_context_size=ctx, qry_chunk=qry_chunk,
                 seed=seed, **kw)
    est.append_simulations(t(theta), t(x))
    return est, x


def test_sample_batched_shapes_and_diagnostics(models):
    _, tm = models
    est, x = _est(tm, prior=Normal(torch.zeros(2), torch.ones(2)))
    theta, lp = est.sample_batched((4, 8), t(x[:3]), return_log_probs=True, obs_chunk=2)
    assert theta.shape == (3, 32, 2) and lp.shape == (3, 32)
    assert torch.isfinite(theta).all() and torch.isfinite(lp).all()
    d = est.last_diagnostics
    assert d["topped_up"].tolist() == [0, 0, 0] and d["acceptance_rate"] == 1.0
    assert d["rounds"] == 2  # one round per chunk of observations
    one = est.sample_batched(5, t(x[0]), with_log_prob=True)
    assert one[0].shape == (1, 5, 2) and one[1].shape == (1, 5)


def test_sample_options(models, capsys):
    """A tuple sample shape, with_log_prob, and show_progress (the host loop's
    progress line)."""
    _, tm = models
    est, x = _est(tm, prior=Normal(torch.zeros(2), torch.ones(2)))
    theta, lp = est.sample((3, 10), t(x[0]), with_log_prob=True, show_progress=True)
    assert theta.shape == (30, 2) and lp.shape == (30,)
    assert "accept_reject: 30/30" in capsys.readouterr().out


def test_no_prior_path(models):
    """Without a prior: no oversampling, one round, nothing topped up."""
    _, tm = models
    est, x = _est(tm)
    seen = []
    draw = est._draw_group
    est._draw_group = lambda g, xs, n_over, ctx: seen.append(n_over) or draw(g, xs, n_over, ctx)
    theta = est.sample_batched(40, t(x[:2]), max_iters=5)
    assert theta.shape == (2, 40, 2) and seen == [40]
    assert est.last_diagnostics["topped_up"].tolist() == [0, 0]
    assert est.last_diagnostics["acceptance_rate"] == 1.0


def _fixed_group(m, n_over, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-2, 2, (m, n_over, 2)).astype(np.float32)
    return s, (-np.arange(m * n_over, dtype=np.float32)).reshape(m, n_over)


@pytest.mark.parametrize("box,num,max_iters", [
    ((-1.0, 1.0), 24, 3),  # a quarter of the square: partial acceptance, some top-ups
    ((-0.2, 0.2), 24, 1),  # a tight box: short observations after one round
    ((50.0, 51.0), 24, 2),  # nothing accepted: every row from the escape hatch
    ((-1.5, 1.5), 10, 4),
])
def test_batched_rejection_matches_jax_fused_loop(models, box, num, max_iters):
    """With _draw_group stubbed to one fixed [m, n_over] batch in both
    packages, the port's batched rejection and the JAX fused loop return
    the same rows, log-probs, top-ups and acceptance."""
    jm, tm = models
    theta, x = _sims(100, seed=1)
    m, n_over = 3, int(np.ceil(num * 1.5))
    s, lp = _fixed_group(m, n_over, seed=num + max_iters)
    ref = JaxNPEPFN(prior=JaxBox(jnp.full(2, box[0]), jnp.full(2, box[1])), model=jm,
                    filter_context_size=128, qry_chunk=16)
    ref.append_simulations(theta, x)
    ref._draw_group = lambda k, xs, n, ctx, model=None: (jnp.asarray(s), jnp.asarray(lp))
    jt, jlp = ref.sample_batched(num, x[:m], rng=jax.random.PRNGKey(0), max_iters=max_iters,
                                 return_log_probs=True)
    est = NPEPFN(prior=BoxUniform(torch.full((2,), box[0]), torch.full((2,), box[1])),
                 model=tm, filter_context_size=128, qry_chunk=16)
    est.append_simulations(t(theta), t(x))
    est._draw_group = lambda g, xs, n, ctx: (t(s), t(lp))
    tt, tlp = est.sample_batched(num, t(x[:m]), max_iters=max_iters, return_log_probs=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    np.testing.assert_array_equal(est.last_diagnostics["topped_up"].numpy(),
                                  np.asarray(ref.last_diagnostics["topped_up"]))
    assert est.last_diagnostics["acceptance_rate"] == pytest.approx(
        ref.last_diagnostics["acceptance_rate"], rel=1e-6)


@pytest.mark.parametrize("box,max_iters", [((50.0, 51.0), 2), ((-0.2, 0.2), 1)])
def test_escape_hatch(models, box, max_iters):
    """tests/test_escape_hatch_parity.py on the port: exact top-up counts, no
    duplicate rows within an observation, and accepted rows first, never
    displaced by fills (which come from the rejected rows)."""
    _, tm = models
    lo, hi = box
    est, _ = _est(tm, prior=BoxUniform(torch.full((2,), lo), torch.full((2,), hi)))
    x = torch.linspace(-1.0, 1.0, 6).reshape(3, 2)
    x = torch.cat([x, x[:, :1]], dim=1)  # dx = 3
    theta = est.sample_batched(24, x, max_iters=max_iters, oversample=1.5)
    diag = est.last_diagnostics
    assert theta.shape == (3, 24, 2) and torch.isfinite(theta).all()
    inside = ((theta >= lo) & (theta <= hi)).all(dim=-1)
    if lo > 10:
        assert diag["topped_up"].tolist() == [24, 24, 24] and diag["acceptance_rate"] == 0.0
    for j in range(3):
        n_acc = 24 - int(diag["topped_up"][j])
        assert inside[j, :n_acc].all() and not inside[j, n_acc:].any()
        assert len({tuple(r) for r in np.round(theta[j].numpy(), 6)}) == 24


def test_sample_batched_matches_per_observation_sample(models):
    """With n <= context size both calls see every simulation, so the batched
    draw and per-observation sample() hold the same distribution."""
    _, tm = models
    est, x = _est(tm, prior=Normal(torch.zeros(2), torch.ones(2)), n=200, ctx=256,
                  qry_chunk=256)
    xs = t(x[[4, 9]])
    batched = est.sample_batched(1024, xs, generator=torch.Generator().manual_seed(1))
    for j in range(2):
        single = est.sample(1024, xs[j], generator=torch.Generator().manual_seed(2 + j))
        for d in range(2):
            p = stats.ks_2samp(batched[j, :, d].numpy(), single[:, d].numpy()).pvalue
            assert p > 1e-3, (j, d, p)


@pytest.mark.parametrize("kw", [{}, dict(num_order_ensembles=2), dict(num_ensembles=2)])
def test_sample_batched_filtered_log_probs_rescore(models, kw):
    """Each observation's draws come from its own filtered context: their
    log-probs equal log_prob on that observation alone (the mixture density
    for context ensembles; each row's own order for order ensembles)."""
    _, tm = models
    est, x = _est(tm, n=400, ctx=128, qry_chunk=64, **kw)
    xs = t(x[:3] + 0.1)
    theta, lp = est.sample_batched_filtered(100, xs, obs_chunk=2, return_log_probs=True)
    assert theta.shape == (3, 100, 2) and lp.shape == (3, 100)
    if kw.get("num_order_ensembles"):
        return  # per-order densities; the mixture is held in test_torch_ensemble.py
    for j in range(3):
        np.testing.assert_allclose(lp[j].numpy(), est.log_prob(theta[j], xs[j]).numpy(), **TOL)


def test_log_prob_matches_jax(models):
    """A deterministic filter (nearest 128 of 400) in both packages, and θ
    scored in chunks of max_sampling_batch_size."""
    jm, tm = models
    theta, x = _sims(400, seed=2)
    th_eval = (1.3 * np.random.default_rng(3).standard_normal((150, 2))).astype(np.float32)
    ref = JaxNPEPFN(model=jm, filter_context_size=128, qry_chunk=32)
    ref.append_simulations(theta, x)
    est = NPEPFN(model=tm, filter_context_size=128, qry_chunk=32)
    est.append_simulations(t(theta), t(x))
    want = np.asarray(ref.log_prob(th_eval, x[7], max_sampling_batch_size=64))
    got = est.log_prob(t(th_eval), t(x[7]), max_sampling_batch_size=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kw", [{}, dict(num_ensembles=2, target_transform="quantile")])
def test_log_prob_batched_matches_jax(models, kw):
    """n <= context size: random_filtering returns every row in both."""
    jm, tm = models
    theta, x = _sims(120, seed=4)
    th_eval = np.random.default_rng(5).standard_normal((3, 40, 2)).astype(np.float32)
    ref = JaxNPEPFN(model=jm, filter_context_size=128, qry_chunk=32, **kw)
    ref.append_simulations(theta, x)
    est = NPEPFN(model=tm, filter_context_size=128, qry_chunk=32, **kw)
    est.append_simulations(t(theta), t(x))
    want = np.asarray(ref.log_prob_batched(th_eval, x[:3], max_sampling_batch_size=50))
    got = est.log_prob_batched(t(th_eval), t(x[:3]), max_sampling_batch_size=50)
    assert got.shape == (3, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("num,max_iters", [(50, 1), (50, 4), (20, 10)])
def test_accept_reject_sample_matches_jax(num, max_iters):
    """The host-driven loop fed the same fixed proposals in both packages:
    identical rows, aux and acceptance, escape hatch included."""
    rng = np.random.default_rng(num + max_iters)
    s = rng.uniform(-2, 2, (32, 2)).astype(np.float32)
    aux = np.arange(32, dtype=np.float32)
    js, jaux, jacc = jrej.accept_reject_sample(
        jax.random.PRNGKey(0), lambda k, n: (jnp.asarray(s), jnp.asarray(aux)),
        lambda v: jnp.all(jnp.abs(v) < 1.0, axis=-1), num, batch_size=32, max_iters=max_iters)
    ts, taux, tacc = rejection.accept_reject_sample(
        torch.Generator(), lambda g, n: (t(s), t(aux)),
        lambda v: (v.abs() < 1.0).all(dim=-1), num, batch_size=32, max_iters=max_iters,
        show_progress=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    assert tacc == pytest.approx(jacc, rel=1e-6)


def test_pickle_round_trip(models):
    """Data, options and the generator's state survive pickling: the copy
    draws what the original draws next."""
    _, tm = models
    est, x = _est(tm, prior=Normal(torch.zeros(2), torch.ones(2)), num_order_ensembles=2,
                  target_transform="quantile", seed=5)
    est.sample(8, t(x[0]))  # move the generator
    copy = pickle.loads(pickle.dumps(est))
    assert copy.num_simulations == est.num_simulations == 256
    assert copy.target_transform == "quantile" and copy.num_order_ensembles == 2
    assert torch.equal(copy._x_train, est._x_train)
    a, b = est.sample((2, 8), t(x[1])), copy.sample((2, 8), t(x[1]))
    assert a.shape == (16, 2)
    assert torch.equal(a, b)
