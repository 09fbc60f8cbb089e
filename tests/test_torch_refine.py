"""Port parity: simulator-in-the-loop refinement (NPEPFN.sample_refined, the
ABC weights of estimator.abc_log_weights, and the harness's
refine_num_proposals) vs npe_pfn_tpu (f32, CPU).

Given the same proposals and the same (noise-free) simulations, the
diagnostics that the weights determine — ESS, ε, the smallest distance and
the uniform fallback — match JAX's to rtol 1e-4 (gaussian and hard kernels,
a given ε, the all-dead fallback), and to rtol 1e-3 with the importance
correction (which adds the autoregressive log_prob, parity 1e-4). Resampled
rows are proposals, and under the hard kernel only those within ε.
Deliberate divergence: a simulator that is not batched raises, where JAX
falls back to a per-row host loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu import NPEPFN as JaxNPEPFN
from npe_pfn_tpu import distributions as jd
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu_torch import NPEPFN
from npe_pfn_tpu_torch import distributions as td
from npe_pfn_tpu_torch.estimator import abc_log_weights
from npe_pfn_tpu_torch.eval import harness
from npe_pfn_tpu_torch.tasks import Task
from torch_parity import port_model, t

torch.set_num_threads(2)
DTH, DX = 2, 3
W = np.random.default_rng(42).standard_normal((DX, DTH)).astype(np.float32)


def jax_sim(key, theta):  # noise-free: both packages simulate the same x
    return jnp.asarray(theta) @ jnp.asarray(W).T + jnp.sin(3.0 * theta[0]) + 1.0


def port_sim(generator, theta):
    return theta @ t(W).T + torch.sin(3.0 * theta[:, :1]) + 1.0


@pytest.fixture(scope="module")
def ests():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    theta = rng.standard_normal((300, DTH)).astype(np.float32)
    x = (port_sim(None, t(theta)) + 0.05 * t(rng.standard_normal((300, DX)).astype(
        np.float32))).numpy()
    lo, hi = -3 * np.ones(DTH, np.float32), 3 * np.ones(DTH, np.float32)
    kw = dict(filter_context_size=64, qry_chunk=32)
    je = JaxNPEPFN(prior=jd.BoxUniform(jnp.asarray(lo), jnp.asarray(hi)), model=jm, **kw)
    je.append_simulations(theta, x)
    te = NPEPFN(prior=td.BoxUniform(t(lo), t(hi)), model=port_model(jm), **kw)
    te.append_simulations(t(theta), t(x))
    x_o = port_sim(None, torch.zeros(1, DTH))[0].numpy()
    return je, te, x_o


PROPOSALS = np.random.default_rng(3).uniform(-2, 2, (512, DTH)).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(eps_quantile=0.1), dict(eps=0.7),
                                dict(kernel="hard", eps_quantile=0.05),
                                dict(kernel="hard", eps=1e-9)])
def test_weights_match_jax_given_the_same_proposals(ests, monkeypatch, kw):
    je, te, x_o = ests
    monkeypatch.setattr(je, "sample", lambda *a, **k: jnp.asarray(PROPOSALS), raising=False)
    monkeypatch.setattr(te, "sample", lambda *a, **k: t(PROPOSALS), raising=False)
    je.sample_refined(128, x_o, jax_sim, rng=jax.random.PRNGKey(0), num_proposals=512, **kw)
    out = te.sample_refined(128, t(x_o), port_sim, generator=torch.Generator().manual_seed(0),
                            num_proposals=512, **kw)
    want, got = je.last_refine_diagnostics, te.last_refine_diagnostics
    assert set(got) == set(want) and got["num_proposals"] == 512
    assert got["fallback_uniform"] == want["fallback_uniform"]
    for key in ("ess", "eps", "min_distance"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    rows = {tuple(r) for r in PROPOSALS.tolist()}
    assert out.shape == (128, DTH) and all(tuple(r) in rows for r in out.tolist())
    if kw.get("kernel") == "hard" and not got["fallback_uniform"]:
        d = torch.linalg.vector_norm((port_sim(None, out) - t(x_o))
                                     / te._x_train.std(0, correction=0), dim=-1)
        assert bool((d <= got["eps"] + 1e-6).all())


def test_importance_correction_matches_jax(ests, monkeypatch):
    je, te, x_o = ests
    monkeypatch.setattr(je, "sample", lambda *a, **k: jnp.asarray(PROPOSALS), raising=False)
    monkeypatch.setattr(te, "sample", lambda *a, **k: t(PROPOSALS), raising=False)
    je.sample_refined(64, x_o, jax_sim, rng=jax.random.PRNGKey(0), num_proposals=512,
                      importance_correct=True)
    te.sample_refined(64, t(x_o), port_sim, generator=torch.Generator().manual_seed(0),
                      num_proposals=512, importance_correct=True)
    np.testing.assert_allclose(te.last_refine_diagnostics["ess"],
                               je.last_refine_diagnostics["ess"], rtol=1e-3)


def test_abc_log_weights_kernels_and_fallback():
    d = torch.tensor([0.1, 0.2, 0.4, 0.8])
    logw, eps, ess, dead = abc_log_weights(d, eps=0.2)
    np.testing.assert_allclose(logw.numpy(), -0.5 * (d.numpy() / 0.2) ** 2, rtol=1e-6)
    w = np.exp(logw.numpy()) / np.exp(logw.numpy()).sum()
    np.testing.assert_allclose(float(ess), 1.0 / (w**2).sum(), rtol=1e-5)
    logw, eps, ess, dead = abc_log_weights(d, eps=0.25, kernel="hard")
    assert logw.tolist() == [0.0, 0.0, -np.inf, -np.inf] and float(ess) == 2.0 and not dead
    logw, eps, ess, dead = abc_log_weights(d, eps=0.0, kernel="hard")
    assert bool(dead) and float(eps) == pytest.approx(1e-8) and logw.tolist() == [0.0] * 4
    logw, *_ = abc_log_weights(d, eps=0.2, log_correction=torch.tensor([0.0, 1.0, -np.inf, 0.5]))
    assert logw[2].item() == -np.inf and logw[1].item() == pytest.approx(1.0 - 0.5)
    with pytest.raises(ValueError, match="kernel"):
        abc_log_weights(d, kernel="box")


def test_refined_samples_move_toward_the_observation(ests):
    _, te, x_o = ests
    gen = torch.Generator().manual_seed(5)
    props = te.sample(512, t(x_o), generator=gen)
    refined = te.sample_refined(256, t(x_o), port_sim, generator=gen, num_proposals=1024,
                                eps_quantile=0.05)
    diag = te.last_refine_diagnostics

    def dist(th):
        return float(torch.linalg.vector_norm(port_sim(None, th) - t(x_o), dim=-1).mean())

    assert dist(refined) < dist(props)
    assert 1.0 <= diag["ess"] <= 1024 and not diag["fallback_uniform"]


def test_simulator_that_is_not_batched_raises(ests):
    """Deliberate divergence: no per-row host loop behind a simulator that
    does not map [N, dθ] to [N, ...]."""
    _, te, x_o = ests
    with pytest.raises(ValueError, match="batched"):
        te.sample_refined(16, t(x_o), lambda g, th: th[0] @ t(W).T, num_proposals=64)
    with pytest.raises(ValueError, match="batched"):
        te.sample_refined(16, t(x_o), lambda g, th: th.sum(), num_proposals=64)
    with pytest.raises(ValueError, match="kernel"):
        te.sample_refined(16, t(x_o), port_sim, kernel="box")


def test_x_shape_embedding_sees_simulations_in_shape(ests):
    """As JAX's test_x_shape_refine_embedding: the simulated proposals reach
    the embedding net in x_shape, like the context and the observation."""
    _, te, x_o = ests
    seen = []

    def embed(x):
        seen.append(tuple(x.shape[1:]))
        return x.reshape(x.shape[0], -1)[:, :2]

    e = NPEPFN(prior=te.prior, model=te.model, filter_context_size=64, qry_chunk=32,
               embedding_net=embed, x_shape=(3, 1))
    e.append_simulations(te._theta_train, port_sim(None, te._theta_train))
    out = e.sample_refined(16, t(x_o), port_sim, generator=torch.Generator().manual_seed(0),
                           num_proposals=64, max_iters=1)
    assert out.shape == (16, DTH) and set(seen) == {(3, 1)}


def test_harness_refine_cells(ests):
    """refine_num_proposals > 0: the JAX harness's cell keys, the budget
    accounting and the mean ESS; a task scored by the joint diagnostic raises."""
    _, te, _ = ests

    def gt_sampler(generator, x_o, n):
        return torch.randn((n, DTH), generator=generator)

    task = Task("toy", te.prior, port_sim, DTH, DX, posterior_sampler=gt_sampler)
    res = harness.evaluate_task(task, num_cal_grid=[64], seeds=[0], num_test=4,
                                num_posterior_samples=16, n_obs_eval=1,
                                estimator_kwargs=dict(model=te.model, qry_chunk=32),
                                refine_num_proposals=64, device="cpu")
    cell = res["cells"]["num_cal=64/seed=0"]
    assert set(cell) == {"wall_s", "c2st", "wasserstein", "mmd", "sims_refine_per_obs",
                         "sims_total_per_obs", "refine_ess_mean"}
    assert (cell["sims_refine_per_obs"], cell["sims_total_per_obs"]) == (64, 128)
    assert 1.0 <= cell["refine_ess_mean"] <= 64.0
    joint = Task("joint", te.prior, port_sim, DTH, DX)
    with pytest.raises(ValueError, match="ground-truth sampler"):
        harness.evaluate_task(joint, num_cal_grid=[64], seeds=[0], num_test=4,
                              estimator_kwargs=dict(model=te.model, qry_chunk=32),
                              refine_num_proposals=64, device="cpu")
