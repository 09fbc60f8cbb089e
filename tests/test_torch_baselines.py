"""Port parity: the trained-flow baseline ``FlowNPE`` vs npe_pfn_tpu's.

With the JAX flow's parameters and standardization carried across
(``baselines.params_from_numpy``), ``log_prob`` and the inverse map agree
with JAX's at rtol 1e-5 (f32). The port's own fit is held against the
analytic posterior of gaussian_linear at the tolerances of
tests/test_baselines.py, unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu.baselines import FlowNPE as JaxFlowNPE
from npe_pfn_tpu.tasks import get_task as jax_task
from npe_pfn_tpu_torch import FlowNPE, get_task
from npe_pfn_tpu_torch import baselines
from torch_parity import t

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def flows():
    """A JAX flow fitted a few epochs on 3-D gaussian_linear (so that no last
    layer is zero any more), and the port's flow with its parameters."""
    task = jax_task("gaussian_linear", dim=3)
    theta, x = task.simulate(jax.random.PRNGKey(0), 600)
    jflow = JaxFlowNPE(dim_theta=3, dim_x=3, max_epochs=4, patience=10, seed=0)
    jflow.fit(theta, x)
    flow = FlowNPE(dim_theta=3, dim_x=3, device="cpu")
    flow.params = baselines.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jflow.params), "cpu")
    flow.stats = tuple(t(np.asarray(a)) for a in jflow._stats)
    return jflow, flow, np.asarray(theta), np.asarray(x)


def test_masks_and_parameter_tree_match_jax(flows):
    jflow, flow, _, _ = flows
    from npe_pfn_tpu.baselines import _coupling_masks

    np.testing.assert_array_equal(flow.masks.numpy(), np.asarray(_coupling_masks(3, 6)))
    fresh = FlowNPE(dim_theta=3, dim_x=3, device="cpu")._init_params(torch.Generator())
    assert [[(tuple(w.shape), tuple(b.shape)) for w, b in net] for net in fresh] == \
        [[(w.shape, b.shape) for w, b in net] for net in jflow.params]
    assert all(bool((net[-1][0] == 0).all()) for net in fresh)


def test_log_prob_with_jax_parameters_matches_jax(flows):
    jflow, flow, theta, x = flows
    x_o = x[0]
    ref = np.asarray(jflow.log_prob(jnp.asarray(theta[:64]), jnp.asarray(x_o)))
    np.testing.assert_allclose(flow.log_prob(t(theta[:64]), t(x_o)).numpy(), ref, **TOL)


def test_inverse_with_jax_parameters_matches_jax(flows):
    """The map from base draws to θ (``sample``'s) against JAX's on the same
    draws; and forward after inverse is the identity."""
    jflow, flow, _, x = flows
    rng = np.random.default_rng(0)
    z = rng.standard_normal((128, 3)).astype(np.float32)
    xs = ((x[:128] - np.asarray(jflow._stats[2])) / np.asarray(jflow._stats[3])).astype(np.float32)
    ref = np.asarray(jflow._inverse(jflow.params, jflow._masks, jnp.asarray(z), jnp.asarray(xs)))
    th = baselines.flow_inverse(flow.params, flow.masks, t(z), t(xs))
    np.testing.assert_allclose(th.numpy(), ref, **TOL)
    back, _ = baselines.flow_forward(flow.params, flow.masks, th, t(xs))
    np.testing.assert_allclose(back.numpy(), z, rtol=1e-4, atol=1e-4)


def test_flow_npe_learns_linear_gaussian():
    """tests/test_baselines.py's check on the port's own fit: posterior mean
    within 3.5 posterior sds, std within 35%, mean(log_prob - exact) within
    0.5 nats."""
    task = get_task("gaussian_linear", dim=2, device="cpu")
    theta, x = task.simulate(torch.Generator().manual_seed(0), 2000)
    flow = FlowNPE(dim_theta=2, dim_x=2, max_epochs=150, patience=15, seed=0, device="cpu")
    epochs = flow.fit(theta, x)
    assert 1 <= epochs <= 150 and flow.epochs_trained == epochs
    x_o = torch.tensor([0.8, -0.5])
    s = flow.sample(4000, x_o, generator=torch.Generator().manual_seed(1)).numpy()
    gt = task.posterior_sampler(torch.Generator().manual_seed(2), x_o, 4000)
    g = gt.numpy()
    assert np.abs(s.mean(0) - g.mean(0)).max() < 3.5 * g.std(0).max()
    assert np.all(np.abs(s.std(0) / g.std(0) - 1.0) < 0.35), (s.std(0), g.std(0))
    lp = flow.log_prob(gt[:512], x_o).numpy()
    exact = task.posterior_log_prob(x_o, gt[:512]).numpy()
    assert np.isfinite(lp).all()
    assert np.abs(np.mean(lp - exact)) < 0.5, np.mean(lp - exact)


def test_flow_npe_density_integrates_to_one():
    """exp(log_prob) integrates to about 1 over a grid (1-D, as JAX's test)."""
    task = get_task("gaussian_linear", dim=1, device="cpu")
    theta, x = task.simulate(torch.Generator().manual_seed(3), 1500)
    flow = FlowNPE(dim_theta=1, dim_x=1, max_epochs=100, patience=12, seed=1, device="cpu")
    flow.fit(theta, x)
    grid = torch.linspace(-4.0, 4.0, 2001)[:, None]
    lp = flow.log_prob(grid, torch.tensor([0.3])).numpy()
    integral = float(np.trapezoid(np.exp(lp), grid[:, 0].numpy()))
    assert abs(integral - 1.0) < 0.05, integral


def test_fit_keeps_the_best_epoch_and_stops_on_patience(monkeypatch):
    """Early stopping as JAX's: after the best epoch, ``patience`` epochs
    without a 1e-4 improvement end the fit, and the best epoch's parameters
    are the ones kept (not the last)."""
    reads = iter([1.0, 0.5, 0.49995, 0.6, 0.7, 9.0])
    seen = []

    def fake_nll(params, masks, theta, x):
        out = baselines_nll(params, masks, theta, x)
        if theta.shape[0] == 10:  # the validation split of 100 rows
            val = next(reads)
            seen.append([w.detach().clone() for net in params for w, _ in net])
            return out * 0 + val
        return out

    baselines_nll = baselines.flow_nll
    monkeypatch.setattr(baselines, "flow_nll", fake_nll)
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((100, 2)).astype(np.float32)
    flow = FlowNPE(dim_theta=2, dim_x=2, batch_size=30, max_epochs=50, patience=3, device="cpu")
    assert flow.fit(theta, theta + 0.1) == 5  # best at epoch 2, then 3 without gain
    kept = [w for net in flow.params for w, _ in net]
    assert all(torch.equal(a, b) for a, b in zip(kept, seen[1]))
    assert not all(torch.equal(a, b) for a, b in zip(kept, seen[-1]))
