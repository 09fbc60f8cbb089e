"""Port parity for the slice as a whole: TSNPE-PFN (tsnpe.run_tsnpe,
simulate_for_sbi) vs npe_pfn_tpu.tsnpe on the CPU.

Both packages run the shipped checkpoint in f32 on the same task (3-D
gaussian_linear) and budget (2 rounds of 128 simulations, rejection-mode
truncation); their posteriors at one observation agree in distribution:
per-dim KS p > 0.01 or c2st <= 0.6 between the two packages' draws. The
simulations differ (each package draws its own), so the draws are compared,
not the numbers. The rest runs a small random model: the round budget, the
per-round diagnostics (the JAX package's keys), proposals, the final
refinement, and the two deliberate divergences: the diagnostics draw comes
from a generator of its own and leaves the run unchanged, and a budget that
leaves no simulation per round raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from npe_pfn_tpu.models import checkpoint as jckpt
from npe_pfn_tpu.tasks import get_task as jax_get_task
from npe_pfn_tpu.tsnpe import run_tsnpe as jax_run_tsnpe
from npe_pfn_tpu_torch import NPEPFN, PosteriorSupport
from npe_pfn_tpu_torch.distributions import BoxUniform
from npe_pfn_tpu_torch.eval import metrics as M
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
from npe_pfn_tpu_torch.tasks import get_task
from npe_pfn_tpu_torch.tsnpe import run_tsnpe, simulate_for_sbi
from torch_parity import SHIPPED, port_model

torch.set_num_threads(2)
ROUND_KW = dict(num_rounds=2, num_simulations=256, qry_chunk=256,
                num_samples_to_estimate_support=256, support_batch_size=256)


@pytest.fixture(scope="module")
def tiny():
    cfg = TabICAConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                       dtype="float32")
    return TabICAModel.create(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))


def _box_task():
    task = get_task("two_moons", device="cpu")
    return task.simulator, task.prior


def test_tsnpe_posterior_matches_jax_in_distribution():
    jm = jckpt.load(SHIPPED)
    jm = dataclasses.replace(jm, cfg=dataclasses.replace(jm.cfg, dtype="float32",
                                                         scores_dtype="float32"))
    tm = port_model(jm)
    jtask, task = jax_get_task("gaussian_linear", dim=3), get_task("gaussian_linear", dim=3,
                                                                   device="cpu")
    x_o = np.array([0.8, -0.4, 1.5], np.float32)
    jdiag, tdiag = [], []
    jest = jax_run_tsnpe(jtask.simulator, jtask.prior, jnp.asarray(x_o),
                         rng=jax.random.PRNGKey(0), model=jm, collect_diagnostics=jdiag,
                         **ROUND_KW)
    test = run_tsnpe(task.simulator, task.prior, torch.tensor(x_o),
                     generator=torch.Generator().manual_seed(0), model=tm,
                     collect_diagnostics=tdiag, **ROUND_KW)
    assert jest.num_simulations == test.num_simulations == 256
    assert [set(d) - {"rounds"} for d in tdiag] == [set(d) for d in jdiag]
    js = np.asarray(jest.sample(256, jnp.asarray(x_o), rng=jax.random.PRNGKey(1)))
    ts = test.sample(256, torch.tensor(x_o), generator=torch.Generator().manual_seed(1))
    ks = [stats.ks_2samp(js[:, d], ts[:, d].numpy()).pvalue for d in range(3)]
    c2st = float(M.c2st(torch.Generator().manual_seed(2), torch.tensor(js), ts))
    assert min(ks) > 0.01 or c2st <= 0.6, (ks, c2st)
    # Both near the analytic posterior: N(0.735 x, 0.514^2) per dim.
    mu, sd = task.posterior_moments(torch.tensor(x_o))
    assert float(((ts.mean(0) - mu).abs() / sd).max()) < 1.0


def test_rounds_diagnostics_proposals_and_refinement(tiny):
    sim, prior = _box_task()
    diags = []
    est, proposals, refined = run_tsnpe(
        sim, prior, torch.zeros(2), num_rounds=3, num_simulations=512, model=tiny,
        filter_context_size=128, qry_chunk=64, num_samples_to_estimate_support=128,
        support_batch_size=256, return_proposals=True, refine_final=128, refine_num_samples=32,
        collect_diagnostics=diags, generator=torch.Generator().manual_seed(3))
    assert est.num_simulations == 3 * ((512 - 128) // 3)
    assert proposals[0] is prior and all(isinstance(p, PosteriorSupport) for p in proposals[1:])
    assert len(proposals) == 3 and [d["round"] for d in diags] == [1, 2]
    assert {"log_prob_threshold", "acceptance_rate", "prereject_keep_rate",
            "padded"} <= set(diags[0])
    assert refined.shape == (32, 2) and est.last_refine_diagnostics["num_proposals"] == 128
    sir = []
    run_tsnpe(sim, prior, torch.zeros(2), num_rounds=2, num_simulations=128, model=tiny,
              filter_context_size=64, qry_chunk=64, num_samples_to_estimate_support=64,
              sampling_method="sir", oversample_sir=4, collect_diagnostics=sir)
    assert set(sir[0]) == {"round", "log_prob_threshold", "ess_fraction", "dead_groups"}


def test_diagnostics_draw_leaves_the_run_unchanged(tiny):
    """Deliberate divergence: JAX splits the diagnostics key off the run's
    stream, so collecting diagnostics changes the simulations of later rounds."""
    sim, prior = _box_task()

    def run(diag):
        est = run_tsnpe(sim, prior, torch.zeros(2), num_rounds=3, num_simulations=192,
                        model=tiny, filter_context_size=128, qry_chunk=64,
                        num_samples_to_estimate_support=64, support_batch_size=256,
                        collect_diagnostics=diag, generator=torch.Generator().manual_seed(4))
        return est._theta_train, est._x_train

    diags = []
    plain, with_diag = run(None), run(diags)
    assert len(diags) == 2
    assert torch.equal(plain[0], with_diag[0]) and torch.equal(plain[1], with_diag[1])


def test_budget_checks(tiny):
    """A budget that leaves no simulation per round raises (deliberate
    divergence: the JAX package checks only refine_final < num_simulations and
    would run rounds of zero simulations)."""
    sim, prior = _box_task()
    with pytest.raises(ValueError, match="no simulation per round"):
        run_tsnpe(sim, prior, torch.zeros(2), num_rounds=5, num_simulations=4, model=tiny)
    with pytest.raises(ValueError, match="no simulation per round"):
        run_tsnpe(sim, prior, torch.zeros(2), num_rounds=2, num_simulations=64,
                  refine_final=63, model=tiny)
    with pytest.raises(ValueError, match="refine_final"):
        run_tsnpe(sim, prior, torch.zeros(2), num_rounds=1, num_simulations=64,
                  refine_final=64, model=tiny)


def test_one_round_is_plain_npe(tiny):
    sim, prior = _box_task()
    est, proposals = run_tsnpe(sim, prior, torch.zeros(2), num_rounds=1, num_simulations=100,
                               model=tiny, return_proposals=True, qry_chunk=64)
    assert isinstance(est, NPEPFN) and est.num_simulations == 100 and proposals == [prior]
    assert est.sample(16, torch.zeros(2)).shape == (16, 2)


def test_simulate_for_sbi_chunks_and_checks_the_simulator():
    sim, prior = _box_task()
    theta, x = simulate_for_sbi(torch.Generator().manual_seed(5), sim, prior, 1000,
                                simulation_batch_size=300)
    assert theta.shape == (1000, 2) and x.shape == (1000, 2)
    assert bool(prior.support_check(theta).all())
    box = BoxUniform(torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError, match="batched"):
        simulate_for_sbi(torch.Generator(), lambda g, th: th[0], box, 10)
