"""Truncated sequential NPE-PFN (TSNPE-PFN).

Counterpart of ``npe_pfn_tpu/tsnpe.py``. Each round simulates from the
current proposal, binds ALL rounds' simulations as the estimator's context,
and builds a ``PosteriorSupport`` over the new posterior as the next round's
proposal. One round is plain NPE-PFN. Simulators are the port's batched
``simulator(generator, theta [N, dθ]) -> x [N, ...]``; randomness comes from
one ``torch.Generator`` in sequence.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ._device import resolve_device
from .distributions import Distribution
from .estimator import NPEPFN, run_simulator
from .support import PosteriorSupport

logger = logging.getLogger(__name__)


def simulate_for_sbi(generator: torch.Generator, simulator, proposal: Distribution,
                     num_simulations: int, simulation_batch_size: int = 8192):
    """(θ, x) pairs: θ from ``proposal``, x from the batched ``simulator`` in
    chunks of ``simulation_batch_size`` rows."""
    theta = proposal.sample(generator, (num_simulations,)).float()
    xs = [run_simulator(simulator, generator, chunk)
          for chunk in theta.split(simulation_batch_size)]
    return theta, torch.cat(xs)


def run_tsnpe(
    simulator,
    prior: Distribution,
    observation,
    num_rounds: int = 5,
    num_simulations: int = 1000,
    generator: Optional[torch.Generator] = None,
    estimator: Optional[NPEPFN] = None,
    log_prob_mode: str = "autoregressive",
    sampling_method: str = "rejection",
    filtering: str = "no_filtering",
    allowed_false_negatives: float = 0.0001,
    oversample_sir: int = 32,
    num_samples_to_estimate_support: int = 4096,
    simulation_batch_size: int = 8192,
    support_batch_size: int = 16_384,
    return_proposals: bool = False,
    refine_final: int = 0,
    refine_num_samples: int = 1000,
    refine_kwargs: Optional[dict] = None,
    collect_diagnostics: Optional[list] = None,
    device=None,
    **estimator_kwargs,
):
    """Sequential truncated NPE-PFN; returns the fitted estimator (and the
    per-round proposals with ``return_proposals``).

    Each round simulates ``(num_simulations - refine_final) // num_rounds``
    pairs; fewer than one raises. ``refine_final > 0`` keeps that many
    simulations for a final ``NPEPFN.sample_refined`` pass, whose
    ``refine_num_samples`` draws are appended to the return value.
    ``collect_diagnostics``: a list that receives one dict per truncation round
    (threshold, acceptance or ESS) from one draw of the new proposal, made
    with a generator of its own so that it leaves the run's stream alone.
    The estimator runs on ``device`` (CUDA unless the caller asks for the
    CPU), or on the model's device when ``model=`` is given.
    """
    if refine_final >= num_simulations:
        raise ValueError("refine_final must leave budget for rounds")
    n_per_round = (num_simulations - refine_final) // num_rounds
    if n_per_round < 1:
        raise ValueError(
            f"(num_simulations - refine_final) // num_rounds = ({num_simulations} - "
            f"{refine_final}) // {num_rounds} leaves no simulation per round")
    if estimator is None:
        if "model" not in estimator_kwargs:
            estimator_kwargs["device"] = resolve_device(device)
        estimator = NPEPFN(prior=prior, filter_type=filtering, log_prob_mode=log_prob_mode,
                           **estimator_kwargs)
    dev = estimator.device
    generator = generator or torch.Generator(dev).manual_seed(0)
    observation = estimator._tensor(observation)

    proposal: Distribution = prior
    proposals = [proposal]
    all_theta, all_x = [], []
    for rnd in range(num_rounds):
        theta, x = simulate_for_sbi(generator, simulator, proposal, n_per_round,
                                    simulation_batch_size)
        all_theta.append(theta)
        all_x.append(x)
        estimator.append_simulations(torch.cat(all_theta), torch.cat(all_x))
        logger.info("TSNPE round %d/%d: %d total sims", rnd + 1, num_rounds,
                    estimator.num_simulations)
        if rnd == num_rounds - 1:
            break
        proposal = PosteriorSupport(
            prior=prior, posterior=estimator, x_o=observation, generator=generator,
            num_samples_to_estimate_support=num_samples_to_estimate_support,
            allowed_false_negatives=allowed_false_negatives, sampling_method=sampling_method,
            oversample_sir=oversample_sir, batch_size=support_batch_size)
        proposals.append(proposal)
        if collect_diagnostics is not None:
            # One draw of the proposal that makes the next round's θ, from
            # its own stream: the run's draws are the same with or without it.
            diag_gen = torch.Generator(dev).manual_seed(rnd + 1)
            proposal.sample(diag_gen, (min(1024, n_per_round),))
            collect_diagnostics.append({
                "round": rnd + 1,
                "log_prob_threshold": proposal.log_prob_threshold,
                **{k: v for k, v in proposal.last_diagnostics.items()
                   if isinstance(v, (int, float, bool))},
            })

    out = [estimator]
    if return_proposals:
        out.append(proposals)
    if refine_final > 0:
        out.append(estimator.sample_refined(
            refine_num_samples, observation, simulator, generator=generator,
            num_proposals=refine_final, **(refine_kwargs or {})))
    return out[0] if len(out) == 1 else tuple(out)
