"""The port's side of the sequential-inference protocols, and their bands.

scripts/calibrate_torch_sequential.py runs these protocols in both packages
to calibrate the bands; chip_smoke.py's phases 20-21 run the ``torch_*``
functions here on the card (seed 0) and hold each reading to its band in
``torch_sequential_bands.json``. This module imports nothing of JAX or of
the JAX package, so that chip_smoke.py does not either.

- ``refine``: two_moons, 1000 simulations, ``sample_refined`` of 1024 draws
  from 8192 proposals (``qry_chunk`` 2048); its ESS, ε and c2st against 1024
  reference-posterior draws (and, unbanded, the plain ``sample``'s c2st);
- ``ratio``: 10-D gaussian_linear, 10k simulations filtered to 2048 rows,
  ``log_prob(mode="ratio_based")`` (4096 posterior draws, 512-row classifier)
  of 10,000 analytic-posterior draws; Pearson r against the analytic
  posterior log-density;
- ``ece``: ``eval.calibration.audit_binary`` (8 logistic tasks, 256 + 256
  rows, 5 features); its ECE and mean |p̂ − p|;
- ``uncond``: ``UnconditionalEstimator`` (4 clusters) on 4096 draws of the
  10-D N(0, 1) prior; of 4096 samples the largest |mean| and the std range
  over dims, and the median |log_prob − prior log_prob| over 4096 fresh prior
  draws.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PROTOCOLS = ("refine", "ratio", "ece", "uncond")
REFINE = dict(num_cal=1000, num_samples=1024, num_proposals=8192, qry_chunk=2048)
RATIO = dict(num_cal=10_000, context=2048, qry_chunk=2048, num_eval=10_000)
UNCOND = dict(num=4096, clusters=4)
# Stream tags: the JAX package splits PRNGKey(seed) into one key per tag; the
# port seeds a torch.Generator with derive_seed(seed, tag).
CAL, OBS, RUN, GT, METRIC = range(5)
BANDED = {"refine": ("c2st", "ess", "eps"), "ratio": ("pearson_r",), "ece": ("ece",),
          "uncond": ("max_abs_mean", "std_min", "std_max", "median_abs_lp_diff")}
BANDS = os.path.join(HERE, "torch_sequential_bands.json")
MIN_HALF_WIDTH = 0.05
MIN_SEEDS = 10


def pearson(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.corrcoef(a, b)[0, 1])


def _uncond_readings(samples, lp, prior_lp) -> dict:
    s = np.asarray(samples, np.float64)
    return {"max_abs_mean": float(np.abs(s.mean(0)).max()), "std_min": float(s.std(0).min()),
            "std_max": float(s.std(0).max()),
            "median_abs_lp_diff": float(np.median(np.abs(np.asarray(lp) - np.asarray(prior_lp))))}


def _gen(device, seed, tag):
    import torch

    from npe_pfn_tpu_torch.utils.seeding import derive_seed

    return torch.Generator(device).manual_seed(derive_seed(seed, tag))


def torch_refine(model, seed):
    from npe_pfn_tpu_torch import NPEPFN
    from npe_pfn_tpu_torch.eval import metrics as M
    from npe_pfn_tpu_torch.tasks import get_task

    dev = model.device
    task = get_task("two_moons", device=dev)
    theta, x = task.simulate(_gen(dev, seed, CAL), REFINE["num_cal"])
    x_o = task.simulate(_gen(dev, seed, OBS), 1)[1][0]
    est = NPEPFN(prior=task.prior, model=model, qry_chunk=REFINE["qry_chunk"])
    est.append_simulations(theta, x)
    post = est.sample_refined(REFINE["num_samples"], x_o, task.simulator,
                              generator=_gen(dev, seed, RUN),
                              num_proposals=REFINE["num_proposals"])
    diag = est.last_refine_diagnostics
    plain = est.sample(REFINE["num_samples"], x_o, generator=_gen(dev, seed, RUN))
    ref = task.posterior_sampler(_gen(dev, seed, GT), x_o, REFINE["num_samples"])
    return {"c2st": float(M.c2st(_gen(dev, seed, METRIC), post, ref)), "ess": diag["ess"],
            "eps": diag["eps"],
            "c2st_plain": float(M.c2st(_gen(dev, seed, METRIC), plain, ref))}


def torch_ratio(model, seed):
    from npe_pfn_tpu_torch import NPEPFN
    from npe_pfn_tpu_torch.tasks import get_task

    dev = model.device
    task = get_task("gaussian_linear", device=dev)
    theta, x = task.simulate(_gen(dev, seed, CAL), RATIO["num_cal"])
    x_o = task.simulate(_gen(dev, seed, OBS), 1)[1][0]
    est = NPEPFN(prior=task.prior, model=model, filter_context_size=RATIO["context"],
                 qry_chunk=RATIO["qry_chunk"])
    est.append_simulations(theta, x)
    theta_eval = task.posterior_sampler(_gen(dev, seed, GT), x_o, RATIO["num_eval"])
    lp = est.log_prob(theta_eval, x_o, generator=_gen(dev, seed, RUN), mode="ratio_based")
    return {"pearson_r": pearson(lp.cpu(), task.posterior_log_prob(x_o, theta_eval).cpu())}


def torch_ece(model, seed):
    from npe_pfn_tpu_torch.eval import calibration

    out = calibration.audit_binary(model, _gen(model.device, seed, RUN))
    return {"ece": out["ece"], "mean_abs_prob_error": out["mean_abs_prob_error"]}


def torch_uncond(model, seed):
    from npe_pfn_tpu_torch import UnconditionalEstimator
    from npe_pfn_tpu_torch.tasks import get_task

    dev = model.device
    prior = get_task("gaussian_linear", device=dev).prior
    est = UnconditionalEstimator(num_clusters=UNCOND["clusters"], model=model, seed=seed)
    est.append_simulations(prior.sample(_gen(dev, seed, CAL), (UNCOND["num"],)))
    samples = est.sample(UNCOND["num"], generator=_gen(dev, seed, RUN))
    theta_eval = prior.sample(_gen(dev, seed, GT), (UNCOND["num"],))
    lp = est.log_prob(theta_eval, generator=_gen(dev, seed, METRIC))
    return _uncond_readings(samples.cpu(), lp.cpu(), prior.log_prob(theta_eval).cpu())


# A fitted classifier context of the ratio density, committed with the
# log-probs the CPU plain path reads on it (scripts/export_ratio_context.py):
# chip_smoke.py phase 20 holds the card's ratio_log_probs on it to them.
RATIO_CONTEXT = os.path.join(HERE, "torch_ratio_context.npz")


def ratio_context(model):
    """(a ``DensityRatioEstimator`` on ``model`` holding the committed
    classifier context, the θ to score ``[n, 10]``, the CPU plain path's
    log-probs ``[n]``), on the model's device."""
    import torch

    from npe_pfn_tpu_torch import DensityRatioEstimator

    dev = model.device
    with np.load(RATIO_CONTEXT) as f:
        data = {k: torch.tensor(f[k].astype(np.float32), device=dev) for k in f.files}
    est = DensityRatioEstimator(model, context_size=data["ctx_theta"].shape[1])
    est._ctx_theta, est._ctx_labels = data["ctx_theta"], data["ctx_labels"]
    est._low, est._high = data["low"], data["high"]
    est._log_u = float(-torch.log((est._high - est._low).clamp_min(1e-12)).sum())
    return est, data["theta_eval"], data["lp_cpu"]
