"""Port parity for the quantile target and feature transforms ("quantile",
"zscore+featq", "quantile+featq") in the autoregressive sampler and scorer,
vs npe_pfn_tpu (f32, CPU).

``autoregressive_log_prob`` under every transform spec is held to rtol 1e-4 /
atol 1e-4 (the ``test_torch_estimator.py`` tolerance), with prefix-width
slicing active. Samples of ``NPEPFN.sample`` with each transform are held by
distribution: per-dimension two-sample KS against JAX's sampler on the same
model and context, p > 1e-3 for each dimension.
"""

import numpy as np
import pytest

from npe_pfn_tpu import estimator as je
from npe_pfn_tpu_torch import estimator as te
from test_torch_ensemble import SPECS, TOL, _eval_rows, _sims, check_samples, models  # noqa: F401
from torch_parity import t


@pytest.mark.parametrize("spec", SPECS)
def test_autoregressive_log_prob_transforms_match_jax(models, spec):
    jm, tm = models
    theta, x = _sims(128)
    cm = np.arange(128) < 110
    xq, th_eval = _eval_rows(64)
    ref = np.asarray(je.autoregressive_log_prob(jm, theta, x, cm, xq, th_eval, qry_chunk=32,
                                                target_transform=spec))
    out = te.autoregressive_log_prob(tm, t(theta), t(x), t(cm), t(xq), t(th_eval),
                                     qry_chunk=32, target_transform=spec)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("spec", ["quantile", "zscore+featq", "quantile+featq"])
def test_samples_match_jax_in_distribution(models, spec):  # noqa: F811
    check_samples(models, spec, 1)
