"""Port parity: the classifier calibration audit (eval.calibration), the
roofline model (utils.roofline) and the phase timers and trace
(utils.profiling) vs npe_pfn_tpu's, on the CPU.

``reliability_curve`` and ``ece`` of the same arrays equal JAX's exactly
(both are numpy). The audits score JAX's own synthetic tasks (its
``_binary_task`` draws, and its multi-class draws made as its
``audit_multiclass`` makes them): ECE, mean |p̂ − p|, Brier and accuracy
agree to 2e-4 absolute (f32 probabilities, rtol 1e-3 on each). The roofline
with JAX's peaks passed in equals JAX's numbers; its defaults are the H100's.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npe_pfn_tpu.eval import calibration as jcal
from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.utils import roofline as jroof
from npe_pfn_tpu_torch.eval import calibration as tcal
from npe_pfn_tpu_torch.models import TabICAConfig
from npe_pfn_tpu_torch.utils import profiling, roofline
from torch_parity import port_model

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                    dtype="float32")
    jm = JaxModel.create(jax.random.PRNGKey(8), cfg)
    return jm, port_model(jm)


def test_reliability_curve_and_ece_equal_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(size=500)
    p[:7] = [0.0, 1.0, 0.5, 1.0 / 15, 2.0 / 15, 0.999999, 1e-9]
    y = (rng.uniform(size=500) < p ** 1.3).astype(np.float64)
    for bins in (5, 15):
        want, got = jcal.reliability_curve(p, y, bins), tcal.reliability_curve(p, y, bins)
        assert json.dumps(got) == json.dumps(want)
        assert tcal.ece(p, y, bins) == jcal.ece(p, y, bins)
    assert tcal.ece(torch.tensor(p), torch.tensor(y)) == jcal.ece(p, y)


@pytest.mark.parametrize("link", ["logistic", "mlp"])
def test_binary_audit_on_jax_tasks_matches(models, link):
    jm, tm = models
    key = jax.random.PRNGKey(11)
    want = jcal.audit_binary(jm, key, num_tasks=3, n_ctx=96, n_qry=80, dim=4, link=link)
    tasks = [tuple(np.array(a) for a in jcal._binary_task(jax.random.fold_in(key, i), 96, 80,
                                                             4, link)) for i in range(3)]
    got = tcal.score_binary(tm, tasks, link)
    assert got["n"] == want["n"] == 240
    for k in ("ece", "mean_abs_prob_error", "brier", "brier_true_p"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=2e-4, err_msg=k)
    drawn = tcal.audit_binary(tm, torch.Generator().manual_seed(0), num_tasks=2, n_ctx=64,
                              n_qry=32, link=link)
    assert drawn["n"] == 64 and 0 <= drawn["ece"] <= 1


def test_multiclass_audit_on_jax_tasks_matches(models):
    jm, tm = models
    key = jax.random.PRNGKey(12)
    want = jcal.audit_multiclass(jm, key, num_tasks=2, n_ctx=96, n_qry=64, dim=4, num_classes=3)
    tasks = []
    for i in range(2):  # the draws of JAX's audit_multiclass
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i), 3)
        x = jax.random.normal(k1, (160, 4))
        w = jax.random.normal(k2, (4, 3)) * (2.0 / jnp.sqrt(4))
        labels = jax.random.categorical(k3, jnp.log(jax.nn.softmax(x @ w, axis=-1)), axis=-1)
        x, labels = np.array(x), np.array(labels)
        tasks.append((x[:96], labels[:96], x[96:], labels[96:]))
    got = tcal.score_multiclass(tm, tasks, 3)
    assert got["n"] == want["n"] == 128
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1.0 / 64)
    np.testing.assert_allclose(got["top_class_ece"], want["top_class_ece"], rtol=1e-3,
                               atol=2e-4)
    drawn = tcal.audit_multiclass(tm, torch.Generator().manual_seed(1), num_tasks=1, n_ctx=64,
                                  n_qry=32)
    assert drawn["n"] == 32 and 0 <= drawn["accuracy"] <= 1


@pytest.mark.parametrize("fw", [None, 16])
def test_roofline_equals_jax_with_jax_peaks(fw):
    jcfg = JaxConfig(d_model=256, num_heads=2, num_layers=8, max_features=32, num_bars=1024)
    tcfg = TabICAConfig(d_model=256, num_heads=2, num_layers=8, max_features=32, num_bars=1024)
    want = jroof.ar_sampling_roofline(jcfg, 2048, 10_240, 10, 10, feature_width=fw)
    got = roofline.ar_sampling_roofline(tcfg, 2048, 10_240, 10, 10, peak_flops=197e12,
                                        hbm_bw=819e9, feature_width=fw)
    for k in want:
        if k != "assumptions":
            assert got[k] == want[k], k
    h100 = roofline.ar_sampling_roofline(tcfg, 2048, 10_240, 10, 10, feature_width=fw)
    assert h100["flops"] == want["flops"] and h100["hbm_bytes"] == want["hbm_bytes"]
    assert h100["t_compute_s"] == round(want["flops"] / 989e12, 6)
    assert "H100" in h100["assumptions"] and "TPU" not in h100["assumptions"]
    assert "H100" not in got["assumptions"]


def test_phase_timers_and_trace(tmp_path):
    timers = profiling.PhaseTimers()
    for _ in range(2):
        with timers.phase("mm", sync=[torch.ones(4) @ torch.ones(4)]):
            pass
    with timers.phase("other"):
        pass
    rep = timers.report()
    assert rep["mm"]["count"] == 2 and rep["other"]["count"] == 1
    assert set(rep["mm"]) == {"total_s", "count", "mean_s"} and json.loads(str(timers))
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert math.isfinite(rep["mm"]["mean_s"])
