"""npe_pfn_tpu_torch.parallel.tensor_parallel against the JAX package's on
the same inputs and weights, over 2 and 4 gloo ranks: the dense and the
row-pooled model over tp 2, tp 4 at four heads, dp×tp 2×2, and
autoregressive_sample through a tp-placed model.

f32, rtol 2e-4 / atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from npe_pfn_tpu.estimator import autoregressive_log_prob
from npe_pfn_tpu.models import TabICAConfig, TabICAModel
from npe_pfn_tpu.parallel import param_pspecs as jax_pspecs
from npe_pfn_tpu.parallel import tp_forward_logits
from npe_pfn_tpu_torch.parallel import param_pspecs
from torch_parallel_ranks import model_spec, spawn, tp_body
from torch_parity import flat_params

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(d_model=32, num_layers=2, max_features=8, num_bars=32, dtype="float32")
CONFIGS = {"dense": dict(num_heads=2), "heads4": dict(num_heads=4),
           "pooled": dict(num_heads=2, row_pool_slots=4)}
# (model, mesh shape, axis names, data axis)
CASES = [("dense", (2, 2), ("rep", "tp"), None), ("pooled", (2, 2), ("rep", "tp"), None),
         ("heads4", (4,), ("tp",), None), ("dense", (2, 2), ("data", "tp"), "data")]


def _models():
    return {k: TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**BASE, **v))
            for k, v in CONFIGS.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    models = _models()
    rng = np.random.default_rng(1)
    data = dict(x_ctx=rng.normal(size=(48, 3)).astype(np.float32),
                y_ctx=rng.normal(size=(48,)).astype(np.float32),
                x_qry=rng.normal(size=(16, 3)).astype(np.float32))
    sample = dict(model="dense", shape=(2, 2), names=("rep", "tp"),
                  theta_ctx=rng.normal(size=(48, 2)).astype(np.float32),
                  x_ctx=rng.normal(size=(48, 3)).astype(np.float32),
                  ctx_mask=np.arange(48) < 40, x_qry=rng.normal(size=(16, 3)).astype(np.float32))
    bad = {"heads": model_spec(TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(
               **BASE, num_heads=1))),
           "moe": model_spec(TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(
               **BASE, num_heads=2, num_experts=4)))}
    out = spawn(4, tp_body, tmp_path_factory.mktemp("tp"),
                models={k: model_spec(m) for k, m in models.items()}, cases=CASES,
                sample=sample, seed=4, bad=bad, **data)
    return models, data, sample, out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'x'.join(c[2])}")
def test_tp_matches_jax(run, case):
    models, data, _, out = run
    name, shape, names, data_axis = case
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    ref = np.asarray(tp_forward_logits(mesh, models[name], *(jnp.asarray(data[k]) for k in (
        "x_ctx", "y_ctx", "x_qry")), data_axis=data_axis))
    for rank_out in out:
        np.testing.assert_allclose(rank_out[case], ref, rtol=RTOL, atol=ATOL)


def test_tp_autoregressive_sample(run):
    """The placed model is a drop-in for the sampler: the replicated model's
    samples on the same generator, and log-probs equal to JAX's
    autoregressive_log_prob of those samples."""
    models, _, sample, out = run
    for rank_out in out:
        (th, lp), (th1, lp1) = rank_out["sample_tp"], rank_out["sample_one"]
        np.testing.assert_allclose(th, th1, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lp, lp1, rtol=1e-4, atol=1e-4)
    th, lp = out[0]["sample_tp"]
    ref = autoregressive_log_prob(models["dense"], *(jnp.asarray(sample[k]) for k in (
        "theta_ctx", "x_ctx", "ctx_mask", "x_qry")), jnp.asarray(th), 16)
    np.testing.assert_allclose(lp, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_pspecs_match_jax(name):
    model = _models()[name]
    ref = flat_params(jax.tree_util.tree_map(
        lambda s: np.array(tuple(s), dtype=object), jax_pspecs(model.params, "mp"),
        is_leaf=lambda s: not isinstance(s, dict)))
    from torch_parallel_ranks import build

    got = param_pspecs(build(model_spec(model)).params, "mp")
    from npe_pfn_tpu_torch.utils import pytree_io

    flat = pytree_io.flatten(got)
    assert set(flat) == set(ref)
    for k, spec in flat.items():
        assert tuple(spec) == tuple(ref[k]), k


def test_tp_validation(run):
    errors = run[-1][0]["errors"]
    assert errors["heads"] == "tp axis size 2 must divide num_heads=1"
    assert "use expert_parallel.ep_place(mesh, model, tp_axis=...)" in errors["moe"]


def test_tp_refuses_grad(run):
    """A tp-placed model's all_reduce carries no gradient, so under grad it
    raises rather than hand back partial gradients."""
    for rank_out in run[-1]:
        assert "runs forward only" in rank_out["errors"]["grad"]
