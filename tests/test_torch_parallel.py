"""npe_pfn_tpu_torch.parallel.mesh against npe_pfn_tpu on the same inputs and
weights: the data-parallel step and query-sharded sampling over 2 gloo ranks,
the public names, and the 4-rank dry run.

The ranks are spawned processes (tests/torch_parallel_ranks.py); the JAX side
runs here, on the CPU. f32, rtol 2e-4 / atol 2e-5.
"""

import dataclasses
import importlib
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npe_pfn_tpu
import npe_pfn_tpu.parallel as jax_parallel
import npe_pfn_tpu_torch
import npe_pfn_tpu_torch.parallel as parallel
from npe_pfn_tpu.estimator import autoregressive_log_prob
from npe_pfn_tpu.models import TabICAConfig, TabICAModel
from npe_pfn_tpu.pretrain import train as jtrain
from npe_pfn_tpu_torch.pretrain import prior
from torch_parallel_ranks import dp_body, model_spec, sample_body, spawn
from torch_parity import TINY_PRIOR, TINY_TRAIN, flat_params

RTOL, ATOL = 2e-4, 2e-5
TCFG = dict(num_datasets=4, warmup_steps=2, max_steps=10)
SEEDS = (1, 2)


def test_exports_hold_every_name_of_the_jax_package():
    assert set(npe_pfn_tpu.__all__) <= set(npe_pfn_tpu_torch.__all__)
    for name in npe_pfn_tpu.__all__:
        assert hasattr(npe_pfn_tpu_torch, name), name
    jax_functions = {n for n, v in vars(jax_parallel).items()
                     if not n.startswith("_") and callable(v)}
    assert jax_functions <= set(parallel.__all__), sorted(jax_functions - set(parallel.__all__))
    for mod in pkgutil.iter_modules(jax_parallel.__path__):
        jax_mod = importlib.import_module(f"npe_pfn_tpu.parallel.{mod.name}")
        port_mod = importlib.import_module(f"npe_pfn_tpu_torch.parallel.{mod.name}")
        public = {n for n, v in vars(jax_mod).items() if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "") == jax_mod.__name__}
        assert public <= set(vars(port_mod)), (mod.name, sorted(public - set(vars(port_mod))))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The dense and the MoE model over 2 ranks (batch seeds 1 and 2)."""
    models = {"dense": TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**TINY_TRAIN)),
              "moe": TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(
                  **TINY_TRAIN, num_experts=4, moe_top_k=2))}
    out = spawn(2, dp_body, tmp_path_factory.mktemp("dp"),
                models={k: model_spec(m) for k, m in models.items()},
                tcfg=TCFG, pcfg=TINY_PRIOR, seeds=SEEDS)
    return models, out


def test_dp_ranks_agree(dp):
    _, (r0, r1) = dp
    for name in ("dense", "moe"):
        for i in range(len(SEEDS)):
            a, b = r0[name][f"step{i}"]["dp"], r1[name][f"step{i}"]["dp"]
            assert a[:2] == b[:2]
            for k in a[2]:
                np.testing.assert_array_equal(a[2][k], b[2][k], err_msg=k)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_dp_loss_and_grads_match_jax(dp, name):
    """The dp-averaged loss and gradients of the first batch against JAX's
    batch_loss and its gradient on the whole batch."""
    models, (r0, _) = dp
    jmodel = models[name]
    tb = prior.sample_tasks(torch.Generator().manual_seed(SEEDS[0]), TCFG["num_datasets"],
                            prior.PriorConfig(**TINY_PRIOR))
    from npe_pfn_tpu.pretrain import prior as jprior

    jbatch = jprior.TaskBatch(*(jnp.asarray(getattr(tb, f.name).numpy())
                                for f in dataclasses.fields(tb)))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtrain.batch_loss(jmodel.cfg, jmodel.borders, p, jbatch, False,
                                    moe_aux_weight=0.01))(jmodel.params)
    np.testing.assert_allclose(r0[name]["loss"], float(ref_loss), rtol=RTOL, atol=ATOL)
    ref = flat_params(ref_grads)
    for k, g in r0[name]["grads"].items():
        np.testing.assert_allclose(g, ref[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["dense", "moe"])
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_dp_steps_match_single_device(dp, name, i):
    """Two dp steps on 2 ranks against train_step on the whole batches:
    loss, gradient norm and parameters after each step."""
    _, (r0, _) = dp
    got, ref = r0[name][f"step{i}"]["dp"], r0[name][f"step{i}"]["single"]
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    for k in ref[2]:
        np.testing.assert_allclose(got[2][k], ref[2][k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_dp_validation(dp):
    _, (r0, _) = dp
    assert "num_datasets 5 must divide over the 2 ranks" in r0["errors"]["datasets"]
    assert "the mesh spans every rank" in r0["errors"]["mesh_size"]


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """The dry run's sampling shapes over 2 ranks: 64 context rows, dθ 2,
    dx 3, 32 query rows."""
    model = TabICAModel.create(jax.random.PRNGKey(0), TabICAConfig(**TINY_TRAIN))
    rng = np.random.default_rng(0)
    inputs = dict(theta_ctx=rng.normal(size=(64, 2)).astype(np.float32),
                  x_ctx=rng.normal(size=(64, 3)).astype(np.float32),
                  ctx_mask=np.arange(64) < 56,
                  x_qry=rng.normal(size=(32, 3)).astype(np.float32))
    out = spawn(2, sample_body, tmp_path_factory.mktemp("sample"), model=model_spec(model),
                seed=3, **inputs)
    return model, inputs, out


def test_sharded_sampling_rows_in_rank_order_match_jax_log_prob(sampled):
    """Every rank returns all rows; their log-probs are JAX's
    autoregressive_log_prob of those samples at those query rows, which a
    row in the wrong place would break."""
    model, inputs, (r0, r1) = sampled
    np.testing.assert_array_equal(r0["samples"], r1["samples"])
    np.testing.assert_array_equal(r0["lps"], r1["lps"])
    assert r0["samples"].shape == (32, 2) and np.isfinite(r0["samples"]).all()
    ref = autoregressive_log_prob(model, *(jnp.asarray(inputs[k]) for k in (
        "theta_ctx", "x_ctx", "ctx_mask", "x_qry")), jnp.asarray(r0["samples"]), 16)
    np.testing.assert_allclose(r0["lps"], np.asarray(ref), rtol=RTOL, atol=ATOL)
    # The two ranks drew from independent streams.
    assert not np.array_equal(r0["samples"][:16], r0["samples"][16:])


def test_sharded_sampling_at_one_rank_is_autoregressive_sample(sampled):
    _, _, (r0, r1) = sampled
    for r in (r0, r1):
        for got, ref in zip(r["one"], r["ref"]):
            np.testing.assert_array_equal(got, ref)


def test_sharded_sampling_validation(sampled):
    _, _, (r0, _) = sampled
    assert "query rows 3 must divide over the 2 ranks of axis 'data'" in r0["odd_rows"]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.init_distributed(0, 1, "file:///nonexistent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.dryrun_multichip(2)


def test_dryrun_multichip_four_ranks(capfd):
    parallel.dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    for what in ("dp train step on 4 ranks", "sharded sampling on 4 ranks OK",
                 "gathered and ring, on 4 ranks OK", "dp×tp tensor-parallel forward on 4 ranks OK",
                 "pipeline-parallel forward (2 stages) OK", "tp×ep expert-parallel MoE forward OK"):
        assert what in out, out
