"""Shared helpers of the tests that hold npe_pfn_tpu_torch against npe_pfn_tpu.

Inputs are made with numpy from a seed and handed to both packages; a JAX
model's parameters are flattened under ``checkpoint.save``'s names and carried
into the port with ``params_from_numpy``. JAX is imported only where used, so
that the card-only tests (tests/test_torch_cuda.py) run where JAX is absent.
"""

import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "checkpoints", "tabica_v6_best.npz")


def flat_params(params) -> dict:
    """A JAX params pytree as ``{"blocks/row_attn/wq": np.ndarray, ...}``."""
    import jax

    out = {}
    for key_path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in key_path)
        out[name] = np.asarray(leaf)
    return out


def port_model(jax_model, dtype=None):
    """The port's TabICAModel with the JAX model's weights, borders and
    temperature (and config, with ``dtype`` overridden if given)."""
    from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel
    from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy

    import dataclasses

    fields = dataclasses.asdict(jax_model.cfg)
    if dtype is not None:
        fields.update(dtype=dtype, scores_dtype=dtype)
    return TabICAModel(
        cfg=TabICAConfig(**fields),
        params=params_from_numpy(flat_params(jax_model.params), "cpu"),
        borders=torch.tensor(np.asarray(jax_model.borders)),
        temperature=float(np.asarray(jax_model.temperature)),
    )


def t(a):
    """numpy -> CPU tensor."""
    return torch.tensor(np.asarray(a))


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip when the machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


# The tiny pretraining configuration of the parity tests (model and prior).
TINY_TRAIN = dict(d_model=32, num_heads=2, num_layers=2, max_features=8, num_bars=32,
                  dtype="float32")
TINY_PRIOR = dict(num_features=8, num_ctx=32, num_qry=16, max_active_features=6, hidden=16)


def task_batches(seed=0, num_datasets=2):
    """A task batch from the port's prior, as the port's TaskBatch and as the
    JAX package's (the same numbers)."""
    import dataclasses

    import jax.numpy as jnp
    from npe_pfn_tpu.pretrain import prior as jprior
    from npe_pfn_tpu_torch.pretrain import prior

    b = prior.sample_tasks(torch.Generator().manual_seed(seed), num_datasets,
                           prior.PriorConfig(**TINY_PRIOR))
    arrays = [getattr(b, f.name).numpy() for f in dataclasses.fields(b)]
    return (prior.TaskBatch(*(t(a) for a in arrays)),
            jprior.TaskBatch(*(jnp.asarray(a) for a in arrays)))


def check_batch_loss_against_jax(over, remat, moe_aux_weight=0.01, seed=0, num_datasets=2):
    """``train.batch_loss`` and its gradients against
    ``jax.value_and_grad(npe_pfn_tpu.pretrain.train.batch_loss)`` on the same
    batch and JAX-initialized weights (TINY_TRAIN with ``over``): loss rtol
    1e-5, gradients rtol 1e-4 / atol 1e-6. Returns the two losses."""
    import jax
    import jax.numpy as jnp
    from npe_pfn_tpu.models import TabICAConfig as JaxConfig
    from npe_pfn_tpu.models import transformer as jt
    from npe_pfn_tpu.pretrain import train as jtrain
    from npe_pfn_tpu_torch.models import TabICAConfig
    from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy
    from npe_pfn_tpu_torch.pretrain import train
    from npe_pfn_tpu_torch.utils import pytree_io

    fields = {**TINY_TRAIN, **over}
    if fields.get("flash") == "on":
        fields["flash_interpret"] = True
    jcfg = JaxConfig(**fields)
    jparams = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = TabICAConfig(**fields)
    tbatch, jbatch = task_batches(seed, num_datasets)
    borders = jnp.asarray(train.bar.make_borders(cfg.num_bars, cfg.bar_range).numpy())
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtrain.batch_loss(jcfg, borders, p, jbatch, remat,
                                    moe_aux_weight=moe_aux_weight))(jparams)
    params = params_from_numpy(flat_params(jparams), "cpu")
    leaves = pytree_io.flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = train.batch_loss(cfg, t(np.asarray(borders)), params, tbatch, remat,
                            moe_aux_weight=moe_aux_weight)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = flat_params(ref_grads)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=1e-4, atol=1e-6, err_msg=name)
    return loss.item(), float(ref_loss)
