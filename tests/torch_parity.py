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
