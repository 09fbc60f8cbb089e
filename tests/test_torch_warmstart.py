"""Port parity: checkpoints in both directions, and warm-starting, vs npe_pfn_tpu.

A checkpoint the port writes (``checkpoint.save``) loads in the JAX package,
and one the JAX package writes loads in the port, with every parameter, the
config and the temperature unchanged (exact). ``upsample_head`` and
``load_warmstart`` match the JAX functions on the same weights: ``w2`` and
the trunk exactly, ``b2`` to atol 1e-4. ``b2`` adds log(fine width / coarse
width), and the two packages' f32 bar borders agree to about 5e-7, which
moves the log of a narrow bucket by up to about 3e-5.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import TabICAModel as JaxModel
from npe_pfn_tpu.models import checkpoint as jax_ckpt
from npe_pfn_tpu.pretrain import warmstart as jws
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel, checkpoint, transformer
from npe_pfn_tpu_torch.models.checkpoint import params_from_numpy
from npe_pfn_tpu_torch.pretrain import warmstart
from npe_pfn_tpu_torch.utils import pytree_io
from torch_parity import flat_params

torch.set_num_threads(2)
TINY = dict(d_model=32, num_heads=2, num_layers=2, max_features=6, num_bars=64, dtype="float32")


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = TabICAConfig(**TINY)
    model = dataclasses.replace(
        TabICAModel.create(torch.Generator().manual_seed(0), cfg, "cpu"), temperature=1.25)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, model)
    loaded = jax_ckpt.load(path)
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(cfg)
    assert float(loaded.temperature) == 1.25
    ref = flat_params(loaded.params)
    ours = pytree_io.flatten(model.params)
    assert sorted(ref) == sorted(ours)
    for name, arr in ref.items():
        np.testing.assert_array_equal(arr, ours[name].numpy(), err_msg=name)
    assert sorted(os.listdir(tmp_path)) == ["port.npz", "port.npz.json"]


def test_jax_checkpoint_loads_in_port(tmp_path):
    jm = JaxModel.create(jax.random.PRNGKey(3), JaxConfig(**TINY))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save(path, jm)
    model = checkpoint.load(path, "cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jm.cfg)
    ours = pytree_io.flatten(model.params)
    for name, arr in flat_params(jm.params).items():
        np.testing.assert_array_equal(ours[name].numpy(), arr, err_msg=name)
    # And back: params_to_numpy gives the JAX names and values.
    assert checkpoint.params_to_numpy(model.params).keys() == flat_params(jm.params).keys()


@pytest.mark.parametrize("old,new", [(64, 256), (64, 64)])
def test_upsample_head_matches_jax(old, new):
    jm = JaxModel.create(jax.random.PRNGKey(1), JaxConfig(**TINY))
    ref = flat_params(jws.upsample_head(jm.params, old, new, 6.0))
    ours = pytree_io.flatten(warmstart.upsample_head(
        params_from_numpy(flat_params(jm.params), "cpu"), old, new, 6.0))
    assert sorted(ref) == sorted(ours)
    for name, arr in ref.items():
        _close(ours[name].numpy(), arr, name)


def _close(got, want, name):
    if name == "head/b2":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_upsample_head_rejects_a_non_multiple():
    params = transformer.init_params(torch.Generator().manual_seed(0), TabICAConfig(**TINY), "cpu")
    with pytest.raises(ValueError):
        warmstart.upsample_head(params, 64, 96, 6.0)


def test_load_warmstart_matches_jax(tmp_path):
    jm = JaxModel.create(jax.random.PRNGKey(2), JaxConfig(**TINY))
    path = str(tmp_path / "coarse.npz")
    jax_ckpt.save(path, jm)
    target = {**TINY, "num_bars": 256}
    ref = jws.load_warmstart(path, JaxConfig(**target))
    model = warmstart.load_warmstart(path, TabICAConfig(**target), "cpu")
    assert model.cfg.num_bars == 256 and model.borders.shape == (257,)
    np.testing.assert_allclose(model.borders.numpy(), np.asarray(ref.borders), atol=1e-6)
    ours = pytree_io.flatten(model.params)
    for name, arr in flat_params(ref.params).items():
        _close(ours[name].numpy(), arr, name)
    with pytest.raises(ValueError, match="trunk mismatch"):
        warmstart.load_warmstart(path, TabICAConfig(**{**target, "d_model": 64}), "cpu")
