"""Port parity: checkpoint loading and the config vs npe_pfn_tpu's.

The shipped checkpoint's every leaf must load bit-equal in both packages
(numpy reads the same .npz), and the config JSON must give the same fields.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from npe_pfn_tpu.models import TabICAConfig as JaxConfig
from npe_pfn_tpu.models import checkpoint as jax_ckpt
from npe_pfn_tpu_torch.models import TabICAConfig
from npe_pfn_tpu_torch.models import checkpoint as tck
from torch_parity import REPO, SHIPPED, flat_params

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + "/")
        else:
            yield name, v


def test_shipped_checkpoint_leaves_bit_equal():
    jm = jax_ckpt.load(SHIPPED)
    tm = tck.load(SHIPPED, "cpu")
    ref = flat_params(jm.params)
    out = dict(_leaves(tm.params))
    assert sorted(out) == sorted(ref)
    for name, arr in ref.items():
        got = out[name].numpy()
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        np.testing.assert_array_equal(got, arr, err_msg=name)
    assert tm.temperature == float(np.asarray(jm.temperature))
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert out["blocks/row_attn/wq"].shape == (8, 256, 2, 128)
    np.testing.assert_allclose(tm.borders.numpy(), np.asarray(jm.borders), rtol=0, atol=1e-6)


def test_params_from_numpy_nests_and_casts():
    flat = {"a/b/w": np.ones((2, 3), np.float32), "a/c": np.zeros(4, np.float32),
            "__temperature__": np.float32(1.5)}
    p = tck.params_from_numpy(flat, "cpu", torch.bfloat16)
    assert set(p) == {"a"} and set(p["a"]) == {"b", "c"}
    assert p["a"]["b"]["w"].dtype == torch.bfloat16 and p["a"]["b"]["w"].shape == (2, 3)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "checkpoints", "*.npz.json"))))
def test_config_json_loads_alike(path):
    with open(path) as f:
        fields = json.load(f)
    port, ref = TabICAConfig(**fields), JaxConfig(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_dim == ref.head_dim


def test_default_checkpoint_path(monkeypatch):
    monkeypatch.delenv("NPE_PFN_TPU_CHECKPOINT", raising=False)
    assert os.path.realpath(tck.default_checkpoint_path()) == os.path.realpath(SHIPPED)
    assert os.path.realpath(tck.default_checkpoint_path()) == os.path.realpath(
        jax_ckpt.default_checkpoint_path())
    monkeypatch.setenv("NPE_PFN_TPU_CHECKPOINT", "/elsewhere/model.npz")
    assert tck.default_checkpoint_path() == "/elsewhere/model.npz"
    with pytest.raises(FileNotFoundError):
        tck.load_default("cpu")


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_default()
