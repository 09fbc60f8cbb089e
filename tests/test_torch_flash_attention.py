"""Port parity: the row flash attention's plain version vs the JAX kernel.

On the CPU the port's ``flash_row_attention`` runs ``reference_row_attention``
(the plain version of the CUDA kernel's function) and the any-valid gate; it
is held against the JAX Pallas kernel in interpret mode at the JAX package's
own kernel tolerance (rtol 2e-4, atol 2e-5, f32). The CUDA kernel itself is
held against the plain version on a card: tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from npe_pfn_tpu.ops import flash_attention as jfa
from npe_pfn_tpu_torch.ops import _build
from npe_pfn_tpu_torch.ops import flash_attention as tfa
from torch_parity import t

torch.set_num_threads(2)


def _qkv(b, lq, lk, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, lq, h, hd), (b, lk, h, hd), (b, lk, h, hd))
    )


def _mask(kind, b, lk, seed=0):
    rng = np.random.default_rng(seed + 1)
    if kind == "shared":
        return np.arange(lk) < lk - 7
    if kind == "batch":
        return np.arange(lk)[None, :] < rng.integers(1, lk + 1, (b, 1))
    if kind == "batch_empty_row":
        m = np.arange(lk)[None, :] < rng.integers(1, lk + 1, (b, 1))
        m[1] = False
        return m
    if kind == "shared_empty":
        return np.zeros(lk, bool)
    raise ValueError(kind)


CASES = [
    # (b, lq, lk, h, hd, mask kind)
    (3, 64, 64, 2, 32, "shared"),
    (3, 96, 160, 2, 16, "shared"),  # ragged, Lq != Lk
    (2, 100, 150, 2, 128, "batch"),  # ragged, the shipped head_dim
    (4, 32, 96, 2, 32, "batch_empty_row"),  # one batch row with no valid key
    (2, 16, 40, 1, 16, "shared_empty"),  # no valid key at all
]


@pytest.mark.parametrize("b,lq,lk,h,hd,kind", CASES)
def test_plain_matches_jax_kernel_interpret(b, lq, lk, h, hd, kind):
    q, k, v = _qkv(b, lq, lk, h, hd)
    m = _mask(kind, b, lk)
    ref = np.asarray(jfa.flash_row_attention(q, k, v, m, block_q=32, block_k=32, interpret=True))
    before = tfa.flash_row_attention.launches
    out = tfa.flash_row_attention(t(q), t(k), t(v), t(m))
    assert tfa.flash_row_attention.launches == before  # the CPU path launches nothing
    assert out.shape == (b, lq, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)
    if kind == "batch_empty_row":
        assert np.all(out.numpy()[1] == 0.0)
    if kind == "shared_empty":
        assert np.all(out.numpy() == 0.0)


@pytest.mark.parametrize("kind", ["shared", "batch"])
def test_reference_matches_jax_reference(kind):
    q, k, v = _qkv(3, 48, 80, 2, 32, seed=4)
    m = _mask(kind, 3, 80)
    ref = np.asarray(jfa.reference_row_attention(q, k, v, m))
    out = tfa.reference_row_attention(t(q), t(k), t(v), t(m)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_wrapper_rejects_bad_shapes_and_devices():
    q, k, v = (t(a) for a in _qkv(2, 8, 16, 2, 16))
    with pytest.raises(ValueError):
        tfa.flash_row_attention(q, k[:, :, :1], v, torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError):
        tfa.flash_row_attention(q, k, v, torch.ones(3, 16, dtype=torch.bool))
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError):
        tfa.flash_row_attention(*meta, torch.ones(16, dtype=torch.bool, device="meta"))


def test_build_names_library_by_source_hash():
    path = _build.library_path("flash_row_attention.cu")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path("flash_row_attention.cu")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
