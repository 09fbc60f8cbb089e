"""Port parity: the trainable row attention (lse forward, backward) vs JAX.

On the CPU the port's ``flash_row_attention_lse`` runs
``reference_row_attention_lse`` and ``flash_row_attention_bwd`` runs
``reference_row_attention_bwd``, the plain versions of the CUDA kernels. They
are held against the JAX package's ``_flash_fwd_lse`` (Pallas, interpret
mode) and ``jax.vjp`` of ``flash_row_attention_trainable`` (Pallas forward in
interpret mode, plain-XLA backward) in f32, at rtol 1e-4 / atol 1e-5. The CUDA
kernels themselves are held against the plain versions on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from npe_pfn_tpu.ops import flash_attention as jfa
from npe_pfn_tpu_torch.models import TabICAConfig, TabICAModel, transformer
from npe_pfn_tpu_torch.ops import flash_attention as tfa
from npe_pfn_tpu_torch.utils import pytree_io
from torch_parity import t

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
BLOCK = 32  # the JAX kernel's block_q = block_k in interpret mode


def _qkv(b, lq, lk, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, lq, h, hd), (b, lk, h, hd), (b, lk, h, hd), (b, lq, h, hd))
    )


def _mask(kind, b, lk, seed=0):
    rng = np.random.default_rng(seed + 1)
    if kind == "shared":
        return np.arange(lk) < lk - 7
    m = np.arange(lk)[None, :] < rng.integers(1, lk + 1, (b, 1))
    if kind == "batch_empty_row":
        m[1] = False
    return m


CASES = [
    # (b, lq, lk, h, hd, mask kind)
    (3, 40, 40, 2, 32, "shared"),
    (3, 24, 70, 2, 16, "batch"),  # ragged, per-batch mask
    (2, 33, 45, 2, 128, "batch"),  # ragged, the shipped head_dim
    (4, 16, 50, 2, 32, "batch_empty_row"),  # a batch row with no valid key
]


@pytest.mark.parametrize("b,lq,lk,h,hd,kind", CASES)
def test_lse_forward_matches_jax_kernel_interpret(b, lq, lk, h, hd, kind):
    q, k, v, _ = _qkv(b, lq, lk, h, hd)
    m = _mask(kind, b, lk)
    ref_out, ref_lse = jfa._flash_fwd_lse(q, k, v, m, BLOCK, BLOCK, True)
    out, lse = tfa.flash_row_attention_lse(t(q), t(k), t(v), t(m))
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    valid = np.ones(b, bool) if m.ndim == 1 else m.any(axis=1)
    np.testing.assert_allclose(lse.numpy()[valid], np.asarray(ref_lse)[valid], **TOL)
    if kind == "batch_empty_row":
        assert np.all(out.numpy()[1] == 0.0)
        assert np.all(lse.numpy()[1] < -1e29) and np.all(np.asarray(ref_lse)[1] < -1e29)


@pytest.mark.parametrize("b,lq,lk,h,hd,kind", CASES)
def test_trainable_gradients_match_jax_vjp(b, lq, lk, h, hd, kind):
    q, k, v, d_out = _qkv(b, lq, lk, h, hd, seed=3)
    m = _mask(kind, b, lk)

    def jax_attn(q_, k_, v_):
        return jfa.flash_row_attention_trainable(q_, k_, v_, m, BLOCK, BLOCK, True)

    ref_out, vjp = jax.vjp(jax_attn, q, k, v)
    ref_grads = vjp(d_out)
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_row_attention_trainable(qt, kt, vt, t(m))
    grads = torch.autograd.grad(out, (qt, kt, vt), t(d_out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), **TOL)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=f"d{name}", **TOL)
    if kind == "batch_empty_row":
        assert all(np.all(g.numpy()[1] == 0.0) for g in grads)


def test_empty_shared_mask_gives_zero_output_and_gradient():
    q, k, v, d_out = _qkv(2, 16, 40, 1, 16)
    m = np.zeros(40, bool)
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_row_attention_trainable(qt, kt, vt, t(m))
    grads = torch.autograd.grad(out, (qt, kt, vt), t(d_out))
    assert np.all(out.detach().numpy() == 0.0)
    assert all(np.all(g.numpy() == 0.0) for g in grads)


@pytest.mark.parametrize("block_k", [16, 1024])
def test_plain_backward_blocks_agree_with_autograd_of_plain_forward(block_k, monkeypatch):
    """The chunked plain backward is the gradient of the plain forward, for any
    key block size (the ragged last block included)."""
    q, k, v, d_out = _qkv(3, 20, 37, 2, 16, seed=5)
    m = _mask("batch_empty_row", 3, 37)
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    ref = tfa.reference_row_attention(qt, kt, vt, t(m)) * tfa._any_valid_gate(t(m), torch.float32)
    ref_grads = torch.autograd.grad(ref, (qt, kt, vt), t(d_out))
    out, lse = tfa.reference_row_attention_lse(t(q), t(k), t(v), t(m))
    out = out * tfa._any_valid_gate(t(m), torch.float32)
    monkeypatch.setattr(tfa, "_BWD_BLOCK_K", block_k)
    grads = tfa.reference_row_attention_bwd(t(q), t(k), t(v), t(m), out, lse, t(d_out))
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def test_bf16_gradients_keep_the_input_dtype():
    q, k, v, d_out = (t(a).bfloat16() for a in _qkv(2, 16, 24, 2, 32))
    m = torch.ones(24, dtype=torch.bool)
    qt, kt, vt = (a.requires_grad_() for a in (q, k, v))
    out = tfa.flash_row_attention_trainable(qt, kt, vt, m)
    grads = torch.autograd.grad(out, (qt, kt, vt), d_out)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and g.shape == a.shape for g, a in zip(grads, (q, k, v)))


def test_cpu_launches_no_kernel():
    q, k, v, d_out = (t(a).requires_grad_() for a in _qkv(2, 16, 24, 2, 16))
    before = (tfa.flash_row_attention_lse.launches, tfa.flash_row_attention_bwd.launches)
    out = tfa.flash_row_attention_trainable(q, k, v, torch.ones(24, dtype=torch.bool))
    out.backward(d_out.detach())
    assert (tfa.flash_row_attention_lse.launches, tfa.flash_row_attention_bwd.launches) == before


def _tiny_model():
    cfg = TabICAConfig(d_model=32, num_heads=2, num_layers=2, max_features=4, num_bars=16,
                       dtype="float32", flash="on")
    return TabICAModel.create(torch.Generator().manual_seed(0), cfg, "cpu")


def _spy(monkeypatch):
    calls = {"trainable": 0, "plain": 0}

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(transformer, "flash_row_attention_trainable",
                        count("trainable", tfa.flash_row_attention_trainable))
    monkeypatch.setattr(transformer, "flash_row_attention",
                        count("plain", tfa.flash_row_attention))
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_dispatch_takes_the_function_under_grad(monkeypatch, remat):
    """Row attention goes through the autograd Function when grad mode is on
    and the parameters require grad (twice per layer, and again in the
    backward under remat); otherwise through the no-grad forward."""
    model = _tiny_model()
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(0)
    x_ctx, y_ctx, x_qry = (t(rng.standard_normal(s).astype(np.float32))
                           for s in ((2, 12, 4), (2, 12), (2, 5, 4)))
    params = model.params
    leaves = list(pytree_io.flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)
    logits = transformer.forward(model.cfg, params, x_ctx, y_ctx, x_qry, remat=remat)
    assert calls == {"trainable": 4, "plain": 0}
    logits.square().mean().backward()
    assert calls == {"trainable": 8 if remat else 4, "plain": 0}
    assert all(p.grad is not None for p in leaves)
    with torch.no_grad():
        transformer.forward(model.cfg, params, x_ctx, y_ctx, x_qry)
    assert calls["plain"] == 4
    frozen = dataclasses.replace(model, params=transformer.init_params(
        torch.Generator().manual_seed(1), model.cfg, "cpu"))
    transformer.forward(frozen.cfg, frozen.params, x_ctx, y_ctx, x_qry)
    assert calls["plain"] == 8
