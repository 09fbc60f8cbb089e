"""Row-axis flash attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``npe_pfn_tpu/ops/flash_attention.py``. The public layout is
the JAX package's: q ``[B, Lq, H, hd]``, k and v ``[B, Lk, H, hd]``, and
``kv_mask`` either shared ``[Lk]`` or per-batch ``[B, Lk]``.

``flash_row_attention`` runs the plain PyTorch version for tensors on the
CPU and the hand-written kernel (``csrc/flash_row_attention.cu``) for tensors
on a CUDA device; it never falls back from one to the other. Like the JAX
wrapper, it applies the any-valid gate outside the kernel: a batch row whose
keys are all masked returns zeros.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_SOURCE = "flash_row_attention.cu"
_HEAD_DIMS = (16, 32, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30


def reference_row_attention(q, k, v, kv_mask):
    """Plain PyTorch version of the kernel's function (no any-valid gate).

    Scores are f32, masked keys score -1e30, softmax is f32, and P is cast to
    v's dtype before P.V, which accumulates in f32 — the kernel's arithmetic
    without the online rescaling.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = kv_mask[None, :] if kv_mask.dim() == 1 else kv_mask
    s = s.masked_fill(~m.bool()[:, None, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _any_valid_gate(kv_mask, dtype):
    """0/1 per batch row: 0 where every key is masked (JAX ``_any_valid_gate``).
    A scalar for a shared mask, ``[B, 1, 1, 1]`` for a per-batch one."""
    valid = (kv_mask.float().sum(dim=-1) > 0).to(dtype)
    return valid if kv_mask.dim() == 1 else valid[:, None, None, None]


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, L, H, hd]")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    lk = k.shape[1]
    if tuple(kv_mask.shape) not in ((lk,), (b, lk)):
        raise ValueError(f"kv_mask must be [{lk}] or [{b}, {lk}], got {tuple(kv_mask.shape)}")


@functools.cache
def _library():
    """The kernel's library, built at first use, with its C signatures set."""
    lib = _build.load(_SOURCE)
    fn = lib.flash_row_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p]
    )
    err = lib.flash_row_attention_error_string
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


def _launch(q, k, v, kv_mask):
    """One launch of the CUDA kernel; returns the ungated output."""
    dev = q.device
    if any(t.device != dev for t in (k, v, kv_mask)):
        raise ValueError("q, k, v and kv_mask must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if lk == 0:
        raise ValueError("kv length must be positive")
    mask = kv_mask.to(torch.float32).contiguous()
    mask_sb = 0 if mask.dim() == 1 else lk
    lib = _library()
    fn = lib.flash_row_attention_fwd
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _DTYPE_CODES[q.dtype], hd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, lq, lk,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            mask_sb, hd**-0.5, stream,
        )
    if rc != 0:
        err = lib.flash_row_attention_error_string
        raise RuntimeError(f"flash_row_attention launch failed: {err(rc).decode()} ({rc})")
    flash_row_attention.launches += 1
    return out


def flash_row_attention(q, k, v, kv_mask):
    """softmax(q kᵀ · hd^-0.5 + mask) v, returns ``[B, Lq, H, hd]``.

    CPU tensors take ``reference_row_attention``; CUDA tensors launch the
    kernel (and raise if it cannot take them). ``flash_row_attention.launches``
    counts kernel launches.
    """
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        out = reference_row_attention(q, k, v, kv_mask)
    elif q.device.type == "cuda":
        out = _launch(q, k, v, kv_mask)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out * _any_valid_gate(kv_mask, out.dtype)


flash_row_attention.launches = 0
