"""Row-axis flash attention: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``npe_pfn_tpu/ops/flash_attention.py``. The public layout is
the JAX package's: q ``[B, Lq, H, hd]``, k and v ``[B, Lk, H, hd]``, and
``kv_mask`` either shared ``[Lk]`` or per-batch ``[B, Lk]``.

Three wrappers, each with a plain PyTorch version beside it:

- ``flash_row_attention``: the inference forward (``csrc/flash_row_attention.cu``);
- ``flash_row_attention_lse``: the same forward that also returns the
  per-query logsumexp ``[B, H, Lq]`` (the JAX ``_flash_fwd_lse``);
- ``flash_row_attention_bwd``: dq, dk, dv from the forward's output and lse
  (``csrc/flash_row_attention_bwd.cu``; the JAX ``_trainable_bwd``).

``flash_row_attention_trainable`` is the differentiable op: a
``torch.autograd.Function`` whose forward is ``flash_row_attention_lse`` and
whose backward is ``flash_row_attention_bwd``. Each wrapper runs its plain
version for tensors on the CPU and its kernel for tensors on a CUDA device; it
never falls back from one to the other. Like the JAX wrappers, they apply the
any-valid gate outside the kernel: a batch row whose keys are all masked
returns zeros and gets zero gradients.

Each source holds two designs, and ``kernel_design`` picks one from the dtype
and head_dim before the launch: ``"wgmma"`` (Hopper: warp-specialised, TMA
loads into an mbarrier ring, wgmma with register accumulators) for bf16 at
head_dim 128, the only shape the shipped models run, and ``"wmma"`` (WMMA
fragments, or FMA for f32) for f32 and head_dim 16 or 32. A failure of the
chosen design raises; nothing gives way to the other design. Each wrapper
counts its kernel launches in ``.launches`` and, per design, in
``.wgmma_launches`` and ``.wmma_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

_SOURCE = "flash_row_attention.cu"
_BWD_SOURCE = "flash_row_attention_bwd.cu"
_HEAD_DIMS = (16, 32, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_BWD_BLOCK_K = 1024  # keys per block of the plain backward, as in the JAX _trainable_bwd
_WGMMA_TILE = 128  # the wgmma design's mask and lse rows are padded to a multiple of this
_LOG2E = math.log2(math.e)
DESIGNS = ("wgmma", "wmma")


def kernel_design(dtype, head_dim):
    """The kernel design a CUDA call with this dtype and head_dim launches:
    ``"wgmma"`` for bf16 at head_dim 128, ``"wmma"`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim == 128 else "wmma"


def _masked_scores(q, k, kv_mask):
    """f32 scores ``[B, H, Lq, Lk]`` scaled by hd^-0.5; masked keys -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    m = kv_mask[None, :] if kv_mask.dim() == 1 else kv_mask
    return s.masked_fill(~m.bool()[:, None, None, :], _NEG_INF)


def _attend(s, v, dtype):
    """f32 softmax of the scores, cast to v's dtype, times v (f32 sums)."""
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dtype)


def reference_row_attention(q, k, v, kv_mask):
    """Plain PyTorch version of the kernel's function (no any-valid gate).

    Scores are f32, masked keys score -1e30, softmax is f32, and P is cast to
    v's dtype before P.V, which accumulates in f32 — the kernel's arithmetic
    without the online rescaling.
    """
    return _attend(_masked_scores(q, k, kv_mask), v, q.dtype)


def reference_row_attention_lse(q, k, v, kv_mask):
    """Plain version of the lse forward: ``(out, lse)``, no any-valid gate.

    ``lse`` is the f32 logsumexp of the masked, scaled scores per query,
    ``[B, H, Lq]``; a row with every key masked reads about -1e30, as the
    kernel's m + log(max(l, 1e-30)) does.
    """
    s = _masked_scores(q, k, kv_mask)
    return _attend(s, v, q.dtype), torch.logsumexp(s, dim=-1)


def reference_row_attention_bwd(q, k, v, kv_mask, out, lse, d_out):
    """Plain version of the backward: ``(dq, dk, dv)`` in the inputs' dtypes.

    A line-for-line counterpart of the JAX ``_trainable_bwd``: everything in
    f32, P recomputed from ``lse`` one block of ``_BWD_BLOCK_K`` keys at a time,
    delta = rowsum(dO * out), and dO zeroed for batch rows with no valid key.
    ``out`` is the gated forward output. The mask gets no gradient.
    """
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    scale = hd**-0.5
    f32 = torch.float32
    qh = q.transpose(1, 2).to(f32)  # [B, H, Lq, hd]
    doh = d_out.transpose(1, 2).to(f32)
    outh = out.transpose(1, 2).to(f32)
    mask2 = kv_mask if kv_mask.dim() == 2 else kv_mask[None, :].expand(b, lk)
    mask2 = mask2.to(f32)
    doh = doh * (mask2.sum(dim=-1) > 0).to(f32)[:, None, None, None]
    delta = (doh * outh).sum(dim=-1)
    kh = k.transpose(1, 2).to(f32)
    vh = v.transpose(1, 2).to(f32)
    dq = torch.zeros_like(qh)
    dk, dv = [], []
    bk = _BWD_BLOCK_K
    for k0 in range(0, lk, bk):
        kb, vb, mb = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk], mask2[:, k0:k0 + bk]
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kb) * scale
        s = s + (1.0 - mb)[:, None, None, :] * _NEG_INF
        p = torch.exp(s - lse[..., None])
        dv.append(torch.einsum("bhqk,bhqd->bhkd", p, doh))
        dp = torch.einsum("bhqd,bhkd->bhqk", doh, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk.append(torch.einsum("bhqk,bhqd->bhkd", ds, qh))
    dk, dv = torch.cat(dk, dim=2), torch.cat(dv, dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


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
    """The forward kernels' library, built at first use, with its C signatures set."""
    lib = _build.load(_SOURCE)
    common = [ctypes.c_int] * 4 + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_row_attention_fwd.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + common)
    lib.flash_row_attention_fwd_lse.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + common)
    lib.flash_row_attention_fwd_wgmma.argtypes = [ctypes.c_void_p] * 6 + common
    lib.flash_row_attention_fwd.restype = lib.flash_row_attention_fwd_lse.restype = ctypes.c_int
    lib.flash_row_attention_fwd_wgmma.restype = ctypes.c_int
    lib.flash_row_attention_error_string.restype = ctypes.c_char_p
    lib.flash_row_attention_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _bwd_library():
    """The backward kernels' library, built at first use, with its C signature set."""
    lib = _build.load(_BWD_SOURCE)
    fn = lib.flash_row_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn = lib.flash_row_attention_bwd_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 11 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.flash_row_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_row_attention_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_kernel_inputs(q, k, v, kv_mask, *more):
    """What every kernel needs of q, k, v: one CUDA device, one dtype it
    takes, a head_dim it is built for, 16-byte rows, positive lengths."""
    dev = q.device
    if any(t.device != dev for t in (k, v, kv_mask, *more)):
        raise ValueError("q, k, v, kv_mask and the other operands must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    hd = q.shape[-1]
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")
    if k.shape[1] == 0:
        raise ValueError("kv length must be positive")


def _mask_operand(kv_mask, multiple=1):
    """The kernels' mask: f32 rows, zero-padded to a multiple of ``multiple``
    keys, and their stride (0 for a shared mask)."""
    mask = kv_mask.to(torch.float32)
    pad = -mask.shape[-1] % multiple
    mask = (F.pad(mask, (0, pad)) if pad else mask).contiguous()
    return mask, (0 if mask.dim() == 1 else mask.shape[-1])


def _tma_operand(t):
    """``t``, or a contiguous copy where a dim longer than 1 has stride 0 (a
    broadcast), which a TMA tensor map cannot describe."""
    if any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)):
        return t.contiguous()
    return t


def _count(wrapper, design):
    wrapper.launches += 1
    name = f"{design}_launches"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _launch_wgmma(q, k, v, kv_mask, out, lse):
    """The Hopper forward (bf16, head_dim 128); ``lse`` may be None."""
    b, lq, h, hd = q.shape
    q, k, v = (_tma_operand(t) for t in (q, k, v))
    mask, mask_sb = _mask_operand(kv_mask, _WGMMA_TILE)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_row_attention_fwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, lq, k.shape[1],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask_sb, hd**-0.5, stream,
    )
    return lib, rc


def _launch_wmma(q, k, v, kv_mask, out, lse):
    """The WMMA/FMA forward (f32, or bf16 at head_dim 16 or 32)."""
    b, lq, h, hd = q.shape
    mask, mask_sb = _mask_operand(kv_mask)
    lib = _library()
    fn = lib.flash_row_attention_fwd if lse is None else lib.flash_row_attention_fwd_lse
    extra = () if lse is None else (lse.data_ptr(),)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        _DTYPE_CODES[q.dtype], hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), *extra,
        b, h, lq, k.shape[1],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask_sb, hd**-0.5, stream,
    )
    return lib, rc


FWD_LAUNCHERS = {"wgmma": _launch_wgmma, "wmma": _launch_wmma}


def _launch(q, k, v, kv_mask, with_lse=False):
    """One launch of a forward kernel, of the design ``kernel_design`` picks;
    returns the ungated output, and with ``with_lse`` also lse ``[B, H, Lq]``
    f32."""
    _check_kernel_inputs(q, k, v, kv_mask)
    dev = q.device
    b, lq, h, hd = q.shape
    out = torch.empty((b, lq, h, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    design = kernel_design(q.dtype, hd)
    with torch.cuda.device(dev):
        lib, rc = FWD_LAUNCHERS[design](q, k, v, kv_mask, out, lse)
    if rc != 0:
        err = lib.flash_row_attention_error_string
        raise RuntimeError(f"flash_row_attention ({design}) launch failed: "
                           f"{err(rc).decode()} ({rc})")
    if with_lse:
        _count(flash_row_attention_lse, design)
        return out, lse
    _count(flash_row_attention, design)
    return out


def _launch_bwd_wgmma(q, k, v, kv_mask, o, lse, do, dq, dk, dv):
    """The Hopper backward (bf16, head_dim 128): delta, dK/dV and dQ kernels.
    lse goes in times log2(e), padded with +inf past Lq; delta is zeroed."""
    b, lq, h, hd = q.shape
    q, k, v = (_tma_operand(t) for t in (q, k, v))
    mask, mask_sb = _mask_operand(kv_mask, _WGMMA_TILE)
    valid = (mask.sum(dim=-1, keepdim=True) > 0).to(torch.float32).reshape(-1)
    lq_pad = -(-lq // _WGMMA_TILE) * _WGMMA_TILE
    lse2 = F.pad(lse.reshape(b * h, lq) * _LOG2E, (0, lq_pad - lq), value=math.inf)
    delta = torch.zeros((b * h, lq_pad), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_row_attention_bwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), valid.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, lq, k.shape[1], lq_pad,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        mask_sb, 0 if valid.numel() == 1 else 1, hd**-0.5, stream,
    )
    return lib, rc


def _launch_bwd_wmma(q, k, v, kv_mask, o, lse, do, dq, dk, dv):
    """The WMMA/FMA backward: delta, dK/dV and dQ kernels."""
    b, lq, h, hd = q.shape
    mask, mask_sb = _mask_operand(kv_mask)
    valid = (mask.sum(dim=-1, keepdim=True) > 0).to(torch.float32).reshape(-1)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_row_attention_bwd(
        _DTYPE_CODES[q.dtype], hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), valid.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, lq, k.shape[1],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        mask_sb, 0 if valid.numel() == 1 else 1, hd**-0.5, stream,
    )
    return lib, rc


BWD_LAUNCHERS = {"wgmma": _launch_bwd_wgmma, "wmma": _launch_bwd_wmma}


def _launch_bwd(q, k, v, kv_mask, out, lse, d_out):
    """One call of the backward entry point of the design ``kernel_design``
    picks (delta, dK/dV and dQ kernels)."""
    _check_kernel_inputs(q, k, v, kv_mask, out, lse, d_out)
    dev = q.device
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    dq = torch.empty((b, lq, h, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((b, lk, h, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((b, lk, h, hd), dtype=v.dtype, device=dev)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    o = out.to(q.dtype).contiguous()
    do = d_out.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    design = kernel_design(q.dtype, hd)
    with torch.cuda.device(dev):
        lib, rc = BWD_LAUNCHERS[design](q, k, v, kv_mask, o, lse, do, dq, dk, dv)
    if rc != 0:
        err = lib.flash_row_attention_bwd_error_string
        raise RuntimeError(f"flash_row_attention_bwd ({design}) launch failed: "
                           f"{err(rc).decode()} ({rc})")
    _count(flash_row_attention_bwd, design)
    return dq, dk, dv


def _device_type(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def flash_row_attention(q, k, v, kv_mask):
    """softmax(q kᵀ · hd^-0.5 + mask) v, returns ``[B, Lq, H, hd]``.

    CPU tensors take ``reference_row_attention``; CUDA tensors launch the
    kernel (and raise if it cannot take them). The kernel's output carries no
    gradient, so a CUDA call with grad mode on and an input that requires grad
    raises: use ``flash_row_attention_trainable`` there.
    ``flash_row_attention.launches`` counts kernel launches.
    """
    _check(q, k, v, kv_mask)
    if _device_type(q) == "cpu":
        out = reference_row_attention(q, k, v, kv_mask)
    else:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise RuntimeError(
                "flash_row_attention's CUDA kernel returns no gradient; call "
                "flash_row_attention_trainable when q, k or v requires grad")
        out = _launch(q, k, v, kv_mask)
    return out * _any_valid_gate(kv_mask, out.dtype)


def flash_row_attention_lse(q, k, v, kv_mask):
    """``(out, lse)``: the gated output and the f32 logsumexp ``[B, H, Lq]``.

    The forward of the trainable op (JAX ``_flash_fwd_lse``). CPU tensors take
    ``reference_row_attention_lse``; CUDA tensors launch the lse kernel.
    ``flash_row_attention_lse.launches`` counts its launches.
    """
    _check(q, k, v, kv_mask)
    if _device_type(q) == "cpu":
        out, lse = reference_row_attention_lse(q, k, v, kv_mask)
    else:
        out, lse = _launch(q, k, v, kv_mask, with_lse=True)
    return out * _any_valid_gate(kv_mask, out.dtype), lse


def flash_row_attention_bwd(q, k, v, kv_mask, out, lse, d_out):
    """``(dq, dk, dv)`` of the row attention, given the gated output ``out``,
    its ``lse`` and the output cotangent ``d_out`` (JAX ``_trainable_bwd``).

    CPU tensors take ``reference_row_attention_bwd``; CUDA tensors call the
    backward kernels. ``flash_row_attention_bwd.launches`` counts the calls
    (three kernels each: delta, dK/dV, dQ).
    """
    _check(q, k, v, kv_mask)
    if _device_type(q) == "cpu":
        return reference_row_attention_bwd(q, k, v, kv_mask, out, lse, d_out)
    return _launch_bwd(q, k, v, kv_mask, out, lse, d_out)


class _FlashRowAttention(torch.autograd.Function):
    """Forward: the lse kernel; backward: the backward kernels (JAX custom VJP
    ``_trainable_fwd`` / ``_trainable_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask):
        out, lse = flash_row_attention_lse(q, k, v, kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_row_attention_bwd(q, k, v, kv_mask, out, lse, d_out)
        return dq, dk, dv, None


def flash_row_attention_trainable(q, k, v, kv_mask):
    """Differentiable row attention, with ``flash_row_attention``'s contract:
    gradients for q, k and v (zero for batch rows with no valid key), none for
    the mask."""
    _check(q, k, v, kv_mask)
    return _FlashRowAttention.apply(q, k, v, kv_mask)


for _wrapper in (flash_row_attention, flash_row_attention_lse, flash_row_attention_bwd):
    _wrapper.launches = 0
    for _design in DESIGNS:
        setattr(_wrapper, f"{_design}_launches", 0)
del _wrapper, _design
