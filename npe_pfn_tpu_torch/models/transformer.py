"""TabICA two-axis in-context tabular transformer.

Counterpart of ``npe_pfn_tpu/models/transformer.py``. Every table cell is a
token of width ``d_model``; each block runs attention across the feature axis
within a row, attention across the row axis within a column, and an MLP.
Context rows attend to context rows; query rows attend only to context rows,
so ``encode_context`` caches each layer's row-attention K/V once and
``decode_queries`` streams query rows against it. The joint ``forward`` is
differentiable (pretraining, with per-layer recomputation under ``remat``);
``encode_context`` and ``decode_queries`` run without gradients.

Parameters are the nested dict of ``checkpoint.params_from_numpy``, with block
weights stacked along a leading layer axis. The dtype policy is the JAX
package's: parameters are stored in f32 and cast to ``cfg.dtype`` for the
matmuls, layer norms and the head run in f32, products marked
``preferred_element_type=float32`` in JAX accumulate and return f32 here too,
and the residual stream is stored in ``cfg.dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_row_attention, flash_row_attention_trainable
from ..utils.pytree_io import flatten
from .config import TabICAConfig

Params = dict
_NEG_INF = -1e9
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(cfg: TabICAConfig):
    if cfg.num_experts:
        raise NotImplementedError(
            "mixture-of-experts MLP (num_experts > 0) is not ported yet "
            "(ROADMAP Queue 1: training / MoE)"
        )
    if cfg.row_pool_slots:
        raise NotImplementedError(
            "row_pool_slots > 0 is not ported yet (ROADMAP Queue 1: training / row pooling)"
        )


def layer(blocks: Params, i: int) -> Params:
    """The ``i``-th layer's slice of the stacked block parameters."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: TabICAConfig, device=None) -> Params:
    """GPT-2-style init with the JAX package's tree, shapes and scales: normal
    weights of std 0.02, residual-output projections (``wo``, ``mlp/w2``) at
    0.02 / sqrt(2 * 3 * num_layers), embeddings at std 1, zero biases, unit
    layer-norm scales. Block parameters are stacked along a leading layer
    axis; storage is f32. Draws come from ``generator`` (on its own device)
    and land on ``device`` (default: the generator's)."""
    _check_supported(cfg)
    d, h, hd, n = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers
    hid = d * cfg.mlp_ratio
    device = generator.device if device is None else torch.device(device)
    f32 = torch.float32
    out_scale = 0.02 / math.sqrt(2.0 * 3 * n)

    def nrm(shape, s=0.02):
        draw = torch.randn(shape, generator=generator, device=generator.device, dtype=f32)
        return (s * draw).to(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def attn_params():
        return {
            "wq": nrm((n, d, h, hd)),
            "wk": nrm((n, d, h, hd)),
            "wv": nrm((n, d, h, hd)),
            "wo": nrm((n, h, hd, d), out_scale),
            "bo": zeros(n, d),
        }

    def ln():
        return {"scale": torch.ones((n, d), dtype=f32, device=device), "bias": zeros(n, d)}

    return {
        "embed": {
            "w_feat": nrm((d,), 1.0),
            "b_feat": zeros(d),
            "w_y": nrm((d,), 1.0),
            "b_y": zeros(d),
            "y_missing": nrm((d,), 1.0),
        },
        "blocks": {
            "ln_feat": ln(),
            "feat_attn": attn_params(),
            "ln_row": ln(),
            "row_attn": attn_params(),
            "ln_mlp": ln(),
            "mlp": {
                "w1": nrm((n, d, hid)),
                "b1": zeros(n, hid),
                "w2": nrm((n, hid, d), out_scale),
                "b2": zeros(n, d),
            },
        },
        "head": {
            "ln": {"scale": torch.ones((d,), dtype=f32, device=device), "bias": zeros(d)},
            "w1": nrm((d, 2 * d)),
            "b1": zeros(2 * d),
            "w2": nrm((2 * d, cfg.num_bars)),
            "b2": zeros(cfg.num_bars),
        },
    }


def param_count(params: Params) -> int:
    return sum(t.numel() for t in flatten(params).values())


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def _ln(p: Params, x):
    """Layer norm in f32 (eps 1e-6); returns f32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _proj(x, w, dt):
    """``einsum('...ld,dhk->...lhk')`` in ``dt``: a contiguous [..., L, H, hd]."""
    d, h, hd = w.shape
    return (x.to(dt) @ w.reshape(d, h * hd).to(dt)).view(*x.shape[:-1], h, hd)


def _out_proj(out, w, b):
    """``einsum('...qhd,hdm->...qm', preferred f32) + b``: f32 result."""
    h, hd, m = w.shape
    wf = w.to(out.dtype).float().reshape(h * hd, m)
    return out.reshape(*out.shape[:-2], h * hd).float() @ wf + b


def _project_kv(cfg: TabICAConfig, p: Params, kv_in):
    dt = _dt(cfg.dtype)
    return _proj(kv_in, p["wk"], dt), _proj(kv_in, p["wv"], dt)


def _attn_core(cfg: TabICAConfig, p: Params, q_in, k, v, kv_mask: Optional[torch.Tensor]):
    """Dense multi-head attention against precomputed K/V.

    q_in ``[..., Lq, D]``; k, v ``[..., Lk, H, hd]``; kv_mask broadcastable to
    ``[..., Lk]`` (as in JAX, with one extra axis for the query rows). The
    logits are stored in ``cfg.scores_dtype`` before the mask (-1e9) and the
    f32 softmax, whose result is cast to ``cfg.dtype``.
    """
    dt, sdt = _dt(cfg.dtype), _dt(cfg.scores_dtype)
    scale = cfg.head_dim**-0.5
    q = _proj(q_in, p["wq"], dt)
    logits = (torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale).to(sdt)
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[..., None, None, :].bool(), _NEG_INF)
    attn = torch.softmax(logits.float(), dim=-1).to(dt)
    out = torch.einsum("...hqk,...khd->...qhd", attn, v)
    return _out_proj(out, p["wo"], p["bo"])


def _attn(cfg, p, q_in, kv_in, kv_mask):
    k, v = _project_kv(cfg, p, kv_in)
    return _attn_core(cfg, p, q_in, k, v, kv_mask)


def _use_kernel(cfg: TabICAConfig, q_in) -> bool:
    """Row-attention dispatch: 'on' forces the kernel's function, 'off' the
    dense path; 'auto' takes the kernel for CUDA tensors and the dense path on
    the CPU (the JAX package's choice off the TPU)."""
    if cfg.flash == "off" or q_in.dim() < 3:
        return False
    if cfg.flash == "on":
        return True
    return q_in.device.type == "cuda"


def _attn_core_flash(cfg: TabICAConfig, p: Params, q_in, k, v, kv_mask):
    """Row attention through the kernel's op with the leading batch dims
    flattened; a per-batch mask becomes ``[B, Lk]`` rows. Under grad mode with
    q, k or v requiring grad it takes ``flash_row_attention_trainable`` (lse
    forward and backward kernels), otherwise ``flash_row_attention`` (the JAX
    primal routes to the plain forward kernel the same way)."""
    dt = _dt(cfg.dtype)
    q = _proj(q_in, p["wq"], dt)
    lead = q.shape[:-3]
    lq, h, hd = q.shape[-3:]
    lk = k.shape[-3]
    qf = q.reshape(-1, lq, h, hd)
    kf = k.reshape(-1, lk, h, hd)
    vf = v.reshape(-1, lk, h, hd)
    if kv_mask.dim() == 1:
        mf = kv_mask
    else:
        mf = kv_mask[..., None, :].broadcast_to(lead + (lk,)).reshape(-1, lk)
    trainable = torch.is_grad_enabled() and (qf.requires_grad or kf.requires_grad
                                             or vf.requires_grad)
    attn = flash_row_attention_trainable if trainable else flash_row_attention
    out = attn(qf, kf, vf, mf).reshape(lead + (lq, h, hd))
    return _out_proj(out, p["wo"], p["bo"])


def _row_attn(cfg, p, q_in, k, v, ctx_mask):
    """Row-axis attention with kernel dispatch. ctx_mask: ``[..., N]``."""
    if _use_kernel(cfg, q_in):
        return _attn_core_flash(cfg, p, q_in, k, v, ctx_mask)
    return _attn_core(cfg, p, q_in, k, v, ctx_mask[..., None, :])


def _mlp(cfg: TabICAConfig, p: Params, x):
    dt = _dt(cfg.dtype)
    h = (x.to(dt) @ p["w1"].to(dt)) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    return h.float() @ p["w2"].to(dt).float() + p["b2"]


def _res_add(cfg, h, delta):
    """Residual add accumulated in f32, stored in cfg.dtype."""
    return (h.float() + delta).to(_dt(cfg.dtype))


def _feat_attn_step(cfg, p, h, token_mask):
    hn = _ln(p["ln_feat"], h)
    return _res_add(cfg, h, _attn(cfg, p["feat_attn"], hn, hn, token_mask[..., None, :]))


def _mlp_step(cfg, p, h):
    return _res_add(cfg, h, _mlp(cfg, p["mlp"], _ln(p["ln_mlp"], h)))


def _block_ctx(cfg, p, h_ctx, token_mask, ctx_mask):
    """Context rows through one block; returns the new state and the
    row-attention K/V cache."""
    h_ctx = _feat_attn_step(cfg, p, h_ctx, token_mask)
    hc = h_ctx.transpose(-3, -2)  # [..., T, N, D]
    hc_n = _ln(p["ln_row"], hc).to(_dt(cfg.dtype))
    k, v = _project_kv(cfg, p["row_attn"], hc_n)
    hc = _res_add(cfg, hc, _row_attn(cfg, p["row_attn"], hc_n, k, v, ctx_mask))
    h_ctx = hc.transpose(-3, -2)
    return _mlp_step(cfg, p, h_ctx), (k, v)


def _block_qry(cfg, p, h_qry, kv_cache, token_mask, ctx_mask):
    """Query rows through one block against the cached context K/V."""
    k, v = kv_cache
    h_qry = _feat_attn_step(cfg, p, h_qry, token_mask)
    hq = h_qry.transpose(-3, -2)  # [..., T, Q, D]
    hq_n = _ln(p["ln_row"], hq).to(_dt(cfg.dtype))
    hq = _res_add(cfg, hq, _row_attn(cfg, p["row_attn"], hq_n, k, v, ctx_mask))
    return _mlp_step(cfg, p, hq.transpose(-3, -2))


def _block_joint(cfg, blocks, i, h_ctx, h_qry, token_mask, ctx_mask):
    """Layer ``i`` on context and query rows (the unit ``remat`` recomputes)."""
    p = layer(blocks, i)
    h_ctx, kv = _block_ctx(cfg, p, h_ctx, token_mask, ctx_mask)
    return h_ctx, _block_qry(cfg, p, h_qry, kv, token_mask, ctx_mask)


# ---------------------------------------------------------------------------
# Embedding and head
# ---------------------------------------------------------------------------


def _embed(p, x, y_cell, feat_mask):
    # x: [..., R, F] -> [..., R, F+1, D]; y_cell: [..., R, D]; feat_mask [..., F].
    cells = x[..., None] * p["w_feat"] + p["b_feat"]
    cells = torch.where(feat_mask[..., None, :, None], cells, 0.0)
    return torch.cat([cells, y_cell[..., None, :]], dim=-2)


def _embed_ctx(cfg, p, x_ctx, y_ctx, feat_mask):
    y_cell = y_ctx[..., None] * p["w_y"] + p["b_y"]
    return _embed(p, x_ctx, y_cell, feat_mask).to(_dt(cfg.dtype))


def _embed_qry(cfg, p, x_qry, feat_mask):
    y_cell = p["y_missing"].broadcast_to(x_qry.shape[:-1] + (cfg.d_model,))
    return _embed(p, x_qry, y_cell, feat_mask).to(_dt(cfg.dtype))


def _head(cfg, p, h_qry):
    """Bar logits, in f32 whatever cfg.dtype is."""
    out = _ln(p["ln"], h_qry[..., -1, :])
    out = F.gelu(out @ p["w1"] + p["b1"], approximate="tanh")
    return out @ p["w2"] + p["b2"]


def _masks(x_ctx, feat_mask, ctx_mask):
    f, n = x_ctx.shape[-1], x_ctx.shape[-2]
    dev = x_ctx.device
    if feat_mask is None:
        feat_mask = torch.ones(x_ctx.shape[:-2] + (f,), dtype=torch.bool, device=dev)
    if ctx_mask is None:
        ctx_mask = torch.ones(x_ctx.shape[:-2] + (n,), dtype=torch.bool, device=dev)
    return feat_mask.bool(), _token_mask(feat_mask.bool()), ctx_mask.bool()


def _token_mask(feat_mask):
    ones = torch.ones(feat_mask.shape[:-1] + (1,), dtype=torch.bool, device=feat_mask.device)
    return torch.cat([feat_mask, ones], dim=-1)


# ---------------------------------------------------------------------------
# Public forward passes
# ---------------------------------------------------------------------------


def forward(cfg: TabICAConfig, params: Params, x_ctx, y_ctx, x_qry,
            feat_mask=None, ctx_mask=None, remat: bool = False, with_moe_aux: bool = False):
    """Joint forward: bar logits ``[..., Q, num_bars]``, differentiable.

    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of the layer
    body). ``with_moe_aux`` returns ``(logits, aux)``; aux is the MoE
    load-balance loss, 0.0 for the dense models the port runs.
    """
    _check_supported(cfg)
    feat_mask, token_mask, ctx_mask = _masks(x_ctx, feat_mask, ctx_mask)
    e = params["embed"]
    h_ctx = _embed_ctx(cfg, e, x_ctx, y_ctx, feat_mask)
    h_qry = _embed_qry(cfg, e, x_qry, feat_mask)
    for i in range(cfg.num_layers):
        args = (cfg, params["blocks"], i, h_ctx, h_qry, token_mask, ctx_mask)
        if remat:
            h_ctx, h_qry = checkpoint(_block_joint, *args, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            h_ctx, h_qry = _block_joint(*args)
    logits = _head(cfg, params["head"], h_qry)
    if with_moe_aux:
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits


@torch.no_grad()
def encode_context(cfg: TabICAConfig, params: Params, x_ctx, y_ctx,
                   feat_mask=None, ctx_mask=None):
    """Encode the context once; returns the per-layer row-attention K/V cache
    as a list of ``(k, v)``, each ``[..., T, N, H, hd]``."""
    _check_supported(cfg)
    feat_mask, token_mask, ctx_mask = _masks(x_ctx, feat_mask, ctx_mask)
    h_ctx = _embed_ctx(cfg, params["embed"], x_ctx, y_ctx, feat_mask)
    cache = []
    for i in range(cfg.num_layers):
        h_ctx, kv = _block_ctx(cfg, layer(params["blocks"], i), h_ctx, token_mask, ctx_mask)
        cache.append(kv)
    return cache


@torch.no_grad()
def decode_queries(cfg: TabICAConfig, params: Params, cache, x_qry,
                   feat_mask=None, ctx_mask=None):
    """Run query rows ``[..., Q, F]`` against a cached context."""
    _check_supported(cfg)
    n = cache[0][0].shape[-3]
    dev = x_qry.device
    if ctx_mask is None:
        ctx_mask = torch.ones(x_qry.shape[:-2] + (n,), dtype=torch.bool, device=dev)
    if feat_mask is None:
        feat_mask = torch.ones(x_qry.shape[:-2] + (x_qry.shape[-1],), dtype=torch.bool, device=dev)
    feat_mask = feat_mask.bool()
    token_mask = _token_mask(feat_mask)
    h_qry = _embed_qry(cfg, params["embed"], x_qry, feat_mask)
    for i in range(cfg.num_layers):
        h_qry = _block_qry(cfg, layer(params["blocks"], i), h_qry, cache[i], token_mask,
                           ctx_mask.bool())
    return _head(cfg, params["head"], h_qry)
