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


class SplitParams(dict):
    """A parameter dict whose product a group of ranks shares.

    Tensor parallelism gives each rank some of an attention's heads or of a
    dense MLP's hidden units, expert parallelism some of a MoE MLP's experts
    (``npe_pfn_tpu_torch.parallel``). A rank's product over its share is a
    partial sum: ``reduce`` sums it over the group, in place, where GSPMD
    inserts the psum in the JAX package (after ``wo``, the dense ``w2`` and
    the expert combine), and the residual bias is added once after it.
    The reduce carries no gradient (autograd would take it for the identity
    and never sum the split input projections' gradients), so a placed model
    runs forward only: under grad it raises. ``expert0`` is the global index
    of the rank's first expert. The leaves are plain tensors, so
    ``pytree_io`` and checkpoints see a plain tree.
    """

    def __init__(self, items, reduce, expert0: int = 0):
        super().__init__(items)
        self.reduce = reduce
        self.expert0 = expert0


def _reduced(p: Params, x):
    """``x`` summed over the ranks that share ``p``'s product (``x`` itself
    for a plain dict)."""
    if not isinstance(p, SplitParams):
        return x
    if x.requires_grad:
        raise RuntimeError("a tensor- or expert-parallel model runs forward only: its "
                           "all_reduce carries no gradient; train data-parallel instead")
    return p.reduce(x)


def layer(blocks: Params, i: int) -> Params:
    """The ``i``-th layer's slice of the stacked block parameters."""
    out = {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}
    if isinstance(blocks, SplitParams):
        return SplitParams(out, blocks.reduce, blocks.expert0)
    return out


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: TabICAConfig, device=None) -> Params:
    """GPT-2-style init with the JAX package's tree, shapes and scales: normal
    weights of std 0.02, residual-output projections (``wo``, ``mlp/w2``) at
    0.02 / sqrt(2 * 3 * num_layers), embeddings at std 1, zero biases, unit
    layer-norm scales. Block parameters are stacked along a leading layer
    axis; storage is f32. Draws come from ``generator`` (on its own device)
    and land on ``device`` (default: the generator's).

    With ``cfg.row_pool_slots`` the blocks carry a ``pool`` subtree (slot
    embeddings ``[L, K, D]`` at std 1, the pooling and unpooling attentions
    and two layer norms); with ``cfg.num_experts`` the MLP is expert-major
    (``router [L, D, E]``, ``w1 [L, E, D, 4D]``, ``w2`` at the residual
    scale), as in the JAX package."""
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

    pool = {}
    if cfg.row_pool_slots:
        pool = {"pool": {
            "slots": nrm((n, cfg.row_pool_slots, d), 1.0),
            "pool_attn": attn_params(),
            "ln_slot": ln(),
            "ln_unpool": ln(),
            "unpool_attn": attn_params(),
        }}
    e = cfg.num_experts
    if e:
        mlp = {
            "router": nrm((n, d, e)),
            "w1": nrm((n, e, d, hid)),
            "b1": zeros(n, e, hid),
            "w2": nrm((n, e, hid, d), out_scale),
            "b2": zeros(n, e, d),
        }
    else:
        mlp = {
            "w1": nrm((n, d, hid)),
            "b1": zeros(n, hid),
            "w2": nrm((n, hid, d), out_scale),
            "b2": zeros(n, d),
        }
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
            "mlp": mlp,
            **pool,
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


def _out_proj(p: Params, out):
    """``einsum('...qhd,hdm->...qm', preferred f32)`` with ``p["wo"]``, summed
    over the ranks that share the heads, ``+ p["bo"]``: f32 result."""
    h, hd, m = p["wo"].shape
    wf = p["wo"].to(out.dtype).float().reshape(h * hd, m)
    return _reduced(p, out.reshape(*out.shape[:-2], h * hd).float() @ wf) + p["bo"]


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
    return _out_proj(p, out)


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
    return _out_proj(p, out)


def _row_attn(cfg, p, q_in, k, v, ctx_mask):
    """Row-axis attention with kernel dispatch. ctx_mask: ``[..., N]``."""
    if _use_kernel(cfg, q_in):
        return _attn_core_flash(cfg, p, q_in, k, v, ctx_mask)
    return _attn_core(cfg, p, q_in, k, v, ctx_mask[..., None, :])


def _moe_mlp(cfg: TabICAConfig, p: Params, x, aux_dims=None):
    """Top-k-routed mixture-of-experts MLP, every expert computed densely.

    Returns ``(out, aux)``. The router runs in f32; a token takes every
    expert whose router logit is ``>=`` its k-th largest (a tie takes more
    than k, as in the JAX package) with softmax gates over those. ``aux`` is
    the Switch-style load-balance loss E * sum_e (f_e / k) * P_e (1 under
    uniform routing, E/k under full collapse), with f_e the share of tokens
    routed to expert e and P_e the mean router probability, both averaged
    over the token axes ``aux_dims`` (every leading dim is what JAX reduces
    for one dataset). Padded tokens count like any other. Without
    ``aux_dims`` the aux is not computed and is None.
    """
    dt = _dt(cfg.dtype)
    n_exp, k = cfg.num_experts, cfg.moe_top_k
    glog = x.float() @ p["router"].float()
    kth = torch.topk(glog, k, dim=-1).values[..., -1:]
    sel = glog >= kth
    gates = torch.softmax(glog.masked_fill(~sel, _NEG_INF), dim=-1)
    if isinstance(p, SplitParams):  # routed over all experts; this rank's gates
        gates = gates[..., p.expert0:p.expert0 + p["w1"].shape[-3]]
    h = torch.einsum("...d,edh->...eh", x.to(dt), p["w1"].to(dt)) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    y = torch.einsum("...eh,ehd->...ed", h.float(), p["w2"].to(dt).float()) + p["b2"]
    out = _reduced(p, torch.einsum("...e,...ed->...d", gates, y))
    if aux_dims is None:
        return out, None
    frac = sel.float().mean(dim=aux_dims)
    prob = torch.softmax(glog, dim=-1).mean(dim=aux_dims)
    aux = n_exp * ((frac / k) * prob).sum(dim=-1)
    return out, aux


def _mlp(cfg: TabICAConfig, p: Params, x):
    if "router" in p:
        return _moe_mlp(cfg, p, x)[0]
    dt = _dt(cfg.dtype)
    h = (x.to(dt) @ p["w1"].to(dt)) + p["b1"]
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    return _reduced(p, h.float() @ p["w2"].to(dt).float()) + p["b2"]


def _res_add(cfg, h, delta):
    """Residual add accumulated in f32, stored in cfg.dtype."""
    return (h.float() + delta).to(_dt(cfg.dtype))


def _feat_attn_step(cfg, p, h, token_mask):
    hn = _ln(p["ln_feat"], h)
    return _res_add(cfg, h, _attn(cfg, p["feat_attn"], hn, hn, token_mask[..., None, :]))


def _mlp_step(cfg, p, h):
    return _res_add(cfg, h, _mlp(cfg, p["mlp"], _ln(p["ln_mlp"], h)))


# Per-dataset MoE aux: the MLP input is [..., R, T, D] (rows, cell tokens),
# so the router statistics average over its two token axes and keep the
# leading dataset dims, as the JAX package's vmap over datasets does.
_TOKEN_DIMS = (-3, -2)


def _mlp_step_aux(cfg, p, h):
    """The MLP step and its MoE aux loss per leading dim (0 for a dense MLP)."""
    x = _ln(p["ln_mlp"], h)
    if "router" in p["mlp"]:
        delta, aux = _moe_mlp(cfg, p["mlp"], x, _TOKEN_DIMS)
    else:
        delta = _mlp(cfg, p["mlp"], x)
        aux = torch.zeros(h.shape[:-3], dtype=torch.float32, device=h.device)
    return _res_add(cfg, h, delta), aux


def _pool_rows(cfg, p, hn, token_mask):
    """Attention-pool each row's T cell tokens into K learned slots: hn
    ``[..., R, T, D]`` (layer-normed) -> ``[..., R, K, D]``. Padded feature
    tokens are masked out of the keys; the target token is always valid."""
    pp = p["pool"]
    slots = pp["slots"].broadcast_to(hn.shape[:-2] + pp["slots"].shape)
    return _attn(cfg, pp["pool_attn"], slots, hn, token_mask[..., None, :])


def _unpool_rows(cfg, p, hn, s):
    """Tokens ``[..., R, T, D]`` cross-attend over their row's K slots
    ``[..., R, K, D]``."""
    pp = p["pool"]
    return _attn(cfg, pp["unpool_attn"], hn, _ln(pp["ln_unpool"], s), None)


def _row_step_pooled(cfg, p, h, token_mask, ctx_mask, kv=None):
    """Row attention through K slots per row: pool, attend across rows per
    slot (``[..., K, R, D]``: the kernel's batch is leading dims x K), unpool.
    Without ``kv`` the rows are context rows and their slot K/V is returned."""
    hn = _ln(p["ln_row"], h)
    s = _pool_rows(cfg, p, hn, token_mask).transpose(-3, -2)  # [..., K, R, D]
    sn = _ln(p["pool"]["ln_slot"], s).to(_dt(cfg.dtype))
    if kv is None:
        kv = _project_kv(cfg, p["row_attn"], sn)
    s = _res_add(cfg, s, _row_attn(cfg, p["row_attn"], sn, *kv, ctx_mask))
    return _res_add(cfg, h, _unpool_rows(cfg, p, hn, s.transpose(-3, -2))), kv


def _block_ctx(cfg, p, h_ctx, token_mask, ctx_mask):
    """Context rows through one block's attention steps (feature, then row;
    the MLP step is the caller's). Returns the new state and the
    row-attention K/V cache: ``[..., T, N, H, hd]``, or ``[..., K, N, H, hd]``
    with row pooling (the decode path is agnostic to the slot axis)."""
    h_ctx = _feat_attn_step(cfg, p, h_ctx, token_mask)
    if cfg.row_pool_slots:
        return _row_step_pooled(cfg, p, h_ctx, token_mask, ctx_mask)
    hc = h_ctx.transpose(-3, -2)  # [..., T, N, D]
    hc_n = _ln(p["ln_row"], hc).to(_dt(cfg.dtype))
    kv = _project_kv(cfg, p["row_attn"], hc_n)
    hc = _res_add(cfg, hc, _row_attn(cfg, p["row_attn"], hc_n, *kv, ctx_mask))
    return hc.transpose(-3, -2), kv


def _block_qry(cfg, p, h_qry, kv_cache, token_mask, ctx_mask):
    """Query rows through one block's attention steps against the cached
    context K/V (the MLP step is the caller's)."""
    h_qry = _feat_attn_step(cfg, p, h_qry, token_mask)
    if cfg.row_pool_slots:
        return _row_step_pooled(cfg, p, h_qry, token_mask, ctx_mask, kv_cache)[0]
    hq = h_qry.transpose(-3, -2)  # [..., T, Q, D]
    hq_n = _ln(p["ln_row"], hq).to(_dt(cfg.dtype))
    hq = _res_add(cfg, hq, _row_attn(cfg, p["row_attn"], hq_n, *kv_cache, ctx_mask))
    return hq.transpose(-3, -2)


def _block_joint(cfg, blocks, i, h_ctx, h_qry, token_mask, ctx_mask):
    """Layer ``i`` on context and query rows (the unit ``remat`` recomputes).
    Returns the new states and the layer's MoE aux loss, the mean of the
    context's and the queries' (both route through the MLP; 0 when dense)."""
    p = layer(blocks, i)
    h_ctx, kv = _block_ctx(cfg, p, h_ctx, token_mask, ctx_mask)
    h_qry = _block_qry(cfg, p, h_qry, kv, token_mask, ctx_mask)
    h_ctx, aux_c = _mlp_step_aux(cfg, p, h_ctx)
    h_qry, aux_q = _mlp_step_aux(cfg, p, h_qry)
    return h_ctx, h_qry, 0.5 * (aux_c + aux_q)


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
    body). ``with_moe_aux`` returns ``(logits, aux)``: aux is the MoE
    load-balance loss averaged over layers, one value per leading (dataset)
    dim, ``[...]``, each what JAX returns for that dataset alone; 0 for a
    dense MLP.
    """
    feat_mask, token_mask, ctx_mask = _masks(x_ctx, feat_mask, ctx_mask)
    e = params["embed"]
    h_ctx = _embed_ctx(cfg, e, x_ctx, y_ctx, feat_mask)
    h_qry = _embed_qry(cfg, e, x_qry, feat_mask)
    aux = 0.0
    for i in range(cfg.num_layers):
        args = (cfg, params["blocks"], i, h_ctx, h_qry, token_mask, ctx_mask)
        if remat:
            h_ctx, h_qry, a = checkpoint(_block_joint, *args, use_reentrant=False,
                                         preserve_rng_state=False)
        else:
            h_ctx, h_qry, a = _block_joint(*args)
        aux = aux + a
    logits = _head(cfg, params["head"], h_qry)
    if with_moe_aux:
        return logits, aux / cfg.num_layers
    return logits


@torch.no_grad()
def encode_context(cfg: TabICAConfig, params: Params, x_ctx, y_ctx,
                   feat_mask=None, ctx_mask=None):
    """Encode the context once; returns the per-layer row-attention K/V cache
    as a list of ``(k, v)``, each ``[..., T, N, H, hd]`` (``[..., K, N, H, hd]``
    with ``cfg.row_pool_slots`` K)."""
    feat_mask, token_mask, ctx_mask = _masks(x_ctx, feat_mask, ctx_mask)
    h_ctx = _embed_ctx(cfg, params["embed"], x_ctx, y_ctx, feat_mask)
    cache = []
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        h_ctx, kv = _block_ctx(cfg, p, h_ctx, token_mask, ctx_mask)
        h_ctx = _mlp_step(cfg, p, h_ctx)
        cache.append(kv)
    return cache


@torch.no_grad()
def decode_queries(cfg: TabICAConfig, params: Params, cache, x_qry,
                   feat_mask=None, ctx_mask=None):
    """Run query rows ``[..., Q, F]`` against a cached context."""
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
        p = layer(params["blocks"], i)
        h_qry = _block_qry(cfg, p, h_qry, cache[i], token_mask, ctx_mask.bool())
        h_qry = _mlp_step(cfg, p, h_qry)
    return _head(cfg, params["head"], h_qry)
