"""Sequence-parallel (context-sharded) TabICA forward.

Counterpart of ``npe_pfn_tpu/parallel/context_sharded.py``. The context row
axis is sharded over a mesh axis (``"sp"``): rank r holds rows
``[r·N/n, (r+1)·N/n)``, the feature attention and the MLP are row-local, and
only the row attention crosses ranks, in one of two ways:

- ``"gather"``: each layer all-gathers the K/V shards along the row axis in
  rank order, and ``transformer._row_attn`` attends against the whole
  context (the inference kernel on a card, the trainable path under grad);
- ``"ring"``: K/V never gather. Each of the n hops calls
  ``flash_row_attention_lse`` on the local queries against the shard it
  holds, merges the partial result into the running one in f32 through the
  lse (``lse = logaddexp(lse_acc, lse_i)``, ``o = o_acc·e^(lse_acc − lse) +
  o_i·e^(lse_i − lse)``) and passes K/V one hop along the ring
  (``batch_isend_irecv``; JAX ``ppermute``) while it computes.

The caller passes the whole raw context, as JAX's API takes global arrays,
and every rank computes the normalisation statistics from all of it, so
every rank holds the whole context mask: the gather moves only K/V, and a
ring hop slices the mask of the shard it holds. The K/V cache stays sharded.

Differences from the JAX package, deliberate: a row-pooled model raises
``ValueError`` (JAX's sharded block ignores ``row_pool_slots`` and computes
another function than ``fit_encode``); in the ring a shard whose keys are
all masked weighs nothing, and a query with every key masked gets 0, where
JAX's ring gets the mean of V; the lse kernel returns each hop's output in
the model's dtype (bf16 for the shipped checkpoint), so each hop's partial
output is rounded before the f32 merge, where JAX accumulates in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import regressor
from ..models.regressor import FittedContext, TabICAModel
from ..models.transformer import (
    _dt,
    _embed_ctx,
    _embed_qry,
    _feat_attn_step,
    _head,
    _ln,
    _mlp_step,
    _out_proj,
    _proj,
    _project_kv,
    _res_add,
    _row_attn,
    _token_mask,
    layer,
)
from ..ops.flash_attention import flash_row_attention_lse
from .mesh import axis_size, axis_slice, gather, has_axis

_MODES = ("gather", "ring")


def _gathered_row_attn(cfg, p, q_in, k, v, ctx_mask, mesh, axis):
    """Row attention of local query rows against K/V all-gathered along the
    row axis (``[T, N_local, H, hd]`` -> ``[T, N, H, hd]``)."""
    k_all = gather(k, mesh, axis, dim=-3)
    v_all = gather(v, mesh, axis, dim=-3)
    return _row_attn(cfg, p, q_in, k_all, v_all, ctx_mask)


def merge_partials(o_acc, lse_acc, o, lse):
    """Fold one key shard's attention ``(o [B, Lq, H, hd], lse [B, H, Lq])``,
    as ``flash_row_attention_lse`` returns it, into the running f32 result
    over the shards before it (``o_acc`` None for the first); returns
    ``(o_acc, lse_acc)``, ``lse_acc [B, H, Lq]``. A shard with every key
    masked (lse about -1e30) weighs nothing."""
    o, lse = o.float(), lse.float()
    if o_acc is None:
        return o, lse
    new = torch.logaddexp(lse_acc, lse)
    w_acc, w = (torch.exp(t - new).transpose(-2, -1)[..., None] for t in (lse_acc, lse))
    return o_acc * w_acc + o * w, new


def _ring_row_attn(cfg, p, q_in, k, v, ctx_mask, mesh, axis):
    """Row attention with K/V shards passed around the ring, merged through
    the lse in f32."""
    dt = _dt(cfg.dtype)
    q = _proj(q_in, p["wq"], dt)
    lead, (lq, h, hd) = q.shape[:-3], q.shape[-3:]
    nl = k.shape[-3]
    qf = q.reshape(-1, lq, h, hd)
    group = mesh.get_group(axis)
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(r + 1) % n], ranks[(r - 1) % n]
    o_acc = lse_acc = None
    for hop in range(n):
        pending = None
        if hop + 1 < n:  # the next shard travels while this one is attended
            k_in, v_in = torch.empty_like(k), torch.empty_like(v)
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k, nxt, group), dist.P2POp(dist.isend, v, nxt, group),
                dist.P2POp(dist.irecv, k_in, prv, group), dist.P2POp(dist.irecv, v_in, prv, group),
            ])
        src = (r - hop) % n  # the shard this rank holds at this hop
        o, lse = flash_row_attention_lse(qf, k.reshape(-1, nl, h, hd), v.reshape(-1, nl, h, hd),
                                         ctx_mask[src * nl:(src + 1) * nl])
        o_acc, lse_acc = merge_partials(o_acc, lse_acc, o, lse)
        if pending is not None:
            for work in pending:
                work.wait()
            k, v = k_in, v_in
    return _out_proj(p, o_acc.to(dt).reshape(lead + (lq, h, hd)))


def _row_attention(mesh, axis, mode, ctx_mask):
    """``attend(cfg, p, q_in, k_local, v_local)`` of the mode."""
    if mode not in _MODES:
        raise ValueError(f"row_attn must be one of {_MODES}, got {mode!r}")
    fn = _ring_row_attn if mode == "ring" else _gathered_row_attn
    return lambda cfg, p, q_in, k, v: fn(cfg, p, q_in, k, v, ctx_mask, mesh, axis)


def _check_unpooled(cfg):
    if cfg.row_pool_slots:
        raise ValueError("context sharding takes a model without row pooling: JAX's sharded "
                         "block ignores row_pool_slots and computes another function than "
                         "fit_encode, so the port refuses it")


def _row_step(cfg, p, h, attend, kv=None):
    """The row-attention step of one block on ``h [R, T, D]`` (local rows);
    without ``kv`` the rows are context rows and their K/V is returned."""
    hr = h.transpose(-3, -2)  # [T, R, D]
    hr_n = _ln(p["ln_row"], hr).to(_dt(cfg.dtype))
    if kv is None:
        kv = _project_kv(cfg, p["row_attn"], hr_n)
    hr = _res_add(cfg, hr, attend(cfg, p["row_attn"], hr_n, *kv))
    return hr.transpose(-3, -2), kv


@torch.no_grad()
def sp_fit_encode(
    mesh: DeviceMesh,
    model: TabICAModel,
    x_ctx,  # [N, F] raw, the whole context; N divisible by the sp axis size
    y_ctx,
    feat_mask: Optional[torch.Tensor] = None,
    ctx_mask: Optional[torch.Tensor] = None,
    axis: str = "sp",
    row_attn: str = "gather",
) -> FittedContext:
    """Context-sharded ``fit_encode``: the returned ``FittedContext`` holds
    this rank's rows of every layer's K/V (``[T, N/n, H, hd]``), the whole
    context's statistics and masks. ``row_attn`` is ``"gather"`` or
    ``"ring"``."""
    cfg, params = model.cfg, model.params
    _check_unpooled(cfg)
    n, f = x_ctx.shape
    rows = axis_slice(mesh, axis, n, "context rows")
    dev = x_ctx.device
    if feat_mask is None:
        feat_mask = torch.ones((f,), dtype=torch.bool, device=dev)
    if ctx_mask is None:
        ctx_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    feat_mask, ctx_mask = feat_mask.bool(), ctx_mask.bool()
    stats = regressor.compute_stats(x_ctx, y_ctx, ctx_mask)
    xn = regressor.normalize_x(stats, x_ctx) * feat_mask[None, :]
    yn = regressor.normalize_y(stats, y_ctx) * ctx_mask
    token_mask = _token_mask(feat_mask)
    attend = _row_attention(mesh, axis, row_attn, ctx_mask)
    h = _embed_ctx(cfg, params["embed"], xn[rows], yn[rows], feat_mask)
    cache = []
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        h, kv = _row_step(cfg, p, _feat_attn_step(cfg, p, h, token_mask), attend)
        h = _mlp_step(cfg, p, h)
        cache.append(kv)
    return FittedContext(cache=cache, stats=stats, feat_mask=feat_mask, ctx_mask=ctx_mask)


@torch.no_grad()
def sp_decode(
    mesh: DeviceMesh,
    model: TabICAModel,
    fitted: FittedContext,
    x_qry,  # [Q, F] raw; Q divisible by the data axis (if the mesh has one)
    axis: str = "sp",
    data_axis: Optional[str] = "data",
    row_attn: str = "gather",
):
    """Decode queries against the sharded cache of ``sp_fit_encode``: bar
    logits ``[Q, num_bars]`` on every rank (the head's, as JAX's, without
    the temperature). Query rows ride ``data_axis`` when the mesh has one
    (gathered in rank order at the end); the K/V gathers or ring hops ride
    ``axis``."""
    cfg, params = model.cfg, model.params
    _check_unpooled(cfg)
    xq = regressor.normalize_x(fitted.stats, x_qry) * fitted.feat_mask[None, :]
    have_data = has_axis(mesh, data_axis)
    if have_data:
        xq = xq[axis_slice(mesh, data_axis, xq.shape[0], "query rows")]
    token_mask = _token_mask(fitted.feat_mask)
    attend = _row_attention(mesh, axis, row_attn, fitted.ctx_mask)
    h = _embed_qry(cfg, params["embed"], xq, fitted.feat_mask)
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        h, _ = _row_step(cfg, p, _feat_attn_step(cfg, p, h, token_mask), attend, fitted.cache[i])
        h = _mlp_step(cfg, p, h)
    logits = _head(cfg, params["head"], h)
    return gather(logits, mesh, data_axis) if have_data else logits
