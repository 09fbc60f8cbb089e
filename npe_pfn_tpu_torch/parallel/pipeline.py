"""Pipeline-parallel (GPipe-style) TabICA forward over the layer axis.

Counterpart of ``npe_pfn_tpu/parallel/pipeline.py``. Stage s (rank s of the
``"pp"`` axis) owns layers ``[s·L/n, (s+1)·L/n)`` and the K/V cache those
layers produce; activations go stage to stage with ``send`` / ``recv`` (JAX
``ppermute``). The stage body is the port's ``_block_ctx`` / ``_block_qry``
and ``_mlp_step``, so pooled and MoE models pipeline as dense ones do.

- ``pp_fit_encode``: context rows cannot be split into microbatches (row
  attention spans every row), so the encode is one sequential fill: stage s
  waits for stage s−1's activations, runs its layers, keeps their K/V and
  sends on.
- ``pp_decode``: query rows are independent, so M microbatches stream
  through a real GPipe schedule: stage s takes microbatch t from stage s−1
  while stage s−1 works on t+1. JAX runs every stage every tick of its
  ``M + n − 1`` and masks what it keeps; the results are the same. The last
  stage's logits are broadcast to every rank, as JAX's psum replicates them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models import regressor
from ..models.regressor import FittedContext, TabICAModel
from ..models.transformer import (
    _block_ctx,
    _block_qry,
    _dt,
    _embed_ctx,
    _embed_qry,
    _head,
    _mlp_step,
    _token_mask,
    layer,
)
from .mesh import axis_size


class _Stage:
    """This rank's place in the pipeline over ``axis``: its index, its
    layers and its neighbours' global ranks."""

    def __init__(self, mesh: DeviceMesh, cfg, axis: str):
        self.n = axis_size(mesh, axis)
        if cfg.num_layers % self.n:
            raise ValueError(f"num_layers {cfg.num_layers} must divide pp axis {self.n}")
        self.s = mesh.get_local_rank(axis)
        self.group = mesh.get_group(axis)
        self.ranks = dist.get_process_group_ranks(self.group)
        per = cfg.num_layers // self.n
        self.layers = range(self.s * per, (self.s + 1) * per)
        self.first, self.last = self.s == 0, self.s == self.n - 1

    def recv(self, shape, dtype, device):
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(buf, src=self.ranks[self.s - 1], group=self.group)
        return buf

    def send(self, h):
        dist.send(h.contiguous(), dst=self.ranks[self.s + 1], group=self.group)


@torch.no_grad()
def pp_fit_encode(
    mesh: DeviceMesh,
    model: TabICAModel,
    x_ctx,  # [N, F] raw
    y_ctx,
    feat_mask: Optional[torch.Tensor] = None,
    ctx_mask: Optional[torch.Tensor] = None,
    axis: str = "pp",
) -> FittedContext:
    """Encode the context through the layer pipeline; the returned
    ``FittedContext`` holds this stage's layers' K/V, ready for
    ``pp_decode``."""
    cfg, params = model.cfg, model.params
    stage = _Stage(mesh, cfg, axis)
    n, f = x_ctx.shape
    dev = x_ctx.device
    if feat_mask is None:
        feat_mask = torch.ones((f,), dtype=torch.bool, device=dev)
    if ctx_mask is None:
        ctx_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    feat_mask, ctx_mask = feat_mask.bool(), ctx_mask.bool()
    stats = regressor.compute_stats(x_ctx, y_ctx, ctx_mask)
    token_mask = _token_mask(feat_mask)
    if stage.first:
        xn = regressor.normalize_x(stats, x_ctx) * feat_mask[None, :]
        yn = regressor.normalize_y(stats, y_ctx) * ctx_mask
        h = _embed_ctx(cfg, params["embed"], xn, yn, feat_mask)
    else:
        h = stage.recv((n, f + 1, cfg.d_model), _dt(cfg.dtype), dev)
    cache = []
    for i in stage.layers:
        p = layer(params["blocks"], i)
        h, kv = _block_ctx(cfg, p, h, token_mask, ctx_mask)
        h = _mlp_step(cfg, p, h)
        cache.append(kv)
    if not stage.last:
        stage.send(h)
    return FittedContext(cache=cache, stats=stats, feat_mask=feat_mask, ctx_mask=ctx_mask)


@torch.no_grad()
def pp_decode(
    mesh: DeviceMesh,
    model: TabICAModel,
    fitted: FittedContext,
    x_qry,  # [Q, F] raw; Q divisible by num_microbatches
    num_microbatches: int = 4,
    axis: str = "pp",
):
    """GPipe decode: query microbatches stream through the layer pipeline;
    returns the bar logits ``[Q, num_bars]`` (the head's, as JAX's, without
    the temperature) on every rank."""
    cfg, params = model.cfg, model.params
    stage = _Stage(mesh, cfg, axis)
    q, f = x_qry.shape
    m = num_microbatches
    if q % m:
        raise ValueError(f"query rows {q} must divide microbatches {m}")
    xq = regressor.normalize_x(fitted.stats, x_qry) * fitted.feat_mask[None, :]
    token_mask = _token_mask(fitted.feat_mask)
    logits = torch.zeros((m, q // m, cfg.num_bars), dtype=torch.float32, device=x_qry.device)
    for t, mb in enumerate(xq.split(q // m)):
        if stage.first:
            h = _embed_qry(cfg, params["embed"], mb, fitted.feat_mask)
        else:
            h = stage.recv((q // m, f + 1, cfg.d_model), _dt(cfg.dtype), x_qry.device)
        for j, i in enumerate(stage.layers):
            p = layer(params["blocks"], i)
            h = _block_qry(cfg, p, h, fitted.cache[j], token_mask, fitted.ctx_mask)
            h = _mlp_step(cfg, p, h)
        if stage.last:
            logits[t] = _head(cfg, params["head"], h)
        else:
            stage.send(h)
    dist.broadcast(logits, src=stage.ranks[-1], group=stage.group)
    return logits.reshape(q, cfg.num_bars)
