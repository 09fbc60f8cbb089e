"""Tensor-parallel (Megatron-style) parameter placement for TabICA.

Counterpart of ``npe_pfn_tpu/parallel/tensor_parallel.py``. JAX gets tensor
parallelism from placement alone: GSPMD shards the einsums and inserts the
psum after ``wo`` and ``w2``. Here ``tp_place`` gives each rank its slice of
the parameters and wraps every split dict in ``transformer.SplitParams``,
whose ``reduce`` all-reduces the partial product over the axis's group
before the residual bias is added, once. The placed model is a drop-in for
``regressor.fit_encode`` / ``predict_logits`` and
``estimator.autoregressive_sample`` (seed the generator alike on every
rank: the logits are equal on every rank, so the draws are too). It serves
inference: the reduce carries no gradient.

Split map (axis "tp"), the leading axis being the stacked layer axis:
- attention ``wq/wk/wv`` ``[L, D, H, hd]`` and ``wo`` ``[L, H, hd, D]``: heads
  (each rank attends with its H/n heads; the row kernel sees H/n);
- MLP ``w1`` ``[L, D, hid]`` / ``b1`` ``[L, hid]`` and ``w2`` ``[L, hid, D]``:
  the hidden units;
- everything else (embeddings, layer norms, the head, the biases ``bo`` and
  ``b2`` into the residual stream) replicated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.regressor import TabICAModel
from ..models.transformer import SplitParams
from .mesh import axis_size, axis_slice, gather, has_axis


class Spec(tuple):
    """Which mesh axis each dim of a parameter is split over (None: not
    split); ``Spec()`` is replicated. The port's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


# Keys of attention-parameter dicts (transformer.init_params attn_params()).
_ATTN_SPECS = {
    "wq": Spec(None, None, "tp", None),
    "wk": Spec(None, None, "tp", None),
    "wv": Spec(None, None, "tp", None),
    "wo": Spec(None, "tp", None, None),
    "bo": Spec(),
}
_MLP_SPECS = {
    "w1": Spec(None, None, "tp"),
    "b1": Spec(None, "tp"),
    "w2": Spec(None, "tp", None),
    "b2": Spec(),
}


def rename(spec: Spec, old: str, new: str) -> Spec:
    return Spec(*[new if s == old else s for s in spec])


def param_pspecs(params, axis: str = "tp"):
    """The tree of ``Spec``s matching a TabICA params tree: attention dicts
    (feature, row, pool, unpool) split over heads, dense MLPs over the hidden
    axis, everything else replicated."""

    def walk(node):
        if isinstance(node, dict):
            keys = set(node.keys())
            if keys == set(_ATTN_SPECS):
                return {k: rename(s, "tp", axis) for k, s in _ATTN_SPECS.items()}
            if keys == set(_MLP_SPECS):
                return {k: rename(s, "tp", axis) for k, s in _MLP_SPECS.items()}
            return {k: walk(v) for k, v in node.items()}
        return Spec()

    return walk(params)


def _all_reduce(x, group):
    dist.all_reduce(x, group=group)
    return x


def place(mesh: DeviceMesh, params, specs):
    """This rank's slice of every parameter by ``specs``; each dict with a
    split leaf becomes a ``SplitParams`` that reduces over that axis (its
    ``expert0`` the rank's first expert for a MoE MLP)."""
    if not isinstance(params, dict):
        for dim, axis in enumerate(specs):
            if axis is not None:
                params = params[(slice(None),) * dim + (axis_slice(
                    mesh, axis, params.shape[dim], f"dim {dim} of a parameter"),)]
        return params.contiguous()
    out = {k: place(mesh, v, specs[k]) for k, v in params.items()}
    axes = {a for s in specs.values() if isinstance(s, Spec) for a in s if a is not None}
    if not axes:
        return out
    (axis,) = axes
    expert0 = axis_slice(mesh, axis, params["w1"].shape[1], "experts").start if (
        "router" in params) else 0
    return SplitParams(out, functools.partial(_all_reduce, group=mesh.get_group(axis)), expert0)


def tp_place(mesh: DeviceMesh, model: TabICAModel, axis: str = "tp") -> TabICAModel:
    """The model with this rank's share of the parameters, tensor-parallel
    over ``axis``. Head count and MLP hidden width must divide the axis
    size."""
    if model.cfg.num_experts:
        raise ValueError(
            "tp_place on a MoE model would leave the expert MLPs (the bulk "
            "of the params) replicated; use expert_parallel.ep_place(mesh, "
            "model, tp_axis=...) to shard experts and attention together"
        )
    n_tp = axis_size(mesh, axis)
    if model.cfg.num_heads % n_tp != 0:
        raise ValueError(
            f"tp axis size {n_tp} must divide num_heads={model.cfg.num_heads}"
        )
    if (model.cfg.d_model * model.cfg.mlp_ratio) % n_tp != 0:
        raise ValueError("the tp axis size must divide the MLP hidden width")
    return dataclasses.replace(model, params=place(mesh, model.params,
                                                   param_pspecs(model.params, axis)))


@torch.no_grad()
def tp_forward_logits(
    mesh: DeviceMesh,
    model: TabICAModel,
    x_ctx,
    y_ctx,
    x_qry,
    axis: str = "tp",
    data_axis: Optional[str] = None,
):
    """Place the model tensor-parallel and run ``fit_encode`` +
    ``predict_logits``; every rank returns all the logits. Query rows ride
    ``data_axis`` when the mesh has one (tp×dp), gathered in rank order.
    Serving should call ``tp_place`` once and reuse the placed model."""
    from ..models import regressor

    placed = tp_place(mesh, model, axis)
    fitted = regressor.fit_encode(placed, x_ctx, y_ctx)
    if not has_axis(mesh, data_axis):
        return regressor.predict_logits(placed, fitted, x_qry)
    rows = axis_slice(mesh, data_axis, x_qry.shape[0], "query rows")
    return gather(regressor.predict_logits(placed, fitted, x_qry[rows]), mesh, data_axis)
