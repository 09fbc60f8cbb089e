"""Expert-parallel (EP) parameter placement for MoE TabICA.

Counterpart of ``npe_pfn_tpu/parallel/expert_parallel.py``. The MoE MLP
computes every expert densely (``transformer._moe_mlp``), so splitting the
expert axis of each MoE MLP over an ``"ep"`` mesh axis leaves each rank its
``E / n`` experts. Routing runs first with the whole, replicated router (top
k by ``>=``, the tie rule of ``_moe_mlp``); the rank then keeps its experts'
gate columns, combines its experts' outputs and all-reduces the combine over
the axis (JAX: the psum GSPMD inserts after ``...e,...ed->...d``). An
expert's ``b2`` is expert-local and rides the gate-weighted combine.

Split map (axis "ep"), the leading axis being the stacked layer axis:
- ``router`` ``[L, D, E]``: replicated;
- ``w1`` ``[L, E, D, hid]``, ``b1`` ``[L, E, hid]``, ``w2`` ``[L, E, hid, D]``,
  ``b2`` ``[L, E, D]``: experts;
- everything else replicated, or tensor-parallel over ``tp_axis``
  (``tensor_parallel.param_pspecs``) for a tp×ep model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

from ..models.regressor import TabICAModel
from .mesh import axis_size
from .tensor_parallel import Spec, place, rename
from .tensor_parallel import param_pspecs as _tp_pspecs

# Keys of a MoE MLP dict (transformer.init_params, num_experts > 0).
_MOE_SPECS = {
    "router": Spec(),
    "w1": Spec(None, "ep", None, None),
    "b1": Spec(None, "ep", None),
    "w2": Spec(None, "ep", None, None),
    "b2": Spec(None, "ep", None),
}


def ep_pspecs(params, axis: str = "ep", tp_axis: Optional[str] = None):
    """The tree of ``Spec``s: MoE MLP dicts split experts over ``axis``;
    everything else is replicated, or tensor-parallel over ``tp_axis`` when
    given (``tensor_parallel.param_pspecs`` merged in)."""
    base = _tp_pspecs(params, tp_axis) if tp_axis else None

    def walk(node, base_node):
        if isinstance(node, dict):
            if set(node.keys()) == set(_MOE_SPECS):
                return {k: rename(s, "ep", axis) for k, s in _MOE_SPECS.items()}
            return {
                k: walk(v, base_node[k] if base_node is not None else None)
                for k, v in node.items()
            }
        return base_node if base_node is not None else Spec()

    return walk(params, base)


def ep_place(
    mesh: DeviceMesh,
    model: TabICAModel,
    axis: str = "ep",
    tp_axis: Optional[str] = None,
) -> TabICAModel:
    """The model with this rank's experts over ``axis`` (and, with
    ``tp_axis``, its attention heads over that axis): a drop-in for
    ``fit_encode`` / ``predict_logits`` and the autoregressive sampler, as
    ``tp_place``'s model is."""
    if model.cfg.num_experts == 0:
        raise ValueError("ep_place requires a MoE model (cfg.num_experts > 0)")
    n_ep = axis_size(mesh, axis)
    if model.cfg.num_experts % n_ep != 0:
        raise ValueError(
            f"ep axis size {n_ep} must divide num_experts={model.cfg.num_experts}"
        )
    if tp_axis is not None:
        n_tp = axis_size(mesh, tp_axis)
        if model.cfg.num_heads % n_tp != 0:
            raise ValueError(
                f"tp axis size {n_tp} must divide num_heads={model.cfg.num_heads}"
            )
    return dataclasses.replace(model, params=place(mesh, model.params,
                                                   ep_pspecs(model.params, axis, tp_axis)))
