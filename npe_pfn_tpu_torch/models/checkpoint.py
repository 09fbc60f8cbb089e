"""Carry a TabICA checkpoint's weights into the port.

Counterpart of ``npe_pfn_tpu/models/checkpoint.py`` (load side). A checkpoint
is a ``.npz`` of flat parameter names (``blocks/row_attn/wq``, stacked
``[L, d, H, hd]``, ...; ``__temperature__`` reserved for the calibration
temperature) beside a ``.json`` of the config. Both are read with numpy.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .._device import resolve_device
from . import bar_distribution as bar
from .config import TabICAConfig
from .regressor import TabICAModel

TEMPERATURE_KEY = "__temperature__"


def params_from_numpy(flat: dict, device="cuda", dtype=torch.float32) -> dict:
    """Nest flat ``{"a/b/c": array}`` parameters into ``{"a": {"b": {"c": tensor}}}``.

    ``dtype`` is the storage dtype (the compute dtype is the config's); the
    reserved ``__temperature__`` key is skipped.
    """
    device = resolve_device(device)
    params: dict = {}
    for name, arr in flat.items():
        if name == TEMPERATURE_KEY:
            continue
        node = params
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(np.asarray(arr), dtype=dtype, device=device)
    return params


def load(path: str, device="cuda", **cfg_overrides) -> TabICAModel:
    """Load ``path`` (.npz) and ``path + ".json"`` into a ``TabICAModel``.

    Parameters are stored in float32, as the JAX package stores them;
    ``cfg_overrides`` replace config fields (e.g. ``dtype="float32"``).
    """
    device = resolve_device(device)
    with open(path + ".json") as f:
        cfg = TabICAConfig(**{**json.load(f), **cfg_overrides})
    with np.load(path) as data:
        flat = {name: data[name] for name in data.files}
    temperature = float(flat.get(TEMPERATURE_KEY, 1.0))
    return TabICAModel(
        cfg=cfg,
        params=params_from_numpy(flat, device, torch.float32),
        borders=bar.make_borders(cfg.num_bars, cfg.bar_range, device=device),
        temperature=temperature,
    )


def default_checkpoint_path() -> str:
    """``NPE_PFN_TPU_CHECKPOINT``, then the file named by
    ``checkpoints/DEFAULT``, then ``checkpoints/tabica_v1.npz``."""
    env = os.environ.get("NPE_PFN_TPU_CHECKPOINT")
    if env:
        return env
    ckpt_dir = os.path.join(os.path.dirname(__file__), "..", "..", "checkpoints")
    pointer = os.path.join(ckpt_dir, "DEFAULT")
    if os.path.exists(pointer):
        with open(pointer) as f:
            name = f.read().strip()
        if name:
            cand = os.path.join(ckpt_dir, name)
            if os.path.exists(cand):
                return cand
    return os.path.join(ckpt_dir, "tabica_v1.npz")


def load_default(device="cuda", **cfg_overrides) -> TabICAModel:
    """Load the shipped checkpoint. Raises ``FileNotFoundError`` if it is
    missing (the JAX package falls back to random weights instead)."""
    path = default_checkpoint_path()
    if not (os.path.exists(path) and os.path.exists(path + ".json")):
        raise FileNotFoundError(f"no TabICA checkpoint at {path} (+ .json)")
    return load(path, device, **cfg_overrides)
