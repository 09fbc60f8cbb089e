"""TabICA checkpoints: the JAX package's format, read and written.

Counterpart of ``npe_pfn_tpu/models/checkpoint.py``. A checkpoint is a
``.npz`` of flat parameter names (``blocks/row_attn/wq``, stacked
``[L, d, H, hd]``, ...; ``__temperature__`` reserved for the calibration
temperature) beside a ``.json`` of the config. Both are read and written with
numpy, so a checkpoint either package writes loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from ..utils.pytree_io import atomic_write, flatten, unflatten
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
    return unflatten({name: torch.tensor(np.asarray(arr), dtype=dtype, device=device)
                      for name, arr in flat.items() if name != TEMPERATURE_KEY})


def params_to_numpy(params: dict) -> dict:
    """Flatten nested parameters into ``{"a/b/c": np.ndarray}`` (f32 stays f32)."""
    return {name: t.detach().cpu().numpy() for name, t in flatten(params).items()}


def save(path: str, model: TabICAModel) -> None:
    """Write ``path`` (.npz, compressed) and ``path + ".json"``, as the JAX
    package's ``checkpoint.save`` does; each file is replaced atomically."""
    arrays = params_to_numpy(model.params)
    arrays[TEMPERATURE_KEY] = np.asarray(model.temperature, dtype=np.float32)
    atomic_write(path, lambda f: np.savez_compressed(f, **arrays))
    cfg_json = json.dumps(dataclasses.asdict(model.cfg), indent=2).encode()
    atomic_write(path + ".json", lambda f: f.write(cfg_json))


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
