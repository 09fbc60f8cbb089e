"""Nested dicts of tensors: flat names, and ``.npz`` files written atomically.

Counterpart of ``npe_pfn_tpu/utils/pytree_io.py``. A leaf's name is its keys
joined by "/" (``blocks/row_attn/wq``), the names of the JAX package's
checkpoints. ``save_pytree``, ``load_pytree`` and ``restore_like`` keep the
pretraining loop's train state (optimizer moments, step count) and its meta
files; every write goes to a temporary file that is then renamed over the
target, so a killed run never corrupts a saved file.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def flatten(tree: dict) -> dict:
    """``{"a/b/c": leaf}`` of a nested dict, in the dict's order."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}/{name}": leaf for name, leaf in flatten(val).items()})
        else:
            out[key] = val
    return out


def unflatten(flat: dict) -> dict:
    """The nested dict of ``{"a/b/c": leaf}`` names (``flatten``'s inverse)."""
    tree: dict = {}
    for name, leaf in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def atomic_write(path: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, then rename it
    over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_pytree(path: str, tree: dict) -> None:
    arrays = {name: (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                     else np.asarray(leaf)) for name, leaf in flatten(tree).items()}
    atomic_write(path, lambda f: np.savez(f, **arrays))


def load_pytree(path: str) -> dict:
    """The nested dict of CPU tensors saved at ``path``."""
    with np.load(path) as data:
        return unflatten({name: torch.as_tensor(data[name]) for name in data.files})


def restore_like(template: dict, path: str) -> dict:
    """``template``'s structure with every tensor read from ``path`` by name,
    in the template leaf's dtype and on its device (shapes must match)."""
    out = {}
    with np.load(path) as data:
        for name, leaf in flatten(template).items():
            arr = data[name]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: saved shape {arr.shape} != {tuple(leaf.shape)}")
            out[name] = torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    return unflatten(out)
