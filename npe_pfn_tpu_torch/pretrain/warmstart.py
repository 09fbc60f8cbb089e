"""Warm-starting a finer-bar-head model from a coarser checkpoint.

Counterpart of ``npe_pfn_tpu/pretrain/warmstart.py``. The trunk is copied
verbatim and only the head's last projection is upsampled: with
``B_new = r * B_old`` every coarse border is every r-th fine border, and

    w2_new[:, r*K + j] = w2_old[:, K]
    b2_new[r*K + j]    = b2_old[K] + log(width_new[r*K + j] / width_old[K])

spreads each coarse bucket's mass over its fine buckets in proportion to
their widths, so the interior density is unchanged.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..models import bar_distribution as bar
from ..models.checkpoint import load as load_checkpoint
from ..models.config import TabICAConfig
from ..models.regressor import TabICAModel


def upsample_head(params: dict, num_bars_old: int, num_bars_new: int, bar_range: float) -> dict:
    """``params`` with ``head/w2`` and ``head/b2`` upsampled from
    ``num_bars_old`` to ``num_bars_new`` buckets (the interior density is
    preserved exactly)."""
    if num_bars_new == num_bars_old:
        return params
    if num_bars_new % num_bars_old != 0:
        raise ValueError(
            f"num_bars_new ({num_bars_new}) must be a multiple of "
            f"num_bars_old ({num_bars_old}) for exact head upsampling"
        )
    r = num_bars_new // num_bars_old
    head = params["head"]
    dev = head["w2"].device
    borders_old = bar.make_borders(num_bars_old, bar_range, device=dev)
    borders_new = bar.make_borders(num_bars_new, bar_range, device=dev)
    w_old = borders_old[1:] - borders_old[:-1]
    w_new = borders_new[1:] - borders_new[:-1]
    w2 = torch.repeat_interleave(head["w2"], r, dim=-1)
    b2 = torch.repeat_interleave(head["b2"], r, dim=-1) + (
        torch.log(w_new) - torch.repeat_interleave(torch.log(w_old), r)
    )
    params = dict(params)
    params["head"] = {**head, "w2": w2, "b2": b2.to(head["b2"].dtype)}
    return params


def load_warmstart(path: str, cfg: TabICAConfig, device=None) -> TabICAModel:
    """Load a checkpoint and adapt it to ``cfg`` (head upsampling only; the
    trunk shape must match). ``device`` defaults to CUDA."""
    device = resolve_device(device)
    src = load_checkpoint(path, device)
    if (
        src.cfg.d_model != cfg.d_model
        or src.cfg.num_layers != cfg.num_layers
        or src.cfg.num_heads != cfg.num_heads
        or src.cfg.max_features != cfg.max_features
    ):
        raise ValueError(f"warmstart trunk mismatch: checkpoint {src.cfg} vs target {cfg}")
    if src.cfg.bar_range != cfg.bar_range:
        raise ValueError("warmstart requires identical bar_range")
    params = upsample_head(src.params, src.cfg.num_bars, cfg.num_bars, cfg.bar_range)
    return TabICAModel(cfg=cfg, params=params,
                       borders=bar.make_borders(cfg.num_bars, cfg.bar_range, device=device))
