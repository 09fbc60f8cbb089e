"""Analytic speed-of-light estimate for autoregressive posterior sampling.

Counterpart of ``npe_pfn_tpu/utils/roofline.py``, with the same FLOP and
byte counts: one ``NPEPFN.sample`` call is dθ autoregressive steps, each an
encode of the filtered context and a decode of every query row against it;
the matmul FLOPs over the peak FLOP rate and the unavoidable HBM traffic over
the memory rate give a lower bound on its wall time.

A model, not a measurement: it assumes full tensor-core use, perfect
overlap and a flash attention that never materializes the [.., N, N]
scores. The default peaks are one NVIDIA H100 SXM's (data sheet, dense, at
700 W): 989 TFLOP/s bf16 and 3.35 TB/s HBM.
"""

from __future__ import annotations

from typing import Dict

H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def _layer_flops(n_rows: int, n_kv: int, t_tokens: int, d: int, mlp_ratio: int) -> float:
    """Matmul FLOPs of one transformer block over [n_rows, t_tokens, d]
    tokens whose row-axis attention attends to ``n_kv`` key rows (2·m·n·k per
    matmul): the feature and the row attention's q, k, v and out
    projections, their scores and P·V, and the two MLP matmuls."""
    ntok = n_rows * t_tokens
    proj = 2 * ntok * d * d * 4
    feat_attn = 2 * n_rows * t_tokens * t_tokens * d * 2
    row_attn = 2 * t_tokens * n_rows * n_kv * d * 2
    mlp = 2 * ntok * d * (mlp_ratio * d) * 2
    return 2 * proj + feat_attn + row_attn + mlp


def _layer_bytes(n_rows: int, t_tokens: int, d: int, mlp_ratio: int, param_count: int,
                 act_bytes: int = 2) -> float:
    """HBM floor of one block: the token activations read and written once,
    and one pass over the block's parameters."""
    ntok = n_rows * t_tokens
    return 2 * ntok * d * act_bytes + param_count * act_bytes


def ar_sampling_roofline(
    cfg,
    num_ctx: int,
    num_qry: int,
    dim_theta: int,
    dim_x: int,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
    hbm_bw: float = H100_HBM_BYTES_PER_S,
    feature_width: int = None,
) -> Dict[str, float]:
    """Speed-of-light estimate for ``NPEPFN.sample(num_qry)``: per step an
    encode of ``num_ctx`` rows and a decode of ``num_qry`` rows, both against
    ``num_ctx`` keys, at ``feature_width`` + 1 tokens (default: the padded
    ``max_features``; pass the width the AR loop computes at)."""
    d = cfg.d_model
    if feature_width is None:
        feature_width = cfg.max_features
    t_tokens = feature_width + 1
    n_layers = cfg.num_layers
    params_per_block = (8 + 2 * cfg.mlp_ratio) * d * d
    head_params = d * cfg.num_bars

    flops = 0.0
    bytes_ = 0.0
    for _ in range(dim_theta):
        enc_f = n_layers * _layer_flops(num_ctx, num_ctx, t_tokens, d, cfg.mlp_ratio)
        dec_f = n_layers * _layer_flops(num_qry, num_ctx, t_tokens, d, cfg.mlp_ratio)
        flops += enc_f + dec_f + 2 * num_qry * d * cfg.num_bars
        enc_b = n_layers * _layer_bytes(num_ctx, t_tokens, d, cfg.mlp_ratio, params_per_block)
        dec_b = n_layers * _layer_bytes(num_qry, t_tokens, d, cfg.mlp_ratio, params_per_block)
        bytes_ += enc_b + dec_b + head_params * 2

    t_compute = flops / peak_flops
    t_memory = bytes_ / hbm_bw
    min_time = max(t_compute, t_memory)
    peaks = ("NVIDIA H100 SXM data sheet, dense, 700 W"
             if (peak_flops, hbm_bw) == (H100_PEAK_BF16_FLOPS, H100_HBM_BYTES_PER_S)
             else "the caller's peaks")
    return {
        "flops": flops,
        "hbm_bytes": bytes_,
        "t_compute_s": round(t_compute, 6),
        "t_memory_s": round(t_memory, 6),
        "min_time_s": round(min_time, 6),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "samples_per_s_ceiling": round(num_qry / min_time, 1),
        "assumptions": "flash attention (no score materialization), padded "
                       f"feature width {t_tokens - 1}, peak {peak_flops / 1e12:.0f} "
                       f"TFLOP/s bf16, {hbm_bw / 1e9:.0f} GB/s HBM ({peaks})",
    }
