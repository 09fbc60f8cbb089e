"""Model configuration of the TabICA in-context tabular transformer.

Counterpart of ``npe_pfn_tpu/models/config.py``: the same fields and the
same JSON (a checkpoint's ``.json`` loads into either package). The port
keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TabICAConfig:
    """Hyperparameters of the two-axis in-context tabular transformer."""

    # Width of every cell token.
    d_model: int = 128
    # Attention heads (shared count for feature-axis and row-axis attention).
    num_heads: int = 4
    # Transformer blocks; each block = feature-attn + row-attn + MLP.
    num_layers: int = 6
    # MLP hidden expansion factor.
    mlp_ratio: int = 4
    # Maximum number of input feature columns the model was trained for.
    max_features: int = 32
    # Number of buckets of the bar-distribution regression head.
    num_bars: int = 256
    # Range (normalized target units) covered by the finite bar borders.
    bar_range: float = 6.0
    # Unused at inference; kept so checkpoint JSON round-trips.
    dropout: float = 0.0
    # Compute dtype of the matmuls ("bfloat16" or "float32").
    dtype: str = "bfloat16"
    # Storage dtype of the dense row-attention score tensor.
    scores_dtype: str = "float32"
    # Row-attention bottleneck: each row's cell tokens pool into this many
    # learned slots, row attention runs per slot (0 = off, per cell token).
    row_pool_slots: int = 0
    # Experts of the mixture-of-experts MLP (0 = a dense MLP).
    num_experts: int = 0
    # Experts each token is routed to (top-k gating).
    moe_top_k: int = 2
    # Row attention: "auto" takes the CUDA kernel for CUDA tensors and the
    # dense path on the CPU; "on" forces the kernel's function, "off" the
    # dense path.
    flash: str = "auto"
    # JAX-only (Pallas interpret mode); kept so checkpoint JSON round-trips.
    flash_interpret: bool = False

    def __post_init__(self):
        if self.num_experts and not (1 <= self.moe_top_k <= self.num_experts):
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, num_experts="
                f"{self.num_experts}]"
            )
        if self.flash not in ("auto", "on", "off"):
            raise ValueError(f"flash must be 'auto', 'on' or 'off', got {self.flash!r}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads
