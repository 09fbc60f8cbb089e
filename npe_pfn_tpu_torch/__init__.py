"""npe_pfn_tpu_torch — the PyTorch/CUDA port of ``npe_pfn_tpu``.

Training-free simulation-based inference: simulated (θ, x) pairs are the
in-context table of a pretrained two-axis tabular transformer (TabICA), and
the posterior is sampled one θ-dimension at a time. The package mirrors the
JAX package's layout; it imports torch and numpy only. Its entry points run
on CUDA unless the caller passes ``device="cpu"``. The row-axis attention is a
hand-written CUDA kernel (``ops/csrc/flash_row_attention.cu``), built with
nvcc at first use.
"""

from . import distributions, filters, models, tasks  # noqa: F401
from .estimator import NPEPFN  # noqa: F401
from .models.checkpoint import load_default  # noqa: F401
from .tasks import get_task  # noqa: F401

__all__ = ["NPEPFN", "distributions", "filters", "get_task", "load_default", "models", "tasks"]
