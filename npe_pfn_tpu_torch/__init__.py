"""npe_pfn_tpu_torch — the PyTorch/CUDA port of ``npe_pfn_tpu``.

Training-free simulation-based inference: simulated (θ, x) pairs are the
in-context table of a pretrained two-axis tabular transformer (TabICA), and
the posterior is sampled one θ-dimension at a time. The package mirrors the
JAX package's layout; it imports torch and numpy only. Its entry points run
on CUDA unless the caller passes ``device="cpu"``. The row-axis attention is a
hand-written CUDA kernel (``ops/csrc/flash_row_attention.cu``), built with
nvcc at first use.
"""

__version__ = "0.1.0"

from . import distributions, embeddings, filters, models, tasks  # noqa: F401
from .baselines import FlowNPE  # noqa: F401
from .estimator import NPEPFN, DensityRatioEstimator  # noqa: F401
from .models.checkpoint import load_default  # noqa: F401
from .rejection import accept_reject_sample  # noqa: F401
from .restricted_prior import RestrictedPrior  # noqa: F401
from .serving import CachedPosterior  # noqa: F401
from .support import PosteriorSupport, prereject_with_bounds  # noqa: F401
from .tasks import get_task  # noqa: F401
from .tsnpe import run_tsnpe, simulate_for_sbi  # noqa: F401
from .unconditional import UnconditionalEstimator  # noqa: F401

__all__ = ["NPEPFN", "CachedPosterior", "DensityRatioEstimator", "FlowNPE", "PosteriorSupport",
           "RestrictedPrior", "UnconditionalEstimator", "accept_reject_sample", "distributions",
           "embeddings", "filters", "get_task", "load_default", "models", "prereject_with_bounds",
           "run_tsnpe", "simulate_for_sbi", "tasks", "__version__"]
