from . import bar_distribution, checkpoint, regressor, transformer
from .config import TabICAConfig
from .regressor import TabICAModel

__all__ = [
    "TabICAConfig",
    "TabICAModel",
    "bar_distribution",
    "checkpoint",
    "regressor",
    "transformer",
]
