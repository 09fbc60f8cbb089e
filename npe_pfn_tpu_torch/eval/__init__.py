from . import metrics  # noqa: F401
