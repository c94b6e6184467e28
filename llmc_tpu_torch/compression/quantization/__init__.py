from . import awq, rtn  # noqa: F401  (register ALGO_REGISTRY entries)
from .auto_clip import AutoClipper

__all__ = ['AutoClipper']
