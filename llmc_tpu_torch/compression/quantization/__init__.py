from . import (awq, gptq, llmint8, osplus, quarot, rtn,  # noqa: F401
               smoothquant)  # (register ALGO_REGISTRY entries)
from .auto_clip import AutoClipper

__all__ = ['AutoClipper']
