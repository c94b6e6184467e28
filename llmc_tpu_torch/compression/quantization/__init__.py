from . import (adadim, awq, dgq, gptq, hqq, llmint8, ntweak,  # noqa: F401
               omniq, osplus, quarot, quik, rtn, smoothquant, spqr,
               tesseraq)
# (the imports register the ALGO_REGISTRY entries)
from .auto_clip import AutoClipper

__all__ = ['AutoClipper']
