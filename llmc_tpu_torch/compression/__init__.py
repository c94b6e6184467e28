from . import transforms
from .blockwise import BaseBlockwiseQuantization, BlockwiseOpt
from .quantization import *  # noqa: F401,F403  (registers the algorithms)

__all__ = ['BaseBlockwiseQuantization', 'BlockwiseOpt', 'transforms']
