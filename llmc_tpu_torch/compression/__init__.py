from . import transforms
from .blockwise import BaseBlockwiseQuantization, BlockwiseOpt
from .quantization import *  # noqa: F401,F403  (registers the algorithms)
from . import sparsification  # noqa: F401  (registers the sparsifiers)

__all__ = ['BaseBlockwiseQuantization', 'BlockwiseOpt', 'transforms']
