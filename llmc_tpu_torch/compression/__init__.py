from . import transforms
from .blockwise import BaseBlockwiseQuantization, BlockwiseOpt
from .quantization import *  # noqa: F401,F403  (registers the algorithms)
from . import sparsification  # noqa: F401  (registers the sparsifiers)
from . import token_reduction  # noqa: F401  (registers TokenReduction)

__all__ = ['BaseBlockwiseQuantization', 'BlockwiseOpt', 'transforms']
