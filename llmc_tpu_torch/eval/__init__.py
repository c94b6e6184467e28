from .orchestrate import EvalOrchestrator
from .ppl import DecodePerplexityEval, PerplexityEval, TokenConsistencyEval

__all__ = ['EvalOrchestrator', 'PerplexityEval', 'DecodePerplexityEval',
           'TokenConsistencyEval']
