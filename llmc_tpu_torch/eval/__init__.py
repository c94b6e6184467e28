from .orchestrate import EvalOrchestrator
from .ppl import PerplexityEval

__all__ = ['EvalOrchestrator', 'PerplexityEval']
