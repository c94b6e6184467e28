from .decode import forward_cached, greedy_generate, init_cache
from .engine import EagerServingEngine, Request, ServingEngine
from .kvcache import KVCachePolicy
from .packed import pack_model, random_packed_llama
from .paged_cache import PagedKVPolicy

__all__ = ['forward_cached', 'greedy_generate', 'init_cache', 'Request',
           'ServingEngine', 'EagerServingEngine', 'KVCachePolicy',
           'pack_model', 'random_packed_llama', 'PagedKVPolicy']
