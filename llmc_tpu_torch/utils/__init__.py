from .config import (Cfg, check_config, get_modality, iter_compress_sections,
                     load_config, seed_all)
from .device import resolve_device
from .offload import (HostBlocks, offload_model_blocks, streaming_ppl,
                      tree_to_device, tree_to_host)
from .registry import (ALGO_REGISTRY, KV_REGISTRY, MODEL_REGISTRY,
                       PREPROC_REGISTRY, Registry)

__all__ = ['HostBlocks', 'offload_model_blocks', 'streaming_ppl',
           'tree_to_device', 'tree_to_host', 'resolve_device', 'Registry',
           'MODEL_REGISTRY', 'KV_REGISTRY', 'ALGO_REGISTRY', 'PREPROC_REGISTRY', 'Cfg', 'check_config',
           'get_modality', 'iter_compress_sections', 'load_config',
           'seed_all']
