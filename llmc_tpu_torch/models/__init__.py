from .adapter import (BaseAdapter, LlamaAdapter, LlavaAdapter, ModalQMap, QMap,
                      VideoLlavaAdapter, VitAdapter, build_model)
from .base import LinearQcfg
from .llama import LlamaConfig

__all__ = ['BaseAdapter', 'LlamaAdapter', 'LlavaAdapter', 'ModalQMap', 'QMap',
           'VideoLlavaAdapter', 'VitAdapter', 'LinearQcfg',
           'LlamaConfig', 'build_model']
