from .adapter import BaseAdapter, LlamaAdapter, QMap, build_model
from .base import LinearQcfg
from .llama import LlamaConfig

__all__ = ['BaseAdapter', 'LlamaAdapter', 'QMap', 'LinearQcfg',
           'LlamaConfig', 'build_model']
