"""Decorator registries mapping config strings to classes/functions.

A copy of ``llmc_tpu/utils/registry.py`` (the port imports nothing from
the JAX package).  The port registers what it ports: ``Llama``, the
Llama-family ``Mistral``, ``SmolLM``, ``Qwen2``, ``Qwen3`` and ``Phi3``,
the generalized-graph ``Gemma2``, ``StableLm``, ``Falcon``, ``Phi``,
``Starcoder``, ``Bloom``, ``InternLM2``, ``Glm`` / ``ChatGLM``, ``MiniCPM``
and ``Qwen``, the MoE ``Mixtral``, ``Qwen2Moe``, ``DeepseekV2`` and
``DeepseekV3``, and ``Opt`` in MODEL_REGISTRY; ``Naive``, ``Kivi``, ``SinkKV`` and
``ShadowKV`` in KV_REGISTRY; the quantization methods and the
sparsifiers (``Dense``, ``Magnitude``, ``Wanda``, ``ShortGPT``) in
ALGO_REGISTRY.
"""

from __future__ import annotations


class Registry(dict):
    def __init__(self, name: str):
        super().__init__()
        self._name = name

    def register(self, target=None, *, name: str = None):
        def deco(obj):
            key = name or obj.__name__
            if key in self:
                raise KeyError(f'{key!r} already registered in {self._name}')
            self[key] = obj
            return obj

        if target is None:
            return deco
        return deco(target)

    # reference-compatible alias
    register_module = register

    def __missing__(self, key):
        raise KeyError(
            f'{key!r} is not registered in {self._name}; '
            f'available: {sorted(self.keys())}')


MODEL_REGISTRY = Registry('MODEL_REGISTRY')
ALGO_REGISTRY = Registry('ALGO_REGISTRY')
KV_REGISTRY = Registry('KV_REGISTRY')
TOKEN_REDUCTION_REGISTRY = Registry('TOKEN_REDUCTION_REGISTRY')
PREPROC_REGISTRY = Registry('PREPROC_REGISTRY')
EVAL_REGISTRY = Registry('EVAL_REGISTRY')
