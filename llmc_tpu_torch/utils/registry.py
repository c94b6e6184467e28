"""Decorator registries mapping config strings to classes/functions.

A copy of ``llmc_tpu/utils/registry.py`` (the port imports nothing from
the JAX package).  The port registers what it ports: ``Llama``, the
Llama-family ``Mistral``, ``SmolLM``, ``Qwen2``, ``Qwen3`` and ``Phi3``,
the generalized-graph ``Gemma2``, ``StableLm``, ``Falcon``, ``Phi``,
``Starcoder``, ``Bloom``, ``InternLM2``, ``Glm`` / ``ChatGLM``, ``MiniCPM``
and ``Qwen``, the MoE ``Mixtral``, ``Qwen2Moe``, ``DeepseekV2`` and
``DeepseekV3``, ``Opt``, and the VLMs ``Llava``, ``LlavaHf``, ``VideoLlava`` /
``VideoLLaVA``, ``Qwen2vl``, ``InternVL2``, ``LlavaOneVision``, ``MiniCPMV``
and ``Vit`` in MODEL_REGISTRY (the other multimodal names raise
``NotImplementedError`` naming their ROADMAP item); ``Naive``, ``Kivi``, ``SinkKV`` and
``ShadowKV`` in KV_REGISTRY; the quantization methods and the
sparsifiers (``Dense``, ``Magnitude``, ``Wanda``, ``ShortGPT``) in
ALGO_REGISTRY, with ``TokenReduction`` and its 13 methods in
TOKEN_REDUCTION_REGISTRY.
"""

from __future__ import annotations


class Registry(dict):
    """``unported``: names the reference registers and the port does not
    run yet, each with the ROADMAP item that holds it."""

    def __init__(self, name: str, unported=None):
        super().__init__()
        self._name = name
        self.unported = dict(unported or {})

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
        if key in self.unported:
            raise NotImplementedError(
                f'{key!r} is not ported yet ({self.unported[key]})')
        raise KeyError(
            f'{key!r} is not registered in {self._name}; '
            f'available: {sorted(self.keys())}')


# the VLM, audio and video models of the reference's registry still to port
_VLM_TIER = 'ROADMAP A13e: the VLM / audio / video tier'
MODEL_REGISTRY = Registry('MODEL_REGISTRY', unported=dict.fromkeys(
    ('Vila', 'Mllama', 'Glm4v', 'GLM4V', 'Qwen2Audio', 'InternOmni', 'WanT2V',
     'WanI2V'),
    _VLM_TIER))
ALGO_REGISTRY = Registry('ALGO_REGISTRY')
KV_REGISTRY = Registry('KV_REGISTRY')
TOKEN_REDUCTION_REGISTRY = Registry('TOKEN_REDUCTION_REGISTRY')
PREPROC_REGISTRY = Registry('PREPROC_REGISTRY')
EVAL_REGISTRY = Registry('EVAL_REGISTRY')
