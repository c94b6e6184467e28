"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, run through the JAX package on
the CPU and through ``llmc_tpu_torch`` with ``device='cpu'``, and compared
as numpy arrays.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

# the tiny GQA Llama of the JAX package's own tests
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, dtype='float32')
# the tiny Mixtral and DeepSeek-V2 of the JAX package's MoE engine tests
# (tests/test_engine_moe.py)
MX_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16,
               num_local_experts=4, num_experts_per_tok=2, dtype='float32')
DS_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=48, num_hidden_layers=3,
               num_attention_heads=4, q_lora_rank=32, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               n_routed_experts=4, n_shared_experts=1,
               num_experts_per_tok=2, first_k_dense_replace=1,
               dtype='float32')
WSPEC = dict(bit=4, symmetric=True, granularity='per_group', group_size=32)
METHODS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'quantization', 'methods')


def method_quant(name):
    """The ``quant`` section of a shipped method config, group size 128
    cut to 32 (TINY is 64 wide), and QUIK's ``fp_features`` 128 cut to 8
    (``min(128, in_features - 1)`` would keep all but one of TINY's
    columns fp), as the JAX package's own QUIK test cuts it."""
    with open(os.path.join(METHODS, f'{name}.yml')) as f:
        quant = yaml.safe_load(f)['quant']

    def cut(d):
        return {k: (32 if k == 'group_size' and v == 128 else
                    8 if k == 'fp_features' and v == 128 else
                    cut(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    return cut(quant)


def to_np(tree):
    """A JAX param tree as numpy arrays (None leaves stay None)."""
    return jax.tree.map(np.asarray, tree)


def port_params(jax_params):
    from llmc_tpu_torch.convert import params_from_numpy
    return params_from_numpy(to_np(jax_params), device='cpu')


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip with a reason (decided inside the test,
    never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels run only '
                    'there (python3 chip_smoke.py, or pytest -m gpu on '
                    'the card)')
    return torch.device('cuda')


def reference_trains_on_block_inputs(monkeypatch, cls):
    """The JAX package's gradient-trained method ``cls`` trained on each
    block's own calibration inputs: its ``block_opt`` replaces
    ``self.inputs`` by the block's outputs before ``block_transform``
    trains on them (ROADMAP C)."""
    inner_opt, inner_transform = cls.block_opt, cls.block_transform

    def block_opt(self, idx):
        self._block_inputs = self.inputs
        return inner_opt(self, idx)

    def block_transform(self, idx, block, feats):
        outs, self.inputs = self.inputs, self._block_inputs
        try:
            return inner_transform(self, idx, block, feats)
        finally:
            self.inputs = outs
    monkeypatch.setattr(cls, 'block_opt', block_opt)
    monkeypatch.setattr(cls, 'block_transform', block_transform)


def reference_builds_its_step_per_block(monkeypatch, cls):
    """The JAX package's TesseraQ with its jitted training step built
    anew in each block: the cached step keeps the qparams of the block it
    was built in (ROADMAP C)."""
    inner = cls.block_transform

    def block_transform(self, idx, block, feats):
        self._jits.clear()
        return inner(self, idx, block, feats)
    monkeypatch.setattr(cls, 'block_transform', block_transform)


def write_hf_moe_checkpoint(kind: str, path: str) -> str:
    """A tiny checkpoint written with transformers, as the JAX package's
    own tests write them: ``mixtral`` (MX_TINY) or ``deepseek`` (DS_TINY,
    a DeepSeek-V2 with a low-rank q, one dense first layer and a shared
    expert)."""
    import transformers as tr
    torch.manual_seed(0)
    if kind == 'mixtral':
        model = tr.MixtralForCausalLM(tr.MixtralConfig(
            tie_word_embeddings=False,
            **{k: v for k, v in MX_TINY.items() if k != 'dtype'}))
    else:
        model = tr.DeepseekV2ForCausalLM(tr.DeepseekV2Config(
            tie_word_embeddings=False, attention_bias=False,
            routed_scaling_factor=1.0, norm_topk_prob=False,
            moe_layer_freq=1, num_key_value_heads=4,
            **{k: v for k, v in DS_TINY.items() if k != 'dtype'}))
    model.save_pretrained(path, safe_serialization=True)
    return path


MOE_CONFIGS = os.path.dirname(METHODS)


def moe_config(rel: str, path: str, group_size: int = 16) -> dict:
    """A shipped MoE config (``rel`` under configs/quantization) as the
    tests run it: its ``model`` and ``quant`` sections on the tiny
    checkpoint at ``path`` (per-group 128 cut to ``group_size``: DS_TINY's
    experts are 48 wide), synthetic calibration and PPL data in place of
    its datasets.  Its ``save`` section is left out: the backend exports
    are not ported (ROADMAP A13)."""
    with open(os.path.join(MOE_CONFIGS, rel)) as f:
        cfg = yaml.safe_load(f)

    def cut(d):
        return {k: (group_size if k == 'group_size' and v == 128 else
                    cut(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    return dict(
        base=dict(seed=7), model=dict(cfg['model'], path=path),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=768, seq_len=32,
                  vocab_size=128, bs=2,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=cut(cfg['quant']))


def load_moe_checkpoints_in_f32(monkeypatch):
    """Both packages' MoE adapters load a checkpoint in float32 (as
    shipped they load bf16 whatever ``torch_dtype`` says): at bf16 a router
    tie and GPTQ's error feedback carry last-bit differences between XLA
    and torch to 7.8e-4 of a PPL, at f32 to 5e-5."""
    import jax.numpy as jnp
    from llmc_tpu.models import adapter as JA
    from llmc_tpu_torch.models import adapter as TA
    for cls, f32 in ((JA.MixtralAdapter, jnp.float32),
                     (JA.DeepseekV2Adapter, jnp.float32),
                     (TA.MixtralAdapter, torch.float32),
                     (TA.DeepseekV2Adapter, torch.float32)):
        inner = cls.from_pretrained.__func__

        def load(c, path, dtype=f32, inner=inner, **kw):
            return inner(c, path, dtype, **kw)
        monkeypatch.setattr(cls, 'from_pretrained', classmethod(load))
