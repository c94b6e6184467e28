"""Where the port's exports depart from the JAX package's on purpose, each
pinned against the reference's behaviour (ROADMAP C, "Reference faults the
port keeps apart from"), where it raises the same errors on purpose (act
order to the AWQ layout, OWQ's and SpQR's fp outliers), and the DeepSeek
export of ``configs/backend/vllm_dsv3_w4.yml``'s shape, whose tensors
equal the reference's (``tests/test_config_corpus.py``'s
``test_dsv3_backend_export_shape``) beside the latent norms and the
routers it writes and the reference leaves out."""

import numpy as np
import pytest
import torch

import llmc_tpu.main as jmain
import llmc_tpu_torch.main as tmain
from llmc_tpu.export import export_real_quant as j_export
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu_torch.convert import params_from_numpy
from llmc_tpu_torch.export import export_real_quant
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.base import get_path
from llmc_tpu_torch.native import AWQ_ORDER
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.quant.quantizer import fake_quant_weight
from test_torch_export import (backend_config, checkpoint,  # noqa: F401
                               read_checkpoint)
from torch_port_helpers import (TINY, family_pipeline_config,
                                same_random_weights, to_np,
                                write_hf_moe_checkpoint)

torch.set_num_threads(1)

OPT_TINY = dict(vocab_size=256, hidden_size=64, ffn_dim=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64)


def unpack_awq(words, bits=4):
    """AWQ-GEMM int32 words [R, C/pf] -> codes [R, C]."""
    u = words.view(np.uint32)
    pf = 32 // bits
    out = np.zeros((u.shape[0], u.shape[1] * pf), np.int64)
    for i in range(pf):
        out[:, AWQ_ORDER[i]::pf] = (u >> (bits * i)) & ((1 << bits) - 1)
    return out


def awq_dequant(flat, prefix, gs=32):
    """(q - z) * s of one linear of an AWQ-GEMM checkpoint, [out, in]."""
    q = unpack_awq(flat[f'{prefix}.qweight'])
    z = np.repeat(unpack_awq(flat[f'{prefix}.qzeros']), gs, axis=0)
    s = np.repeat(flat[f'{prefix}.scales'].astype(np.float32), gs, axis=0)
    return ((q - z) * s).T, s.max()


def symmetric_awq_config(path, out):
    cfg = backend_config('autoawq/rtn_w4a16.yml', path, out)
    cfg['quant']['weight']['symmetric'] = True
    return cfg


def test_symmetric_awq_export_dequantizes_to_the_fake_quant_weights(
        checkpoint, tmp_path):  # noqa: F811
    """Fault 1: the port offsets a symmetric model's signed codes by 8 and
    writes 8 as their zero point; its checkpoint dequantizes to the
    fake-quant weights within the fp16 rounding of the scales.  The
    reference hands the packer the signed codes with zero points of 0: its
    checkpoint is more than 0.1 off (the weights' largest magnitude is
    about 0.3)."""
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jmain.run_pipeline(symmetric_awq_config(checkpoint, jout))
    res = tmain.run_pipeline(symmetric_awq_config(checkpoint, tout),
                             device='cpu')
    spec = res['opt'].wspec
    got = read_checkpoint(tout)['model.safetensors']
    want = read_checkpoint(jout)['model.safetensors']
    assert sorted(got) == sorted(want)
    blk = res['model'].blocks[0]
    for path in res['model'].get_layout().linears:
        prefix = f'model.layers.0.{path}'
        fq = fake_quant_weight(spec, get_path(blk, path)['w']).numpy()
        deq, smax = awq_dequant(got, prefix)
        assert np.abs(deq - fq).max() <= 8 * smax * 2 ** -11
        ref, _ = awq_dequant(want, prefix)
        assert np.abs(ref - fq).max() > 0.1


def test_float_weights_to_a_backend_raise_before_any_work(
        checkpoint, monkeypatch):  # noqa: F811
    """Fault 2: ``configs/backend/vllm/fp8/rtn_fp8.yml`` raises
    ``NotImplementedError`` in the port before the model is built; the
    reference raises ``ValueError`` on ``int('e4m3')`` after its
    calibration."""
    def unbuilt(*a, **k):
        raise AssertionError('the model was built')
    cfg = backend_config('vllm/fp8/rtn_fp8.yml', checkpoint, 'unused')
    with pytest.raises(ValueError, match="invalid literal.*e4m3"):
        jmain.run_pipeline(cfg)
    monkeypatch.setattr(tmain, 'build_model', unbuilt)
    with pytest.raises(NotImplementedError, match='ROADMAP C'):
        tmain.run_pipeline(cfg, device='cpu')


# (model type, save flag) -> what the reference raises (else it writes a
# checkpoint without what the port names)
REFERENCE_RAISES = {('Bloom', 'save_trtllm'): KeyError,       # no gate_proj
                    ('Opt', 'save_vllm'): KeyError,            # no 'norm'
                    ('Opt', 'save_trtllm'): AttributeError}  # its config


@pytest.mark.parametrize('model_type,dropped,absent', [
    ('Gemma2', 'pre_feedforward_layernorm', 'feedforward_layernorm'),
    ('Bloom', r"'norm\.b'", 'norm.bias'),
    ('Opt', 'final_layer_norm', None),
    ('Qwen3', 'q_norm', 'q_norm'),
])
@pytest.mark.parametrize('flag', ['save_vllm', 'save_trtllm'])
def test_what_a_writer_would_drop_raises(model_type, dropped, absent, flag,
                                         tmp_path, monkeypatch):
    """Fault 3: where the model holds a parameter the writer does not
    write, the port raises ``ValueError`` naming it (Gemma2's sandwich
    norms, Bloom's LayerNorm biases, Qwen3's q/k norms, OPT's tree).  The
    reference writes Gemma2's and Qwen3's checkpoints and Bloom's
    compressed-tensors one without them, and raises on the rest
    (``REFERENCE_RAISES``).  Qwen3's random model gets its q/k norms in
    both packages (the reference's random tree lacks them: ROADMAP C)."""
    if model_type == 'Qwen3':
        same_random_weights(monkeypatch)
    if model_type == 'Opt':
        cfg = dict(family_pipeline_config('Llama', 'RTN'),
                   model=dict(type='Opt', arch=OPT_TINY, seed=0))
        cfg['calib']['vocab_size'] = 256
    else:
        cfg = family_pipeline_config(model_type, 'RTN')
    del cfg['eval']
    jout = str(tmp_path / 'jax')
    cfg['save'] = {flag: True, 'save_path': jout}
    raises = REFERENCE_RAISES.get((model_type, flag))
    if raises is not None:
        with pytest.raises(raises):
            jmain.run_pipeline(cfg)
    else:
        jmain.run_pipeline(cfg)
        names = [n for fn, f in read_checkpoint(jout).items()
                 if fn.endswith('.safetensors') for n in f]
        assert names and not any(absent in n for n in names)
    cfg['save'] = {flag: True, 'save_path': str(tmp_path / 'port')}
    with pytest.raises(ValueError, match=dropped):
        tmain.run_pipeline(cfg, device='cpu')


def _gptq_models(**lin_extra):
    """Both packages' TINY model on the same weights, block 0's q_proj
    carrying a stored act-order grid (and ``lin_extra``)."""
    jm = JAdapter.random(JConfig(**TINY), seed=1)
    tree = to_np(jm.params)
    rng = np.random.RandomState(0)
    lin = tree['blocks'][0]['self_attn']['q_proj']
    lin.update(gptq_scales=(rng.rand(64, 2) * 0.01 + 0.01).astype(
        np.float32), gptq_zeros=rng.randint(0, 16, (64, 2)).astype(
            np.float32), perm=rng.permutation(64), gptq_perm_qp=True,
        **lin_extra)
    jm.params['blocks'][0]['self_attn']['q_proj'] = lin
    tm = LlamaAdapter(LlamaConfig(**TINY), params_from_numpy(tree,
                                                             device='cpu'))
    tm.params['blocks'][0]['self_attn']['q_proj']['gptq_perm_qp'] = True
    return jm, tm


@pytest.mark.parametrize('extra,backend,match', [
    ({}, 'autoawq', 'actorder'),
    ({}, 'mlcllm', 'actorder'),
    (dict(owq_n_out=4), 'vllm', 'OWQ'),
    (dict(spqr_mask=np.zeros((64, 64), bool)), 'vllm', 'SpQR'),
])
def test_what_the_reference_refuses_the_port_refuses(extra, backend, match,
                                                     tmp_path):
    jm, tm = _gptq_models(**extra)
    w = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
    with pytest.raises(ValueError, match=match):
        j_export(jm, JSpec(**w), dict(weight=w), str(tmp_path / 'j'),
                 backend=backend)
    with pytest.raises(ValueError, match=match):
        export_real_quant(tm, QuantSpec(**w), dict(weight=w),
                          str(tmp_path / 't'), backend=backend)


def test_deepseek_export_writes_the_reference_tensors(tmp_path):
    """An MoE / MLA model (a tiny DeepSeek-V2 written by transformers) ->
    RTN W4 need_pack -> ``save_vllm``: every tensor the reference writes,
    name, dtype, shape and bytes, and its ``config.json``; the port also
    writes each block's q/kv latent norms and each MoE block's router,
    which the reference leaves out."""
    path = write_hf_moe_checkpoint('deepseek', str(tmp_path / 'ds'))

    def cfg(out):
        return {
            'base': {'seed': 42},
            'model': {'type': 'DeepseekV2', 'path': path},
            'calib': {'name': 'synthetic', 'n_samples': 2, 'bs': -1,
                      'seq_len': 12, 'seed': 0, 'vocab_size': 128},
            'quant': {'method': 'RTN',
                      'weight': {'bit': 4, 'symmetric': True,
                                 'granularity': 'per_group',
                                 'group_size': 16, 'need_pack': True}},
            'save': {'save_vllm': True, 'save_path': out}}
    jmain.run_pipeline(cfg(str(tmp_path / 'jax')))
    tmain.run_pipeline(cfg(str(tmp_path / 'port')), device='cpu')
    want = read_checkpoint(str(tmp_path / 'jax'))
    got = read_checkpoint(str(tmp_path / 'port'))
    assert got['config.json'] == want['config.json']
    g, w = got['model.safetensors'], want['model.safetensors']
    for name in w:
        assert (g[name].dtype, g[name].shape) == (w[name].dtype,
                                                  w[name].shape), name
        assert g[name].tobytes() == w[name].tobytes(), name
    extra = sorted(set(g) - set(w))
    n = 3   # DS_TINY's layers: one dense, two MoE
    assert extra == sorted(
        [f'model.layers.{i}.self_attn.{k}.weight' for i in range(n)
         for k in ('q_a_layernorm', 'kv_a_layernorm')]
        + [f'model.layers.{i}.mlp.gate.weight' for i in range(1, n)])
