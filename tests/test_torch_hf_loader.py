"""The port's checkpoint loader against the JAX package's: a 2-layer
checkpoint written by the JAX package, once plain and once with its block
linears stored as an FP8-block checkpoint stores them (e4m3 ``weight`` +
``weight_scale_inv``), loads to the same tree in both packages, eagerly
and one tensor at a time; what the port saves, the JAX package loads."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.flax import save_file as save_flax

from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu.quant import fp8_block as JF
from llmc_tpu_torch.convert import params_to_numpy
from llmc_tpu_torch.models import LlamaAdapter, build_model
from llmc_tpu_torch.models.hf_loader import (LazyHFTensors, load_hf_tensors,
                                             save_llama_params_to_hf)
from torch_port_helpers import TINY, assert_trees_equal, to_np

HF = dict({k: v for k, v in TINY.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5)
LINEARS = ('q_proj', 'k_proj', 'v_proj', 'o_proj', 'gate_proj', 'up_proj',
           'down_proj')


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    """(plain dir, fp8-block dir) of one random tiny Llama."""
    root = tmp_path_factory.mktemp('ckpt')
    plain, fp8 = str(root / 'plain'), str(root / 'fp8')
    model = JAdapter.random(JConfig(**TINY), seed=11)
    j_save_params(model.params, plain, HF)
    flat = {}
    with safe_open(os.path.join(plain, 'model.safetensors'),
                   framework='flax') as f:
        for name in f.keys():
            flat[name] = f.get_tensor(name)
    for name in list(flat):
        if name.endswith('.weight') and name.split('.')[-2] in LINEARS:
            codes, scale_inv = JF.weight_cast_to_fp8(flat[name], 32)
            flat[name] = codes
            flat[name + '_scale_inv'] = scale_inv
    os.makedirs(fp8)
    save_flax(flat, os.path.join(fp8, 'model.safetensors'))
    with open(os.path.join(fp8, 'config.json'), 'w') as f:
        json.dump(HF, f)
    return plain, fp8


@pytest.mark.parametrize('kind', ['plain', 'fp8_block'])
@pytest.mark.parametrize('stream', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_both_packages_load_the_same_tree(checkpoints, kind, stream, dtype):
    path = checkpoints[kind == 'fp8_block']
    jm = JAdapter.from_pretrained(path, dtype=getattr(jnp, dtype),
                                  stream=stream)
    tm = LlamaAdapter.from_pretrained(path, dtype=getattr(torch, dtype),
                                      stream=stream, device='cpu')
    assert tm.cfg.num_hidden_layers == jm.cfg.num_hidden_layers == 2
    assert tm.params['blocks'][0]['mlp']['up_proj']['w'].dtype == \
        getattr(torch, dtype)
    assert_trees_equal(params_to_numpy(tm.params), to_np(jm.params))


def test_fp8_block_pair_is_consumed_and_differs_from_plain(checkpoints):
    plain, fp8 = checkpoints
    name = 'model.layers.1.mlp.down_proj.weight'
    lazy = LazyHFTensors(fp8, dtype=torch.float32)
    eager = load_hf_tensors(fp8, dtype=torch.float32)
    assert lazy.get(name + '_scale_inv') is None
    assert name + '_scale_inv' not in eager
    np.testing.assert_array_equal(lazy[name].numpy(), eager[name].numpy())
    w = load_hf_tensors(plain, dtype=torch.float32)[name]
    err = (eager[name] - w).abs().max() / w.abs().max()
    assert 0 < float(err) < 2 ** -4       # e4m3 keeps 3 mantissa bits


def test_from_config_reads_model_path_and_build_model_dispatches(
        checkpoints):
    cfg = dict(model=dict(type='Llama', path=checkpoints[0],
                          torch_dtype='float32'))
    a = build_model(cfg, device='cpu')
    b = LlamaAdapter.from_pretrained(checkpoints[0], dtype=torch.float32,
                                     device='cpu')
    assert_trees_equal(params_to_numpy(a.params), params_to_numpy(b.params))
    # model.offload, which raised until offload was ported, loads the same
    # params with the blocks kept in host memory
    c = build_model(dict(model=dict(type='Llama', path=checkpoints[0],
                                    torch_dtype='float32', offload=True)),
                    device='cpu')
    assert c.offloaded and type(c.params['blocks']).__name__ == 'HostBlocks'
    assert_trees_equal(params_to_numpy(c.params), params_to_numpy(b.params))
    with pytest.raises(ValueError, match='model.path'):
        build_model(dict(model=dict(type='Llama')), device='cpu')


def test_port_saves_what_the_reference_loads(checkpoints, tmp_path):
    tm = LlamaAdapter.from_pretrained(checkpoints[0], dtype=torch.float32,
                                      device='cpu')
    out = str(tmp_path / 'saved')
    save_llama_params_to_hf(tm.params, out, tm.hf_config)
    jm = JAdapter.from_pretrained(out, dtype=jnp.float32)
    assert_trees_equal(to_np(jm.params), params_to_numpy(tm.params))
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f)['hidden_size'] == TINY['hidden_size']


def test_model_arch_is_random_from_the_seed():
    cfg = dict(model=dict(type='Llama', arch=dict(TINY), seed=5))
    a, b = build_model(cfg, device='cpu'), build_model(cfg, device='cpu')
    assert_trees_equal(params_to_numpy(a.params), params_to_numpy(b.params))
    c = build_model(dict(model=dict(type='Llama', arch=dict(TINY), seed=6)),
                    device='cpu')
    assert not np.array_equal(
        params_to_numpy(a.params)['blocks'][0]['mlp']['up_proj']['w'],
        params_to_numpy(c.params)['blocks'][0]['mlp']['up_proj']['w'])
