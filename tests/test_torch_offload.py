"""Block offload in the port (``llmc_tpu_torch/utils/offload.py``: the
blocks in host memory, one on the device at a time) against the JAX
package's, on the CPU at float32: the block-outer streaming PPL, a
sharded checkpoint loaded with ``offload=True``, ``inference_per_block``
and a whole pipeline (calibration, evals, the fake-quant bake and a
backend export) with ``model.offload``, each equal to the resident run
and to the reference's (the counterparts of
``tests/test_parallel_offload.py``'s offload tests,
``tests/test_sharded_loader.py::test_offload_keeps_blocks_on_host`` and
``tests/test_eval_orchestration.py::
test_inference_per_block_ppl_matches_dense``)."""

import numpy as np
import pytest
import torch

from llmc_tpu.eval.ppl import PerplexityEval as JPerplexityEval
from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.utils import offload_model_blocks as j_offload
from llmc_tpu.utils import streaming_ppl as j_streaming_ppl
from llmc_tpu_torch.convert import params_from_numpy, params_to_numpy
from llmc_tpu_torch.eval.ppl import PerplexityEval
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig, build_model
from llmc_tpu_torch.utils import (HostBlocks, offload_model_blocks,
                                  streaming_ppl)
from test_sharded_loader import _flat_llama, _write_sharded
from test_torch_export import checkpoint, read_checkpoint  # noqa: F401
from torch_port_helpers import TINY, assert_trees_equal, to_np

torch.set_num_threads(1)


def pair(seed=2):
    """(JAX model, port model) of TINY on the same weights."""
    jm = JAdapter.random(JConfig(**TINY), seed=seed)
    return jm, LlamaAdapter(LlamaConfig(**TINY),
                            params_from_numpy(to_np(jm.params),
                                              device='cpu'))


def assert_on_host(model):
    blocks = model.params['blocks']
    assert model.offloaded and isinstance(blocks, HostBlocks)
    for i in range(len(blocks)):
        assert all(t.device.type == 'cpu' for t in _tensors(blocks.host(i)))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_offload_streaming_ppl_matches():
    """The block-outer PPL of an offloaded model equals the resident
    model's ``PerplexityEval`` and the reference's ``streaming_ppl``."""
    jm, tm = pair()
    ids = np.random.RandomState(3).randint(0, 128, (512,)).astype(np.int32)
    pe = PerplexityEval(ids, seq_len=32, bs=2)
    ref = pe.eval(tm)
    offload_model_blocks(tm)
    assert_on_host(tm)
    assert tm.device.type == 'cpu' and tm.n_blocks == TINY[
        'num_hidden_layers']
    got = streaming_ppl(tm, pe.chunks, bs=2)
    assert got == pytest.approx(ref, rel=1e-5)
    assert pe.eval(tm) == pytest.approx(ref, rel=1e-6)
    jref = JPerplexityEval(ids, seq_len=32, bs=2)
    j_offload(jm)
    assert got == pytest.approx(j_streaming_ppl(jm, jref.chunks, bs=2),
                                rel=1e-4)


def test_a_stored_block_goes_to_the_host():
    """Reading a block of ``HostBlocks`` gives it on the model's device,
    storing one keeps a host copy; iteration, slices and ``del`` follow
    the list."""
    _, tm = pair()
    offload_model_blocks(tm)
    blocks = tm.params['blocks']
    blk = blocks[0]
    new = dict(blk, input_layernorm={'w': blk['input_layernorm']['w'] * 2})
    tm.set_block(0, new)
    assert torch.equal(blocks[0]['input_layernorm']['w'],
                       new['input_layernorm']['w'])
    assert len(list(blocks)) == len(blocks[0:2]) == 2
    del blocks[1]
    assert tm.n_blocks == 1


def test_offload_loads_a_sharded_checkpoint_onto_the_host(tmp_path):
    """``from_pretrained(offload=True)`` reads the blocks straight to host
    memory; the streaming PPL equals the resident model's and the
    reference's offloaded load."""
    flat = _flat_llama()
    path = str(tmp_path / 's')
    _write_sharded(flat, path)
    m = LlamaAdapter.from_pretrained(path, dtype=torch.float32,
                                     offload=True, device='cpu')
    assert_on_host(m)
    md = LlamaAdapter.from_pretrained(path, dtype=torch.float32,
                                      device='cpu')
    assert_trees_equal(params_to_numpy(m.params),
                       params_to_numpy(md.params))
    chunks = np.random.RandomState(0).randint(0, 128, (2, 16))
    ppl = streaming_ppl(m, chunks)
    assert np.isfinite(ppl)
    assert ppl == pytest.approx(streaming_ppl(md, chunks), rel=1e-6)
    import jax.numpy as jnp
    jm = JAdapter.from_pretrained(path, dtype=jnp.float32, offload=True)
    assert ppl == pytest.approx(j_streaming_ppl(jm, chunks), rel=1e-4)


def config(path, method='RTN', offload=False, per_block=False, save=None):
    quant = dict(method=method, weight=dict(
        bit=4, symmetric=False, granularity='per_group', group_size=32))
    if method == 'GPTQ':
        quant['special'] = dict(actorder=True, percdamp=0.01, blocksize=32)
        quant['weight']['need_pack'] = True
    cfg = dict(
        base=dict(seed=7),
        model=dict(type='Llama', path=path, torch_dtype='float32',
                   offload=offload),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=1536, seq_len=48,
                  vocab_size=128, bs=2, inference_per_block=per_block,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=quant)
    if save:
        cfg['save'] = save
    return cfg


PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')


@pytest.mark.parametrize('method', ['RTN', 'GPTQ'])
def test_offloaded_pipeline_equals_the_resident_one(checkpoint, tmp_path,
                                                    method):  # noqa: F811
    """``model.offload`` through calibration (RTN's block step, GPTQ's own),
    the PPL evals block by block, GPTQ's weight bake at its fake-quant
    deploy and ``save_vllm``: PPLs within 1e-6 of the resident run and the
    written tensors equal; RTN's PPLs within 1e-3 of the reference's
    offloaded run."""
    res = {}
    for offload in (False, True):
        out = str(tmp_path / f'{offload}')
        res[offload] = run_pipeline(config(
            checkpoint, method, offload, per_block=offload,
            save=dict(save_vllm=True, save_path=out)), device='cpu')
        assert res[offload]['model'].n_blocks == TINY['num_hidden_layers']
    assert_on_host(res[True]['model'])
    for k in PPLS:
        assert res[True][k] == pytest.approx(res[False][k], rel=1e-6)
    got = read_checkpoint(str(tmp_path / 'True'))
    want = read_checkpoint(str(tmp_path / 'False'))
    assert got['config.json'] == want['config.json']
    for name, t in want['model.safetensors'].items():
        assert got['model.safetensors'][name].tobytes() == t.tobytes()
    if method == 'RTN':
        jres = j_run_pipeline(config(checkpoint, method, True, True))
        for k in PPLS:
            assert res[True][k] == pytest.approx(jres[k], rel=1e-3)


def test_inference_per_block_ppl_matches_dense(checkpoint):  # noqa: F811
    """``inference_per_block: true`` routes a PPL entry through the
    block-outer streaming path and agrees with the in-memory eval and with
    the reference's."""
    dense = run_pipeline(config(checkpoint), device='cpu')
    stream = run_pipeline(config(checkpoint, per_block=True), device='cpu')
    jstream = j_run_pipeline(config(checkpoint, per_block=True))
    for k in PPLS:
        assert stream[k] == pytest.approx(dense[k], rel=1e-5)
        assert stream[k] == pytest.approx(jstream[k], rel=1e-3)


def test_build_model_offloads_every_family():
    """``model.offload`` on a random model: the Llama family draws each
    block straight to the host (the same weights as a resident draw), the
    other families move their blocks there after the build."""
    arch = dict(TINY)
    a = build_model(dict(model=dict(type='Llama', arch=arch, offload=True)),
                    device='cpu')
    b = build_model(dict(model=dict(type='Llama', arch=arch)), device='cpu')
    assert_on_host(a)
    assert_trees_equal(params_to_numpy(a.params), params_to_numpy(b.params))
    opt = build_model(dict(model=dict(type='Opt', offload=True, arch=dict(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64))), device='cpu')
    assert_on_host(opt)
