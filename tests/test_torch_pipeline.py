"""The compression pipeline of the port against the JAX package's, end to
end on the CPU at float32: both ``run_pipeline``s on the same locally
written checkpoint (RTN, and AWQ with its scale transform and clip v1),
the ``python -m llmc_tpu_torch`` command line, and compress -> pack ->
greedy decode."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu.quant import QuantSpec as JSpec
from llmc_tpu.serve.decode import greedy_generate as j_greedy
from llmc_tpu.serve.packed import pack_model as j_pack_model
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models.hf_loader import load_hf_tensors
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.serve import greedy_generate, pack_model
from torch_port_helpers import TINY, rel_err

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF = dict({k: v for k, v in TINY.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5)
PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')
AWQ_CLIP = dict(trans=True, weight_clip=True, clip_version='v1')
METHODS = {'RTN': ('RTN', None), 'Awq': ('Awq', AWQ_CLIP)}


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'tiny')
    j_save_params(JAdapter.random(JConfig(**TINY), seed=3).params, path, HF)
    return path


def pipeline_config(path, method, special=None, symmetric=False,
                    save_path=None):
    """The tiny config of the repository's verification recipe, on a
    checkpoint on disk."""
    quant = dict(method=method, weight=dict(
        bit=4, symmetric=symmetric, granularity='per_group', group_size=32))
    if special:
        quant['special'] = dict(special)
    cfg = dict(
        base=dict(seed=7),
        model=dict(type='Llama', path=path, torch_dtype='float32'),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=1536, seq_len=48,
                  vocab_size=128, bs=2, eval_pos=['pretrain', 'transformed',
                                                  'fake_quant']),
        quant=quant)
    if save_path:
        cfg['save'] = dict(save_fake=True, save_path=save_path)
    return cfg


@pytest.fixture(scope='module')
def runs(checkpoint, tmp_path_factory):
    """method -> (JAX result, port result), each with ``save_fake``."""
    out = {}
    root = tmp_path_factory.mktemp('saved')
    for key, (method, special) in METHODS.items():
        jres = j_run_pipeline(pipeline_config(
            checkpoint, method, special, save_path=str(root / f'j_{key}')))
        tres = run_pipeline(pipeline_config(
            checkpoint, method, special, save_path=str(root / f't_{key}')),
            device='cpu')
        out[key] = (jres, tres)
    return out


@pytest.mark.parametrize('ppl', PPLS)
@pytest.mark.parametrize('method', list(METHODS))
def test_pipeline_ppls_match(runs, method, ppl):
    jres, tres = runs[method]
    assert np.isfinite(tres[ppl])
    assert abs(tres[ppl] - jres[ppl]) / jres[ppl] <= 1e-3
    if method == 'RTN':
        assert tres['ppl_transformed'] == tres['ppl_pretrain']


@pytest.mark.parametrize('method', list(METHODS))
def test_save_fake_trees_match(runs, method):
    jres, tres = runs[method]
    jflat = load_hf_tensors(jres['saved_to'], dtype=torch.float32)
    tflat = load_hf_tensors(tres['saved_to'], dtype=torch.float32)
    assert set(tflat) == set(jflat) and len(tflat) == 3 + 9 * 2
    for name in jflat:
        assert rel_err(tflat[name].numpy(), jflat[name].numpy()) <= 1e-5, name
    # the saved weights are on the 4-bit grid: at most 16 values a group
    w = tflat['model.layers.0.mlp.down_proj.weight'].numpy()
    assert max(len(np.unique(g)) for g in w.reshape(-1, 32)) <= 16


@pytest.mark.parametrize('method', list(METHODS))
def test_phase_times_and_result_keys(runs, method):
    _, tres = runs[method]
    assert set(tres['phase_times']) == {
        'build_model', 'eval_pretrain', 'calib_data', f'calib_{method}',
        'eval_transformed', 'eval_fake_quant', 'save'}
    assert all(v >= 0 for v in tres['phase_times'].values())
    assert tres['device'] == 'cpu' and tres['opt'].wspec.bit == 4
    assert tres['model'].device.type == 'cpu'


def test_command_line_prints_the_pipelines_ppls(checkpoint, runs, tmp_path):
    cfg_path = tmp_path / 'cfg.yml'
    cfg_path.write_text(yaml.safe_dump(pipeline_config(checkpoint, 'RTN')))
    r = subprocess.run(
        [sys.executable, '-m', 'llmc_tpu_torch', '--config', str(cfg_path),
         '--device', 'cpu'], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    printed = dict(line.split(': ', 1) for line in r.stdout.splitlines()
                   if line.startswith('ppl_'))
    for k in PPLS:
        assert abs(float(printed[k]) - runs['RTN'][1][k]) \
            <= 1e-6 * runs['RTN'][1][k]
    assert 'phase calib_RTN:' in r.stdout and 'device: cpu' in r.stdout


def test_compress_pack_greedy_decode_tokens_match(checkpoint):
    """AWQ (scale transform + clip v1, symmetric W4 g32), then
    ``pack_model`` and greedy decode in both packages: the same tokens on
    fixed prompts."""
    cfg = pipeline_config(checkpoint, 'Awq', AWQ_CLIP, symmetric=True)
    jres = j_run_pipeline(cfg)
    tres = run_pipeline(cfg, device='cpu')
    for k in PPLS:
        assert abs(tres[k] - jres[k]) / jres[k] <= 1e-3
    jm, tm = jres['model'], tres['model']
    wspec = dict(cfg['quant']['weight'])
    jq = j_pack_model(jm, JSpec(**wspec), fuse=True, head=True)
    tq = pack_model(tm, QuantSpec(**wspec), fuse=True, head=True)
    assert 'qweight' in tm.blocks[0]['mlp']['gate_up_proj']
    ids = np.random.RandomState(0).randint(0, 128, (2, 7))
    want = np.asarray(j_greedy(jm, jnp.asarray(ids), 8, qmap=jq))
    got = greedy_generate(tm, torch.as_tensor(ids), 8, qmap=tq,
                          device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('extra,item', [
    (dict(parallel=dict(dp=2)), 'ROADMAP A14'),
    (dict(sparse=dict(method='Magnitude')), 'ROADMAP A13'),
    (dict(save=dict(save_vllm=True)), 'ROADMAP A13'),
    (dict(save=dict(save_trtllm=True)), 'ROADMAP A13'),
    (dict(opencompass=dict(cfg_path='x', output_path='y')), 'ROADMAP A13'),
    (dict(save=dict(save_lightx2v=True)), 'ROADMAP A13e'),
])
def test_pipeline_options_outside_the_slice_raise(checkpoint, extra, item,
                                                  tmp_path):
    """Data parallelism and the Wan video export raise with their ROADMAP
    item.  What raised until its slice ported it runs as the JAX package
    runs it: a ``sparse`` section (Magnitude's PPLs within 1e-3 of the JAX
    package's), the backend exports (``save_vllm``, ``save_trtllm``: the
    written tensors and ``config.json`` equal to the JAX package's), and
    opencompass, which without ``save.save_trans`` raises ``ValueError``
    as the reference's does (here before any work)."""
    cfg = dict(pipeline_config(checkpoint, 'RTN'), **extra)
    if 'sparse' in extra:
        del cfg['quant']
        jres, tres = j_run_pipeline(cfg), run_pipeline(cfg, device='cpu')
        for k in PPLS:
            assert abs(tres[k] - jres[k]) / jres[k] <= 1e-3
        assert tres['ppl_transformed'] != tres['ppl_pretrain']
        return
    if 'opencompass' in extra:
        with pytest.raises(ValueError, match='save_trans'):
            run_pipeline(cfg, device='cpu')
        return
    save = extra.get('save', {})
    if save.get('save_vllm') or save.get('save_trtllm'):
        from test_torch_export import assert_same_checkpoint, read_checkpoint
        j_run_pipeline(dict(cfg, save=dict(save, save_path=str(
            tmp_path / 'jax'))))
        run_pipeline(dict(cfg, save=dict(save, save_path=str(
            tmp_path / 'port'))), device='cpu')
        assert_same_checkpoint(read_checkpoint(str(tmp_path / 'port')),
                               read_checkpoint(str(tmp_path / 'jax')))
        return
    with pytest.raises(NotImplementedError, match=item):
        run_pipeline(cfg, device='cpu')


@pytest.mark.parametrize('ev,item', [
    (dict(type='latency'), 'ROADMAP A13'),
    (dict(type='acc', name='imagenet'), 'ROADMAP A13'),
    (dict(inference_per_block=True), 'ROADMAP A13'),
    (dict(type='code'), 'ROADMAP A13'),
])
def test_eval_entries_outside_the_slice_raise(checkpoint, ev, item):
    """What raised until its slice ported it runs as the JAX package runs
    it.  The ImageNet accuracy eval (the VLM tier's) classifies images:
    on a Llama both packages fail before calibration, the port with a
    ``ValueError`` that names the Vit it needs, the JAX package on the
    Llama config's missing ``num_channels``.  A ``latency`` entry at each position (positive
    times, and the greedy tokens of its runs equal the JAX package's
    greedy decode of the same ids), the per-block PPL
    (``inference_per_block``: the PPLs within 1e-5 of the resident eval's
    and 1e-3 of the JAX package's), and a ``code`` entry, which without a
    problems file reads ``human_eval``'s set and raises
    ``ModuleNotFoundError`` where the package is missing, as the JAX
    package's does."""
    cfg = pipeline_config(checkpoint, 'RTN')
    cfg['eval'] = dict(cfg['eval'], **ev)
    if ev.get('type') == 'latency':
        cfg['eval'].update(prompt_len=6, gen_len=3, bs=2, iters=2)
        res = run_pipeline(cfg, device='cpu')
        for pos in cfg['eval']['eval_pos']:
            assert min(res[f'latency_{pos}'].values()) > 0
        from llmc_tpu_torch.eval.latency import LatencyEval
        from llmc_tpu_torch.models import LlamaAdapter
        ids = np.random.RandomState(0).randint(0, 128, (2, 6))
        jm = JAdapter.from_pretrained(checkpoint, dtype=jnp.float32)
        want = np.asarray(j_greedy(jm, jnp.asarray(ids), 4))[:, 6:]
        le = LatencyEval(prompt_len=6, gen_len=3, batch=2, iters=1)
        le.eval(LlamaAdapter.from_pretrained(checkpoint, dtype=torch.float32,
                                             device='cpu'))
        np.testing.assert_array_equal(le.tokens.numpy(), want)
        return
    if ev.get('inference_per_block'):
        res = run_pipeline(cfg, device='cpu')
        dense = run_pipeline(pipeline_config(checkpoint, 'RTN'),
                             device='cpu')
        jres = j_run_pipeline(cfg)
        for k in PPLS:
            assert res[k] == pytest.approx(dense[k], rel=1e-5)
            assert res[k] == pytest.approx(jres[k], rel=1e-3)
        return
    if ev.get('type') == 'code':
        for run, kw in ((j_run_pipeline, {}), (run_pipeline,
                                              dict(device='cpu'))):
            with pytest.raises(ModuleNotFoundError, match='human_eval'):
                run(cfg, **kw)
        return
    if ev.get('type') == 'acc':
        with pytest.raises(AttributeError, match='num_channels'):
            j_run_pipeline(cfg)
        with pytest.raises(ValueError, match='needs a Vit model'):
            run_pipeline(cfg, device='cpu')
        return
    with pytest.raises(NotImplementedError, match=f'{item}e'):
        run_pipeline(cfg, device='cpu')


def test_pipeline_without_a_card_raises_unless_the_cpu_is_asked_for(
        checkpoint):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: device=None runs on it')
    with pytest.raises(RuntimeError, match='CUDA'):
        run_pipeline(pipeline_config(checkpoint, 'RTN'))
