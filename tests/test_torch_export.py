"""The port's backend exports (``llmc_tpu_torch/export``) against the JAX
package's, on the CPU at float32: one shipped ``configs/backend`` config
per writer and layout through both packages' ``run_pipeline`` on the same
tiny checkpoint (per-group 128 cut to 32), every written tensor's name,
dtype and shape equal and ``config.json`` equal as JSON, the bytes equal
where the method is RTN; and the reference's compressed model (GPTQ's
stored grids and act-order permutation, AWQ's searched scales and clips)
written by the port's writer, byte for byte the reference's file.  The RTN
and GPTQ configs are here, the AWQ ones (and TRT-LLM's) in
``test_torch_export_searched.py``, the reference's faults (ROADMAP C) in
``test_torch_export_faults.py``."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from llmc_tpu.export.exporter import _stored_quant_np
from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.base import get_path as j_get_path
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu_torch.convert import params_from_numpy
from llmc_tpu_torch.export import export_real_quant
from llmc_tpu_torch.export.exporter import _stored_quant
from llmc_tpu_torch.export.trtllm import export_trtllm
from llmc_tpu_torch.export import BACKENDS
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.models.base import get_path
from llmc_tpu_torch.quant.qspec import spec_from_config
from torch_port_helpers import TINY, to_np

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKEND = os.path.join(ROOT, 'configs', 'backend')
HF = dict({k: v for k, v in TINY.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5, model_type='llama')
# name -> (config under configs/backend, save-section overrides)
CASES = {
    'vllm_rtn_w8a16': ('vllm/rtn_w8a16.yml', {}),
    'sglang_rtn_w4a16': ('sglang/rtn_w4a16.yml', {}),
    'vllm_gptq_w4a16': ('vllm/gptq_w4a16.yml', {}),
    'autoawq_rtn_w4a16': ('autoawq/rtn_w4a16.yml', {}),
    'mlcllm_rtn_w4a16': ('mlcllm/rtn_w4a16.yml', {}),
}


def cut_groups(d):
    return {k: (32 if k == 'group_size' and v == 128 else
                cut_groups(v) if isinstance(v, dict) else v)
            for k, v in d.items()}


def backend_config(rel, path, out, **save):
    """A shipped backend config's ``quant`` (group size 128 cut to 32) and
    ``save`` sections on the checkpoint at ``path``, synthetic calibration
    data and no eval (the PPLs are held elsewhere)."""
    with open(os.path.join(BACKEND, rel)) as f:
        cfg = yaml.safe_load(f)
    return dict(
        base=dict(seed=7),
        model=dict(type='Llama', path=path, torch_dtype='float32'),
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        quant=cut_groups(cfg['quant']),
        save=dict(cfg['save'], save_path=out, **save))


def read_checkpoint(path):
    """{file: {name: numpy array}} of the safetensors files, {file: dict}
    of the JSON ones."""
    from safetensors.numpy import load_file
    out = {}
    for fn in sorted(os.listdir(path)):
        full = os.path.join(path, fn)
        if fn.endswith('.safetensors'):
            out[fn] = load_file(full)
        elif fn.endswith('.json'):
            with open(full) as f:
                out[fn] = json.load(f)
    return out


def assert_same_checkpoint(got, want, same_bytes=True):
    assert sorted(got) == sorted(want)
    for fn, w in want.items():
        g = got[fn]
        if fn.endswith('.json'):
            assert g == w, fn
            continue
        assert sorted(g) == sorted(w), (fn, set(g) ^ set(w))
        for name in w:
            assert (g[name].dtype, g[name].shape) == \
                (w[name].dtype, w[name].shape), name
            if same_bytes:
                assert g[name].tobytes() == w[name].tobytes(), name


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'tiny')
    j_save_params(JAdapter.random(JConfig(**TINY), seed=3).params, path, HF)
    return path


_RUNS = {}


def run_case(name, checkpoint, tmp_path_factory, cases=CASES):
    """Both pipelines on one backend config of ``cases``, once a process:
    (name, config, JAX result, port result, JAX checkpoint dir, port
    checkpoint dir)."""
    if name not in _RUNS:
        rel, save = cases[name]
        root = tmp_path_factory.mktemp(name)
        jdir, tdir = str(root / 'jax'), str(root / 'port')
        jres = j_run_pipeline(backend_config(rel, checkpoint, jdir, **save))
        config = backend_config(rel, checkpoint, tdir, **save)
        tres = run_pipeline(config, device='cpu')
        _RUNS[name] = name, config, jres, tres, jdir, tdir
    return _RUNS[name]


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request, checkpoint, tmp_path_factory):
    return run_case(request.param, checkpoint, tmp_path_factory)


def check_pipeline(case):
    """Every written tensor's name, dtype and shape and ``config.json``;
    the bytes too where the method is RTN (the same weights in both).  A
    method that searches or compensates (AWQ, GPTQ) differs in the last
    bits of its weights between XLA and torch; its bytes are held by
    ``check_writer`` on the reference's own compressed model."""
    name, config, jres, tres, jdir, tdir = case
    assert tres['saved_to'] == tdir and tres['phase_times']['save'] > 0
    assert_same_checkpoint(read_checkpoint(tdir), read_checkpoint(jdir),
                           same_bytes=config['quant']['method'] == 'RTN')


def check_writer(case, out):
    """The reference's compressed model (its weights, AWQ's clips, GPTQ's
    stored grids and act-order permutation) written by the port's writer
    into ``out``: the reference's checkpoint byte for byte."""
    name, config, jres, tres, jdir, tdir = case
    jm = jres['model']
    tm = LlamaAdapter(LlamaConfig(**TINY),
                      params_from_numpy(to_np(jm.params), device='cpu'),
                      hf_config=jm.hf_config)
    save = config['save']
    if save.get('save_trtllm'):
        export_trtllm(tm, out, tp_size=int(save.get('tp_size', 1)),
                      quant_algo='W4A16')
    else:
        backend = next(b for f, b in BACKENDS.items() if save.get(f))
        export_real_quant(tm, spec_from_config(config['quant']['weight']),
                          config['quant'], out, backend=backend)
    assert_same_checkpoint(read_checkpoint(out), read_checkpoint(jdir))


def test_pipeline_writes_what_the_reference_writes(case):
    check_pipeline(case)


def test_writer_on_the_reference_model_is_byte_equal(case, tmp_path):
    check_writer(case, str(tmp_path / 'port'))


def test_gptq_stored_codes_match_the_reference(checkpoint, tmp_path_factory):
    """GPTQ's export reads its stored grid (``_stored_quant``): the codes,
    scales, zero points and act-order group index of every linear equal
    the reference's ``_stored_quant_np`` on the same stored linear, and
    dequantize to GPTQ's own static qdq (the counterpart of
    ``test_opt_and_export.py::test_export_uses_stored_gptq_qparams``)."""
    _, _, jres, tres, _, _ = run_case('vllm_gptq_w4a16', checkpoint,
                                      tmp_path_factory)
    jm, jopt, topt = jres['model'], jres['opt'], tres['opt']
    for path in jm.get_layout().linears:
        jlin = to_np(j_get_path(jm.blocks[0], path))
        assert jlin.get('gptq_perm_qp')
        want = _stored_quant_np(jopt.wspec, jlin)
        got = _stored_quant(topt.wspec, params_from_numpy(jlin,
                                                          device='cpu'))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        lin = get_path(tres['model'].blocks[0], path)
        codes, scales, zeros, g_idx = _stored_quant(topt.wspec, lin)
        deq = (codes.float() - zeros[:, g_idx.long()]) \
            * scales[:, g_idx.long()]
        np.testing.assert_allclose(deq.numpy(),
                                   topt.static_w_qdq(lin).numpy(),
                                   rtol=1e-6, atol=1e-6)
