"""Sparsification in the port (llmc_tpu_torch.compression.sparsification)
against the JAX package's: every shipped sparsification config through
both ``run_pipeline``s on one tiny checkpoint written to disk (PPLs within
1e-3), the masks of Magnitude and Wanda on fixed data, ShortGPT's
importances and the blocks it removes, and the ``kvsparse`` configs,
which give Dense's PPLs in both packages (ROADMAP C) and warn in the
port."""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from llmc_tpu.compression import sparsification as JS
from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.models.hf_loader import \
    save_llama_params_to_hf as j_save_params
from llmc_tpu_torch.compression import sparsification as TS
from llmc_tpu_torch.main import run_pipeline
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from torch_port_helpers import TINY, port_params, same_random_weights

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# six blocks, so that ShortGPT's shipped n_prune_layers (4) leaves two
DEEP = dict(TINY, num_hidden_layers=6)
HF = dict({k: v for k, v in DEEP.items() if k != 'dtype'},
          torch_dtype='float32', rms_norm_eps=1e-5)
CONFIGS = ('sparsification/dense.yml', 'sparsification/magnitude.yml',
           'sparsification/wanda.yml', 'sparsification/shortgpt.yml',
           'sparsification/kvsparse/sinkkv.yml',
           'sparsification/kvsparse/shadowkv.yml', 'ci/sparsify_wanda.yml')
PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')


def shipped(rel, path, save_path):
    """A shipped config as the tests run it: its ``model`` on the tiny
    checkpoint at ``path`` (an inline arch stays), synthetic calibration
    and PPL data in place of its datasets at its ``eval_pos``, its
    ``sparse`` section as shipped, ``save_trans`` into ``save_path``."""
    with open(os.path.join(ROOT, 'configs', rel)) as f:
        cfg = yaml.safe_load(f)
    model = cfg['model']
    if 'arch' not in model:
        model = dict(model, path=path, torch_dtype='float32')
    return dict(
        base=cfg['base'], model=model, sparse=cfg['sparse'],
        calib=dict(name='synthetic', n_samples=4, bs=-1, seq_len=24, seed=0,
                   vocab_size=128, preproc='random_truncate_txt'),
        eval=dict(name='synthetic', num_tokens=768, seq_len=32,
                  vocab_size=128, bs=2,
                  eval_pos=list(cfg['eval']['eval_pos'])),
        save=dict(save_trans=True, save_path=save_path))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """config -> (JAX result, port result, the port's warnings)."""
    root = tmp_path_factory.mktemp('sparse')
    path = str(root / 'tiny')
    j_save_params(JAdapter.random(JConfig(**DEEP), seed=3).params, path, HF)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        same_random_weights(mp)
        for i, rel in enumerate(CONFIGS):
            jcfg = shipped(rel, path, str(root / f'j{i}'))
            if 'shortgpt' in rel:
                # the reference's fake-quant eval fails after ShortGPT
                # (ROADMAP C: test_shortgpt_fake_quant_eval)
                jcfg['eval']['eval_pos'].remove('fake_quant')
            jres = j_run_pipeline(jcfg)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter('always')
                tres = run_pipeline(shipped(rel, path, str(root / f't{i}')),
                                    device='cpu')
            out[rel] = (jres, tres, [str(w.message) for w in rec])
    return out


@pytest.mark.parametrize('rel', CONFIGS)
def test_shipped_config_ppls_match(runs, rel):
    jres, tres, _ = runs[rel]
    keys = [k for k in PPLS if k in jres]
    assert keys and [k for k in PPLS if k in tres] == keys + (
        ['ppl_fake_quant'] if 'shortgpt' in rel else [])
    for k in keys:
        assert np.isfinite(tres[k])
        assert abs(tres[k] - jres[k]) / jres[k] <= 1e-3, k
    if 'dense' in rel:
        assert tres['ppl_transformed'] == tres['ppl_pretrain']


@pytest.mark.parametrize('rel', ['sparsification/kvsparse/sinkkv.yml',
                                 'sparsification/kvsparse/shadowkv.yml'])
def test_kvsparse_configs_equal_dense_and_warn(runs, rel):
    """The ``sparse.kvcache`` section reaches no eval in either package:
    the transformed PPL is Dense's exactly, and the port says so once."""
    jres, tres, warned = runs[rel]
    jd, td, _ = runs['sparsification/dense.yml']
    assert jres['ppl_transformed'] == jd['ppl_transformed']
    assert tres['ppl_transformed'] == td['ppl_transformed']
    assert getattr(tres['opt'], 'kv_module', None) is None
    assert getattr(jres['opt'], 'kv_module', None) is None
    assert sum('sparse.kvcache is not applied' in w for w in warned) == 1
    _, _, dense_warned = runs['sparsification/dense.yml']
    assert not any('sparse.kvcache' in w for w in dense_warned)


def test_shortgpt_fake_quant_eval(runs, tmp_path):
    """The shipped ShortGPT config evaluates at fake_quant: the
    reference's second ``deploy`` returns ``[]``, which its pipeline passes
    on as the fake-quant QMap, and fails (ROADMAP C); the port evaluates
    the deployed model under no QMap, as Dense, Magnitude and Wanda are
    evaluated in both."""
    _, tres, _ = runs['sparsification/shortgpt.yml']
    assert tres['ppl_fake_quant'] == tres['ppl_transformed']
    cfg = shipped('sparsification/shortgpt.yml', '', str(tmp_path))
    cfg['model'] = dict(type='Llama', arch=dict(TINY), seed=0)
    cfg['sparse'] = dict(cfg['sparse'], special=dict(n_prune_layers=1))
    with pytest.raises(AttributeError, match="'list' object has no "
                                             "attribute 'get'"):
        j_run_pipeline(cfg)
    for ppl in ('ppl_transformed', 'ppl_fake_quant'):
        assert np.isfinite(run_pipeline(cfg, device='cpu')[ppl])


def test_shortgpt_importances_and_removed_blocks(runs):
    """Block Influence within 1e-5 of the reference's, the same four
    blocks removed before the transformed eval, and the shortened
    ``num_hidden_layers`` in both saved configs."""
    jres, tres, _ = runs['sparsification/shortgpt.yml']
    ji, ti = jres['opt'].importances, tres['opt'].importances
    np.testing.assert_allclose(ti, ji, rtol=1e-5)
    assert list(np.argsort(ti)[:4]) == list(np.argsort(ji)[:4])
    assert sorted(tres['opt'].removed) == sorted(np.argsort(ji)[:4])
    assert tres['model'].n_blocks == jres['model'].n_blocks == 2
    for res in (jres, tres):
        with open(os.path.join(res['saved_to'], 'config.json')) as f:
            assert json.load(f)['num_hidden_layers'] == 2
    from llmc_tpu_torch.models.hf_loader import load_hf_tensors
    flat = load_hf_tensors(tres['saved_to'], dtype=torch.float32)
    assert not any(n.startswith('model.layers.2.') for n in flat)


@pytest.fixture(scope='module')
def algos():
    """(JAX model, port model, make(name, sparsity) -> (JAX algo, port
    algo)) on the same tiny weights, no calibration inputs."""
    jm = JAdapter.random(JConfig(**TINY), seed=5)

    def make(name, sparsity):
        tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
        sc = dict(method=name, weight=dict(sparsity=sparsity))
        empty = {'data': [], 'kwargs': []}
        return (getattr(JS, name)(jm, sc, empty, None, dict(sparse=sc)),
                getattr(TS, name)(tm, sc, empty, None, dict(sparse=sc)))
    return jm, make


@pytest.mark.parametrize('name,sparsity', [('Magnitude', 0.5),
                                           ('Magnitude', 0.3),
                                           ('Wanda', 0.5), ('Wanda', 0.7)])
def test_masks_equal_on_fixed_data(algos, name, sparsity):
    """Each subset's pruned weights equal the reference's bit for bit on
    block 1's weights and fixed features (Wanda's statistic summed over
    two batches); Wanda zeroes at least floor(sparsity · K) a row,
    Magnitude at least that share of each layer."""
    jm, make = algos
    ja, ta = make(name, sparsity)
    rng = np.random.RandomState(7)
    keys = {s.input_key: s for s in ja.layout.subsets}
    widths = {'qkv_in': 64, 'o_in': 64, 'mlp_in': 64, 'down_in': 128}
    feats = {k: [rng.randn(2, 5, widths[k]).astype(np.float32)
                 for _ in range(2)] for k in keys}
    jb, tb = jm.blocks[1], ta.model.blocks[1]
    for subset in ja.layout.subsets:
        jb = ja.subset_transform(1, jb, subset, {
            k: [jnp.asarray(x) for x in v] for k, v in feats.items()})
        tb = ta.subset_transform(1, tb, subset, {
            k: [torch.as_tensor(x) for x in v] for k, v in feats.items()})
    for path in ja.layout.linears:
        a, b = path.split('.')
        want = np.asarray(jb[a][b]['w'])
        got = tb[a][b]['w'].numpy()
        np.testing.assert_array_equal(got, want, err_msg=path)
        zeros = (got == 0)
        k = int(got.shape[1] * sparsity)
        if name == 'Wanda':
            assert zeros.sum(1).min() >= k
        else:
            assert zeros.sum() >= int(got.size * sparsity)


def test_dense_needs_no_calibration():
    assert TS.Dense.needs_calib is False and JS.Dense.needs_calib is False
    for name in ('Magnitude', 'Wanda', 'ShortGPT'):
        assert getattr(getattr(TS, name), 'needs_calib', True)
