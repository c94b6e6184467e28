"""The port's compression engine against the JAX package on the CPU: the
param transforms, the block captures, AWQ's scale search of every subset,
the weight-clip search, and the fake-quant deploy ``QMap``.  Both packages
get the same tiny Llama (float32) and the same synthetic calibration
tokens."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llmc_tpu.serve  # noqa: F401  (registers the reference's KV policies)
from llmc_tpu.compression import transforms as JT
from llmc_tpu.compression.quantization.auto_clip import \
    AutoClipper as JAutoClipper
from llmc_tpu.compression.quantization.awq import Awq as JAwq
from llmc_tpu.compression.quantization.rtn import RTN as JRTN
from llmc_tpu.data import CalibDataset as JCalibDataset
from llmc_tpu.models import LlamaAdapter as JAdapter
from llmc_tpu.models import LlamaConfig as JConfig
from llmc_tpu.quant.qspec import QuantSpec as JQuantSpec
from llmc_tpu.utils.config import Cfg as JCfg
from llmc_tpu_torch.compression import transforms as T
from llmc_tpu_torch.compression.quantization.auto_clip import AutoClipper
from llmc_tpu_torch.compression.quantization.awq import Awq
from llmc_tpu_torch.compression.quantization.rtn import RTN
from llmc_tpu_torch.convert import params_from_numpy, params_to_numpy
from llmc_tpu_torch.data import CalibDataset
from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
from llmc_tpu_torch.quant import QuantSpec
from llmc_tpu_torch.utils import Cfg
from torch_port_helpers import TINY, port_params, rel_err, to_np

CALIB = dict(name='synthetic', n_samples=4, bs=2, seq_len=24, seed=0,
             vocab_size=128)


def tt(tree):
    return params_from_numpy(tree, device='cpu')


def config(method, weight, special=None, **extra):
    quant = dict(method=method, weight=dict(weight))
    if special:
        quant['special'] = dict(special)
    return dict(base=dict(seed=7), model=dict(type='Llama'),
                calib=dict(CALIB), quant=quant, **extra)


def both(method, weight, special=None, seed=3, **extra):
    """(JAX algorithm object, port algorithm object) on the same model and
    the same calibration batches."""
    cfg = config(method, weight, special, **extra)
    jm = JAdapter.random(JConfig(**TINY), seed=seed)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    jb, _ = JCalibDataset(cfg['calib'], None).get_calib_dataset()
    tb, _ = CalibDataset(cfg['calib'], None).get_calib_dataset()
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a['input_ids'], b['input_ids'])
    jx, jkw = jm.collect_first_block_input(jb)
    tx, tkw = tm.collect_first_block_input(tb)
    jcls = {'Awq': JAwq, 'RTN': JRTN}[method]
    tcls = {'Awq': Awq, 'RTN': RTN}[method]
    ja = jcls(jm, JCfg(cfg)['quant'], {'data': jx, 'kwargs': jkw}, None,
              JCfg(cfg))
    ta = tcls(tm, Cfg(cfg)['quant'], {'data': tx, 'kwargs': tkw}, None,
              Cfg(cfg))
    return ja, ta


W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=32)
W4_SYM = dict(W4, symmetric=True)


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------

def _lin(rng, out_d, in_d, bias):
    d = {'w': (rng.standard_normal((out_d, in_d)) * 0.1).astype(np.float32),
         'b': None}
    if bias:
        d['b'] = (rng.standard_normal(out_d) * 0.1).astype(np.float32)
    return d


def _assert_tree_close(got, want, tol=1e-6):
    got, want = params_to_numpy(got), to_np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, tol)
    elif want is None:
        assert got is None
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        # infinities (the logit of an unclipped group's factor 1) must sit
        # at the same places; the rest is held relative to the largest
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        if fin.any():
            assert rel_err(got[fin], want[fin]) <= tol


@pytest.mark.parametrize('bias', [False, True])
def test_scale_and_shift_transforms_match(bias):
    rng = np.random.RandomState(0)
    fc1, fc2 = _lin(rng, 32, 48, bias), _lin(rng, 24, 32, bias)
    ln = {'w': rng.uniform(0.5, 1.5, 48).astype(np.float32)}
    if bias:
        ln['b'] = rng.standard_normal(48).astype(np.float32)
    fcs = [_lin(rng, 32, 48, bias), _lin(rng, 16, 48, bias)]
    s32 = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    s48 = rng.uniform(0.5, 2.0, 48).astype(np.float32)
    _assert_tree_close(T.scale_fc_fc(tt(fc1), tt(fc2), tt(s32)),
                       JT.scale_fc_fc(fc1, fc2, jnp.asarray(s32)))
    _assert_tree_close(T.scale_ln_fcs(tt(ln), tt(fcs), tt(s48)),
                       JT.scale_ln_fcs(ln, fcs, jnp.asarray(s48)))
    _assert_tree_close(T.shift_fc_fc(tt(fc1), tt(fc2), tt(s32)),
                       JT.shift_fc_fc(fc1, fc2, jnp.asarray(s32)))
    _assert_tree_close(T.shift_ln_fcs(tt(ln), tt(fcs), tt(s48), bias),
                       JT.shift_ln_fcs(ln, fcs, jnp.asarray(s48), bias))
    _assert_tree_close(T.fuse_ln_fcs(tt(ln), tt(fcs)),
                       JT.fuse_ln_fcs(ln, fcs))


def test_gqa_scale_transform_matches():
    rng = np.random.RandomState(1)
    v, o = _lin(rng, 32, 64, True), _lin(rng, 64, 64, False)   # 2 kv x 16
    s = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    np.testing.assert_array_equal(
        T.repeat_gqa_scales(tt(s), 2, 2).numpy(),
        np.asarray(JT.repeat_gqa_scales(jnp.asarray(s), 2, 2)))
    _assert_tree_close(
        T.scale_fc_fc(tt(v), tt(o), tt(s), gqa_repeat=(2, 2)),
        JT.scale_fc_fc(v, o, jnp.asarray(s), gqa_repeat=(2, 2)))


def test_rotation_and_mean_transforms_match():
    rng = np.random.RandomState(2)
    fc, emb = _lin(rng, 24, 32, True), {'w': _lin(rng, 40, 32, False)['w']}
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    q24, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    q, q24 = q.astype(np.float64), q24.astype(np.float64)
    tq = torch.from_numpy(q)
    _assert_tree_close(T.rotate_pre_layer(tt(fc), tq),
                       JT.rotate_pre_layer(fc, q))
    _assert_tree_close(T.rotate_post_layer(tt(fc), torch.from_numpy(q24)),
                       JT.rotate_post_layer(fc, q24))
    _assert_tree_close(T.rotate_embedding(tt(emb), tq),
                       JT.rotate_embedding(emb, q))
    _assert_tree_close(T.remove_mean_from_embed(tt(emb)),
                       JT.remove_mean_from_embed(emb))
    _assert_tree_close(T.bake_mean_into_fc(tt(fc)),
                       JT.bake_mean_into_fc(fc))


# --------------------------------------------------------------------------
# captures, AWQ search, clip search
# --------------------------------------------------------------------------

def test_first_block_input_and_captures_match():
    ja, ta = both('RTN', W4)
    assert len(ta.inputs) == len(ja.inputs) == 2 and ta.n_samples == 4
    for jx, tx in zip(ja.inputs, ta.inputs):
        assert rel_err(tx.numpy(), np.asarray(jx)) <= 1e-6
    jouts, jfeats = ja.block_forward_capture(ja.model.blocks[0])
    touts, tfeats = ta.block_forward_capture(ta.model.blocks[0])
    assert set(tfeats) == set(jfeats) == {'qkv_in', 'o_in', 'mlp_in',
                                          'down_in'}
    for k in jfeats:
        for jf, tf in zip(jfeats[k], tfeats[k]):
            assert tuple(tf.shape) == jf.shape
            assert rel_err(tf.numpy(), np.asarray(jf)) <= 1e-5
    for jo, to in zip(jouts, touts):
        assert rel_err(to.numpy(), np.asarray(jo)) <= 1e-5


def test_padding_mask_bias_and_positions_match():
    jm = JAdapter.random(JConfig(**TINY), seed=3)
    tm = LlamaAdapter(LlamaConfig(**TINY), port_params(jm.params))
    ids = np.random.RandomState(0).randint(0, 128, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[0, :4] = 0                               # left padding
    jx, jkw = jm.embed_and_rope_p(jm.params, jnp.asarray(ids),
                                  jnp.asarray(mask))
    tx, tkw = tm.embed_and_rope_p(tm.params, torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    assert set(tkw) == set(jkw) == {'cos', 'sin', 'attn_bias'}
    for k in jkw:
        assert rel_err(tkw[k].numpy(), np.asarray(jkw[k])) <= 1e-6
    jy = jm.block_fn()(jm.blocks[0], jx, jkw)[0]
    ty = tm.block_fn()(tm.blocks[0], tx, tkw)[0]
    assert rel_err(ty.numpy(), np.asarray(jy)) <= 1e-5


@pytest.mark.parametrize('weight,version,gqa', [
    (W4, 'v2', False), (W4_SYM, 'v1', False), (W4, 'v2', True)])
def test_awq_subset_search_matches(weight, version, gqa):
    """Every subset of block 0: the same best scales (and through them the
    same best ratio), and the same block after the transform."""
    special = dict(trans=True, trans_version=version, do_gqa_trans=gqa)
    ja, ta = both('Awq', weight, special)
    jblock, tblock = ja.model.blocks[0], ta.model.blocks[0]
    _, jfeats = ja.block_forward_capture(jblock)
    _, tfeats = ta.block_forward_capture(tblock)
    searched = 0
    for js, ts in zip(ja.layout.subsets, ta.layout.subsets):
        assert (ts.name, ts.layers, ts.prev_op) == \
            (js.name, js.layers, js.prev_op)
        if not js.do_trans or js.prev_op is None or \
                (js.is_gqa and ja.has_gqa and not gqa):
            continue
        jscales, jg = ja.search_scale_subset(0, jblock, js, jfeats)
        tscales, tg = ta.search_scale_subset(0, tblock, ts, tfeats)
        assert tg == jg
        assert rel_err(tscales.numpy(), np.asarray(jscales)) <= 1e-5
        jblock = ja.apply_scale_to_block(jblock, js, jscales, jg)
        tblock = ta.apply_scale_to_block(tblock, ts, tscales, tg)
        ja.update_input_feat(jfeats, js, jscales, jg)
        ta.update_input_feat(tfeats, ts, tscales, tg)
        searched += 1
    assert searched == (4 if gqa else 3)
    _assert_tree_close(tblock, jblock, 1e-5)


@pytest.mark.parametrize('version,sym', [('v1', True), ('v1', False),
                                         ('v2', True), ('v2', False)])
def test_auto_clipper_factors_match(version, sym):
    rng = np.random.RandomState(5)
    w = (rng.standard_normal((48, 64)) * 0.1).astype(np.float32)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    kw = dict(bit=4, symmetric=sym, granularity='per_group', group_size=32)
    jc = JAutoClipper(w_only=True, wspec=JQuantSpec(**kw), aspec=None,
                      clip_version=version, clip_sym=sym, save_clip=False)
    tc = AutoClipper(w_only=True, wspec=QuantSpec(**kw), aspec=None,
                     clip_version=version, clip_sym=sym, save_clip=False)
    jmax, jmin = jc.auto_clip_layer(jnp.asarray(w), jnp.asarray(x),
                                    n_sample_token=20)
    tmax, tmin = tc.auto_clip_layer(torch.from_numpy(w), torch.from_numpy(x),
                                    n_sample_token=20)
    assert tuple(tmax.shape) == jmax.shape == (48, 2)
    assert rel_err(tmax.numpy(), np.asarray(jmax)) <= 1e-6
    assert rel_err(tmin.numpy(), np.asarray(jmin)) <= 1e-6
    assert (np.asarray(jmax) < np.abs(w).reshape(48, 2, 32).max(-1)).any()


@pytest.mark.parametrize('version', ['v1', 'v2'])
def test_block_transform_with_clip_matches(version):
    """The whole per-block step (scale search, transform, clip) on both
    blocks, inputs chained."""
    special = dict(trans=True, weight_clip=True, clip_version=version)
    ja, ta = both('Awq', W4, special)
    ja.run_block_loop()
    ta.run_block_loop()
    _assert_tree_close(ta.model.params, ja.model.params, 1e-5)
    lin = ta.model.blocks[1]['mlp']['down_proj']
    assert ('clip_up' in lin) == (version == 'v2')
    for jx, tx in zip(ja.inputs, ta.inputs):
        assert rel_err(tx.numpy(), np.asarray(jx)) <= 1e-5


def test_search_artifacts_match(tmp_path):
    """scales.pkl and clips.pkl (the artifacts of a two-stage pipeline):
    the same keys and, as numpy arrays, the same values."""
    import pickle
    special = dict(trans=True, weight_clip=True, clip_version='v2',
                   save_scale=True, save_clip=True)
    objs = {}
    for name, special_n in (('j', dict(special, scale_path=str(tmp_path / 'j'),
                                       clip_path=str(tmp_path / 'j'))),
                            ('t', dict(special, scale_path=str(tmp_path / 't'),
                                       clip_path=str(tmp_path / 't')))):
        ja, ta = both('Awq', W4, special_n)
        (ja if name == 'j' else ta).run_block_loop()
        for f in ('scales.pkl', 'clips.pkl'):
            with open(tmp_path / name / f, 'rb') as fh:
                objs[name, f] = pickle.load(fh)
    js, ts = objs['j', 'scales.pkl'], objs['t', 'scales.pkl']
    assert set(ts) == set(js) and len(ts) == 2 * 6   # o_proj: GQA, skipped
    for k in js:
        assert isinstance(ts[k], np.ndarray)
        assert rel_err(ts[k], js[k]) <= 1e-5
    jc, tc = objs['j', 'clips.pkl'], objs['t', 'clips.pkl']
    assert set(tc) == set(jc) == {0, 1}
    for b in jc:
        assert set(tc[b]) == set(jc[b])
        for k, want in jc[b].items():
            _assert_tree_close(tc[b][k], want, 1e-5)


def test_true_sequential_matches():
    ja, ta = both('Awq', W4, dict(trans=True, true_sequential=True))
    ja.run_block_loop()
    ta.run_block_loop()
    _assert_tree_close(ta.model.params, ja.model.params, 1e-5)


class _WordTokenizer:
    """Whitespace words -> ids, enough for the text preprocessors."""

    def __call__(self, text, **kw):
        return {'input_ids': [len(w) % 97 + 3 * (ord(w[0]) % 7)
                              for w in text.split()]}


@pytest.mark.parametrize('preproc,bs,padding', [
    ('random_truncate_txt', -1, False), ('random_truncate_txt', 2, False),
    ('original_txt', 2, True), ('txt_general_preproc', 1, False)])
def test_custom_txt_calibration_batches_match(tmp_path, preproc, bs,
                                              padding):
    """A text file through both packages' preprocessors and batching: the
    same token arrays and padding masks (python's ``random`` is seeded the
    same way in both)."""
    rng = np.random.RandomState(0)
    words = ['alpha', 'be', 'gamma', 'delta', 'epsilon', 'zeta', 'eta']
    lines = [' '.join(rng.choice(words, size=rng.randint(12, 30)))
             for _ in range(12)]
    path = tmp_path / 'calib.txt'
    path.write_text('\n'.join(lines))
    cfg = dict(name='custom_txt', path=str(path), n_samples=4, bs=bs,
               seq_len=10, preproc=preproc, padding=padding, seed=5)
    jb, jm = JCalibDataset(cfg, _WordTokenizer()).get_calib_dataset()
    tb, tm = CalibDataset(cfg, _WordTokenizer()).get_calib_dataset()
    assert len(tb) == len(jb) > 0 and (tm is None) == (jm is None)
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if padding:
        assert tb[0]['attention_mask'].min() == 0


def test_unported_calibration_sources_raise():
    """The sources of the models still to port raise with their ROADMAP
    item; the VLM slices' synthetic sources, which raised until their
    slices ported them, draw the JAX package's batches."""
    for name in ('synthetic_mllama', 't2v'):
        with pytest.raises(NotImplementedError, match='ROADMAP A13'):
            CalibDataset(dict(name=name, n_samples=1, seq_len=4), None)
    for name in ('synthetic_vlm', 'synthetic_img', 'synthetic_videollava',
                 'synthetic_qwen2vl', 'synthetic_onevision',
                 'synthetic_onevision_video'):
        cfg = dict(name=name, n_samples=2, seq_len=24, seed=3, vocab_size=60,
                   image_token=60, video_token=61, image_seq_length=4,
                   image_size=28, num_frames=3, vision_start_token=62,
                   patch_dim=24, patch_size=7)
        jb, jm = JCalibDataset(cfg, None).get_calib_dataset()
        tb, tm = CalibDataset(cfg, None).get_calib_dataset()
        assert jm is tm is None and len(tb) == len(jb) == 2
        for a, b in zip(jb, tb):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match='from disk only'):
        CalibDataset(dict(name='pileval', download=True, n_samples=1,
                          seq_len=4), None)


# --------------------------------------------------------------------------
# deploy
# --------------------------------------------------------------------------

def _qmap_entries(qmap):
    out = {}
    for path, qc in qmap._d.items():
        if qc is None:
            out[path] = None
            continue
        d = {f.name: getattr(qc, f.name) for f in dataclasses.fields(qc)}
        for k in ('w_spec', 'a_spec'):
            if d[k] is not None:
                d[k] = dataclasses.asdict(d[k])
        out[path] = d
    return out


def test_deploy_fake_quant_qmap_equal_field_by_field():
    ja, ta = both('RTN', W4)
    jq, tq = ja.deploy('fake_quant'), ta.deploy('fake_quant')
    je, te = _qmap_entries(jq), _qmap_entries(tq)
    assert te == je and len(te) == 7
    assert te['mlp.down_proj']['w_spec']['group_size'] == 32
    assert ta.model.qmap is tq
    assert _qmap_entries(ta.deploy('transformed')) == \
        _qmap_entries(ja.deploy('transformed')) == {}
    with pytest.raises(ValueError, match='unknown quant_format'):
        ta.deploy('real_quant')


def test_ignored_layers_bake_and_qmap_match():
    ignored = dict(ignored_layers=dict(block_ids=[1],
                                       layer_names=['mlp.down_proj']))
    ja, ta = both('RTN', W4, **ignored)
    assert ta.layer_is_ignored(1, 'mlp.down_proj') and \
        not ta.layer_is_ignored(0, 'mlp.down_proj')
    ja.run_block_loop()
    ta.run_block_loop()
    before = ta.model.blocks[1]['mlp']['down_proj']['w'].clone()
    je, te = _qmap_entries(ja.deploy('fake_quant')), \
        _qmap_entries(ta.deploy('fake_quant'))
    assert te == je and all(v is None for v in te.values())
    _assert_tree_close(ta.model.params, ja.model.params, 1e-6)
    assert torch.equal(ta.model.blocks[1]['mlp']['down_proj']['w'], before)
    assert not torch.equal(ta.model.blocks[0]['mlp']['down_proj']['w'],
                           port_params(JAdapter.random(
                               JConfig(**TINY), seed=3).params
                           )['blocks'][0]['mlp']['down_proj']['w'])


@pytest.mark.parametrize('quant,item', [
    (dict(weight=W4, act=dict(bit=8, symmetric=True,
                              granularity='per_token')), None),
    (dict(weight=dict(W4, bit=48)), None),
    # the id it had while the ShadowKV policy raised with its item
    pytest.param(dict(weight=W4, kvcache=dict(method='ShadowKV')), None,
                 id='quant2-ROADMAP A11'),
    (dict(weight=W4, kvcache=dict(method='Kivi', bit=4)), None),
    (dict(weight=W4, special=dict(online_rotate=True)), None),
])
def test_options_outside_the_slice_raise_with_their_roadmap_item(quant,
                                                                 item):
    """Activation quantization, ``bit: 48``, the online rotation and the
    KV-cache policies (a quantizer, and the ShadowKV policy), which raised
    until they were ported, build the policy the reference builds (and
    the same KV policy, field for field)."""
    cfg = dict(model=dict(type='Llama'), quant=dict(quant, method='RTN'))
    tm = LlamaAdapter.random(LlamaConfig(**TINY), seed=0, device='cpu')
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            RTN(tm, Cfg(cfg)['quant'], {'data': [], 'kwargs': []}, None,
                Cfg(cfg))
        return
    jm = JAdapter.random(JConfig(**TINY), seed=0)
    jcfg = dict(cfg, quant=dict(cfg['quant']))
    ja = JRTN(jm, JCfg(jcfg)['quant'], {'data': [], 'kwargs': []}, None,
              JCfg(jcfg))
    ta = RTN(tm, Cfg(cfg)['quant'], {'data': [], 'kwargs': []}, None,
             Cfg(cfg))
    te, je = _qmap_entries(ta.fake_quant_qmap(0)), \
        _qmap_entries(ja.fake_quant_qmap(0))
    assert te == je and len(te) == 7
    assert (ta.kv_module is None) == (ja.kv_module is None)
    if ta.kv_module is not None:
        assert type(ta.kv_module).__name__ == type(ja.kv_module).__name__
        assert dataclasses.asdict(ta.kv_module) == \
            dataclasses.asdict(ja.kv_module)
    tt, jt = ta.transform_qmap(), ja.transform_qmap()
    assert (tt is None) == (jt is None)
    if tt is not None:
        assert _qmap_entries(tt) == _qmap_entries(jt)
