"""Port parity of the token-reduction operators
(llmc_tpu_torch/compression/token_reduction.py) and of their wiring into
the Llava and Video-LLaVA forwards.  Each operator runs on seeded numpy
inputs through both packages: selected indices exactly equal, merged
values within 1e-5.  Each method then runs through both packages'
forwards on the same weights (f32 logits within 1e-5, the same reduced
length)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.compression import token_reduction as JT
from llmc_tpu_torch.compression import token_reduction as TT
from torch_port_helpers import vlm_pair

torch.set_num_threads(1)
TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _probs(rng, B, H, S):
    s = rng.randn(B, H, S, S).astype(np.float32)
    e = np.exp(s - s.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _cases():
    """operator name -> (reference fn, port fn, args maker, kwargs); each
    maker gives numpy arrays (converted per package) and scalars."""
    def fastv(rng):
        return (rng.randn(2, 16, 8).astype(np.float32), _probs(rng, 2, 2, 16),
                (4, 12), 3)

    def tome(rng):
        return (rng.randn(2, 16, 8).astype(np.float32), 3)

    def divprune(rng):
        return (rng.randn(2, 12, 6).astype(np.float32), 5)

    def fastervlm(rng):
        return (rng.rand(2, 3, 16).astype(np.float32), 5)

    def visionzip(rng):
        return (rng.randn(2, 17, 16).astype(np.float32),
                _probs(rng, 2, 2, 17), rng.randn(2, 17, 8).astype(np.float32),
                4, 3)

    def dpc(rng):
        return (rng.randn(2, 12, 8).astype(np.float32), 3)

    def sparsevlm(rng):
        return (_probs(rng, 1, 2, 20), 2, 10, 12)

    def pyramiddrop(rng):
        return (rng.randn(1, 20, 2, 8).astype(np.float32),
                rng.randn(1, 20, 2, 8).astype(np.float32), 13, 3, 11)

    def dycoke(rng):
        return (rng.randn(6 * 8, 16).astype(np.float32), 8, 0.5)

    def dart(rng):
        return (rng.randn(24, 16).astype(np.float32),
                rng.randn(24, 32).astype(np.float32), 2, 16, 2, 2, 0.5)

    def mustdrop(rng):
        x = rng.randn(2, 17, 8).astype(np.float32)
        x[:, 1:5] = x[:, 1:2] + 0.01 * rng.randn(2, 4, 8)  # a similar window
        return (x, 0.3)

    def dpc_assign(rng):
        return (rng.randn(10, 8).astype(np.float32), 3)

    def prunevid(rng):
        base = rng.randn(1, 20, 8).astype(np.float32)
        frames = np.repeat(base, 4, 0) + 0.3 * rng.randn(4, 20, 8)
        return (frames.astype(np.float32), 0.6, 0.5, 0.5)

    def fastvid(rng):
        return (rng.randn(6, 16, 8).astype(np.float32),
                rng.rand(6, 16).astype(np.float32),
                rng.randn(6, 8).astype(np.float32))

    def holitom(rng):
        base = rng.randn(1, 16, 8).astype(np.float32)
        frames = np.repeat(base, 6, 0) + 0.2 * rng.randn(6, 16, 8)
        return (frames.astype(np.float32), rng.rand(6, 16).astype(np.float32))
    return {
        'FastV.fastv_prune': (JT.fastv_prune, TT.fastv_prune, fastv, {}),
        'ToMe.tome_merge': (JT.tome_merge, TT.tome_merge, tome, {}),
        'DivPrune.divprune_select': (JT.divprune_select, TT.divprune_select,
                                     divprune, {}),
        'FasterVLM.fastervlm_select': (JT.fastervlm_select,
                                       TT.fastervlm_select, fastervlm, {}),
        'VisionZip.visionzip_reduce': (JT.visionzip_reduce,
                                       TT.visionzip_reduce, visionzip, {}),
        'SparseVLM.dpc_cluster_merge': (JT.dpc_cluster_merge,
                                        TT.dpc_cluster_merge, dpc, {}),
        'SparseVLM.sparsevlm_rate': (JT.sparsevlm_rate, TT.sparsevlm_rate,
                                     sparsevlm, {}),
        'PyramidDrop.pyramiddrop_rate': (JT.pyramiddrop_rate,
                                         TT.pyramiddrop_rate, pyramiddrop,
                                         {}),
        'DyCoke.dycoke_ttm': (JT.dycoke_ttm, TT.dycoke_ttm, dycoke, {}),
        'DART.dart_keep_indices': (JT.dart_keep_indices,
                                   TT.dart_keep_indices, dart, {}),
        'MustDrop.mustdrop_spatial_merge': (JT.mustdrop_spatial_merge,
                                            TT.mustdrop_spatial_merge,
                                            mustdrop, {}),
        'PruneVid.dpc_assign': (JT.dpc_assign, TT.dpc_assign, dpc_assign, {}),
        'PruneVid.prunevid_merge': (JT.prunevid_merge, TT.prunevid_merge,
                                    prunevid, {}),
        'FastVID.fastvid_prune': (JT.fastvid_prune, TT.fastvid_prune, fastvid,
                                  dict(DySeg_c=2, DySeg_tau=0.1,
                                       retention_ratio=0.5, STPrune_d=0.5,
                                       DTM_p=2, DTM_alpha=0.3)),
        'HoliTom.holitom_merge': (JT.holitom_merge, TT.holitom_merge, holitom,
                                  dict(tau=0.5, retain_ratio=0.5)),
    }


CASES = _cases()


@pytest.mark.parametrize('name', sorted(CASES))
def test_operator_matches_reference(name):
    jfn, tfn, build, kw = CASES[name]
    args = build(np.random.RandomState(sorted(CASES).index(name)))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    want, got = jfn(*jargs, **kw), tfn(*targs, **kw)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(got, want)


def test_every_method_has_an_operator_case():
    methods = {n.split('.')[0] for n in CASES}
    assert methods == set(TT.TOKEN_REDUCTION_METHODS)
    assert len(TT.TOKEN_REDUCTION_METHODS) == 13


# the wiring cases of the reference's tests (tests/test_llava.py,
# test_token_reduction.py, test_videollava_qwen.py) at the tiny Llava's
# 16-token image span and Video-LLaVA's 4 frames of 4 tokens
IMAGE_WIRINGS = {
    'FastV': {'prune_layer': 1, 'keep': 5},
    'FasterVLM': {'method': 'FasterVLM', 'keep': 6},
    'VisionZip': {'method': 'VisionZip', 'dominant': 4, 'contextual': 3},
    'MustDrop': {'method': 'MustDrop', 'spatial_threshold': -1.0},
    'DART': {'method': 'DART', 'pruning_loc': 1, 'pivot_image_token': 1,
             'pivot_text_token': 1, 'reduction_ratio': 0.5},
    'SparseVLM': {'method': 'SparseVLM', 'pruning_loc': [1],
                  'retained_tokens': 64},
    'PyramidDrop': {'method': 'PyramidDrop', 'layer_list': [1, 2],
                    'image_token_ratio_list': [0.5, 0.25]},
}
VIDEO_WIRINGS = {
    'DyCoke': {'method': 'DyCoke', 'merging_ratio': 0.5},
    'PruneVid': {'method': 'PruneVid', 'taus': 0.5, 'cluster_ratios': 0.5,
                 'temporal_segment_ratios': 0.25},
    'FastVID': {'method': 'FastVID', 'fastvid_retention_ratio': 0.5,
                'fastvid_DySeg_c': 2},
    'HoliTom': {'method': 'HoliTom', 'holitom_retain_ratio': 0.5},
}


@pytest.fixture(scope='module')
def pairs():
    return {'Llava': vlm_pair('Llava'), 'VideoLlava': vlm_pair('VideoLlava')}


def _inputs(cfg, video, seed=4):
    rng = np.random.RandomState(seed)
    span = cfg.num_frames * cfg.image_seq_length if video \
        else cfg.image_seq_length
    ids = rng.randint(0, 69, size=(1, span + 8)).astype(np.int32)
    ids[0, 1:1 + span] = cfg.video_token_index if video \
        else cfg.image_token_index
    if video:
        one = rng.randn(1, 1, 3, cfg.image_size, cfg.image_size)
        # similar frames: the temporal methods have static content to merge
        px = (np.repeat(one, cfg.num_frames, axis=1) + 0.1 * rng.randn(
            1, cfg.num_frames, 3, cfg.image_size, cfg.image_size))
        return ids, {'pixel_values_videos': px.astype(np.float32)}
    return ids, {'pixel_values': rng.randn(
        1, 3, cfg.image_size, cfg.image_size).astype(np.float32)}


@pytest.mark.parametrize('method', sorted(IMAGE_WIRINGS)
                         + sorted(VIDEO_WIRINGS))
def test_wiring_matches_reference(pairs, method):
    video = method in VIDEO_WIRINGS
    jm, tm = pairs['VideoLlava' if video else 'Llava']
    tr = (VIDEO_WIRINGS if video else IMAGE_WIRINGS)[method]
    ids, img = _inputs(tm.llava_cfg, video)
    want = np.asarray(jm.forward_logits(
        jnp.asarray(ids), None, token_reduction=tr,
        **{k: jnp.asarray(v) for k, v in img.items()}))
    got = tm.forward_logits(torch.as_tensor(ids), None, token_reduction=tr,
                            **{k: torch.as_tensor(v) for k, v in img.items()})
    assert got.shape == want.shape, method
    # SparseVLM recycles merged tokens: at this span it keeps the length
    assert got.shape[1] < ids.shape[1] or method == 'SparseVLM', method
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('method', ['ToMe', 'DivPrune'])
def test_unwired_methods_raise(pairs, method):
    """The reference's Llava forward has no branch for ToMe and DivPrune
    and runs them unreduced; the port raises (ROADMAP C)."""
    _, tm = pairs['Llava']
    ids, img = _inputs(tm.llava_cfg, False)
    with pytest.raises(NotImplementedError, match='ROADMAP C'):
        tm.forward_logits(torch.as_tensor(ids), None,
                          token_reduction={'method': method},
                          pixel_values=torch.as_tensor(img['pixel_values']))


def test_token_reduction_algorithm_installs_its_config(pairs):
    from llmc_tpu_torch.utils import ALGO_REGISTRY
    _, tm = pairs['Llava']
    cls = ALGO_REGISTRY['TokenReduction']
    with pytest.raises(KeyError):
        cls.check_special({'method': 'NoSuchMethod'})
    special = {'method': 'FastV', 'prune_layer': 1, 'keep': 2}
    algo = cls(tm, {'method': 'TokenReduction', 'special': special},
               {'data': [], 'kwargs': []}, None, {})
    algo.run_block_loop()
    assert tm.token_reduction == special and algo.deploy('fake_quant') is None
    del tm.token_reduction
