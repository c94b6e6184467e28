"""Port parity of the LLaVA tier (llmc_tpu_torch/models/llava.py and its
adapters): the Llava and Video-LLaVA forwards against llmc_tpu on the same
weights (f32 logits within 1e-5), the text-only forward against the LM, a
transformers-written checkpoint loaded by both packages, and the weight
trees carried across by ``convert.params_from_numpy``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu_torch.convert import params_from_numpy, params_to_numpy
from llmc_tpu_torch.models import LlamaAdapter
from torch_port_helpers import assert_trees_equal, to_np, vlm_pair

torch.set_num_threads(1)
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def image_inputs(cfg, B=2, extra=8, seed=0):
    """Ids with the image span at position 1, and pixels."""
    rng = np.random.RandomState(seed)
    span = cfg.image_seq_length
    ids = rng.randint(0, 69, size=(B, 1 + span + extra)).astype(np.int32)
    ids[:, 1:1 + span] = cfg.image_token_index
    px = rng.randn(B, cfg.num_channels, cfg.image_size,
                   cfg.image_size).astype(np.float32)
    return ids, px


def video_inputs(cfg, extra=6, seed=0, with_image=False):
    rng = np.random.RandomState(seed)
    span = cfg.num_frames * cfg.image_seq_length
    n_img = cfg.image_seq_length if with_image else 0
    ids = rng.randint(0, 69, size=(1, 2 + span + n_img + extra)).astype(
        np.int32)
    ids[0, 2:2 + span] = cfg.video_token_index
    ids[0, 2 + span:2 + span + n_img] = cfg.image_token_index
    vids = rng.randn(1, cfg.num_frames, 3, cfg.image_size,
                     cfg.image_size).astype(np.float32)
    px = rng.randn(1, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    return ids, vids, (px if with_image else None)


@pytest.fixture(scope='module')
def llava():
    return vlm_pair('Llava')


@pytest.fixture(scope='module')
def videollava():
    return vlm_pair('VideoLlava')


def test_llava_forward_matches_reference(llava):
    jm, tm = llava
    ids, px = image_inputs(tm.llava_cfg)
    want = jm.forward_logits(jnp.asarray(ids), pixel_values=jnp.asarray(px))
    got = tm.forward_logits(torch.as_tensor(ids),
                            pixel_values=torch.as_tensor(px))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def test_llava_embeddings_and_features_match_reference(llava):
    """The tower's selected features, the projector and the merged
    embeddings, each against the reference."""
    from llmc_tpu.models import llava as JLV
    from llmc_tpu_torch.models import llava as TLV
    jm, tm = llava
    ids, px = image_inputs(tm.llava_cfg)
    jf = JLV.vision_features(jm.params['vision'], jm.llava_cfg,
                             jnp.asarray(px))
    tf = TLV.vision_features(tm.params['vision'], tm.llava_cfg,
                             torch.as_tensor(px))
    _close(tf, jf)
    _close(TLV.llava_embed(tm.params, tm.llava_cfg, torch.as_tensor(ids),
                           torch.as_tensor(px)),
           JLV.llava_embed(jm.params, jm.llava_cfg, jnp.asarray(ids),
                           jnp.asarray(px)))


@pytest.mark.parametrize('with_image', [False, True])
def test_videollava_forward_matches_reference(videollava, with_image):
    jm, tm = videollava
    ids, vids, px = video_inputs(tm.llava_cfg, with_image=with_image)
    want = jm.forward_logits(
        jnp.asarray(ids), None, pixel_values=None if px is None
        else jnp.asarray(px), pixel_values_videos=jnp.asarray(vids))
    got = tm.forward_logits(
        torch.as_tensor(ids), None, pixel_values=None if px is None
        else torch.as_tensor(px), pixel_values_videos=torch.as_tensor(vids))
    assert got.shape == want.shape
    _close(got, want)


def test_text_only_forward_is_the_language_model(llava):
    """Without pixels the Llava forward is its LM's: the same logits as a
    Llama adapter over the LM's params, and as the reference."""
    jm, tm = llava
    ids = np.random.RandomState(1).randint(0, 72, (2, 9))
    got = tm.forward_logits(torch.as_tensor(ids))
    lm = LlamaAdapter(tm.llava_cfg.text, tm.params)
    np.testing.assert_array_equal(got.numpy(), lm.forward_logits(
        torch.as_tensor(ids)).numpy())
    _close(got, jm.forward_logits(jnp.asarray(ids)))


def test_converter_carries_the_llava_and_vit_trees():
    """``params_from_numpy`` maps the Llava tree (the tower's patch conv,
    class embedding, positions, LayerNorms and blocks, the projector) and
    the ViT tree (its classifier too) leaf for leaf, None leaves kept."""
    for kind in ('Llava', 'Vit'):
        jm, _ = vlm_pair(kind)
        tree = to_np(jm.params)
        back = params_to_numpy(params_from_numpy(tree, device='cpu'))
        assert_trees_equal(back, tree)
        if kind == 'Llava':
            assert set(back['vision']) == {'patch_proj', 'class_emb',
                                           'pos_embed', 'pre_ln', 'post_ln',
                                           'blocks'}
            assert back['vision']['patch_proj']['b'] is None
            assert set(back['projector']) == {'linear_1', 'linear_2'}
        else:
            assert back['classifier']['w'].shape == (10, 64)


IMG = 28


@pytest.fixture(scope='module')
def hf_llava_dir(tmp_path_factory):
    """A tiny LlavaForConditionalGeneration written by transformers, as
    the JAX package's own test writes it (tests/test_llava.py)."""
    tr = pytest.importorskip('transformers')
    vision = tr.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, image_size=IMG, patch_size=14,
        projection_dim=32)
    text = tr.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=False)
    cfg = tr.LlavaConfig(vision_config=vision, text_config=text,
                         image_token_index=127, vision_feature_layer=-2,
                         vision_feature_select_strategy='default')
    torch.manual_seed(0)
    m = tr.LlavaForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp('tiny_llava')
    m.save_pretrained(d, safe_serialization=True)
    return str(d), m


def test_from_pretrained_reads_a_transformers_llava(hf_llava_dir):
    """Both packages load the checkpoint (in f32): the port's logits are
    the reference's within 1e-5, and HF's own within the reference's
    test tolerance (5e-3)."""
    from llmc_tpu.models.adapter import LlavaAdapter as JLlava
    from llmc_tpu_torch.models import LlavaAdapter
    path, hf = hf_llava_dir
    jm = JLlava.from_pretrained(path, dtype=jnp.float32)
    tm = LlavaAdapter.from_pretrained(path, dtype=torch.float32,
                                      device='cpu')
    assert tm.llava_cfg.image_seq_length == 4
    assert tm.llava_cfg.image_token_index == 127
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 120, size=(2, 12))
    ids[:, 2:6] = 127
    px = rng.randn(2, 3, IMG, IMG).astype(np.float32)
    got = tm.forward_logits(torch.as_tensor(ids),
                            pixel_values=torch.as_tensor(px))
    _close(got, jm.forward_logits(jnp.asarray(ids),
                                  pixel_values=jnp.asarray(px)))
    with torch.no_grad():
        ref = hf(input_ids=torch.as_tensor(ids),
                 pixel_values=torch.as_tensor(px)).logits.float()
    _close(got, ref.numpy(), tol=5e-3)


@pytest.mark.parametrize('name', [
    'Qwen2vl', 'InternVL2', 'LlavaOneVision', 'MiniCPMV', 'Vila', 'Mllama',
    'Glm4v', 'GLM4V', 'Qwen2Audio', 'InternOmni', 'WanT2V', 'WanI2V'])
def test_unported_vlm_names_raise_with_their_roadmap_item(name):
    """The reference registers these names.  The four of the second VLM
    slice (Qwen2-VL, InternVL, OneVision, MiniCPM-V), which raised until it
    ported them, build from a tiny inline arch; for the others the port
    raises ``NotImplementedError`` naming ROADMAP A13e (not the registry's
    ``KeyError``), from the registry and from ``build_model``."""
    import llmc_tpu.models  # noqa: F401  (registers the reference's names)
    from llmc_tpu.utils.registry import MODEL_REGISTRY as JREG
    from llmc_tpu_torch.models import build_model
    from llmc_tpu_torch.utils.registry import MODEL_REGISTRY
    from torch_port_helpers import VLM2_ARCHS
    assert name in JREG
    if name in VLM2_ARCHS:
        model = build_model({'model': {'type': name,
                                       'arch': VLM2_ARCHS[name]}},
                            device='cpu')
        assert isinstance(model, MODEL_REGISTRY[name])
        assert model.n_blocks == 2 and 'vision' in model.params
        return
    assert name not in MODEL_REGISTRY
    with pytest.raises(NotImplementedError, match='ROADMAP A13e'):
        MODEL_REGISTRY[name]
    with pytest.raises(NotImplementedError, match='ROADMAP A13e'):
        build_model({'model': {'type': name, 'arch': {}}}, device='cpu')
    with pytest.raises(KeyError):
        MODEL_REGISTRY['NoSuchModel']
