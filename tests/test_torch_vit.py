"""Port parity of ViT (llmc_tpu_torch/models/vit.py, ``VitAdapter``,
``AccuracyEval``): the classifier's f32 logits against llmc_tpu within
1e-5, the W8A8 quantized-attention path (the pseudo-paths of the
attention matmuls, the softmax and the act-fn), the accuracy eval, and a
transformers-written checkpoint."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import vlm_pair

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope='module')
def vit():
    return vlm_pair('Vit')


def _pixels(n, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def _qmaps(pseudo, a_bit=8, gran='per_token', w_spec=True):
    """The same policy in both packages: W8 per-channel on every linear
    (``w_spec``) and an ``a_bit`` activation spec on the ``pseudo``
    paths."""
    from llmc_tpu.models import LinearQcfg as JQcfg
    from llmc_tpu.models import QMap as JQMap
    from llmc_tpu.quant import QuantSpec as JSpec
    from llmc_tpu_torch.models import LinearQcfg, QMap
    from llmc_tpu_torch.quant.qspec import QuantSpec
    out = []
    for Q, C, S in ((JQMap, JQcfg, JSpec), (QMap, LinearQcfg, QuantSpec)):
        a = C(a_spec=S(bit=a_bit, symmetric=True, granularity=gran))
        w = C(w_spec=S(bit=8, symmetric=True, granularity='per_channel'),
              a_spec=S(bit=8, symmetric=True, granularity='per_token'))
        out.append(Q({p: a for p in pseudo}, default=w if w_spec else None))
    return out


def test_classify_matches_reference(vit):
    jm, tm = vit
    px = _pixels(3)
    want = np.asarray(jm.classify(jnp.asarray(px)))
    got = tm.classify(torch.as_tensor(px))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


PSEUDO = ('attention.matmul_1', 'attention.matmul_2', 'attention.softmax',
          'act_fn')


@pytest.mark.parametrize('pseudo,a_bit,gran', [
    (PSEUDO, 8, 'per_token'),
    (PSEUDO[:1], 2, 'per_tensor'), (PSEUDO[1:2], 2, 'per_tensor'),
    (PSEUDO[2:3], 2, 'per_tensor'), (PSEUDO[3:], 2, 'per_tensor')])
def test_quantized_attention_matches_reference(vit, pseudo, a_bit, gran):
    """W8A8 with the quantized attention (every pseudo-path), and each
    pseudo-path alone at 2 bits, where it must move the logits."""
    jm, tm = vit
    px = _pixels(2, seed=1)
    jq, tq = _qmaps(pseudo, a_bit, gran, w_spec=a_bit == 8)
    want = np.asarray(jm.classify(jnp.asarray(px), qmap=jq))
    got = tm.classify(torch.as_tensor(px), qmap=tq).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if a_bit == 2:
        assert not np.allclose(got, tm.classify(torch.as_tensor(px)).numpy())


def test_accuracy_eval_matches_reference(vit):
    from llmc_tpu.models.adapter import AccuracyEval as JAcc
    from llmc_tpu_torch.models.adapter import AccuracyEval
    jm, tm = vit
    px = _pixels(12, seed=2)
    labels = np.asarray(jnp.argmax(jm.classify(jnp.asarray(px)), -1))
    jq, tq = _qmaps((), w_spec=True)
    jacc, tacc = JAcc(px, labels, bs=5), AccuracyEval(px, labels, bs=5)
    assert tacc.eval(tm) == jacc.eval(jm) == 1.0
    np.testing.assert_array_equal(
        tacc.predictions(tm, qmap=tq),
        np.asarray(jnp.argmax(jm.classify(jnp.asarray(px), qmap=jq), -1)))
    assert tacc.eval(tm, qmap=tq) == jacc.eval(jm, qmap=jq)


def test_from_pretrained_reads_a_transformers_vit(tmp_path):
    tr = pytest.importorskip('transformers')
    from llmc_tpu.models.adapter import VitAdapter as JVit
    from llmc_tpu_torch.models import VitAdapter
    cfg = tr.ViTConfig(image_size=32, patch_size=8, num_channels=3,
                       hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_labels=10)
    torch.manual_seed(0)
    hf = tr.ViTForImageClassification(cfg).eval()
    hf.save_pretrained(tmp_path, safe_serialization=True)
    tm = VitAdapter.from_pretrained(str(tmp_path), device='cpu')
    jm = JVit.from_pretrained(str(tmp_path))
    px = _pixels(2, seed=3)
    got = tm.classify(torch.as_tensor(px)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.classify(jnp.asarray(px))),
                               rtol=TOL, atol=TOL)
    with torch.no_grad():
        ref = hf(torch.as_tensor(px)).logits.numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-3, atol=5e-3)
