"""Two faults of the reference's LLaVA tier the port keeps apart from
(ROADMAP C), each pinned against the reference:

- a language QMap also quantizes the CLIP tower: the tower's block linears
  carry the LM's path names and a QMap is keyed by path alone, so
  ``llava_embed`` hands the LM's QMap to ``vision_features``.  In the port
  the tower reads only a ``ModalQMap``'s ``vision`` QMap;
- the reference cannot serve a packed LLaVA: the packed QMap reaches the
  tower's unpacked linears (``KeyError: 'qweight'``).  The port serves it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import vlm_pair

torch.set_num_threads(1)


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    span = cfg.image_seq_length
    ids = rng.randint(0, 69, size=(1, span + 6)).astype(np.int32)
    ids[0, 1:1 + span] = cfg.image_token_index
    return ids, rng.randn(1, 3, cfg.image_size, cfg.image_size).astype(
        np.float32)


def _lm_qmaps(layout_linears, bit):
    """The same per-channel ``bit``-bit weight QMap over the LM's linears
    in both packages."""
    from llmc_tpu.models import LinearQcfg as JQcfg
    from llmc_tpu.models import QMap as JQMap
    from llmc_tpu.quant import QuantSpec as JSpec
    from llmc_tpu_torch.models import LinearQcfg, QMap
    from llmc_tpu_torch.quant.qspec import QuantSpec
    kw = dict(bit=bit, symmetric=False, granularity='per_channel')
    return (JQMap({p: JQcfg(w_spec=JSpec(**kw)) for p in layout_linears}),
            QMap({p: LinearQcfg(w_spec=QuantSpec(**kw))
                  for p in layout_linears}))


def test_language_qmap_leaves_the_tower_unquantized():
    """A 2-bit per-channel QMap over the LM's seven linears: the
    reference's merged image embeddings move (its tower is quantized);
    the port's stay bit for bit those of no QMap, and move only when the
    QMap is the tower's own (``ModalQMap(vision=...)``)."""
    from llmc_tpu.models import llava as JLV
    from llmc_tpu_torch.models import ModalQMap
    from llmc_tpu_torch.models import llava as TLV
    jm, tm = vlm_pair('Llava')
    jq, tq = _lm_qmaps(tm.get_layout().linears, 2)
    ids, px = _inputs(tm.llava_cfg)
    j_shift = float(np.abs(
        np.asarray(JLV.llava_embed(jm.params, jm.llava_cfg, jnp.asarray(ids),
                                   jnp.asarray(px), qmap=jq))
        - np.asarray(JLV.llava_embed(jm.params, jm.llava_cfg,
                                     jnp.asarray(ids), jnp.asarray(px)))
    ).max())
    ti, tp = torch.as_tensor(ids), torch.as_tensor(px)
    base = TLV.llava_embed(tm.params, tm.llava_cfg, ti, tp)
    t_shift = float((TLV.llava_embed(tm.params, tm.llava_cfg, ti, tp,
                                     qmap=tq) - base).abs().max())
    own = float((TLV.llava_embed(tm.params, tm.llava_cfg, ti, tp,
                                 qmap=ModalQMap(vision=tq)) - base
                 ).abs().max())
    print(f'merged-embedding shift under the LM QMap: reference {j_shift:.4g}'
          f', port {t_shift:.4g}; under the tower\'s own QMap {own:.4g}')
    assert j_shift > 1e-2 and t_shift == 0.0 and own > 1e-2
    # the text positions take no image feature: both packages equal there
    text = np.asarray(ids[0] != tm.llava_cfg.image_token_index)
    np.testing.assert_allclose(
        base.numpy()[0, text],
        np.asarray(JLV.llava_embed(jm.params, jm.llava_cfg, jnp.asarray(ids),
                                   jnp.asarray(px), qmap=jq))[0, text],
        rtol=1e-6, atol=1e-6)


def test_packed_llava_serves():
    """``pack_model`` of a LLaVA (W4 g16, fused qkv / gate_up, the head):
    the reference's cached generation raises ``KeyError: 'qweight'`` in
    the tower's first q_proj; the port's serves."""
    from llmc_tpu.quant import QuantSpec as JSpec
    from llmc_tpu.serve.decode import vlm_greedy_generate as j_generate
    from llmc_tpu.serve.packed import pack_model as j_pack
    from llmc_tpu_torch.quant.qspec import QuantSpec
    from llmc_tpu_torch.serve import pack_model
    from llmc_tpu_torch.serve.decode import vlm_greedy_generate
    jm, tm = vlm_pair('Llava', seed=4)
    kw = dict(bit=4, symmetric=False, granularity='per_group', group_size=16)
    jq = j_pack(jm, JSpec(**kw), fuse=True, head=True)
    tq = pack_model(tm, QuantSpec(**kw), fuse=True, head=True)
    ids, px = _inputs(tm.llava_cfg, seed=1)
    with pytest.raises(KeyError, match='qweight'):
        j_generate(jm, jnp.asarray(ids), 3, qmap=jq,
                   pixel_values=jnp.asarray(px))
    out = vlm_greedy_generate(tm, ids, 3, qmap=tq,
                              pixel_values=torch.as_tensor(px), device='cpu')
    assert out.shape == (1, ids.shape[1] + 3)
    assert int(out[:, -3:].max()) < tm.cfg.vocab_size
