"""The towers' QMap fault of the reference's second VLM slice, which the
port keeps apart from (ROADMAP C), pinned against the reference.

A deploy's QMap keys its linears by path alone and the towers' block
linears carry the LM's names.  The reference's Qwen2-VL, InternVL and
OneVision image forwards hand their tower no QMap, so a calibrated
tower (``quant.vision``) reaches no eval; OneVision's video forward and
MiniCPM-V's hand it the LM's QMap, so the LM's policy quantizes the tower
and a packed LM's QMap sends the tower's unpacked linears to the packed
path.  In the port every tower reads only a ``ModalQMap``'s ``vision``
QMap (``models/llava.py::vision_qmap``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vlm2_serve import CASES, _pair, image_inputs

torch.set_num_threads(1)

# the reference hands these towers no QMap; the others the LM's
GIVEN_NONE = ('Qwen2vl', 'InternVL2', 'LlavaOneVision')


def _qmaps(linears, bit):
    """The same per-channel ``bit``-bit weight QMap over ``linears`` in
    both packages."""
    from llmc_tpu.models import LinearQcfg as JQcfg
    from llmc_tpu.models import QMap as JQMap
    from llmc_tpu.quant import QuantSpec as JSpec
    from llmc_tpu_torch.models import LinearQcfg, QMap
    from llmc_tpu_torch.quant.qspec import QuantSpec
    kw = dict(bit=bit, symmetric=False, granularity='per_channel')
    return (JQMap({p: JQcfg(w_spec=JSpec(**kw)) for p in linears}),
            QMap({p: LinearQcfg(w_spec=QuantSpec(**kw)) for p in linears}))


def _jax_kw(img):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in img.items()}


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize('case', CASES)
def test_each_tower_takes_only_its_own_qmap(case):
    """The deploy of a two-modality calibration: the LM W8 (``lm``) and the
    tower's own 2-bit QMap (``tower``), both per-channel over the LM's
    linear names.  The reference's forward under its deploy (the LM's
    QMap) equals the port's with no QMap on the tower (Qwen2-VL, InternVL,
    OneVision's image) or with the LM's on it (OneVision's video,
    MiniCPM-V); the port's under ``ModalQMap(lm, tower)`` moves with the
    tower's own QMap."""
    from llmc_tpu_torch.models import ModalQMap
    jm, tm = _pair(case, seed=1)
    linears = tm.get_layout().linears
    j_lm, t_lm = _qmaps(linears, 8)
    t_tw = _qmaps(linears, 2)[1]
    ids, img = image_inputs(case, tm.vl_cfg, seed=2)
    jids, jimg = jnp.asarray(ids), _jax_kw(img)
    with torch.no_grad():
        port = tm.forward_logits(ids, qmap=ModalQMap(t_lm, t_tw), **img)
        port_lm = tm.forward_logits(ids, qmap=t_lm, **img)
        port_lm_on_tower = tm.forward_logits(
            ids, qmap=ModalQMap(t_lm, t_lm), **img)
    ref = np.asarray(jm.forward_logits(jids, qmap=j_lm, **jimg))
    if case in GIVEN_NONE:
        # the reference's tower is unquantized: the port's under the LM's
        # QMap alone
        np.testing.assert_allclose(port_lm.numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    else:
        # the reference's tower takes the LM's QMap
        np.testing.assert_allclose(port_lm_on_tower.numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
        assert _gap(port_lm.numpy(), ref) > 1e-3
    # the tower's own QMap moves the logits in the port, not in the
    # reference's deploy
    shift = _gap(port.numpy(), port_lm.numpy())
    print(f'{case}: the reference\'s logits under its deploy are '
          f'{_gap(port.numpy(), ref):.4g} (max abs) from the port\'s with '
          f'the tower under its own 2-bit QMap; the tower\'s QMap moves the '
          f'port\'s logits by {shift:.4g}')
    assert shift > 1e-2


@pytest.mark.parametrize('case', [c for c in CASES if c not in GIVEN_NONE])
def test_packed_towers_take_no_lm_qmap(case):
    """``pack_model`` (W4 g16, unfused, the head unpacked: the reference's
    eager graph takes neither) on both packages: where the reference hands
    the tower the packed QMap (OneVision's video, MiniCPM-V) its forward
    raises ``KeyError: 'qweight'`` at the tower's first linear; the port's
    packed forward runs, its tower unquantized (the other three models'
    packed forwards: ``test_torch_vlm2_serve.py``)."""
    from llmc_tpu.quant import QuantSpec as JSpec
    from llmc_tpu.serve.packed import pack_model as j_pack
    from llmc_tpu_torch.quant.qspec import QuantSpec
    from llmc_tpu_torch.serve import pack_model
    jm, tm = _pair(case, seed=6)
    kw = dict(bit=4, symmetric=False, granularity='per_group', group_size=16)
    jq = j_pack(jm, JSpec(**kw))
    tq = pack_model(tm, QuantSpec(**kw))
    ids, img = image_inputs(case, tm.vl_cfg, seed=7)
    with torch.no_grad():
        got = tm.forward_logits(ids, qmap=tq, **img)
    assert bool(torch.isfinite(got).all())
    with pytest.raises(KeyError, match='qweight'):
        jm.forward_logits(jnp.asarray(ids), qmap=jq, **_jax_kw(img))
    # the port's tower runs unquantized: block 0's input is the unpacked
    # model's, bit for bit
    _, plain = _pair(case, seed=6)
    x = tm._first_input(dict(input_ids=ids, **img))[0]
    assert torch.equal(x, plain._first_input(dict(input_ids=ids, **img))[0])
