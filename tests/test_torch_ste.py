"""The port's straight-through rounding and the gradients of its
fake-quantizers against ``jax.grad`` of the JAX package's, at float32 on
the CPU: ``ste_round`` forward bit-equal to ``jnp.round`` on halves and
the identity backward; ``clip`` splitting the gradient of an element on
a bound as ``jnp.clip`` does (``torch.clamp`` passes all of it); the
gradients of ``fake_quant_weight`` with straight-through rounding in the
learnable clip factors and the weight, and of ``fake_quant_act`` in the
activation, on tensors where codes round exactly onto ``qmin`` and
``qmax``; and AdaDim's input-channel fake-quant (``dim_ic``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmc_tpu.quant import quantizer as JQ
from llmc_tpu.quant.qspec import QuantSpec as JSpec
from llmc_tpu_torch.quant import quantizer as TQ
from llmc_tpu_torch.quant.qspec import QuantSpec

torch.set_num_threads(1)

# every gradient within 1e-6 of jax.grad's (absolute, and 1e-6 relative
# for the weight's gradients of order 1): the same f32 operations, summed
# in another order
TOL_GRAD = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL_GRAD, atol=TOL_GRAD)


def test_ste_round_bit_equal_on_halves_and_identity_backward():
    x = np.concatenate([np.arange(-8.5, 9.0, 1.0),
                        np.random.RandomState(0).randn(64) * 7]
                       ).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = TQ.ste_round(tx)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(JQ.ste_round(jnp.asarray(x))))
    c = np.random.RandomState(1).randn(x.size).astype(np.float32)
    (y * torch.tensor(c)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(JQ.ste_round(v) * c))(jnp.asarray(x))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), c)


def test_clip_splits_a_tie_like_jnp_clip():
    x = np.array([0.0, 15.0, 7.0, 16.0, -1.0], np.float32)
    want = jax.grad(lambda v: jnp.clip(v, 0, 15).sum())(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    TQ.clip(tx, 0.0, 15.0).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), [0.5, 0.5, 1, 0, 0])


WEIGHT_SPECS = {
    'asym_g32_learnable': dict(bit=4, symmetric=False,
                               granularity='per_group', group_size=32,
                               calib_algo='learnable'),
    'sym_channel_learnable': dict(bit=4, symmetric=True,
                                  granularity='per_channel',
                                  calib_algo='learnable'),
    'asym_channel_minmax': dict(bit=4, symmetric=False,
                                granularity='per_channel'),
    'asym_nozp_g32': dict(bit=4, symmetric=False, granularity='per_group',
                          group_size=32, round_zp=False),
}


def _weight_case(kw, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(8, 64) * 0.1).astype(np.float32)
    spec = JSpec(**kw)
    groups = 8 * 64 // 32 if kw['granularity'] == 'per_group' else 8
    learn = kw.get('calib_algo') == 'learnable'
    up = rng.uniform(2.0, 5.0, (groups, 1)).astype(np.float32) \
        if learn else None
    low = rng.uniform(2.0, 5.0, (groups, 1)).astype(np.float32) \
        if learn and not kw['symmetric'] else None
    c = rng.randn(8, 64).astype(np.float32)
    return spec, w, up, low, c


@pytest.mark.parametrize('name', sorted(WEIGHT_SPECS))
def test_fake_quant_weight_gradients_match_jax(name):
    """d/d(up, low, w) of sum(c * fake_quant_weight) with straight-through
    rounding, against jax.grad of the jitted reference (the training step
    runs jitted): every group holds codes that round exactly onto qmin
    and qmax, whose gradient the clip halves."""
    kw = WEIGHT_SPECS[name]
    spec, w, up, low, c = _weight_case(kw)

    def jloss(w, up, low):
        out = JQ.fake_quant_weight(spec, w, up, low, round_fn=JQ.ste_round)
        return jnp.sum(out * c)
    args = [jnp.asarray(a) if a is not None else None for a in (w, up, low)]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    want = jax.jit(jax.grad(jloss, argnums=argnums))(*args)
    targs = [torch.tensor(a, requires_grad=True) if a is not None else None
             for a in (w, up, low)]
    out = TQ.fake_quant_weight(QuantSpec(**kw), targs[0], targs[1],
                               targs[2], round_fn=TQ.ste_round)
    (out * torch.tensor(c)).sum().backward()
    for i, g in zip(argnums, want):
        _close(targs[i].grad.numpy(), g)
    # the ties are there: an asymmetric range puts codes on qmin and qmax
    # in every row; a symmetric one ends at -qmax, and puts codes on qmax
    # in the rows whose largest magnitude is positive
    t, qp = TQ.tensor_qparams(QuantSpec(**kw), torch.tensor(w),
                              *[torch.tensor(a) if a is not None else None
                                for a in (up, low)])
    q = TQ.quant(QuantSpec(**kw), t, qp)
    if spec.symmetric:
        assert bool((q == spec.qmax).any())
    else:
        assert bool((q == spec.qmin).any(-1).all()
                    and (q == spec.qmax).any(-1).all())


ACT_SPECS = {
    'a8_sym_token': dict(bit=8, symmetric=True, granularity='per_token'),
    'a8_asym_token': dict(bit=8, symmetric=False, granularity='per_token'),
    'a4_asym_g32': dict(bit=4, symmetric=False, granularity='per_group',
                        group_size=32),
}


@pytest.mark.parametrize('name', sorted(ACT_SPECS))
def test_fake_quant_act_gradient_matches_jax(name):
    """d/da of sum(c * fake_quant_act(a)) with straight-through rounding,
    against jax.grad of the jitted reference: the range's extremes and
    every code on qmin / qmax are ties."""
    kw = ACT_SPECS[name]
    rng = np.random.RandomState(3)
    a = (rng.randn(2, 5, 64) * 2).astype(np.float32)
    c = rng.randn(2, 5, 64).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(JQ.fake_quant_act(
        JSpec(**kw), v, round_fn=JQ.ste_round) * c)))(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    (TQ.fake_quant_act(QuantSpec(**kw), ta, round_fn=TQ.ste_round)
     * torch.tensor(c)).sum().backward()
    _close(ta.grad.numpy(), want)


@pytest.mark.parametrize('kw', [
    dict(bit=8, symmetric=True, granularity='per_channel'),
    dict(bit=4, symmetric=False, granularity='per_group', group_size=32)])
def test_dim_ic_fake_quant_bit_equal_to_jitted_reference(kw):
    """AdaDim's input-channel fake-quant, as the reference computes it
    jitted (``folded``), bit for bit; and different from the output-channel
    one."""
    w = (np.random.RandomState(4).randn(48, 64) * 0.1).astype(np.float32)
    want = jax.jit(lambda t: JQ.fake_quant_weight(JSpec(**kw), t,
                                                  dim_ic=True))(
        jnp.asarray(w))
    got = TQ.fake_quant_weight(QuantSpec(**kw), torch.tensor(w),
                               dim_ic=True, folded=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oc = TQ.fake_quant_weight(QuantSpec(**kw), torch.tensor(w), folded=True)
    assert not torch.equal(got, oc)
