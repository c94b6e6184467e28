"""Port parity of the Hadamard transforms (llmc_tpu_torch.ops.hadamard)
against llmc_tpu.ops.hadamard on JAX-CPU, f32 within 1e-6: the power-of-2
FWHT and the K x 2^a sizes of Llama widths, the across-heads online
rotation, the weight rotations; and the same raises (11008 has no
factorization, 40 heads are no power of 2)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, rel_err  # noqa: F401

JH = importlib.import_module('llmc_tpu.ops.hadamard')
TH = importlib.import_module('llmc_tpu_torch.ops.hadamard')
torch.set_num_threads(1)


def _x(n, rows=6, seed=0):
    return np.random.RandomState(seed).randn(rows, n).astype(np.float32)


@pytest.mark.parametrize('n', [64, 128, 2048, 5632])
def test_matmul_hadU_matches(n):
    """x H_n / sqrt(n): 2048 by the FWHT, 5632 = 44 x 128 by a Paley H_44
    times the FWHT."""
    x = _x(n)
    want = np.asarray(JH.matmul_hadU(jnp.asarray(x)))
    got = TH.matmul_hadU(torch.as_tensor(x)).numpy()
    assert rel_err(got, want) < 1e-6
    assert TH.get_hadK(n)[1] == JH.get_hadK(n)[1]


@pytest.mark.parametrize('n', [4096, 5632, 13824, 11008, 172])
def test_get_hadK_factors_as_the_reference(n):
    """The factor K of Llama widths: 4096 (1), 5632 (44), 13824 (108);
    none for 11008 (0), as in the reference."""
    jh, jk = JH.get_hadK(n)
    th, tk = TH.get_hadK(n)
    assert tk == jk
    if jh is not None:
        np.testing.assert_array_equal(th, jh)


def test_raises_where_the_reference_raises():
    """n = 11008 (Llama-2-7B's down_proj input) has no factorization, and
    the across-heads rotation at 40 heads (Llama-2-13B) is no power of 2:
    both packages raise alike."""
    x = _x(11008, rows=1)
    with pytest.raises(ValueError, match='no Hadamard factorization'):
        JH.matmul_hadU(jnp.asarray(x))
    with pytest.raises(ValueError, match='no Hadamard factorization'):
        TH.matmul_hadU(torch.as_tensor(x))
    h = _x(40 * 128, rows=2)
    with pytest.raises(AssertionError, match='40 not a power of 2'):
        JH.pre_had_apply(jnp.asarray(h), 'head', 128)
    with pytest.raises(AssertionError, match='40 not a power of 2'):
        TH.pre_had_apply(torch.as_tensor(h), 'head', 128)


@pytest.mark.parametrize('mode, dim', [('full', 0), ('head', 16),
                                       ('head', 64)])
def test_pre_had_apply_matches(mode, dim):
    """The online rotation of a [B, S, D] activation, full and across
    heads."""
    x = np.random.RandomState(1).randn(2, 5, 256).astype(np.float32)
    want = np.asarray(JH.pre_had_apply(jnp.asarray(x), mode, dim))
    got = TH.pre_had_apply(torch.as_tensor(x), mode, dim).numpy()
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize('had_dim, output', [(-1, False), (-1, True),
                                             (16, True)])
def test_apply_exact_had_to_linear_matches(had_dim, output):
    w = np.random.RandomState(2).randn(128, 256).astype(np.float32)
    want = np.asarray(JH.apply_exact_had_to_linear(jnp.asarray(w), had_dim,
                                                   output))
    got = TH.apply_exact_had_to_linear(torch.as_tensor(w), had_dim,
                                       output).numpy()
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize('n, mode', [(64, 'hadamard'), (5632, 'hadamard'),
                                     (96, 'random'), (172, 'hadamard')])
def test_rotations_are_orthogonal_and_seeded(n, mode):
    """QuaRot's rotation from a torch.Generator: orthogonal, the same for
    the same seed; a random Hadamard where n factors (its rows +-1/sqrt(n)
    up to the H_K factor), else QR of a normal matrix (172 = 43 x 4, which
    has no factorization, as 11008 = 43 x 256)."""
    if n > 4096:
        q = TH.get_rotation(n, torch.Generator().manual_seed(3), mode)
        again = TH.get_rotation(n, torch.Generator().manual_seed(3), mode)
        assert torch.equal(q, again) and q.shape == (n, n)
        v = torch.randn(4, n, generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose((v @ q).norm(dim=1).numpy(),
                                   v.norm(dim=1).numpy(), rtol=1e-4)
        return
    q = TH.get_rotation(n, torch.Generator().manual_seed(3), mode)
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(n), atol=2e-5)
    if mode == 'hadamard' and TH.get_hadK(n)[1] == 1:
        np.testing.assert_allclose(np.abs(q.numpy()), 1 / np.sqrt(n),
                                   rtol=1e-5)


def test_jax_rotation_handed_in_is_the_same_function():
    """The reference's random Hadamard of a JAX key, rebuilt from its signs
    by the port's matmul_hadU, gives the same matrix."""
    key = jax.random.PRNGKey(0)
    q = np.asarray(JH.random_hadamard_matrix(64, key))
    s = np.array(jax.random.rademacher(key, (64,), dtype=jnp.float32))
    got = TH.matmul_hadU(torch.diag(torch.as_tensor(s))).numpy()
    assert rel_err(got, q) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize('mode, dim, n', [('full', 0, 4096),
                                          ('full', 0, 5632),
                                          ('head', 64, 2048),
                                          ('head', 128, 4096)])
def test_pre_had_apply_on_card_equals_cpu(cuda_device, mode, dim, n):
    """The online rotation runs on the tensor's device: the card's result
    within 1e-6 of the CPU's (f32 sums in another order)."""
    x = torch.as_tensor(np.random.RandomState(4).randn(3, 7, n)
                        .astype(np.float32))
    got = TH.pre_had_apply(x.to(cuda_device), mode, dim)
    assert got.device.type == 'cuda'
    want = TH.pre_had_apply(x, mode, dim)
    assert rel_err(got.cpu().numpy(), want.numpy()) < 1e-6
