"""Hadamard transforms (port of ``llmc_tpu/ops/hadamard.py``): the fast
Walsh-Hadamard transform and sizes n = K * 2^a with a Paley H_K.

The reference has no Pallas kernel here: its butterflies and the K x K
product are jitted XLA.  Here they are torch ops on the tensor's device;
H_K is built on the host (numpy, float64) as the reference builds it, so
both raise where no factorization exists (n = 11008: K = 43, for which no
Paley matrix is generated).  The random rotations take a
``torch.Generator`` where the reference takes a JAX key.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

F32 = torch.float32


def fwht(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (a power of 2),
    Sylvester ordering, times ``scale`` (default 1 / sqrt(n))."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, f'{n} not a power of 2'
    lead = x.shape[:-1]
    out = x.to(F32).reshape(-1, n)
    h = 1
    while h < n:
        out = out.reshape(-1, n // (2 * h), 2, h)
        a, b = out[:, :, 0, :], out[:, :, 1, :]
        out = torch.stack([a + b, a - b], dim=2).reshape(-1, n)
        h *= 2
    if scale is None:
        scale = 1.0 / np.sqrt(n)
    return (out * float(np.float32(scale))).reshape(*lead, n).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _paley_hadamard(q: int) -> np.ndarray:
    """H_{q+1} for a prime q = 3 (mod 4), by Paley's first construction."""
    assert q % 4 == 3
    residues = set((i * i) % q for i in range(1, q))

    def chi(a):
        a %= q
        if a == 0:
            return 0
        return 1 if a in residues else -1

    n = q + 1
    Q = np.array([[chi(i - j) for j in range(q)] for i in range(q)],
                 dtype=np.float64)
    S = np.zeros((n, n))
    S[0, 1:] = 1
    S[1:, 0] = -1
    S[1:, 1:] = Q
    H = S + np.eye(n)
    assert np.allclose(H @ H.T, n * np.eye(n)), 'Paley construction failed'
    return H


def _is_prime(m: int) -> bool:
    if m < 2:
        return False
    for p in range(2, int(m ** 0.5) + 1):
        if m % p == 0:
            return False
    return True


@functools.lru_cache(maxsize=None)
def get_hadK(n: int) -> Tuple[Optional[np.ndarray], int]:
    """Factor n = K * 2^a: (H_K, K), (None, 1) for a power of 2, and
    (None, 0) where no factorization is available."""
    m = n
    while m % 2 == 0:
        m //= 2
    if m == 1:
        return None, 1
    if m % 4 == 0 and _is_prime(m - 1) and (m - 1) % 4 == 3:
        return _paley_hadamard(m - 1), m
    for K in (m * 4, m * 2, m):
        if n % K == 0 and K % 4 == 0 and _is_prime(K - 1) \
                and (K - 1) % 4 == 3 and (n // K) & (n // K - 1) == 0:
            return _paley_hadamard(K - 1), K
    return None, 0


def matmul_hadU(x: torch.Tensor) -> torch.Tensor:
    """x @ H_n / sqrt(n) along the last axis."""
    n = x.shape[-1]
    hadK, K = get_hadK(n)
    if K == 0:
        raise ValueError(f'no Hadamard factorization for n={n}')
    if K == 1:
        return fwht(x)
    lead = x.shape[:-1]
    v = x.to(F32).reshape(-1, K, n // K)
    v = fwht(v, scale=1.0 / np.sqrt(n))
    v = torch.einsum('ij,bjk->bik', torch.as_tensor(hadK, dtype=F32,
                                                    device=x.device), v)
    return v.reshape(*lead, n).to(x.dtype)


def random_hadamard_matrix(n: int, gen: torch.Generator,
                           device=None) -> torch.Tensor:
    """H diag(+-1) / sqrt(n), orthogonal; the signs from ``gen``."""
    s = torch.randint(0, 2, (n,), generator=gen, device=device or gen.device
                      ).to(F32) * 2 - 1
    return matmul_hadU(torch.diag(s))


def random_orthogonal_matrix(n: int, gen: torch.Generator,
                             device=None) -> torch.Tensor:
    """A random orthogonal matrix by the QR of a normal one (signs fixed
    by R's diagonal)."""
    m = torch.randn((n, n), generator=gen, dtype=F32,
                    device=device or gen.device)
    q, r = torch.linalg.qr(m)
    return q * torch.sign(torch.diagonal(r))[None, :]


def get_rotation(n: int, gen: torch.Generator, mode: str = 'hadamard',
                 device=None) -> torch.Tensor:
    """QuaRot's rotation of the residual stream: a random Hadamard where n
    factors, else a random orthogonal matrix."""
    if mode == 'hadamard':
        _, K = get_hadK(n)
        if K != 0:
            return random_hadamard_matrix(n, gen, device)
    return random_orthogonal_matrix(n, gen, device)


def pre_had_apply(x: torch.Tensor, mode: str, had_dim: int = 0
                  ) -> torch.Tensor:
    """The online activation rotation before a linear.  'full': x @ H_D.
    'head' (o_proj's input): the Hadamard ACROSS the heads axis, length
    D / had_dim, scale 1 / sqrt(n_heads); the within-head factor is folded
    into v_proj's output, and in Sylvester ordering H_D = H_nh (x) H_hd."""
    orig_dtype = x.dtype
    if mode == 'full':
        return matmul_hadU(x).to(orig_dtype)
    hd = had_dim
    shape = x.shape
    nh = shape[-1] // hd
    r = x.to(F32).reshape(*shape[:-1], nh, hd).transpose(-1, -2)
    r = fwht(r)                       # across heads, 1 / sqrt(nh)
    return r.transpose(-1, -2).reshape(shape).to(orig_dtype)


def apply_exact_had_to_linear(w: torch.Tensor, had_dim: int = -1,
                              output: bool = False) -> torch.Tensor:
    """A per-head (``had_dim``) or full Hadamard applied to a weight's
    rows (``output``) or columns.  w: [out, in]."""
    wf = w.to(F32)
    if had_dim == -1:
        if output:
            return matmul_hadU(wf.T).T.to(w.dtype)
        return matmul_hadU(wf).to(w.dtype)
    if output:
        wt = wf.T  # [in, out]
        r = wt.reshape(-1, wt.shape[-1] // had_dim, had_dim)
        r = fwht(r)
        return r.reshape(wt.shape).T.contiguous().to(w.dtype)
    raise NotImplementedError('input-side per-head hadamard unused')
