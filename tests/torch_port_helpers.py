"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed, run through the JAX package on
the CPU and through ``llmc_tpu_torch`` with ``device='cpu'``, and compared
as numpy arrays.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

# the tiny GQA Llama of the JAX package's own tests
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, dtype='float32')
WSPEC = dict(bit=4, symmetric=True, granularity='per_group', group_size=32)
METHODS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'configs', 'quantization', 'methods')


def method_quant(name):
    """The ``quant`` section of a shipped method config, group size 128
    cut to 32 (TINY is 64 wide), and QUIK's ``fp_features`` 128 cut to 8
    (``min(128, in_features - 1)`` would keep all but one of TINY's
    columns fp), as the JAX package's own QUIK test cuts it."""
    with open(os.path.join(METHODS, f'{name}.yml')) as f:
        quant = yaml.safe_load(f)['quant']

    def cut(d):
        return {k: (32 if k == 'group_size' and v == 128 else
                    8 if k == 'fp_features' and v == 128 else
                    cut(v) if isinstance(v, dict) else v)
                for k, v in d.items()}
    return cut(quant)


def to_np(tree):
    """A JAX param tree as numpy arrays (None leaves stay None)."""
    return jax.tree.map(np.asarray, tree)


def port_params(jax_params):
    from llmc_tpu_torch.convert import params_from_numpy
    return params_from_numpy(to_np(jax_params), device='cpu')


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip with a reason (decided inside the test,
    never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the hand-written kernels run only '
                    'there (python3 chip_smoke.py, or pytest -m gpu on '
                    'the card)')
    return torch.device('cuda')


def reference_trains_on_block_inputs(monkeypatch, cls):
    """The JAX package's gradient-trained method ``cls`` trained on each
    block's own calibration inputs: its ``block_opt`` replaces
    ``self.inputs`` by the block's outputs before ``block_transform``
    trains on them (ROADMAP C)."""
    inner_opt, inner_transform = cls.block_opt, cls.block_transform

    def block_opt(self, idx):
        self._block_inputs = self.inputs
        return inner_opt(self, idx)

    def block_transform(self, idx, block, feats):
        outs, self.inputs = self.inputs, self._block_inputs
        try:
            return inner_transform(self, idx, block, feats)
        finally:
            self.inputs = outs
    monkeypatch.setattr(cls, 'block_opt', block_opt)
    monkeypatch.setattr(cls, 'block_transform', block_transform)


def reference_builds_its_step_per_block(monkeypatch, cls):
    """The JAX package's TesseraQ with its jitted training step built
    anew in each block: the cached step keeps the qparams of the block it
    was built in (ROADMAP C)."""
    inner = cls.block_transform

    def block_transform(self, idx, block, feats):
        self._jits.clear()
        return inner(self, idx, block, feats)
    monkeypatch.setattr(cls, 'block_transform', block_transform)
