"""RTN through both ``run_pipeline``s on the families' graphs, on the same
weights (``same_random_weights``), held to the JAX package on the CPU at
float32; and a family through the ``python -m llmc_tpu_torch`` command
line with an inline arch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from llmc_tpu.main import run_pipeline as j_run_pipeline
from llmc_tpu_torch.main import run_pipeline
from torch_port_helpers import (PIPELINE_FAMILIES, family_pipeline_config,
                                same_random_weights)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PPLS = ('ppl_pretrain', 'ppl_transformed', 'ppl_fake_quant')


@pytest.mark.parametrize('family', sorted(PIPELINE_FAMILIES))
def test_rtn_pipeline_ppls_match_jax(family, monkeypatch):
    """The three PPLs within 1e-3 of the JAX package's (pretrain and
    transformed equal: RTN transforms nothing), the fake-quant weights'
    forward on the family's graph included."""
    config = family_pipeline_config(family, 'RTN')
    same_random_weights(monkeypatch)
    jres = j_run_pipeline(config)
    tres = run_pipeline(config, device='cpu')
    assert type(tres['model']).__name__ == f'{family}Adapter'
    for k in PPLS:
        assert np.isfinite(tres[k])
        assert abs(tres[k] - jres[k]) / jres[k] < 1e-3, k
    assert tres['ppl_transformed'] == tres['ppl_pretrain']


def test_cli_runs_a_family_from_an_inline_arch(tmp_path):
    """``python -m llmc_tpu_torch --config`` with ``model.type: Qwen3`` and
    an inline arch, on the CPU: the three PPLs printed, finite."""
    config = family_pipeline_config('Qwen3', 'RTN')
    path = tmp_path / 'qwen3.yml'
    path.write_text(yaml.safe_dump(config))
    out = subprocess.run(
        [sys.executable, '-m', 'llmc_tpu_torch', '--config', str(path),
         '--device', 'cpu'], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr[-2000:]
    got = {line.split(':')[0]: float(line.split(':')[1])
           for line in out.stdout.splitlines()
           if line.split(':')[0] in PPLS}
    assert sorted(got) == sorted(PPLS)
    assert all(np.isfinite(v) for v in got.values())
