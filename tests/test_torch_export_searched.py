"""The backend configs whose method searches (AWQ with clip v1:
``vllm_w4a16_pack``, ``lightllm_w8a8``, and ``trtllm_w4a16`` at tensor
parallel 1 and 2) through both packages' ``run_pipeline``: the written
names, dtypes, shapes and ``config.json`` equal, and the reference's
compressed model written by the port's writer byte for byte the
reference's checkpoint (``test_torch_export.py``'s checks)."""

import pytest
import torch

from test_torch_export import (check_pipeline, check_writer,  # noqa: F401
                               checkpoint, run_case)

torch.set_num_threads(1)

SEARCHED = {
    'vllm_w4a16_pack': ('vllm_w4a16_pack.yml', {}),
    'lightllm_w8a8': ('lightllm_w8a8.yml', {}),
    'trtllm_w4a16_tp1': ('trtllm_w4a16.yml', {}),
    'trtllm_w4a16_tp2': ('trtllm_w4a16.yml', dict(tp_size=2)),
}


@pytest.fixture(scope='module', params=sorted(SEARCHED))
def case(request, checkpoint, tmp_path_factory):  # noqa: F811
    return run_case(request.param, checkpoint, tmp_path_factory, SEARCHED)


def test_pipeline_writes_what_the_reference_writes(case):
    check_pipeline(case)


def test_writer_on_the_reference_model_is_byte_equal(case, tmp_path):
    check_writer(case, str(tmp_path / 'port'))
