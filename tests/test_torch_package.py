"""The PyTorch port as a package: it imports no JAX and nothing of
llmc_tpu, imports without a GPU / nvcc / triton, builds its kernels only
when asked, and chip_smoke.py's phases that need no kernel run at a tiny
size on the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from llmc_tpu_torch.ops import _build

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p for p in (ROOT / 'llmc_tpu_torch').rglob('*.py')
                    if 'build' not in p.parts) + [ROOT / 'chip_smoke.py']
TINY_BF16 = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=32, dtype='bfloat16')


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_port_imports_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 15
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in _imports(p)
           if m.split('.')[0] in ('jax', 'jaxlib', 'llmc_tpu', 'flax')]
    assert bad == []


def test_package_imports_without_gpu_nvcc_or_triton():
    """A fresh interpreter with triton blocked imports every module."""
    code = ('import sys; sys.modules["triton"] = None\n'
            'import importlib, pathlib\n'
            'root = pathlib.Path("llmc_tpu_torch")\n'
            'for p in sorted(root.rglob("*.py")):\n'
            '    if "build" in p.parts: continue\n'
            '    mod = ".".join(p.with_suffix("").parts)\n'
            '    importlib.import_module(mod.removesuffix(".__init__"))\n'
            'assert "jax" not in sys.modules, "jax was imported"\n'
            'print("ok")\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == 'ok', r.stderr[-2000:]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'exists', lambda p: False)
    monkeypatch.setattr(_build, 'BUILD', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build()


def test_ptxas_report_is_parsed():
    text = ("ptxas info    : Compiling entry function '_Z3fooPf' for "
            "'sm_90a'\nptxas info    : Function properties for _Z3fooPf\n"
            "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
            "loads\nptxas info    : Used 96 registers, 43008 bytes smem, "
            "400 bytes cmem[0]\n")
    assert _build._parse_ptxas(text) == {'_Z3fooPf': {
        'spill_stores': 8, 'spill_loads': 4, 'registers': 96,
        'smem_bytes': 43008}}


def test_chip_smoke_exits_nonzero_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: chip_smoke.py would run')
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ''


ZERO_LAUNCHES = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)


def test_chip_smoke_cpu_phases_tiny():
    """parity / serve / throughput at a tiny size on the CPU (the plain
    versions: no kernel launches, so the launch counts stay 0)."""
    cpu = torch.device('cpu')
    rec = chip_smoke.phase_parity(cpu, cpu, TINY_BF16, prompt_len=8,
                                  steps=3, group_size=32)
    assert rec['ok'] and rec['rel_logit_err'] < chip_smoke.TOL_PARITY['w4a16']
    m, q = chip_smoke.make_model('w4a16', TINY_BF16, 'cpu', group_size=32)
    rec = chip_smoke.phase_serve(cpu, m, q, n_requests=5, max_batch=2,
                                 max_len=96, buckets=(16, 32),
                                 max_prompt=30)
    assert rec['all_done'] and rec['requests'] == 5
    assert rec['launches'] == ZERO_LAUNCHES
    L = TINY_BF16['num_hidden_layers']
    assert rec['expected_launches']['flash_decode'] == \
        L * rec['decode_steps']
    rec = chip_smoke.phase_throughput(cpu, m, q, B=4, prefill=8, steps=4)
    assert rec['tokens_per_s'] > 0 and np.isfinite(rec['step_ms'])
    assert rec['launches'] == ZERO_LAUNCHES
    assert rec['expected_launches'] == dict(
        ZERO_LAUNCHES, w4_dequant_matmul=9 * 5, flash_decode=L * 4)
    b = chip_smoke.step_bound(m, 4, 8, 4, chip_smoke.PEAKS['H100 SXM'])
    assert b['weight_bytes'] > 0 and b['step_bound_by'] in ('bytes',
                                                           'operations')


@pytest.mark.parametrize('mode', ['w4a8', 'w8a16'])
def test_chip_smoke_cpu_phases_tiny_w4a8_and_w8(mode):
    """The W4A8 (+ batch attention) and W8A16 phases at a tiny size on the
    CPU, and the launches each path implies."""
    cpu = torch.device('cpu')
    L = TINY_BF16['num_hidden_layers']
    rec = chip_smoke.phase_parity(cpu, cpu, TINY_BF16, prompt_len=8,
                                  steps=3, mode=mode, group_size=32)
    assert rec['ok'] and rec['mode'] == mode
    m, q = chip_smoke.make_model(mode, TINY_BF16, 'cpu', group_size=32)
    assert q.get('mlp.down_proj').a_int8 == (mode == 'w4a8')
    rec = chip_smoke.phase_serve(cpu, m, q, n_requests=4, max_batch=2,
                                 max_len=96, buckets=(16, 32), max_prompt=30,
                                 mode=mode)
    assert rec['all_done'] and rec['launches'] == ZERO_LAUNCHES
    assert rec['phase'] == {'w4a8': 'serve_w4a8', 'w8a16': 'serve_w8'}[mode]
    fw, steps = rec['prefill_forwards'] + rec['decode_steps'], \
        rec['decode_steps']
    want = {'w4a8': dict(ZERO_LAUNCHES, w4a8_dequant_matmul=4 * L * fw,
                         w4_dequant_matmul=fw, batch_decode=L * steps),
            'w8a16': dict(ZERO_LAUNCHES, w8_dequant_matmul=(4 * L + 1) * fw,
                          flash_decode=L * steps)}[mode]
    assert rec['expected_launches'] == want
    from llmc_tpu_torch.serve import decode
    assert decode.ATTN_IMPL == 'auto'         # restored after the phase
    peaks = chip_smoke.PEAKS['H100 SXM']
    b = chip_smoke.step_bound(m, 4, 8, 4, peaks, mode)
    b4 = chip_smoke.step_bound(
        chip_smoke.make_model('w4a16', TINY_BF16, 'cpu', group_size=32)[0],
        4, 8, 4, peaks)
    assert b['linear_params'] == b4['linear_params']
    assert (b['weight_bytes'] > b4['weight_bytes']) == (mode == 'w8a16')


@pytest.mark.parametrize('flag', ['prefill_w8', 'decode_w8'])
def test_chip_smoke_cpu_companion_phase_tiny(flag):
    """The w8-companion phase at a tiny size: the forwards that ride the
    companion imply no block launch of the w4 kernel, only the head's."""
    cpu = torch.device('cpu')
    L = TINY_BF16['num_hidden_layers']
    m, q = chip_smoke.companion_model(cpu, TINY_BF16, group_size=32)
    assert 'qweight8' in m.blocks[0]['mlp']['down_proj']
    rec = chip_smoke.phase_serve(cpu, m, q, n_requests=4, max_batch=2,
                                 max_len=96, buckets=(16, 32), max_prompt=30,
                                 w8_flag=flag)
    assert rec['all_done'] and rec['phase'] == f'serve_w8_companion.{flag}'
    pre, steps = rec['prefill_forwards'], rec['decode_steps']
    block = steps if flag == 'prefill_w8' else 0
    assert rec['expected_launches'] == dict(
        ZERO_LAUNCHES, w4_dequant_matmul=4 * L * block + pre + steps,
        flash_decode=L * steps)


def test_bounds_follow_the_data_sheet():
    peaks = chip_smoke.PEAKS['H100 SXM']
    ms, by = chip_smoke.gemm_bound('w4', 128, 22016, 4096, 2, peaks)
    assert by == 'operations' and abs(ms - 2 * 128 * 22016 * 4096
                                      / 989e12 * 1e3) < 1e-9
    ms1, by1 = chip_smoke.gemm_bound('w4', 1, 22016, 4096, 2, peaks)
    assert by1 == 'bytes' and 0.014 < ms1 < 0.016
    pos = torch.full((128,), 63, dtype=torch.int32)
    ms2, by2 = chip_smoke.flash_bound(pos, 32, 128, 32, True, peaks)
    assert by2 == 'bytes' and 0.020 < ms2 < 0.023
    # W4A8 multiplies at the int8 rate: half the w4 operation bound at
    # M=4096; at M=128 the packed bytes bound it
    ms3, by3 = chip_smoke.gemm_bound('w4a8', 4096, 22016, 4096, 2, peaks)
    assert by3 == 'operations' and abs(ms3 - 2 * 4096 * 22016 * 4096
                                       / 1979e12 * 1e3) < 1e-9
    assert chip_smoke.gemm_bound('w4a8', 128, 22016, 4096, 2, peaks)[1] == \
        'bytes'
    # W8 reads a byte a weight: twice the w4 byte bound at M=1, nearly
    ms4, by4 = chip_smoke.gemm_bound('w8', 1, 22016, 4096, 2, peaks)
    assert by4 == 'bytes' and 1.8 < ms4 / ms1 < 2.0
    # its bytes, exactly: x, a byte a weight, one f32 scale per group and
    # column, as many zeros only where the weight has them, the output
    N, K, M, ng = 22016, 4096, 128, 32
    sym = 2 * M * K + N * K + ng * N * 4 + 2 * M * N
    for has_z, nbytes in ((False, sym), (True, sym + ng * N * 4)):
        ms5, by5 = chip_smoke.gemm_bound('w8', M, N, K, 2, peaks,
                                         has_z=has_z)
        assert by5 == 'bytes' and abs(ms5 - nbytes / 3.35e12 * 1e3) < 1e-12
    # the W4 kernels read s and zs whatever the storage
    assert chip_smoke.gemm_bound('w4', 1, N, K, 2, peaks, has_z=False) == \
        (ms1, by1)
