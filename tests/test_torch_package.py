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


NEW_MODULES = ('main.py', '__main__.py', 'compression/blockwise.py',
               'compression/transforms.py', 'compression/quantization/awq.py',
               'compression/quantization/auto_clip.py',
               'compression/quantization/rtn.py', 'data/dataset.py',
               'data/preproc.py', 'eval/ppl.py', 'eval/orchestrate.py',
               'models/hf_loader.py', 'ops/fp8_gemm.py',
               'quant/fp8_block.py', 'quant/fp_formats.py',
               'utils/config.py', 'utils/profiler.py')


def _module_level_imports(path):
    """Imports a module runs when it is imported (not those inside a
    function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def test_compression_slice_is_under_the_import_check():
    names = {p.relative_to(ROOT / 'llmc_tpu_torch').as_posix()
             for p in PORT_FILES[:-1]}
    assert set(NEW_MODULES) <= names


def test_optional_packages_are_imported_only_inside_functions():
    """safetensors, yaml, datasets and transformers may be missing where
    the port runs: no module imports them at import time, and
    chip_smoke.py nowhere."""
    optional = ('safetensors', 'yaml', 'datasets', 'transformers')
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in _module_level_imports(p) if m.split('.')[0] in optional]
    assert bad == []
    assert [m for m in _imports(ROOT / 'chip_smoke.py')
            if m.split('.')[0] in optional] == []


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


def test_chip_smoke_cpu_fp8_linear_phase_tiny():
    """One block's seven linears through the FP8-block path at a tiny
    size on the CPU (the plain version: no launches)."""
    rec = chip_smoke.phase_fp8_linear(torch.device('cpu'), TINY_BF16, M=16)
    assert rec['ok'] and len(rec['linears']) == 7
    assert rec['launches'] == rec['expected_launches'] == ZERO_LAUNCHES
    assert {r['path']: (r['N'], r['K']) for r in rec['linears']}[
        'mlp.down_proj'] == (128, 256)
    assert all(0 < r['rel_err_vs_dense_bf16_weight']
               <= chip_smoke.TOL_FP8_LINEAR for r in rec['linears'])


@pytest.fixture(scope='module')
def compressed_tiny():
    """method -> (phase record, pipeline result) of the ``compress`` phase
    at a tiny size on the CPU."""
    sizes = dict(group_size=32, n_samples=4, seq_len=24, eval_tokens=480,
                 eval_bs=2)
    cpu = torch.device('cpu')
    return {'RTN': chip_smoke.phase_compress(cpu, TINY_BF16, 'RTN', **sizes),
            'Awq': chip_smoke.phase_compress(
                cpu, TINY_BF16, 'Awq', chip_smoke.AWQ_SPECIAL,
                fp8_ingest=True, **sizes)}


@pytest.mark.parametrize('method', ['RTN', 'Awq'])
def test_chip_smoke_cpu_compress_phase_tiny(compressed_tiny, method):
    rec, res = compressed_tiny[method]
    assert rec['ok'] and rec['phase'] == 'compress' and rec['layers'] == 2
    assert rec['launches'] == ZERO_LAUNCHES    # the pipeline runs no kernel
    assert rec['ppl_transformed_rel_drift'] <= chip_smoke.TOL_PPL_TRANSFORMED
    assert (rec['ppl_transformed'] == rec['ppl_pretrain']) == \
        (method == 'RTN')
    assert set(rec['phase_times_s']) == {
        'build_model', 'eval_pretrain', 'calib_data', f'calib_{method}',
        'eval_transformed', 'eval_fake_quant'}
    assert rec['fp8_block_ingest'] == (method == 'Awq')
    assert res['opt'].wspec.group_size == 32
    # what the search left errs less than RTN at every checked block
    assert [r['block'] for r in rec['block_output_mse']] == \
        ([0, 1] if method == 'Awq' else [])
    assert all(0 < r['searched_over_rtn'] < 0.9
               for r in rec['block_output_mse'])


def test_chip_smoke_fp8_ingest_rounds_the_block_linears_to_e4m3():
    from llmc_tpu_torch.models import build_model
    from llmc_tpu_torch.quant import weight_cast_to_bf16, weight_cast_to_fp8
    cfg = chip_smoke.compress_config(TINY_BF16, 'RTN', fp8_ingest=True)
    plain = build_model(chip_smoke.compress_config(TINY_BF16, 'RTN'),
                        device='cpu')
    model = build_model(cfg, device='cpu')
    w0 = plain.blocks[1]['mlp']['up_proj']['w']
    w1 = model.blocks[1]['mlp']['up_proj']['w']
    assert w1.dtype == torch.bfloat16 and not torch.equal(w0, w1)
    assert torch.equal(w1, weight_cast_to_bf16(*weight_cast_to_fp8(w0)))
    assert torch.equal(plain.params['embed_tokens']['w'],
                       model.params['embed_tokens']['w'])
    # its norms spread the channels; the plain model's are ones
    ln = model.blocks[0]['input_layernorm']['w'].float()
    assert ln.max() / ln.min() > 10
    assert bool((plain.blocks[0]['input_layernorm']['w'] == 1).all())


def test_chip_smoke_cpu_compress_serve_phase_tiny(compressed_tiny):
    """What the AWQ run made, packed and served at a tiny size: the
    packed logits against the fake-quant model's, and the launches the
    serving path implies."""
    _, res = compressed_tiny['Awq']
    rec = chip_smoke.phase_compress_serve(
        torch.device('cpu'), res, prompt_len=8, n_requests=4, max_batch=2,
        max_len=96, buckets=(16, 32), max_prompt=30)
    assert rec['ok'] and rec['all_done'] and rec['phase'] == 'compress_serve'
    assert rec['rel_logit_err_vs_fake_quant'] <= chip_smoke.TOL_COMPRESS_SERVE
    assert rec['launches'] == ZERO_LAUNCHES
    L, fw = 2, rec['prefill_forwards'] + rec['decode_steps']
    assert rec['expected_launches'] == dict(
        ZERO_LAUNCHES, w4_dequant_matmul=(4 * L + 1) * fw,
        flash_decode=L * rec['decode_steps'])
    assert 'qweight' in res['model'].params['lm_head']


def test_fp8_bound_follows_the_data_sheet():
    peaks = chip_smoke.PEAKS['H100 SXM']
    N, K = 22016, 4096
    for M, by in ((1, 'bytes'), (128, 'bytes'), (4096, 'operations')):
        ms, got = chip_smoke.fp8_bound(M, N, K, 2, peaks)
        nbytes = M * K + N * K + 4 * M * 32 + 4 * 172 * 32 + 2 * M * N
        want = max(nbytes / 3.35e12, 2 * M * N * K / 1979e12) * 1e3
        assert got == by and abs(ms - want) < 1e-12
    assert 0.0269 < chip_smoke.fp8_bound(1, N, K, 2, peaks)[0] < 0.0270
    assert 0.373 < chip_smoke.fp8_bound(4096, N, K, 2, peaks)[0] < 0.374
    assert chip_smoke.KERNEL_NAMES[-1] == 'fp8_block_gemm'
