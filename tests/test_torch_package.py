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
    """No jax and nothing of the reference: ``llmc_tpu``, nor the repo's
    root ``tools`` package, whose probes import both (the port's own
    ``llmc_tpu_torch.tools`` is another package)."""
    assert len(PORT_FILES) > 15
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in _imports(p)
           if m.split('.')[0] in ('jax', 'jaxlib', 'llmc_tpu', 'flax',
                                  'tools')]
    assert bad == []


NEW_MODULES = ('main.py', '__main__.py', 'compression/blockwise.py',
               'compression/transforms.py', 'compression/quantization/awq.py',
               'compression/quantization/auto_clip.py',
               'compression/quantization/rtn.py', 'data/dataset.py',
               'data/preproc.py', 'eval/ppl.py', 'eval/orchestrate.py',
               'models/hf_loader.py', 'ops/fp8_gemm.py',
               'quant/fp8_block.py', 'quant/fp_formats.py',
               'utils/config.py', 'utils/profiler.py',
               'ops/probe_gemm.py', 'tools/__init__.py', 'tools/_measure.py',
               'tools/kernel_bench.py', 'tools/w4_probe.py',
               'tools/ab_serve.py', 'tools/wgmma_variants.py',
               'ops/hadamard.py', 'compression/quantization/smoothquant.py',
               'compression/quantization/gptq.py',
               'compression/quantization/quarot.py',
               'compression/quantization/osplus.py',
               'compression/quantization/llmint8.py', 'native/__init__.py',
               'export/__init__.py', 'export/formats.py',
               'export/exporter.py', 'export/trtllm.py', 'utils/offload.py',
               'eval/code.py', 'eval/harness.py')


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
    """safetensors, yaml, datasets, transformers, lm_eval and human_eval
    may be missing where the port runs: no module imports them at import
    time, and chip_smoke.py nowhere."""
    optional = ('safetensors', 'yaml', 'datasets', 'transformers', 'lm_eval',
                'human_eval')
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
            'from llmc_tpu_torch.utils import ALGO_REGISTRY\n'
            'for m in ("SmoothQuant", "GPTQ", "Quarot", "OsPlus", '
            '"LlmInt8", "HQQ", "AdaDim", "NormTweaking", "OmniQuant", '
            '"TesseraQ"):\n'
            '    ALGO_REGISTRY[m]\n'
            'print("ok")\n')
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == 'ok', r.stderr[-2000:]


def test_registry_holds_the_trained_methods_and_ste_is_served():
    """HQQ, AdaDim, NormTweaking, OmniQuant, TesseraQ and the last A10
    methods (QUIK, SpQR, DGQ) are registered; ``LinearQcfg(ste=True)`` and
    ``mixed_cols``, which raised until QUIK was ported, are served."""
    import llmc_tpu_torch.compression  # noqa: F401 (registers them)
    from llmc_tpu_torch.models.base import LinearQcfg, linear_apply
    from llmc_tpu_torch.utils import ALGO_REGISTRY
    for m in ('HQQ', 'AdaDim', 'NormTweaking', 'OmniQuant', 'TesseraQ',
              'QUIK', 'SpQR', 'DGQ'):
        assert ALGO_REGISTRY[m].__name__ == m
    x = torch.ones(2, 4)
    lin = {'w': torch.eye(4), 'b': None,
           'int_mask': torch.tensor([True, False, True, True])}
    for qc in (LinearQcfg(ste=True), LinearQcfg(mixed_cols=True)):
        assert torch.equal(linear_apply(lin, x, qc), x)


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
    rec = chip_smoke.serve_run(cpu, m, q, n_requests=5, max_batch=2,
                               max_len=96, buckets=(16, 32),
                               max_prompt=30)[0]
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
    rec = chip_smoke.serve_run(cpu, m, q, n_requests=4, max_batch=2,
                               max_len=96, buckets=(16, 32), max_prompt=30,
                               mode=mode)[0]
    assert rec['all_done'] and rec['launches'] == ZERO_LAUNCHES
    assert rec['phase'] == {'w4a8': 'serve_w4a8', 'w8a16': 'serve_w8'}[mode]
    fw, steps = rec['prefill_forwards'] + rec['decode_steps'], \
        rec['decode_steps']
    want = {'w4a8': dict(ZERO_LAUNCHES, w4a8_dequant_matmul=4 * L * fw,
                         quant_act_token=4 * L * fw, w4_dequant_matmul=fw,
                         batch_decode=L * steps),
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


def test_chip_smoke_cpu_graph_and_paged_phases_tiny():
    """serve_graph and serve_paged at a tiny size on the CPU, where every
    step is eager: the eager and window runs give the serve run's tokens;
    the paged pool (int8, chunked admission) makes requests wait, gives
    every page back, implies no decode-attention launch, and at 2 layers
    of a float32 model gives the dense engine's tokens, fp and int8."""
    cpu = torch.device('cpu')
    kw = dict(n_requests=5, max_batch=2, max_len=96, buckets=(16, 32),
              max_prompt=30)
    m, q = chip_smoke.make_model('w4a16', TINY_BF16, 'cpu', group_size=32)
    rec, toks, eng = chip_smoke.serve_run(cpu, m, q, **kw)
    assert not rec['graphed'] and rec['graph_replays'] == 0
    rec = chip_smoke.phase_serve_graph(cpu, m, q, toks, **kw)
    assert rec['eager_tokens_equal'] and rec['window_tokens_equal']
    assert rec['all_done'] and rec['window_launches'] == ZERO_LAUNCHES
    rec = chip_smoke.phase_serve_paged(cpu, m, q, TINY_BF16, n_pages=6,
                                       group_size=32, **kw)
    assert rec['all_done'] and rec['pool_whole_at_end']
    assert rec['requests_waited_on_the_pool']
    assert rec['fp_pool_tokens_equal_dense_fp_at_2_layers_f32']
    assert rec['int8_pool_requests_equal_dense_int8_at_2_layers_f32'] == 1
    assert rec['int8_pool_tokens_equal_cpu_at_2_layers_f32']
    assert rec['expected_launches']['flash_decode'] == 0
    assert rec['launches'] == ZERO_LAUNCHES


@pytest.mark.parametrize('flag', ['prefill_w8', 'decode_w8'])
def test_chip_smoke_cpu_companion_phase_tiny(flag):
    """The w8-companion phase at a tiny size: the forwards that ride the
    companion imply no block launch of the w4 kernel, only the head's."""
    cpu = torch.device('cpu')
    L = TINY_BF16['num_hidden_layers']
    m, q = chip_smoke.companion_model(cpu, TINY_BF16, group_size=32)
    assert 'qweight8' in m.blocks[0]['mlp']['down_proj']
    rec = chip_smoke.serve_run(cpu, m, q, n_requests=4, max_batch=2,
                               max_len=96, buckets=(16, 32), max_prompt=30,
                               w8_flag=flag)[0]
    assert rec['all_done'] and rec['phase'] == f'serve_w8_companion.{flag}'
    pre, steps = rec['prefill_forwards'], rec['decode_steps']
    block = steps if flag == 'prefill_w8' else 0
    assert rec['expected_launches'] == dict(
        ZERO_LAUNCHES, w4_dequant_matmul=4 * L * block + pre + steps,
        flash_decode=L * steps)


def test_profiled_kernel_calls_read_each_wrapper_kernel():
    """The profiler's device rows map to the wrapper that launches each
    kernel (B5 by either of its two kernels), helpers and other kernels
    to none, and host rows are not read."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def row(key, n, dev=DeviceType.CUDA):
        return SimpleNamespace(key=key, count=n, device_type=dev)
    rows = [
        row('void (anonymous namespace)::w4_dequant_matmul_kernel<128, 2, '
            'false>(CUtensorMap_st, float*)', 1024),
        row('void (anonymous namespace)::w4_dequant_matmul_kernel<128, 1, '
            'true>(CUtensorMap_st, float*)', 8),
        row('void (anonymous namespace)::w4a8_dequant_matmul_kernel<8>('
            'CUtensorMap_st)', 5),
        row('(anonymous namespace)::quant_act_token_kernel<__nv_bfloat16, '
            '8>(int)', 5),
        row('void (anonymous namespace)::fd::flash_decode_kernel<0, 1>('
            'CUtensorMap_st)', 256),
        row('void (anonymous namespace)::batch_decode_kernel<0>(int)', 3),
        row('void (anonymous namespace)::batch_decode_mma_kernel<1>(int)',
            4),
        row('void (anonymous namespace)::split_sum_kernel<false>(float '
            'const*)', 1024),
        row('(anonymous namespace)::x_piece_sums_kernel(__nv_bfloat16 '
            'const*)', 1032),
        row('w4_dequant_matmul', 99, DeviceType.CPU),
    ]
    prof = SimpleNamespace(key_averages=lambda: rows)
    got = chip_smoke.profiled_kernel_calls(prof)
    assert got == dict(w4_dequant_matmul=1032, w4a8_dequant_matmul=5,
                       w8_dequant_matmul=0, quant_act_token=5,
                       flash_decode=256, batch_decode=7, fp8_block_gemm=0)


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


@pytest.mark.parametrize('name, mode', [('smoothquant_w8a8', 'w8a16'),
                                        ('gptq_w4a16', 'w4a16'),
                                        ('quarot_w4a8', None)])
def test_chip_smoke_cpu_method_phases_tiny(name, mode):
    """The compress phase of the activation-quantizing and Hessian methods
    at a tiny size on the CPU (group size 32): finite PPLs, the
    equivalence transforms near pretrain, GPTQ's column-loop share and
    QuaRot's Hadamard share; then SmoothQuant's and GPTQ's models packed
    with their a_spec and served, against the fake-quant model, with the
    launches of the W8 or W4 path."""
    quant = chip_smoke.METHOD_QUANT[name]
    sizes = dict(group_size=32, n_samples=4, seq_len=24, eval_tokens=480,
                 eval_bs=2)
    cpu = torch.device('cpu')
    rec, res = chip_smoke.phase_compress(cpu, TINY_BF16, quant['method'],
                                         quant=quant, **sizes)
    assert rec['ok'] and rec['launches'] == ZERO_LAUNCHES
    assert rec['act'] == quant.get('act')
    if name.startswith('gptq'):
        assert rec['column_steps'] == 2 * (6 * 128 + 256)
        assert 0 < rec['column_loop_share_of_block_loop'] <= 1
    if name.startswith('quarot'):
        assert rec['hadamard_calls'] > 0 and 0 < rec['hadamard_share'] < 1
        assert rec['ppl_fake_quant_again'] == rec['ppl_fake_quant']
    if mode is None:
        return
    srv = chip_smoke.phase_compress_serve(
        cpu, res, prompt_len=8, mode=mode, n_requests=4, max_batch=2,
        max_len=96, buckets=(16, 32), max_prompt=30)
    assert srv['ok'] and srv['all_done'] and srv['launches'] == ZERO_LAUNCHES
    assert srv['rel_logit_err_vs_fake_quant'] \
        <= srv['tolerance_vs_fake_quant'] == (
            chip_smoke.TOL_COMPRESS_SERVE if 'act' not in quant
            else chip_smoke.TOL_COMPRESS_SERVE_A8)
    kernel = 'w8_dequant_matmul' if mode == 'w8a16' else 'w4_dequant_matmul'
    fw = srv['prefill_forwards'] + srv['decode_steps']
    assert srv['expected_launches'][kernel] == (4 * 2 + 1) * fw
    assert srv['a_spec'] == (None if 'act' not in quant else dict(
        srv['a_spec'], **quant['act']))


def test_chip_smoke_method_quants_are_the_shipped_configs():
    """``METHOD_QUANT`` holds each method config's ``quant`` section as it
    stands in configs/quantization/methods."""
    import yaml
    for name, quant in chip_smoke.METHOD_QUANT.items():
        path = ROOT / 'configs' / 'quantization' / 'methods' / f'{name}.yml'
        assert yaml.safe_load(path.read_text())['quant'] == quant, name


@pytest.mark.parametrize('name, mode', chip_smoke.PHASE16)
def test_chip_smoke_cpu_phase16_tiny(name, mode):
    """Phase 16 at a tiny size on the CPU (group size 32): finite PPLs, the
    hyperparameters each method read, the trained methods' steps, block
    losses and depth cut; then the model packed and served against its
    fake-quant model, with the launches of the W4 or W8 path."""
    cpu = torch.device('cpu')
    rec, res = chip_smoke.phase16_compress(
        cpu, name, TINY_BF16, group_size=32, n_samples=4, seq_len=24,
        eval_tokens=480, eval_bs=2)
    method = chip_smoke.METHOD_QUANT[name]['method']
    assert rec['ok'] and rec['launches'] == ZERO_LAUNCHES
    assert rec['hyperparams'] == res['opt'].hyperparams()
    cut = chip_smoke.DEPTH_CUT.get(method)
    L = 2 if cut is None else min(2, cut[0])
    assert rec['layers'] == L
    assert (rec['depth_cut'] is None) == (cut is None)
    if method in chip_smoke.TRAINED_DEPTH:
        steps = {'NormTweaking': 10, 'OmniQuant': 20, 'TesseraQ': 300}
        assert rec['train_steps'] == steps[method] * L
        assert [r['block'] for r in rec['block_loss']] == list(range(L))
        assert all(r['after'] <= r['before'] for r in rec['block_loss'])
        assert rec['train_ms_per_step'] > 0
    srv = chip_smoke.phase_compress_serve(
        cpu, res, prompt_len=8, mode=mode, n_requests=4, max_batch=2,
        max_len=96, buckets=(16, 32), max_prompt=30)
    assert srv['ok'] and srv['all_done'] and srv['launches'] == ZERO_LAUNCHES
    assert srv['rel_logit_err_vs_fake_quant'] <= chip_smoke.TOL_COMPRESS_SERVE
    kernel = 'w8_dequant_matmul' if mode == 'w8a16' else 'w4_dequant_matmul'
    fw = srv['prefill_forwards'] + srv['decode_steps']
    assert srv['expected_launches'][kernel] == (4 * L + 1) * fw
    # packed on the method's own calibration and qparams; held against the
    # method's fake-quant model where packing holds its grid, else against
    # the weights packing holds, with the gap recorded
    assert srv['w_spec']['calib_algo'] == \
        chip_smoke.METHOD_QUANT[name]['weight'].get('calib_algo', 'minmax')
    gap = srv['packed_weight_gap']
    assert gap['max_excess_steps_stored_qparams'] <= chip_smoke.STORED_MOVE
    if method == 'HQQ':
        # the elements its float zeros clip, at most half a step off
        assert 0 < gap['share_moved'] < 0.05
        assert gap['max_excess_steps'] <= chip_smoke.STORED_MOVE
    elif method == 'AdaDim':
        ic = [c == 'ic' for c in res['opt'].dim_choice.values()]
        assert 0 < gap['off_grid_share'] == sum(ic) / len(ic)
    else:
        assert gap['off_grid_share'] == gap['share_moved'] == 0
        assert srv['rel_logit_err_vs_method_model'] == \
            srv['rel_logit_err_vs_fake_quant']
    if method == 'NormTweaking':
        # the shipped rate moves no bf16 norm: held to the pretrained model
        assert rec['norms_moved'] == 0
        assert rec['tolerance_ppl_transformed'] is not None


@pytest.mark.parametrize('name,mode', chip_smoke.PHASE17)
def test_chip_smoke_cpu_phase17_tiny(name, mode, monkeypatch):
    """Phase 17's methods at a tiny size on the CPU (TINY_BF16, 128 wide;
    group size 32 as phase 16's tiny run takes it, DGQ at its shipped 128,
    its int4 grain; QUIK's fp_features 128 cut to 8, since
    ``min(128, in - 1)`` would keep all but one of a 128-wide linear's
    columns fp): finite PPLs, the depth cut and its
    reason, the share each keeps fp (QUIK's columns, SpQR's outliers), the
    transformed PPL of QUIK and DGQ held to the pretrained one; then served
    on its mode (QUIK and DGQ W4A8, SpQR W4A16) against its own model or
    the weights packing holds, the gap recorded, DGQ's weights all on its
    grid and QUIK's int columns on QUIK's own."""
    cpu = torch.device('cpu')
    method = chip_smoke.METHOD_QUANT[name]['method']
    if method == 'QUIK':
        mq = chip_smoke.METHOD_QUANT[name]
        monkeypatch.setitem(chip_smoke.METHOD_QUANT, name, dict(
            mq, special=dict(mq['special'], fp_features=8)))
    rec, srv, res = chip_smoke.phase17_method(
        cpu, name, mode, TINY_BF16, serve_kw=dict(
            prompt_len=8, n_requests=4, max_batch=2, max_len=96,
            buckets=(16, 32), max_prompt=30),
        group_size=128 if method == 'DGQ' else 32, n_samples=4, seq_len=24,
        eval_tokens=480, eval_bs=2)
    cut = chip_smoke.DEPTH_CUT.get(method)
    L = 2 if cut is None else min(2, cut[0])
    assert rec['ok'] and rec['launches'] == ZERO_LAUNCHES
    assert rec['layers'] == L and rec['config'].endswith(f'{name}.yml')
    assert (rec['depth_cut'] is None) == (cut is None)
    assert rec['hyperparams'] == res['opt'].hyperparams()
    assert (rec['fp_column_share'] is None) == (method != 'QUIK')
    assert (rec['outlier_share'] is None) == (method != 'SpQR')
    if method == 'QUIK':
        # 8 of each linear's input columns
        assert rec['fp_column_share'] == 8 * 7 / (128 * 6 + 256)
    if method == 'SpQR':
        assert 0 < rec['outlier_share'] < 0.2
        assert rec['tolerance_ppl_transformed'] is None
    else:
        assert rec['tolerance_ppl_transformed'] == chip_smoke.TOL_PPL_EQUIV
        assert rec['ppl_transformed_rel_drift'] <= chip_smoke.TOL_PPL_EQUIV
    assert srv['ok'] and srv['all_done'] and srv['launches'] == ZERO_LAUNCHES
    assert srv['mode'] == mode and srv['layers'] == L
    fw = srv['prefill_forwards'] + srv['decode_steps']
    want = srv['expected_launches']
    if mode == 'w4a8':
        # the block linears through the quantizer and B3, the head B1
        assert want['w4a8_dequant_matmul'] == want['quant_act_token'] \
            == 4 * L * fw
        assert want['w4_dequant_matmul'] == fw
    else:
        assert want['w4_dequant_matmul'] == (4 * L + 1) * fw
    gap = srv['packed_weight_gap']
    assert gap['max_excess_steps_stored_qparams'] <= chip_smoke.STORED_MOVE
    if method == 'DGQ':
        assert gap['off_grid_share'] == gap['share_moved'] == 0
        assert srv['rel_logit_err_vs_method_model'] == \
            srv['rel_logit_err_vs_fake_quant']
    else:
        # QUIK's fp columns and SpQR's fp outliers are off the grid
        assert gap['off_grid_share'] > 0 and gap['share_moved'] > 0
        assert srv['held_against'] == \
            'that model with the weights packing holds'
    if method == 'QUIK':
        # its int columns on its own grid: the fp columns alone moved
        assert gap['max_excess_steps_stored_qparams'] <= chip_smoke.GRID_MOVE
        assert gap['share_moved'] <= rec['fp_column_share']
        assert srv['tolerance_vs_method_model'] == chip_smoke.TOL_QUIK_VS_OWN
        assert srv['rel_logit_err_vs_method_model'] <= \
            chip_smoke.TOL_QUIK_VS_OWN


def test_chip_smoke_cpu_decode_ppl_tiny():
    """The decode_ppl phase at a tiny size on the CPU: every PPL finite and
    recorded (three positions, KIVI as shipped, KIVI with a whole-sequence
    ring, Sink), the pretrain decode PPL against the prefill PPL, KIVI's fp
    ring against the fp cache, token consistency, ms a step per position,
    no launch anywhere (the CPU runs the plain versions), the depth cut
    with its reason."""
    rec, res = chip_smoke.phase_decode_ppl(
        torch.device('cpu'), TINY_BF16, layers=(2, 'tiny'), tokens=32,
        sink=(2, 8), n_samples=4, seq_len=24)
    assert rec['ok'], rec
    assert set(rec['decode_ppl']) == {'pretrain', 'fake_quant',
                                      'fake_quant_wo_kv', 'kivi',
                                      'kivi_ring_whole', 'sink'}
    assert set(rec['positions']) == set(rec['decode_ppl'])
    for row in rec['positions'].values():
        assert row['fed_steps'] == 31 and row['ms_per_step'] > 0
        assert row['launches'] == ZERO_LAUNCHES
        assert row['xla_branch_calls'] == 0
    assert rec['expected_flash_decode'] == dict.fromkeys(rec['decode_ppl'], 0)
    assert rec['kv_module']['method'] == 'naive'
    assert rec['policies']['kivi']['residual_length'] == 128
    assert rec['policies']['kivi_ring_whole']['residual_length'] == 32
    assert rec['depth_cut'] == dict(layers=2, reason='tiny')
    assert 0 < rec['token_consistency'] <= 1
    assert rec['decode_vs_prefill_rel'] <= chip_smoke.TOL_DECODE_VS_PREFILL
    assert rec['kivi_ring_whole_nll_rel_vs_fp_cache'] <= chip_smoke.TOL_FLASH
    # the int8 cache and the sink window change what is read
    ppl = rec['decode_ppl']
    assert ppl['fake_quant'] != ppl['fake_quant_wo_kv'] != ppl['sink']
    # the logits of every step against a prefill's: the fp decode inside
    # the bound, each planted fault at least twice outside it
    lg = rec['logits']
    assert lg['ok'] and lg['steps'] == 32
    assert lg['fp_vs_prefill'] <= chip_smoke.TOL_DECODE_LOGITS_VS_PREFILL
    assert lg['fp_vs_b2_plain'] <= chip_smoke.TOL_DECODE_LOGITS_B2_PLAIN
    assert set(lg['reads_vs_prefill']) == {'kivi_ring_whole', 'kivi',
                                           'naive_int8'}
    assert set(lg['faults_vs_prefill']) == {'naive_4bit', 'sink_window'}
    assert min(lg['faults_vs_prefill'].values()) >= \
        2 * chip_smoke.TOL_DECODE_LOGITS_VS_PREFILL
    assert lg['flash_decode_fp'] == lg['launches_plain'] == 0
    assert set(lg['nll_gap_vs_prefill']) == {'fp', 'b2_plain',
                                             'kivi_ring_whole'}
    assert lg['first_step_fp_vs_prefill'] <= lg['fp_vs_prefill']


def test_chip_smoke_cpu_probes_phase_tiny():
    """The probes phase at a tiny size on the CPU: both tools' records
    (plain versions, no launches) and the kernels line's entries."""
    rec = chip_smoke.phase_probes(torch.device('cpu'), Ms=(16, 77), K=2048,
                                  N=256)
    assert rec['phase'] == 'probes' and rec['Ms'] == [16, 77]
    assert rec['launches'] == rec['expected_launches'] == ZERO_LAUNCHES
    assert len(rec['kernel_bench']) == 2 * 7 and len(rec['w4_probe']) == 2 * 9
    assert all(r.get('ok', True) for r in rec['kernel_bench'] +
               rec['w4_probe'])
    launches = dict.fromkeys(chip_smoke.KERNEL_NAMES, 3)
    entries = [chip_smoke.probe_kernel_record(n, rec, launches, M=77)
               for n in chip_smoke.PROBE_KERNELS]
    assert [e['name'] for e in entries] == list(chip_smoke.PROBE_KERNELS)
    for e in entries:
        assert e['route'] == 'cuda' and e['launches'] == 3
        assert e['source'] == ('llmc_tpu_torch/csrc/'
                               + chip_smoke.PROBE_SOURCES[e['name']])
        assert (ROOT / e['source']).exists()
        path, line = e['replaces'].split(':')
        fn = e['replaces_fn'].split('::')[1]
        src = (ROOT / path).read_text().splitlines()
        # the line is the probe's pallas_call, inside the tool's wrapper
        # whose kernel function is ``replaces_fn``
        assert 'pallas_call' in src[int(line) - 1], e['replaces']
        assert f'def {fn}(' in (ROOT / path).read_text()
        assert set(e) >= {'max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                          'bound_by', 'library_ms'}


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


def test_chip_smoke_lists_seventeen_kernels_and_the_wgmma_builds():
    """The kernels line's names: the nine probes, B1's old design and the
    main paths' seven, the W4A8 quantizer after its GEMM; the wgmma
    kernels whose ptxas report the build phase holds to no spill, with
    their instantiation counts (B6: one or two 64-column units a step);
    and the quantizer's byte bound."""
    names = chip_smoke.KERNEL_NAMES
    assert len(names) == len(set(names)) == 17
    assert names.index('quant_act_token') == \
        names.index('w4a8_dequant_matmul') + 1
    assert chip_smoke.WGMMA_KERNELS == {
        'w4_dequant_matmul': 20, 'w4a8_dequant_matmul': 20,
        'w8_dequant_matmul': 40, 'fp8_block_gemm': 20}
    info = {'kernels': {f'_Z{i}{n}_kernelILi8EEv': {'registers': 90}
                        for n, k in chip_smoke.WGMMA_KERNELS.items()
                        for i in range(k)}}
    assert set(chip_smoke.wgmma_build(info)) == set(chip_smoke.WGMMA_KERNELS)
    info['kernels']['_Z0fp8_block_gemm_kernelILi8EEv']['spill_stores'] = 8
    with pytest.raises(chip_smoke.CheckFailed, match='spills'):
        chip_smoke.wgmma_build(info)
    peaks = chip_smoke.PEAKS['H100 SXM']
    ms, by = chip_smoke.quant_bound(128, 4096, 2, peaks)
    nbytes = 128 * 4096 * 3 + 4 * 128 + 4 * 64 * 128
    assert by == 'bytes' and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12


# phase 18's families at a tiny size, bf16, widths the decode kernels take
MOE_TINY = {
    'mixtral_8x7b': dict(vocab_size=256, hidden_size=128,
                         intermediate_size=256, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=32,
                         num_local_experts=4, num_experts_per_tok=2,
                         dtype='bfloat16'),
    'qwen15_moe_a27b': dict(vocab_size=256, hidden_size=128,
                            intermediate_size=128,
                            shared_expert_intermediate_size=256,
                            num_attention_heads=4, num_key_value_heads=4,
                            head_dim=32, num_local_experts=6,
                            num_experts_per_tok=2, dtype='bfloat16'),
    'deepseek_v2_lite': dict(vocab_size=256, hidden_size=128,
                             intermediate_size=256, moe_intermediate_size=128,
                             num_attention_heads=4, q_lora_rank=None,
                             kv_lora_rank=64, qk_nope_head_dim=32,
                             qk_rope_head_dim=16, v_head_dim=32,
                             n_routed_experts=4, n_shared_experts=1,
                             num_experts_per_tok=2, first_k_dense_replace=1,
                             dtype='bfloat16'),
}


@pytest.mark.parametrize('name', sorted(MOE_TINY))
def test_chip_smoke_cpu_phase18_tiny(name):
    """Phase 18 at a tiny size on the CPU (every step eager, no kernel):
    each family served once per attention kernel it names, the eager
    run's tokens equal to the graph run's, the launches the path implies
    (B2 or B5 once a layer a decode step on Mixtral and Qwen2-MoE, none on
    DeepSeek's latent cache); the step bound, the latent cache's bytes;
    then its compressions (RTN's transformed PPL equal to pretrain; Mixtral
    GPTQ's column loop; DeepSeek's AWQ on one MoE block, its searched block
    erring no more than RTN)."""
    cpu = torch.device('cpu')
    spec = chip_smoke.MOE_MODELS[name]
    rec, model = chip_smoke.phase18_serve(
        cpu, name, chip_smoke.PEAKS['H100 SXM'], layers=2,
        arch=MOE_TINY[name], serve_kw=dict(
            n_requests=4, max_batch=2, max_len=96, buckets=(16, 32),
            max_prompt=30), timing_kw=dict(B=2, prompt=16, steps=2,
                                           max_len=96))
    # ``ok`` needs the card's launches and at least 8 requests: not here
    assert rec['model'] == spec['type'] and rec['layers'] == 2
    assert sorted(rec['runs']) == sorted(a or 'latent'
                                         for a in spec['attn'])
    for attn, run in rec['runs'].items():
        assert run['tokens_equal']
        for m in ('graph', 'eager'):
            r = run[m]
            assert r['launches'] == ZERO_LAUNCHES and r['all_done']
            want = dict(ZERO_LAUNCHES)
            if attn != 'latent':
                kernel = 'batch_decode' if attn == 'batch' else 'flash_decode'
                want[kernel] = 2 * r['decode_steps']
            assert r['expected_launches'] == want
        t = rec['timing'][attn]
        assert all(t[m]['step_ms'] > 0 and t[m]['ttft_s'] > 0
                   for m in ('graph', 'eager'))
    assert rec['step_bound_ms'] > 0 and rec['bound_by'] == 'bytes'
    assert rec['step_bound_ms'] <= rec['dense_dispatch_bound_ms']
    dvp = rec['decode_vs_prefill']
    assert dvp['ok'] and dvp['layers'] == 2
    assert dvp['cache'] == ('latent' if name == 'deepseek_v2_lite'
                            else 'per-head')
    assert all(v == dict(ZERO_LAUNCHES, xla_branch_calls=0)
               for v in dvp['launches'].values())
    if name == 'deepseek_v2_lite':
        assert rec['latent_int8_bytes_per_token'] == 64 + 4 + 16 * 2
        assert rec['per_head_bytes_per_token'] == 4 * (48 + 32) * 2
        assert any('yarn' in r for r in rec['reduced'])
    recs = chip_smoke.phase18_compress(
        cpu, name, layers=2, arch=MOE_TINY[name], group_size=32,
        n_samples=2, seq_len=32, eval_tokens=256, eval_bs=2)
    assert [r['config'] for r in recs] == [
        c[0] for c in chip_smoke.MOE_COMPRESS[name]]
    for r in recs:
        assert r['ok'] and r['launches'] == ZERO_LAUNCHES
        if r['method'] == 'RTN':
            assert r['ppl_transformed'] == r['ppl_pretrain']
        if r['method'] == 'GPTQ':
            assert r['column_steps'] > 0
        if r['method'] == 'Awq':
            assert r['block_output_mse'] and all(
                b['searched_over_rtn'] <= chip_smoke.TOL_SEARCH_VS_RTN
                for b in r['block_output_mse'])



def test_moe_step_bound_counts_the_routed_experts():
    """The step bound reads of each MoE block's routed experts only those
    B tokens x top-k can pick (min(E, B k) of E), beside the expected
    coverage under random picks and dense dispatch's every expert; the
    shared expert, the router, attention and the head count whole."""
    from llmc_tpu_torch.models import build_model
    arch = dict(MOE_TINY['qwen15_moe_a27b'], num_hidden_layers=2)
    m = build_model(dict(model=dict(type='Qwen2Moe', arch=arch, seed=0)),
                    device='cpu')
    peaks = chip_smoke.PEAKS['H100 SXM']
    b = chip_smoke.moe_step_bound(m, peaks, B=2)
    D, I, E = 128, 128, 6
    routed = 2 * E * 3 * I * D * 2          # layers x experts x bf16 bytes
    assert b['routed_expert_bytes'] == routed
    dense = b['dense_dispatch_bytes']
    assert dense == chip_smoke.param_bytes(m.params['blocks']) \
        + chip_smoke.param_bytes(m.params['lm_head'])
    assert b['weight_bytes_bound'] == dense - routed + routed * 4 / 6
    assert abs(b['expected_coverage_bytes']
               - (dense - routed + routed * 5 / 9)) < 1e-6
    assert b['step_bound_ms'] == b['weight_bytes_bound'] / peaks.bw * 1e3
    # B k over E: every expert, as dense dispatch reads
    full = chip_smoke.moe_step_bound(m, peaks, B=8)
    assert full['weight_bytes_bound'] == dense