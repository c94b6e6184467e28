"""The w4 design probes of the PyTorch port against the JAX tools.

Each plain version of ``llmc_tpu_torch/ops/probe_gemm.py`` is held against
the Pallas kernel of ``tools/kernel_bench.py`` / ``tools/w4_probe.py``
that it ports, run in interpret mode on the CPU: the kernel and its
wrapper are taken out of the tool's source by ``ast`` (they are local to
the tools' ``main``) and run in a namespace whose ``pl.pallas_call`` is
interpreted, at a small shape, with ``tn=128``.  The Hopper kernels are
held against the plain versions on the card (``gpu`` marker)."""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llmc_tpu_torch.ops import probe_gemm as P
from llmc_tpu_torch.ops.dequant_matmul import QMeta, pack_weight
from llmc_tpu_torch.tools import kernel_bench, w4_probe
from llmc_tpu_torch.tools._measure import bound
from llmc_tpu_torch.utils.device import PEAKS
from torch_port_helpers import cuda_device, rel_err  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
M, K, N, GS = 16, 2048, 256, 128
# bf16 outputs: every product is exact in f32 (bf16 values, or the same
# bf16 weight product on both sides), so the two differ by the f32
# summation order and one bf16 rounding of each output
TOL = 1e-2


def _tool_defs(name):
    tree = ast.parse((ROOT / 'tools' / name).read_text())
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


KB, WP = _tool_defs('kernel_bench.py'), _tool_defs('w4_probe.py')

# case -> (tool's defs, [kernel, wrapper], keyword arguments of the call)
TOOL_CASES = {
    'kernel_bench.bf16_pallas': (KB, ['_bf16_kernel', 'bf16_pallas'], {}),
    'w4_probe.bf16_pallas': (WP, ['_bf16_kernel', 'bf16_pallas'], {}),
    'w4_probe.bf16_big': (WP, ['_bf16_big', 'bf16_big'], {}),
    'kernel_bench.i8_pallas': (KB, ['_i8_kernel', 'i8_pallas'], {}),
    'w4_probe.i8_big': (WP, ['_i8_big', 'i8_big'], {}),
    'w4_probe.i8i8': (WP, ['_i8i8', 'i8i8'], {}),
    'w4_probe.w4_block': (WP, ['_w4_block', 'w4_block'], {}),
    'kernel_bench.fullq_g4': (KB, ['_fullq_kernel', 'fullq'],
                              {'groups': 4}),
    'kernel_bench.fullq_g8': (KB, ['_fullq_kernel', 'fullq'],
                              {'groups': 8}),
    'kernel_bench.i32_pallas': (KB, ['_i32_kernel', 'i32_pallas'], {}),
    'kernel_bench.xc_g4': (KB, ['_xc_kernel', 'xc_pallas'], {'groups': 4}),
    'kernel_bench.xc_g8': (KB, ['_xc_kernel', 'xc_pallas'], {'groups': 8}),
    'w4_probe.i4_big': (WP, ['_i4_big', 'i4_big'], {}),
}


def test_every_tool_kernel_is_found():
    """A drift in ``tools/`` (a probe renamed or removed) fails here."""
    for defs, names, _ in TOOL_CASES.values():
        assert all(n in defs for n in names), names
    # every function of the two tools that calls pallas_call itself (not
    # through a function nested in it) has a case
    def calls_pallas(fn):
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Attribute) and node.attr == 'pallas_call':
                return True
            if not isinstance(node, ast.FunctionDef):
                stack.extend(ast.iter_child_nodes(node))
        return False
    calls = {fn.name for defs in (KB, WP) for fn in defs.values()
             if calls_pallas(fn)}
    assert calls == {names[1] for _, names, _ in TOOL_CASES.values()}


@functools.lru_cache(maxsize=None)
def operands(seed=0, m=M, k=K, n=N):
    """numpy operands, bf16 values where the tools take bf16."""
    rng = np.random.RandomState(seed)
    bf = jnp.bfloat16
    x = rng.randn(m, k).astype(np.float32).astype(bf)
    codes = rng.randint(-8, 8, size=(n, k)).astype(np.int8)
    scales = (rng.rand(n, k // GS) * 0.01 + 0.005).astype(np.float32)
    meta = QMeta(bits=4, group_size=GS, symmetric=True, out_features=n,
                 in_features=k)
    packed, s, _ = pack_weight(torch.from_numpy(codes),
                               torch.from_numpy(scales), None, meta)
    return dict(x=x, wb=rng.randn(n, k).astype(np.float32).astype(bf),
                codes=codes, packed=packed.numpy(), s=s.numpy(),
                s_t=np.ascontiguousarray(s.numpy().T),
                w32=rng.randint(0, 2 ** 31, size=(n, k // 8)).astype(
                    np.int32))


def _t(a, dev='cpu'):
    """A numpy operand as a torch tensor (bf16 stays bf16)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(
            dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _tool_fn(case, **closure):
    defs, names, _ = TOOL_CASES[case]
    ipl = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith('_')})
    ipl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(functools=functools, jax=jax, jnp=jnp, pl=ipl, pltpu=pltpu,
              F32=jnp.float32, M=M, K=K, N=N, GS=GS, gs_eff=GS, **closure)
    mod = ast.Module(body=[defs[n] for n in names], type_ignores=[])
    exec(compile(mod, f'tools:{case}', 'exec'), ns)
    return ns[names[1]]


def _jax_and_port(case):
    """(the tool's output, the port's plain version's) on one input."""
    o = operands()
    x, xe, xc = o['x'], o['x'][:, :K // 2], o['x'][:, K // 2:]
    tx = _t(x)
    kw = dict(TOOL_CASES[case][2], tn=128)
    if case.endswith('bf16_pallas') or case.endswith('bf16_big'):
        want = _tool_fn(case)(x, o['wb'], **kw)
        plain = P.bf16_chunked_plain if 'pallas' in case else \
            P.bf16_bigdot_plain
        got = plain(tx, _t(o['wb']))
    elif case.endswith(('i8_pallas', 'i8_big')):
        want = _tool_fn(case, wi8=jnp.asarray(o['codes']))(
            x, jnp.asarray(o['codes']), **kw)
        got = P.i8_cast_plain(tx, _t(o['codes']))
    elif case.endswith('w4_block'):
        want = _tool_fn(case)(x, jnp.asarray(o['packed']),
                              jnp.asarray(o['s']), **kw)
        got = P.w4_blockdecode_plain(tx, _t(o['packed']), _t(o['s']))
    elif '.fullq' in case:
        want = _tool_fn(case)(x, jnp.asarray(o['packed']),
                              jnp.asarray(o['s_t']), **kw)
        got = P.w4_fullq_plain(tx, _t(o['packed']), _t(o['s_t']))
    elif case.endswith('i32_pallas'):
        want = _tool_fn(case)(x, jnp.asarray(o['w32']), **kw)
        got = P.i32_window_plain(tx, _t(o['w32']))
    elif '.xc' in case:
        want = _tool_fn(case)(jnp.asarray(xe), jnp.asarray(xc),
                              jnp.asarray(o['packed']),
                              jnp.asarray(o['s_t']), **kw)
        got = P.w4_xc_plain(_t(np.ascontiguousarray(xe)),
                            _t(np.ascontiguousarray(xc)), _t(o['packed']),
                            _t(o['s_t']))
    elif case.endswith('i4_big'):
        want = _tool_fn(case)(x, jnp.asarray(o['codes']).astype(jnp.int4),
                              **kw)
        got = P.i4_native_plain(tx, P.pack_i4_native(_t(o['codes'])))
    else:                                   # i8i8: the chain of the tool
        want = _tool_fn(case)(x, jnp.asarray(o['codes']), **kw)
        got = w4_probe.from_x16(P.i8xi8_int32_plain(w4_probe.quant_x16(tx),
                                                    _t(o['codes'])))
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize('case', [c for c in TOOL_CASES
                                  if not c.endswith('i8i8')])
def test_plain_version_matches_the_tool_kernel(case):
    want, got = _jax_and_port(case)
    assert want.shape == got.shape == (M, N)
    assert np.isfinite(got).all() and rel_err(got, want) <= TOL


def test_int8_dot_exact_and_its_bf16_bit_equal_to_the_tool():
    """Row 10: the int32 product equals numpy's int64 one, and the tool's
    /16 -> bf16 of it is bit-equal to the tool's output."""
    want, got = _jax_and_port('w4_probe.i8i8')
    np.testing.assert_array_equal(got, want)
    o = operands()
    xq = w4_probe.quant_x16(_t(o['x']))
    ref = np.clip(np.round(o['x'].astype(np.float32) * 16), -127, 127)
    np.testing.assert_array_equal(xq.numpy(), ref.astype(np.int8))
    y = P.i8xi8_int32_plain(xq, _t(o['codes']))
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(
        y.numpy(), xq.numpy().astype(np.int64) @
        o['codes'].astype(np.int64).T)


def test_i4_native_layout_round_trip():
    codes = np.random.RandomState(3).randint(-8, 8, size=(6, 64))
    t = torch.from_numpy(codes).to(torch.int8)
    packed = P.pack_i4_native(t)
    assert packed.dtype == torch.uint8 and packed.shape == (6, 32)
    np.testing.assert_array_equal(P.unpack_i4_native(packed).numpy(), codes)
    # two's complement, column 2c in the low nibble of byte c
    b = P.pack_i4_native(torch.tensor([[-1, 7, -8, 0]], dtype=torch.int8))
    assert b.tolist() == [[0x7F, 0x08]]
    with pytest.raises(ValueError, match='-8..7'):
        P.pack_i4_native(torch.tensor([[8, 0]], dtype=torch.int8))


def _probe_args(name, m, k, n, dev, seed=0):
    """Torch operands of one probe wrapper on ``dev``."""
    o = operands(seed, m, k, n)
    x = _t(o['x'], dev)
    return {'bf16_chunked': (x, _t(o['wb'], dev)),
            'bf16_bigdot': (x, _t(o['wb'], dev)),
            'i8_cast': (x, _t(o['codes'], dev)),
            'i8xi8_int32': (w4_probe.quant_x16(x), _t(o['codes'], dev)),
            'w4_blockdecode': (x, _t(o['packed'], dev), _t(o['s'], dev)),
            'w4_fullq': (x, _t(o['packed'], dev), _t(o['s_t'], dev)),
            'i32_window': (x, _t(o['w32'], dev)),
            'w4_xc': (x[:, :k // 2].contiguous(), x[:, k // 2:].contiguous(),
                      _t(o['packed'], dev), _t(o['s_t'], dev)),
            'i4_native': (x, P.pack_i4_native(_t(o['codes'], dev)))}[name]


@pytest.mark.parametrize('name', list(P.PROBES))
def test_wrapper_takes_the_plain_version_on_cpu(name):
    """On a CPU tensor (and with force_plain) a wrapper is its plain
    version and launches nothing."""
    wrapper, plain = P.PROBES[name]
    args = _probe_args(name, M, K, N, 'cpu')
    before = dict(P.LAUNCHES)
    want = plain(*args)
    assert torch.equal(wrapper(*args), want)
    assert torch.equal(wrapper(*args, force_plain=True), want)
    assert want.shape == (M, N) and P.LAUNCHES == before
    assert want.dtype == (torch.int32 if name == 'i8xi8_int32'
                          else torch.bfloat16)


def _jax_tool_keys():
    """The keys the JAX tools print: kernel_bench's ``out[...]`` and
    w4_probe's ``f'{tag}_...'`` suffixes, a ``_g4`` / ``_g8`` pair as one."""
    kb = {n.slice.value for n in ast.walk(ast.parse(
        (ROOT / 'tools' / 'kernel_bench.py').read_text()))
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
        and n.value.id == 'out' and isinstance(n.slice, ast.Constant)}
    kb = {k.removesuffix('_g4').removesuffix('_g8') for k in kb}
    wp = {n.values[1].value.removeprefix('_') for n in ast.walk(ast.parse(
        (ROOT / 'tools' / 'w4_probe.py').read_text()))
        if isinstance(n, ast.JoinedStr) and len(n.values) == 2
        and isinstance(n.values[1], ast.Constant)
        and isinstance(n.values[0], ast.FormattedValue)
        and getattr(n.values[0].value, 'id', None) == 'tag'}
    return kb, wp


def test_tools_on_cpu_give_every_key_of_the_jax_tools():
    kb_keys, wp_keys = _jax_tool_keys()
    assert {'w4_current', 'w4_fullq', 'w4_xc', 'xc_gbs'} <= kb_keys
    assert {'w4_current', 'i4_native_xla', 'i8xi8_int32dot'} <= wp_keys
    recs = kernel_bench.run('cpu', M=(16, 77), K=K, N=N)
    summ = kernel_bench.summary(recs, N=N, K=K)
    assert [s['M'] for s in summ] == [16, 77]
    assert set(summ[0]) - {'M'} == kb_keys
    recs_wp = w4_probe.run('cpu', M=(16, 32), K=K, N=N)
    assert {k for s in w4_probe.summary(recs_wp) for k in s} == \
        {f'm{m}_{k}' for m in (16, 32) for k in wp_keys}
    for r in recs + recs_wp:
        # nothing is timed on the CPU; the bound is the card's
        assert r['ms'] is None and r['library_ms'] is None
        assert r['bound_ms'] > 0 and r['bound_by'] in ('bytes', 'operations')
        assert r.get('ok', True) and r['calls'] == 0
    assert {r['kernel'] for r in recs + recs_wp} - {None} == \
        set(P.PROBES) | {'w4_mma_sync'}


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the tools would run on it')
    for tool in (kernel_bench, w4_probe):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tool.run()


def test_ab_serve_needs_a_card_and_runs_each_tree_in_its_root(tmp_path,
                                                             monkeypatch):
    """The A/B serving tool exits 2 without a card; with one it runs the
    trees in the order A, B, B, A, each as a subprocess in its own root,
    and tags every record with its tree and turn."""
    from llmc_tpu_torch.tools import ab_serve
    if not torch.cuda.is_available():
        assert ab_serve.main([str(tmp_path), str(tmp_path)]) == 2
    calls = []

    class Done:
        returncode, stderr = 0, ''
        stdout = 'nvcc log\n{"phase": "throughput", "ttft_ms": 1.0}\n'

    def fake_run(cmd, cwd, **kw):
        calls.append(cwd)
        assert 'chip_smoke' in cmd[-1] and "['w4a16']" in cmd[-1]
        return Done()
    monkeypatch.setattr(ab_serve.subprocess, 'run', fake_run)
    a, b = tmp_path / 'a', tmp_path / 'b'
    recs = [r for turn, (tag, tree) in enumerate(
        [('A', a), ('B', b), ('B', b), ('A', a)])
        for r in ab_serve.run_tree(tree, ['w4a16'], tag, turn)]
    assert calls == [a, b, b, a]
    assert [(r['tree'], r['turn'], r['phase']) for r in recs] == [
        ('A', 0, 'throughput'), ('B', 1, 'throughput'),
        ('B', 2, 'throughput'), ('A', 3, 'throughput')]


def test_ab_serve_takes_the_batch_and_prefill_of_both_phases(monkeypatch):
    """``--batch 8 --prefill 1024`` reaches the throughput and the profile
    phase of every tree (the long-context row of chip_smoke's profile)."""
    from llmc_tpu_torch.tools import ab_serve
    codes = []

    class Done:
        returncode, stderr, stdout = 0, '', '{"phase": "profile"}\n'

    def fake_run(cmd, cwd, **kw):
        codes.append(cmd[-1])
        return Done()
    monkeypatch.setattr(ab_serve.subprocess, 'run', fake_run)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'card')
    monkeypatch.setattr(ab_serve, 'nvidia_smi_line', lambda: 'card, 700 W')
    assert ab_serve.main(['a', 'b', '--modes', 'w4a16', '--batch', '8',
                          '--prefill', '1024']) == 0
    assert len(codes) == 4
    for code in codes:
        assert code.count('B=8,') == 2 and code.count('prefill=1024,') == 2
        compile(code, 'ab_serve', 'exec')


def test_ab_attention_times_chip_smokes_attention_rows(monkeypatch):
    """The A/B attention tool's rows are chip_smoke's ``FLASH_SHAPES``, and
    each tree's subprocess times its own ``flash_decode_cuda``."""
    import chip_smoke
    from llmc_tpu_torch.tools import ab_attention, ab_serve
    assert ab_attention.ROWS == chip_smoke.FLASH_SHAPES
    codes = []

    class Done:
        returncode, stderr, stdout = 0, '', '{"B": 8, "kernel_ms": 0.1}\n'

    def fake_run(cmd, cwd, **kw):
        codes.append((cwd, cmd[-1]))
        return Done()
    monkeypatch.setattr(ab_serve.subprocess, 'run', fake_run)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'card')
    monkeypatch.setattr(ab_serve, 'nvidia_smi_line', lambda: 'card, 700 W')
    assert ab_attention.main(['a', 'b']) == 0
    assert [c[0].name for c in codes] == ['a', 'b', 'b', 'a']
    assert all('flash_decode_cuda' in c[1] and '(1, 4096, 32, 32' in c[1]
               and 'if False:' in c[1] for c in codes)
    # the serving-batch kernel, through a CUDA graph too
    codes.clear()
    assert ab_attention.main(['a', 'b', '--kernel', 'batch_decode',
                              '--graph']) == 0
    assert [c[0].name for c in codes] == ['a', 'b', 'b', 'a']
    for _, code in codes:
        assert 'batch_decode_cuda as kernel' in code
        assert 'if True:' in code and 'C.graph_ms(kern)' in code
        compile(code, 'ab_attention', 'exec')


@pytest.mark.parametrize('kernel, variant', [
    (k, v) for k in ('w4_dequant_matmul', 'w8_dequant_matmul')
    for v in ('no_decode', 'no_wgmma')] + [
    ('w8_dequant_matmul', 'two_group_lookup')])
def test_wgmma_variants_cut_the_shipping_sources(kernel, variant):
    """Each attribution variant finds its anchors once in the shipping
    source and changes it (a stale variant would raise, not time the
    kernel as built)."""
    from llmc_tpu_torch.ops import _build
    from llmc_tpu_torch.tools import wgmma_variants as V
    source = V.VARIANTS[kernel][0]
    cut = V.variant_source(kernel, variant)
    assert cut != (_build.CSRC / source).read_text()
    for old, new in V.VARIANTS[kernel][1][variant]:
        assert old not in cut and new in cut


@pytest.mark.parametrize('kernel, variant', [
    ('w4a8_dequant_matmul', 'no_decode'), ('w4a8_dequant_matmul', 'no_wgmma'),
    ('w4a8_dequant_matmul', 'no_epilogue'),
    ('fp8_block_gemm', 'no_promotion')])
def test_wgmma_variants_of_b3_and_b6(kernel, variant):
    """B3's and B6's variants: a text cut finds its anchors once and
    changes the source."""
    from llmc_tpu_torch.ops import _build
    from llmc_tpu_torch.tools import wgmma_variants as V
    source, variants = V.VARIANTS[kernel]
    text = (_build.CSRC / source).read_text()
    cut = V.variant_source(kernel, variant)
    assert cut != text
    for old, new in variants[variant]:
        assert old not in cut and new in cut


def test_wgmma_variants_times_only_the_kernels_asked_for(monkeypatch):
    """``--kernels`` and ``--M`` narrow the run: only the named kernels'
    variants are built, and each is timed at each M in turns with the
    library as built (built, variant, variant, built), which is loaded
    again at the end; an unknown kernel is refused."""
    from llmc_tpu_torch.tools import wgmma_variants as V
    built, order = object(), []
    monkeypatch.setattr(V._build, '_LIB', None)
    monkeypatch.setattr(V._build, 'lib', lambda: built)
    monkeypatch.setattr(V.torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(V.torch, 'Generator',
                        lambda device: types.SimpleNamespace(
                            manual_seed=lambda seed: None))
    monkeypatch.setattr(V, 'build_variant', lambda k, v: (k, v))
    monkeypatch.setattr(V, '_operands', lambda *a: (None,) * 4)
    monkeypatch.setattr(V, '_timer', lambda *a: None)

    def fake_ms(call, iters):
        order.append(V._build._LIB)
        return 1.0
    monkeypatch.setattr(V, 'cuda_ms', fake_ms)
    kernel = 'w8_dequant_matmul'
    variants = list(V.VARIANTS[kernel][1])
    recs = V.run(Ms=(1, 128), kernels=[kernel])
    assert [(r['kernel'], r['variant'], r['M']) for r in recs] == [
        (kernel, v, M) for M in (1, 128) for v in variants]
    assert order == [lib for M in (1, 128) for v in variants
                     for lib in (built, (kernel, v), (kernel, v), built)]
    assert V._build._LIB is built
    with pytest.raises(SystemExit):
        V.main(['--kernels', 'no_such_kernel'])


def test_bounds_follow_the_data_sheet():
    """The gate_up shape's bounds against the H100 SXM's data-sheet peaks,
    and a record's bound from its own shape."""
    pk = PEAKS['H100 SXM']
    n, k = 22016, 4096
    for m, nbytes, peak, ms, by in (
            (128, 2 * 128 * k + 2 * n * k + 2 * 128 * n, 'bf16', 0.0558,
             'bytes'),
            (128, 128 * k + n * k + 4 * 128 * n, 'int8', 0.0305, 'bytes'),
            (128, 2 * 128 * k + n * k // 2 + 2 * 128 * n, 'bf16', 0.0233,
             'operations'),
            (4096, 2 * 4096 * k + 2 * n * k + 2 * 4096 * n, 'bf16', 0.747,
             'operations'),
            (4096, 4096 * k + n * k + 4 * 4096 * n, 'int8', 0.373,
             'operations')):
        got, got_by = bound(nbytes, 2 * m * n * k, peak, pk)
        assert got_by == by and abs(got - ms) < 5e-4 * max(1, ms / 0.05)
    rec = {r['name']: r for r in w4_probe.run('cpu', M=(128,), K=K, N=N)}
    assert (rec['m128_i8xi8_int32dot']['bound_ms'],
            rec['m128_i8xi8_int32dot']['bound_by']) == bound(
        128 * K + N * K + 4 * 128 * N, 2 * 128 * N * K, 'int8', pk)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

GPU_K, GPU_N = 2048, 328   # N off the 128-column tile; small: split-K


@pytest.mark.gpu
@pytest.mark.parametrize('m', [1, 77, 128])
@pytest.mark.parametrize('name', list(P.PROBES))
def test_kernel_matches_plain_on_card(cuda_device, name, m):
    wrapper, plain = P.PROBES[name]
    args = _probe_args(name, m, GPU_K, GPU_N, cuda_device, seed=m)
    before = P.LAUNCHES[name]
    got = wrapper(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert P.LAUNCHES[name] == before + 1
    assert got.shape == (m, GPU_N) and got.dtype == want.dtype
    if name == 'i8xi8_int32':
        assert torch.equal(got, want)
    else:
        assert bool(torch.isfinite(got).all())
        assert P.rel_err(got, want)[1] <= P.TOL_BF16


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(P.PROBES))
def test_wrapper_refuses_what_its_kernel_does_not_take(cuda_device, name):
    wrapper, _ = P.PROBES[name]
    args = _probe_args(name, 16, GPU_K, 256, cuda_device)
    first, rest = args[0], args[1:]
    for bad in ((first.float(),) + rest,                   # dtype
                (first[:, :-128].contiguous(),) + rest,     # K off the weight
                (first.T.contiguous().T,) + rest):          # not contiguous
        with pytest.raises(ValueError):
            wrapper(*bad)


@pytest.mark.gpu
def test_kernels_refuse_a_k_their_chunks_do_not_divide(cuda_device):
    """K = 9 * 128: no whole group pair (w4_blockdecode) and no whole
    1024-column window (i32_window)."""
    k, n = 1152, 256
    x = torch.zeros((16, k), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match='multiple of 256'):
        P.w4_blockdecode(
            x, torch.zeros((n, k // 2), dtype=torch.uint8,
                           device=cuda_device),
            torch.ones((n, k // 128), device=cuda_device))
    with pytest.raises(ValueError, match='multiple of 1024'):
        P.i32_window(x, torch.zeros((n, k // 8), dtype=torch.int32,
                                    device=cuda_device))


def test_attention_variant_cuts_the_shipping_source():
    """The serving-batch kernel's scale-loading variant finds each anchor
    once in the shipping source and changes it (a stale variant would
    raise rather than time the kernel as built)."""
    from llmc_tpu_torch.ops import _build
    from llmc_tpu_torch.tools import attention_variants as V
    text = (_build.CSRC / V.SOURCE).read_text()
    for variant, cuts in V.VARIANTS.items():
        cut = V.variant_source(variant)
        assert cut != text
        for old, new, _ in cuts:
            assert new in cut


def test_attention_variants_records_a_variant_off_the_plain_version(
        monkeypatch):
    """A variant more than 2e-4 off the plain version is recorded with
    its error and not timed; one within it is timed in turns with the
    built kernel (built, variant, variant, built); the built kernel off
    the plain version stops the run."""
    import chip_smoke as C
    from llmc_tpu_torch.ops import batch_decode as BD
    from llmc_tpu_torch.tools import attention_variants as V
    built = object()
    errs = {'built': 1e-7, 'good': 1e-6, 'off': 3e-4}
    libs = {id(built): 'built'}
    order = []
    monkeypatch.setattr(V._build, '_LIB', None)
    monkeypatch.setattr(V._build, 'lib', lambda: built)
    monkeypatch.setattr(V.torch.cuda, 'is_available', lambda: True)

    def fake_build(kernel, variant, source, text):
        lib = object()
        libs[id(lib)] = variant
        return lib
    monkeypatch.setattr(V, 'build_source', fake_build)
    monkeypatch.setattr(V, 'variant_source', lambda v: '')
    monkeypatch.setattr(C, 'FLASH_SHAPES', ((2, 32, 1, 1, (16,)),))
    monkeypatch.setattr(C, 'flash_inputs', lambda *a, **k: (None,) * 5)
    monkeypatch.setattr(V.torch, 'full', lambda *a, **k: None)
    monkeypatch.setattr(BD, 'batch_decode_plain', lambda *a: 'want')
    monkeypatch.setattr(BD, 'batch_decode_cuda',
                        lambda *a: libs[id(V._build._LIB)])
    monkeypatch.setattr(C, '_rel', lambda got, want: (0.0, errs[got]))

    def timer(fn, *a):
        order.append(libs[id(V._build._LIB)])
        return 1.0
    monkeypatch.setattr(V, 'cuda_ms', timer)
    monkeypatch.setattr(C, 'graph_ms', lambda fn: 1.0)
    monkeypatch.setattr(V, 'VARIANTS', {'good': [], 'off': []})
    recs = list(V.run(('good', 'off')))
    assert [(r['variant'], r['timed']) for r in recs] == [('good', True),
                                                          ('off', False)]
    assert recs[1]['rel_err'] == {'built': 1e-7, 'off': 3e-4}
    assert recs[1]['graph_ms'] == {'built': [], 'off': []}
    assert order == ['built', 'good', 'good', 'built']
    assert V._build._LIB is built
    errs['built'] = 3e-4
    with pytest.raises(RuntimeError, match='built kernel'):
        list(V.run(('good',)))
