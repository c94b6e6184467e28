"""``chip_smoke.py``'s phase 19 at a tiny size on the CPU (every step
eager, no kernel): each family of ``FAMILY_MODELS`` built by its adapter,
its decode held to a prefill, its packed logits to the fake-quant model,
served through the engine (the eager run's tokens equal to the graph
run's, no launch, the launches the card's path implies: B1 once a packed
linear and the head a forward, B2 / B5 once a layer a decode step only
where attn_ok), the step bound; then the compressed families' RTN and AWQ
on one block."""

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

CPU = torch.device('cpu')
ZERO = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
# widths the W4 g128 packing takes (K a multiple of 128); Gemma2's window
# longer than the decode checks' 32 steps, as Gemma-2-9B's 4096 is: the
# prefill they are held to runs the block function, which (as the
# reference's) windows no layer
TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_attention_heads=2, num_key_value_heads=1, head_dim=64,
            dtype='bfloat16')
TINY_ARCH = {
    'qwen25_7b': dict(TINY, attention_bias=True, rope_theta=1e6),
    'qwen3_8b': dict(TINY, use_qk_norm=True),
    'gemma2_9b': dict(TINY, attn_logit_softcap=50.0,
                      final_logit_softcap=30.0, query_pre_attn_scalar=64.0,
                      sliding_window=48),
    'bloom_7b1': dict(TINY, num_key_value_heads=2),
}
# the decode checks' planted fault: the card's 4-bit cache, but a 3-bit
# one on the tiny Bloom, where ALiBi's recent-token weighting and the
# LayerNorms damp a 4-bit cache's error to 0.049 over 128 channels, under
# twice the bound (at Bloom-7b1's width on the card it reads 0.074)
TINY_FAULTS = {'bloom_7b1': dict(fault_bit=3, record_bits=(4,))}


@pytest.mark.parametrize('name', sorted(chip_smoke.FAMILY_MODELS))
def test_chip_smoke_cpu_phase19_tiny(name):
    spec = chip_smoke.FAMILY_MODELS[name]
    rec, model = chip_smoke.phase19_serve(
        CPU, name, chip_smoke.PEAKS['H100 SXM'], layers=2,
        arch=TINY_ARCH[name], serve_kw=dict(
            n_requests=4, max_batch=2, max_len=96, buckets=(16, 32),
            max_prompt=30, new_tokens=4),
        timing_kw=dict(B=2, prompt=16, steps=2, max_len=96),
        decode_kw=dict(steps=32, **TINY_FAULTS.get(name, {})))
    assert type(model).__name__ == f'{spec["type"]}Adapter'
    assert rec['layers'] == 2 and sorted(rec['runs']) == sorted(spec['attn'])
    takes = name in ('qwen25_7b', 'qwen3_8b')
    assert rec['attention_kernel'] is takes
    for attn, run in rec['runs'].items():
        assert run['tokens_equal']
        for m in ('graph', 'eager'):
            r = run[m]
            assert r['launches'] == ZERO and r['all_done']
            assert r['xla_branch_calls'] == 0
            forwards = r['prefill_forwards'] + r['host_decode_steps']
            want = dict(ZERO, w4_dequant_matmul=9 * forwards)
            if takes:
                kernel = 'batch_decode' if attn == 'batch' else 'flash_decode'
                want[kernel] = 2 * r['host_decode_steps']
            assert r['expected_launches'] == want
    dvp, pvf = rec['decode_vs_prefill'], rec['packed_vs_fake_quant']
    assert dvp['ok'] and pvf['ok'] and pvf['layers'] == 2
    assert sorted(dvp['faults_vs_prefill']) + sorted(
        dvp['recorded_faults_vs_prefill']) == (
        ['int3', 'int4'] if name == 'bloom_7b1' else ['int4', 'int3'])
    assert dvp['expected_launches']['flash_decode'] == 0     # no card
    assert rec['weight_bound_ms'] > 0 and rec['bound_by'] == 'bytes'
    head = model.params['lm_head']
    assert 'qweight' in head                   # the tied heads packed too
    assert rec['weight_bytes'] >= chip_smoke.param_bytes(head)


def test_phase19_families_expect_the_attention_kernel_where_attn_ok():
    cfgs = {n: chip_smoke.family_model(CPU, n, 1, TINY_ARCH[n])[0].cfg
            for n in chip_smoke.FAMILY_MODELS}
    for name, cfg in cfgs.items():
        n = chip_smoke.serve_expected_launches(cfg, 3, 2, 'batch')
        want = 2 if name in ('qwen25_7b', 'qwen3_8b') else 0
        assert n['batch_decode'] == want and n['flash_decode'] == 0
        assert n['w4_dequant_matmul'] == 3 * 5
    assert cfgs['bloom_7b1'].use_alibi and cfgs['gemma2_9b'].sandwich_norms
    assert cfgs['qwen3_8b'].use_qk_norm


@pytest.mark.parametrize('name', chip_smoke.FAMILY_COMPRESS)
def test_chip_smoke_cpu_phase19_compress_tiny(name):
    recs = chip_smoke.phase19_compress(
        CPU, name, arch=dict(TINY_ARCH[name], dtype='float32'),
        group_size=32, n_samples=2, seq_len=32, eval_tokens=256, eval_bs=2)
    assert [r['method'] for r in recs] == ['RTN', 'Awq', 'Awq']
    for r in recs:
        assert r['ok'] and r['launches'] == ZERO and r['layers'] == 1
    assert recs[0]['ppl_transformed'] == recs[0]['ppl_pretrain']
    assert recs[1]['tolerance_ppl_transformed'] == chip_smoke.TOL_PPL_EQUIV
    assert recs[1]['dtype'] == 'float32'
    assert recs[2]['special']['weight_clip'] and recs[2]['block_output_mse']


def test_chip_smoke_cpu_reads_tiny():
    """``check_reads`` needs the card (B2 and CUDA events): its parts, the
    chunked and full reads, are held to B2's plain version here."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.ops.flash_decode import flash_decode_plain
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve import decode
    B, smax, kvh, H, hd = 4, 64, 2, 4, 32
    cfg = LlamaConfig(num_attention_heads=H, num_key_value_heads=kvh,
                      head_dim=hd, hidden_size=H * hd)
    for cache in ('int8', 'bf16'):
        q, kb, vb, ks, vs = chip_smoke.flash_inputs(CPU, B, smax, kvh, H, hd,
                                                    cache=cache)
        quant = cache == 'int8'
        policy = KVCachePolicy(method='naive' if quant else 'fp', bit=8)
        buf = (dict(k_q=kb, v_q=vb, k_s=ks, v_s=vs) if quant
               else dict(k=kb, v=vb))
        for pos in chip_smoke._attn_positions(B, smax, 32, CPU).values():
            want = flash_decode_plain(q, kb, vb, ks, vs, pos, 1)
            c = dict(buf, pos=pos)
            got = decode._decode_attn_chunked(q[:, None], c, 1, policy, cfg,
                                              decode._chunk_for(smax))[:, 0]
            full = decode._attend_cached(q[:, None] * hd ** 0.5, c, 1,
                                         policy, cfg, torch.float32)[:, 0]
            assert chip_smoke._rel(got, want)[1] <= chip_smoke.TOL_FLASH
            assert chip_smoke._rel(full, want)[1] <= chip_smoke.TOL_FLASH
