"""``chip_smoke.py``'s phase 20 at a tiny size on the CPU (every step
eager, no kernel): OPT through the generalized graph, packed and served,
and compressed on its native graph; the engine under SinkKV with its
CPU parity; the three sparsifiers through the pipeline with block 0's
masks; ShadowKV beside the dense decode; the latency eval on a packed
model and through the pipeline.  On the CPU no kernel launches, so the
launch predictions are read apart from the records' ``ok``."""

import numpy as np
import torch

import chip_smoke

torch.set_num_threads(1)

CPU = torch.device('cpu')
PEAKS = chip_smoke.PEAKS['H100 SXM']
ZERO = dict.fromkeys(chip_smoke.KERNEL_NAMES, 0)
# widths the W4 g128 packing takes (K a multiple of 128)
OPT_TINY = dict(vocab_size=256, hidden_size=128, ffn_dim=256,
                num_hidden_layers=2, num_attention_heads=2,
                max_position_embeddings=128, dtype='bfloat16')
LLAMA_TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=2,
                  num_key_value_heads=2, head_dim=64,
                  max_position_embeddings=256, dtype='bfloat16')
SERVE = dict(n_requests=4, max_batch=2, max_len=96, buckets=(16, 32, 64),
             max_prompt=60, new_tokens=4)
SIZES = dict(n_samples=2, seq_len=32, eval_tokens=256, eval_bs=2)


def test_chip_smoke_cpu_phase20_opt_tiny():
    rec = chip_smoke.phase20_opt(
        CPU, PEAKS, arch=OPT_TINY, serve_kw=SERVE,
        timing_kw=dict(B=2, prompt=16, steps=2, max_len=96),
        decode_kw=dict(steps=32))
    assert rec['layers'] == 2 and rec['attention_kernel']
    for attn, run in rec['runs'].items():
        assert run['tokens_equal']
        for m in ('graph', 'eager'):
            r = run[m]
            assert r['launches'] == ZERO and r['all_done']
            forwards = r['prefill_forwards'] + r['host_decode_steps']
            kernel = 'batch_decode' if attn == 'batch' else 'flash_decode'
            assert r['expected_launches'] == dict(
                ZERO, w4_dequant_matmul=9 * forwards,
                **{kernel: 2 * r['host_decode_steps']})
    assert rec['decode_vs_prefill']['ok'] and rec['packed_vs_fake_quant']['ok']
    assert rec['weight_bound_ms'] > 0


def test_chip_smoke_cpu_phase20_opt_compress_tiny():
    recs = chip_smoke.phase20_opt_compress(
        CPU, arch=dict(OPT_TINY, dtype='float32'), group_size=32, **SIZES)
    assert [r['method'] for r in recs] == ['RTN', 'Awq', 'Awq']
    for r in recs:
        assert r['launches'] == ZERO and r['model'] == 'Opt'
        assert r['ppl_transformed_rel_drift'] <= r['tolerance_ppl_transformed']
    assert recs[0]['ppl_transformed'] == recs[0]['ppl_pretrain']
    # the scale transform alone is an equivalence through OPT's biases and
    # LayerNorms (at this width its searched block may err a little more
    # than RTN's: the search minimizes each subset's error, not the block's)
    assert recs[1]['ppl_transformed_rel_drift'] <= chip_smoke.TOL_PPL_EQUIV
    assert recs[0]['ok'] and recs[2]['ok'] and recs[2]['block_output_mse']


def test_chip_smoke_cpu_phase20_sink_tiny():
    rec = chip_smoke.phase20_sink(
        CPU, PEAKS, cfg_kw=LLAMA_TINY, serve_kw=SERVE,
        vs_cpu=dict(layers=2, prompts=(40, 50), new_tokens=4))
    assert rec['attention_launches'] == 0
    for run in rec['runs'].values():
        assert run['tokens_equal']
        for m in ('graph', 'eager'):
            r = run[m]
            assert r['all_done'] and r['kv_cache'] == 'sink'
            assert r['expected_launches']['flash_decode'] == 0
            assert r['expected_launches']['batch_decode'] == 0
            assert r['expected_launches']['w4_dequant_matmul'] > 0
    cpu = rec['vs_cpu']
    assert cpu['ok'] and cpu['max_token_gap'] == 0.0     # the same device
    assert cpu['tokens_equal_share'] == 1.0


def test_chip_smoke_cpu_phase20_sparse_tiny():
    recs = chip_smoke.phase20_sparse(
        CPU, cfg_kw=dict(LLAMA_TINY, dtype='float32'), layers=6, **SIZES)
    assert [r['phase'] for r in recs] == ['sparse'] * 3 + [
        'sparse_masks_vs_cpu']
    for r in recs:
        assert r['ok'], r
    mag, wanda, short = recs[:3]
    assert mag['min_zero_share'] >= 0.5
    assert wanda['min_row_zero_share'] >= 0.5
    assert short['blocks_after'] == 2 == short['saved_num_hidden_layers']
    assert len(short['removed']) == 4
    assert recs[3]['magnitude_mismatches'] == 0


def test_chip_smoke_cpu_phase20_shadowkv_tiny():
    rec = chip_smoke.phase20_shadowkv(
        CPU, cfg_kw=dict(LLAMA_TINY, dtype='float32'),
        run=dict(layers=2, tokens=128),
        cpu=dict(layers=1, tokens=64,
                 policy=dict(sparse_budget=8, chunk_size=4, rank=8,
                             outlier_chunk=2, max_gen=32)),
        policy_kw=dict(sparse_budget=16, chunk_size=4, rank=8,
                       outlier_chunk=3, max_gen=64), dense_timed=17)
    assert rec['ok'] and rec['retrieved_chunks'] == 4
    assert rec['outlier_chunks'] == 3 and rec['prefill_chunks'] == 16
    # the same device: the check's sides agree exactly
    assert rec['cpu_check']['rel'] == 0.0
    r = rec['retrieval_vs_cpu']
    # 2 kv heads x (4 retrieved + 3 outlier + 4 local chunks) x 4 tokens
    assert r['position_entries'] == 2 * (4 + 3 + 4) * 4
    assert r['ok'] and r['k_rebuilt_max_rel'] == 0.0
    # the dense PPL of the scored tokens from one forward equals the dense
    # decode's over them
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.serve.decode import decode_nll
    ids = np.random.RandomState(0).randint(0, 256, (1, 128))
    model = LlamaAdapter.random(LlamaConfig(**dict(
        LLAMA_TINY, dtype='float32')), seed=0, device=CPU)
    score = np.arange(128) >= 63
    nll, n = decode_nll(model, ids, labels=np.roll(ids, -1, 1),
                        score_mask=score[:-1].tolist() + [False],
                        device=CPU)
    assert n == 64 == rec['scored']
    np.testing.assert_allclose(rec['dense_ppl'], float(torch.exp(nll / n)),
                               rtol=1e-5)


def test_chip_smoke_cpu_phase20_latency_tiny():
    rec = chip_smoke.phase20_latency(
        CPU, cfg_kw=LLAMA_TINY,
        lat=dict(prompt_len=8, gen_len=4, iters=2, batches=(1, 2)),
        pipeline_layers=1)
    for r in rec['packed']:
        assert r['captured_equals_eager'] and r['launches'] == ZERO
        assert r['counts'] == dict(prefill_forwards=3, decode_steps=12)
        assert r['expected_launches']['w4_dequant_matmul'] == 9 * (3 + 8)
    assert sorted(rec['pipeline']['results']) == [
        'latency_bs2_fake_quant', 'latency_fake_quant']
    assert rec['pipeline']['expected_launches']['flash_decode'] == 16


def test_sparse_sections_are_the_shipped_configs():
    import yaml
    for rel, sparse in chip_smoke.SPARSE_CONFIGS.items():
        with open(rel) as f:
            assert yaml.safe_load(f)['sparse'] == sparse, rel
