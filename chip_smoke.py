"""Drive the PyTorch / H100 port (``llmc_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line, all of them on every run:

1. ``device``     the card's name, count, SM count, and nvidia-smi's name
                  and power limit (also printed raw on a line of its own).
2. ``build``      nvcc build of ``llmc_tpu_torch/csrc`` (seconds,
                  registers and spills per kernel); it fails on a spill in
                  the wgmma kernels (B1, B3, B4, B6).
3. ``kernel_checks``  each of the seven kernels of the main paths against
                  its plain PyTorch version on the card at the main paths'
                  shapes and M = 1, 64, 77, 128, 4096 (the W4A8 kernel also
                  against a float64 integer oracle, the FP8-block kernel
                  against a float64 oracle, also on a block built to
                  expose a short adder, and at an N off the 128-row
                  block; the W4A8 activation quantizer bit for bit), with
                  times (CUDA events) beside the bound and a library
                  yardstick that the port never calls for that function.
                  ``kernel_ms`` is the kernel's wrapper on
                  prepared operands, ``path_ms`` the ``dequant_matmul``
                  call one linear of the main path makes (for W4A8 with
                  the activation quantizer's launch); every GEMM with its
                  host microseconds a launch and, up to M=128, its device
                  time through a CUDA graph.  B1 and B3 also at half
                  groups of 64 columns, B4 at groups of 64 and 32; B1
                  timed beside its old mma.sync design on the same
                  operands.  B1, B3 and B4 also at an odd N (4095).
                  Also the staged W4A8 prefill beside the kernel at
                  M=4096, and a sweep of the serving-batch kernel's slots
                  a CTA through CUDA graphs.  Both decode-attention
                  kernels (split over the cache at small batch) at
                  ``FLASH_SHAPES``: the bench's decode shape, B=8 at
                  Smax=1024, and Llama-2-7B's full context of 4096 at
                  B = 1 and 8 and Llama-3-8B's 8 kv heads at B = 8, int8
                  and bf16 caches, each launch repeated to the same bits,
                  a reading under 0.06 ms also through a CUDA graph; and
                  each on an f32 cache, at 16 query heads a kv head
                  (Llama-3.1-405B), on a cache made by the port's KV
                  quantizer, and on an fp16 cache at the bench shape and
                  Llama-3-8B's row.  The FP8-block kernel also at block
                  sizes 64, 256 and the whole K, also at K = 1000 (rows
                  no whole 16 bytes).
4. ``probes``     the w4 design probes (``ops/probe_gemm.py``, nine kernels
                  of ``csrc/probe_gemm.cu`` and B1's old design
                  ``w4_current``) through their entry points
                  ``llmc_tpu_torch.tools.kernel_bench.run`` and
                  ``.w4_probe.run`` at the JAX tools' gate_up shape (K=4096,
                  N=22016) and M = 64, 77, 128 and 4096: every kernel held
                  against its plain version (bf16 within 1e-2 of the
                  largest output, the int8 dot's int32 equal), timed beside
                  its bound, the plain version and the library call, and
                  its launches equal to the calls the tools made.
5. ``parity``     2 layers at Llama-2-7B width: the card (bf16, kernels)
                  against the CPU (f32, plain versions) on the same
                  random packed weights, once per serving configuration:
                  W4A16 + flash, W4A8 + batch attention, W8A16 + flash;
                  each with a control run of the card through the plain
                  linears.  ``--parity-seeds 0 1 2`` repeats it on more
                  random models; nothing else takes an option.
6. ``serve``      ``ServingEngine`` on Llama-2-7B (32 layers) with random
                  packed W4 g128 weights and an int8 KV cache, its decode
                  steps replaying the captured CUDA graph
                  (``serve/graphs.py``); the kernel launch counters must
                  equal what the host launched (prefills, and each
                  graph's eager first run and capture; a replay launches
                  from no wrapper) and ``capture_s`` is their time.
   ``serve_graph``  the same 10 requests through the eager step
                  (``EagerServingEngine``) and through the captured K=4
                  window: tokens identical to the captured single step's,
                  launches as the path implies; the eager run's counts
                  are the ``kernels`` line's launches.
7. ``throughput`` the reference bench's shape: B=128, prefill 32, 64
                  greedy decode steps after one warm-up prefill and step,
                  through the captured step and the eager one in turns
                  (eager, graph, graph, eager; a record, not a claim).
8. ``profile_prefill``  torch.profiler over that prefill: the device's
                  idle share of TTFT.
   ``profile``    torch.profiler over 8 decode steps at that shape,
                  through the graph and eagerly: device time by kernel,
                  attention's share and the device's idle share, and the
                  port's kernels the device ran (a replay's too) equal
                  to what 8 steps imply; for
                  W4A16 also at B=8 after a prefill of 1024 tokens
                  (``LONG_PROFILE``), where a step is mostly attention.
   ``serve_paged``  (W4A16) an int8 ``PagedKVPolicy`` pool of 48 pages of
                  16, a third of the dense allocation, with chunked
                  admission (64-token chunks, two a step): at
                  ``SERVE_PAGED_LAYERS`` layers every request finishes, some wait on the pool, and the
                  free list is whole at the end; at 2 layers of a float32
                  model an fp pool's tokens equal the dense fp engine's,
                  and on an unpacked float32 model the int8 pool's tokens
                  on the card equal the CPU's.
9. ``serve_w4a8`` + its ``serve_graph``, ``throughput`` and ``profile``:
                  the same engine and bench shape with per-token int8
                  activations (every block linear through the quantizer
                  and the W4A8 kernel, the head weight-only) and the
                  serving-batch attention kernel (``ATTN_IMPL='batch'``).
10. ``serve_w8`` + its ``serve_graph``, ``throughput`` and ``profile``:
                  the same on W8A16 per-group 128 weights (every linear
                  through the W8 kernel).
11. ``serve_w8_companion``  8 layers at 7B width, a random fp model packed
                  with ``pack_model(w8_prefill=True)``: the engine once
                  with ``prefill_w8`` and once with ``decode_w8``.
12. ``fp8_linear`` one Llama-2-7B block's seven linears stored as an
                  FP8-block checkpoint stores them (e4m3 codes and one
                  inverse scale per 128 x 128 block), applied to 128 rows:
                  ``act_quant_per_group`` -> ``fp8_block_matmul``, seven
                  launches of the FP8-block kernel.
13. ``compress``  ``run_pipeline`` at Llama-2-7B width (bf16,
                  random weights from a seed, synthetic calibration and
                  PPL data, W4 symmetric per-group 128): once RTN at its
                  32 layers, once AWQ at ``AWQ_LAYERS`` (4) (scale
                  search + clip v1) on weights that came
                  through the FP8-block ingest and whose norms give the
                  activations outlier channels.  PPLs finite,
                  ``ppl_transformed`` near ``ppl_pretrain``, the searched
                  blocks' fake-quant output error at most RTN's on the
                  calibration inputs, seconds per pipeline phase.  The
                  calibration set is cut to 8 x 512 tokens; one more AWQ
                  run of a single block reads the seconds at 128 x 512,
                  the size of ``configs/quantization/methods/
                  awq_w_only.yml``.  The pipeline launches no kernel.
14. ``compress_serve``  what AWQ made, packed (``pack_model``, fused,
                  packed head) and served by ``ServingEngine`` with an
                  int8 KV cache; its logits on one prompt against the
                  same model under the fake-quant ``QMap``.
15. ``compress`` + ``compress_serve`` of the activation-quantizing and
                  Hessian methods, calibration 8 x 512: SmoothQuant W8A8
                  (``configs/quantization/methods/smoothquant_w8a8.yml``)
                  at Llama-2-7B's width and depth, packed with its per-token
                  ``a_spec`` and served through the W8 kernel; GPTQ W4A16
                  (``gptq_w4a16.yml``: asymmetric g128, actorder, percdamp
                  0.01, quant_out) at Llama-2-7B's width and
                  ``GPTQ_LAYERS`` (2) layers (its column loop is sequential
                  torch ops), served through the W4 kernel, with the column
                  loop's share of a block; QuaRot W4A8 with the online
                  rotation (``quarot_w4a8.yml``) at TinyLlama-1.1B's widths
                  and 22 layers (the reference's Hadamard does not factor
                  Llama-2-7B's 11008), with the Hadamard's share of the
                  fake-quant eval.
16. ``compress`` + ``compress_serve`` of the data-free, dimension-search
                  and gradient-trained methods, each on its shipped
                  config's ``quant`` section as it stands, calibration
                  8 x 512, at Llama-2-7B's width: HQQ (``hqq_w4.yml``,
                  asymmetric g64) and AdaDim (``adadim_w8.yml``, per-channel
                  W8) at 8 layers, NormTweaking, OmniQuant and TesseraQ
                  at the depths ``TRAINED_DEPTH`` sets (each cut with its
                  reason in the record, ``DEPTH_CUT``).  Each records its seconds a block,
                  the hyperparameters it read, and for the trained ones the
                  steps, milliseconds a step and the block loss before and
                  after training at the first, middle and last block; each
                  is packed and served (HQQ, NormTweaking, OmniQuant and
                  TesseraQ through the W4 kernel, AdaDim through the W8
                  kernel) and held against its own fake-quant model, or,
                  where packing cannot hold the method's grid (HQQ's
                  clipped elements, AdaDim's input-channel scales),
                  against that model with the weights packing holds, the
                  gap to the method's model recorded.  NormTweaking at the
                  shipped rate moves no bf16 norm: its transformed model
                  is held to the pretrained one.
17. ``compress`` + ``compress_serve`` of the last A10 methods, each on its
                  shipped config's ``quant`` section, calibration 8 x 512,
                  at Llama-2-7B's width: QUIK (``quik_w4a8.yml``) at 8
                  layers (``DEPTH_CUT``), served W4A8 through the
                  quantizer and B3, its
                  int columns on its own per-channel grid and its fp
                  columns off it (their share recorded), held to QUIK's
                  own model within ``TOL_QUIK_VS_OWN``;
                  SpQR (``spqr_w4.yml``) at ``GPTQ_LAYERS`` layers, served
                  W4A16 through B1 on the double-quantized qparams it
                  stores, its fp outliers off the grid (their share
                  recorded); DGQ (``dgq_w4a8.yml``) at the depth
                  ``DEPTH_CUT`` sets, served W4A8 through B3 on its dual
                  grain, every weight on that grid.  QUIK's and DGQ's
                  transformed PPL held to the pretrained one within
                  ``TOL_PPL_EQUIV``.  Then ``decode_ppl``: the
                  ``kvquant_int8.yml`` model (RTN W4, Naive int8 KV) at
                  ``DECODE_LAYERS`` layers through ``run_pipeline`` with a
                  decode-PPL entry at pretrain, fake_quant and
                  fake_quant_wo_kv (B2 once a layer a fed step in each;
                  the pretrain decode PPL against the prefill PPL of the
                  same tokens) and token consistency at fake_quant; then
                  the fake-quant model over ``kvquant_kivi.yml``'s KIVI
                  4-bit cache, over KIVI with a ring as long as the
                  sequence (its NLL the fp cache's) and over a SinkKV
                  cache, none of them through B2.  At the pretrained
                  weights the logits of every decode step are held to one
                  prefill's and B2 to its plain version
                  (``decode_logits_checks``), planted faults outside both
                  bounds.
18. ``moe_serve`` + ``moe_compress``: the MoE and MLA families at their
                  published widths (``MOE_MODELS``: Mixtral-8x7B at 4 of
                  its 32 layers, Qwen1.5-MoE-A2.7B at 4 of 24,
                  DeepSeek-V2-Lite at 4 of 27, ``PHASE18_CUT``; bf16
                  random weights), each served unpacked by the
                  engine over 10 requests through the captured step and
                  the eager one (tokens equal; Mixtral through B2 and B5,
                  Qwen2-MoE through B5, once a layer a host decode step;
                  DeepSeek over the int8 latent cache, no kernel), TTFT and
                  the decode step captured and eager against the weights'
                  byte bound, the latent cache's bytes a token; then
                  compressed (``MOE_COMPRESS``: RTN W4 at each depth,
                  ``mixtral_gptq_w4.yml``'s GPTQ at 1 layer,
                  ``awq_w_only_dsv3.yml``'s AWQ on one MoE block), RTN's
                  transformed PPL equal to pretrain.  Each depth cut and
                  reason is in its record's ``reduced``.
19. ``attn_reads`` + ``family_serve`` + ``family_compress``: the chunked
                  and full decode reads (``LLMC_ATTN``) at the bench
                  attention shape, int8 and bf16, each held to B2; then
                  the Llama-family and generalized-graph families at their
                  published widths (``FAMILY_MODELS``: Qwen2.5-7B,
                  Qwen3-8B, Gemma-2-9B, BLOOM-7b1 at full depth; bf16
                  random weights),
                  each with its decode held to a prefill on fp / int8
                  caches (a planted 4-bit cache outside the bound), its
                  packed logits held to the fake-quant model at 2 layers,
                  then packed W4A16 g128 (fused, the head packed: Gemma2's
                  and Bloom's tied heads as a copy of the embedding) and
                  served over 10 requests through the captured step and
                  the eager one, under ``auto`` and ``batch`` (tokens
                  equal; B1 once a packed linear and the head a forward;
                  B2 or B5 once a layer a host decode step where the
                  reference's attn_ok lets a kernel take it: none on
                  Gemma2 and Bloom), the step's
                  ms at B=8 after a 128-token prefill beside its byte
                  bound; RTN, AWQ's scale transform alone (in float32)
                  and AWQ with clip v1 on one block of Qwen2.5-7B and of
                  Gemma-2-9B (``FAMILY_COMPRESS``), the equivalences'
                  transformed PPL within ``TOL_PPL_EQUIV`` of pretrain.
20. ``opt_serve`` + ``opt_compress`` + ``sink_serve`` + ``sparse`` +
                  ``shadowkv`` + ``latency``: OPT-6.7B at its published
                  widths and full depth through its generalized view
                  (``OPT_6_7B``), as phase 19 runs a family (B1 once a
                  packed linear and the head a forward, B2 / B5 once a
                  layer a host decode step), and RTN and AWQ on one block
                  of its native graph; the packed Llama-2-7B
                  (``SINK_LAYERS``) served by
                  the engine under SinkKV (``SINK_KV``: the window bites on
                  the serve prompts), no attention kernel launched, its
                  first 2 layers' tokens on the card within bf16's reach
                  of the CPU port's (``engine_vs_cpu``); the shipped
                  Magnitude, Wanda and ShortGPT configs at
                  ``SPARSE_LAYERS`` layers through ``run_pipeline`` (zero
                  shares, ShortGPT's removed blocks and saved config,
                  block 0's masks against the CPU port's; ShortGPT on a
                  written checkpoint); ShadowKV's decode PPL over 4096
                  tokens at ``SHADOWKV_RUN`` layers beside the dense PPL of the same
                  tokens, the card's outlier chunks and retrieved
                  positions equal to the CPU's at the run's prefill, and
                  its PPL at 2 layers in float32 against the CPU's; and
                  ``LatencyEval`` at batch 1 and 8 on the packed model
                  (``LATENCY_LAYERS``; its captured decode's tokens equal to its eager
                  warm-up's) and through ``run_pipeline`` at
                  ``LATENCY_PIPELINE_LAYERS``.
21. ``export`` + ``export_symmetric`` + ``export_writers`` + ``offload`` +
                  ``code_eval``: the backend exports at Llama-2-7B, block
                  offload at Llama-2-70B's widths (``OFFLOAD_LAYERS``) and
                  the code eval through B2.
22. ``vlm_serve`` + ``vlm_fastv`` + ``vlm_compress`` + ``videollava`` +
                  ``vit``: LLaVA-1.5-7B (``LLAVA15_7B``: the CLIP
                  ViT-L/14-336 tower, the projector, Llama-2-7B's LM at 32
                  layers) with its LM packed W4A16 g128 and served by
                  ``vlm_greedy_generate`` (8 prompts of an image and 32
                  text tokens, 64 new tokens, an int8 cache) under
                  ``auto`` (B2) and ``batch`` (B5): the captured decode's
                  tokens equal to the eager decode's, the launches the path
                  implies, the tower + projector ms, TTFT and the replayed
                  step beside its byte bound, the packed prefill logits
                  within ``TOL_COMPRESS_SERVE`` of the fake-quant model's,
                  VisionZip's 576 image tokens served as 64, and the card's
                  tokens equal to the CPU port's at 2 LM layers in float32;
                  FastV in the eager forward (``FASTV_LAYERS``) against the
                  CPU; ``run_pipeline`` of the tower RTN W8 and the LM RTN
                  W4 g128 with the vqa eval; Video-LLaVA at 224 pixels x 8
                  frames with DyCoke (``VIDEOLLAVA_LAYERS``) against the
                  CPU; ViT-B/16 (``VIT_B16``) W8A8 with the quantized
                  attention and the ImageNet accuracy eval, its predictions
                  equal to the CPU's at 2 layers.
23. ``qwen2vl_serve`` + ``qwen2vl_compress`` + ``internvl`` +
                  ``onevision`` + ``minicpmv``: Qwen2-VL-7B (``QWEN2VL_7B``)
                  at 28 LM and 32 tower layers, its LM packed W4A16 g128:
                  4 prompts of a 448-pixel image (256 merged tokens) and
                  32 text tokens through the eager forward and B1 (the
                  tower + merger timed), their logits within
                  ``TOL_COMPRESS_SERVE`` of the fake-quant model's; 8 text
                  prompts of 32 tokens served from an int8 cache under
                  ``auto`` (B2) and ``batch`` (B5), captured against eager,
                  the step beside its byte bound; the card against the CPU
                  at 2 + 2 layers in float32; ``run_pipeline`` of
                  ``qwen2vl_awq_w4.yml``'s two AWQ sections with the vqa
                  eval (``QWEN2VL_COMPRESS``); InternVL3-8B
                  (``INTERNVL3_8B``: the full InternViT-300M, the LM cut),
                  InternViT-6B's qk-norm block against the CPU;
                  LLaVA-OneVision-7B (``ONEVISION_7B``: the full SigLIP, the
                  LM cut) on an anyres_max_9 image and 8 frames of video
                  plain, with PruneVid and with DyCoke; MiniCPM-V
                  (``MINICPMV_25``) after RTN; each LM packed through B1,
                  held to its fake-quant model and the card to the CPU.

Every phase that drives the model or the probe tools on the card sets the
kernels' launch counters to 0 just before its run, reads them just after,
and fails unless they equal what its path implies and no call ran the
reference's XLA branch in torch ops (``xla_branch_calls`` 0: every weight
of every path goes to a kernel).  The flash-decode kernel combines its
splits inside its one launch: no combine launch to count.  Then the
``wgmma_kernels`` line (B1's, B3's, B4's and B6's registers, spills, host
microseconds a launch and graph times, B1's old design), the
``{"kernels": [...]}`` line (seventeen kernels: each of the main paths'
launches from the serve phase of its own path, the FP8-block kernel's from
``fp8_linear``, each probe's from the ``probes`` phase), the
nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero.
There is no CPU mode: without a CUDA card the script exits 2.  The phase
functions take a device and sizes, so the tests run the phases that
need no kernel at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import importlib
import itertools
import json
import os
import re
import sys
import time

import numpy as np
import torch

from llmc_tpu_torch.utils.device import (PEAKS,  # noqa: F401 (re-exported)
                                         nvidia_smi_line, peaks_for)
from llmc_tpu_torch.utils.profiler import cuda_ms

F32 = torch.float32
BF16 = torch.bfloat16

# Llama-2-7B (the reference bench's configuration)
LLAMA2_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, head_dim=128, dtype='bfloat16')
# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-Chat-v1.0 config.json): the
# Llama-family widths at which the reference's QuaRot with the online
# rotation runs (5632 = 44 x 128 factors; Llama-2-7B's 11008 does not)
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=22, num_attention_heads=32,
                 num_key_value_heads=4, head_dim=64, dtype='bfloat16')
# the quant sections of the repository's method configs
# (configs/quantization/methods/<name>.yml), as they stand there
METHOD_QUANT = {
    'smoothquant_w8a8': dict(
        method='SmoothQuant',
        weight=dict(bit=8, symmetric=True, granularity='per_channel'),
        act=dict(bit=8, symmetric=True, granularity='per_token'),
        special=dict(alpha=0.5)),
    'gptq_w4a16': dict(
        method='GPTQ',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        quant_out=True,
        special=dict(actorder=True, percdamp=0.01, blocksize=128)),
    'quarot_w4a8': dict(
        method='Quarot',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        act=dict(bit=8, symmetric=True, granularity='per_token'),
        special=dict(online_rotate=True)),
    'hqq_w4': dict(
        method='HQQ',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=64, calib_algo='hqq')),
    'adadim_w8': dict(
        method='AdaDim',
        weight=dict(bit=8, symmetric=True, granularity='per_channel')),
    'normtweaking_w4': dict(
        method='NormTweaking',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        special=dict(epochs=10, lr=0.0001)),
    'omniquant_w4': dict(
        method='OmniQuant',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        special=dict(epochs=20, lwc=True, let=False, wlr=0.001)),
    'tesseraq_w4': dict(
        method='TesseraQ',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        special=dict(epochs=8, thresholds=[0.8, 0.5, 0.2])),
    'quik_w4a8': dict(
        method='QUIK',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        act=dict(bit=8, symmetric=True, granularity='per_token'),
        special=dict(fp_features=128)),
    # outlier_threshold and scorer are keys no package reads (ROADMAP C):
    # SpQR runs relative_threshold 0.2 and the simplified pre-pass
    'spqr_w4': dict(
        method='SpQR',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        special=dict(outlier_threshold=0.2, scorer='exact')),
    'dgq_w4a8': dict(
        method='DGQ',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        act=dict(bit=8, symmetric=True, granularity='per_token')),
    'kvquant_int8': dict(
        method='RTN',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        kvcache=dict(method='Naive', bit=8, symmetric=True)),
    'kvquant_kivi': dict(
        method='RTN',
        weight=dict(bit=4, symmetric=False, granularity='per_group',
                    group_size=128),
        kvcache=dict(method='Kivi', bit=4, symmetric=True)),
}
# GPTQ's column loop is a Python loop of torch ops, 35584 columns a
# Llama-2-7B block at about 0.17 ms a column on an H100 (6 s a block): the
# phase runs 1 of the 32 layers (4 before phase 18 took its 200 s, 2
# before phase 20)
GPTQ_LAYERS = 1
# Phase 16: each method's serving mode, and the depth of the trained
# methods with its reason.  A training step is a forward and a backward of
# one Llama-2-7B block over the 8 x 512 calibration tokens, its linears as
# f32 matmuls (the fake-quant path's matmul_f32_acc) on the CUDA cores: on
# an H100 about 86 ms (NormTweaking, input gradients only) and 124 ms
# (OmniQuant, TesseraQ: the weights' gradients too).  HQQ (0.36 s a block)
# and AdaDim (0.2 s) run 8 of the 32 layers (``DEPTH_CUT``).
PHASE16 = (('hqq_w4', 'w4a16'), ('adadim_w8', 'w8a16'),
           ('normtweaking_w4', 'w4a16'), ('omniquant_w4', 'w4a16'),
           ('tesseraq_w4', 'w4a16'))
TRAINED_DEPTH = {
    'NormTweaking': (2, '10 AdamW steps a block (epochs 10 x 1 batch), '
                        'about 1.0 s a block; 2 layers (8 before phase 18, '
                        '4 before phase 19)'),
    'OmniQuant': (1, '20 AdamW steps a block (epochs 20 x 1 batch), about '
                     '2.7 s a block; 1 layer (4 before phase 18, 2 before '
                     'phase 19)'),
    'TesseraQ': (1, '300 Adam steps a block (3 thresholds x 100 '
                    'iterations: the config\'s epochs is not read) and 21 '
                    'host quantiles, about 49 s a block'),
}
# Phase 17: the last A10 methods, each served on its path (QUIK and DGQ
# W4A8 through B3, SpQR W4A16 through B1), and the depth cut of each that
# has one, with its reason.  QUIK runs all 32 layers (its calibration is
# an absmax a subset).
PHASE17 = (('quik_w4a8', 'w4a8'), ('spqr_w4', 'w4a16'),
           ('dgq_w4a8', 'w4a8'))
# the depth cuts that pay for phase 20's time (the seconds of the 32-layer
# run with its evals on an H100 at 700 W)
PHASE20_DEPTH = 'cut to pay for phase 20\'s time'
PHASE22_DEPTH = 'cut to pay for phase 22\'s time'
DEPTH_CUT = dict(TRAINED_DEPTH, **{
    'QUIK': (8, f'{PHASE20_DEPTH} (32 layers: 11.4 s)'),
    'HQQ': (8, f'{PHASE20_DEPTH} (32 layers: 15.8 s)'),
    'AdaDim': (8, f'{PHASE20_DEPTH} (32 layers: 10.7 s)'),
    'SpQR': (GPTQ_LAYERS, 'GPTQ\'s column loop (a Python loop of torch '
                          'ops, 35584 columns a block) and the outlier '
                          'test in it, about 6-10 s a block'),
    'DGQ': (1, '100 grid points a linear, each an f32 product over the '
               '4096 calibration tokens (about 165 TFLOP a block on the '
               'CUDA cores), about 5.4 s a block; 1 layer (8, then 4, '
               'before phase 18, 2 before phase 20) to keep the script '
               'inside its time limit'),
})
# transformed PPL against pretrained where the method's transform is an
# equivalence up to the bf16 rounding of rescaled weights (QUIK transforms
# nothing; DGQ smooths as SmoothQuant does, which read 5e-5 at this size)
TOL_PPL_EQUIV = 2e-4
# decode_ppl: the kvquant_int8 model (RTN W4 g128 asym, Naive int8 KV) on
# DECODE_LAYERS of Llama-2-7B's, over one chunk of DECODE_TOKENS synthetic
# tokens.  A fake-quant decode step fake-quantizes every weight again
# (about 7-9 ms a layer), and five passes of 255 steps run at fake-quant.
DECODE_LAYERS = (2, 'a fake-quant decode step re-quantizes every weight '
                    '(about 7-9 ms a layer); five fake-quant passes of 255 '
                    'steps and seven pretrained ones of 256; 2 layers (8, '
                    'then 4, before phase 18) to keep the script inside its '
                    'time limit')
DECODE_TOKENS = 256
# The decode PPL over an fp bf16 cache against the prefill PPL of the same
# tokens (both bf16, f32 attention): they differ by the order of f32 sums
# and the bf16 roundings of the attention output that it flips, through
# the layers; the mean NLL moves far less than one bf16 ulp (3.9e-3).  The
# random model's logits are near uniform, so the PPL hardly moves with what
# attention returns: the logits below are what tell a read apart.
TOL_DECODE_VS_PREFILL = 2e-3
# The logits of each fed step (``logits_rel``: the largest over the steps
# of |got - want| / |want|, L2 over the vocabulary), at the pretrained
# weights.  The decode over the fp cache (B2) against one prefill of the
# same tokens: bf16 roundings that fall otherwise between a one-token step
# and a 256-token forward.  Set from an H100 reading at 8 layers: 1.01e-2,
# and 9.5e-3 at the first step, where attention reads one position and
# returns its value exactly, so the gap is the linears'; KIVI's 4-bit cache
# read 3.2e-2, the Naive int8 cache 1.7e-2, and the planted faults (a
# 4-bit Naive cache, the Sink window of 64) 0.20 and 1.26, which must stay
# at least twice the bound.
TOL_DECODE_LOGITS_VS_PREFILL = 2.5e-2
# B2 against its plain version in the same decode: f32 sums in another
# order, whose last bits flip a bf16 rounding of the attention output now
# and then, carried through the layers.  Set from an H100 reading at 8
# layers: 7.6e-3.
TOL_DECODE_LOGITS_B2_PLAIN = 1.5e-2

# Tolerances, with their reasons.
# w4 kernel vs plain (same bf16 x and packed weights, f32 plain math):
#   bf16 output — one bf16 rounding of each output (2^-8 relative) plus
#   f32 summation order: max |err| <= 1e-2 * max |ref|;
#   f32 output (head) — f32 summation order over K and the cancellation
#   between y+ and the excess-8 correction: max |err| <= 1e-4 * max |ref|.
TOL_W4_BF16 = 1e-2
TOL_W4_F32 = 1e-4
# W4A8 kernel vs plain on the same int8 codes: as the w4 kernel.  Against
# the float64 integer oracle at f32 output the int32 sums are exact and
# only the order of the <= 86 f32 group terms differs.
TOL_A8_ORACLE = 1e-6
# W8 kernel vs the plain version that rounds the weight to bf16 the same
# way: as the w4 kernel.
# flash and batch kernels vs plain (all f32): exp and summation order only.
TOL_FLASH = 2e-4
# on a cache made by the port's KV quantizer: f32 rounding, which f16
# halves that let p times its V scale fall below f16's normal range miss
# (by about 1e-4 on ATTN_KVQ's row)
TOL_ATTN_KVQ = 2e-5
# FP8-block kernel at f32 output vs the float64 oracle on the same codes
# and scales (and vs the plain f32 version): every e4m3 product is exact
# in f32, so what is left is the order of the f32 sums inside a 128-wide
# block and over at most 86 scaled block terms.  At bf16 output one more
# bf16 rounding: TOL_W4_BF16.
TOL_FP8_ORACLE = 1e-5
# One FP8-block linear (bf16 activations through act_quant_per_group and
# the kernel) vs x @ weight_cast_to_bf16(codes, scale_inv)^T in f32: the
# activation's e4m3 rounding, at most 2^-4 relative an element with random
# sign, leaves about 2.5% of an output's RMS, 4 to 5 sigma of it over all
# outputs against a largest output of as many sigma: 5e-2 of the largest
# output (the reference's own test allows 0.1).
TOL_FP8_LINEAR = 5e-2
# ``compress``: the transformed model's PPL against the pretrained one's.
# RTN transforms nothing (equal).  AWQ's scale transform is an equivalence
# up to the working type's rounding of the rescaled weights, and clip v1
# clamps group outliers in place, which a 4-bit grid search found cheaper
# than keeping them; both move the PPL of a model with random weights
# (close to the vocabulary size whatever the weights) by far less than
# 2e-2 relative.
TOL_PPL_TRANSFORMED = 2e-2
# ``compress`` with a search (AWQ scales, clip v1): the PPLs of random
# weights cannot tell a right search from a wrong one, so the searched
# blocks are held against RTN where it shows.  On a block's own calibration
# inputs, the squared error of its fake-quantized output against the
# unquantized block's is at most RTN's: both grids hold the point that
# changes nothing (ratio 0, no shrink), so every subset's own objective can
# only fall, and clipping a 4-bit group of Gaussian weights takes 10 to 20%
# off it.  A search that picks wrong scales, applies them on one side only
# or shrinks too far raises the error above RTN's.
TOL_SEARCH_VS_RTN = 1.0
# ``compress_serve``: logits of the packed model through the kernels
# against the same model under the fake-quant QMap, both on the card in
# bf16, relative to the largest logit.  The two differ by the bf16
# rounding of the fake-quantized weight (the kernel multiplies the exact
# codes and applies the f32 scales afterwards), the order of the f32 sums
# and the bf16 roundings they flip, through every layer of the run.
# Measured on an H100 at 32 layers of Llama-2-7B width: 1.9e-2.
TOL_COMPRESS_SERVE = 3e-2
# ... and of a model that quantizes its activations per token (SmoothQuant
# W8A8, packed with its a_spec): each linear's input is rounded to 8-bit
# codes from a bf16 row in the packed run and from the fake-quant run's
# row, and a code that the runs' last-bit differences put on the other side
# of a rounding tie moves its products by a whole step, which the next
# layer's codes carry on; 32 layers of it.  Measured on an H100 at
# Llama-2-7B's width and depth: 3.8e-2 (argmax agreement 0.91), against
# the weight-only AWQ model's 2.0e-2.  The same packed model through the
# plain linears on the card (the kernels' own function, the weight rounded
# to bf16 as B4 rounds it) is read beside it.
TOL_COMPRESS_SERVE_A8 = 8e-2
# QUIK served through B3 against QUIK's own model (not only the model
# packing holds): packing keeps its int columns on QUIK's own grid (per
# channel over those columns) and puts its fp columns (2.5% of the inputs
# at Llama-2-7B's width, those of the largest calibration activations) on
# that grid too, and B3 quantizes those columns' activations with the rest
# of the row.  That gap is the whole of the rest.  Measured on an H100 at
# Llama-2-7B's width and depth: 0.124 (2.38% of the weights moved), against
# 0.595 when packing re-quantized every column at g128.
TOL_QUIK_VS_OWN = 0.25
# card (bf16 activations, int8 KV) vs CPU (f32) over 2 layers at 7B width,
# relative to the largest logit: bf16 rounding at every cast and int8 KV
# codes that flip between the two.  Measured on an H100 with seeds 0-2
# (phase_parity(seed=...)): W4A16 4.2e-3, 1.3e-3, 3.7e-3.  W4A8 quantizes
# every block linear's input per token to int8 in both runs, from a bf16 row
# on the card and an f32 row on the CPU, so a code near a rounding tie
# differs by one step: 1.4e-2, 1.3e-3, 1.2e-3, inside the W4A16 tolerance.
# The random W8 model's codes are centred (the W4 model's excess-8 nibbles
# have mean -0.5, which puts a common component into every logit and
# flatters a ratio to the largest one), and its logits are 2.5x smaller:
# 5.0e-2, 6.0e-2, 4.8e-2, and as much (4.6e-2 to 4.9e-2) when the card runs
# the plain f32-weight linears on the same bf16 activations, so the error
# is the working type's on that model and not the kernel's or its bf16
# weight rounding; its tolerance is 1e-1.  What the kernels add is held by
# two more limits.  The run with kernels may err at most PARITY_VS_CONTROL
# times what the card's control run with plain linears errs (readings:
# 1.00 to 1.26 times).  And it is compared directly with the control that
# computes the kernels' own function on the card (the plain linears; for
# W8 with the weight rounded to bf16), which takes the CPU's f32 working
# type out of the comparison: what is left is the order of the f32 sums,
# the bf16 roundings and int8 codes (KV, W4A8 activations) that it flips,
# and what two layers make of them.  Measured over seeds 0-2
# (``--parity-seeds 0 1 2``): W4A16 7.9e-4 to 1.3e-3, W4A8 5.1e-4 to
# 1.2e-3, W8A16 1.2e-2 to 1.4e-2 (that model turns any rounding into more
# than the W4 models do, as its error against the CPU shows);
# TOL_VS_CONTROL is a little over twice the worst reading.
TOL_PARITY = {'w4a16': 5e-2, 'w4a8': 5e-2, 'w8a16': 1e-1}
PARITY_VS_CONTROL = 1.3
TOL_VS_CONTROL = {'w4a16': 3e-3, 'w4a8': 3e-3, 'w8a16': 3e-2}
MIN_GREEDY_AGREE = 0.5


_T_IMPORT = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's record also gets ``at_s``, the seconds
    since the script started, so that each phase's share of the time
    limit can be read off the output."""
    if 'phase' in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T_IMPORT)
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def tree_to(tree, device, float_dtype=None):
    if isinstance(tree, dict):
        return {k: tree_to(v, device, float_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, float_dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        if float_dtype is not None and tree.dtype in (BF16, torch.float16):
            tree = tree.to(float_dtype)
        return tree.to(device)
    return tree


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def _w4_case(N, K, M, sym, gen, dev, gs=128):
    from llmc_tpu_torch.ops.dequant_matmul import QMeta
    ng = K // gs
    meta = QMeta(bits=4, group_size=gs, symmetric=sym, out_features=N,
                 in_features=K, pre_t=True)
    packed = torch.randint(0, 256, (N, K // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
    s = torch.rand((ng, N), generator=gen, device=dev) * 0.01 + 0.002
    z = (torch.full_like(s, 8.0) if sym else
         torch.randint(0, 16, (ng, N), generator=gen, device=dev).to(F32))
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    return x, packed, s.contiguous(), (s * z).contiguous(), meta


def _w8_case(N, K, M, sym, gen, dev, gs=128):
    """Signed int8 codes, legacy [N, ng] scales (and zeros when asym)."""
    from llmc_tpu_torch.ops.dequant_matmul import QMeta
    ng = K // gs
    meta = QMeta(bits=8, group_size=gs, symmetric=sym, out_features=N,
                 in_features=K)
    codes = torch.randint(-128, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
    s = torch.rand((N, ng), generator=gen, device=dev) * 0.001 + 0.0002
    z = None if sym else torch.randint(-16, 16, (N, ng), generator=gen,
                                       device=dev).to(F32)
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    return x, codes, s.contiguous(), z, meta


def gemm_bound(kind, M, N, K, out_bytes, peaks, gs=128, has_z=True):
    """Least time of one dequant-matmul: every input read once (x, the
    weight, the f32 scale and zero term per group and column, the
    per-token scale of W4A8), the output written once, against 2*M*N*K
    operations at the peak of the type the tensor cores multiply in.  The
    W4 kernels always read s and zs; the W8 kernel reads zeros only when
    the weight has them (``has_z``)."""
    ng = K // gs
    x_b, w_b, peak = {'w4': (2 * M * K, N * K // 2, peaks.bf16),
                      'w4a8': (M * K + 4 * M, N * K // 2, peaks.int8),
                      'w8': (2 * M * K, N * K, peaks.bf16)}[kind]
    n_scale = 2 if has_z or kind != 'w8' else 1
    nbytes = x_b + w_b + n_scale * ng * N * 4 + M * N * out_bytes
    t_b, t_o = nbytes / peaks.bw * 1e3, 2 * M * N * K / peak * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _gemm_ops(kind):
    """(case, kernel, plain, library, tiling, path) of one dequant-matmul
    kernel.  ``kernel(case, weight, out_dtype)`` calls the kernel's wrapper
    on ``weight`` in place of the case's own (same shape), ``plain(case)``
    is its plain version in f32, ``library(case)`` returns the yardstick
    call, and ``path(case, weight, out_dtype)`` is what one linear of the
    main path calls: ``dequant_matmul``, with whatever it runs before the
    launch (for W4A8 the activation quantizer)."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    from llmc_tpu_torch.utils.device import sm_count

    def sms(case):
        return sm_count(case[0].device.index)

    def path(case, weight, out_dtype):
        x, _, s, z, meta = case
        return D.dequant_matmul(x, weight, s, z, meta, out_dtype,
                                a_int8=kind == 'w4a8')

    if kind == 'w8':
        def kernel(case, weight, out_dtype):
            x, _, s, z, meta = case
            return D.w8_dequant_matmul(x, weight, s, z, meta, out_dtype)

        def plain(case):
            x, codes, s, z, meta = case
            return D.dequant_matmul_plain(x, codes, s, z, meta,
                                          out_dtype=F32, w_bf16=True)

        def library(case):
            x, codes, s, z, meta = case
            w = D.dequant_weight(codes, s, z, meta).to(BF16)
            return lambda: torch.matmul(x, w.T)

        def tiling(case):
            x, _, _, _, meta = case
            tt, splits = D.wgmma_tiling(x.shape[0], meta.out_features,
                                        x.shape[1] // D.WG_UNIT, sms(case))
            return dict(tok_tile=tt, splits=splits)
        return _w8_case, kernel, plain, library, tiling, path

    def tiling(case):       # w4 and w4a8: the same K steps
        x, _, _, _, meta = case
        tt, splits = D.wgmma_tiling(x.shape[0], meta.out_features,
                                    D.w4_steps(x.shape[1],
                                               D._half_group(meta)[0]),
                                    sms(case))
        return dict(tok_tile=tt, splits=splits)

    def dense_weight(case):
        _, packed, s, zs, meta = case
        return D.dequant_weight(packed, *D._unfold_pre_t(s, zs, meta))

    if kind == 'w4':
        def kernel(case, weight, out_dtype):
            x, _, s, zs, meta = case
            return D.w4_dequant_matmul(x, weight, s, zs, meta, out_dtype)

        def plain(case):
            x, packed, s, zs, meta = case
            return D.dequant_matmul_plain(x, packed, s, zs, meta,
                                          out_dtype=F32)

        def library(case):
            x, w = case[0], dense_weight(case).to(BF16)
            return lambda: torch.matmul(x, w.T)
        return _w4_case, kernel, plain, library, tiling, path

    memo = {}

    def kernel(case, weight, out_dtype):       # w4a8
        """The wrapper on the quantizer kernel's outputs, made once per
        case: the quantizer is no part of the GEMM (``path`` times the two
        together).  Its launch is no launch of the main path either."""
        x, _, s, zs, meta = case
        if memo.get('x') is not x:
            memo.update(x=x, codes=D.quant_act_token(x))
        xq, sx, sums = memo['codes']
        return D.w4a8_dequant_matmul(xq, sx, sums, weight, s, zs, meta,
                                     out_dtype)

    def plain(case):
        x, packed, s, zs, meta = case
        return D.dequant_matmul_plain_a8(x, packed, s, zs, meta,
                                         out_dtype=F32)

    def library(case):
        x, packed, _, _, meta = case
        xq, _ = D._quant_act_token(x)
        rows = max(32, -(-xq.shape[0] // 8) * 8)    # _int_mm needs > 16
        xq = torch.nn.functional.pad(xq, (0, 0, 0, rows - xq.shape[0]))
        w8 = D.unpack_weight(packed, meta).to(torch.int8)
        return lambda: torch._int_mm(xq, w8.T)
    return _w4_case, kernel, plain, library, tiling, path


def a8_oracle(case):
    """The integer oracle of W4A8 in float64 from the same int8 codes:
    sx * sum_g s_g * sum_k xq * (u - z_eff)."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    x, packed, s, zs, meta = case
    xq, sx = D._quant_act_token(x)
    w = D.dequant_weight(packed, *D._unfold_pre_t(s.double(), zs.double(),
                                                  meta))
    return (xq.double() @ w.double().T) * sx.double()


def quant_bound(M, K, x_bytes, peaks):
    """Least time of the activation quantizer: x read once; xq, sx and the
    int32 piece sums (rows padded to a multiple of 4) written once; about
    four operations an element (abs and max, divide, round and clamp) at
    the f32 rate."""
    nbytes = M * K * (x_bytes + 1) + 4 * M + 4 * (K // 64) * (-(-M // 4) * 4)
    t_b, t_o = nbytes / peaks.bw * 1e3, 4 * M * K / peaks.f32 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def check_quant_act_token(dev, peaks, Ks=(4096, 11008),
                          ms_list=(1, 77, 128, 4096), timed=(1, 128, 4096),
                          wide=((53248, 1), (53248, 77))):
    """The quantizer kernel (``quant_act_token``) against its plain
    version ``_quant_act_token`` on the same x on the card: xq and sx bit
    for bit and the int32 piece sums exact (zeros past M); the plain
    version on the card also bit-equal to itself on the CPU.  bf16 x at
    the block linears' K (f32 x too at one shape); row m's first element
    is 1 + 0.01 m, which puts some rows' scale where a true division by
    127 and the folded multiply differ.  ``wide``: (K, M) of rows too wide
    for the kernel to hold in registers (Llama-3-405B's down projection),
    which it reads twice.  Timed at K=4096, bf16."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for K, M in [*itertools.product(Ks, ms_list), *wide]:
        for dt in (BF16, F32) if (K, M) == (4096, 77) else (BF16,):
            x = torch.rand((M, K), generator=gen, device=dev) * 2 - 1
            x[:, 0] = 1 + 0.01 * torch.arange(M, device=dev)
            x = x.to(dt)
            xq, sx, sums = D.quant_act_token(x)
            pq, psx = D._quant_act_token(x)
            cq, csx = D._quant_act_token(x.cpu())
            torch.cuda.synchronize()
            want = pq.to(torch.int32).reshape(M, K // 64, 64).sum(-1).T
            checks = dict(
                xq=torch.equal(xq, pq), sx=torch.equal(sx, psx),
                sums=torch.equal(sums[:, :M], want)
                and bool((sums[:, M:] == 0).all()),
                card_vs_cpu=torch.equal(pq.cpu(), cq)
                and torch.equal(psx.cpu(), csx))
            require(all(checks.values()), f'quant_act_token M={M} K={K} '
                    f'{dt}: not bit-equal: {checks}')
            row = dict(M=M, K=K, x=str(dt).replace('torch.', ''),
                       bit_equal=checks, max_abs_err=max(
                           (xq.float() - pq.float()).abs().max().item(),
                           (sx - psx).abs().max().item()))
            if M in timed and K == 4096 and dt == BF16:
                def kern():
                    return D.quant_act_token(x)
                row.update(kernel_ms=cuda_ms(kern, 50),
                           plain_ms=cuda_ms(lambda: D._quant_act_token(x),
                                            10),
                           host_us=host_us(kern), library_ms=None)
                if M <= 128:
                    row['device_ms'] = graph_ms(kern)
                row['bound_ms'], row['bound_by'] = quant_bound(M, K, 2,
                                                               peaks)
            rows.append(row)
            del x, xq, sx, sums, pq, psx
    return rows


def _rel(got, want):
    err = (got.to(want.dtype) - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def check_gemm(kind, dev, peaks, shapes, ms_list, timed_ms=(1, 128, 4096),
               gs=128):
    """One dequant-matmul kernel ('w4', 'w4a8' or 'w8') at every main-path
    (N, K), each M, sym and asym, group size ``gs``; the symmetric case
    timed at each M of ``timed_ms``.  The tolerance is TOL_W4_F32 at f32
    output and TOL_W4_BF16 at bf16; W4A8 is also run at f32 output against
    the float64 oracle."""
    make, kernel, plain, library, tiling, path = _gemm_ops(kind)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, worst_abs, worst_rel, worst_oracle = [], 0.0, 0.0, 0.0
    for (N, K, is_head) in shapes:
        out_dtype = F32 if is_head else BF16
        tol = TOL_W4_F32 if is_head else TOL_W4_BF16
        for M in ms_list:
            for sym in (True, False):
                case = make(N, K, M, sym, gen, dev, gs)
                got = kernel(case, case[1], out_dtype)
                want = plain(case)
                torch.cuda.synchronize()
                err, rel = _rel(got, want)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                                rel)
                what = f'{kind} N={N} K={K} M={M} sym={sym} gs={gs}'
                require(bool(torch.isfinite(got).all()) and rel <= tol,
                        f'{what}: rel err {rel:.3g} > {tol}')
                row = dict(N=N, K=K, M=M, sym=sym, gs=gs, **tiling(case),
                           out=str(out_dtype).replace('torch.', ''),
                           max_abs_err=err, max_rel_err=rel)
                if kind == 'w4a8':
                    got32 = got if is_head else kernel(case, case[1], F32)
                    _, rel_p = _rel(got32, want)
                    _, rel_o = _rel(got32, a8_oracle(case))
                    require(rel_p <= TOL_W4_F32 and rel_o <= TOL_A8_ORACLE,
                            f'{what}: f32 output rel err {rel_p:.3g} vs '
                            f'plain, {rel_o:.3g} vs the integer oracle')
                    worst_oracle = max(worst_oracle, rel_o)
                    row.update(f32_rel_err_plain=rel_p,
                               f32_rel_err_oracle=rel_o)
                    del got32
                if M in timed_ms and sym:
                    row.update(_time_gemm(kind, case, out_dtype, peaks,
                                          kernel, plain, library, path, gen))
                    if kind == 'w4a8' and M >= 4096:
                        row.update(_time_staged(case, out_dtype, want))
                rows.append(row)
                del case, got, want
    return rows, worst_abs, worst_rel, worst_oracle


def _time_staged(case, out_dtype, want):
    """The staged W4A8 prefill (``A8_STAGE_MIN_M``, off by default: the
    weight re-quantized to per-channel int8 on every call, then one
    library int8 dot) beside the kernel at the same prefill shape.  It
    computes another function than the kernel, so its error against the
    plain W4A8 version is recorded, not held to a tolerance."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')
    x, packed, s, zs, meta = case

    def staged():
        return D._dequant_matmul_a8_staged(x, packed, s, zs, meta, out_dtype)
    _, rel = _rel(staged(), want)
    return dict(staged_ms=cuda_ms(staged, 5, 1), staged_rel_err=rel)


def host_us(fn, n=50):
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    device is synchronised before and after, not in between)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def graph_ms(fn, n=20):
    """Device milliseconds a call of ``fn`` takes with the host out of the
    way: ``n`` calls captured in one CUDA graph, replayed and timed with
    CUDA events (``kernel_ms`` times calls as the host enqueues them, which
    at a few microseconds of device work a call reads the host)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    ms = cuda_ms(g.replay, 5, 1) / n
    del g
    return ms


def _old_w4(case, weight, out_dtype):
    """B1's design before its wgmma redesign (the ``w4_current`` probe) on
    the same operands."""
    from llmc_tpu_torch.ops.probe_gemm import w4_mma_sync
    x, _, s, zs, meta = case
    return w4_mma_sync(x, weight, s, zs, meta, out_dtype)


def _time_gemm(kind, case, out_dtype, peaks, kernel, plain, library, path,
               gen):
    x, weight, meta = case[0], case[1], case[4]
    M, K = x.shape
    N = meta.out_features
    # rotate over copies of the weight so that the 50 MB L2 does not
    # hold it between calls (the main path reads each weight once a step)
    n_copy = max(1, min(8, -(-160_000_000 // weight.numel())))
    lo, hi = (0, 256) if weight.dtype == torch.uint8 else (-128, 128)
    copies = [weight] + [torch.randint(lo, hi, weight.shape, generator=gen,
                                       device=weight.device,
                                       dtype=weight.dtype)
                         for _ in range(n_copy - 1)]
    def rotating(fn):
        it = [0]

        def call():
            it[0] += 1
            return fn(case, copies[it[0] % n_copy], out_dtype)
        return call
    iters = 10 if M >= 4096 else 50
    kernel_ms = cuda_ms(rotating(kernel), iters)
    path_ms = cuda_ms(rotating(path), iters)
    old = {}
    old['host_us'] = host_us(rotating(kernel))
    if M <= 128:
        old['device_ms'] = graph_ms(rotating(kernel))
        if kind == 'w4a8':   # the quantizer and the GEMM, one chain
            old['path_device_ms'] = graph_ms(rotating(path))
    if kind == 'w4':
        old.update(old_design_ms=cuda_ms(rotating(_old_w4), iters),
                   old_design_host_us=host_us(rotating(_old_w4)))
        if M <= 128:
            old['old_design_device_ms'] = graph_ms(rotating(_old_w4))
    plain_ms = cuda_ms(lambda: plain(case), 3, 1)
    lib = library(case)
    library_ms = cuda_ms(lib, iters)
    del lib, copies
    bound_ms, bound_by = gemm_bound(kind, M, N, K,
                                    4 if out_dtype == F32 else 2, peaks,
                                    has_z=kind != 'w8' or case[3] is not None)
    return dict(kernel_ms=kernel_ms, path_ms=path_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, **old)


def flash_inputs(dev, B=128, smax=96, kvh=32, H=32, hd=128, L=2, quant=True,
                 seed=2, cache=None):
    """q and a random cache: ``cache`` 'int8' (random codes and scales),
    'int8_kv' (the port's KV quantizer on keys of std 1 and values of std
    0.05, V scales about 1e-3, with q of scores that spread over a few
    units: most p times its V scale lies far below f16's normal range),
    'bf16', 'f16' or 'f32' values; None takes ``quant`` (int8, else
    bf16)."""
    cache = cache or ('int8' if quant else 'bf16')
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (L, B, smax, kvh, hd)
    q = torch.randn((B, H, hd), generator=gen, device=dev) / hd ** 0.5
    if cache == 'f32':
        kb = torch.randn(shape, generator=gen, device=dev)
        vb = torch.randn(shape, generator=gen, device=dev)
        ks = vs = None
    elif cache == 'int8':
        kb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vb = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 0.01
    elif cache == 'int8_kv':
        from llmc_tpu_torch.serve import KVCachePolicy
        quant8 = KVCachePolicy(method='naive', bit=8)._quant
        kb, ks, _ = quant8(torch.randn(shape, generator=gen, device=dev))
        vb, vs, _ = quant8(torch.randn(shape, generator=gen, device=dev)
                           * 0.05)
        ks, vs = ks[..., 0], vs[..., 0]
        q = q * 2
    else:
        dt = torch.float16 if cache == 'f16' else BF16
        kb = torch.randn(shape, generator=gen, device=dev).to(dt)
        vb = torch.randn(shape, generator=gen, device=dev).to(dt)
        ks = vs = None
    return q, kb, vb, ks, vs


def flash_bound(pos, kvh, hd, H, quant, peaks, esize=None):
    """Least time of one decode attention: the valid rows of K and V of
    this run's positions (``esize`` bytes an element: 1 with its 4-byte
    scale where ``quant``, else 2 unless given), q, the output and pos."""
    valid = int((pos.to(torch.int64) + 1).sum())
    esize = esize or (1 if quant else 2)
    per_row = hd * esize + (4 if quant else 0)
    B = pos.numel()
    nbytes = 2 * valid * kvh * per_row + 2 * B * H * hd * 4 + B * 4
    flops = 4 * valid * (H // kvh) * kvh * hd
    t_b, t_o = nbytes / peaks.bw * 1e3, flops / peaks.f32 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _attn_positions(B, smax, chunk, dev):
    """Named position vectors: random with the chunk boundaries; one slot
    at Smax - 1 and the rest near 0, with every block of 8 slots holding
    such a slot and with only the first block holding one."""
    rng = np.random.RandomState(3)
    special = [0, chunk - 1, chunk, chunk + 1, smax - 1, 31, 32, 1]
    rnd = rng.randint(0, smax, B)
    rnd[:len(special)] = [min(p, smax - 1) for p in special][:B]
    every = rng.randint(0, 3, B)
    every[::8] = smax - 1
    first = rng.randint(0, 3, B)
    first[min(3, B - 1)] = smax - 1
    return {name: torch.as_tensor(v, dtype=torch.int32, device=dev)
            for name, v in (('random', rnd), ('skew_every_block', every),
                            ('skew_one_block', first))}


# check_attention's rows: (B, Smax, KVH, H, valid positions timed).  The
# bench's decode shape (64 valid: the ``kernels`` line's row), a small
# batch with a long cache, and Llama-2-7B's full context of 4096 at B = 1
# and 8 (32 kv heads) and Llama-3-8B's attention widths (8 kv heads for 32
# query heads) at B = 8.
FLASH_SHAPES = ((128, 96, 32, 32, (64,)), (8, 1024, 32, 32, (64, 1000)),
                (1, 4096, 32, 32, (4000,)), (8, 4096, 32, 32, (4000,)),
                (8, 4096, 8, 32, (4000,)))
BATCH_SHAPES = FLASH_SHAPES
# one more case each for both kernels: a float32 model's f32 cache at
# B=8 over 1000 of 1024 positions, and Llama-3.1-405B's attention widths
# (128 query heads over 8 kv heads: 16 a kv head) at the same row
ATTN_F32 = ((8, 1024, 32, 32, (1000,)),)
ATTN_G16 = ((8, 1024, 8, 128, (1000,)),)
# and an int8 cache made by the port's KV quantizer at Llama-3-8B's row
# (``flash_inputs``' 'int8_kv': V scales and p as a model gives them)
ATTN_KVQ = ((8, 4096, 8, 32, (4000,)),)
# an fp16 cache (read as it lies) at the bench shape and at Llama-3-8B's
# row (the tensor cores' f16 products of B5 over 4000 positions)
ATTN_F16 = ((128, 96, 32, 32, (64,)), (8, 4096, 8, 32, (4000,)))
# head dims off the 128-channel layout: 256 (Gemma's; the HDM = 256
# instantiation) at Llama-3-8B's row, and 72 (rows copied by cp.async into
# 128-channel rows) at the bench shape
ATTN_HD256 = ((8, 4096, 8, 32, (4000,)),)
ATTN_HD72 = ((128, 96, 32, 32, (64,)),)
GRAPH_BELOW_MS = 0.06   # a reading under this also gets its graph time


def check_attention(name, dev, peaks, shapes=FLASH_SHAPES, hd=128,
                    caches=('int8', 'bf16'), tol=TOL_FLASH):
    """A decode-attention kernel ('flash_decode' or 'batch_decode') against
    its plain version (within ``tol``) at each of ``shapes`` and
    ``caches``, over ``_attn_positions``, each launched twice to the same
    bits; timed at each shape's valid positions a slot (the first row,
    which the ``kernels`` line reads, at the bench's mid-run state) beside
    the bound, the plain version and SDPA, and through a CUDA graph where the reading
    is under ``GRAPH_BELOW_MS`` (the host's enqueue rate)."""
    if name == 'flash_decode':
        from llmc_tpu_torch.ops.flash_decode import (
            KERNEL_CHUNK as chunk, flash_decode_cuda as kernel,
            flash_decode_plain as plain)
    else:
        from llmc_tpu_torch.ops.batch_decode import (
            KERNEL_CHUNK as chunk, batch_decode_cuda as kernel,
            batch_decode_plain as plain)
    rows, worst_abs, worst_rel = [], 0.0, 0.0
    for (B, smax, kvh, H, timed), cache in itertools.product(shapes, caches):
        quant = cache.startswith('int8')
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd,
                                         cache=cache)
        errs = {}
        for pname, pos in _attn_positions(B, smax, chunk, dev).items():
            got = kernel(q, kb, vb, ks, vs, pos, 1)
            again = kernel(q, kb, vb, ks, vs, pos, 1)
            want = plain(q, kb, vb, ks, vs, pos, 1)
            torch.cuda.synchronize()
            err, rel = _rel(got, want)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                            rel)
            what = (f'{name} B={B} Smax={smax} KVH={kvh} H={H} {cache} '
                    f'{pname}')
            require(bool(torch.isfinite(got).all()) and rel <= tol,
                    f'{what}: rel err {rel:.3g} > {tol}')
            require(torch.equal(got, again),
                    f'{what}: a second launch gave other bits')
            errs[pname] = rel
            del got, again, want
        for valid in timed:
            pos_t = torch.full((B,), valid - 1, dtype=torch.int32,
                               device=dev)
            it = [0]

            def kern():
                it[0] += 1   # alternate layers: at B=128 each is beyond L2
                return kernel(q, kb, vb, ks, vs, pos_t, it[0] % 2)
            kernel_ms = cuda_ms(kern, 200, 5)
            plain_ms = cuda_ms(
                lambda: plain(q, kb, vb, ks, vs, pos_t, 1), 5, 1)
            library_ms = _time_sdpa(q, kb, vb, ks, vs, pos_t, 1)
            bound_ms, bound_by = flash_bound(pos_t, kvh, hd, H, quant,
                                             peaks, kb.element_size())
            row = dict(B=B, smax=smax, kvh=kvh, H=H, hd=hd, cache=cache,
                       max_rel_err=max(errs.values()),
                       rel_err_by_positions=errs,
                       timed_valid_positions=valid,
                       kernel_ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, x_bound=kernel_ms / bound_ms,
                       x_library=kernel_ms / library_ms)
            if kernel_ms < GRAPH_BELOW_MS:
                row['graph_ms'] = graph_ms(kern)
            rows.append(row)
        del q, kb, vb, ks, vs
        torch.cuda.empty_cache()
    return rows, worst_abs, worst_rel


def sweep_batch_blocks(dev, shapes=((128, 96, 32, 64), (8, 1024, 32, 64),
                                    (8, 1024, 32, 1000), (8, 4096, 8, 4000)),
                       H=32, hd=128):
    """The serving-batch kernel over its launch argument, slots a CTA
    (``b_blk``: how its warps are packed; the split plan follows the
    kernel's occupancy in CTAs of that size), on an int8 cache at each
    (B, Smax, kv heads, valid positions a slot: one query head a kv head
    on the CUDA cores, and Llama-3-8B's four on the tensor cores), timed
    through a CUDA graph (the device's time, not the host's enqueue rate):
    one row a block size, ``picked`` on the one ``kernel_plan`` chooses."""
    from llmc_tpu_torch.ops import batch_decode as BD
    rows = []
    for B, smax, kvh, valid in shapes:
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd)
        pos = torch.full((B,), valid - 1, dtype=torch.int32, device=dev)
        picked = BD.kernel_plan(q, kb)[0]
        for b_blk in (1,) + tuple(reversed(BD.BLOCKS)):
            if B % b_blk:
                continue
            it = [0]

            def kern():
                it[0] += 1
                return BD.batch_decode_cuda(q, kb, vb, ks, vs, pos,
                                            it[0] % 2, b_blk)
            rows.append(dict(B=B, smax=smax, kvh=kvh, valid=valid,
                             b_blk=b_blk,
                             splits=BD.kernel_plan(q, kb, b_blk)[1],
                             picked=b_blk == picked,
                             graph_ms=graph_ms(kern)))
        del q, kb, vb, ks, vs
    return rows


def _time_sdpa(q, kb, vb, ks, vs, pos, layer):
    """Yardstick: scaled_dot_product_attention on dequantized bf16 K/V
    (the port never calls it)."""
    B, H, hd = q.shape
    k = kb[layer].to(F32)
    v = vb[layer].to(F32)
    if ks is not None:
        k = k * ks[layer][..., None]
        v = v * vs[layer][..., None]
    kvh = k.shape[2]
    k = k.to(BF16).permute(0, 2, 1, 3).repeat_interleave(H // kvh, 1)
    v = v.to(BF16).permute(0, 2, 1, 3).repeat_interleave(H // kvh, 1)
    qq = q.to(BF16)[:, :, None, :]
    smax = k.shape[2]
    mask = (torch.arange(smax, device=q.device)[None, :]
            <= pos[:, None].to(torch.int64))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: sdpa(qq, k, v, attn_mask=mask, scale=1.0), 200, 5)


# --------------------------------------------------------------------------
# the FP8-block GEMM
# --------------------------------------------------------------------------

FP8_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (22016, 4096)]
# an N that is no multiple of the 128-row scale block (nor of the tile)
FP8_RAGGED = [(4000, 4096)]


def fp8_bound(M, N, K, out_bytes, peaks, bs=128):
    """Least time of one FP8-block GEMM: codes, both scale arrays and the
    output moved once, against 2*M*N*K operations at the FP8 rate."""
    kb = K // bs
    nbytes = (M * K + N * K + 4 * M * kb + 4 * -(-N // bs) * kb
              + out_bytes * M * N)
    t_b, t_o = nbytes / peaks.bw * 1e3, 2 * M * N * K / peaks.fp8 * 1e3
    return max(t_b, t_o), ('bytes' if t_b >= t_o else 'operations')


def _fp8_case(N, K, M, gen, dev, bs=128):
    """(x bf16, its codes and scales, the weight's codes and scale_inv):
    random activations and weights through the port's own quantizers, in
    blocks of ``bs``."""
    from llmc_tpu_torch.quant import act_quant_per_group, weight_cast_to_fp8
    x = torch.randn((M, K), generator=gen, device=dev).to(BF16)
    w = torch.randn((N, K), generator=gen, device=dev) * 0.02
    xc, xs = act_quant_per_group(x, bs)
    wc, ws = weight_cast_to_fp8(w, bs)
    return x, xc, xs.contiguous(), wc, ws.contiguous()


def _fp8_library(case):
    """The yardstick call and its name: ``torch._scaled_mm`` with 1x128 /
    128x128 block scales where this build of torch takes them (and gives
    the plain version's result), else a bf16 ``torch.matmul`` on the weight
    from ``weight_cast_to_bf16``, which is what the loader's route costs."""
    from llmc_tpu_torch.ops.fp8_gemm import fp8_block_matmul_plain
    from llmc_tpu_torch.quant import weight_cast_to_bf16
    x, xc, xs, wc, ws = case
    want = fp8_block_matmul_plain(xc, xs, wc, ws, out_dtype=F32)
    for sa, sb in ((xs.t().contiguous().t(), ws.t()),
                   (xs, ws.t().contiguous()),
                   (xs.t().contiguous().t(), ws.t().contiguous())):
        def scaled(sa=sa, sb=sb):
            return torch._scaled_mm(xc, wc.t(), scale_a=sa, scale_b=sb,
                                    out_dtype=BF16)
        try:
            got = scaled()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError, NotImplementedError):
            continue
        if _rel(got, want)[1] <= TOL_W4_BF16:
            return scaled, 'torch._scaled_mm, 1x128 and 128x128 block scales'
    w = weight_cast_to_bf16(wc, ws)
    return (lambda: torch.matmul(x, w.T)), \
        'torch.matmul, bf16 weight from weight_cast_to_bf16'


def check_fp8(dev, peaks, shapes=FP8_SHAPES, ms_list=(1, 64, 77, 128, 4096),
              timed=(1, 64, 128, 4096), bs=128, contiguous_w=False):
    """The FP8-block kernel at every (N, K) and M, f32 and bf16 output, in
    scale blocks of ``bs`` (the whole K where ``bs`` is 'K'), against its
    plain version and the float64 oracle; with ``contiguous_w`` on the
    weight codes in contiguous rows (not padded to 16 bytes as the cast
    packs them: where K is no multiple of 16 the kernel reads them without
    TMA).  Times by CUDA events at the
    ``timed`` Ms (block size 128), with the host's microseconds a launch
    and, up to M=128, the device time through a CUDA graph."""
    from llmc_tpu_torch.ops import fp8_gemm as G
    from llmc_tpu_torch.ops.dequant_matmul import wgmma_tiling
    from llmc_tpu_torch.quant import act_quant_per_group, fp8_block_matmul
    from llmc_tpu_torch.utils.device import sm_count
    gen = torch.Generator(device=dev).manual_seed(4)
    rows, worst_abs, worst_rel, worst_oracle = [], 0.0, 0.0, 0.0
    for (N, K), M in itertools.product(shapes, ms_list):
        b = K if bs == 'K' else bs
        case = _fp8_case(N, K, M, gen, dev, b)
        if contiguous_w:
            case = case[:3] + (case[3].contiguous(),) + case[4:]
        x, xc, xs, wc, ws = case
        plain = G.fp8_block_matmul_plain(xc, xs, wc, ws, b, out_dtype=F32)
        oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws, b,
                                          out_dtype=torch.float64,
                                          acc_dtype=torch.float64)
        got32 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, b, out_dtype=F32)
        got16 = G.fp8_block_matmul_cuda(xc, xs, wc, ws, b, out_dtype=BF16)
        torch.cuda.synchronize()
        err, rel_p = _rel(got32, plain)
        _, rel_o = _rel(got32, oracle)
        err16, rel16 = _rel(got16, plain)
        what = f'fp8_block_gemm N={N} K={K} M={M} block {b}'
        finite = bool(torch.isfinite(got32).all()
                      and torch.isfinite(got16).all())
        require(finite and rel_o <= TOL_FP8_ORACLE
                and rel_p <= TOL_FP8_ORACLE and rel16 <= TOL_W4_BF16,
                f'{what}: rel err {rel_o:.3g} vs the float64 oracle, '
                f'{rel_p:.3g} vs plain (limit {TOL_FP8_ORACLE}), bf16 output '
                f'{rel16:.3g} (limit {TOL_W4_BF16})')
        worst_abs, worst_rel = max(worst_abs, err16), max(worst_rel, rel16)
        worst_oracle = max(worst_oracle, rel_o)
        tt, splits = wgmma_tiling(M, N, K // b, sm_count(dev.index or 0))
        row = dict(N=N, K=K, M=M, block=b, tok_tile=tt, splits=splits,
                   f32_rel_err_oracle=rel_o, f32_rel_err_plain=rel_p,
                   max_abs_err=err16, max_rel_err=rel16)
        del plain, oracle, got32, got16
        if M in timed and b == 128:
            n_copy = max(1, min(8, -(-160_000_000 // wc.numel())))
            copies = [wc] + [wc.clone() for _ in range(n_copy - 1)]
            it = [0]

            def rotating(fn):
                def call():
                    it[0] += 1
                    return fn(copies[it[0] % n_copy])
                return call
            iters = 10 if M >= 4096 else 50
            kern = rotating(lambda w: G.fp8_block_matmul_cuda(xc, xs, w, ws))
            row['kernel_ms'] = cuda_ms(kern, iters)
            row['host_us'] = host_us(kern)
            if M <= 128:
                row['device_ms'] = graph_ms(kern)
            row['path_ms'] = cuda_ms(rotating(
                lambda w: fp8_block_matmul(*act_quant_per_group(x), w, ws)),
                iters)
            row['plain_ms'] = cuda_ms(
                lambda: G.fp8_block_matmul_plain(xc, xs, wc, ws), 2, 1)
            lib, row['library'] = _fp8_library(case)
            row['library_ms'] = cuda_ms(lib, iters)
            row['bound_ms'], row['bound_by'] = fp8_bound(M, N, K, 2, peaks)
            del lib, copies, kern
        rows.append(row)
        del case, x, xc, xs, wc, ws
    return rows, worst_abs, worst_rel, worst_oracle


def fp8_adder_probe(dev, M=16, N=128, K=1024):
    """What the kernel keeps when a block's products differ widely in
    size: in every 32-wide k step one product of 448 * 448 (about
    2^17.6) beside 31 products of 2^-6 * 16 = 2^-2, which float32 adds
    exactly (the sum of a block needs 21 bits).  An adder that aligns to
    the step's largest product and keeps fewer bits loses the small ones:
    124 * 2^-2 in 4 * 448^2 of a block, 3.9e-5 of the output.  Returns the
    kernel's error against the float64 oracle, relative to the largest
    output."""
    from llmc_tpu_torch.ops import fp8_gemm as G
    x = torch.full((M, K), 2.0 ** -6, device=dev)
    w = torch.full((N, K), 16.0, device=dev)
    x[:, ::32] = 448.0
    w[:, ::32] = 448.0
    # rows and columns differ, so that no two outputs are the same sum
    x[:, 1::32] *= torch.arange(1, M + 1, device=dev)[:, None].float()
    w[:, 2::32] /= 2.0 ** torch.arange(N, device=dev)[:, None].remainder(4)
    xc, wc = x.to(torch.float8_e4m3fn), w.to(torch.float8_e4m3fn)
    xs = torch.ones((M, K // 128), device=dev)
    ws = torch.ones((N // 128, K // 128), device=dev)
    oracle = G.fp8_block_matmul_plain(xc, xs, wc, ws,
                                      out_dtype=torch.float64,
                                      acc_dtype=torch.float64)
    return _rel(G.fp8_block_matmul_cuda(xc, xs, wc, ws, out_dtype=F32),
                oracle)[1]


# --------------------------------------------------------------------------
# model phases (device and sizes are arguments, so the CPU tests run them)
# --------------------------------------------------------------------------

# The w4 design probes (rows 7 to 15 of PERF.md's kernel table), each with
# the TPU kernel it replaces: the tool's pallas_call and its kernel function
PROBE_KERNELS = {
    'bf16_chunked': ('tools/kernel_bench.py:113',
                     'tools/kernel_bench.py::_bf16_kernel'),
    'bf16_bigdot': ('tools/w4_probe.py:149', 'tools/w4_probe.py::_bf16_big'),
    'i8_cast': ('tools/kernel_bench.py:151',
                'tools/kernel_bench.py::_i8_kernel'),
    'i8xi8_int32': ('tools/w4_probe.py:210', 'tools/w4_probe.py::_i8i8'),
    'w4_blockdecode': ('tools/w4_probe.py:257',
                       'tools/w4_probe.py::_w4_block'),
    'w4_fullq': ('tools/kernel_bench.py:236',
                 'tools/kernel_bench.py::_fullq_kernel'),
    'i32_window': ('tools/kernel_bench.py:191',
                   'tools/kernel_bench.py::_i32_kernel'),
    'w4_xc': ('tools/kernel_bench.py:297',
              'tools/kernel_bench.py::_xc_kernel'),
    'i4_native': ('tools/w4_probe.py:295', 'tools/w4_probe.py::_i4_big'),
    # B1's design before its wgmma redesign, the tools' ``w4_current``
    'w4_mma_sync': ('llmc_tpu/ops/dequant_matmul.py:426',
                    'llmc_tpu/ops/dequant_matmul.py::_kernel_w4'),
}
# the CUDA source of each probe
PROBE_SOURCES = dict(dict.fromkeys(PROBE_KERNELS, 'probe_gemm.cu'),
                     w4_mma_sync='dequant_matmul_w4_mma.cu')
# every kernel of the port: the probes, then the main paths' seven (the
# W4A8 path's activation quantizer replaces no TPU kernel)
KERNEL_NAMES = tuple(PROBE_KERNELS) + (
    'w4_dequant_matmul', 'w4a8_dequant_matmul', 'quant_act_token',
    'w8_dequant_matmul', 'flash_decode', 'batch_decode', 'fp8_block_gemm')
# A serving configuration: weight bits, per-token int8 activations on the
# block linears, and the decode-attention kernel (``ATTN_IMPL``).
Mode = collections.namedtuple('Mode', 'bits a_int8 attn')
MODES = {'w4a16': Mode(4, False, 'flash'), 'w4a8': Mode(4, True, 'batch'),
         'w8a16': Mode(8, False, 'flash')}


def _wspec(bits=4, group_size=128):
    from llmc_tpu_torch.quant import QuantSpec
    return QuantSpec(bit=bits, symmetric=True, granularity='per_group',
                     group_size=group_size)


def make_model(mode, cfg_kw, dev, seed=0, group_size=128):
    """Random packed Llama of a serving mode, and its QMap."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.serve.packed import random_packed_llama
    m = MODES[mode]
    return random_packed_llama(LlamaConfig(**cfg_kw),
                               _wspec(m.bits, group_size), seed=seed,
                               fuse=True, pre_t=True, head=True,
                               a_int8=m.a_int8, device=dev)


@contextlib.contextmanager
def attn_impl(name):
    """Run a block under ``serve.decode.ATTN_IMPL = name``."""
    from llmc_tpu_torch.serve import decode
    old, decode.ATTN_IMPL = decode.ATTN_IMPL, name
    try:
        yield
    finally:
        decode.ATTN_IMPL = old


def expected_launches(layers, forwards, decode_steps, mode='w4a16',
                      block_forwards=None):
    """Launches a path implies.  Per forward: 4 block linears a layer
    (fused qkv, o, fused gate_up, down) through the mode's kernel (for
    W4A8 each after one launch of the activation quantizer) and the
    packed head through the weight-only kernel of its bits; per decode
    step, one decode-attention a layer.  ``block_forwards``: the forwards
    whose block linears launch a kernel at all (the w8 companion's dot is
    no kernel of the port), default every forward."""
    m = MODES[mode]
    n = dict.fromkeys(KERNEL_NAMES, 0)
    weight_only = 'w8_dequant_matmul' if m.bits == 8 else 'w4_dequant_matmul'
    block = 'w4a8_dequant_matmul' if m.a_int8 else weight_only
    n[block] += 4 * layers * (forwards if block_forwards is None
                              else block_forwards)
    if m.a_int8:
        n['quant_act_token'] = n[block]
    n[weight_only] += forwards
    n['batch_decode' if m.attn == 'batch' else 'flash_decode'] = \
        layers * decode_steps
    return n


def _scale_weights(tree, factor) -> None:
    """Multiply every packed linear's scales by ``factor``, in place."""
    if isinstance(tree, dict):
        if 'qweight' in tree:
            tree['scales'] = tree['scales'] * factor
            return
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            _scale_weights(v, factor)


@contextlib.contextmanager
def plain_linears(w_bf16=False):
    """Send the card's dequant-matmuls through their plain versions (the
    parity phase's control run: same bf16 activations, no kernel).
    ``w_bf16`` rounds a W8 weight to bf16 as the W8 kernel does."""
    D = importlib.import_module('llmc_tpu_torch.ops.dequant_matmul')

    def plain(x2, packed, scales, zeros, meta, out_dtype, a_int8):
        if a_int8:
            return D.dequant_matmul_plain_a8(x2, packed, scales, zeros, meta,
                                             out_dtype=out_dtype)
        return D.dequant_matmul_plain(x2, packed, scales, zeros, meta,
                                      out_dtype=out_dtype,
                                      w_bf16=w_bf16 and meta.bits == 8)
    old, D._dequant_matmul_cuda = D._dequant_matmul_cuda, plain
    try:
        yield
    finally:
        D._dequant_matmul_cuda = old


def phase_parity(dev, ref_dev, cfg_kw, prompt_len=32, steps=8, seed=0,
                 mode='w4a16', group_size=128):
    """The same random packed weights on ``dev`` (bf16) and ``ref_dev``
    (f32).  The reference is teacher-forced on ``dev``'s greedy tokens,
    so every step's logits compare like with like."""
    from llmc_tpu_torch.models import LlamaAdapter
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    src, qmap = make_model(mode, cfg_kw, 'cpu', seed, group_size)
    cfg = src.cfg
    if MODES[mode].bits == 8:
        # the random model gives 8-bit codes (+-128) the scale of the 4-bit
        # ones (+-8); a sixteenth of it gives the W8 parity model the W4
        # model's weight magnitude, so that the attention softmax is not
        # saturated to one-hot rows whose argmax a rounding can flip
        _scale_weights(src.params, 1 / 16)
    cfg32 = dataclasses.replace(cfg, dtype='float32')
    m_dev = LlamaAdapter(cfg, tree_to(src.params, dev))
    m_ref = LlamaAdapter(cfg32, tree_to(src.params, ref_dev, F32))
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, prompt_len)))

    def run(model, device, feed=None):
        cache = init_cache(model, 1, prompt_len + steps, policy,
                           device=device)
        logits, cache = forward_cached(model.params, model.cfg,
                                       ids.to(device), cache, policy, qmap)
        rows = [logits[:, -1].float().cpu()]
        tok = rows[-1].argmax(-1)
        toks = [int(tok)]
        for i in range(steps):
            t = tok if feed is None else torch.tensor([feed[i]])
            logits, cache = forward_cached(model.params, model.cfg,
                                           t[:, None].to(device), cache,
                                           policy, qmap)
            rows.append(logits[:, -1].float().cpu())
            tok = rows[-1].argmax(-1)
            toks.append(int(tok))
        return torch.cat(rows), toks

    with torch.no_grad(), attn_impl(MODES[mode].attn):
        reset_launch_counts()
        got, toks = run(m_dev, dev)
        counts, xla = read_counts()
        want, ref_toks = run(m_ref, ref_dev, feed=toks)
        # control runs on ``dev``: the same bf16 activations through the
        # plain linears, to tell the kernels' share of the error from the
        # working type's
        controls, same_fn = {}, None
        if dev.type == 'cuda':
            for name, w_bf16 in (('plain_linears', False),
                                 ('plain_linears_bf16_weight', True)):
                if w_bf16 and MODES[mode].bits != 8:
                    continue
                with plain_linears(w_bf16):
                    ctl, _ = run(m_dev, dev, feed=toks)
                controls[name] = _rel(ctl, want)[1]
                # the last control computes the kernels' own function (the
                # W8 kernel rounds its weight to bf16): the kernel run is
                # held against it directly
                same_fn = _rel(got, ctl)[1]
    err, rel = _rel(got, want)
    agree = float(np.mean([a == b for a, b in zip(toks, ref_toks)]))
    tol = TOL_PARITY[mode]
    return dict(phase='parity', mode=mode, seed=seed,
                layers=cfg.num_hidden_layers,
                width=cfg.hidden_size, prompt=prompt_len, steps=steps,
                max_abs_logit_err=err, rel_logit_err=rel,
                rel_logit_err_of_controls=controls,
                rel_logit_err_vs_same_function_control=same_fn,
                greedy_agreement=agree, tolerance=tol,
                tolerance_vs_same_function_control=TOL_VS_CONTROL[mode],
                min_greedy_agreement=MIN_GREEDY_AGREE,
                ok=bool(rel <= tol and agree >= MIN_GREEDY_AGREE
                        and all(rel <= PARITY_VS_CONTROL * c
                                for c in controls.values())
                        and (same_fn is None
                             or same_fn <= TOL_VS_CONTROL[mode])),
                launches=counts, xla_branch_calls=xla, expected_launches=expected_launches(
                    cfg.num_hidden_layers, 1 + steps, steps, mode))


def serve_requests(n, vocab, max_prompt=200, seed=0, new_tokens=16,
                   fixed=False):
    """``n`` requests, prompts spread over 10 to ``max_prompt`` tokens,
    each asking for ``new_tokens`` to about twice that many; ``fixed``:
    every prompt ``max_prompt`` tokens, each asking ``new_tokens``."""
    from llmc_tpu_torch.serve import Request
    rng = np.random.RandomState(seed)
    lens = (np.full(n, max_prompt) if fixed
            else np.linspace(10, max_prompt, n).astype(int))
    rng.shuffle(lens)
    return [Request(uid=i, prompt_ids=rng.randint(0, vocab, (int(p),)),
                    max_new_tokens=int(new_tokens if fixed else new_tokens
                                       + (i * 7) % (new_tokens + 1)))
            for i, p in enumerate(lens)]


def allocator_counts(dev):
    """The caching allocator's device allocations, frees and retries so
    far on ``dev`` (none on the CPU)."""
    if dev.type != 'cuda':
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ('num_device_alloc', 'num_device_free',
                                      'num_alloc_retries')}


def host_decode_steps(eng) -> int:
    """The decode steps of ``eng`` whose kernels a wrapper launched:
    every step but a graph's replays, where a captured window of K steps
    ran eagerly once and was captured once."""
    return eng.stats['decode_steps'] - sum(
        k * (g.replays - 1) for k, g in eng._graphs.items())


def serve_run(dev, model, qmap, n_requests=10, max_batch=8, max_len=256,
              buckets=(32, 64, 128, 256), max_prompt=200, mode='w4a16',
              w8_flag=None, eager=False, K=1, kv_policy=None, **engine_kw):
    """``ServingEngine.run`` over ``serve_requests``: (the phase record
    with the launch counts the path implies, the requests' tokens, the
    engine).  The engine replays its captured decode step, or with
    ``eager`` is an ``EagerServingEngine``; ``K`` is
    ``decode_steps_per_sync``; ``w8_flag`` ('prefill_w8' or 'decode_w8')
    sends those forwards through the model's w8 companion, whose block
    linears launch no kernel of the port.  A paged pool's decode reads the
    pool in torch ops (the reference has no kernel there either): its
    steps launch no decode-attention kernel.  The counters count the
    wrappers' launches, which a graph's replay does not make: a captured
    window of K steps launches K steps' kernels in its eager first run and
    K in its capture, and none in a replay (``host_decode_steps``; the
    device's count of a replay's kernels is ``phase_profile``'s).
    ``first_run_s``, ``gc_s`` and ``capture_s``: the seconds of those
    first runs, of the garbage collection before each capture and of the
    captures; on the card, ``allocator`` counts the caching
    allocator's device allocations, frees and retries (a retry frees every
    cached block first) in the run."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      ServingEngine)
    cfg = model.cfg
    policy = kv_policy or KVCachePolicy(method='naive', bit=8)
    with attn_impl(MODES[mode].attn):
        eng = (EagerServingEngine if eager else ServingEngine)(
            model, qmap=qmap, max_batch=max_batch, max_len=max_len,
            prefill_buckets=buckets, kv_policy=policy,
            decode_steps_per_sync=K, device=dev, **engine_kw,
            **({w8_flag: True} if w8_flag else {}))
        reqs = serve_requests(n_requests, cfg.vocab_size, max_prompt)
        alloc = allocator_counts(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        eng.run(reqs)
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, xla = read_counts()
        alloc = {k: v - alloc[k] for k, v in allocator_counts(dev).items()}
    L = cfg.num_hidden_layers
    prefills, steps = eng.stats['prefill_forwards'], eng.stats['decode_steps']
    host_steps = host_decode_steps(eng)
    graphs = eng._graphs.values()
    block_forwards = {None: None, 'prefill_w8': host_steps,
                      'decode_w8': 0}[w8_flag]
    expect = expected_launches(L, prefills + host_steps,
                               0 if eng.paged else host_steps, mode,
                               block_forwards)
    done = all(r.done and len(r.output_ids) == r.max_new_tokens
               and all(0 <= t < cfg.vocab_size for t in r.output_ids)
               for r in reqs)
    name = 'serve' if mode == 'w4a16' else f'serve_{mode.replace("a16", "")}'
    if w8_flag:
        name = f'serve_w8_companion.{w8_flag}'
    rec = dict(phase=name, mode=mode, layers=L, requests=len(reqs),
               prompt_lens=[len(r.prompt_ids) for r in reqs],
               tokens=sum(len(r.output_ids) for r in reqs),
               graphed=eng.graphed, window=K,
               graph_replays=sum(g.replays for g in graphs),
               first_run_s=sum(g.first_s for g in graphs),
               gc_s=sum(g.gc_s for g in graphs),
               capture_s=sum(g.capture_s for g in graphs), allocator=alloc,
               wall_s=wall, **eng.stats, host_decode_steps=host_steps,
               launches=counts,
               xla_branch_calls=xla, expected_launches=expect,
               all_done=done)
    return rec, [list(r.output_ids) for r in reqs], eng


def phase_serve_graph(dev, model, qmap, graph_tokens, mode='w4a16', **kw):
    """The serve phase's requests again through the eager step, and
    through the captured K=4 window: each run's tokens against the
    captured single step's (``graph_tokens``), each run's launch counts
    against what its path implies.  The eager run's counts are the
    kernels' launches on the main path (the ``kernels`` line)."""
    runs = {}
    for name, run_kw in (('eager', dict(eager=True)),
                         ('window_4', dict(K=4))):
        rec, toks, _ = serve_run(dev, model, qmap, mode=mode, **run_kw,
                                 **kw)
        runs[name] = (rec, toks)
    eager, window = runs['eager'][0], runs['window_4'][0]
    return dict(
        phase=f'serve_graph.{mode}', mode=mode, layers=eager['layers'],
        requests=eager['requests'], tokens=eager['tokens'],
        eager_tokens_equal=runs['eager'][1] == graph_tokens,
        window_tokens_equal=runs['window_4'][1] == graph_tokens,
        eager_wall_s=eager['wall_s'], window_wall_s=window['wall_s'],
        window_graph_replays=window['graph_replays'],
        window_first_run_s=window['first_run_s'],
        window_gc_s=window['gc_s'],
        window_capture_s=window['capture_s'],
        window_decode_steps=window['decode_steps'],
        window_host_decode_steps=window['host_decode_steps'],
        launches=eager['launches'],
        expected_launches=eager['expected_launches'],
        xla_branch_calls=eager['xla_branch_calls'],
        window_launches=window['launches'],
        window_expected_launches=window['expected_launches'],
        window_xla_branch_calls=window['xla_branch_calls'],
        all_done=eager['all_done'] and window['all_done'])


# the paged pool's eager serve at the model's depth: 13.8 s at 32 layers on
# an H100; cut to 16 to pay for phase 20's time, to 8 for phase 22's
SERVE_PAGED_LAYERS = 8


def phase_serve_paged(dev, model, qmap, cfg_kw, n_requests=10, max_batch=8,
                      max_len=256, page_size=16, n_pages=48, seed=0,
                      group_size=128, **kw):
    """W4A16 into an int8 paged pool smaller than the dense allocation
    (``n_pages`` of ``page_size`` against max_batch x max_len / page_size)
    with chunked admission (chunks of 64, two an engine step): at the
    model's depth every request finishes, requests wait on the pool, and
    the free list is whole at the end.  Then at 2 layers of a float32
    model, with the same chunked admission, each pool against the dense
    cache of its kind: an fp pool reads the very values the dense fp cache
    holds (its prefill runs on the same dense fp local cache), so their
    tokens must be equal; an int8 pool's prefill attends over fp values
    where the dense int8 engine's attends over the codes it wrote (the
    reference's design), so there the share of requests whose tokens are
    equal is recorded.  The int8 pool is held instead to the CPU's (whose
    engine the CPU tests hold to the JAX engine): the same pool and
    admission at 2 layers of an unpacked float32 model (torch matmuls on
    both devices) give the same tokens on the card as on the CPU."""
    from llmc_tpu_torch.serve import KVCachePolicy, PagedKVPolicy
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.serve.packed import random_packed_llama
    pol = PagedKVPolicy(page_size=page_size, n_pages=n_pages,
                        max_pages=max_len // page_size, bit=8)
    chunked = dict(prefill_chunk=64, prefill_chunks_per_step=2, **kw)
    rec, _, eng = serve_run(dev, model, qmap, n_requests=n_requests,
                            max_batch=max_batch, max_len=max_len,
                            kv_policy=pol, **chunked)
    small = dict(cfg_kw, num_hidden_layers=2, dtype='float32')
    m32, q32 = random_packed_llama(LlamaConfig(**small),
                                   _wspec(4, group_size), seed=seed,
                                   fuse=True, pre_t=True, head=True,
                                   device=dev)
    same = {}
    for bit, dense in ((0, dict(method='fp')),
                       (8, dict(method='naive', bit=8))):
        _, paged_toks, _ = serve_run(
            dev, m32, q32, n_requests=n_requests, max_batch=max_batch,
            max_len=max_len, kv_policy=dataclasses.replace(pol, bit=bit),
            **chunked)
        _, dense_toks, _ = serve_run(
            dev, m32, q32, n_requests=n_requests, max_batch=max_batch,
            max_len=max_len, kv_policy=KVCachePolicy(**dense), **chunked)
        same[bit] = [a == b for a, b in zip(paged_toks, dense_toks)]
    del m32, q32
    cpu = torch.device('cpu')
    host = LlamaAdapter.random(LlamaConfig(**small), seed=seed, device=cpu)
    toks = []
    for d, m in ((cpu, host),
                 (dev, LlamaAdapter(host.cfg, tree_to(host.params, dev)))):
        toks.append(serve_run(d, m, None, n_requests=n_requests,
                              max_batch=max_batch, max_len=max_len,
                              kv_policy=pol, **chunked)[1])
        del m
    del host
    rec.update(phase='serve_paged', pool_pages=n_pages, page_size=page_size,
               dense_pages=max_batch * max_len // page_size,
               requests_waited_on_the_pool=eng.stats['pool_waits'] > 0,
               free_pages_at_end=len(eng.allocator.free),
               pool_whole_at_end=sorted(eng.allocator.free)
               == list(range(n_pages - 1)),
               fp_pool_tokens_equal_dense_fp_at_2_layers_f32=all(same[0]),
               int8_pool_requests_equal_dense_int8_at_2_layers_f32=float(
                   np.mean(same[8])),
               int8_pool_tokens_equal_cpu_at_2_layers_f32=toks[1] == toks[0])
    return rec


def companion_model(dev, cfg_kw, seed=0, group_size=128):
    """A random fp Llama packed W4 with the per-channel int8 companion
    beside every block linear (``pack_model(w8_prefill=True)`` builds it
    from the dequantized weight), and its serving QMap."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.serve import pack_model
    model = LlamaAdapter.random(LlamaConfig(**cfg_kw), seed=seed, device=dev)
    qmap = pack_model(model, _wspec(4, group_size), fuse=True, head=True,
                      w8_prefill=True)
    return model, qmap


def _bench_decode(model, qmap, policy, cache, tok):
    """The bench's decode step over static buffers: ``cache`` with a
    per-slot ``pos`` tensor, ``tok`` [B]; both advance in place."""
    from llmc_tpu_torch.serve.decode import forward_cached
    cfg = model.cfg

    def step():
        logits, out = forward_cached(model.params, cfg, tok[:, None], cache,
                                     policy, qmap)
        cache['pos'].copy_(out['pos'])
        tok.copy_(logits[:, -1].argmax(-1))
        return tok
    return step


def _sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def _bench_prefill(dev, model, qmap, policy, ids, steps):
    """The bench's prefill of ``ids`` [B, P] on a cache with room for
    ``steps`` more tokens (and one for a graph's warm-up step); returns
    (cache with a per-slot ``pos`` tensor, the greedy tokens, seconds)."""
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    B, P = ids.shape
    cache = init_cache(model, B, P + steps + 1, policy, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = forward_cached(model.params, model.cfg, ids, cache,
                                   policy, qmap, last_only=True)
    tok = logits[:, -1].argmax(-1)
    _sync(dev)
    ttft = time.perf_counter() - t0
    cache['pos'] = torch.full((B,), P, dtype=torch.int32, device=dev)
    return cache, tok, ttft


def phase_throughput(dev, model, qmap, B=128, prefill=32, steps=64, seed=0,
                     mode='w4a16'):
    """The reference bench's shape on the port: prefill, then greedy
    decode steps, timed with host clocks around synchronised work, through
    the captured step (``serve/graphs.py``, as the reference's bench jits
    its decode scan) and through the eager step, in turns: eager, graph,
    graph, eager (on the CPU, which has no graph, one eager turn).  The
    graph's first call runs the step eagerly and captures it, before the
    clock starts.  One prefill and one step on a throwaway cache first
    take the first-use costs (allocator growth, library handles) out of
    TTFT.  The record's ``step_ms``, ``tokens_per_s`` and ``ttft_ms`` are
    the graph turns' means (the eager turn's on the CPU), ``eager_*`` the
    eager turns'."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.graphs import CapturedStep
    cfg = model.cfg
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, prefill)), device=dev)
    runs = {'eager': [], 'graph': []}
    turns = (('eager', 'graph', 'graph', 'eager') if dev.type == 'cuda'
             else ('eager',))
    with torch.no_grad(), attn_impl(MODES[mode].attn):
        cache, tok, _ = _bench_prefill(dev, model, qmap, policy, ids, 1)
        _bench_decode(model, qmap, policy, cache, tok)()
        del cache, tok
        for variant in turns:
            reset_launch_counts()
            cache, tok, ttft = _bench_prefill(dev, model, qmap, policy, ids,
                                              steps)
            step = _bench_decode(model, qmap, policy, cache, tok)
            forwards = 1 + steps
            if variant == 'graph':
                step = CapturedStep(step, dev)
                step()                  # runs the step, then captures it
                # launched: the prefill, the eager run and the capture
                # (a replay launches nothing from the host)
                forwards = 3
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            _sync(dev)
            dec = time.perf_counter() - t0
            counts, xla = read_counts()
            runs[variant].append(dict(
                step_ms=dec / steps * 1e3, tokens_per_s=B * steps / dec,
                ttft_ms=ttft * 1e3, launches=counts, xla_branch_calls=xla,
                expected_launches=expected_launches(
                    cfg.num_hidden_layers, forwards, forwards - 1, mode)))
            del step, cache, tok
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
    e = runs['eager']
    g = runs['graph'] or e
    return dict(phase='throughput', mode=mode, B=B, prefill=prefill,
                steps=steps, tokens_per_s=np.mean([r['tokens_per_s']
                                                   for r in g]),
                ttft_ms=np.mean([r['ttft_ms'] for r in g]),
                step_ms=np.mean([r['step_ms'] for r in g]),
                eager_tokens_per_s=np.mean([r['tokens_per_s'] for r in e]),
                eager_ttft_ms=np.mean([r['ttft_ms'] for r in e]),
                eager_step_ms=np.mean([r['step_ms'] for r in e]),
                turns=[dict(variant=v, **{k: r[k] for k in
                                          ('step_ms', 'tokens_per_s',
                                           'ttft_ms')})
                       for v, r in zip(turns, (e + runs['graph'])[:1]
                                       + runs['graph'] + e[1:])],
                launches=g[-1]['launches'],
                xla_branch_calls=max(r['xla_branch_calls'] for r in g + e),
                expected_launches=g[-1]['expected_launches'],
                eager_launches=e[-1]['launches'],
                eager_expected_launches=e[-1]['expected_launches'])


# idle host time on each side of a profiled block: the profiler drops a
# device record whose time, converted from the card's clock, falls outside
# its window, and the two clocks can disagree by about a millisecond there
# (a graph's last millisecond of kernels went missing once without it)
PROFILE_PAD_S = 0.1


@contextlib.contextmanager
def device_profile():
    """torch.profiler (host and device) over the block, with
    ``PROFILE_PAD_S`` of idle host time before and after it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def profiled_kernel_calls(prof):
    """The device's count of each port kernel in a torch.profiler run,
    by the name of its wrapper: the kernels of a graph's replays too,
    which no wrapper launched.  Each wrapper launches one main kernel a
    call (B5 one of two), with helpers beside it (split sums, the W4
    piece sums) that are not counted."""
    from torch.autograd import DeviceType
    syms = {name: (f'{name}_kernel',) for name in KERNEL_NAMES
            if name not in PROBE_KERNELS}
    syms['batch_decode'] += ('batch_decode_mma_kernel',)
    pats = {name: re.compile(r'(^|[\s:])(' + '|'.join(v) + r')[<(]')
            for name, v in syms.items()}
    calls = dict.fromkeys(syms, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for name, pat in pats.items():
            if pat.search(e.key):
                calls[name] += e.count
    return calls


def phase_profile(dev, model, qmap, B=128, prefill=32, steps=8, top=12,
                  mode='w4a16', graph=True):
    """torch.profiler over ``steps`` decode steps after a prefill of
    ``prefill`` tokens a slot (the bench's shape by default), through the
    captured step (``graph``; captured before the profiler starts) or the
    eager one: device time by kernel, the decode attention's share of it,
    and the device's busy share of the wall.  ``kernel_calls``: the port's
    kernels the device ran in those steps, which must equal
    ``device_expected_launches`` through the graph as eagerly."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.graphs import CapturedStep
    cfg = model.cfg
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.randint(0, cfg.vocab_size, (B, prefill), device=dev)
    with torch.no_grad(), attn_impl(MODES[mode].attn):
        reset_launch_counts()
        cache, tok, _ = _bench_prefill(dev, model, qmap, policy, ids, steps)
        step = _bench_decode(model, qmap, policy, cache, tok)
        forwards = 1 + steps
        if graph:
            step = CapturedStep(step, dev)
            step()                      # runs the step, then captures it
            forwards = 3    # the prefill, the eager run and the capture
        torch.cuda.synchronize()
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, xla = read_counts()
        del step, cache, tok
    # device-side events only: a host op (aten::mean) also reports the
    # device time of the kernel it launched, which would count it twice
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0))
        if dt > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dt, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3          # ms
    attn = sum(r[0] for r in rows
               if 'flash_decode' in r[1] or 'batch_decode' in r[1]) / 1e3
    return dict(phase='profile', mode=mode, graph=graph, B=B,
                prefill=prefill, steps=steps, wall_ms=wall * 1e3,
                device_busy_ms=busy,
                device_busy_ms_per_step=busy / steps,
                attention_ms_per_step=attn / steps,
                attention_share=attn / busy if busy else 0.0,
                device_idle_share=max(0.0, 1 - busy / (wall * 1e3)),
                per_step_ms=wall * 1e3 / steps,
                top=[dict(kernel=k[:80], ms=dt / 1e3, calls=c)
                     for dt, k, c in rows[:top]],
                kernel_calls=profiled_kernel_calls(prof),
                device_expected_launches=expected_launches(
                    cfg.num_hidden_layers, steps, steps, mode),
                launches=counts, xla_branch_calls=xla,
                expected_launches=expected_launches(
                    cfg.num_hidden_layers, forwards, forwards - 1, mode))


def phase_profile_prefill(dev, model, qmap, B=128, prefill=32, top=8,
                          mode='w4a16'):
    """torch.profiler over the bench's prefill (eager, as the engine's
    prefill is): its wall, the device's busy time and idle share, i.e. the
    share of TTFT that the host takes, which a captured prefill could
    remove."""
    from torch.autograd import DeviceType
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import KVCachePolicy
    policy = KVCachePolicy(method='naive', bit=8)
    ids = torch.randint(0, model.cfg.vocab_size, (B, prefill), device=dev)
    with torch.no_grad(), attn_impl(MODES[mode].attn):
        _bench_prefill(dev, model, qmap, policy, ids, 0)      # first use
        reset_launch_counts()
        with device_profile() as prof:
            _, _, ttft = _bench_prefill(dev, model, qmap, policy, ids, 0)
        counts, xla = read_counts()
    rows = sorted(((getattr(e, 'self_device_time_total',
                            getattr(e, 'self_cuda_time_total', 0)), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    return dict(phase='profile_prefill', mode=mode, B=B, prefill=prefill,
                wall_ms=ttft * 1e3, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / (ttft * 1e3)),
                top=[dict(kernel=k[:80], ms=dt / 1e3) for dt, k in rows[:top]
                     if dt > 0],
                launches=counts, xla_branch_calls=xla,
                expected_launches=expected_launches(
                    model.cfg.num_hidden_layers, 1, 0, mode))


def step_bound(model, B, prefill, steps, peaks, mode='w4a16'):
    """Least time of one decode step: the packed weights' bytes (codes,
    scales, zeros) + the average valid int8 KV prefix, against the
    linears' operations at the peak of the type they multiply in (int8
    for the block linears of W4A8, bf16 otherwise and for the head)."""
    cfg = model.cfg

    def walk(t):
        """(bytes, weights) of every packed linear under ``t``."""
        if isinstance(t, dict):
            if 'qweight' in t:
                nbytes = sum(t[k].numel() * t[k].element_size()
                             for k in ('qweight', 'scales', 'zeros')
                             if t.get(k) is not None)
                per_byte = 2 if t['qweight'].dtype == torch.uint8 else 1
                return nbytes, t['qweight'].numel() * per_byte
            t = list(t.values())
        if isinstance(t, list):
            parts = [walk(v) for v in t]
            return sum(p[0] for p in parts), sum(p[1] for p in parts)
        return 0, 0
    blk_bytes, blk_params = walk(model.params['blocks'])
    head_bytes, head_params = walk(model.params.get('lm_head'))
    L, KVH, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim)
    valid = prefill + steps / 2
    kv = 2 * L * B * valid * KVH * (hd + 4)
    wbytes = blk_bytes + head_bytes
    t_b = (wbytes + kv) / peaks.bw * 1e3
    blk_peak = peaks.int8 if MODES[mode].a_int8 else peaks.bf16
    t_o = 2 * B * (blk_params / blk_peak + head_params / peaks.bf16) * 1e3
    return dict(step_bound_ms=max(t_b, t_o),
                step_bound_by='bytes' if t_b >= t_o else 'operations',
                weight_bytes=wbytes, kv_bytes_avg=kv,
                linear_params=blk_params + head_params)


# --------------------------------------------------------------------------
# the FP8-block linear and the compression pipeline
# --------------------------------------------------------------------------

def phase_fp8_linear(dev, cfg_kw, M=128, seed=0, block_size=128):
    """One block's seven linears as an FP8-block checkpoint stores them:
    random weights -> ``weight_cast_to_fp8``; M rows of bf16 activations
    -> ``act_quant_per_group`` -> ``fp8_block_matmul``.  Each output is
    held against x @ weight_cast_to_bf16(codes, scale_inv)^T in f32 and
    against the plain version on the same codes."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.quant import (act_quant_per_group, fp8_block_matmul,
                                      weight_cast_to_bf16, weight_cast_to_fp8)
    model = LlamaAdapter.random(
        LlamaConfig(**dict(cfg_kw, num_hidden_layers=1)), seed=seed,
        device=dev)
    paths = model.get_layout().linears
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        stored = {p: weight_cast_to_fp8(get_path(model.blocks[0], p)['w'],
                                        block_size) for p in paths}
        xs_in = {p: torch.randn((M, stored[p][0].shape[1]), generator=gen,
                                device=dev).to(BF16) for p in paths}
        reset_launch_counts()
        outs = {}
        for p in paths:
            codes, scale_inv = stored[p]
            xc, xs = act_quant_per_group(xs_in[p], block_size)
            outs[p] = fp8_block_matmul(xc, xs, codes, scale_inv, block_size)
        counts, xla = read_counts()
        rows = []
        for p in paths:
            codes, scale_inv = stored[p]
            xc, xs = act_quant_per_group(xs_in[p], block_size)
            plain = fp8_block_matmul(xc, xs, codes, scale_inv, block_size,
                                     out_dtype=F32, force_plain=True)
            dense = xs_in[p].to(F32) @ weight_cast_to_bf16(
                codes, scale_inv, block_size).to(F32).T
            rows.append(dict(
                path=p, N=codes.shape[0], K=codes.shape[1],
                finite=bool(torch.isfinite(outs[p]).all()),
                rel_err_vs_plain=_rel(outs[p], plain)[1],
                rel_err_vs_dense_bf16_weight=_rel(outs[p], dense)[1]))
    expect = dict.fromkeys(KERNEL_NAMES, 0)
    expect['fp8_block_gemm'] = len(paths) if dev.type == 'cuda' else 0
    return dict(phase='fp8_linear', width=model.cfg.hidden_size, layers=1,
                M=M, block_size=block_size, linears=rows,
                tolerance_vs_plain=TOL_W4_BF16,
                tolerance_vs_dense=TOL_FP8_LINEAR,
                ok=all(r['finite'] and r['rel_err_vs_plain'] <= TOL_W4_BF16
                       and r['rel_err_vs_dense_bf16_weight'] <= TOL_FP8_LINEAR
                       for r in rows),
                launches=counts, xla_branch_calls=xla, expected_launches=expect)


def _fp8_ingest_model_type():
    """Register (once) the model type of the ``compress`` phase's AWQ run:
    a random Llama whose block linears went through the FP8-block ingest
    in memory: ``weight_cast_to_fp8`` (what such a checkpoint stores) and
    the loader's own ``_ingest_fp8`` (``weight_cast_to_bf16`` with the
    block size taken from the two shapes).  Its norm weights are
    log-normal (sigma ``NORM_SIGMA``, scaled to a mean square of 1, which
    keeps a block's share of the residual stream what it is with norm
    weights of one) instead of ones, so that the inputs
    of the linears have outlier channels as a trained model's do: with
    uniform channels every AWQ ratio gives nearly the same scales, and
    ``search_vs_rtn`` could not tell the best ratio from the worst."""
    from llmc_tpu_torch.models import LlamaAdapter
    from llmc_tpu_torch.models.base import get_path, set_path
    from llmc_tpu_torch.models.hf_loader import _ingest_fp8
    from llmc_tpu_torch.quant import weight_cast_to_fp8
    from llmc_tpu_torch.utils import MODEL_REGISTRY
    name = 'LlamaFp8BlockIngest'
    if name in MODEL_REGISTRY:
        return name

    @MODEL_REGISTRY.register(name=name)
    class LlamaFp8BlockIngest(LlamaAdapter):
        @classmethod
        def from_config(cls, config, device=None):
            model = super().from_config(config, device=device)
            bs = int(config['model'].get('fp8_block_size', 128))
            dev = model.device
            gen = torch.Generator(device=dev).manual_seed(
                int(config['model'].get('seed', 0)) + 1)
            with torch.no_grad():
                for i, blk in enumerate(model.blocks):
                    for p in model.get_layout().linears:
                        lin = get_path(blk, p)
                        codes, scale_inv = weight_cast_to_fp8(lin['w'], bs)
                        w = _ingest_fp8(codes, scale_inv).to(lin['w'].dtype)
                        blk = set_path(blk, p, dict(lin, w=w))
                    for p in ('input_layernorm', 'post_attention_layernorm'):
                        ln = get_path(blk, p)
                        spread = torch.exp(NORM_SIGMA * torch.randn(
                            ln['w'].shape, generator=gen, device=dev))
                        spread = spread / spread.square().mean().sqrt()
                        blk = set_path(blk, p, dict(
                            ln, w=(ln['w'].float() * spread).to(ln['w'].dtype)))
                    model.set_block(i, blk)
            return model
    return name


def compress_config(cfg_kw, method, special=None, fp8_ingest=False,
                    group_size=128, n_samples=8, seq_len=512,
                    eval_tokens=4096, eval_bs=4, seed=0, quant=None,
                    model_type='Llama'):
    """The pipeline config of the ``compress`` phase: a random model of
    ``model_type`` from ``model.arch``, synthetic calibration and PPL data,
    W4 symmetric per-group weights, or ``quant`` (a method config's
    section; a per-group weight takes ``group_size``)."""
    if quant is not None:
        quant = dict(quant, method=method)
        if quant['weight'].get('granularity') == 'per_group':
            quant['weight'] = dict(quant['weight'], group_size=group_size)
    else:
        quant = dict(method=method, weight=dict(
            bit=4, symmetric=True, granularity='per_group',
            group_size=group_size))
    if special:
        quant['special'] = dict(special)
    vocab = cfg_kw['vocab_size']
    return dict(
        base=dict(seed=seed),
        model=dict(type=_fp8_ingest_model_type() if fp8_ingest
                   else model_type,
                   arch=dict(cfg_kw), seed=seed),
        calib=dict(name='synthetic', n_samples=n_samples, bs=-1,
                   seq_len=seq_len, seed=seed, vocab_size=vocab),
        eval=dict(name='synthetic', num_tokens=eval_tokens, seq_len=seq_len,
                  vocab_size=vocab, bs=eval_bs,
                  eval_pos=['pretrain', 'transformed', 'fake_quant']),
        quant=quant)


NORM_SIGMA = 1.0
# The calibration set of the repository's AWQ config: 128 samples of 512
# tokens.  The 32-layer runs take 8 samples to stay inside the script's
# time limit.
AWQ_SOURCE = 'configs/quantization/methods/awq_w_only.yml'
AWQ_SOURCE_SAMPLES = 128
AWQ_SPECIAL = dict(trans=True, weight_clip=True, clip_version='v1')
# AWQ with clipping takes 1.47-1.6 s a Llama-2-7B block at 8 x 512
# tokens: 4 of the 32 layers (32 before phase 18 took its 200 s, 16
# before phase 19 took its 65 s, 8 before phase 20)
AWQ_LAYERS = 4


def search_vs_rtn(dev, config, res, blocks):
    """What the search bought, measured outside the algorithm.  The model
    of ``config`` is built again from its seed (the weights before the
    search), the calibration batches walk through its unquantized blocks
    as they did in the block loop, and at each of ``blocks`` the squared
    error of the fake-quantized output against the unquantized block's is
    taken twice on those inputs: with the original weights (RTN) and with
    the weights the search left in ``res['model']``."""
    from llmc_tpu_torch.data import CalibDataset
    from llmc_tpu_torch.models import build_model
    model, opt = res['model'], res['opt']
    orig = build_model(config, device=dev)
    batches, _ = CalibDataset(config['calib'],
                              orig.tokenizer).get_calib_dataset()
    xs, kws = orig.collect_first_block_input(batches)
    block_fn = orig.block_fn()
    rows = []
    with torch.no_grad():
        for i in range(max(blocks) + 1):
            outs = [block_fn(orig.blocks[i], x, kw)[0]
                    for x, kw in zip(xs, kws)]
            if i in blocks:
                qmap = opt.fake_quant_qmap(i)
                n = sum(y.numel() for y in outs)
                mse = {name: sum(float(
                    ((block_fn(blk, x, kw, qmap=qmap)[0].float()
                      - y.float()) ** 2).sum())
                    for x, kw, y in zip(xs, kws, outs)) / n
                    for name, blk in (('rtn', orig.blocks[i]),
                                      ('searched', model.blocks[i]))}
                rows.append(dict(block=i, mse_rtn=mse['rtn'],
                                 mse_searched=mse['searched'],
                                 searched_over_rtn=mse['searched']
                                 / mse['rtn']))
            xs = outs
    return rows


@contextlib.contextmanager
def timed_hadamard(dev):
    """Seconds and calls of the online rotation (``pre_had_apply``) inside
    the block, each call synchronised on both sides."""
    from llmc_tpu_torch.ops import hadamard
    inner, acc = hadamard.pre_had_apply, dict(s=0.0, calls=0)

    def timed(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        _sync(dev)
        acc['s'] += time.perf_counter() - t0
        acc['calls'] += 1
        return out
    hadamard.pre_had_apply = timed
    try:
        yield acc
    finally:
        hadamard.pre_had_apply = inner


def hadamard_share(dev, config, res):
    """The fake-quant eval once more, the online rotation's torch ops
    timed: their seconds, calls and share of the eval's wall time."""
    from llmc_tpu_torch.eval.orchestrate import EvalOrchestrator
    model = res['model']
    orch = EvalOrchestrator(config, model)
    with timed_hadamard(dev) as acc:
        _sync(dev)
        t0 = time.perf_counter()
        ppl = orch.run('fake_quant', model, qmap=model.qmap)
        _sync(dev)
        wall = time.perf_counter() - t0
    return dict(eval_fake_quant_s=wall, hadamard_s=acc['s'],
                hadamard_calls=acc['calls'],
                hadamard_share=acc['s'] / wall,
                ppl_fake_quant_again=ppl['ppl_fake_quant'])


def phase_compress(dev, cfg_kw, method, special=None, fp8_ingest=False,
                   quant=None, equivalence=None, **sizes):
    """``run_pipeline`` (build, pretrain eval, calibration data, block
    loop, transformed eval, fake-quant eval) on ``dev``; after a method
    that searches (``special`` given), ``search_vs_rtn`` at the first, the
    middle and the last block.  ``quant``: a method config's section
    instead of the W4 default; GPTQ's column loop and QuaRot's online
    rotation get their shares of the time.  Returns the phase record and
    the pipeline's result (the compressed model and its algorithm
    object)."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    config = compress_config(cfg_kw, method, special, fp8_ingest,
                             quant=quant, **sizes)
    reset_launch_counts()
    res = run_pipeline(config, device=dev)
    counts, xla = read_counts()
    ppl = {k: res[k] for k in ('ppl_pretrain', 'ppl_transformed',
                               'ppl_fake_quant')}
    drift = abs(ppl['ppl_transformed'] - ppl['ppl_pretrain']) \
        / ppl['ppl_pretrain']
    times = res['phase_times']
    calib = times[f'calib_{method}']
    L = cfg_kw['num_hidden_layers']
    searched = search_vs_rtn(dev, config, res, sorted({0, L // 2, L - 1})) \
        if special else []
    # GPTQ's (and SpQR's) 'transformed' model holds its compensated
    # weights, TesseraQ's
    # its merged rounding: no equivalence to hold them to.  NormTweaking's
    # holds its trained norms, which change the function only where one
    # moved in the block's type: at the shipped rate none does, and the
    # transformed model is then the pretrained one
    moved = getattr(res['opt'], 'train_stats', {}).get('norms_moved')
    if equivalence is None:
        equivalence = method not in ('GPTQ', 'SpQR', 'TesseraQ') \
            and not moved
    rec = dict(phase='compress', method=method,
               special=config['quant'].get('special', {}),
               fp8_block_ingest=fp8_ingest, layers=L,
               width=cfg_kw['hidden_size'],
               intermediate=cfg_kw.get('intermediate_size',
                                       cfg_kw.get('ffn_dim')),
               dtype=cfg_kw['dtype'],
               calib=config['calib'], eval=config['eval'],
               weight=config['quant']['weight'],
               act=config['quant'].get('act'), **ppl,
               ppl_transformed_rel_drift=drift,
               tolerance_ppl_transformed=(TOL_PPL_TRANSFORMED if equivalence
                                          else None),
               block_output_mse=searched,
               tolerance_searched_over_rtn=TOL_SEARCH_VS_RTN,
               phase_times_s=times, block_loop_s_per_block=calib / L,
               wall_s=res['wall_s'], launches=counts, xla_branch_calls=xla,
               ok=bool(all(np.isfinite(v) for v in ppl.values())
                       and (drift <= TOL_PPL_TRANSFORMED or not equivalence)
                       and all(r['searched_over_rtn'] <= TOL_SEARCH_VS_RTN
                               for r in searched)))
    rec['hyperparams'] = res['opt'].hyperparams()
    if moved is not None:
        rec['norms_moved'] = moved
    train = getattr(res['opt'], 'train_stats', None)
    if train is not None:
        # a trained block errs no more than before its training
        rec.update(train_record(train, calib))
        rec['ok'] = rec['ok'] and all(r['after'] <= r['before']
                                      for r in rec['block_loss'])
    stats = getattr(res['opt'], 'loop_stats', None)
    if stats is not None:
        rec.update(column_loop_s=stats['column_loop_s'],
                   column_steps=stats['columns'],
                   column_loop_share_of_block_loop=stats['column_loop_s']
                   / calib)
    if getattr(res['opt'], 'online_rotate', False):
        rec.update(hadamard_share(dev, config, res))
    return rec, res


def train_record(train, calib_s):
    """The training loop of a gradient-trained method: its steps, seconds,
    milliseconds a step and share of the block loop, and the block loss
    (the MSE of the block's output against the fp block's on the
    calibration batches) before and after training at the first, the
    middle and the last block."""
    blocks = sorted(train['block_loss'])
    steps = train['steps']
    picked = sorted({blocks[0], blocks[len(blocks) // 2], blocks[-1]}) \
        if blocks else []
    return dict(
        train_steps=steps, train_steps_per_block=steps / max(len(blocks), 1),
        train_s=train['train_s'],
        train_ms_per_step=1e3 * train['train_s'] / steps if steps else None,
        train_share_of_block_loop=train['train_s'] / calib_s,
        block_loss=[dict(block=b, before=train['block_loss'][b][0],
                         after=train['block_loss'][b][1]) for b in picked])


def packed_weights(model, opt, wspec):
    """For each linear (block, path, its params), after the method's
    deploy and before packing: (the weight packing will hold, its codes
    dequantized in f32; the weight the method's fake-quant model runs;
    the step of each packed group), grouped as ``wspec`` groups, and
    whether packing reads the qparams its method stored."""
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.quant.quantizer import (fake_quant_weight,
                                                fake_quant_weight_masked,
                                                quant_dequant,
                                                reshape_tensor)
    from llmc_tpu_torch.serve.packed import packed_grid, stored_grid
    for b in range(model.n_blocks):
        for p in model.get_layout().linears:
            lin = get_path(model.blocks[b], p)
            qc = opt.fake_quant_qcfg(b, p)
            if qc is None or qc.w_spec is None or qc.w_baked:
                own = lin['w']
            elif qc.mixed_cols:     # QUIK: its fp columns stay fp
                own = fake_quant_weight_masked(qc.w_spec, lin['w'],
                                               lin['int_mask'])
            else:
                own = fake_quant_weight(qc.w_spec, lin['w'],
                                        lin.get('clip_up'),
                                        lin.get('clip_low'))
            qp = packed_grid(lin, wspec)
            held = quant_dequant(wspec, reshape_tensor(wspec, lin['w']), qp)
            yield b, p, lin, held, reshape_tensor(wspec, own.float()), \
                qp.scales, stored_grid(lin, wspec) is not None


# An element that packing puts farther from the method's fake-quant weight
# than the latter's rounding to bf16 (at most 2^-9 of it; 2^-8 allowed)
# by more than this share of a step is off the method's grid
GRID_MOVE = 0.05
# the largest such excess of an element packed from the qparams its method
# stored (GPTQ, TesseraQ, HQQ): the rounding of a float zero (HQQ's) moves
# one by at most half a step
STORED_MOVE = 0.5 + GRID_MOVE


def packed_weight_gap(model, opt, wspec):
    """How far packing puts each weight element from the method's
    fake-quant model, in steps beyond the bf16 rounding of the latter: the
    linears with an element off the method's grid (by more than
    ``GRID_MOVE``; B1 and B4 read a scale per output channel and group of
    consecutive columns on integer codes, so AdaDim's input-channel
    scales, GPTQ's act-order groups, the elements HQQ's float zeros
    clip, SpQR's fp outliers and QUIK's fp columns are off it), and the
    record: their share, the share of elements moved, the largest excess,
    and the largest among the linears packed from the qparams their method
    stored, SpQR's outliers and QUIK's fp columns (kept fp by design) left
    out of it."""
    from llmc_tpu_torch.quant.quantizer import reshape_tensor
    n = moved = 0
    worst = worst_stored = 0.0
    off = []
    for b, p, lin, held, own, sc, stored in packed_weights(model, opt,
                                                            wspec):
        excess = ((held - own).abs() - own.abs() * 2.0 ** -8) / sc
        m = int((excess > GRID_MOVE).sum())
        n += excess.numel()
        moved += m
        if m:
            off.append((b, p))
        worst = max(worst, float(excess.max()))
        if stored:
            if 'spqr_mask' in lin:
                excess = excess[reshape_tensor(wspec, lin['spqr_mask']) == 0]
            if 'int_mask' in lin:
                excess = excess[reshape_tensor(wspec, lin['int_mask'].expand(
                    lin['w'].shape).float()) == 1]
            worst_stored = max(worst_stored, float(excess.max()))
    n_lin = model.n_blocks * len(model.get_layout().linears)
    return off, dict(off_grid_share=len(off) / n_lin,
                     share_moved=moved / n, max_excess_steps=worst,
                     max_excess_steps_stored_qparams=worst_stored)


def packed_grid_params(model, opt, wspec):
    """The params with every block linear's weight replaced by the one
    packing will hold, dequantized (in the block's type)."""
    from llmc_tpu_torch.models.base import set_path
    from llmc_tpu_torch.quant.quantizer import restore_tensor
    blocks = list(model.blocks)
    for b, p, lin, held, _, _, _ in packed_weights(model, opt, wspec):
        w = restore_tensor(wspec, held, lin['w'].shape).to(lin['w'].dtype)
        blocks[b] = set_path(blocks[b], p, dict(lin, w=w))
    return dict(model.params, blocks=blocks)


def phase_compress_serve(dev, res, prompt_len=32, seed=0, mode='w4a16',
                         **serve_kw):
    """Serve what the pipeline compressed: ``pack_model`` (fused, packed
    head, the method's ``a_spec``) on the result's model ->
    ``ServingEngine`` with an int8 KV cache, ``mode`` the serving path the
    launches are counted on ('w8a16' for 8-bit weights).  Before the engine
    runs, the packed model's logits on one prompt are held against the
    method's own fake-quant model: the QMap of its ``deploy('fake_quant')``
    (GPTQ, TesseraQ, HQQ and AdaDim bake their weights there), with the
    head's weight fake-quantized in place onto the grid packing gives it
    (the head's input is not: neither package's packed head reads
    ``a_spec``).  Packing reads the
    qparams GPTQ, TesseraQ and HQQ stored (``packed_grid``).  Where it
    cannot hold the method's grid (``packed_weight_gap``), the packed
    logits are held instead against the same model with the weights
    packing holds, and the gap to the method's own model is recorded
    beside the weights' gap."""
    from llmc_tpu_torch.models.adapter import QMap
    from llmc_tpu_torch.models.base import LinearQcfg
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight_static
    from llmc_tpu_torch.serve import pack_model
    from llmc_tpu_torch.serve.decode import (FP_POLICY, forward_cached,
                                             init_cache)
    from llmc_tpu_torch.serve.packed import packed_grid
    model, opt = res['model'], res['opt']
    cfg = model.cfg
    wspec = opt.wspec
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, prompt_len)), device=dev)

    def prefill_logits(qmap, params=None):
        # the serving forward, for both: it takes the fused layout too
        cache = init_cache(model, 1, prompt_len, device=dev)
        return forward_cached(model.params if params is None else params,
                              cfg, ids, cache, FP_POLICY, qmap)[0].float()

    with torch.no_grad():
        # the head on the grid packing gives it (no method quantizes it)
        head = model.params['lm_head']
        model.params['lm_head'] = dict(head, w=fake_quant_weight_static(
            wspec, head['w'], packed_grid(head, wspec)))
        own = prefill_logits(opt.deploy('fake_quant'))
        off, gap = packed_weight_gap(model, opt, wspec)
        want = own if not off else prefill_logits(
            QMap({p: LinearQcfg(a_spec=opt.aspec)
                  for p in model.get_layout().linears}),
            packed_grid_params(model, opt, wspec))
        # W4A8: B3 quantizes every block linear's input per token itself
        a8 = MODES[mode].a_int8
        qmap = pack_model(model, wspec, a_spec=None if a8 else opt.aspec,
                          fuse=True, head=True, a_int8=a8)
        got = prefill_logits(qmap)
        with plain_linears(w_bf16=True):
            control = prefill_logits(qmap)
    err, rel = _rel(got, want)
    rel_own = _rel(got, own)[1]
    rel_control = _rel(got, control)[1]
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    tol = TOL_COMPRESS_SERVE if opt.aspec is None else TOL_COMPRESS_SERVE_A8
    rec = serve_run(dev, model, qmap, mode=mode, **serve_kw)[0]
    rec.update(phase='compress_serve', method=type(opt).__name__,
               w_spec=dataclasses.asdict(wspec),
               a_spec=dataclasses.asdict(opt.aspec) if opt.aspec else None,
               rel_logit_err_vs_same_function_control=rel_control,
               prompt=prompt_len, held_against=(
                   'the method\'s fake-quant model' if not off else
                   'that model with the weights packing holds'),
               max_abs_logit_err_vs_fake_quant=err,
               rel_logit_err_vs_fake_quant=rel,
               rel_logit_err_vs_method_model=rel_own,
               packed_weight_gap=gap,
               argmax_agreement_vs_fake_quant=agree,
               tolerance_vs_fake_quant=tol,
               ok=bool(torch.isfinite(got).all() and rel <= tol
                       and gap['max_excess_steps_stored_qparams']
                       <= STORED_MOVE))
    return rec


def phase16_compress(dev, name, cfg_kw=LLAMA2_7B, **sizes):
    """``phase_compress`` of one of phase 16's or 17's method configs at
    ``cfg_kw``'s width, at full depth or the depth ``DEPTH_CUT`` sets
    (recorded with its reason), at the config's own group size unless
    ``sizes`` gives one."""
    mq = METHOD_QUANT[name]
    cut = DEPTH_CUT.get(mq['method'])
    if cut is not None:
        cfg_kw = dict(cfg_kw, num_hidden_layers=min(
            cut[0], cfg_kw['num_hidden_layers']))
    sizes.setdefault('group_size', mq['weight'].get('group_size', 128))
    rec, res = phase_compress(dev, cfg_kw, mq['method'], quant=mq, **sizes)
    rec.update(config=f'configs/quantization/methods/{name}.yml',
               depth_cut=None if cut is None else dict(
                   layers=cfg_kw['num_hidden_layers'], reason=cut[1]))
    return rec, res


def method_shares(model):
    """What a phase 17 method keeps fp, before packing: QUIK's share of
    input columns (``int_mask`` False) and SpQR's share of outlier weights
    (``spqr_mask``), over every block linear; None where it keeps none."""
    from llmc_tpu_torch.models.base import get_path
    fp_cols = cols = outliers = weights = 0
    for blk in model.blocks:
        for p in model.get_layout().linears:
            lin = get_path(blk, p)
            if 'int_mask' in lin:
                fp_cols += int((~lin['int_mask']).sum())
                cols += lin['int_mask'].numel()
            if 'spqr_mask' in lin:
                outliers += int(lin['spqr_mask'].sum())
                weights += lin['spqr_mask'].numel()
    return dict(fp_column_share=fp_cols / cols if cols else None,
                outlier_share=outliers / weights if weights else None)


def phase17_method(dev, name, mode, cfg_kw=LLAMA2_7B, serve_kw=None,
                   **sizes):
    """``compress`` and ``compress_serve`` of one of phase 17's method
    configs: the compress record with the share the method keeps fp and,
    for QUIK and DGQ (equivalence transforms), its transformed PPL held to
    the pretrained one within ``TOL_PPL_EQUIV``; then the served record,
    DGQ's weights all on the grid packing reads from its qparams, QUIK's
    int columns on its own grid and its served logits held to QUIK's own
    model within ``TOL_QUIK_VS_OWN``."""
    rec, res = phase16_compress(dev, name, cfg_kw, **sizes)
    method = rec['method']
    rec.update(method_shares(res['model']))
    if method in ('QUIK', 'DGQ'):
        rec['tolerance_ppl_transformed'] = TOL_PPL_EQUIV
        rec['ok'] = rec['ok'] and \
            rec['ppl_transformed_rel_drift'] <= TOL_PPL_EQUIV
    srv = phase_compress_serve(dev, res, mode=mode, **(serve_kw or {}))
    srv.update(config=rec['config'], layers=rec['layers'],
               depth_cut=rec['depth_cut'])
    gap = srv['packed_weight_gap']
    if method == 'DGQ':
        srv['ok'] = srv['ok'] and gap['off_grid_share'] == 0
    if method == 'QUIK':
        # the int columns on QUIK's own grid; the fp columns' gap bounded
        srv['tolerance_vs_method_model'] = TOL_QUIK_VS_OWN
        srv['ok'] = srv['ok'] and \
            gap['max_excess_steps_stored_qparams'] <= GRID_MOVE and \
            srv['rel_logit_err_vs_method_model'] <= TOL_QUIK_VS_OWN
    return rec, srv, res


@contextlib.contextmanager
def decode_positions(dev):
    """Per eval position of the pipeline (``EvalOrchestrator.run``) and
    per ``decode_nll`` call: the kernels launched (the counters set to 0
    just before), the calls that ran the XLA branch, and the decode's
    seconds and fed steps (synchronised on both sides).  Yields the
    dict of rows by position (or by the label ``label[0]`` holds)."""
    from llmc_tpu_torch.eval.orchestrate import EvalOrchestrator
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import decode
    inner_run, inner_nll = EvalOrchestrator.run, decode.decode_nll
    rows, label = {}, ['']

    def run(self, position, model, qmap=None, kv_policy=None):
        label[0] = position
        return inner_run(self, position, model, qmap=qmap,
                         kv_policy=kv_policy)

    def decode_nll(model, ids, *a, **kw):
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        out = inner_nll(model, ids, *a, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts, xla = read_counts()
        row = rows.setdefault(label[0], dict(
            decode_s=0.0, fed_steps=0, launches=dict.fromkeys(counts, 0),
            xla_branch_calls=0))
        fed = np.asarray(ids).shape[1] - (0 if kw.get('labels') is not None
                                          else 1)
        row['decode_s'] += wall
        row['fed_steps'] += fed
        row['launches'] = {k: row['launches'][k] + v
                           for k, v in counts.items()}
        row['xla_branch_calls'] += xla
        row['ms_per_step'] = 1e3 * row['decode_s'] / row['fed_steps']
        return out

    EvalOrchestrator.run, decode.decode_nll = run, decode_nll
    try:
        yield rows, label
    finally:
        EvalOrchestrator.run, decode.decode_nll = inner_run, inner_nll


def decode_ppl_config(cfg_kw, quant, tokens=DECODE_TOKENS, seed=0,
                      n_samples=8, seq_len=512):
    """The pipeline config of ``decode_ppl``: a random model from
    ``model.arch``, synthetic calibration, a PPL entry over ``tokens``
    synthetic tokens at pretrain and fake_quant (token consistency on) and
    a decode-PPL entry over the same tokens at pretrain, fake_quant and
    fake_quant_wo_kv."""
    vocab = cfg_kw['vocab_size']
    data = dict(name='synthetic', vocab_size=vocab, seed=seed,
                num_tokens=tokens, seq_len=tokens)
    return dict(
        base=dict(seed=seed),
        model=dict(type='Llama', arch=dict(cfg_kw), seed=seed),
        calib=dict(name='synthetic', n_samples=n_samples, bs=-1,
                   seq_len=seq_len, seed=seed, vocab_size=vocab),
        eval=[dict(data, bs=1, eval_pos=['pretrain', 'fake_quant'],
                   eval_token_consist=True),
              dict(data, type='decode_ppl', num_samples=1,
                   eval_pos=['pretrain', 'fake_quant', 'fake_quant_wo_kv'])],
        quant=dict(quant))


def phase_decode_ppl(dev, cfg_kw=LLAMA2_7B, layers=DECODE_LAYERS,
                     tokens=DECODE_TOKENS, sink=(4, 64), **sizes):
    """The decode PPL through ``run_pipeline`` (A5): the kvquant_int8
    model (RTN W4 g128 asymmetric, Naive int8 KV) at ``cfg_kw``'s width
    and ``layers[0]`` layers, at pretrain (bf16 fp cache), fake_quant (the
    int8 cache) and fake_quant_wo_kv (the fake-quant model over the fp
    cache): B2 launched once a layer a fed step in each, and the pretrain
    decode PPL equal to the prefill PPL of the same tokens within
    ``TOL_DECODE_VS_PREFILL``.  Then the fake-quant model again over the
    kvquant_kivi KIVI 4-bit cache (its ring of 128 shorter than the
    sequence), over KIVI with a ring as long as the sequence (fp values
    only: its NLL within ``TOL_FLASH`` of the fp cache's, the plain read
    against B2), and over a SinkKV cache (``sink``: sinks, window): no B2
    launch in any of the three.  Token consistency at fake_quant."""
    from llmc_tpu_torch.eval.ppl import DecodePerplexityEval
    from llmc_tpu_torch.eval.orchestrate import load_eval_ids
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.serve.kvcache import KVCachePolicy
    cfg_kw = dict(cfg_kw, num_hidden_layers=min(
        layers[0], cfg_kw['num_hidden_layers']))
    L = cfg_kw['num_hidden_layers']
    config = decode_ppl_config(cfg_kw, METHOD_QUANT['kvquant_int8'], tokens,
                               **sizes)
    kivi_cfg = METHOD_QUANT['kvquant_kivi']['kvcache']
    policies = {
        'kivi': KVCachePolicy(method='kivi', bit=kivi_cfg['bit'],
                              symmetric=kivi_cfg['symmetric']),
        'kivi_ring_whole': KVCachePolicy(method='kivi', bit=kivi_cfg['bit'],
                                         symmetric=kivi_cfg['symmetric'],
                                         residual_length=tokens),
        'sink': KVCachePolicy(method='sink', num_sink_tokens=sink[0],
                              window_length=sink[1])}
    with attn_impl('auto'), decode_positions(dev) as (rows, label):
        res = run_pipeline(config, device=dev)
        model = res['model']
        ev = DecodePerplexityEval(load_eval_ids(config['eval'][1], None),
                                  seq_len=tokens, num_samples=1)
        ppl = {p: res[f'decode_ppl_{p}'] for p in
               ('pretrain', 'fake_quant', 'fake_quant_wo_kv')}
        for name, pol in policies.items():
            label[0] = name
            ppl[name] = ev.eval(model, qmap=model.qmap, kv_policy=pol)
        logits = decode_logits_checks(dev, model, ev.chunks[0],
                                      policies, L)
    fed = tokens - 1
    # B2 once a layer a fed step (a CPU run launches no kernel)
    want_b2 = fed * L if dev.type == 'cuda' else 0
    b2 = {k: r['launches']['flash_decode'] for k, r in rows.items()}
    others = {k: sum(v for n, v in r['launches'].items()
                     if n != 'flash_decode') + r['xla_branch_calls']
              for k, r in rows.items()}
    prefill = res['ppl_pretrain']
    vs_prefill = abs(ppl['pretrain'] - prefill) / prefill
    # the NLL of KIVI's fp ring against the fp cache's (same deploy)
    nll_gap = abs(np.log(ppl['kivi_ring_whole'])
                  - np.log(ppl['fake_quant_wo_kv'])) \
        / np.log(ppl['fake_quant_wo_kv'])
    kv_b2 = ('pretrain', 'fake_quant', 'fake_quant_wo_kv')
    rec = dict(phase='decode_ppl', config='configs/quantization/methods/'
               'kvquant_int8.yml', kivi_config='configs/quantization/'
               'methods/kvquant_kivi.yml', layers=L,
               width=cfg_kw['hidden_size'], dtype=cfg_kw['dtype'],
               depth_cut=dict(layers=L, reason=layers[1]),
               tokens=tokens, fed_steps=fed, attn_impl='auto',
               kv_module=dataclasses.asdict(res['opt'].kv_module),
               policies={k: dataclasses.asdict(v)
                         for k, v in policies.items()},
               decode_ppl=ppl, ppl_prefill_pretrain=prefill,
               ppl_fake_quant=res['ppl_fake_quant'],
               decode_vs_prefill_rel=vs_prefill,
               tolerance_decode_vs_prefill=TOL_DECODE_VS_PREFILL,
               kivi_ring_whole_nll_rel_vs_fp_cache=nll_gap,
               tolerance_kivi_vs_fp_cache=TOL_FLASH,
               token_consistency=res['token_consistency'],
               logits=logits, positions=rows, expected_flash_decode=dict(
                   {k: want_b2 for k in kv_b2},
                   **dict.fromkeys(policies, 0)),
               phase_times_s=res['phase_times'], wall_s=res['wall_s'])
    rec['ok'] = bool(
        all(np.isfinite(v) for v in ppl.values())
        and all(b2.get(k) == want_b2 for k in kv_b2)
        and all(b2.get(k) == 0 for k in policies)
        and all(v == 0 for v in others.values())
        and vs_prefill <= TOL_DECODE_VS_PREFILL
        and nll_gap <= TOL_FLASH and logits['ok'])
    return rec, res


def logits_rel(got, want) -> float:
    """The largest over the steps of |got - want| / |want| (L2 over the
    vocabulary) of two [B, S, V] logits."""
    d = torch.linalg.vector_norm((got - want).double(), dim=-1)
    return float((d / torch.linalg.vector_norm(want.double(), dim=-1)).max())


def decode_logits_checks(dev, model, ids, policies, layers):
    """``decode_logits`` of ``ids`` at the pretrained weights against one
    prefill's logits of the same tokens: over the fp cache through B2
    (launched once a layer a step) within
    ``TOL_DECODE_LOGITS_VS_PREFILL``, and against B2's plain version in
    the same decode within ``TOL_DECODE_LOGITS_B2_PLAIN``; beside them
    KIVI's fp ring (the plain masked read, held to B2 within the prefill
    bound), KIVI as shipped and the Naive int8 cache, and the planted
    faults (a 4-bit Naive cache, the Sink window), each of which must read
    at least twice the prefill bound.  Also the first step alone
    (attention over one position returns its value exactly: the linears'
    gap), and the per-token NLL differences of the fp decode, B2's plain
    version and KIVI's fp ring against the prefill: their mean, spread and
    standard error."""
    from llmc_tpu_torch.eval.ppl import forward_logits
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.ops.flash_decode import flash_decode_plain
    from llmc_tpu_torch.serve import decode
    from llmc_tpu_torch.serve.kvcache import KVCachePolicy
    ids = torch.as_tensor(np.asarray(ids, np.int64)[None], device=dev)
    S = ids.shape[1]
    with torch.no_grad():
        prefill = forward_logits(model, ids).float()

    def run(policy, plain=False):
        old = decode._DECODE_KERNELS['auto']
        if plain:
            decode._DECODE_KERNELS['auto'] = flash_decode_plain
        reset_launch_counts()
        try:
            out = decode.decode_logits(model, ids, kv_policy=policy,
                                       device=dev)
        finally:
            decode._DECODE_KERNELS['auto'] = old
        counts, xla = read_counts()
        return out, counts['flash_decode'], sum(counts.values()) + xla

    fp, b2_fp, all_fp = run(KVCachePolicy(method='fp'))
    plain, b2_plain, all_plain = run(KVCachePolicy(method='fp'), plain=True)
    reads = {k: run(policies[k])[0] for k in ('kivi_ring_whole', 'kivi')}
    reads['naive_int8'] = run(KVCachePolicy(method='naive', bit=8))[0]
    faults = {'naive_4bit': run(KVCachePolicy(method='naive', bit=4))[0],
              'sink_window': run(policies['sink'])[0]}
    # per-token NLL of the next token, each decode against the prefill
    tgt = ids[:, 1:, None]

    def nll(lg):
        return -torch.gather(torch.log_softmax(lg[:, :-1].double(), -1), -1,
                             tgt)[..., 0].flatten()
    gaps = {}
    for k, lg in (('fp', fp), ('b2_plain', plain),
                  ('kivi_ring_whole', reads['kivi_ring_whole'])):
        d = (nll(lg) - nll(prefill)).cpu().numpy()
        gaps[k] = dict(mean=float(d.mean()), std=float(d.std()),
                       stderr=float(d.std() / np.sqrt(d.size)))
    want_b2 = S * layers if dev.type == 'cuda' else 0
    rec = dict(
        steps=S, fp_vs_prefill=logits_rel(fp, prefill),
        first_step_fp_vs_prefill=logits_rel(fp[:, :1], prefill[:, :1]),
        fp_vs_b2_plain=logits_rel(fp, plain),
        b2_plain_vs_prefill=logits_rel(plain, prefill),
        reads_vs_prefill={k: logits_rel(v, prefill)
                          for k, v in reads.items()},
        kivi_ring_whole_vs_fp=logits_rel(reads['kivi_ring_whole'], fp),
        faults_vs_prefill={k: logits_rel(v, prefill)
                           for k, v in faults.items()},
        nll_gap_vs_prefill=gaps,
        flash_decode_fp=b2_fp, launches_plain=all_plain,
        expected_flash_decode_fp=want_b2,
        tolerance_vs_prefill=TOL_DECODE_LOGITS_VS_PREFILL,
        tolerance_b2_plain=TOL_DECODE_LOGITS_B2_PLAIN)
    rec['ok'] = bool(
        rec['fp_vs_prefill'] <= TOL_DECODE_LOGITS_VS_PREFILL
        and rec['fp_vs_b2_plain'] <= TOL_DECODE_LOGITS_B2_PLAIN
        and rec['kivi_ring_whole_vs_fp'] <= TOL_DECODE_LOGITS_VS_PREFILL
        and min(rec['faults_vs_prefill'].values())
        >= 2 * TOL_DECODE_LOGITS_VS_PREFILL
        and b2_fp == all_fp == want_b2 and all_plain == 0)
    return rec


# --------------------------------------------------------------------------

# Phase 18: the MoE and MLA families at their published widths (each
# source's config.json), bf16 random weights from a seed, served unpacked
# (the reference cannot serve a packed MoE, ROADMAP C) through the engine's
# captured decode step and compressed through run_pipeline.  The experts
# dispatch densely, as in the reference: every expert's weights are read
# at every step.  Each depth cut is listed with its reason.
MIXTRAL_8X7B = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    head_dim=128, rope_theta=1e6, rms_norm_eps=1e-5,
                    max_position_embeddings=32768, num_local_experts=8,
                    num_experts_per_tok=2, dtype='bfloat16')
# Qwen1.5-MoE-A2.7B: the port's intermediate_size is the experts'
# (moe_intermediate_size 1408), as Qwen2MoeConfig.from_hf sets it
QWEN15_MOE_A27B = dict(vocab_size=151936, hidden_size=2048,
                       intermediate_size=1408,
                       shared_expert_intermediate_size=5632,
                       num_hidden_layers=24, num_attention_heads=16,
                       num_key_value_heads=16, head_dim=128, rope_theta=1e6,
                       rms_norm_eps=1e-6, max_position_embeddings=8192,
                       num_local_experts=60, num_experts_per_tok=4,
                       norm_topk_prob=False, dtype='bfloat16')
DEEPSEEK_V2_LITE = dict(vocab_size=102400, hidden_size=2048,
                        intermediate_size=10944, moe_intermediate_size=1408,
                        num_hidden_layers=27, num_attention_heads=16,
                        q_lora_rank=None, kv_lora_rank=512,
                        qk_nope_head_dim=128, qk_rope_head_dim=64,
                        v_head_dim=128, n_routed_experts=64,
                        n_shared_experts=2, num_experts_per_tok=6,
                        routed_scaling_factor=1.0, norm_topk_prob=False,
                        first_k_dense_replace=1, moe_layer_freq=1,
                        rms_norm_eps=1e-6, rope_theta=10000.0,
                        dtype='bfloat16')
# phase 18's share of the script's time limit went to phase 20: its two
# deepest models are cut to the 4 layers its decode checks read (24 and 27
# layers took 179.8 s with Mixtral's 4 on an H100 at 700 W, 8 and 9 took
# 118.9 s); a layer repeats the first MoE layer's shapes
PHASE18_CUT = ('cut to pay for phase 20\'s time: every layer '
               'repeats the first MoE layer\'s shapes')
MOE_MODELS = {
    'mixtral_8x7b': dict(
        type='Mixtral', arch=MIXTRAL_8X7B,
        source='mistralai/Mixtral-8x7B-v0.1 config.json',
        layers=(4, 'the 8 experts are 2.82 GB of bf16 a layer: 32 layers '
                   'are about 93 GB, over the 80 GB card'),
        attn=('auto', 'batch'), reduced=[]),
    'qwen15_moe_a27b': dict(
        type='Qwen2Moe', arch=QWEN15_MOE_A27B,
        source='Qwen/Qwen1.5-MoE-A2.7B config.json',
        layers=(4, PHASE18_CUT), attn=('batch',), reduced=[]),
    'deepseek_v2_lite': dict(
        type='DeepseekV2', arch=DEEPSEEK_V2_LITE,
        source='deepseek-ai/DeepSeek-V2-Lite config.json',
        layers=(4, PHASE18_CUT), attn=(None,),
        reduced=['rope_scaling (yarn, factor 40) left out: the reference '
                 'computes DeepSeek\'s rope unscaled and the port refuses a '
                 'yarn config (ROADMAP C)']),
}
# what each family's compression runs: (name, quant, layers, reason of the
# cut, the transform an equivalence); the quant sections as the shipped
# configs hold them
MIXTRAL_GPTQ_QUANT = dict(
    method='GPTQ', weight=dict(bit=4, symmetric=True,
                               granularity='per_group', group_size=128),
    special=dict(actorder=True, static_groups=True, percdamp=0.01,
                 blocksize=128, true_sequential=True, quant_out=True))
DSV3_AWQ_QUANT = dict(
    method='Awq', weight=dict(bit=4, symmetric=False,
                              granularity='per_group', group_size=128),
    special=dict(trans=True, trans_version='v2', weight_clip=True))
RTN_W4 = dict(method='RTN', weight=dict(bit=4, symmetric=True,
                                        granularity='per_group',
                                        group_size=128))
MOE_COMPRESS = {
    'mixtral_8x7b': [
        ('rtn_w4', RTN_W4, 4, None, True),
        ('configs/quantization/models/mixtral_gptq_w4.yml',
         MIXTRAL_GPTQ_QUANT, 1,
         'GPTQ\'s column loop (a Python loop of torch ops): 196608 columns '
         'a Mixtral block, 5.5 times a Llama-2-7B block\'s (GPTQ_LAYERS '
         'cuts those to 2), about 37 s a block', False)],
    'qwen15_moe_a27b': [('rtn_w4', RTN_W4, 4, PHASE18_CUT, True)],
    'deepseek_v2_lite': [
        ('rtn_w4', RTN_W4, 4, PHASE18_CUT, True),
        # the router reads the post-attention norm that moe_gu scales:
        # AWQ on DeepSeek moves the routing (no equivalence, ROADMAP C)
        ('configs/quantization/deepseekv3/awq_w_only_dsv3.yml',
         DSV3_AWQ_QUANT, 1,
         'one MoE block (its moe_gu subset searches one scale over 130 '
         'linears; each expert\'s down_proj and every clip are searched '
         'apart); the dense first block left out (first_k_dense_replace '
         '0): its down_proj\'s 10944 inputs are no whole number of '
         '128-groups, where the clip search raises in the reference and '
         'in the port (auto_clip.py\'s reshape into groups)', False)],
}
# the architecture each compression of MOE_COMPRESS runs, where it is not
# the family's served one
MOE_COMPRESS_ARCH = {
    'configs/quantization/deepseekv3/awq_w_only_dsv3.yml':
        dict(first_k_dense_replace=0)}
# phase 18's decode held to one prefill of the same tokens (the relative
# L2 gap of the logits, as TOL_DECODE_LOGITS_VS_PREFILL), on each model's
# first 4 blocks (DeepSeek's dense one and three MoE ones) at its widths,
# 32 tokens, on the steps every router picked as in the prefill: bf16
# roundings that fall otherwise between a one-token step and a 32-token
# forward, and the int8 cache's rounding.  Set from an H100 reading: fp
# 7.7e-3 / 7.9e-3 / 8.2e-3 (Mixtral / Qwen1.5-MoE / DeepSeek-V2-Lite),
# int8 1.27e-2 / 1.37e-2 / 1.38e-2 (the latent one on DeepSeek); the
# planted 4-bit cache 0.18 / 0.17 / 0.20, which must stay at least twice
# the bound.
TOL_MOE_DECODE_VS_PREFILL = 2.5e-2
MOE_DECODE_CHECK = dict(layers=4, steps=32)
# the share of those steps that may route otherwise than the prefill in
# some layer (a bf16 router's near-ties).  The same reading: 0-2 of 32 on
# Mixtral and Qwen1.5-MoE, 7-8 on DeepSeek-V2-Lite (three routers of 6 of
# 64 a step); the 4-bit cache 13, 30 and 31.
MOE_DECODE_ROUTED_APART = 0.5
# the engine's serving shape of phases 18 and 19: the serve phase's, each
# request asking for 8 to 16 tokens (its 16 to 32 took 43 steps, whose
# eager run is 0.55 s a step on Qwen2-MoE and DeepSeek)
MOE_SERVE = dict(n_requests=10, max_batch=8, max_len=256,
                 buckets=(32, 64, 128, 256), max_prompt=200, new_tokens=8)


def adapter_serve_run(dev, model, attn, eager=False, n_requests=10,
                      max_batch=8, max_len=256, buckets=(32, 64, 128, 256),
                      max_prompt=200, new_tokens=16, kv_policy=None,
                      qmap=None, fixed=False):
    """``ServingEngine.run`` (or the eager engine's) over ``serve_requests``
    under ``ATTN_IMPL = attn``, over an int8 cache by default: (the record
    with the launches the path implies, ``serve_expected_launches``, the
    requests' tokens).  ``qmap``: a packed model's serving QMap (phase 19's
    families); without one (phase 18's MoE and MLA models) every linear is
    a torch matmul."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      ServingEngine)
    cfg = model.cfg
    policy = kv_policy or KVCachePolicy(method='naive', bit=8)
    with attn_impl(attn or 'auto'):
        eng = (EagerServingEngine if eager else ServingEngine)(
            model, qmap=qmap, max_batch=max_batch, max_len=max_len,
            prefill_buckets=buckets, kv_policy=policy, device=dev)
        reqs = serve_requests(n_requests, cfg.vocab_size, max_prompt,
                              new_tokens=new_tokens, fixed=fixed)
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        eng.run(reqs)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts, xla = read_counts()
    host_steps = host_decode_steps(eng)
    graphs = eng._graphs.values()
    rec = dict(attn=attn, eager=eager, graphed=eng.graphed, mla=eng.mla,
               requests=len(reqs), tokens=sum(len(r.output_ids)
                                              for r in reqs),
               wall_s=wall, **eng.stats, host_decode_steps=host_steps,
               graph_replays=sum(g.replays for g in graphs),
               first_run_s=sum(g.first_s for g in graphs),
               capture_s=sum(g.capture_s for g in graphs),
               launches=counts, xla_branch_calls=xla,
               kv_cache=policy.method,
               expected_launches=serve_expected_launches(
                   cfg, eng.stats['prefill_forwards'] + host_steps,
                   host_steps, attn, packed=qmap is not None, mla=eng.mla,
                   policy=policy),
               all_done=all(r.done and len(r.output_ids) == r.max_new_tokens
                            and all(0 <= t < cfg.vocab_size
                                    for t in r.output_ids) for r in reqs))
    return rec, [list(r.output_ids) for r in reqs]


def serve_expected_launches(cfg, forwards, decode_steps, attn, packed=True,
                            mla=False, policy=None):
    """A packed model's forward: 4 packed linears a layer (fused q/k/v,
    o, fused gate/up or a non-gated MLP's up, down) and the packed head
    through B1.  A decode step: B2 (``auto``) or B5 (``batch``) once a
    layer on a per-head cache where the reference's attn_ok lets a
    kernel take it (the graph's and the ``policy``'s: none on SinkKV's);
    none on the latent cache, whose read is torch ops as the reference's
    is XLA."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    L_ = cfg.num_hidden_layers
    if packed:
        n['w4_dequant_matmul'] = (4 * L_ + 1) * forwards
    if not mla and attention_kernel_takes(cfg, policy):
        n['batch_decode' if attn == 'batch' else 'flash_decode'] = \
            L_ * decode_steps
    return n


def moe_step_times(dev, model, attn, kv_policy=None, B=8, prompt=128,
                   steps=4, max_len=256, qmap=None):
    """TTFT and the decode step, captured and eager: an idle engine admits
    one prompt of ``prompt`` tokens (after one warm-up admission), timed to
    its first token (its prefill); then ``B`` slots decode ``steps``
    steps, each synchronised, through the captured step (its capture
    before the timing) and through the eager step.  tok/s = B tokens a
    step.  ``qmap``: a packed model's serving QMap."""
    from llmc_tpu_torch.serve import (EagerServingEngine, KVCachePolicy,
                                      Request, ServingEngine)
    policy = kv_policy or KVCachePolicy(method='naive', bit=8)
    rng = np.random.RandomState(1)
    out = {}
    for name, cls in (('graph', ServingEngine), ('eager',
                                                 EagerServingEngine)):
        with attn_impl(attn or 'auto'):
            eng = cls(model, qmap=qmap, max_batch=B, max_len=max_len,
                      prefill_buckets=(32, 64, 128, 256), kv_policy=policy,
                      device=dev)
            for i in range(B):
                eng.submit(Request(uid=i, prompt_ids=rng.randint(
                    0, model.cfg.vocab_size, (prompt,)),
                    max_new_tokens=max_len))
                if i < 2:     # one warm-up admission, then the timed one
                    _sync(dev)
                    t0 = time.perf_counter()
                    eng._admit()
                    _sync(dev)
                    ttft = time.perf_counter() - t0
            eng._admit()
            eng._decode(1)    # the captured step's eager run and capture
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(steps):
                eng._decode(1)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3 / steps
        out[name] = dict(step_ms=ms, tok_s=B * 1e3 / ms, ttft_s=ttft)
    return out


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def moe_step_bound(model, peaks, B=8) -> dict:
    """The decode step's byte bound at ``B`` tokens a step: every weight
    of every block and the head read once, but of each MoE block's routed
    experts only those the step's tokens pick, at most min(E, B k) of the
    E (``step_bound_ms``), and E (1 - (1 - k / E)^B) of them where each
    token picks k at random (``expected_coverage_bound_ms``).  Dense
    dispatch, which the port runs as the reference does, reads every
    expert (``dense_dispatch_bound_ms``).  The embedding is gathered, a
    row a token."""
    cfg = model.cfg
    E = getattr(cfg, 'num_local_experts', None) or cfg.n_routed_experts
    k = cfg.num_experts_per_tok
    p = model.params
    dense = param_bytes(p['blocks']) + param_bytes(p['lm_head'])
    routed = sum(param_bytes(mlp['experts']) for bp in p['blocks']
                 for mlp in bp.values()
                 if isinstance(mlp, dict) and 'experts' in mlp)
    most = dense - routed + routed * min(E, B * k) / E
    expected = dense - routed + routed * (1 - (1 - k / E) ** B)
    return dict(dense_dispatch_bytes=dense,
                dense_dispatch_bound_ms=dense / peaks.bw * 1e3,
                routed_expert_bytes=routed, weight_bytes_bound=most,
                step_bound_ms=most / peaks.bw * 1e3,
                expected_coverage_bytes=expected,
                expected_coverage_bound_ms=expected / peaks.bw * 1e3,
                bound_batch=B, bound_by='bytes')


def shallow(model, layers):
    """The model's first ``layers`` blocks at its widths, sharing its
    tensors."""
    cfg = dataclasses.replace(model.cfg, num_hidden_layers=layers)
    return type(model)(cfg, dict(model.params,
                                 blocks=model.params['blocks'][:layers]))


def moe_decode_logits(model, ids, dev, policy):
    """The f32 logits [B, S, V] of ``ids`` fed one token a step through
    the cache the engine builds under ``policy``: the per-head cache (B2
    at S == 1 under ``auto``), or on an MLA model the latent cache (fp,
    or the codes at the policy's bit under ``naive``)."""
    from llmc_tpu_torch.serve import decode
    if getattr(model.cfg, 'kv_lora_rank', None) is None:
        return decode.decode_logits(model, ids, kv_policy=policy, device=dev)
    from llmc_tpu_torch.serve.mla_decode import (init_mla_cache,
                                                 mla_forward_cached)
    bit = policy.bit if policy.method == 'naive' else None
    cache = init_mla_cache(model.cfg, ids.shape[0], ids.shape[1],
                           quant_bit=bit, device=dev)
    rows = []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            lg, cache = mla_forward_cached(model.params, model.cfg,
                                           ids[:, t:t + 1], cache,
                                           latent_bit=int(policy.bit))
            rows.append(lg[:, 0].float())
    return torch.stack(rows, 1)


@contextlib.contextmanager
def routed_sets():
    """Records the top-k set each MoE router call picks: a list over the
    calls of [tokens, k] sorted index tensors on the host."""
    from llmc_tpu_torch.models import deepseek, mixtral, qwen2moe
    picks = []
    mods = (mixtral, qwen2moe, deepseek)
    inner = [m.top_k for m in mods]

    def record(x, k, fn=inner[0]):
        v, i = fn(x, k)
        picks.append(torch.sort(i.reshape(-1, k), -1).values.cpu())
        return v, i
    for m, fn in zip(mods, inner):
        m.top_k = functools.partial(record, fn=fn)
    try:
        yield picks
    finally:
        for m, fn in zip(mods, inner):
            m.top_k = fn


def same_routing(prefill_picks, decode_picks, steps) -> torch.Tensor:
    """[steps] bool: whether the decode step picked, in every MoE layer,
    the set the prefill picked for that token (the prefill calls each
    router once over every token, the decode once a step)."""
    n = len(prefill_picks)
    assert len(decode_picks) == n * steps, (n, len(decode_picks))
    same = torch.ones(steps, dtype=torch.bool)
    for t in range(steps):
        for l_, want in enumerate(prefill_picks):
            same[t] &= bool((decode_picks[t * n + l_][0] == want[t]).all())
    return same


def moe_decode_checks(dev, model, layers=MOE_DECODE_CHECK['layers'],
                      steps=MOE_DECODE_CHECK['steps'], seed=0, fault_bit=4,
                      record_bits=()):
    """The decode of ``steps`` random tokens over the fp and the int8 cache
    (per-head, or latent on DeepSeek) against one prefill of the same
    tokens, on the model's first ``layers`` blocks.  A bf16 router's
    near-ties may fall otherwise between a one-token step and the
    prefill, and a token routed otherwise gets other experts: the steps
    whose top-k sets differ from the prefill's in some layer are counted
    (at most ``MOE_DECODE_ROUTED_APART`` of them), and the others' logits
    held within ``TOL_MOE_DECODE_VS_PREFILL``.  A planted fault (the cache
    at ``fault_bit`` bits, 4 by default) must be at least twice that off on
    the steps it routes as the prefill does (inf where none does); the
    caches at ``record_bits`` bits are read beside it, unchecked.  The
    first step alone (attention over one position returns its value)
    shows the linears' and the router's gap.  Under ``auto`` the per-head
    reads launch B2 once a layer a step where the reference's attn_ok
    lets a kernel take it, the latent read and a dense family's plain read
    (ALiBi, softcap, window) nothing; a dense model has no router, and no
    step routes apart."""
    from llmc_tpu_torch.eval.ppl import forward_logits
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve.kvcache import KVCachePolicy
    m = shallow(model, min(layers, model.cfg.num_hidden_layers))
    L = m.cfg.num_hidden_layers
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, m.cfg.vocab_size, (1, steps)), device=dev)
    with torch.no_grad(), routed_sets() as want_picks:
        prefill = forward_logits(m, ids).float()
    mla = getattr(m.cfg, 'kv_lora_rank', None) is not None
    per_step = (0 if mla or dev.type != 'cuda'
                or not attention_kernel_takes(m.cfg) else L)
    runs = {}
    policies = [('fp', KVCachePolicy(method='fp')),
                ('int8', KVCachePolicy(method='naive', bit=8))]
    policies += [(f'int{b}', KVCachePolicy(method='naive', bit=b))
                 for b in (fault_bit,) + tuple(record_bits)]
    with attn_impl('auto'):
        for name, policy in policies:
            reset_launch_counts()
            with routed_sets() as picks:
                lg = moe_decode_logits(m, ids, dev, policy)
            _sync(dev)
            counts, xla = read_counts()
            runs[name] = (lg, same_routing(want_picks, picks, steps),
                          dict(counts, xla_branch_calls=xla))
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want['flash_decode'] = per_step * steps
    want['xla_branch_calls'] = 0

    def gap(name):
        lg, same, _ = runs[name]
        keep = same.nonzero()[:, 0].to(dev)
        return (logits_rel(lg[:, keep], prefill[:, keep]) if len(keep)
                else float('inf'))
    reads, faults = ('fp', 'int8'), (f'int{fault_bit}',)
    recorded = tuple(f'int{b}' for b in record_bits)
    rec = dict(
        layers=L, steps=steps, cache='latent' if mla else 'per-head',
        vs_prefill={k: gap(k) for k in reads},
        first_step_vs_prefill={k: logits_rel(runs[k][0][:, :1],
                                              prefill[:, :1])
                               for k in reads},
        all_steps_vs_prefill={k: logits_rel(runs[k][0], prefill)
                              for k in reads + faults + recorded},
        steps_routed_apart={k: int((~runs[k][1]).sum())
                            for k in reads + faults + recorded},
        faults_vs_prefill={k: gap(k) for k in faults},
        recorded_faults_vs_prefill={k: gap(k) for k in recorded},
        launches={k: v[2] for k, v in runs.items()},
        expected_launches=want,
        tolerance_vs_prefill=TOL_MOE_DECODE_VS_PREFILL,
        routed_apart_limit=int(MOE_DECODE_ROUTED_APART * steps))
    rec['ok'] = bool(
        max(rec['vs_prefill'].values()) <= TOL_MOE_DECODE_VS_PREFILL
        and max(rec['steps_routed_apart'][k] for k in reads)
        <= rec['routed_apart_limit']
        and min(rec['faults_vs_prefill'].values())
        >= 2 * TOL_MOE_DECODE_VS_PREFILL
        and all(rec['launches'][k] == want for k in reads))
    return rec


def cache_bytes_per_token(cfg) -> dict:
    """The latent cache's bytes a token a layer (int8 codes, an f32 scale,
    the model-type ``kpe``) against the per-head cache's in the model's
    type (K and V of every head)."""
    if getattr(cfg, 'kv_lora_rank', None) is None:
        return {}
    es = torch.empty((), dtype=cfg.tdtype).element_size()
    return dict(
        latent_int8_bytes_per_token=cfg.kv_lora_rank + 4
        + cfg.qk_rope_head_dim * es,
        per_head_bytes_per_token=cfg.num_attention_heads
        * (cfg.qk_head_dim + cfg.v_head_dim) * es)


def phase18_serve(dev, name, peaks, layers=None, serve_kw=None,
                  timing_kw=None, seed=0, arch=None):
    """One family's model at its published widths (``arch``: other
    widths, for a test) and ``layers`` (default the cut ``MOE_MODELS``
    sets), served once per attention kernel through
    the captured step and the eager one: the tokens equal, the launches
    the path's; the step times, TTFT and the step's byte bound.  Returns
    (record, model)."""
    from llmc_tpu_torch.models import build_model
    spec = MOE_MODELS[name]
    L = layers or spec['layers'][0]
    arch = dict(arch or spec['arch'], num_hidden_layers=L)
    model = build_model(dict(model=dict(type=spec['type'], arch=arch,
                                        seed=seed)), device=dev)
    runs, times = {}, {}
    for attn in spec['attn']:
        got = {mode: adapter_serve_run(dev, model, attn,
                                       eager=mode == 'eager',
                                       **(serve_kw or MOE_SERVE))
               for mode in ('graph', 'eager')}
        runs[attn or 'latent'] = dict(
            graph=got['graph'][0], eager=got['eager'][0],
            tokens_equal=got['graph'][1] == got['eager'][1])
        times[attn or 'latent'] = moe_step_times(dev, model, attn,
                                                 **(timing_kw or {}))
    cut = spec['layers']
    reduced = list(spec['reduced'])
    if L < spec['arch']['num_hidden_layers']:
        reduced.append(f'{L} of {spec["arch"]["num_hidden_layers"]} layers'
                       + (f': {cut[1]}' if layers is None and cut[1]
                          else ''))
    checks = moe_decode_checks(dev, model)
    rec = dict(phase=f'moe_serve.{name}', model=spec['type'],
               source=spec['source'], layers=L, arch=arch, reduced=reduced,
               kv_cache='int8 latent' if runs.get('latent') else 'int8',
               runs=runs, timing=times, decode_vs_prefill=checks,
               **moe_step_bound(model, peaks),
               **cache_bytes_per_token(model.cfg))
    rec['ok'] = checks['ok'] and all(
        r['tokens_equal'] and r[m]['all_done']
        and r[m]['launches'] == r[m]['expected_launches']
        and r[m]['xla_branch_calls'] == 0 and r[m]['requests'] >= 8
        for r in runs.values() for m in ('graph', 'eager'))
    return rec, model


def phase18_compress(dev, name, layers=None, arch=None, **sizes):
    """The family's compressions (``MOE_COMPRESS``, or ``layers`` deep)
    through ``run_pipeline``: PPLs finite, an equivalence's transformed PPL
    within ``TOL_PPL_EQUIV`` of pretrain, seconds a block."""
    spec = MOE_MODELS[name]
    recs = []
    for cname, quant, cut, why, equiv in MOE_COMPRESS[name]:
        L = layers or cut
        rec, res = phase_compress(dev, dict(arch or spec['arch'],
                                            num_hidden_layers=L,
                                            **MOE_COMPRESS_ARCH.get(cname,
                                                                    {})),
                                  quant['method'],
                                  # a search is held to RTN's output error
                                  special=(quant['special']
                                           if quant['method'] == 'Awq'
                                           else None), quant=quant,
                                  equivalence=equiv,
                                  model_type=spec['type'], **sizes)
        del res
        _free(dev)
        full = spec['arch']['num_hidden_layers']
        rec.update(phase=f'moe_compress.{name}', config=cname,
                   source=spec['source'],
                   reduced=list(spec['reduced']) + (
                       [f'{L} of {full} layers: {why}'] if L < full and why
                       else [f'{L} of {full} layers'] if L < full else []),
                   tolerance_ppl_transformed=TOL_PPL_EQUIV if equiv
                   else None)
        rec['ok'] = rec['ok'] and (not equiv or rec[
            'ppl_transformed_rel_drift'] <= TOL_PPL_EQUIV)
        recs.append(rec)
    return recs


# --------------------------------------------------------------------------

# Phase 19: the Llama-family adapters and the generalized block graph at
# their published widths (each source's config.json), bf16 random weights
# from a seed, packed W4A16 g128 RTN (fused, the head packed: a tied head
# as a copy of the embedding) and served through B1 and, where the
# reference's attn_ok lets a kernel take the decode step, B2 / B5.  Gemma2
# (softcap, sliding window) and Bloom (ALiBi) decode through the plain
# masked read: no attention kernel.  Each depth cut is listed with its
# reason.
QWEN25_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                 num_hidden_layers=28, num_attention_heads=28,
                 num_key_value_heads=4, head_dim=128, rope_theta=1e6,
                 rms_norm_eps=1e-6, max_position_embeddings=131072,
                 attention_bias=True, dtype='bfloat16')
QWEN3_8B = dict(vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                num_hidden_layers=36, num_attention_heads=32,
                num_key_value_heads=8, head_dim=128, rope_theta=1e6,
                rms_norm_eps=1e-6, max_position_embeddings=40960,
                use_qk_norm=True, dtype='bfloat16')
GEMMA2_9B = dict(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                 num_hidden_layers=42, num_attention_heads=16,
                 num_key_value_heads=8, head_dim=256, rope_theta=10000.0,
                 rms_norm_eps=1e-6, max_position_embeddings=8192,
                 attn_logit_softcap=50.0, final_logit_softcap=30.0,
                 query_pre_attn_scalar=256.0, sliding_window=4096,
                 dtype='bfloat16')
# BLOOM-7b1: n_embd 4096, n_head 32, n_layer 30; the MLP is 4 x hidden
BLOOM_7B1 = dict(vocab_size=250880, hidden_size=4096, intermediate_size=16384,
                 num_hidden_layers=30, num_attention_heads=32,
                 num_key_value_heads=32, head_dim=128, rms_norm_eps=1e-5,
                 max_position_embeddings=2048, dtype='bfloat16')
FAMILY_MODELS = {
    'qwen25_7b': dict(type='Qwen2', arch=QWEN25_7B,
                      source='Qwen/Qwen2.5-7B config.json',
                      layers=(28, None), attn=('auto', 'batch')),
    'qwen3_8b': dict(type='Qwen3', arch=QWEN3_8B,
                     source='Qwen/Qwen3-8B config.json',
                     layers=(36, None), attn=('auto', 'batch')),
    'gemma2_9b': dict(type='Gemma2', arch=GEMMA2_9B,
                      source='google/gemma-2-9b config.json',
                      layers=(42, None), attn=('auto', 'batch')),
    'bloom_7b1': dict(type='Bloom', arch=BLOOM_7B1,
                      source='bigscience/bloom-7b1 config.json',
                      layers=(30, None), attn=('auto', 'batch')),
}
# the families compressed (RTN, and AWQ with its scale search and clip v1)
# on one block each: the pre-ffn norm of Gemma2's sandwich (gate/up's
# prev_op) and Qwen2's biased q/k/v at full width.  AWQ's scale transform
# alone is an equivalence, held in float32: in bf16 its rescaled weights'
# rounding moved Gemma-2-9B's PPL by 3.0e-4 (Qwen2.5-7B's 3.0e-5), whose
# random model's near-certain wrong logits (softcap 30, PPL about 7.8e11)
# turn a last-bit change of a logit into a change of the NLL
FAMILY_COMPRESS = ('qwen25_7b', 'gemma2_9b')
FAMILY_PACKED_CHECK_LAYERS = 2
# the decode checks' planted fault: phase 18's 4-bit cache, a 3-bit one
# read beside it.  On each family's first 4 blocks at full width on the
# card (NVIDIA H100 80GB HBM3, 700 W) the 4-bit one read 0.183 / 0.201 /
# 0.155 / 0.074 (Qwen2.5 / Qwen3 / Gemma2 / Bloom), at least twice the
# bound; the 3-bit one 0.376 / 0.441 / 0.349 / 0.173


def family_model(dev, name, layers=None, arch=None, seed=0):
    """The family's random bf16 model at its published widths (``arch``:
    other widths, for a test) and ``layers``; Bloom with its embedding
    LayerNorm (ones and zeros), which the random tree leaves out."""
    from llmc_tpu_torch.models import build_model
    spec = FAMILY_MODELS[name]
    L_ = layers or spec['layers'][0]
    arch = dict(arch or spec['arch'], num_hidden_layers=L_)
    model = build_model(dict(model=dict(type=spec['type'], arch=arch,
                                        seed=seed)), device=dev)
    if model.cfg.use_alibi:
        D = model.cfg.hidden_size
        model.params['embed_layernorm'] = {
            'w': torch.ones(D, dtype=model.cfg.tdtype, device=dev),
            'b': torch.zeros(D, dtype=model.cfg.tdtype, device=dev)}
    return model, arch


def attention_kernel_takes(cfg, policy=None) -> bool:
    """The reference's attn_ok for a decode step of ``cfg`` over
    ``policy``'s cache (default an fp one)."""
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve.decode import kernel_takes_attention
    return kernel_takes_attention(cfg, 1,
                                  policy or KVCachePolicy(method='fp'))


def fake_quant_twin(model, wspec):
    """The model under RTN's fake-quant QMap of ``wspec`` with its head's
    weight fake-quantized in place onto the grid packing gives it (a tied
    head untied into a fake-quantized copy of the embedding, which the
    token lookup does not read): (twin, its QMap).  Shares every other
    tensor with ``model``."""
    from llmc_tpu_torch.models.adapter import QMap
    from llmc_tpu_torch.models.base import LinearQcfg
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight_static
    from llmc_tpu_torch.serve.packed import packed_grid
    cfg = model.cfg
    head = (dict(w=model.params['embed_tokens']['w'], b=None)
            if cfg.tie_word_embeddings else model.params['lm_head'])
    fq = dict(head, w=fake_quant_weight_static(wspec, head['w'],
                                               packed_grid(head, wspec)))
    twin = type(model)(dataclasses.replace(cfg, tie_word_embeddings=False),
                       dict(model.params, lm_head=fq))
    return twin, QMap({p: LinearQcfg(w_spec=wspec)
                       for p in model.get_layout().linears})


def packed_vs_fake_quant(dev, model, layers=FAMILY_PACKED_CHECK_LAYERS,
                         prompt_len=32, seed=0):
    """On the model's first ``layers`` blocks: the packed model's prefill
    logits through B1 against the same weights under RTN's fake-quant
    QMap (``fake_quant_twin``), both on ``dev`` in bf16, within
    ``TOL_COMPRESS_SERVE`` of the largest logit."""
    import copy
    from llmc_tpu_torch.serve import pack_model
    from llmc_tpu_torch.serve.decode import (FP_POLICY, forward_cached,
                                             init_cache)
    m = shallow(model, min(layers, model.cfg.num_hidden_layers))
    m.params = dict(m.params, blocks=[copy.copy(b) for b in m.blocks])
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, m.cfg.vocab_size, (1, prompt_len)), device=dev)

    def prefill(mm, qmap):
        cache = init_cache(mm, 1, prompt_len, device=dev)
        return forward_cached(mm.params, mm.cfg, ids, cache, FP_POLICY,
                              qmap)[0].float()
    wspec = _wspec(4)
    with torch.no_grad():
        twin, fq_map = fake_quant_twin(m, wspec)
        want = prefill(twin, fq_map)
        qmap = pack_model(m, wspec, fuse=True, head=True)
        got = prefill(m, qmap)
    err, rel = _rel(got, want)
    return dict(layers=m.cfg.num_hidden_layers, prompt=prompt_len,
                max_abs_logit_err_vs_fake_quant=err,
                rel_logit_err_vs_fake_quant=rel,
                argmax_agreement_vs_fake_quant=float(
                    (got.argmax(-1) == want.argmax(-1)).float().mean()),
                tolerance_vs_fake_quant=TOL_COMPRESS_SERVE,
                ok=bool(torch.isfinite(got).all()
                        and rel <= TOL_COMPRESS_SERVE))


def family_step_bound(model, peaks, B=8, prompt=128) -> dict:
    """The packed decode step's byte bound at ``B`` tokens a step after a
    ``prompt``-token prefill: every packed block weight, norm and bias and
    the packed head read once (the embedding gathered, a row a token),
    and beside it the int8 cache's K / V codes and scales at that
    position."""
    cfg = model.cfg
    p = model.params
    weights = (param_bytes(p['blocks']) + param_bytes(p['norm'])
               + param_bytes(p.get('lm_head', {}))
               + B * cfg.hidden_size * p['embed_tokens']['w'].element_size())
    cache = (2 * cfg.num_hidden_layers * B * (prompt + 1)
             * cfg.num_key_value_heads * (cfg.head_dim + 4))
    return dict(weight_bytes=weights,
                weight_bound_ms=weights / peaks.bw * 1e3,
                int8_cache_bytes=cache,
                weight_and_cache_bound_ms=(weights + cache) / peaks.bw * 1e3,
                bound_batch=B, bound_prompt=prompt, bound_by='bytes')


def packed_serve_checks(dev, model, peaks, attns=('auto', 'batch'),
                        serve_kw=None, timing_kw=None, decode_kw=None):
    """A Llama-graph model's decode held to a prefill (fp / int8 caches
    and the planted 4-bit one, a 3-bit one read beside it, on its first 4
    blocks unpacked, B2 once a layer a step where attn_ok), its packed
    logits held to the fake-quant model at 2 layers, then the whole model
    packed (W4 g128 RTN, fused, packed head) and served over an int8 cache
    through the captured step and the eager one per attention kernel of
    ``attns`` (tokens equal, the launches the path implies,
    ``xla_branch_calls`` 0), and the captured step's ms at B=8 after a
    128-token prefill beside its byte bound: the record's fields, with
    ``ok``.  Packs ``model`` in place."""
    from llmc_tpu_torch.serve import pack_model
    checks = moe_decode_checks(dev, model, **dict(
        dict(fault_bit=4, record_bits=(3,)), **(decode_kw or {})))
    packed_check = packed_vs_fake_quant(dev, model)
    t0 = time.perf_counter()
    with torch.no_grad():
        qmap = pack_model(model, _wspec(4), fuse=True, head=True)
    _sync(dev)
    pack_s = time.perf_counter() - t0
    runs, times = {}, {}
    for attn in attns:
        got = {mode: adapter_serve_run(dev, model, attn,
                                       eager=mode == 'eager', qmap=qmap,
                                       **(serve_kw or MOE_SERVE))
               for mode in ('graph', 'eager')}
        runs[attn] = dict(graph=got['graph'][0], eager=got['eager'][0],
                          tokens_equal=got['graph'][1] == got['eager'][1])
        times[attn] = moe_step_times(dev, model, attn, qmap=qmap,
                                     **(timing_kw or {}))
    rec = dict(weights='W4A16 g128 symmetric RTN, fused q/k/v and gate/up, '
                       'packed head', kv_cache='int8',
               attention_kernel=attention_kernel_takes(model.cfg),
               pack_s=pack_s, runs=runs, timing=times,
               decode_vs_prefill=checks, packed_vs_fake_quant=packed_check,
               **family_step_bound(model, peaks))
    rec['ok'] = checks['ok'] and packed_check['ok'] and all(
        r['tokens_equal'] and r[m]['all_done']
        and r[m]['launches'] == r[m]['expected_launches']
        and r[m]['xla_branch_calls'] == 0 and r[m]['requests'] >= 8
        for r in runs.values() for m in ('graph', 'eager'))
    return rec


def phase19_serve(dev, name, peaks, layers=None, arch=None, serve_kw=None,
                  timing_kw=None, decode_kw=None, seed=0):
    """One family at its published widths (``arch``: other widths, for a
    test) and ``layers`` (default the cut ``FAMILY_MODELS`` sets) through
    ``packed_serve_checks``.  Returns (record, model)."""
    spec = FAMILY_MODELS[name]
    model, arch = family_model(dev, name, layers, arch, seed)
    L_ = model.cfg.num_hidden_layers
    checks = packed_serve_checks(dev, model, peaks, spec['attn'], serve_kw,
                                 timing_kw, decode_kw)
    reduced = []
    full = spec['arch']['num_hidden_layers']
    if L_ < full:
        reduced.append(f'{L_} of {full} layers'
                       + (f': {spec["layers"][1]}' if layers is None
                          and spec['layers'][1] else ''))
    rec = dict(phase=f'family_serve.{name}', model=spec['type'],
               source=spec['source'], layers=L_, arch=arch, reduced=reduced,
               **checks)
    return rec, model


def phase19_compress(dev, name, arch=None, **sizes):
    """``family_compress`` of one of ``FAMILY_MODELS``."""
    spec = FAMILY_MODELS[name]
    return family_compress(dev, spec['type'], arch or spec['arch'],
                           spec['source'], f'family_compress.{name}',
                           spec['arch']['num_hidden_layers'], **sizes)


def family_compress(dev, model_type, arch, source, phase, full_layers,
                    **sizes):
    """RTN, AWQ's scale transform alone and AWQ with clip v1
    (``AWQ_SPECIAL``) on one block of ``model_type`` at ``arch``'s widths
    through ``run_pipeline``: PPLs finite; RTN's transformed PPL equal to
    pretrain, the scale transform's (an equivalence through the family's
    norms and biases: Gemma2's pre-ffn norm, Qwen2's biased q/k/v, OPT's
    biased linears and LayerNorms) within ``TOL_PPL_EQUIV`` of it on the
    block in float32, and with clip v1 (which clamps weights in place)
    within ``TOL_PPL_TRANSFORMED``, its searched block erring no more
    than RTN's."""
    recs = []
    for method, special, dtype, tol in (
            ('RTN', None, None, TOL_PPL_EQUIV),
            ('Awq', dict(trans=True, weight_clip=False), 'float32',
             TOL_PPL_EQUIV),
            ('Awq', AWQ_SPECIAL, None, TOL_PPL_TRANSFORMED)):
        cfg_kw = dict(arch, num_hidden_layers=1)
        if dtype:
            cfg_kw['dtype'] = dtype
        rec, res = phase_compress(dev, cfg_kw, method, special,
                                  model_type=model_type, **sizes)
        del res
        _free(dev)
        rec.update(phase=phase, model=model_type, source=source,
                   reduced=[f'1 of {full_layers} layers: one block shows '
                            f'the layout'],
                   tolerance_ppl_transformed=tol)
        rec['ok'] = rec['ok'] and rec['ppl_transformed_rel_drift'] <= tol
        recs.append(rec)
    return recs


# --------------------------------------------------------------------------
# phase 20: OPT, the engine's SinkKV, sparsification, ShadowKV and the
# latency eval
# --------------------------------------------------------------------------

OPT_6_7B = dict(vocab_size=50272, hidden_size=4096, ffn_dim=16384,
                num_hidden_layers=32, num_attention_heads=32,
                max_position_embeddings=2048, dtype='bfloat16')
OPT_SOURCE = 'facebook/opt-6.7b config.json'
# SinkKV in the engine: 4 sinks and a window of 32, which the 10 to 200
# token prompts of ``serve_requests`` outgrow
SINK_KV = dict(method='sink', num_sink_tokens=4, window_length=32)
# its first 2 layers served on the card against the CPU port: prompts
# longer than the window
SINK_VS_CPU = dict(layers=2, prompts=(40, 75, 110, 130), new_tokens=8)
# a token the card picked against the CPU's best under teacher forcing,
# relative to the largest logit: bf16 roundings that fall otherwise
# through two layers (tests/test_torch_families_gpu.py's bound)
TOL_TOKEN_GAP = 3e-2
# the shipped sparsification configs' ``sparse`` sections, as the files
# hold them (tests/test_torch_phase20.py reads the files)
SPARSE_CONFIGS = {
    'configs/sparsification/magnitude.yml':
        dict(method='Magnitude', weight=dict(sparsity=0.5)),
    'configs/sparsification/wanda.yml':
        dict(method='Wanda', weight=dict(sparsity=0.5)),
    'configs/sparsification/shortgpt.yml':
        dict(method='ShortGPT', special=dict(n_prune_layers=4)),
}
SPARSE_LAYERS = 8
# ShadowKV at Llama-2-7B's width: 2048 prefilled tokens in 256 chunks of
# 8; 48 outlier and 4 local chunks always attended, the top 128 of the
# other 204 retrieved each step
SHADOWKV = dict(sparse_budget=1024, chunk_size=8, rank=160, outlier_chunk=48,
                max_gen=2048)
SHADOWKV_RUN = dict(layers=2, tokens=4096)   # 4 until phase 22
# the dense decode's step is timed over the first tokens (its PPL over the
# same scored tokens comes from one teacher-forced forward)
DENSE_TIMED_TOKENS = 257
# the card against the CPU port, both in float32 on the same weights, at
# 2 layers over 512 tokens, under a policy whose retrieval selects at that
# length (256 prefilled tokens in 32 chunks of 8: 6 outlier and 4 local
# chunks, the top 16 of the other 22 retrieved; SHADOWKV at that length
# would keep 28 outliers and retrieve none)
SHADOWKV_CPU = dict(layers=2, tokens=512,
                    policy=dict(sparse_budget=128, chunk_size=8, rank=64,
                                outlier_chunk=6, max_gen=256))
# relative, the PPL of the card's float32 run against the CPU's
# (tests/test_torch_text_tier_gpu.py's bound)
TOL_SHADOWKV_VS_CPU = 1e-4
LATENCY = dict(prompt_len=128, gen_len=64, iters=5, batches=(1, 8))
# the packed model's depth of LatencyEval, and SinkKV's serve
LATENCY_LAYERS = (16, PHASE22_DEPTH)
SINK_LAYERS = (16, PHASE22_DEPTH)
# the latency entry through run_pipeline runs the fake-quant QMap, whose
# every decode step re-quantizes every weight (on an H100: 8.3 ms a layer
# eager at Llama-2-7B's width, 31.3 ms a captured step at 4 layers, B=1)
LATENCY_PIPELINE_LAYERS = (1, 'a fake-quant decode step re-quantizes every '
                              'weight: 31 ms captured at 4 layers, and 64 '
                              'eager warm-up steps at 32 layers are about '
                              '17 s a batch size')


def opt_model(dev, layers=None, arch=None, seed=0):
    """A random OPT (native graph, ``OptAdapter``) at OPT-6.7B's widths
    (``arch``: other widths, for a test) and ``layers``."""
    from llmc_tpu_torch.models.adapter import OptAdapter
    from llmc_tpu_torch.models.opt import OptConfig
    arch = dict(arch or OPT_6_7B)
    if layers:
        arch['num_hidden_layers'] = layers
    return OptAdapter.random(OptConfig(**arch), seed=seed, device=dev), arch


def phase20_opt(dev, peaks, layers=None, arch=None, serve_kw=None,
                timing_kw=None, decode_kw=None, seed=0):
    """OPT-6.7B viewed through the generalized Llama graph
    (``as_generalized``: LayerNorm with biases, learned positions at +2, a
    non-gated ReLU MLP, biased q/k/v fused) through
    ``packed_serve_checks``: B1 (4L + 1) a forward, B2 / B5 L a host
    decode step.  Returns the record."""
    native, arch = opt_model(dev, layers, arch, seed)
    model = native.as_generalized()
    del native      # the generalized view shares every tensor
    L_ = model.cfg.num_hidden_layers
    checks = packed_serve_checks(dev, model, peaks, ('auto', 'batch'),
                                 serve_kw, timing_kw, decode_kw)
    full = OPT_6_7B['num_hidden_layers']
    rec = dict(phase='opt_serve.opt_6_7b', model='Opt', source=OPT_SOURCE,
               layers=L_, arch=arch,
               reduced=[f'{L_} of {full} layers'] if L_ < full else [],
               graph='the generalized Llama graph (as_generalized)',
               **checks)
    del model
    _free(dev)
    return rec


def phase20_opt_compress(dev, arch=None, **sizes):
    """RTN and AWQ on one block of the native OPT graph
    (``family_compress``)."""
    return family_compress(dev, 'Opt', arch or OPT_6_7B, OPT_SOURCE,
                           'opt_compress.opt_6_7b',
                           OPT_6_7B['num_hidden_layers'], **sizes)


def engine_vs_cpu(dev, model, qmap, policy, prompts, new_tokens):
    """``prompts`` served by the engine on the card under ``policy``
    (captured steps), then each request teacher-forced on the CPU port on
    the same weights: one forward of its prompt and tokens, whose row
    masks are the decode steps' (SinkKV's sinks and window at each row's
    own position).  Every token the card picked must be within bf16's
    reach of the CPU's best (``TOL_TOKEN_GAP`` of the largest logit); the
    share picked exactly as the CPU's argmax is recorded."""
    from llmc_tpu_torch.utils.offload import tree_to_device
    from llmc_tpu_torch.serve import Request, ServingEngine
    from llmc_tpu_torch.serve.decode import forward_cached, init_cache
    eng = ServingEngine(model, qmap=qmap, max_batch=len(prompts),
                        max_len=max(map(len, prompts)) + new_tokens + 1,
                        prefill_buckets=(32, 64, 128), kv_policy=policy,
                        device=dev)
    reqs = [Request(uid=i, prompt_ids=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    cpu = type(model)(model.cfg, tree_to_device(model.params, 'cpu'))
    gaps, same = [], []
    with torch.no_grad():
        for p, r in zip(prompts, reqs):
            out = list(r.output_ids)
            seq = torch.as_tensor(np.concatenate([p, out[:-1]])[None])
            cache = init_cache(cpu, 1, seq.shape[1], policy, device='cpu')
            rows = forward_cached(cpu.params, cpu.cfg, seq, cache, policy,
                                  qmap)[0][0, len(p) - 1:].float()
            picked = rows[torch.arange(len(out)), torch.as_tensor(out)]
            gaps.append(float(((rows.max(-1).values - picked)
                               / rows.abs().max()).max()))
            same += (rows.argmax(-1) == torch.as_tensor(out)).tolist()
    del cpu
    return dict(layers=model.cfg.num_hidden_layers,
                prompts=[len(p) for p in prompts], new_tokens=new_tokens,
                max_token_gap=max(gaps), tolerance_token_gap=TOL_TOKEN_GAP,
                tokens_equal_share=float(np.mean(same)),
                all_done=all(r.done for r in reqs),
                ok=bool(max(gaps) <= TOL_TOKEN_GAP
                        and all(r.done for r in reqs)))


def phase20_sink(dev, peaks, layers=None, cfg_kw=LLAMA2_7B, serve_kw=None,
                 vs_cpu=SINK_VS_CPU, seed=0):
    """The packed Llama-2-7B (random W4A16 g128, fused, packed head) served
    by the engine under SinkKV (``SINK_KV``) through the captured step and
    the eager one, under ``auto`` and ``batch``: every request finishes,
    the captured tokens equal the eager ones, B1 launches as a forward
    implies and B2 / B5 never (no kernel takes a sink step, as the
    reference's attn_ok takes none).  Then its first ``vs_cpu['layers']``
    layers served on the card against the CPU port (``engine_vs_cpu``),
    on prompts longer than the window."""
    from llmc_tpu_torch.serve import KVCachePolicy
    policy = KVCachePolicy(**SINK_KV)
    cfg_kw = dict(cfg_kw, num_hidden_layers=layers
                  or cfg_kw['num_hidden_layers'])
    model, qmap = make_model('w4a16', cfg_kw, dev, seed)
    runs = {}
    for attn in ('auto', 'batch'):
        got = {mode: adapter_serve_run(dev, model, attn,
                                       eager=mode == 'eager', qmap=qmap,
                                       kv_policy=policy,
                                       **(serve_kw or MOE_SERVE))
               for mode in ('graph', 'eager')}
        runs[attn] = dict(graph=got['graph'][0], eager=got['eager'][0],
                          tokens_equal=got['graph'][1] == got['eager'][1])
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg_kw['vocab_size'], (n,))
               for n in vs_cpu['prompts']]
    cpu_check = engine_vs_cpu(dev, shallow(model, vs_cpu['layers']), qmap,
                              policy, prompts, vs_cpu['new_tokens'])
    del model
    _free(dev)
    attn_launches = sum(r[m]['launches'][k] for r in runs.values()
                        for m in ('graph', 'eager')
                        for k in ('flash_decode', 'batch_decode'))
    full = LLAMA2_7B['num_hidden_layers']
    rec = dict(phase='sink_serve', model='Llama',
               source='bench.py:58-62 (Llama-2-7B)',
               layers=cfg_kw['num_hidden_layers'], kv_policy=SINK_KV,
               reduced=[f'{cfg_kw["num_hidden_layers"]} of {full} layers: '
                        f'{SINK_LAYERS[1]}']
               if cfg_kw['num_hidden_layers'] < full else [],
               weights='random W4A16 g128, fused, packed head', runs=runs,
               attention_launches=attn_launches, vs_cpu=cpu_check)
    rec['ok'] = bool(cpu_check['ok'] and attn_launches == 0 and all(
        r['tokens_equal'] and r[m]['all_done']
        and r[m]['launches'] == r[m]['expected_launches']
        and r[m]['xla_branch_calls'] == 0
        for r in runs.values() for m in ('graph', 'eager')))
    return rec


def sparse_config(rel, cfg_kw, n_samples=8, seq_len=512, eval_tokens=4096,
                  eval_bs=4, seed=0):
    """A shipped sparsification config's ``sparse`` section
    (``SPARSE_CONFIGS``) on a random Llama of ``cfg_kw``, synthetic
    calibration and PPL data at ``pretrain`` and ``transformed``."""
    sparse = json.loads(json.dumps(SPARSE_CONFIGS[rel]))
    cfg = compress_config(cfg_kw, 'RTN', n_samples=n_samples,
                          seq_len=seq_len, eval_tokens=eval_tokens,
                          eval_bs=eval_bs, seed=seed)
    del cfg['quant']
    cfg['eval']['eval_pos'] = ['pretrain', 'transformed']
    return dict(cfg, sparse=sparse)


def write_llama_checkpoint(dev, cfg_kw, path, seed=0) -> dict:
    """A random Llama of ``cfg_kw`` written to ``path`` as an HF
    checkpoint (``config.json`` in HF's names), for a pipeline that loads
    it and saves what it made; returns the ``model`` section that loads
    it."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    model = LlamaAdapter.random(LlamaConfig(**cfg_kw), seed=seed, device=dev)
    model.hf_config = dict(cfg_kw, model_type='llama',
                           torch_dtype=cfg_kw['dtype'])
    model.save_to_hf(path)
    del model
    _free(dev)
    return dict(type='Llama', path=path, torch_dtype=cfg_kw['dtype'])


def zero_shares(model) -> dict:
    """Each linear of each block: its share of zeros, and the least count
    of zeros a row over its input width."""
    from llmc_tpu_torch.models.base import get_path
    out = {}
    for i, blk in enumerate(model.blocks):
        for p in model.get_layout().linears:
            w = get_path(blk, p)['w']
            z = w == 0
            out[f'{i}.{p}'] = dict(share=float(z.float().mean()),
                                   min_row_share=float(
                                       z.sum(1).min()) / w.shape[1])
    return out


def sparse_masks_vs_cpu(dev, config, names=('Magnitude', 'Wanda')):
    """Block 0 of ``config``'s model, its subset inputs captured on the
    card over the calibration batches, pruned by each method on the card
    and by the CPU port on the same weights and inputs: the masks'
    agreement.  Magnitude's sort of |w| is exact on both; Wanda's row
    statistic is a sum whose order differs, so an entry may fall
    otherwise only where its metric ties the row's k-th value within a few
    ulps (``wanda_off_tie``: the mismatches whose CPU metric lies more
    than 1e-5 relative from that value, which must be none)."""
    from llmc_tpu_torch.compression import sparsification as TS
    from llmc_tpu_torch.data import CalibDataset
    from llmc_tpu_torch.models import build_model
    from llmc_tpu_torch.models.base import get_path
    model = build_model(config, device=dev)
    batches, _ = CalibDataset(config['calib'],
                              model.tokenizer).get_calib_dataset()
    with torch.no_grad():
        xs, kws = model.collect_first_block_input(batches)
        inputs = {'data': xs, 'kwargs': kws}
        out = {}
        for name in names:
            sc = dict(method=name, weight=dict(sparsity=0.5))
            algo = getattr(TS, name)(model, sc, inputs, None, config)
            _, feats = algo.block_forward_capture(model.blocks[0])
            cpu_feats = {k: [x.cpu().float() for x in v]
                         for k, v in feats.items()}
            blk, cpu_blk = model.blocks[0], tree_to(model.blocks[0], 'cpu')
            rows = {}
            for subset in algo.layout.subsets:
                got = algo.subset_transform(0, blk, subset, feats)
                want = algo.subset_transform(0, cpu_blk, subset, cpu_feats)
                for p in subset.layers:
                    gm = get_path(got, p)['w'].cpu() == 0
                    wm = get_path(want, p)['w'] == 0
                    diff = gm != wm
                    row = dict(mismatches=int(diff.sum()),
                               entries=int(diff.numel()))
                    if name == 'Wanda' and row['mismatches']:
                        w = get_path(cpu_blk, p)['w'].float()
                        sr = TS.Wanda.scaler_row(cpu_feats[subset.input_key])
                        metric = w.abs() * sr.sqrt()[None]
                        k = int(w.shape[1] * 0.5)
                        kth = metric.sort(-1).values[:, k - 1:k]
                        near = (metric - kth).abs() <= 1e-5 * kth
                        row['off_tie'] = int((diff & ~near).sum())
                    rows[p] = row
            out[name] = rows
    del model
    _free(dev)
    return out


def phase20_sparse(dev, cfg_kw=None, layers=SPARSE_LAYERS, mask_check=True,
                   **sizes):
    """Magnitude and Wanda at sparsity 0.5 and ShortGPT with the shipped
    ``n_prune_layers`` on a random Llama-2-7B at ``layers`` layers
    (``cfg_kw``: other widths, for a test) through ``run_pipeline``: PPLs
    finite, seconds a block, each linear's share of zeros (Wanda at least
    floor(K / 2) a row, Magnitude at least half of each layer), ShortGPT's
    removed blocks and the ``num_hidden_layers`` of the config
    ``save_trans`` wrote; then block 0's masks on the card against the
    CPU port's (``sparse_masks_vs_cpu``).  ShortGPT runs on a written
    checkpoint (``write_llama_checkpoint``), whose config its save
    shortens."""
    import tempfile
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    cfg_kw = dict(cfg_kw or LLAMA2_7B, num_hidden_layers=layers)
    recs = []
    for rel in SPARSE_CONFIGS:
        config = sparse_config(rel, cfg_kw, **sizes)
        method = config['sparse']['method']
        with tempfile.TemporaryDirectory() as tmp:
            if method == 'ShortGPT':
                config['model'] = write_llama_checkpoint(
                    dev, cfg_kw, os.path.join(tmp, 'in'),
                    config['model']['seed'])
                config['save'] = dict(save_trans=True,
                                      save_path=os.path.join(tmp, 'out'))
            reset_launch_counts()
            res = run_pipeline(config, device=dev)
            counts, xla = read_counts()
            saved = None
            if method == 'ShortGPT':
                with open(os.path.join(tmp, 'out', 'config.json')) as f:
                    saved = json.load(f)['num_hidden_layers']
        ppl = {k: res[k] for k in ('ppl_pretrain', 'ppl_transformed')}
        calib = res['phase_times'][f'calib_{method}']
        rec = dict(phase='sparse', config=rel, method=method,
                   sparse=config['sparse'], layers=layers,
                   width=cfg_kw['hidden_size'], calib=config['calib'],
                   eval=config['eval'], **ppl,
                   block_loop_s_per_block=calib / layers,
                   phase_times_s=res['phase_times'], wall_s=res['wall_s'],
                   launches=counts, xla_branch_calls=xla)
        ok = all(np.isfinite(v) for v in ppl.values())
        if method == 'ShortGPT':
            n = int(config['sparse']['special']['n_prune_layers'])
            imp = res['opt'].importances
            rec.update(importances=imp.tolist(),
                       removed=sorted(res['opt'].removed),
                       blocks_after=res['model'].n_blocks,
                       saved_num_hidden_layers=saved)
            ok = ok and res['model'].n_blocks == layers - n == saved \
                and rec['removed'] == sorted(np.argsort(imp)[:n].tolist())
        else:
            shares = zero_shares(res['model'])
            sp = float(config['sparse']['weight']['sparsity'])
            rec.update(min_zero_share=min(v['share'] for v in
                                          shares.values()),
                       min_row_zero_share=min(v['min_row_share'] for v in
                                              shares.values()))
            key = 'min_row_zero_share' if method == 'Wanda' \
                else 'min_zero_share'
            ok = ok and rec[key] >= sp - 1e-6
        rec['ok'] = bool(ok)
        del res
        _free(dev)
        recs.append(rec)
    if mask_check:
        masks = sparse_masks_vs_cpu(dev, sparse_config(
            'configs/sparsification/wanda.yml', cfg_kw, **sizes))
        rec = dict(phase='sparse_masks_vs_cpu', block=0, masks=masks,
                   magnitude_mismatches=sum(
                       r['mismatches'] for r in masks['Magnitude'].values()),
                   wanda_mismatches=sum(
                       r['mismatches'] for r in masks['Wanda'].values()),
                   wanda_off_tie=sum(r.get('off_tie', 0)
                                     for r in masks['Wanda'].values()))
        rec['ok'] = rec['magnitude_mismatches'] == 0 \
            and rec['wanda_off_tie'] == 0
        recs.append(rec)
    return recs


def shadowkv_retrieval_vs_cpu(dev, cfg_kw, policy_kw, prefill, seed=0):
    """``init_from_prefill`` and one step's ``retrieve`` of one layer on
    the card and on the CPU, in float32, on the same random prefill K / V
    and query at ``cfg_kw``'s widths: the outlier chunks and the retrieved
    positions of each kv head, compared as sets (the card must pick
    exactly the CPU's), and the rebuilt K's largest difference relative
    to its largest entry (a record).  The unroped K is of rank half the
    policy's plus 1% noise, low-rank as keys are (ShadowKV's premise: a
    full-rank random K's truncated SVD is ill-posed); the seeded data keep
    every selection 3e-5 (relative) away from a tie."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.models import llama as Lm
    from llmc_tpu_torch.serve.shadowkv import ShadowKVPolicy
    policy = ShadowKVPolicy(**policy_kw)
    cfg = LlamaConfig(**dict(cfg_kw, num_hidden_layers=1, dtype='float32'))
    kvh, hd = cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.RandomState(seed)
    r = max(policy.rank // 2, 1)
    ku = torch.as_tensor((rng.standard_normal((prefill, r))
                          @ rng.standard_normal((r, kvh * hd)) / r ** 0.5
                          + 0.01 * rng.standard_normal((prefill, kvh * hd))
                          ).astype(np.float32).reshape(1, prefill, kvh, hd))
    v = torch.as_tensor(rng.standard_normal(
        (1, prefill, kvh, hd)).astype(np.float32))
    q = torch.as_tensor(rng.standard_normal(
        (1, 1, cfg.num_attention_heads, hd)).astype(np.float32))
    picks = {}
    for where in (dev, torch.device('cpu')):
        k, vv, qq = (t.to(where) for t in (ku, v, q))
        cos, sin = Lm.rope_cos_sin(cfg, torch.arange(prefill,
                                                     device=where)[None])
        kr = Lm.apply_rope(k, k, cos, sin)[0]
        state = policy.init_from_prefill(cfg, [k], [kr], [vv])
        k_sel, _, pos = policy.retrieve(cfg, state, 0, qq)
        # the top-k's order among the retrieved is not part of the result
        pos, order = pos.sort(-1)
        k_sel = k_sel.gather(2, order[..., None].expand(-1, -1, -1, hd))
        picks[where.type] = (state['out_idx'][0].sort(-1).values.cpu(),
                             pos.cpu(), k_sel.cpu())
    (co, cp, ck), (ho, hp, hk) = picks[dev.type], picks['cpu']
    rec = dict(layers=1, prefill=prefill, outlier_mismatches=int(
                   (co != ho).sum()), outlier_entries=int(co.numel()),
               position_mismatches=int((cp != hp).sum()),
               position_entries=int(cp.numel()),
               k_rebuilt_max_rel=float((ck - hk).abs().max()
                                       / hk.abs().max()))
    rec['ok'] = rec['outlier_mismatches'] == 0 == rec['position_mismatches']
    return rec


def phase20_shadowkv(dev, cfg_kw=LLAMA2_7B, run=SHADOWKV_RUN,
                     cpu=SHADOWKV_CPU, policy_kw=SHADOWKV, seed=0,
                     dense_timed=DENSE_TIMED_TOKENS):
    """``shadowkv_decode_nll`` on a random bf16 Llama-2-7B at
    ``run['layers']`` layers over ``run['tokens']`` random ids (half
    prefilled): its PPL and seconds (the prefill's SVD included) beside
    the dense model's PPL over the same scored tokens (one teacher-forced
    forward) and the dense ``decode_nll``'s milliseconds a step over the
    first ``dense_timed`` ids; the card's retrieval against the CPU's at
    the run's prefill (``shadowkv_retrieval_vs_cpu``); then at
    ``cpu['layers']`` layers and ``cpu['tokens']`` tokens, under
    ``cpu['policy']``, the card's PPL against the CPU port's, both in
    float32 on the same weights, within ``TOL_SHADOWKV_VS_CPU``."""
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.serve.decode import decode_nll
    from llmc_tpu_torch.serve.shadowkv import (ShadowKVPolicy,
                                               shadowkv_decode_nll)
    policy = ShadowKVPolicy(**policy_kw)
    model = LlamaAdapter.random(LlamaConfig(**dict(
        cfg_kw, num_hidden_layers=run['layers'])), seed=seed, device=dev)
    ids = np.random.RandomState(seed).randint(0, cfg_kw['vocab_size'],
                                              (1, run['tokens']))
    S_pre = (run['tokens'] // 2 // policy.chunk_size) * policy.chunk_size
    _sync(dev)
    t0 = time.perf_counter()
    ppl, n = shadowkv_decode_nll(model, ids, policy)
    _sync(dev)
    sparse_s = time.perf_counter() - t0
    # the dense PPL of the tokens ShadowKV scores, ids[S_pre:], each from
    # the logits of the position before it
    with torch.no_grad():
        t_ids = torch.as_tensor(ids, device=dev)
        lp = torch.log_softmax(model.forward_logits(t_ids)[
            0, S_pre - 1:-1].float(), dim=-1)
        dense_ppl = float(torch.exp(-lp.gather(
            -1, t_ids[0, S_pre:, None]).mean()))
        del lp
    _sync(dev)
    t0 = time.perf_counter()
    decode_nll(model, ids[:, :dense_timed], device=dev)
    _sync(dev)
    dense_ms = (time.perf_counter() - t0) * 1e3 / (dense_timed - 1)
    n_chunks = S_pre // policy.chunk_size
    n_out = min(policy.outlier_chunk, n_chunks - policy._local(n_chunks))
    retrieval = shadowkv_retrieval_vs_cpu(dev, cfg_kw, policy_kw, S_pre,
                                          seed)
    small = dict(cfg_kw, num_hidden_layers=cpu['layers'], dtype='float32')
    m_card = LlamaAdapter(LlamaConfig(**small), tree_to(
        {**model.params, 'blocks': model.params['blocks'][:cpu['layers']]},
        dev, F32))
    del model
    _free(dev)
    m_cpu = LlamaAdapter(LlamaConfig(**small), tree_to(m_card.params, 'cpu'))
    small_ids = ids[:, :cpu['tokens']]
    cpu_policy = ShadowKVPolicy(**cpu['policy'])
    checks = {}
    for name, m in (('card', m_card), ('cpu', m_cpu)):
        t0 = time.perf_counter()
        checks[name] = shadowkv_decode_nll(m, small_ids, cpu_policy)[0]
        checks[f'{name}_s'] = time.perf_counter() - t0
    rec = dict(phase='shadowkv', model='Llama', source='bench.py:58-62 '
               '(Llama-2-7B)', layers=run['layers'], tokens=run['tokens'],
               reduced=[f'{run["layers"]} of {cfg_kw["num_hidden_layers"]} '
                        f'layers: 2047 decode steps; {PHASE22_DEPTH}'],
               policy=policy_kw, prefill_tokens=S_pre, prefill_chunks=n_chunks,
               outlier_chunks=n_out, local_chunks=policy._local(n_chunks),
               retrieved_chunks=min(policy.sparse_budget // policy.chunk_size,
                                    n_chunks - n_out
                                    - policy._local(n_chunks)),
               ppl=ppl, scored=n, s=sparse_s,
               ms_a_step_prefill_included=sparse_s * 1e3 / (n - 1),
               dense_ppl=dense_ppl, dense_ms_per_step=dense_ms,
               dense_timed_steps=dense_timed - 1,
               ppl_rel_vs_dense=abs(ppl - dense_ppl) / dense_ppl,
               retrieval_vs_cpu=retrieval,
               cpu_check=dict(layers=cpu['layers'], tokens=cpu['tokens'],
                              policy=cpu['policy'], dtype='float32',
                              card_ppl=checks['card'],
                              cpu_ppl=checks['cpu'],
                              rel=abs(checks['card'] - checks['cpu'])
                              / checks['cpu'],
                              card_s=checks['card_s'],
                              cpu_s=checks['cpu_s'],
                              tolerance=TOL_SHADOWKV_VS_CPU))
    rec['ok'] = bool(np.isfinite(ppl) and np.isfinite(dense_ppl)
                     and n == run['tokens'] - S_pre and retrieval['ok']
                     and rec['cpu_check']['rel'] <= TOL_SHADOWKV_VS_CPU)
    del m_card, m_cpu
    _free(dev)
    return rec


def latency_launches(L, runs, gen_len, packed):
    """What one ``LatencyEval`` counts: B1 (4L + 1) a forward of a packed
    model over its prefills and the decode's counted passes (its eager
    warm-up and its capture: a replay counts nothing), B2 once a layer a
    counted decode step (an fp cache)."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    steps = 2 * gen_len
    if packed:
        n['w4_dequant_matmul'] = (4 * L + 1) * (runs + steps)
    n['flash_decode'] = L * steps
    return n


def phase20_latency(dev, cfg_kw=LLAMA2_7B, lat=LATENCY,
                    pipeline_layers=LATENCY_PIPELINE_LAYERS[0], seed=0):
    """``LatencyEval`` at batch 1 and 8: on the packed model's serving
    QMap (random W4A16 g128, fused, packed head) over an fp cache, and
    through ``run_pipeline`` with a ``latency`` entry at ``fake_quant``
    of an RTN W4 config (at ``pipeline_layers``).  TTFT p50 / p99, decode
    tok/s (records), the captured decode's tokens equal to its eager
    warm-up's, and the launches its path implies."""
    from llmc_tpu_torch.eval.latency import LatencyEval
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    model, qmap = make_model('w4a16', cfg_kw, dev, seed)
    L = cfg_kw['num_hidden_layers']
    rows = []
    with attn_impl('auto'):
        for B in lat['batches']:
            ev = LatencyEval(prompt_len=lat['prompt_len'],
                             gen_len=lat['gen_len'], batch=B,
                             iters=lat['iters'])
            reset_launch_counts()
            stats = ev.eval(model, qmap=qmap)
            counts, xla = read_counts()
            rows.append(dict(
                qmap='packed', batch=B, layers=L, **stats,
                captured_equals_eager=bool(torch.equal(ev.first_tokens,
                                                       ev.tokens)),
                counts=ev.stats, launches=counts, xla_branch_calls=xla,
                expected_launches=latency_launches(
                    L, 1 + lat['iters'], lat['gen_len'], True)))
    del model
    _free(dev)
    pl = dict(cfg_kw, num_hidden_layers=pipeline_layers)
    config = compress_config(pl, 'RTN', seed=seed)
    config['eval'] = [dict(type='latency', name=f'bs{B}',
                           prompt_len=lat['prompt_len'],
                           gen_len=lat['gen_len'], bs=B, iters=lat['iters'],
                           eval_pos=['fake_quant'])
                      for B in lat['batches']]
    reset_launch_counts()
    with attn_impl('auto'):
        res = run_pipeline(config, device=dev)
    counts, xla = read_counts()
    piped = {k: v for k, v in res.items() if k.startswith('latency')}
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want['flash_decode'] = sum(latency_launches(
        pipeline_layers, 0, lat['gen_len'], False)['flash_decode']
        for _ in lat['batches'])
    del res
    _free(dev)
    full = LLAMA2_7B['num_hidden_layers']
    rec = dict(phase='latency', source='bench.py:58-62 (Llama-2-7B)',
               prompt_len=lat['prompt_len'], gen_len=lat['gen_len'],
               iters=lat['iters'], kv_cache='fp', packed=rows,
               reduced=[f'{L} of {full} layers: {LATENCY_LAYERS[1]}']
               if L < full else [],
               pipeline=dict(layers=pipeline_layers,
                             reduced=[f'{pipeline_layers} of {full} layers: '
                                      f'{LATENCY_PIPELINE_LAYERS[1]}'],
                             config='RTN W4 g128 symmetric, a latency '
                                    'entry a batch size at fake_quant',
                             results=piped, launches=counts,
                             xla_branch_calls=xla, expected_launches=want))
    rec['ok'] = bool(all(
        r['captured_equals_eager'] and r['launches'] == r['expected_launches']
        and r['xla_branch_calls'] == 0 and r['ttft_p50_ms'] > 0
        and r['decode_tokens_per_s'] > 0 for r in rows)
        and counts == want and xla == 0
        and all(v['decode_tokens_per_s'] > 0 for v in piped.values()))
    return rec


def phase20(dev, peaks):
    """Every record of phase 20, in its order (a generator: each record
    is emitted and checked before the next part runs)."""
    yield phase20_opt(dev, peaks)
    yield from phase20_opt_compress(dev)
    yield phase20_sink(dev, peaks, layers=SINK_LAYERS[0])
    yield from phase20_sparse(dev)
    yield phase20_shadowkv(dev)
    yield phase20_latency(dev, cfg_kw=dict(
        LLAMA2_7B, num_hidden_layers=LATENCY_LAYERS[0]))


def phase20_failure(rec) -> dict:
    """The fields of a phase-20 record that its ``ok`` reads, for the
    failure's message."""
    keys = ('runs', 'decode_vs_prefill', 'packed_vs_fake_quant',
            'ppl_transformed_rel_drift', 'block_output_mse',
            'attention_launches', 'vs_cpu', 'min_zero_share',
            'min_row_zero_share', 'removed', 'blocks_after',
            'saved_num_hidden_layers', 'magnitude_mismatches',
            'wanda_off_tie', 'retrieval_vs_cpu', 'cpu_check', 'ppl',
            'packed', 'pipeline')
    return {k: rec[k] for k in keys if k in rec}


# --------------------------------------------------------------------------
# phase 21: the backend exports, block offload and the code eval
# --------------------------------------------------------------------------

# meta-llama/Llama-2-70b-hf config.json's widths
LLAMA2_70B = dict(vocab_size=32000, hidden_size=8192, intermediate_size=28672,
                  num_hidden_layers=80, num_attention_heads=64,
                  num_key_value_heads=8, head_dim=128, dtype='bfloat16')
OFFLOAD_LAYERS = (8, 'one block is 1.71 GB in bf16: the 80 layers would need '
                     '137 GB of pinned host memory and most of the script\'s '
                     'time limit; the check is that the device\'s peak does '
                     'not grow with depth')
OFFLOAD_CHECK_LAYERS = 2
OFFLOAD_EVAL = dict(num_tokens=2048, seq_len=512, bs=4)   # 4 x 512 tokens
PEAK_FLAT = 0.05          # the 8-layer peak within 5% of the 2-layer peak
TOL_OFFLOAD_PPL = 1e-4    # offloaded against resident, relative
# The quant and save sections of the shipped backend configs phase 21 runs
# (copied: this script reads no YAML).  The AWQ-searched configs' weight
# specs run under RTN: the writers read the weight spec alone.
_W4G = dict(bit=4, symmetric=False, granularity='per_group', group_size=128)
_W8C = dict(bit=8, symmetric=True, granularity='per_channel')
EXPORT_CONFIGS = {
    'autoawq_rtn_w4a16': ('configs/backend/autoawq/rtn_w4a16.yml',
                          dict(method='RTN', weight=_W4G),
                          dict(save_autoawq=True)),
    'vllm_w4a16_pack': ('configs/backend/vllm_w4a16_pack.yml',
                        dict(method='RTN', weight=dict(_W4G, need_pack=True)),
                        dict(save_vllm=True)),
    'vllm_rtn_w8a16': ('configs/backend/vllm/rtn_w8a16.yml',
                       dict(method='RTN', weight=_W8C), dict(save_vllm=True)),
    'vllm_gptq_w4a16': ('configs/backend/vllm/gptq_w4a16.yml',
                        dict(method='GPTQ', weight=_W4G, quant_out=True,
                             special=dict(actorder=True, static_groups=False,
                                          percdamp=0.01, blocksize=128,
                                          true_sequential=True)),
                        dict(save_vllm=True)),
    'lightllm_w8a8': ('configs/backend/lightllm_w8a8.yml',
                      dict(method='RTN', weight=_W8C),
                      dict(save_lightllm=True)),
    'mlcllm_rtn_w4a16': ('configs/backend/mlcllm/rtn_w4a16.yml',
                         dict(method='RTN', weight=_W4G),
                         dict(save_mlcllm=True)),
    'trtllm_w4a16_tp2': ('configs/backend/trtllm_w4a16.yml',
                         dict(method='RTN', weight=_W4G),
                         dict(save_trtllm=True, tp_size=2)),
}
WRITERS = ('vllm_w4a16_pack', 'vllm_rtn_w8a16', 'vllm_gptq_w4a16',
           'lightllm_w8a8', 'mlcllm_rtn_w4a16', 'trtllm_w4a16_tp2')
# the writers' depth on the card, and on the CPU that holds them
WRITER_LAYERS = {'vllm_gptq_w4a16': (1, 'GPTQ\'s column loop: about 6 s a '
                                        '7B block')}
WRITER_CPU_LAYERS = 1
CODE_EVAL = dict(layers=2, max_new_tokens=16)
CODE_PROBLEMS = ({'task_id': 'smoke/0', 'prompt': 'def add(a, b):\n'},
                 {'task_id': 'smoke/1',
                  'prompt': 'class Stack:\n    def pop(self):\n'})


class ByteTokenizer:
    """UTF-8 bytes as ids (``tests/test_eval_orchestration.py``'s
    tokenizer): an id decodes to the character of its value mod 128."""

    def __call__(self, text):
        return {'input_ids': list(text.encode())}

    def decode(self, ids, skip_special_tokens=True):
        return ''.join(chr(int(i) % 128) for i in ids)


def export_config(cfg_kw, name, out, seed=0, n_samples=2, seq_len=512,
                  **model_kw):
    """``EXPORT_CONFIGS[name]``'s quant and save sections (the save into
    ``out``) on a random Llama of ``cfg_kw`` from ``model.arch``, synthetic
    calibration data, no eval."""
    _, quant, save = EXPORT_CONFIGS[name]
    return dict(
        base=dict(seed=seed),
        model=dict(type='Llama', arch=dict(cfg_kw), seed=seed, **model_kw),
        calib=dict(name='synthetic', n_samples=n_samples, bs=-1,
                   seq_len=seq_len, seed=seed,
                   vocab_size=cfg_kw['vocab_size']),
        quant=json.loads(json.dumps(quant)),
        save=dict(save, save_path=out))


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


@contextlib.contextmanager
def scratch_dir():
    """A temporary directory, deleted with what it holds on exit."""
    import shutil
    import tempfile
    path = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


def awq_dequant(flat, prefix, gs):
    """(q - z) * s of one linear of an AWQ-GEMM checkpoint, [out, in] f32 on
    the tensors' device, and the linear's largest scale."""
    from llmc_tpu_torch.native import unpack_awq_order
    q = unpack_awq_order(flat[f'{prefix}.qweight'], 4).float()
    z = unpack_awq_order(flat[f'{prefix}.qzeros'], 4).float()
    s = flat[f'{prefix}.scales'].float()
    w = (q - z.repeat_interleave(gs, 0)) * s.repeat_interleave(gs, 0)
    return w.t(), float(s.max())


def codes_vs_b1(model, flat, wspec) -> dict:
    """An AWQ-GEMM checkpoint's codes, zero points and fp16 scales, unpacked
    on the card, against what ``pack_model`` (unfused, ``pre_t=False``)
    packed for B1 into ``model`` (read back with ``unpack_weight``): the
    counts that differ.  A symmetric model's exported codes and zero point
    carry the offset 2^(bits-1) (ROADMAP C)."""
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.native import unpack_awq_order
    from llmc_tpu_torch.ops.dequant_matmul import QMeta, unpack_weight
    off = 8 if wspec.symmetric else 0
    n = dict(codes=0, zeros=0, scales=0, linears=0, codes_checked=0)
    for i in range(model.n_blocks):
        blk = model.blocks[i]
        for path in model.get_layout().linears:
            pre = f'model.layers.{i}.{path}'
            lin = get_path(blk, path)
            N, half = lin['qweight'].shape
            meta = QMeta(bits=4, group_size=wspec.group_size,
                         symmetric=wspec.symmetric, out_features=N,
                         in_features=2 * half)
            codes = unpack_weight(lin['qweight'], meta) + off
            got = unpack_awq_order(flat[f'{pre}.qweight'], 4).t().float()
            n['codes'] += int((got != codes).sum())
            z = unpack_awq_order(flat[f'{pre}.qzeros'], 4).t().float()
            zb = lin['zeros'] if lin.get('zeros') is not None \
                else torch.full_like(z, off)
            n['zeros'] += int((z != zb).sum())
            n['scales'] += int((flat[f'{pre}.scales'].t()
                                != lin['scales'].to(torch.float16)).sum())
            n['linears'] += 1
            n['codes_checked'] += codes.numel()
    return n


def file_model(flat, cfg, layers, gs):
    """A plain (unpacked) model of the first ``layers`` blocks whose
    weights are an AWQ-GEMM checkpoint's, dequantized, in ``cfg``'s
    dtype."""
    from llmc_tpu_torch.models import LlamaAdapter
    from llmc_tpu_torch.models.hf_loader import llama_params_from_hf
    cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    hf = {k: v for k, v in flat.items()
          if not k.startswith('model.layers.')
          or int(k.split('.')[2]) < layers and k.endswith('norm.weight')}
    for i in range(layers):
        for path in ('self_attn.q_proj', 'self_attn.k_proj',
                     'self_attn.v_proj', 'self_attn.o_proj', 'mlp.gate_proj',
                     'mlp.up_proj', 'mlp.down_proj'):
            pre = f'model.layers.{i}.{path}'
            hf[f'{pre}.weight'] = awq_dequant(flat, pre, gs)[0].to(
                cfg.tdtype)
    return LlamaAdapter(cfg, llama_params_from_hf(hf, layers,
                                                  cfg.tie_word_embeddings))


def file_vs_b1(dev, model, qmap, flat, wspec, layers=2, prompt_len=32,
               seed=0) -> dict:
    """On the packed model's first ``layers`` blocks: its prefill logits
    through B1 against a plain forward over the weights dequantized from
    the written checkpoint, within ``TOL_COMPRESS_SERVE`` of the largest
    logit; B1 launched once a packed linear (the head is not packed)."""
    from llmc_tpu_torch.serve.decode import (FP_POLICY, forward_cached,
                                             init_cache)
    from llmc_tpu_torch.ops import reset_launch_counts
    m = shallow(model, layers)
    plain = file_model(flat, model.cfg, layers, wspec.group_size)
    ids = torch.as_tensor(np.random.RandomState(seed).randint(
        0, m.cfg.vocab_size, (1, prompt_len)), device=dev)

    def prefill(mm, q):
        cache = init_cache(mm, 1, prompt_len, device=dev)
        return forward_cached(mm.params, mm.cfg, ids, cache, FP_POLICY,
                              q)[0].float()
    with torch.no_grad():
        reset_launch_counts()
        got = prefill(m, qmap)
        counts, xla = read_counts()
        want = prefill(plain, None)
    err, rel = _rel(got, want)
    expected = dict.fromkeys(counts, 0)
    expected['w4_dequant_matmul'] = len(m.get_layout().linears) * layers
    return dict(layers=layers, prompt=prompt_len,
                max_abs_logit_err_vs_file=err, rel_logit_err_vs_file=rel,
                tolerance_vs_file=TOL_COMPRESS_SERVE, launches=counts,
                expected_launches=expected, xla_branch_calls=xla,
                ok=bool(torch.isfinite(got).all()
                        and rel <= TOL_COMPRESS_SERVE))


def phase21_export(dev, cfg_kw=LLAMA2_7B, name='autoawq_rtn_w4a16',
                   check_layers=2, **sizes):
    """``run_pipeline`` at ``cfg_kw``'s full depth with ``name``'s quant
    section and ``save_autoawq``: the ``save`` phase's seconds and the
    bytes written; the written codes, zero points and fp16 scales against
    what ``pack_model`` packs for B1 from the same compressed model (0
    mismatched); at ``check_layers`` the packed prefill through B1 held to
    a plain forward over the weights dequantized from the file."""
    from llmc_tpu_torch.export import read_checkpoint
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import pack_model
    with scratch_dir() as out:
        config = export_config(cfg_kw, name, out, **sizes)
        reset_launch_counts()
        res = run_pipeline(config, device=dev)
        counts, xla = read_counts()
        written = dir_bytes(out)
        flat = read_checkpoint(out, dev)['model.safetensors']
    parts = collections.Counter()
    for k, t in flat.items():
        part = k.rsplit('.', 1)[1]
        parts[part if part in ('qweight', 'qzeros', 'scales') else 'other'] \
            += t.numel() * t.element_size()
    model, wspec = res['model'], res['opt'].wspec
    times = res['phase_times']
    with torch.no_grad():
        qmap = pack_model(model, wspec, pre_t=False)
    mism = codes_vs_b1(model, flat, wspec)
    check = file_vs_b1(dev, model, qmap, flat, wspec, layers=check_layers)
    del res, model, flat
    _free(dev)
    return dict(phase='export', config=EXPORT_CONFIGS[name][0],
                weight=config['quant']['weight'], save=config['save'],
                layers=cfg_kw['num_hidden_layers'],
                width=cfg_kw['hidden_size'], save_s=times['save'],
                phase_times_s=times, bytes_written=written,
                bytes_by_part=dict(parts), pipeline_launches=counts,
                pipeline_xla_branch_calls=xla, codes_vs_b1=mism,
                file_vs_b1=check, launches=check['launches'],
                expected_launches=check['expected_launches'],
                xla_branch_calls=check['xla_branch_calls'],
                ok=bool(not (mism['codes'] or mism['zeros']
                             or mism['scales'])
                        and check['ok'] and not any(counts.values())
                        and xla == 0))


def phase21_symmetric(dev, cfg_kw=None, name='autoawq_rtn_w4a16', **sizes):
    """The main path's symmetric W4 g128 model exported for AutoAWQ: every
    linear's unpacked checkpoint dequantizes to the fake-quant weights
    within the fp16 rounding of its scales (|q - z| <= 8 steps of a scale
    rounded to 2^-11 of itself), the port's departure from the reference
    (ROADMAP C); the codes against B1's packing as in ``phase21_export``."""
    from llmc_tpu_torch.export import read_checkpoint
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight
    from llmc_tpu_torch.serve import pack_model
    cfg_kw = cfg_kw or dict(LLAMA2_7B, num_hidden_layers=2)
    with scratch_dir() as out:
        config = export_config(cfg_kw, name, out, **sizes)
        config['quant']['weight']['symmetric'] = True
        res = run_pipeline(config, device=dev)
        flat = read_checkpoint(out, dev)['model.safetensors']
    model, wspec = res['model'], res['opt'].wspec
    worst = 0.0
    with torch.no_grad():
        for i in range(model.n_blocks):
            blk = model.blocks[i]
            for path in model.get_layout().linears:
                fq = fake_quant_weight(wspec, get_path(blk, path)['w'].float())
                deq, smax = awq_dequant(flat, f'model.layers.{i}.{path}',
                                        wspec.group_size)
                bound = 8 * smax * 2 ** -11
                worst = max(worst, float((deq - fq).abs().max()) / bound)
        pack_model(model, wspec, pre_t=False)
    mism = codes_vs_b1(model, flat, wspec)
    del res, model, flat
    _free(dev)
    return dict(phase='export_symmetric', config=EXPORT_CONFIGS[name][0],
                weight=config['quant']['weight'],
                layers=cfg_kw['num_hidden_layers'],
                width=cfg_kw['hidden_size'],
                worst_err_over_fp16_bound=worst, codes_vs_b1=mism,
                ok=bool(worst <= 1.0 and not (mism['codes'] or mism['zeros']
                                              or mism['scales'])))


def host_copy(model, layers):
    """The model's first ``layers`` blocks (and its embedding, norm and
    head) copied to the CPU, in their dtype."""
    cfg = dataclasses.replace(model.cfg, num_hidden_layers=layers)
    params = dict(model.params, blocks=[model.blocks[i]
                                        for i in range(layers)])
    return type(model)(cfg, tree_to(params, 'cpu'))


def checkpoint_vs(got, want) -> dict:
    """Every tensor of ``want`` (the CPU's) against ``got`` (the card's):
    missing names, dtype or shape mismatches, and the elements that differ
    in their bytes; the JSON files equal but for ``num_hidden_layers``."""
    n = dict(tensors=0, missing=[], layout=[], elements_differ=0,
             json_differ=[])
    for fn, w in want.items():
        g = got.get(fn)
        if fn.endswith('.json'):
            def depthless(d):
                return {k: v for k, v in (d or {}).items()
                        if k != 'num_hidden_layers'}
            if depthless(g) != depthless(w):
                n['json_differ'].append(fn)
            continue
        for name, t in w.items():
            n['tensors'] += 1
            if g is None or name not in g:
                n['missing'].append(name)
                continue
            c = g[name]
            if (c.dtype, tuple(c.shape)) != (t.dtype, tuple(t.shape)):
                n['layout'].append(name)
                continue
            u = t.view(torch.uint8).reshape(t.numel(), -1)
            n['elements_differ'] += int(
                (c.view(torch.uint8).reshape(c.numel(), -1) != u)
                .any(-1).sum())
    return n


def phase21_writers(dev, cfg_kw=None, names=WRITERS,
                    cpu_layers=WRITER_CPU_LAYERS, **sizes):
    """Each writer of ``names`` at ``cfg_kw``'s width (2 layers, or the
    depth ``WRITER_LAYERS`` sets) through ``run_pipeline`` on the card,
    its checkpoint held to what the port writes on the CPU from the same
    compressed weights (the first ``cpu_layers`` blocks copied there):
    names, dtypes and shapes equal, every byte equal."""
    from llmc_tpu_torch.export import export_backends, read_checkpoint
    from llmc_tpu_torch.main import run_pipeline
    cfg_kw = cfg_kw or dict(LLAMA2_7B, num_hidden_layers=2)
    for name in names:
        layers, why = WRITER_LAYERS.get(name, (cfg_kw['num_hidden_layers'],
                                               None))
        kw = dict(cfg_kw, num_hidden_layers=min(
            layers, cfg_kw['num_hidden_layers']))
        with scratch_dir() as out, scratch_dir() as cpu_out:
            config = export_config(kw, name, out, **sizes)
            res = run_pipeline(config, device=dev)
            card = read_checkpoint(out)
            t0 = time.perf_counter()
            cpu_model = host_copy(res['model'], min(cpu_layers,
                                                    kw['num_hidden_layers']))
            export_backends(cpu_model, res['opt'],
                            dict(config['save'], save_path=cpu_out))
            cpu = read_checkpoint(cpu_out)
            cpu_s = time.perf_counter() - t0
            written = dir_bytes(out)
        vs = checkpoint_vs(card, cpu)
        times = res['phase_times']
        del res, cpu_model, card, cpu
        _free(dev)
        yield dict(phase='writer', name=name, config=EXPORT_CONFIGS[name][0],
                   quant=config['quant'], save=config['save'],
                   layers=kw['num_hidden_layers'], depth_cut=why,
                   width=kw['hidden_size'], cpu_layers=cpu_layers,
                   save_s=times['save'], phase_times_s=times,
                   bytes_written=written, cpu_s=cpu_s, vs_cpu=vs,
                   ok=bool(vs['tensors'] and not (
                       vs['missing'] or vs['layout'] or vs['json_differ']
                       or vs['elements_differ'])))


def offload_config(cfg_kw, layers, offload, out, seed=0, n_samples=4,
                   seq_len=512, eval_kw=OFFLOAD_EVAL):
    """RTN W4 g128 (the main path's symmetric grid, packed for vLLM) on a
    random Llama of ``cfg_kw`` at ``layers``, its blocks in host memory
    with ``offload``; a PPL entry with ``inference_per_block`` at pretrain
    and fake_quant; ``save_vllm`` into ``out``."""
    return dict(
        base=dict(seed=seed),
        model=dict(type='Llama', seed=seed, offload=offload,
                   arch=dict(cfg_kw, num_hidden_layers=layers)),
        calib=dict(name='synthetic', n_samples=n_samples, bs=-1,
                   seq_len=seq_len, seed=seed,
                   vocab_size=cfg_kw['vocab_size']),
        eval=dict(name='synthetic', vocab_size=cfg_kw['vocab_size'],
                  inference_per_block=True,
                  eval_pos=['pretrain', 'fake_quant'], **eval_kw),
        quant=dict(method='RTN', weight=dict(
            bit=4, symmetric=True, granularity='per_group', group_size=128,
            need_pack=True)),
        save=dict(save_vllm=True, save_path=out))


def tree_bytes(tree) -> int:
    from llmc_tpu_torch.export.exporter import leaf_paths
    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree))


def transfer_times(dev, host_block, reps=3) -> dict:
    """Seconds to upload one host block (pinned, ``non_blocking``) and to
    take it back to pinned host memory, the least of ``reps``, beside one
    plain pinned copy of the same bytes each way (the link's rate)."""
    from llmc_tpu_torch.utils.offload import tree_to_device, tree_to_host
    nbytes = tree_bytes(host_block)
    up, down = [], []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        blk = tree_to_device(host_block, dev)
        _sync(dev)
        t1 = time.perf_counter()
        tree_to_host(blk, pin=dev.type == 'cuda')
        _sync(dev)
        up.append(t1 - t0)
        down.append(time.perf_counter() - t1)
        del blk
    flat = torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=dev.type == 'cuda')
    link_up, link_down = [], []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        d = flat.to(dev, non_blocking=True)
        _sync(dev)
        t1 = time.perf_counter()
        flat.copy_(d)
        _sync(dev)
        link_up.append(t1 - t0)
        link_down.append(time.perf_counter() - t1)
        del d
    return dict(block_bytes=nbytes, upload_s=min(up), download_s=min(down),
                link_up_bytes_per_s=nbytes / min(link_up),
                link_down_bytes_per_s=nbytes / min(link_down),
                upload_over_link=min(up) / min(link_up),
                download_over_link=min(down) / min(link_down))


def phase21_offload(dev, cfg_kw=LLAMA2_70B, layers=OFFLOAD_LAYERS[0],
                    check_layers=OFFLOAD_CHECK_LAYERS, **sizes):
    """``model.offload`` at ``cfg_kw``'s widths through ``run_pipeline``
    (RTN, the per-block PPL at pretrain and fake_quant, ``save_vllm``) at
    ``layers`` and at ``check_layers``, and at ``check_layers`` resident:
    the run's own device peak (over what was allocated at its start) flat
    in depth (within ``PEAK_FLAT``), the offloaded PPLs within
    ``TOL_OFFLOAD_PPL`` of the resident ones and the written tensors
    equal; the seconds to upload and take back one block beside
    the link's rate, and the seconds of each pipeline phase."""
    from llmc_tpu_torch.export import read_checkpoint
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    cuda = dev.type == 'cuda'
    runs, files = {}, {}
    for key, n, offload in (('resident', check_layers, False),
                            ('offload_check', check_layers, True),
                            ('offload', layers, True)):
        with scratch_dir() as out:
            _free(dev)
            start = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
                start = torch.cuda.memory_allocated(dev)
            reset_launch_counts()
            res = run_pipeline(offload_config(cfg_kw, n, offload, out,
                                              **sizes), device=dev)
            counts, xla = read_counts()
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            runs[key] = dict(
                layers=n, offload=offload, peak_bytes=peak,
                allocated_at_start_bytes=start if cuda else None,
                # the run's own peak: what it allocated over what earlier
                # phases still hold
                own_peak_bytes=peak - start if cuda else None,
                ppl_pretrain=res['ppl_pretrain'],
                ppl_fake_quant=res['ppl_fake_quant'],
                phase_times_s=res['phase_times'], bytes_written=dir_bytes(out),
                launches=counts, xla_branch_calls=xla)
            if key != 'offload':
                files[key] = read_checkpoint(out)
        if key == 'offload':
            model = res['model']
            host = model.params['blocks'].host(0)
            runs[key]['blocks_bytes'] = sum(
                tree_bytes(model.params['blocks'].host(i))
                for i in range(model.n_blocks))
            runs[key]['resident_bytes'] = tree_bytes(
                {k: v for k, v in model.params.items() if k != 'blocks'})
            runs[key]['pinned'] = bool(
                host['self_attn']['q_proj']['w'].is_pinned())
            moves = transfer_times(dev, host)
            del model, host
        del res
    _free(dev)
    vs = checkpoint_vs(files['offload_check'], files['resident'])
    r, c, o = runs['resident'], runs['offload_check'], runs['offload']
    ppl_rel = max(abs(c[k] - r[k]) / r[k]
                  for k in ('ppl_pretrain', 'ppl_fake_quant'))
    peak_rel = abs(o['own_peak_bytes'] - c['own_peak_bytes']) \
        / c['own_peak_bytes'] if cuda else None
    return dict(phase='offload', source='meta-llama/Llama-2-70b-hf '
                'config.json', width=cfg_kw['hidden_size'],
                intermediate=cfg_kw['intermediate_size'],
                depth_cut=dict(layers=layers, of=cfg_kw['num_hidden_layers'],
                               reason=OFFLOAD_LAYERS[1]),
                eval=OFFLOAD_EVAL, runs=runs, transfers=moves,
                peak_rel_8_vs_2=peak_rel, tolerance_peak=PEAK_FLAT,
                ppl_rel_offload_vs_resident=ppl_rel,
                tolerance_ppl=TOL_OFFLOAD_PPL, written_vs_resident=vs,
                ok=bool(ppl_rel <= TOL_OFFLOAD_PPL
                        and (not cuda or peak_rel <= PEAK_FLAT)
                        and (not cuda or o['pinned'])
                        and vs['tensors'] and not (
                            vs['missing'] or vs['layout']
                            or vs['elements_differ'] or vs['json_differ'])
                        and all(not any(x['launches'].values())
                                and x['xla_branch_calls'] == 0
                                for x in runs.values())))


def phase21_code_eval(dev, cfg_kw=None, max_new_tokens=None,
                      problems=CODE_PROBLEMS):
    """``eval/code.py``'s HumanEval on a random float32 Llama of
    ``cfg_kw`` (Llama-2-7B's widths at ``CODE_EVAL``'s depth) under RTN's
    W4 g128 fake-quant QMap, on a problems file of two tasks with the byte
    tokenizer: ``samples.jsonl`` holds both tasks, its completions equal
    the CPU port's on the same weights (there baked once: RTN's weight
    qdq is a function of the weight alone), and so do the generated token
    ids (the byte tokenizer maps ids 128 apart to one character, and the
    stop strings cut the text), and B2 launched once a layer a decode
    step."""
    from llmc_tpu_torch.eval.code import HumanEval
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.models.adapter import QMap
    from llmc_tpu_torch.models.base import LinearQcfg, get_path, set_path
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight
    cfg_kw = cfg_kw or dict(LLAMA2_7B, num_hidden_layers=CODE_EVAL['layers'],
                            dtype='float32')
    new = max_new_tokens or CODE_EVAL['max_new_tokens']
    cfg = LlamaConfig(**cfg_kw)
    model = LlamaAdapter.random(cfg, seed=0, device=dev)
    model.tokenizer = ByteTokenizer()
    wspec = _wspec(4)
    layout = model.get_layout()
    qmap = QMap({p: LinearQcfg(w_spec=wspec) for p in layout.linears})
    samples = {}
    with scratch_dir() as root:
        path = os.path.join(root, 'problems.jsonl')
        with open(path, 'w') as f:
            f.writelines(json.dumps(p) + '\n' for p in problems)
        reset_launch_counts()
        t0 = time.perf_counter()
        card_eval = HumanEval(path, max_new_tokens=new,
                              res_path=os.path.join(root, 'card'))
        res = card_eval.eval(model, qmap)
        card_s = time.perf_counter() - t0
        counts, xla = read_counts()
        cpu = LlamaAdapter(cfg, tree_to(model.params, 'cpu'))
        del model
        _free(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(cpu.n_blocks):
                blk = cpu.blocks[i]
                for p in layout.linears:
                    lin = get_path(blk, p)
                    blk = set_path(blk, p, dict(
                        lin, w=fake_quant_weight(wspec, lin['w'])))
                cpu.set_block(i, blk)
        cpu.tokenizer = ByteTokenizer()
        cpu_eval = HumanEval(path, max_new_tokens=new,
                             res_path=os.path.join(root, 'cpu'))
        cpu_eval.eval(cpu)
        cpu_s = time.perf_counter() - t0
        for name in ('card', 'cpu'):
            with open(os.path.join(root, name, 'samples.jsonl')) as f:
                samples[name] = [json.loads(ln) for ln in f]
    # per task, the positions where the card's ids leave the CPU's
    cpu_ids = cpu_eval.token_ids
    ids_differ = {t: [i for i, (a, b) in enumerate(zip(ids, cpu_ids[t]))
                      if a != b]
                  for t, ids in card_eval.token_ids.items()
                  if ids != cpu_ids[t]}
    steps = sum(new - 1 for _ in problems)
    expected = dict.fromkeys(counts, 0)
    if attention_kernel_takes(cfg):
        expected['flash_decode'] = cfg.num_hidden_layers * steps
    return dict(phase='code_eval', layers=cfg.num_hidden_layers,
                width=cfg.hidden_size, dtype=cfg_kw['dtype'],
                max_new_tokens=new, tasks=[p['task_id'] for p in problems],
                result_keys=sorted(res), samples=samples['card'],
                completions_equal_cpu=samples['card'] == samples['cpu'],
                token_ids=card_eval.token_ids, token_ids_differ=ids_differ,
                card_s=card_s, cpu_s=cpu_s, launches=counts,
                expected_launches=expected, xla_branch_calls=xla,
                ok=bool(samples['card'] == samples['cpu'] and not ids_differ
                        and [s['task_id'] for s in samples['card']]
                        == [p['task_id'] for p in problems]))


def phase21(dev):
    """Every record of phase 21, in its order (a generator: each record
    is emitted and checked before the next part runs)."""
    yield phase21_export(dev)
    yield phase21_symmetric(dev)
    yield from phase21_writers(dev)
    yield phase21_offload(dev)
    yield phase21_code_eval(dev)


def phase21_failure(rec) -> dict:
    """The fields of a phase-21 record that its ``ok`` reads, for the
    failure's message."""
    keys = ('codes_vs_b1', 'file_vs_b1', 'pipeline_launches',
            'worst_err_over_fp16_bound', 'vs_cpu', 'runs',
            'peak_rel_8_vs_2', 'ppl_rel_offload_vs_resident',
            'written_vs_resident', 'samples', 'completions_equal_cpu',
            'token_ids_differ')
    return {k: rec[k] for k in keys if k in rec}


# --------------------------------------------------------------------------
# phase 22: the LLaVA tier and ViT
# --------------------------------------------------------------------------

# LLaVA-1.5-7B (llava-hf/llava-1.5-7b-hf config.json): the CLIP
# ViT-L/14-336 tower, a 1024 -> 4096 -> 4096 GELU projector and the
# Llama-2-7B LM with its 32064-token vocab, image token 32000
CLIP_L14 = dict(hidden_size=1024, intermediate_size=4096,
                num_hidden_layers=24, num_attention_heads=16)
LLAVA15_7B = dict(text=dict(LLAMA2_7B, vocab_size=32064), vision=CLIP_L14,
                  image_size=336, patch_size=14, image_token_index=32000)
LLAVA_SOURCE = 'llava-hf/llava-1.5-7b-hf config.json'
# the serve shape: 8 prompts of an image and 32 text tokens, 64 new tokens;
# the card against the CPU at 2 LM layers, one prompt, 8 new tokens
VLM_SERVE = dict(batch=8, text_tokens=32, new_tokens=64, cpu_layers=2,
                 cpu_new_tokens=8)
# configs/sparsification/token_reduction/{visionzip,fastv,dycoke}.yml
VISIONZIP = dict(method='VisionZip', dominant=54, contextual=10)
FASTV = dict(method='FastV', prune_layer=2, keep=144)
FASTV_LAYERS = (3, 'FastV ranks the image tokens by block 2\'s attention: '
                   'the shallowest LM that prunes holds 3 blocks')
DYCOKE = dict(method='DyCoke', merging_ratio=0.3)
# Video-LLaVA: the same tower at 224 pixels (256 patches a frame) x 8
# frames, cut in LM depth; its check against the CPU also in tower depth
VIDEOLLAVA = dict(image_size=224, num_frames=8, video_token_index=32001)
VIDEOLLAVA_LAYERS = (4, 'phase 22 has 120 s: 4 LM layers carry DyCoke\'s '
                        'shrunk span through the LM')
VIDEOLLAVA_CPU = dict(layers=2, tower_layers=(
    4, 'the 24-layer tower over 8 frames is 2.5 TFLOP on the CPU: 4 of its '
       'layers, the select layer -2 their third'))
# ViT-B/16 (google/vit-base-patch16-224 config.json), float32 as the
# repository's vit_rtn_w8a8.yml loads it
VIT_B16 = dict(image_size=224, patch_size=16, hidden_size=768,
               intermediate_size=3072, num_hidden_layers=12,
               num_attention_heads=12, num_labels=1000)
VIT_SOURCE = 'google/vit-base-patch16-224 config.json'
VIT_RUN = dict(images=64, calib_images=4, cpu_layers=2, cpu_images=16)
# the vqa eval of vlm_compress: 4 synthetic_vlm samples, 3 answer tokens
VLM_COMPRESS = dict(samples=4, answer_tokens=3, calib_samples=2)
W8_CHANNEL = dict(bit=8, symmetric=True, granularity='per_channel')
W4_G128 = dict(bit=4, symmetric=False, granularity='per_group',
               group_size=128)
CPU = torch.device('cpu')
# the card against the CPU in float32: the largest logit error over the
# largest logit (a token's top-k selections must agree for the spans to)
TOL_VLM_VS_CPU = 1e-3


def llava_model(dev, spec=LLAVA15_7B, layers=None, tower_layers=None,
                dtype=BF16, seed=0, video=None):
    """A random Llava (``video``: a VideoLlava with those fields) at
    ``spec``'s widths in ``dtype``, tower and LM alike; ``layers`` /
    ``tower_layers`` cut the depths."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.models import llava as LV
    from llmc_tpu_torch.models.adapter import (LlavaAdapter,
                                               VideoLlavaAdapter)
    dt = str(dtype).replace('torch.', '')
    text = dict(spec['text'], dtype=dt)
    if layers:
        text['num_hidden_layers'] = layers
    v = dict(spec['vision'])
    if tower_layers:
        v['num_hidden_layers'] = tower_layers
    vcfg = dataclasses.replace(LV.LlavaConfig.clip_block_cfg(
        v['hidden_size'], v['intermediate_size'], v['num_hidden_layers'],
        v['num_attention_heads']), dtype=dt)
    extra = {k: spec[k] for k in ('image_size', 'patch_size',
                                  'image_token_index')}
    extra.update(video or {})
    cfg = LV.LlavaConfig(text=LlamaConfig(**text), vision=vcfg, **extra)
    return (VideoLlavaAdapter if video else LlavaAdapter).random(
        cfg, seed=seed, device=dev)


def vlm_copy(model, device, dtype=F32, layers=None, tower_layers=None):
    """The model's first ``layers`` LM blocks and ``tower_layers`` tower
    blocks (default all) with everything else, copied to ``device`` in
    ``dtype``: a float32 twin for the card-against-CPU checks (any VLM
    adapter: its ``vl_cfg``)."""
    cfg = model.vl_cfg
    text, vision = cfg.text, cfg.vision
    dt = str(dtype).replace('torch.', '')
    text = dataclasses.replace(text, dtype=dt, num_hidden_layers=(
        layers or text.num_hidden_layers))
    vision = dataclasses.replace(vision, dtype=dt, num_hidden_layers=(
        tower_layers or vision.num_hidden_layers))
    p = model.params
    params = dict(p, blocks=p['blocks'][:text.num_hidden_layers],
                  vision=dict(p['vision'], blocks=p['vision']['blocks'][
                      :vision.num_hidden_layers]))
    return type(model)(dataclasses.replace(cfg, text=text, vision=vision),
                       tree_to(params, device, dtype))


def vlm_prompts(cfg, B, text_tokens, seed=0, video=False):
    """Ids [B, 1 + span + text_tokens] (BOS, the image or video span, text
    ids below the image token) and the pixels, numpy."""
    rng = np.random.RandomState(seed)
    span = cfg.image_seq_length * (cfg.num_frames if video else 1)
    ids = rng.randint(1, cfg.image_token_index, (B, 1 + span + text_tokens))
    ids[:, 1:1 + span] = (cfg.video_token_index if video
                          else cfg.image_token_index)
    shape = ((B, cfg.num_frames) if video else (B,)) + (
        3, cfg.image_size, cfg.image_size)
    return ids, rng.randn(*shape).astype(np.float32)


def vlm_fake_quant_twin(model, wspec):
    """The VLM with its LM under RTN's fake-quant QMap of ``wspec`` and
    its head's weight fake-quantized onto the grid packing gives it
    (``fake_quant_twin``'s, the tower left as it is): (twin, its QMap)."""
    from llmc_tpu_torch.models.adapter import QMap
    from llmc_tpu_torch.models.base import LinearQcfg
    from llmc_tpu_torch.quant.quantizer import fake_quant_weight_static
    from llmc_tpu_torch.serve.packed import packed_grid
    head = model.params['lm_head']
    fq = dict(head, w=fake_quant_weight_static(wspec, head['w'],
                                               packed_grid(head, wspec)))
    twin = type(model)(model.vl_cfg, dict(model.params, lm_head=fq))
    twin.set_modality('language')
    return twin, QMap({p: LinearQcfg(w_spec=wspec)
                       for p in twin.get_layout().linears})


def vlm_prefill_logits(model, ids, px, qmap, token_reduction=None):
    """Every position's f32 logits of the cached prefill (fp cache)."""
    from llmc_tpu_torch.serve.decode import FP_POLICY, forward_cached
    dev = model.device
    embeds, ids2 = model.prefill_embeds(
        torch.as_tensor(ids, device=dev), qmap=qmap,
        pixel_values=torch.as_tensor(px, device=dev),
        token_reduction=token_reduction)
    cfg = model.lm_cfg
    cache = FP_POLICY.init_cache(ids2.shape[0], ids2.shape[1],
                                 cfg.num_key_value_heads, cfg.head_dim,
                                 cfg.num_hidden_layers, dtype=cfg.tdtype,
                                 device=dev)
    return forward_cached(model.params, cfg, None, cache, FP_POLICY, qmap,
                          input_embeds=embeds)[0].float()


def vlm_expected_launches(L, decode_steps, attn, prefills=1):
    """What one ``vlm_greedy_generate`` of a packed LM counts: B1 (4L + 1)
    a forward over its prefills and counted decode steps, B2 (``auto``)
    or B5 (``batch``) once a layer a counted decode step (the prefill's
    attention is no kernel's).  On the card a captured decode counts two
    steps (its eager first run and its capture), a replay none."""
    n = dict.fromkeys(KERNEL_NAMES, 0)
    n['w4_dequant_matmul'] = (4 * L + 1) * (prefills + decode_steps)
    n['batch_decode' if attn == 'batch' else 'flash_decode'] = \
        L * decode_steps
    return n


def _generate(model, ids, px, G, qmap, policy, graph, tr=None):
    """One ``vlm_greedy_generate`` with its timings, launches and XLA
    branch calls."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve.decode import vlm_greedy_generate
    dev = model.device
    t = {}
    reset_launch_counts()
    out = vlm_greedy_generate(model, ids, G, qmap=qmap, kv_policy=policy,
                              token_reduction=tr, timings=t, graph=graph,
                              device=dev,
                              pixel_values=torch.as_tensor(px, device=dev))
    counts, xla = read_counts()
    return out.cpu(), t, counts, xla


def phase22_serve(dev, peaks, spec=LLAVA15_7B, layers=None, serve=VLM_SERVE,
                  group_size=128, seed=0):
    """LLaVA-1.5-7B served: its LM packed W4A16 g128 (fused qkv / gate_up,
    the head packed), an int8 cache, 8 prompts of an image and 32 text
    tokens, 64 greedy tokens through ``vlm_greedy_generate`` under
    ``auto`` (B2) and ``batch`` (B5): the captured decode's tokens equal
    to the eager decode's, the launches the path implies, the tower +
    projector ms, TTFT and the replayed step's ms beside its byte bound;
    the packed prefill logits against the fake-quant model's; VisionZip
    served through the same cached path (576 image tokens to 64); and
    the card against the CPU port at ``cpu_layers`` LM layers in float32."""
    from llmc_tpu_torch.serve import KVCachePolicy, pack_model
    from llmc_tpu_torch.serve.decode import vlm_greedy_generate
    wspec = dataclasses.replace(_wspec(4, group_size), symmetric=False)
    model = llava_model(dev, spec, layers, seed=seed)
    cfg = model.llava_cfg
    L = cfg.text.num_hidden_layers
    B, G = serve['batch'], serve['new_tokens']
    ids, px = vlm_prompts(cfg, B, serve['text_tokens'], seed)
    rec = dict(phase='vlm_serve', source=LLAVA_SOURCE, layers=L,
               tower_layers=cfg.vision.num_hidden_layers,
               image_tokens=cfg.image_seq_length, batch=B,
               prompt=ids.shape[1], new_tokens=G,
               weights='random, seed 0, bf16; LM packed W4A16 g128 '
                       '(asymmetric), fused qkv / gate_up, head packed',
               kv_cache='naive int8')
    # the card-against-CPU twins, before packing replaces the LM's weights
    c = serve['cpu_layers']
    twins = [vlm_copy(model, d, F32, layers=c) for d in (dev, CPU)]
    with torch.no_grad():
        one = ids[:1], px[:1]
        twin, fq_map = vlm_fake_quant_twin(model, wspec)
        want = vlm_prefill_logits(twin, *one, fq_map)
        del twin
        qmap = pack_model(model, wspec, fuse=True, head=True)
        got = vlm_prefill_logits(model, *one, qmap)
        err, rel = _rel(got, want)
        rec['packed_vs_fake_quant'] = dict(
            prompt=one[0].shape[1], max_abs_logit_err=err,
            rel_logit_err=rel, tolerance=TOL_COMPRESS_SERVE,
            argmax_agreement=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))
        del got, want
        # the tower and projector alone, B images (warm, then timed)
        pxt = torch.as_tensor(px, device=dev)
        idt = torch.as_tensor(ids, device=dev)
        model.prefill_embeds(idt, pixel_values=pxt)
        _sync(dev)
        t0 = time.perf_counter()
        model.prefill_embeds(idt, pixel_values=pxt)
        _sync(dev)
        rec['tower_projector_ms'] = (time.perf_counter() - t0) * 1e3
        policy = KVCachePolicy(method='naive', bit=8)
        runs = {}
        for attn in ('auto', 'batch'):
            with attn_impl(attn):
                g_out, t, g_counts, g_xla = _generate(model, ids, px, G, qmap,
                                                      policy, None)
                e_out, _, e_counts, e_xla = _generate(model, ids, px, G, qmap,
                                                      policy, False)
            graphed = dev.type == 'cuda'
            runs[attn] = dict(
                tokens_equal_eager=bool(torch.equal(g_out, e_out)),
                timings_s=t, ttft_ms=(t['embeds_s'] + t['prefill_s']) * 1e3,
                step_ms=((t['decode_s'] - t['decode_first_s'])
                         / max(G - 2, 1) * 1e3),
                graph=dict(launches=g_counts, xla_branch_calls=g_xla,
                           expected_launches=vlm_expected_launches(
                               L, 2 if graphed else G - 1, attn)),
                eager=dict(launches=e_counts, xla_branch_calls=e_xla,
                           expected_launches=vlm_expected_launches(
                               L, G - 1, attn)))
        rec['runs'] = runs
        rec.update(family_step_bound(model, peaks, B=B,
                                     prompt=ids.shape[1] + G // 2))
        # VisionZip through the same cached path: the span shrinks
        with attn_impl('auto'):
            z_out, zt, z_counts, z_xla = _generate(model, ids, px, G, qmap,
                                                   policy, None, VISIONZIP)
            z_eager = _generate(model, ids, px, G, qmap, policy, False,
                                VISIONZIP)[0]
        span = z_out.shape[1] - G - (ids.shape[1] - cfg.image_seq_length)
        rec['visionzip'] = dict(
            config=VISIONZIP, image_tokens_before=cfg.image_seq_length,
            image_tokens_after=span,
            tokens_equal_eager=bool(torch.equal(z_out, z_eager)),
            ttft_ms=(zt['embeds_s'] + zt['prefill_s']) * 1e3,
            launches=z_counts, xla_branch_calls=z_xla,
            expected_launches=vlm_expected_launches(
                L, 2 if dev.type == 'cuda' else G - 1, 'auto'))
        # the card against the CPU: float32, cpu_layers LM layers, 1 prompt
        toks = []
        for tw in twins:
            tq = pack_model(tw, wspec, fuse=True, head=True)
            toks.append(vlm_greedy_generate(
                tw, ids[:1], serve['cpu_new_tokens'], qmap=tq,
                kv_policy=policy, device=tw.device,
                pixel_values=torch.as_tensor(px[:1], device=tw.device)).cpu())
        del twins
    rec['vs_cpu'] = dict(layers=c, dtype='float32', batch=1,
                         new_tokens=serve['cpu_new_tokens'],
                         tokens_equal=bool(torch.equal(*toks)))
    rec['ok'] = bool(
        rel <= TOL_COMPRESS_SERVE and rec['vs_cpu']['tokens_equal']
        and all(r['tokens_equal_eager'] for r in runs.values())
        and rec['visionzip']['tokens_equal_eager']
        and span == VISIONZIP['dominant'] + VISIONZIP['contextual'])
    return rec, model


def _logits_vs_cpu(card, cpu):
    err, rel = _rel(card.cpu().float(), cpu.float())
    return dict(max_abs_logit_err=err, rel_logit_err=rel,
                same_shape=card.shape == cpu.shape,
                last_argmax_equal=bool(torch.equal(
                    card.cpu()[:, -1].argmax(-1), cpu[:, -1].argmax(-1))),
                tolerance=TOL_VLM_VS_CPU)


def phase22_fastv(dev, model, prompt_tokens=32, layers=FASTV_LAYERS[0],
                  seed=0):
    """FastV (``fastv.yml``) in the eager forward at ``layers`` LM layers,
    float32: the card against the CPU port on the same weights (the same
    pruned length, logits within ``TOL_VLM_VS_CPU``)."""
    cfg = model.llava_cfg
    ids, px = vlm_prompts(cfg, 1, prompt_tokens, seed + 1)
    outs = []
    with torch.no_grad():
        for d in (dev, CPU):
            m = vlm_copy(model, d, F32, layers=layers)
            t0 = time.perf_counter()
            outs.append(m.forward_logits(
                torch.as_tensor(ids), pixel_values=torch.as_tensor(px),
                token_reduction=FASTV))
            _sync(d)
            outs.append((time.perf_counter() - t0) * 1e3)
            del m
    rec = dict(phase='vlm_fastv', source=LLAVA_SOURCE, config=FASTV,
               layers=layers, reduced=[f'{layers} of '
                                       f'{cfg.text.num_hidden_layers} LM '
                                       f'layers: {FASTV_LAYERS[1]}'],
               dtype='float32', prompt=ids.shape[1],
               pruned_length=outs[0].shape[1], card_ms=outs[1],
               cpu_ms=outs[3], vs_cpu=_logits_vs_cpu(outs[0], outs[2]))
    v = rec['vs_cpu']
    rec['ok'] = bool(v['same_shape'] and v['rel_logit_err'] <= TOL_VLM_VS_CPU
                     and rec['pruned_length'] == ids.shape[1]
                     - cfg.image_seq_length + FASTV['keep'])
    return rec


def vlm_compress_config(spec=LLAVA15_7B, layers=None, sizes=VLM_COMPRESS,
                        seed=0):
    """``run_pipeline``'s config of ``vlm_compress``: the tower RTN W8
    per-channel, the LM RTN W4 g128, the vqa eval on ``synthetic_vlm``."""
    text = dict(spec['text'])
    if layers:
        text['num_hidden_layers'] = layers
    span = (spec['image_size'] // spec['patch_size']) ** 2
    data = dict(name='synthetic_vlm', seq_len=1 + span + 32,
                vocab_size=spec['image_token_index'],
                image_token=spec['image_token_index'], image_seq_length=span,
                image_size=spec['image_size'], seed=seed)
    return dict(
        base=dict(seed=seed),
        model=dict(type='Llava', seed=seed, arch=dict(
            text, vision=dict(spec['vision'], dtype=text['dtype']),
            **{k: spec[k] for k in ('image_size', 'patch_size',
                                    'image_token_index')})),
        calib=dict(data, n_samples=sizes['calib_samples'], bs=1),
        eval=dict(data, type='vqa', n_samples=sizes['samples'], bs=1,
                  answer_tokens=sizes['answer_tokens'],
                  eval_pos=['pretrain', 'fake_quant']),
        quant=dict(vision=dict(method='RTN', weight=W8_CHANNEL),
                   language=dict(method='RTN', weight=W4_G128)))


def phase22_compress(dev, spec=LLAVA15_7B, layers=None, sizes=VLM_COMPRESS,
                     seed=0):
    """``run_pipeline`` over both modalities (the tower RTN W8, then the
    LM RTN W4 g128) with the vqa eval at pretrain and fake_quant: the
    pretrain accuracy 1.0 by construction, the fake-quant deploy a
    ``ModalQMap``, and the launches of its cached answers (B2 once a layer
    a counted decode step over the fp cache; no B1: fake-quant weights
    are no packed ones)."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.ops import reset_launch_counts
    config = vlm_compress_config(spec, layers, sizes, seed)
    L = config['model']['arch']['num_hidden_layers']
    reset_launch_counts()
    with attn_impl('auto'):
        res = run_pipeline(config, device=dev)
    counts, xla = read_counts()
    # a sample's decode steps; on the card its captured step counts two
    steps = sizes['answer_tokens'] - 1
    counted = (2 if steps else 0) if dev.type == 'cuda' else steps
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want['flash_decode'] = L * counted * sizes['samples'] * 2
    rec = dict(phase='vlm_compress', source=LLAVA_SOURCE, layers=L,
               quant='vision RTN W8 per-channel, language RTN W4 g128',
               eval=f'vqa on synthetic_vlm, {sizes["samples"]} samples, '
                    f'{sizes["answer_tokens"]} answer tokens',
               results={k: v for k, v in res.items()
                        if isinstance(v, (int, float))},
               phase_times=res['phase_times'], launches=counts,
               xla_branch_calls=xla, expected_launches=want)
    acc = res.get('vqa_fake_quant_acc')
    rec['ok'] = bool(res.get('vqa_pretrain_acc') == 1.0 and acc is not None
                     and 0.0 <= acc <= 1.0
                     and res['model'].modality == 'language')
    del res
    return rec


def phase22_videollava(dev, spec=LLAVA15_7B, layers=VIDEOLLAVA_LAYERS[0],
                       video=VIDEOLLAVA, cpu=VIDEOLLAVA_CPU,
                       prompt_tokens=32, seed=0):
    """Video-LLaVA: the tower at ``video['image_size']`` over 8 frames and
    ``layers`` LM layers in bf16, DyCoke (``dycoke.yml``) shrinking the
    video span in the eager forward (timed); then the card against the CPU
    port in float32 at ``cpu['layers']`` LM layers and
    ``cpu['tower_layers']`` tower layers (the same kept span, logits
    within ``TOL_VLM_VS_CPU``)."""
    spec = dict(spec, image_size=video['image_size'])
    vfields = {k: video[k] for k in ('num_frames', 'video_token_index')}
    model = llava_model(dev, spec, layers, seed=seed, video=vfields)
    cfg = model.llava_cfg
    ids, vids = vlm_prompts(cfg, 1, prompt_tokens, seed + 2, video=True)
    span = cfg.num_frames * cfg.image_seq_length
    with torch.no_grad():
        args = (torch.as_tensor(ids, device=dev),)
        kw = dict(pixel_values_videos=torch.as_tensor(vids, device=dev),
                  token_reduction=DYCOKE)
        model.forward_logits(*args, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        full = model.forward_logits(*args, pixel_values_videos=kw[
            'pixel_values_videos'])
        _sync(dev)
        t1 = time.perf_counter()
        red = model.forward_logits(*args, **kw)
        _sync(dev)
        t2 = time.perf_counter()
        tl = cpu['tower_layers'][0]
        outs = [vlm_copy(model, d, F32, layers=cpu['layers'],
                         tower_layers=tl).forward_logits(
            torch.as_tensor(ids), **dict(kw, pixel_values_videos=torch
                                         .as_tensor(vids))) for d in (dev,
                                                                      CPU)]
    keep = int((1 - DYCOKE['merging_ratio']) * cfg.image_seq_length)
    F_ = cfg.num_frames
    pruned = sum(1 for i in range(F_) if i % 2) + len(range(0, F_ - 4, 4))
    want_span = span - pruned * (cfg.image_seq_length - keep)
    kept = red.shape[1] - (ids.shape[1] - span)
    rec = dict(phase='videollava', source=LLAVA_SOURCE + ' (the Llava '
               'graph of Video-LLaVA-7B at 224 pixels)', layers=layers,
               reduced=[f'{layers} of {spec["text"]["num_hidden_layers"]} LM '
                        f'layers: {VIDEOLLAVA_LAYERS[1]}',
                        f'CPU check at {cpu["layers"]} LM and {tl} tower '
                        f'layers: {cpu["tower_layers"][1]}'],
               frames=F_, image_size=cfg.image_size,
               video_tokens=span, dycoke=DYCOKE, video_tokens_kept=kept,
               video_tokens_kept_expected=want_span,
               full_forward_ms=(t1 - t0) * 1e3,
               dycoke_forward_ms=(t2 - t1) * 1e3,
               full_length=full.shape[1], vs_cpu=_logits_vs_cpu(*outs))
    v = rec['vs_cpu']
    rec['ok'] = bool(kept == want_span and v['same_shape']
                     and v['rel_logit_err'] <= TOL_VLM_VS_CPU
                     and bool(torch.isfinite(red).all()))
    del model
    return rec


def vit_qmap():
    """RTN W8A8's fake-quant deploy on ViT (``vit_rtn_w8a8.yml`` with the
    quantized attention): W8 per-channel weights and per-token 8-bit
    activations on every linear, and the attention's pseudo-paths."""
    from llmc_tpu_torch.models import LinearQcfg, QMap
    from llmc_tpu_torch.quant import QuantSpec
    a = QuantSpec(bit=8, symmetric=True, granularity='per_token')
    lin = LinearQcfg(w_spec=QuantSpec(**W8_CHANNEL), a_spec=a)
    return QMap({p: LinearQcfg(a_spec=a) for p in (
        'attention.matmul_1', 'attention.matmul_2', 'attention.softmax',
        'act_fn')}, default=lin)


def phase22_vit(dev, arch=VIT_B16, run=VIT_RUN, seed=0):
    """ViT-B/16 at full depth (float32, random weights): ``run_pipeline``
    of RTN W8A8 with the quantized attention over the ``vision``
    modality and the ``acc`` eval on ``run['images']`` synthetic images
    (labels the pretrain model's predictions); then the card's W8A8
    predictions against the CPU port's at ``cpu_layers`` layers."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.models import VitAdapter
    from llmc_tpu_torch.ops import reset_launch_counts
    act = dict(bit=8, symmetric=True, granularity='per_token',
               quant_attn=True, quant_softmax=True, quant_act_fn=True)
    config = dict(
        base=dict(seed=seed), model=dict(type='Vit', arch=dict(arch),
                                         seed=seed),
        calib=dict(name='synthetic_img', n_samples=run['calib_images'],
                   bs=1, seed=seed, image_size=arch['image_size']),
        eval=dict(name='imagenet', n_samples=run['images'], bs=16,
                  eval_pos=['pretrain', 'fake_quant']),
        quant=dict(vision=dict(method='RTN', weight=W8_CHANNEL, act=act)))
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_pipeline(config, device=dev)
    wall = time.perf_counter() - t0
    counts, xla = read_counts()
    model = res['model']
    L = run['cpu_layers']
    cfg = dataclasses.replace(model.cfg, num_hidden_layers=L)
    px = np.random.RandomState(seed + 3).randn(
        run['cpu_images'], 3, arch['image_size'], arch['image_size']).astype(
        np.float32)
    # the float32 logits within TOL_VLM_VS_CPU; under W8A8 the card's other
    # summation order flips activation codes at their rounding edges, so
    # there the predictions are held equal and the logits' gap recorded
    logits = {}
    with torch.no_grad():
        for d in (dev, CPU):
            m = VitAdapter(cfg, tree_to(dict(model.params, blocks=model.params[
                'blocks'][:L]), d))
            for q in ('fp', 'w8a8'):
                logits.setdefault(q, []).append(m.classify(
                    px, qmap=vit_qmap() if q == 'w8a8' else None).cpu())
    err, rel = _rel(*logits['fp'])
    q_err, q_rel = _rel(*logits['w8a8'])
    rec = dict(phase='vit', source=VIT_SOURCE, layers=model.cfg
               .num_hidden_layers, dtype='float32',
               quant='RTN W8 per-channel, A8 per-token, quantized attention',
               images=run['images'], acc_pretrain=res['acc_pretrain'],
               acc_fake_quant=res['acc_fake_quant'], pipeline_s=wall,
               phase_times=res['phase_times'], launches=counts,
               xla_branch_calls=xla,
               expected_launches=dict.fromkeys(KERNEL_NAMES, 0),
               vs_cpu=dict(layers=L, images=run['cpu_images'],
                           max_abs_logit_err=err, rel_logit_err=rel,
                           tolerance=TOL_VLM_VS_CPU,
                           w8a8_predictions_equal=all(bool(torch.equal(
                               a.argmax(-1), b.argmax(-1)))
                               for a, b in logits.values()),
                           w8a8_max_abs_logit_err=q_err,
                           w8a8_rel_logit_err=q_rel))
    rec['ok'] = bool(res['acc_pretrain'] == 1.0
                     and 0.0 <= res['acc_fake_quant'] <= 1.0
                     and rec['vs_cpu']['w8a8_predictions_equal']
                     and rel <= TOL_VLM_VS_CPU)
    del res, model
    return rec


def phase22(dev, peaks):
    """Every record of phase 22, in its order (a generator: each record is
    emitted and checked before the next part runs)."""
    rec, model = phase22_serve(dev, peaks)
    yield rec
    del model
    _free(dev)
    unpacked = llava_model(dev)
    yield phase22_fastv(dev, unpacked)
    del unpacked
    _free(dev)
    yield phase22_compress(dev)
    _free(dev)
    yield phase22_videollava(dev)
    _free(dev)
    yield phase22_vit(dev)
    _free(dev)


def phase22_launch_checks(rec):
    """(name, launches, expected launches, XLA branch calls) of every run
    a phase-22 record counts, for ``require_launches`` (on the CPU no
    kernel launches: the tests read the predictions apart)."""
    subs = [(f'{rec["phase"]}.{attn}.{m}', run[m])
            for attn, run in rec.get('runs', {}).items()
            for m in ('graph', 'eager')]
    if 'visionzip' in rec:
        subs.append((f'{rec["phase"]}.visionzip', rec['visionzip']))
    if 'expected_launches' in rec:
        subs.append((rec['phase'], rec))
    return [dict(phase=name, launches=r['launches'],
                 expected_launches=r['expected_launches'],
                 xla_branch_calls=r['xla_branch_calls']) for name, r in subs]


def phase22_failure(rec) -> dict:
    """The fields of a phase-22 record that its ``ok`` reads, for the
    failure's message."""
    keys = ('packed_vs_fake_quant', 'runs', 'visionzip', 'vs_cpu',
            'pruned_length', 'results', 'launches', 'expected_launches',
            'video_tokens_kept', 'video_tokens_kept_expected',
            'acc_pretrain', 'acc_fake_quant')
    return {k: rec[k] for k in keys if k in rec}


# --------------------------------------------------------------------------
# phase 23: Qwen2-VL, InternVL, LLaVA-OneVision and MiniCPM-V
# --------------------------------------------------------------------------

# Qwen2-VL-7B-Instruct (Qwen/Qwen2-VL-7B-Instruct config.json): the
# 1280-wide 32-layer ViT with 2-D rope (patch 14, temporal patch 2), the
# 2x2 patch merger into 3584, the Qwen2-7B LM with M-RoPE (16, 24, 24)
QWEN2VL_7B = dict(
    text=dict(QWEN25_7B, max_position_embeddings=32768,
              rope_scaling_type='mrope'),
    vision=dict(hidden_size=1280, intermediate_size=5120,
                num_hidden_layers=32, num_attention_heads=16),
    mrope_section=(16, 24, 24), patch_size=14, temporal_patch_size=2,
    spatial_merge_size=2, image_token_id=151655,
    vision_start_token_id=151652)
QWEN2VL_SOURCE = 'Qwen/Qwen2-VL-7B-Instruct config.json'
# B = 4 prompts of a 448-pixel image (grid 1 x 32 x 32: 1024 patches, 256
# merged tokens) and 32 text tokens, one eager forward each (the
# reference's forward takes one image); text: 8 prompts of 32 tokens, 32
# greedy steps; the card against the CPU at 2 LM and 2 tower layers with
# a 1 x 8 x 8 grid
QWEN2VL_RUN = dict(batch=4, grid=(1, 32, 32), text_tokens=32, text_batch=8,
                   text_prompt=32, new_tokens=32, cpu_layers=2,
                   cpu_grid=(1, 8, 8))
# qwen2vl_awq_w4.yml's two quant sections at 4 LM and 4 tower layers
QWEN2VL_COMPRESS = dict(
    layers=(4, 'AWQ with clip v1 over 4 LM blocks and 4 tower blocks shows '
               'both modalities; the full-depth model runs in qwen2vl_serve'),
    samples=4, answer_tokens=3, calib_samples=2, grid=(32, 32),
    quant=dict(vision=dict(method='Awq', weight=dict(
        bit=8, symmetric=False, granularity='per_group', group_size=128),
        special=dict(trans=True, weight_clip=False)),
        language=dict(method='Awq', weight=dict(
            bit=4, symmetric=False, granularity='per_group', group_size=128),
            special=AWQ_SPECIAL)))
# InternVL3-8B-hf (OpenGVLab/InternVL3-8B-hf config.json): InternViT-300M
# (1024 wide, 24 layers, LayerNorm, layer scale, attention bias, 448
# pixels of 14), the pixel shuffle 0.5 (256 tokens of 4096), the projector
# LN -> 3584 -> GELU -> 3584 and the Qwen2.5-7B LM with 151674 tokens
INTERNVL3_8B = dict(
    text=dict(QWEN25_7B, vocab_size=151674),
    vision=dict(hidden_size=1024, intermediate_size=4096,
                num_hidden_layers=24, num_attention_heads=16),
    image_size=448, patch_size=14, image_token_id=151667,
    downsample_ratio=0.5)
INTERNVL_SOURCE = 'OpenGVLab/InternVL3-8B-hf config.json'
INTERNVL_LAYERS = (4, 'qwen2vl_serve runs the same LM widths at full depth')
# InternViT-6B-448px-V2_5's block (3200 wide, 25 heads, RMSNorm, the
# full-width qk-norm, no attention bias): 2 layers, f32, over a 224-pixel
# image's 257 tokens, the card against the CPU
INTERNVIT_6B = dict(hidden_size=3200, intermediate_size=12800, layers=2,
                    heads=25, tokens=257)
INTERNVIT_6B_SOURCE = 'OpenGVLab/InternViT-6B-448px-V2_5 config.json'
# LLaVA-OneVision-7B (llava-hf/llava-onevision-qwen2-7b-ov-hf config.json):
# SigLIP-so400m at 26 layers (1152 wide, gelu-tanh, 384 pixels of 14: 729
# patches), the projector 1152 -> 3584 -> 3584, anyres_max_9 over the 36
# pinpoints (384 i, 384 j), the Qwen2-7B LM with 152128 tokens
ONEVISION_7B = dict(
    text=dict(QWEN25_7B, vocab_size=152128, max_position_embeddings=32768),
    vision=dict(hidden_size=1152, intermediate_size=4304,
                num_hidden_layers=26, num_attention_heads=16),
    image_size=384, patch_size=14, image_token_index=151646,
    video_token_index=151647, vision_aspect_ratio='anyres_max_9',
    image_grid_pinpoints=tuple((384 * i, 384 * j) for i in range(1, 7)
                               for j in range(1, 7)))
ONEVISION_SOURCE = 'llava-hf/llava-onevision-qwen2-7b-ov-hf config.json'
ONEVISION_LAYERS = (4, 'qwen2vl_serve runs the Qwen2-7B widths at full '
                       'depth')
# a 768 x 768 image (the base crop and a 2 x 2 grid), 8 frames of video;
# the CI config's PruneVid (token_reduction_prunevid_onevision.yml) and
# dycoke.yml's DyCoke; the card against the CPU on 2 frames
ONEVISION_RUN = dict(image=(768, 768), frames=8, text_tokens=32,
                     cpu_layers=2, cpu_frames=2)
PRUNEVID = dict(method='PruneVid', taus=0.5, cluster_ratios=0.5,
                temporal_segment_ratios=0.34)
# MiniCPM-Llama3-V-2.5 (openbmb/MiniCPM-Llama3-V-2_5 config.json, the
# reference's MiniCPMVConfig defaults): SigLIP 1152 wide at 27 layers over
# one 448-pixel slice (1024 patches), the resampler's 96 queries into 4096,
# the Llama-3-8B LM
LLAMA3_8B_LM = dict(vocab_size=128256, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
                    max_position_embeddings=8192, dtype='bfloat16')
MINICPMV_25 = dict(
    text=LLAMA3_8B_LM,
    vision=dict(hidden_size=1152, intermediate_size=4304,
                num_hidden_layers=27, num_attention_heads=16),
    image_size=448, patch_size=14, num_queries=96,
    image_token_index=128244)
MINICPMV_SOURCE = 'openbmb/MiniCPM-Llama3-V-2_5 config.json'
MINICPMV_LAYERS = (4, 'the Llama-3-8B LM is the text families\' graph, '
                      'served at full depth in phase 19')
VLM2_CHECK = dict(prompts=1, text_tokens=32, cpu_layers=2)


def vlm2_model(dev, kind, spec, layers=None, tower_layers=None, dtype=BF16,
               seed=0):
    """A random ``kind`` (``Qwen2vl``, ``InternVL2``, ``LlavaOneVision`` or
    ``MiniCPMV``) at ``spec``'s widths in ``dtype``, tower and LM alike
    (MiniCPM-V's vision side float32, as the reference draws it);
    ``layers`` / ``tower_layers`` cut the depths."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.utils.registry import MODEL_REGISTRY
    cls = MODEL_REGISTRY[kind]
    dt = str(dtype).replace('torch.', '')
    text = dict(spec['text'], dtype=dt)
    if layers:
        text['num_hidden_layers'] = layers
    v = dict(spec['vision'], dtype=dt)
    if tower_layers:
        v['num_hidden_layers'] = tower_layers
    extra = {k: w for k, w in spec.items() if k not in ('text', 'vision')}
    cfg = cls.vl_config_cls(text=LlamaConfig(**text),
                            vision=cls._tower_cfg(v), **extra)
    return cls.random(cfg, seed=seed, device=dev)


def _forward(model, ids, img, qmap=None):
    """The model's eager forward, its image kwargs' arrays on its device."""
    dev = model.device
    kw = {k: (torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray)
              else v) for k, v in img.items()}
    return model.forward_logits(torch.as_tensor(ids, device=dev),
                                qmap=qmap, **kw)


def _timed(dev, fn):
    """(fn's value, its ms), synchronised."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def packed_eager(dev, model, prompts, wspec):
    """The VLM's LM against its fake-quant twin (``vlm_fake_quant_twin``),
    then packed W4A16 (fused qkv / gate_up, the head packed) in place:
    each ``(name, ids, img)`` of ``prompts`` through the eager forward of
    both, the packed one timed and counted (B1 4L + 1 times a forward,
    whatever its batch).  Returns (the serving QMap, {name: the prompt's
    record})."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.serve import pack_model
    L_ = model.cfg.num_hidden_layers
    out = {}
    with torch.no_grad():
        twin, fq_map = vlm_fake_quant_twin(model, wspec)
        wants = {n: _forward(twin, ids, img, fq_map).float().cpu()
                 for n, ids, img in prompts}
        del twin
        qmap, pack_ms = _timed(dev, lambda: pack_model(model, wspec,
                                                       fuse=True, head=True))
        for name, ids, img in prompts:
            _forward(model, ids, img, qmap)        # warm
            reset_launch_counts()
            got, ms = _timed(dev, lambda: _forward(model, ids, img, qmap))
            counts, xla = read_counts()
            err, rel = _rel(got.float().cpu(), wants[name])
            want = dict.fromkeys(KERNEL_NAMES, 0)
            want['w4_dequant_matmul'] = 4 * L_ + 1
            out[name] = dict(
                prompts=len(ids), prompt_tokens=int(ids.shape[1]),
                positions=int(got.shape[1]), forward_ms=ms,
                max_abs_logit_err=err, rel_logit_err=rel,
                tolerance=TOL_COMPRESS_SERVE,
                argmax_agreement=float((got.float().cpu().argmax(-1)
                                        == wants[name].argmax(-1)).float()
                                       .mean()),
                finite=bool(torch.isfinite(got).all()),
                launches=counts, xla_branch_calls=xla,
                expected_launches=want)
    out['pack_ms'] = pack_ms
    return qmap, out


def vlm2_vs_cpu(dev, model, ids, img, layers, tower_layers=None):
    """The model's first ``layers`` LM blocks (and ``tower_layers`` tower
    blocks) in float32 on the card and on the CPU: the same prompt's
    logits (``_logits_vs_cpu``)."""
    outs = []
    with torch.no_grad():
        for d in (dev, CPU):
            m = vlm_copy(model, d, F32, layers=layers,
                         tower_layers=tower_layers)
            outs.append(_forward(m, ids, img).cpu())
            del m
    return dict(layers=layers, tower_layers=tower_layers, dtype='float32',
                **_logits_vs_cpu(*outs))


def qwen2vl_prompts(cfg, B, grid, text_tokens, seed=0):
    """(ids [B, 2 + merged + text], B patch arrays [t*h*w, C*T*p*p]):
    each prompt a text token, ``vision_start``, the merged image span and
    text below the special tokens."""
    rng = np.random.RandomState(seed)
    t, h, w = grid
    m = t * h * w // cfg.spatial_merge_size ** 2
    ids = rng.randint(0, cfg.vision_start_token_id - 9,
                      (B, 2 + m + text_tokens))
    ids[:, 1] = cfg.vision_start_token_id
    ids[:, 2:2 + m] = cfg.image_token_id
    return ids, [rng.randn(t * h * w, cfg.patch_dim).astype(np.float32)
                 for _ in range(B)]


def phase23_qwen2vl(dev, peaks, spec=QWEN2VL_7B, run=QWEN2VL_RUN,
                    layers=None, tower_layers=None, group_size=128, seed=0,
                    timing_steps=8):
    """Qwen2-VL-7B at full depth: its LM packed W4A16 g128 (asymmetric,
    fused, the head packed); B prompts with an image through the eager
    forward (the tower + merger timed alone), their logits against the
    fake-quant model's; text prompts served from an int8 cache through the
    engine under ``auto`` (B2) and ``batch`` (B5), captured against eager,
    the captured step against its byte bound; the card against the CPU
    port at ``cpu_layers`` in float32."""
    from llmc_tpu_torch.models import qwen2vl as QV
    wspec = dataclasses.replace(_wspec(4, group_size), symmetric=False)
    model = vlm2_model(dev, 'Qwen2vl', spec, layers, tower_layers, seed=seed)
    cfg = model.vl_cfg
    L_ = cfg.text.num_hidden_layers
    grid = run['grid']
    ids, patches = qwen2vl_prompts(cfg, run['batch'], grid,
                                   run['text_tokens'], seed)
    c = run['cpu_layers']
    cids, cpatch = qwen2vl_prompts(cfg, 1, run['cpu_grid'],
                                   run['text_tokens'], seed + 1)
    vs_cpu = vlm2_vs_cpu(dev, model, cids, dict(
        pixel_patches=cpatch[0], grid_thw=run['cpu_grid']), c, c)
    rec = dict(phase='qwen2vl_serve', source=QWEN2VL_SOURCE, layers=L_,
               tower_layers=cfg.vision.num_hidden_layers, grid=grid,
               image_tokens=int((ids[0] == cfg.image_token_id).sum()),
               batch=run['batch'], prompt=int(ids.shape[1]),
               rope_scaling_type=cfg.text.rope_scaling_type,
               weights='random, seed 0, bf16; LM packed W4A16 g128 '
                       '(asymmetric), fused qkv / gate_up, head packed',
               vs_cpu=dict(vs_cpu, grid=run['cpu_grid']))
    prompts = [(f'image_{b}', ids[b:b + 1], dict(pixel_patches=patches[b],
                                                 grid_thw=grid))
               for b in range(run['batch'])]
    qmap, pre = packed_eager(dev, model, prompts, wspec)
    with torch.no_grad():
        px = [torch.as_tensor(p, device=dev) for p in patches]
        tower = [QV.vision_forward(model.params['vision'], cfg, p, grid)
                 for p in px]                                  # warm
        del tower
        _, rec['tower_merger_ms'] = _timed(dev, lambda: [
            QV.vision_forward(model.params['vision'], cfg, p, grid)
            for p in px])
    rec['pack_ms'] = pre.pop('pack_ms')
    rec['image_prefill'] = pre
    runs, times = {}, {}
    serve_kw = dict(n_requests=run['text_batch'], max_batch=run['text_batch'],
                    max_len=run['text_prompt'] + run['new_tokens'],
                    buckets=(run['text_prompt'],),
                    max_prompt=run['text_prompt'],
                    new_tokens=run['new_tokens'], fixed=True)
    for attn in ('auto', 'batch'):
        got = {mode: adapter_serve_run(dev, model, attn,
                                       eager=mode == 'eager', qmap=qmap,
                                       **serve_kw)
               for mode in ('graph', 'eager')}
        runs[attn] = dict(graph=got['graph'][0], eager=got['eager'][0],
                          tokens_equal=got['graph'][1] == got['eager'][1])
        times[attn] = moe_step_times(
            dev, model, attn, qmap=qmap, B=run['text_batch'],
            prompt=run['text_prompt'], steps=timing_steps,
            max_len=run['text_prompt'] + timing_steps + 4)
    rec.update(text_runs=runs, text_timing=times, **family_step_bound(
        model, peaks, B=run['text_batch'],
        prompt=run['text_prompt'] + timing_steps // 2))
    rec['ok'] = bool(
        all(r['rel_logit_err'] <= TOL_COMPRESS_SERVE and r['finite']
            for r in pre.values())
        and all(r['tokens_equal'] and r[m]['all_done']
                for r in runs.values() for m in ('graph', 'eager'))
        and vs_cpu['same_shape'] and vs_cpu['rel_logit_err'] <= TOL_VLM_VS_CPU
        and vs_cpu['last_argmax_equal'])
    return rec


def qwen2vl_compress_config(spec=QWEN2VL_7B, sizes=QWEN2VL_COMPRESS, seed=0):
    """``run_pipeline``'s config of ``qwen2vl_compress``: the two ``quant``
    sections of ``qwen2vl_awq_w4.yml``, calibration and the vqa eval on
    ``synthetic_qwen2vl``."""
    L_ = sizes['layers'][0]
    h, w = sizes['grid']
    merged = h * w // spec['spatial_merge_size'] ** 2
    data = dict(name='synthetic_qwen2vl', seq_len=2 + merged + 32,
                vocab_size=spec['vision_start_token_id'] - 9,
                image_token=spec['image_token_id'],
                vision_start_token=spec['vision_start_token_id'],
                grid_hw=[h, w], patch_dim=3 * spec['temporal_patch_size']
                * spec['patch_size'] ** 2, seed=seed)
    return dict(
        base=dict(seed=seed),
        model=dict(type='Qwen2vl', seed=seed, arch=dict(
            spec['text'], num_hidden_layers=L_,
            vision=dict(spec['vision'], num_hidden_layers=L_,
                        dtype=spec['text']['dtype']),
            **{k: spec[k] for k in ('patch_size', 'temporal_patch_size',
                                    'image_token_id',
                                    'vision_start_token_id',
                                    'mrope_section')})),
        calib=dict(data, n_samples=sizes['calib_samples'], bs=1),
        eval=dict(data, type='vqa', n_samples=sizes['samples'], bs=1,
                  answer_tokens=sizes['answer_tokens'],
                  eval_pos=['pretrain', 'fake_quant']),
        quant=sizes['quant'])


def phase23_qwen2vl_compress(dev, spec=QWEN2VL_7B, sizes=QWEN2VL_COMPRESS,
                             seed=0):
    """``run_pipeline`` of ``qwen2vl_awq_w4.yml``'s two sections (the tower
    AWQ W8 g128, then the LM AWQ W4 g128 with clip v1) with the vqa eval:
    the pretrain accuracy 1.0 by construction, and the fake-quant deploy a
    ``ModalQMap`` whose ``vision`` QMap is the tower's W8 and whose own is
    the LM's W4 (each tower takes only its own)."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.models import ModalQMap
    from llmc_tpu_torch.ops import reset_launch_counts
    config = qwen2vl_compress_config(spec, sizes, seed)
    reset_launch_counts()
    res = run_pipeline(config, device=dev)
    counts, xla = read_counts()
    dep = res['deploy']
    bits = {}
    if isinstance(dep, ModalQMap) and dep.vision is not None:
        bits = dict(vision=dep.vision.get('self_attn.q_proj').w_spec.bit,
                    language=dep.get('self_attn.q_proj').w_spec.bit)
    L_ = sizes['layers'][0]
    rec = dict(phase='qwen2vl_compress', source=QWEN2VL_SOURCE, layers=L_,
               tower_layers=L_, reduced=[
                   f'{L_} of {spec["text"]["num_hidden_layers"]} LM and {L_} '
                   f'of {spec["vision"]["num_hidden_layers"]} tower layers: '
                   f'{sizes["layers"][1]}'],
               quant='vision AWQ W8 g128, language AWQ W4 g128 + clip v1 '
                     '(configs/quantization/models/qwen2vl_awq_w4.yml)',
               eval=f'vqa on synthetic_qwen2vl, {sizes["samples"]} samples, '
                    f'{sizes["answer_tokens"]} answer tokens',
               results={k: v for k, v in res.items()
                        if isinstance(v, (int, float))},
               phase_times=res['phase_times'], deploy_bits=bits,
               launches=counts, xla_branch_calls=xla,
               expected_launches=dict.fromkeys(KERNEL_NAMES, 0))
    acc = res.get('vqa_fake_quant_acc')
    rec['ok'] = bool(res.get('vqa_pretrain_acc') == 1.0 and acc is not None
                     and 0.0 <= acc <= 1.0
                     and bits == dict(vision=8, language=4)
                     and res['model'].modality == 'language')
    del res
    return rec


def internvit_6b_vs_cpu(dev, spec=INTERNVIT_6B, seed=0):
    """InternViT-6B's blocks (RMSNorm, the full-width qk-norm, no attention
    bias, layer scale) in float32 on the card and on the CPU, the same
    random weights and tokens: the largest error over the largest
    output."""
    from llmc_tpu_torch.models import internvl as IV
    from llmc_tpu_torch.models import llama as L
    vc = IV.InternVLConfig.vit_block_cfg(
        spec['hidden_size'], spec['intermediate_size'], spec['layers'],
        spec['heads'], 'gelu', 'rms', True, False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = L.init_params(vc, gen, device=dev)['blocks']
    x = torch.randn((1, spec['tokens'], spec['hidden_size']), generator=gen,
                    device=dev)
    outs = []
    with torch.no_grad():
        for d in (dev, CPU):
            y = x.to(d)
            z = torch.zeros((1, 1, 1, 1), device=d)
            for bp in blocks:
                y = L.block_apply(tree_to(bp, d), vc, y, None, None,
                                  attn_bias=z)[0]
            outs.append(y.cpu())
    err, rel = _rel(outs[0], outs[1])
    return dict(source=INTERNVIT_6B_SOURCE, layers=spec['layers'],
                tokens=spec['tokens'], dtype='float32',
                q_norm_width=int(blocks[0]['self_attn']['q_norm']['w']
                                 .shape[0]),
                max_abs_err=err, rel_err=rel, tolerance=TOL_VLM_VS_CPU)


def vlm2_image_prompts(cfg, B, span, text_tokens, image_token, seed=0,
                       start=1):
    """Ids [B, start + span + text] with the image span at ``start``, text
    ids below the image token."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, image_token - 9, (B, start + span + text_tokens))
    ids[:, start:start + span] = image_token
    return ids, rng


def phase23_internvl(dev, peaks, spec=INTERNVL3_8B, layers=INTERNVL_LAYERS[0],
                     batch=4, text_tokens=32, cpu_layers=2,
                     vit6b=INTERNVIT_6B, group_size=128, seed=0):
    """InternVL3-8B: the full InternViT-300M tower, the LM at ``layers``
    packed W4A16 g128 (17 launches of B1 a forward at 4 layers): B prompts
    of the image's 256 tokens and 32 text tokens through the eager forward,
    against the fake-quant model; the card against the CPU at
    ``cpu_layers`` (LM and tower); InternViT-6B's qk-norm block on the card
    against the CPU."""
    from llmc_tpu_torch.models import internvl as IV
    wspec = dataclasses.replace(_wspec(4, group_size), symmetric=False)
    model = vlm2_model(dev, 'InternVL2', spec, layers, seed=seed)
    cfg = model.vl_cfg
    span = cfg.image_seq_length
    ids, rng = vlm2_image_prompts(cfg, batch, span, text_tokens,
                                  cfg.image_token_id, seed)
    px = rng.randn(batch, 3, cfg.image_size, cfg.image_size).astype(
        np.float32)
    vs_cpu = vlm2_vs_cpu(dev, model, ids[:1], dict(pixel_values=px[:1]),
                         cpu_layers, cpu_layers)
    qmap, pre = packed_eager(dev, model, [('images', ids, dict(
        pixel_values=px))], wspec)
    with torch.no_grad():
        pxt = torch.as_tensor(px, device=dev)
        IV.image_features(model.params, cfg, pxt)              # warm
        _, tower_ms = _timed(dev, lambda: IV.image_features(model.params,
                                                            cfg, pxt))
    full = spec['text']['num_hidden_layers']
    rec = dict(phase='internvl', source=INTERNVL_SOURCE,
               layers=cfg.text.num_hidden_layers,
               tower_layers=cfg.vision.num_hidden_layers,
               reduced=[f'{cfg.text.num_hidden_layers} of {full} LM layers: '
                        f'{INTERNVL_LAYERS[1]}']
               if cfg.text.num_hidden_layers < full else [],
               image_tokens=span, batch=batch, prompt=int(ids.shape[1]),
               layer_scale=cfg.vision.layer_scale,
               tower_projector_ms=tower_ms, pack_ms=pre.pop('pack_ms'),
               packed_prefill=pre['images'], vs_cpu=vs_cpu,
               internvit_6b=internvit_6b_vs_cpu(dev, vit6b, seed))
    p, v6 = rec['packed_prefill'], rec['internvit_6b']
    rec['ok'] = bool(p['rel_logit_err'] <= TOL_COMPRESS_SERVE and p['finite']
                     and vs_cpu['same_shape']
                     and vs_cpu['rel_logit_err'] <= TOL_VLM_VS_CPU
                     and vs_cpu['last_argmax_equal']
                     and v6['rel_err'] <= TOL_VLM_VS_CPU
                     and v6['q_norm_width'] == vit6b['hidden_size'])
    return rec


def phase23_onevision(dev, peaks, spec=ONEVISION_7B,
                      layers=ONEVISION_LAYERS[0], run=ONEVISION_RUN,
                      group_size=128, seed=0):
    """LLaVA-OneVision-7B: the full SigLIP tower, the LM at ``layers``
    packed W4A16 g128; an anyres_max_9 image (the base crop and a 2 x 2
    grid) and an 8-frame video through the eager forward against the
    fake-quant model; the video also reduced by PruneVid and DyCoke (their
    kept tokens); the card against the CPU at ``cpu_layers`` on a video of
    ``cpu_frames``."""
    from llmc_tpu_torch.models import llava_onevision as OV
    wspec = dataclasses.replace(_wspec(4, group_size), symmetric=False)
    model = vlm2_model(dev, 'LlavaOneVision', spec, layers, seed=seed)
    cfg = model.vl_cfg
    size = run['image']
    crops = OV.num_patches_for(size, cfg.image_grid_pinpoints,
                               cfg.image_size)
    # a crop's pixels the patch conv reads: 27 x 14 = 378 of a 384 crop
    # (HF's conv drops the remainder; the reference's unfold takes none)
    side = cfg.patches_per_side * cfg.patch_size
    rng = np.random.RandomState(seed)
    px = rng.randn(1, crops, 3, side, side).astype(np.float32)
    with torch.no_grad():
        span = OV.image_features(model.params, cfg, torch.as_tensor(
            px[0], device=dev), size).shape[0]
    half = -(-cfg.patches_per_side // 2)

    def video(frames, s):
        vspan = frames * half * half + 1
        ids, r = vlm2_image_prompts(cfg, 1, vspan, run['text_tokens'],
                                    cfg.image_token_index, s)
        ids[:, 1:1 + vspan] = cfg.video_token_index
        return ids, r.randn(1, frames, 3, side, side).astype(np.float32)
    img_ids, _ = vlm2_image_prompts(cfg, 1, span, run['text_tokens'],
                                    cfg.image_token_index, seed + 1)
    vid_ids, vids = video(run['frames'], seed + 2)
    cpu_ids, cpu_vids = video(run['cpu_frames'], seed + 3)
    vs_cpu = vlm2_vs_cpu(dev, model, cpu_ids, dict(
        pixel_values_videos=cpu_vids), run['cpu_layers'], run['cpu_layers'])
    prompts = [('image', img_ids, dict(pixel_values=px, image_sizes=[size])),
               ('video', vid_ids, dict(pixel_values_videos=vids))]
    prompts += [(f'video_{r["method"]}', vid_ids, dict(
        pixel_values_videos=vids, token_reduction=r))
        for r in (PRUNEVID, DYCOKE)]
    qmap, pre = packed_eager(dev, model, prompts, wspec)
    vspan = run['frames'] * half * half + 1
    kept = {n[6:]: pre[n]['positions'] - (vid_ids.shape[1] - vspan)
            for n in pre if n.startswith('video_')}
    full = spec['text']['num_hidden_layers']
    rec = dict(phase='onevision', source=ONEVISION_SOURCE,
               layers=cfg.text.num_hidden_layers,
               tower_layers=cfg.vision.num_hidden_layers,
               reduced=[f'{cfg.text.num_hidden_layers} of {full} LM layers: '
                        f'{ONEVISION_LAYERS[1]}']
               if cfg.text.num_hidden_layers < full else [],
               image_size=size, crops=crops, crop_pixels=side,
               image_tokens=span,
               frames=run['frames'], video_tokens=vspan,
               video_tokens_kept=kept, prunevid=PRUNEVID, dycoke=DYCOKE,
               pack_ms=pre.pop('pack_ms'), packed_prefill=pre, vs_cpu=vs_cpu)
    rec['ok'] = bool(
        all(pre[n]['rel_logit_err'] <= TOL_COMPRESS_SERVE and pre[n]['finite']
            for n in ('image', 'video'))
        and all(pre[n]['finite'] for n in pre)
        and all(0 < k <= vspan for k in kept.values())
        and kept['DyCoke'] < vspan
        and vs_cpu['same_shape'] and vs_cpu['rel_logit_err'] <= TOL_VLM_VS_CPU
        and vs_cpu['last_argmax_equal'])
    return rec


def minicpmv_config(spec, layers, samples=2, seed=0):
    """``run_pipeline``'s config of RTN W4 g128 on MiniCPM-V's LM alone,
    calibrated on ``synthetic_vlm`` images, no eval."""
    n = spec['num_queries']
    data = dict(name='synthetic_vlm', seq_len=1 + n + 32,
                vocab_size=spec['image_token_index'] - 9,
                image_token=spec['image_token_index'], image_seq_length=n,
                image_size=spec['image_size'], seed=seed)
    return dict(
        base=dict(seed=seed),
        model=dict(type='MiniCPMV', seed=seed, arch=dict(
            spec['text'], num_hidden_layers=layers,
            vision=dict(spec['vision']),
            **{k: spec[k] for k in ('image_size', 'patch_size', 'num_queries',
                                    'image_token_index')})),
        calib=dict(data, n_samples=samples, bs=1),
        quant=dict(language=dict(method='RTN', weight=W4_G128)))


def phase23_minicpmv(dev, peaks, spec=MINICPMV_25, layers=MINICPMV_LAYERS[0],
                     batch=1, text_tokens=32, cpu_layers=2, seed=0):
    """MiniCPM-Llama3-V-2.5: ``run_pipeline`` of RTN W4 g128 on the LM
    alone (the reference compresses nothing else), then the LM packed
    W4A16 g128 and the eager forward with an image through B1, against the
    fake-quant model; the card against the CPU at ``cpu_layers``."""
    from llmc_tpu_torch.main import run_pipeline
    from llmc_tpu_torch.models import minicpmv as MV
    wspec = dataclasses.replace(_wspec(4), symmetric=False)
    res = run_pipeline(minicpmv_config(spec, layers, seed=seed), device=dev)
    model = res['model']
    cfg = model.vl_cfg
    n = cfg.num_queries
    ids, rng = vlm2_image_prompts(cfg, batch, n, text_tokens,
                                  cfg.image_token_index, seed)
    px = rng.randn(batch, 3, cfg.image_size, cfg.image_size).astype(
        np.float32)
    vs_cpu = vlm2_vs_cpu(dev, model, ids[:1], dict(pixel_values=px[:1]),
                         cpu_layers, cpu_layers)
    qmap, pre = packed_eager(dev, model, [('image', ids, dict(
        pixel_values=px))], wspec)
    with torch.no_grad():
        pxt = torch.as_tensor(px, device=dev)
        MV.image_embeds(model.params, cfg, pxt)                # warm
        _, tower_ms = _timed(dev, lambda: MV.image_embeds(model.params, cfg,
                                                          pxt))
    full = spec['text']['num_hidden_layers']
    rec = dict(phase='minicpmv', source=MINICPMV_SOURCE, layers=layers,
               tower_layers=cfg.vision.num_hidden_layers,
               reduced=[f'{layers} of {full} LM layers: '
                        f'{MINICPMV_LAYERS[1]}'] if layers < full else [],
               quant='RTN W4 g128 asymmetric, language only (the packing '
                     'holds its grid)', phase_times=res['phase_times'],
               image_tokens=n, prompt=int(ids.shape[1]),
               tower_resampler_ms=tower_ms, pack_ms=pre.pop('pack_ms'),
               packed_prefill=pre['image'], vs_cpu=vs_cpu)
    p = rec['packed_prefill']
    rec['ok'] = bool(p['rel_logit_err'] <= TOL_COMPRESS_SERVE and p['finite']
                     and vs_cpu['same_shape']
                     and vs_cpu['rel_logit_err'] <= TOL_VLM_VS_CPU
                     and vs_cpu['last_argmax_equal'])
    del res
    return rec


def phase23(dev, peaks):
    """Every record of phase 23, in its order (a generator: each record is
    emitted and checked before the next part runs)."""
    yield phase23_qwen2vl(dev, peaks)
    _free(dev)
    yield phase23_qwen2vl_compress(dev)
    _free(dev)
    yield phase23_internvl(dev, peaks)
    _free(dev)
    yield phase23_onevision(dev, peaks)
    _free(dev)
    yield phase23_minicpmv(dev, peaks)
    _free(dev)


def phase23_launch_checks(rec):
    """(name, launches, expected launches, XLA branch calls) of every run
    a phase-23 record counts, for ``require_launches`` (on the CPU no
    kernel launches: the tests read the predictions apart)."""
    subs = [(f'{rec["phase"]}.{attn}.{m}', run[m])
            for attn, run in rec.get('text_runs', {}).items()
            for m in ('graph', 'eager')]
    pre = rec.get('image_prefill', rec.get('packed_prefill', {}))
    if 'launches' in pre:
        pre = {'prefill': pre}
    subs += [(f'{rec["phase"]}.{n}', r) for n, r in pre.items()]
    if 'expected_launches' in rec:
        subs.append((rec['phase'], rec))
    return [dict(phase=name, launches=r['launches'],
                 expected_launches=r['expected_launches'],
                 xla_branch_calls=r['xla_branch_calls']) for name, r in subs]


def phase23_failure(rec) -> dict:
    """The fields of a phase-23 record that its ``ok`` reads, for the
    failure's message."""
    keys = ('image_prefill', 'packed_prefill', 'text_runs', 'vs_cpu',
            'internvit_6b', 'results', 'deploy_bits', 'video_tokens_kept')
    return {k: rec[k] for k in keys if k in rec}


def check_reads(dev, peaks, B=128, smax=96, kvh=32, H=32, hd=128):
    """``LLMC_ATTN`` = chunked and full at the bench attention shape (B=128
    over 96 positions, 32 heads of 128, int8 and bf16 caches), each held
    to B2's output on the same cache within ``TOL_FLASH`` over
    ``_attn_positions``, timed (a record) beside B2 and the bound."""
    from llmc_tpu_torch.models import LlamaConfig
    from llmc_tpu_torch.ops.flash_decode import (KERNEL_CHUNK,
                                                 flash_decode_attention)
    from llmc_tpu_torch.serve import KVCachePolicy
    from llmc_tpu_torch.serve import decode
    cfg = LlamaConfig(num_attention_heads=H, num_key_value_heads=kvh,
                      head_dim=hd, hidden_size=H * hd)
    rows = []
    for cache in ('int8', 'bf16'):
        quant = cache == 'int8'
        q, kb, vb, ks, vs = flash_inputs(dev, B, smax, kvh, H, hd,
                                         cache=cache)
        policy = KVCachePolicy(method='naive' if quant else 'fp', bit=8)
        buf = (dict(k_q=kb, v_q=vb, k_s=ks, v_s=vs) if quant
               else dict(k=kb, v=vb))
        chunk = decode._chunk_for(smax)

        def reads(pos):
            c = dict(buf, pos=pos)
            return {
                'chunked': lambda: decode._decode_attn_chunked(
                    q[:, None], c, 1, policy, cfg, chunk)[:, 0],
                'full': lambda: decode._attend_cached(
                    q[:, None] * hd ** 0.5, c, 1, policy, cfg, F32)[:, 0]}
        errs = {}
        for pname, pos in _attn_positions(B, smax, KERNEL_CHUNK,
                                          dev).items():
            want = flash_decode_attention(q, kb, vb, ks, vs, pos, 1)
            for rname, fn in reads(pos).items():
                _, rel = _rel(fn(), want)
                errs.setdefault(rname, {})[pname] = rel
        pos_t = torch.full((B,), 63, dtype=torch.int32, device=dev)
        times = {k: cuda_ms(fn, 20, 2) for k, fn in reads(pos_t).items()}
        times['b2'] = cuda_ms(lambda: flash_decode_attention(
            q, kb, vb, ks, vs, pos_t, 1), 200, 5)
        bound_ms, bound_by = flash_bound(pos_t, kvh, hd, H, quant, peaks,
                                         kb.element_size())
        for rname in ('chunked', 'full'):
            rows.append(dict(read=rname, cache=cache, B=B, smax=smax,
                             kvh=kvh, H=H, hd=hd, chunk=chunk,
                             rel_err_vs_b2=errs[rname],
                             max_rel_err_vs_b2=max(errs[rname].values()),
                             ms=times[rname], b2_ms=times['b2'],
                             timed_valid_positions=64, bound_ms=bound_ms,
                             bound_by=bound_by))
        del q, kb, vb, ks, vs, buf
        _free(dev)
    return dict(phase='attn_reads', rows=rows, tolerance_vs_b2=TOL_FLASH,
                ok=all(r['max_rel_err_vs_b2'] <= TOL_FLASH for r in rows))


def _free(dev) -> None:
    import gc
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()


MAIN_SHAPES = [(12288, 4096, False), (4096, 4096, False),
               (22016, 4096, False), (4096, 11008, False),
               (32000, 4096, True)]


PROBE_MS = (64, 77, 128, 4096)


def phase_probes(dev, Ms=PROBE_MS, K=4096, N=22016):
    """The w4 design probes through the tools' entry points at every M.
    Each tool holds each kernel against its plain version (bf16 within
    ``probe_gemm.TOL_BF16`` of the largest output, the int8 dot's int32
    equal) and raises when one is off; the launches must equal the calls
    the tools made."""
    from llmc_tpu_torch.ops import reset_launch_counts
    from llmc_tpu_torch.tools import kernel_bench, w4_probe
    t0 = time.perf_counter()
    reset_launch_counts()
    kb = kernel_bench.run(dev, M=Ms, K=K, N=N)
    wp = w4_probe.run(dev, M=Ms, K=K, N=N)
    counts, xla = read_counts()
    wall = time.perf_counter() - t0
    expect = dict.fromkeys(KERNEL_NAMES, 0)
    for r in kb + wp:
        if r['kernel']:
            expect[r['kernel']] += r['calls']
    return dict(phase='probes', K=K, N=N, Ms=list(Ms), wall_s=wall,
                kernel_bench=kb, w4_probe=wp, launches=counts, xla_branch_calls=xla,
                expected_launches=expect)


def probe_kernel_record(name, rec, launches, M=128):
    """The ``kernels`` line's entry of a probe: its worst errors over every
    M, its times at gate_up and M (w4_probe's line where both tools have
    one)."""
    rows = [r for r in rec['w4_probe'] + rec['kernel_bench']
            if r['kernel'] == name]
    row = next(r for r in rows if r['M'] == M)
    replaces, replaces_fn = PROBE_KERNELS[name]
    return dict(name=name, route='cuda',
                source=f'llmc_tpu_torch/csrc/{PROBE_SOURCES[name]}',
                replaces=replaces, replaces_fn=replaces_fn,
                launches=launches[name],
                max_abs_err=max(r['max_abs_err'] for r in rows),
                max_rel_err=max(r['max_rel_err'] for r in rows),
                ms=row['ms'], plain_ms=row['plain_ms'],
                bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                library_ms=row['library_ms'],
                at=f'{row["name"]} N={rec["N"]} K={rec["K"]} M={M}')


def read_counts():
    """(kernel launches, calls that ran the reference's XLA branch on the
    card) since the last ``reset_launch_counts``."""
    from llmc_tpu_torch.ops import launch_counts, xla_branch_calls
    return launch_counts(), xla_branch_calls()


def require_launches(rec) -> None:
    require(rec['launches'] == rec['expected_launches'],
            f'{rec["phase"]}: launches {rec["launches"]} != expected '
            f'{rec["expected_launches"]}')
    require(rec['xla_branch_calls'] == 0,
            f'{rec["phase"]}: {rec["xla_branch_calls"]} calls ran the XLA '
            f'branch in torch ops: a weight of the path no kernel takes')


def require_served(rec) -> None:
    require(rec['all_done'], f'{rec["phase"]}: a request did not finish '
            f'with max_new_tokens valid token ids')
    require(rec['requests'] >= 8, f'{rec["phase"]}: fewer than 8 requests')
    require_launches(rec)


# instantiations: 5 token tiles x 2 outputs x (B1, B3) 1 or 2 pieces a
# step, (B4) with or without zeros x one or two groups a unit, (B6) 1 or 2
# units a step
WGMMA_KERNELS = {'w4_dequant_matmul': 20, 'w4a8_dequant_matmul': 20,
                 'w8_dequant_matmul': 40, 'fp8_block_gemm': 20}


def wgmma_build(build_info):
    """Registers and spill bytes of every instantiation of the wgmma
    kernels (B1, B3, B4, B6), from ptxas; fails on a spill or a missing
    kernel."""
    out = {}
    for name, want in WGMMA_KERNELS.items():
        insts = {k: v for k, v in build_info.get('kernels', {}).items()
                 if f'{name}_kernel' in k}
        require(len(insts) == want, f'{name}: {len(insts)} instantiations '
                f'in the ptxas report, want {want}')
        spills = {k: v for k, v in insts.items()
                  if v.get('spill_stores', 0) or v.get('spill_loads', 0)}
        require(not spills, f'{name} spills: {spills}')
        out[name] = insts
    return out


def _at(row):
    return f'N={row["N"]} K={row["K"]} M={row["M"]}'


def wgmma_summary(build, gemm, fp8_rows, probes):
    """The B1, B3, B4 and B6 entries that go before the ``kernels`` line:
    each kernel's registers and spills, its host microseconds a launch at
    every timed shape and its device time through a CUDA graph up to M=128
    (B1 beside its old design, B3 also with its quantizer), and B1's old
    design from the probes phase (``w4_current``, gate_up, M = 64, 128,
    4096)."""
    rec = {}
    for kind, name in (('w4', 'w4_dequant_matmul'),
                       ('w4a8', 'w4a8_dequant_matmul'),
                       ('w8', 'w8_dequant_matmul'),
                       ('fp8', 'fp8_block_gemm')):
        rows = [r for r in (fp8_rows if kind == 'fp8' else gemm[kind][0])
                if 'kernel_ms' in r]
        rec[name] = dict(
            registers=sorted({v['registers'] for v in build[name].values()}),
            spill_bytes=sum(v.get('spill_stores', 0) + v.get('spill_loads', 0)
                            for v in build[name].values()),
            host_us={_at(r): r['host_us'] for r in rows},
            device_ms={_at(r): r['device_ms'] for r in rows
                       if 'device_ms' in r})
    rows = [r for r in gemm['w4a8'][0] if 'kernel_ms' in r]
    rec['w4a8_dequant_matmul'].update(
        path_ms={_at(r): r['path_ms'] for r in rows},
        path_device_ms={_at(r): r['path_device_ms'] for r in rows
                        if 'path_device_ms' in r})
    rows = [r for r in gemm['w4'][0] if 'kernel_ms' in r]
    rec['w4_dequant_matmul'].update(
        old_design_host_us={_at(r): r['old_design_host_us'] for r in rows},
        old_design_device_ms={_at(r): r['old_design_device_ms'] for r in rows
                              if 'old_design_device_ms' in r},
        old_design_ms=old_design_ms(probes))
    return rec


def old_design_ms(probes):
    """``w4_current`` (B1's mma.sync design) from the probes phase at
    gate_up, M -> ms (``w4_probe``'s line)."""
    return {r['M']: r['ms'] for r in probes['w4_probe']
            if r['kernel'] == 'w4_mma_sync' and r['M'] in (64, 128, 4096)}


# the long-context profile row of W4A16 + flash: a small batch deep into a
# long cache, where a decode step is mostly attention
LONG_PROFILE = dict(B=8, prefill=1024, steps=8)


def require_graph_serve(rec) -> None:
    require(rec['all_done'] and rec['requests'] >= 8,
            f'{rec["phase"]}: a request did not finish')
    require(rec['eager_tokens_equal'], f'{rec["phase"]}: the eager step '
            f'gave other tokens than the captured one')
    require(rec['window_tokens_equal'], f'{rec["phase"]}: the K=4 window '
            f'gave other tokens than single steps')
    require_launches(rec)
    require_launches(dict(phase=rec['phase'] + '.window_4',
                          launches=rec['window_launches'],
                          expected_launches=rec['window_expected_launches'],
                          xla_branch_calls=rec['window_xla_branch_calls']))


def drive_mode(mode, dev, peaks, card):
    """The model phases of one serving mode at Llama-2-7B width and depth:
    serve (the captured step), serve_graph (the eager step and the K=4
    window against it), throughput, profile through the graph and eagerly
    (for W4A16 also at ``LONG_PROFILE``, and serve_paged).  Returns the
    launches of serve_graph's eager run."""
    model, qmap = make_model(mode, LLAMA2_7B, dev)
    rec, toks, _ = serve_run(dev, model, qmap, mode=mode)
    rec.update(card)
    emit(rec)
    require_served(rec)
    require(rec['graphed'] and rec['graph_replays'] > 0,
            f'{rec["phase"]}: the engine did not replay a captured step')
    rec = phase_serve_graph(dev, model, qmap, toks, mode=mode)
    rec.update(card)
    emit(rec)
    require_graph_serve(rec)
    launches = rec['launches']
    rec = phase_throughput(dev, model, qmap, mode=mode)
    rec.update(step_bound(model, 128, 32, 64, peaks, mode), **card)
    emit(rec)
    require_launches(rec)
    require_launches(dict(phase='throughput.eager',
                          launches=rec['eager_launches'],
                          expected_launches=rec['eager_expected_launches'],
                          xla_branch_calls=rec['xla_branch_calls']))
    rec = phase_profile_prefill(dev, model, qmap, mode=mode)
    rec.update(card)
    emit(rec)
    require_launches(rec)
    shapes = [{}] + ([LONG_PROFILE] if mode == 'w4a16' else [])
    for kw, graph in itertools.product(shapes, (True, False)):
        rec = phase_profile(dev, model, qmap, mode=mode, graph=graph, **kw)
        if kw:
            rec.update(step_bound(model, kw['B'], kw['prefill'], kw['steps'],
                                  peaks, mode))
        rec.update(card)
        emit(rec)
        require_launches(rec)
        require(rec['device_busy_ms'] > 0, f'profile ({mode}, graph '
                f'{graph}): the profiler saw no device time')
        want = {k: v for k, v in rec['device_expected_launches'].items()
                if k in rec['kernel_calls']}
        require(rec['kernel_calls'] == want, f'profile ({mode}, graph '
                f'{graph}): the device ran {rec["kernel_calls"]} port '
                f'kernels in {rec["steps"]} steps, the path implies {want}')
    if mode == 'w4a16':
        rec = phase_serve_paged(dev, shallow(model, SERVE_PAGED_LAYERS),
                                qmap, LLAMA2_7B)
        rec.update(card, reduced=[f'{SERVE_PAGED_LAYERS} of 32 layers: '
                                  f'{PHASE22_DEPTH}'])
        emit(rec)
        require_served(rec)
        require(rec['pool_whole_at_end'], 'serve_paged: pages were lost')
        require(rec['requests_waited_on_the_pool'],
                'serve_paged: no request waited on the pool')
        require(rec['fp_pool_tokens_equal_dense_fp_at_2_layers_f32'],
                'serve_paged: the fp pool\'s tokens at 2 layers differ '
                'from the dense fp engine\'s')
        require(rec['int8_pool_tokens_equal_cpu_at_2_layers_f32'],
                'serve_paged: the int8 pool\'s tokens at 2 layers differ '
                'between the card and the CPU')
    del model
    torch.cuda.empty_cache()
    return launches


def kernel_record(name, source, replaces, replaces_fn, launches, errs, row,
                  at):
    worst_abs, worst_rel = errs
    return dict(name=name, route='cuda',
                source=f'llmc_tpu_torch/csrc/{source}', replaces=replaces,
                replaces_fn=replaces_fn, launches=launches[name],
                max_abs_err=worst_abs, max_rel_err=worst_rel,
                ms=row['kernel_ms'], path_ms=row.get('path_ms'),
                plain_ms=row['plain_ms'],
                bound_ms=row['bound_ms'], bound_by=row['bound_by'],
                library_ms=row['library_ms'], at=at)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parity-seeds', type=int, nargs='+', default=[0],
                    help='seeds of the parity phase\'s random models '
                         '(default: 0; more seeds show how its errors '
                         'spread)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on the '
              'card', file=sys.stderr)
        return 2
    from llmc_tpu_torch.ops import _build
    from llmc_tpu_torch.utils.device import sm_count
    t_start = time.perf_counter()
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    card = dict(card=kind, nvidia_smi=smi)
    peak_name, peaks = peaks_for(kind)
    emit(dict(phase='device', kind=kind, count=count, nvidia_smi=smi,
              sms=sm_count(0),
              peaks=dict(table=peak_name, bytes_per_s=peaks.bw,
                         bf16_flops=peaks.bf16, f32_flops=peaks.f32,
                         int8_ops=peaks.int8, fp8_flops=peaks.fp8)))
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.lib()
    emit(dict(phase='build', wall_s=time.perf_counter() - t0,
              **_build.BUILD_INFO))
    wg_build = wgmma_build(_build.BUILD_INFO)

    # the GEMMs also at M=64 (timed: the probes' M) and M=77 (rows off
    # every token tile); B1 and B3 at group size 64 (half groups of 64
    # columns, and a single group of K=128); B4 at group sizes 64 and 32
    # (a 64-column unit in two groups)
    gemm = {kind_: check_gemm(kind_, dev, peaks, MAIN_SHAPES,
                              (1, 64, 77, 128, 4096), (1, 64, 128, 4096))
            for kind_ in ('w4', 'w4a8', 'w8')}
    gs64 = {kind_: [check_gemm(kind_, dev, peaks, shapes, (1, 77, 128),
                               timed_ms=(), gs=gs)
                    for shapes, gs in (([(22016, 4096, False),
                                         (32000, 4096, True),
                                         (4096, 128, False)], 64),
                                       ([(4096, 128, False)], 128))]
            for kind_ in ('w4', 'w4a8')}
    w8_small = [check_gemm('w8', dev, peaks, [(22016, 4096, False),
                                              (4096, 11008, False),
                                              (32000, 4096, True)],
                           (1, 77, 128), timed_ms=(), gs=gs)
                for gs in (64, 32)]
    quant = check_quant_act_token(dev, peaks)
    attn = {'flash_decode': check_attention('flash_decode', dev, peaks),
            'batch_decode': check_attention('batch_decode', dev, peaks,
                                            BATCH_SHAPES)}
    # both kernels on a float32 model's cache, at 16 query heads a kv head,
    # on a cache made by the port's KV quantizer and on an fp16 cache
    attn_more = {name: [check_attention(name, dev, peaks, ATTN_F32,
                                        caches=('f32',)),
                        check_attention(name, dev, peaks, ATTN_G16,
                                        caches=('int8',)),
                        check_attention(name, dev, peaks, ATTN_KVQ,
                                        caches=('int8_kv',),
                                        tol=TOL_ATTN_KVQ),
                        check_attention(name, dev, peaks, ATTN_F16,
                                        caches=('f16',))]
                 for name in attn}
    # head dims 256 and 72, which the card refused before
    attn_hd = {name: [check_attention(name, dev, peaks, ATTN_HD256, hd=256),
                      check_attention(name, dev, peaks, ATTN_HD72, hd=72)]
               for name in attn}
    # an odd N: every GEMM kernel at N = 4095 (no multiple of 2 or of the
    # 128-row tile)
    odd_n = {kind_: check_gemm(kind_, dev, peaks, [(4095, 4096, False)],
                               (1, 77, 128), timed_ms=())
             for kind_ in ('w4', 'w4a8', 'w8')}
    fp8 = check_fp8(dev, peaks)
    fp8_ragged = check_fp8(dev, peaks, FP8_RAGGED, (1, 77, 128), timed=())
    # block sizes other than 128: 64 (two rows of ws under a CTA), 256 (a
    # block over two K steps), the whole K
    fp8_blocks = [check_fp8(dev, peaks, FP8_SHAPES[:1] + FP8_RAGGED,
                            (1, 77, 128), timed=(), bs=bs)
                  for bs in (64, 256, 'K')]
    # the whole-K block at a K whose rows are no whole 16 bytes (the codes'
    # rows padded when the weight is cast)
    fp8_blocks.append(check_fp8(dev, peaks, [(4096, 1000)], (1, 77, 128),
                                timed=(), bs='K'))
    # and those codes in contiguous 1000-byte rows (a checkpoint's, or a
    # padded cast moved by .to()), which TMA cannot read
    fp8_blocks.append(check_fp8(dev, peaks, [(4096, 1000)], (1, 77, 128),
                                timed=(), bs='K', contiguous_w=True))
    fp8_adder = fp8_adder_probe(dev)
    require(fp8_adder <= TOL_FP8_ORACLE,
            f'fp8_block_gemm on a block whose products span 20 bits: '
            f'{fp8_adder:.3g} against the float64 oracle '
            f'(limit {TOL_FP8_ORACLE})')
    emit(dict(phase='kernel_checks', sms=sm_count(0), **card,
              w4_dequant_matmul=gemm['w4'][0],
              w4_dequant_matmul_half_group_64=gs64['w4'][0][0]
              + gs64['w4'][1][0],
              w4a8_dequant_matmul=gemm['w4a8'][0],
              w4a8_dequant_matmul_half_group_64=gs64['w4a8'][0][0]
              + gs64['w4a8'][1][0],
              w4a8_worst_rel_err_vs_integer_oracle=max(
                  gemm['w4a8'][3], gs64['w4a8'][0][3], gs64['w4a8'][1][3]),
              quant_act_token=quant,
              w8_dequant_matmul=gemm['w8'][0],
              w8_dequant_matmul_gs64_gs32=w8_small[0][0] + w8_small[1][0],
              w4_w4a8_w8_odd_n={k: v[0] for k, v in odd_n.items()},
              flash_decode=attn['flash_decode'][0],
              batch_decode=attn['batch_decode'][0],
              flash_decode_f32_g16_kvq_f16=[
                  r for rec in attn_more['flash_decode'] for r in rec[0]],
              batch_decode_f32_g16_kvq_f16=[
                  r for rec in attn_more['batch_decode'] for r in rec[0]],
              flash_decode_head_dims_256_72=[
                  r for rec in attn_hd['flash_decode'] for r in rec[0]],
              batch_decode_head_dims_256_72=[
                  r for rec in attn_hd['batch_decode'] for r in rec[0]],
              batch_decode_sweep=sweep_batch_blocks(dev),
              fp8_block_gemm=fp8[0],
              fp8_block_gemm_ragged_n=fp8_ragged[0],
              fp8_block_gemm_block_sizes=[r for rec in fp8_blocks
                                          for r in rec[0]],
              fp8_worst_rel_err_vs_float64_oracle=max(
                  [fp8[3], fp8_ragged[3]] + [r[3] for r in fp8_blocks]),
              fp8_adder_probe_rel_err_vs_float64_oracle=fp8_adder))

    probes = phase_probes(dev)
    probes.update(card)
    emit(probes)
    require_launches(probes)

    failed = []
    for mode, seed in itertools.product(MODES, args.parity_seeds):
        rec = phase_parity(dev, torch.device('cpu'),
                           dict(LLAMA2_7B, num_hidden_layers=2), seed=seed,
                           mode=mode)
        emit(rec)
        require_launches(rec)
        failed += [] if rec['ok'] else [(mode, seed)]
    require(not failed, f'parity failed for (mode, seed) in {failed}')

    launches = dict.fromkeys(KERNEL_NAMES, 0)
    launches.update({k: probes['launches'][k] for k in PROBE_KERNELS})
    for mode in MODES:
        got = drive_mode(mode, dev, peaks, card)
        # a kernel's launches are read from the eager serve run of its own
        # path (the head of the W4A8 model also runs the w4 kernel: keep
        # the W4A16 path's count for it)
        launches.update({k: v for k, v in got.items()
                         if v and not launches[k]})

    model, qmap = companion_model(dev, dict(LLAMA2_7B, num_hidden_layers=8))
    for flag in ('prefill_w8', 'decode_w8'):
        rec = serve_run(dev, model, qmap, n_requests=8, w8_flag=flag)[0]
        rec.update(card)
        emit(rec)
        require_served(rec)
    del model
    torch.cuda.empty_cache()

    rec = phase_fp8_linear(dev, LLAMA2_7B)
    rec.update(card)
    emit(rec)
    require(rec['ok'], 'fp8_linear: an FP8-block linear is off its plain '
            'version or its dense bf16 weight')
    require_launches(rec)
    launches['fp8_block_gemm'] = rec['launches']['fp8_block_gemm']

    # the compression pipeline: RTN, then AWQ (scale search + clip v1) on
    # weights that came through the FP8-block ingest; what AWQ made is
    # packed and served
    for method, special, ingest, cfg_kw in (
            ('RTN', None, False, LLAMA2_7B),
            ('Awq', AWQ_SPECIAL, True,
             dict(LLAMA2_7B, num_hidden_layers=AWQ_LAYERS))):
        rec, res = phase_compress(dev, cfg_kw, method, special, ingest)
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'compress {method}: a PPL is not finite, '
                f'ppl_transformed left ppl_pretrain by '
                f'{rec["ppl_transformed_rel_drift"]:.3g} '
                f'(limit {TOL_PPL_TRANSFORMED}), or a searched block errs '
                f'more than RTN: {rec["block_output_mse"]}')
        if method == 'RTN':
            del res
            torch.cuda.empty_cache()
    rec = phase_compress_serve(dev, res)
    rec.update(card)
    emit(rec)
    require(rec['ok'], f'compress_serve: packed logits are '
            f'{rec["rel_logit_err_vs_fake_quant"]:.3g} off the fake-quant '
            f'model\'s (limit {TOL_COMPRESS_SERVE})')
    require_served(rec)
    del res
    torch.cuda.empty_cache()

    # one block at the calibration size AWQ's own config asks for
    rec, res = phase_compress(dev, dict(LLAMA2_7B, num_hidden_layers=1),
                              'Awq', AWQ_SPECIAL, True,
                              n_samples=AWQ_SOURCE_SAMPLES)
    rec.update(card, calib_size_of=AWQ_SOURCE)
    emit(rec)
    require(rec['ok'], f'compress Awq at {AWQ_SOURCE_SAMPLES} samples: '
            f'{rec["block_output_mse"]}')
    del res
    torch.cuda.empty_cache()

    # the activation-quantizing and Hessian methods: SmoothQuant W8A8 at
    # Llama-2-7B served through the W8 kernel with its per-token a_spec,
    # GPTQ W4A16 at GPTQ_LAYERS of its layers through the W4 kernel, and
    # QuaRot W4A8 with the online rotation at TinyLlama-1.1B's widths
    for name, cfg_kw, mode in (
            ('smoothquant_w8a8', LLAMA2_7B, 'w8a16'),
            ('gptq_w4a16', dict(LLAMA2_7B, num_hidden_layers=GPTQ_LAYERS),
             'w4a16'),
            ('quarot_w4a8', TINYLLAMA, None)):
        mq = METHOD_QUANT[name]
        rec, res = phase_compress(dev, cfg_kw, mq['method'], quant=mq)
        rec.update(card, config=f'configs/quantization/methods/{name}.yml')
        emit(rec)
        require(rec['ok'], f'compress {name}: a PPL is not finite or '
                f'ppl_transformed left ppl_pretrain by '
                f'{rec["ppl_transformed_rel_drift"]:.3g} (limit '
                f'{TOL_PPL_TRANSFORMED})')
        if mode is not None:
            rec = phase_compress_serve(dev, res, mode=mode)
            rec.update(card, config=f'configs/quantization/methods/'
                                    f'{name}.yml')
            emit(rec)
            require(rec['ok'], f'compress_serve {name}: packed logits are '
                    f'{rec["rel_logit_err_vs_fake_quant"]:.3g} off the '
                    f'fake-quant model\'s (limit '
                    f'{rec["tolerance_vs_fake_quant"]})')
            require_served(rec)
        del res
        torch.cuda.empty_cache()

    # phase 16: HQQ and AdaDim at Llama-2-7B's width and depth, the
    # gradient-trained methods at the depths TRAINED_DEPTH sets
    for name, mode in PHASE16:
        rec, res = phase16_compress(dev, name)
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'compress {name}: a PPL is not finite, '
                f'ppl_transformed left ppl_pretrain by '
                f'{rec["ppl_transformed_rel_drift"]:.3g} (limit '
                f'{TOL_PPL_TRANSFORMED}) or a trained block errs more than '
                f'before: {rec.get("block_loss")}')
        rec = phase_compress_serve(dev, res, mode=mode)
        rec.update(card, config=f'configs/quantization/methods/{name}.yml')
        emit(rec)
        require(rec['ok'], f'compress_serve {name}: packed logits are '
                f'{rec["rel_logit_err_vs_fake_quant"]:.3g} off the '
                f'fake-quant model\'s (limit '
                f'{rec["tolerance_vs_fake_quant"]})')
        require_served(rec)
        del res
        torch.cuda.empty_cache()

    # phase 17: QUIK and DGQ served through B3, SpQR through B1, and the
    # decode PPL through B2 with the KV-cache quantizers it scores
    for name, mode in PHASE17:
        rec, srv, res = phase17_method(dev, name, mode)
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'compress {name}: a PPL is not finite or '
                f'ppl_transformed left ppl_pretrain by '
                f'{rec["ppl_transformed_rel_drift"]:.3g} (limit '
                f'{rec["tolerance_ppl_transformed"]})')
        srv.update(card)
        emit(srv)
        require(srv['ok'], f'compress_serve {name}: packed logits are '
                f'{srv["rel_logit_err_vs_fake_quant"]:.3g} off (limit '
                f'{srv["tolerance_vs_fake_quant"]}), or a weight is off '
                f'the grid: {srv["packed_weight_gap"]}')
        require_served(srv)
        del res
        torch.cuda.empty_cache()
    rec, res = phase_decode_ppl(dev)
    rec.update(card)
    emit(rec)
    require(rec['ok'], f'decode_ppl: a PPL is not finite, B2 launched '
            f'other than once a layer a step on the fp and int8 caches (or '
            f'at all on KIVI and Sink), the pretrain decode PPL is '
            f'{rec["decode_vs_prefill_rel"]:.3g} off the prefill PPL, or '
            f'KIVI\'s fp ring {rec["kivi_ring_whole_nll_rel_vs_fp_cache"]:.3g}'
            f' off the fp cache: {rec["positions"]}')
    del res
    torch.cuda.empty_cache()

    # phase 18: the MoE and MLA families at their published widths, served
    # through the captured step (Mixtral through B2 and B5, Qwen2-MoE
    # through B5, DeepSeek over the int8 latent cache) and compressed
    t18 = time.perf_counter()
    for name in MOE_MODELS:
        rec, model = phase18_serve(dev, name, peaks)
        rec.update(card)
        emit(rec)
        runs = {a: (r['tokens_equal'], r['graph']['launches'],
                    r['graph']['expected_launches'])
                for a, r in rec['runs'].items()}
        dvp = rec['decode_vs_prefill']
        require(rec['ok'], f'moe_serve {name}: the captured step\'s tokens '
                f'differ from the eager step\'s, a request did not finish, '
                f'the launches are off the path\'s ({runs}), or the decode '
                f'is off the prefill: {dvp["vs_prefill"]} (limit '
                f'{dvp["tolerance_vs_prefill"]}), its planted fault '
                f'{dvp["faults_vs_prefill"]}, launches {dvp["launches"]}')
        del model
        _free(dev)
        # PPLs over 2048 tokens (the compress phases' 4096 elsewhere)
        for rec in phase18_compress(dev, name, eval_tokens=2048):
            rec.update(card)
            emit(rec)
            require(rec['ok'], f'moe_compress {name} {rec["config"]}: a PPL '
                    f'is not finite, an equivalence moved the PPL by '
                    f'{rec["ppl_transformed_rel_drift"]:.3g} (limit '
                    f'{TOL_PPL_EQUIV}), or a searched block errs more than '
                    f'RTN: {rec["block_output_mse"]}')
    emit(dict(phase='phase18', wall_s=time.perf_counter() - t18, **card))

    # phase 19: the Llama-family adapters and the generalized block graph
    # at their published widths, packed W4A16 and served through B1 and,
    # where attn_ok, B2 / B5 (none on Gemma2 and Bloom); two of them
    # compressed; the chunked and full reads held to B2
    t19 = time.perf_counter()
    rec = check_reads(dev, peaks)
    rec.update(card)
    emit(rec)
    errs = [(r['read'], r['cache'], r['max_rel_err_vs_b2'])
            for r in rec['rows']]
    require(rec['ok'], f'attn_reads: the chunked or full read is off B2: '
            f'{errs} (limit {TOL_FLASH})')
    for name in FAMILY_MODELS:
        rec, model = phase19_serve(dev, name, peaks)
        rec.update(card)
        emit(rec)
        runs = {a: (r['tokens_equal'], r['graph']['launches'],
                    r['graph']['expected_launches'],
                    r['graph']['xla_branch_calls'])
                for a, r in rec['runs'].items()}
        dvp, pvf = rec['decode_vs_prefill'], rec['packed_vs_fake_quant']
        require(rec['ok'], f'family_serve {name}: the captured step\'s '
                f'tokens differ from the eager step\'s, a request did not '
                f'finish, the launches are off the path\'s ({runs}), the '
                f'decode is off the prefill: {dvp["vs_prefill"]} (limit '
                f'{dvp["tolerance_vs_prefill"]}), its planted fault '
                f'{dvp["faults_vs_prefill"]}, launches {dvp["launches"]}, or '
                f'the packed logits are '
                f'{pvf["rel_logit_err_vs_fake_quant"]:.3g} off the '
                f'fake-quant model\'s (limit {TOL_COMPRESS_SERVE})')
        del model
        _free(dev)
        if name in FAMILY_COMPRESS:
            for rec in phase19_compress(dev, name):
                rec.update(card)
                emit(rec)
                require(rec['ok'], f'family_compress {name} {rec["method"]} '
                        f'{rec["special"]}: a PPL is not finite, the '
                        f'transformed PPL moved by '
                        f'{rec["ppl_transformed_rel_drift"]:.3g} (limit '
                        f'{rec["tolerance_ppl_transformed"]}), or the '
                        f'searched block errs more than RTN: '
                        f'{rec["block_output_mse"]}')
    emit(dict(phase='phase19', wall_s=time.perf_counter() - t19, **card))

    # phase 20: OPT-6.7B served packed through B1 and B2 / B5 and
    # compressed on its native graph; the engine under SinkKV (no attention
    # kernel); sparsification, ShadowKV and the latency eval
    t20 = time.perf_counter()
    for rec in phase20(dev, peaks):
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'{rec["phase"]}: a check failed: '
                f'{phase20_failure(rec)}')
    emit(dict(phase='phase20', wall_s=time.perf_counter() - t20, **card))

    # phase 21: the backend exports at Llama-2-7B (the full-depth AWQ-GEMM
    # export against B1's packing, each writer against the CPU's), block
    # offload at Llama-2-70B's widths, and the code eval through B2
    t21 = time.perf_counter()
    for rec in phase21(dev):
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'{rec["phase"]}: a check failed: '
                f'{phase21_failure(rec)}')
        if 'expected_launches' in rec:
            require_launches(rec)
    emit(dict(phase='phase21', wall_s=time.perf_counter() - t21, **card))

    # phase 22: the LLaVA tier and ViT: LLaVA-1.5-7B's LM packed and served
    # through B1 and B2 / B5 (VisionZip too), FastV, the two-modality
    # pipeline with the vqa eval, Video-LLaVA with DyCoke, ViT-B/16 W8A8
    t22 = time.perf_counter()
    for rec in phase22(dev, peaks):
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'{rec["phase"]}: a check failed: '
                f'{phase22_failure(rec)}')
        for run in phase22_launch_checks(rec):
            require_launches(run)
    emit(dict(phase='phase22', wall_s=time.perf_counter() - t22, **card))

    # phase 23: Qwen2-VL-7B at full depth (images through the eager forward
    # and B1, text served through B1 and B2 / B5), its two-modality AWQ,
    # InternVL3-8B, LLaVA-OneVision-7B (anyres, video, PruneVid, DyCoke)
    # and MiniCPM-V, each LM packed through B1
    t23 = time.perf_counter()
    for rec in phase23(dev, peaks):
        rec.update(card)
        emit(rec)
        require(rec['ok'], f'{rec["phase"]}: a check failed: '
                f'{phase23_failure(rec)}')
        for run in phase23_launch_checks(rec):
            require_launches(run)
    emit(dict(phase='phase23', wall_s=time.perf_counter() - t23, **card))

    require(min(launches.values()) > 0,
            f'a kernel of the main paths was never launched: {launches}')

    def gemm_row(kind_):
        return next(r for r in gemm[kind_][0]
                    if (r['N'], r['M']) == (22016, 128) and r['sym'])
    at_gemm = 'gate_up N=22016 K=4096 M=128 bf16'
    emit(dict(phase='wgmma_kernels', **card,
              **wgmma_summary(wg_build, gemm, fp8[0], probes)))

    def errs(*recs):
        return [max(e) for e in zip(*(r[1:3] for r in recs))]
    quant_row = next(r for r in quant
                     if (r['M'], r['K'], r['x']) == (128, 4096, 'bfloat16'))
    at_attn = 'B=128 Smax=96 KVH=32 hd=128 int8, 64 valid'
    dm = 'llmc_tpu/ops/dequant_matmul.py'
    emit({'kernels': [
        dict(kernel_record('w4_dequant_matmul', 'dequant_matmul_w4.cu',
                           f'{dm}:189', f'{dm}::_kernel_w4', launches,
                           errs(gemm['w4'], *gs64['w4'], odd_n['w4']),
                           gemm_row('w4'),
                           at_gemm),
             old_design_ms=old_design_ms(probes)),
        kernel_record('w4a8_dequant_matmul', 'dequant_matmul_w4a8.cu',
                      f'{dm}:236', f'{dm}::_kernel_w4a8', launches,
                      errs(gemm['w4a8'], *gs64['w4a8'], odd_n['w4a8']),
                      gemm_row('w4a8'),
                      at_gemm),
        dict(kernel_record('quant_act_token', 'quant_act_token.cu',
                           f'{dm}:143', f'{dm}::_quant_act_token', launches,
                           (max(r['max_abs_err'] for r in quant), 0.0),
                           quant_row, 'M=128 K=4096 bf16'),
             replaces_note='no TPU kernel: XLA ops before the W4A8 '
                           'kernel in the reference'),
        kernel_record('w8_dequant_matmul', 'dequant_matmul_w8.cu',
                      f'{dm}:274', f'{dm}::_kernel_w8', launches,
                      errs(gemm['w8'], *w8_small, odd_n['w8']),
                      gemm_row('w8'), at_gemm),
        kernel_record('flash_decode', 'flash_decode.cu',
                      'llmc_tpu/ops/flash_decode.py:59',
                      'llmc_tpu/ops/flash_decode.py::_kernel', launches,
                      errs(attn['flash_decode'],
                           *attn_more['flash_decode'], *attn_hd['flash_decode']),
                      attn['flash_decode'][0][0],
                      at_attn),
        kernel_record('batch_decode', 'batch_decode.cu',
                      'llmc_tpu/ops/batch_decode.py:88',
                      'llmc_tpu/ops/batch_decode.py::_kernel', launches,
                      errs(attn['batch_decode'],
                           *attn_more['batch_decode'], *attn_hd['batch_decode']),
                      attn['batch_decode'][0][0],
                      at_attn),
        kernel_record('fp8_block_gemm', 'fp8_block_gemm.cu',
                      'llmc_tpu/ops/fp8_gemm.py:28',
                      'llmc_tpu/ops/fp8_gemm.py::_kernel_fp8', launches,
                      errs(fp8, fp8_ragged, *fp8_blocks), next(
                          r for r in fp8[0] if (r['N'], r['M'])
                          == (22016, 128)),
                      'N=22016 K=4096 M=128 e4m3, block 128, bf16 out'),
    ] + [probe_kernel_record(name, probes, launches)
         for name in PROBE_KERNELS]})
    emit(dict(phase='done', wall_s=time.perf_counter() - t_start, **card))
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
