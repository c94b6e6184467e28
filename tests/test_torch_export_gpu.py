"""The backend exports and block offload on the card (``gpu`` marker; each
test skips without a card): a model's AWQ-GEMM and compressed-tensors
``pack-quantized`` checkpoints written on the card equal, byte for byte,
those the CPU writes from the same weights; the AWQ-GEMM codes, zero
points and fp16 scales equal what ``pack_model`` packs for B1 from the
same model; an offloaded model keeps its blocks in pinned host memory
between steps while its PPL equals the resident model's; and its
``save_trans`` writer holds one block on the card at a time.  The
comparisons are with the port's own paths: no JAX here."""

import os

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device  # noqa: F401

CARD = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, dtype='bfloat16')
W4 = dict(bit=4, symmetric=False, granularity='per_group', group_size=128)


def _pair(dev, seed=1):
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.utils.offload import tree_to_device
    cpu = LlamaAdapter.random(LlamaConfig(**CARD), seed=seed, device='cpu')
    return cpu, LlamaAdapter(cpu.cfg, tree_to_device(cpu.params, dev))


def _read(path):
    from safetensors.torch import load_file
    return load_file(os.path.join(path, 'model.safetensors'))


@pytest.mark.gpu
@pytest.mark.parametrize('backend,need_pack', [('autoawq', False),
                                               ('vllm', True)])
def test_card_export_equals_the_cpu_export(
        cuda_device, tmp_path, backend, need_pack):  # noqa: F811
    from llmc_tpu_torch.export import export_real_quant
    from llmc_tpu_torch.quant import QuantSpec
    cpu, card = _pair(cuda_device)
    w = dict(W4, need_pack=need_pack)
    for name, model in (('cpu', cpu), ('card', card)):
        export_real_quant(model, QuantSpec(**W4), dict(weight=w),
                          str(tmp_path / name), backend=backend)
    got, want = _read(str(tmp_path / 'card')), _read(str(tmp_path / 'cpu'))
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k].view(torch.uint8), t.view(torch.uint8)), k


@pytest.mark.gpu
def test_awq_codes_equal_the_b1_packed_codes(
        cuda_device, tmp_path):  # noqa: F811
    """The written qweight / qzeros / scales, unpacked on the card, are the
    codes, zero points and fp16-rounded scales ``pack_model`` packs for
    B1 (read back with ``unpack_weight``): 0 mismatched codes."""
    from llmc_tpu_torch.export import export_real_quant
    from llmc_tpu_torch.models.base import get_path
    from llmc_tpu_torch.native import unpack_awq_order
    from llmc_tpu_torch.ops.dequant_matmul import QMeta, unpack_weight
    from llmc_tpu_torch.quant import QuantSpec
    from llmc_tpu_torch.serve import pack_model
    _, card = _pair(cuda_device)
    flat = export_real_quant(card, QuantSpec(**W4), dict(weight=W4),
                             str(tmp_path / 'awq'), backend='autoawq')
    layout = card.get_layout()
    pack_model(card, QuantSpec(**W4), pre_t=False)
    for i in range(card.n_blocks):
        for path in layout.linears:
            pre = f'model.layers.{i}.{path}'
            lin = get_path(card.blocks[i], path)
            N, K2 = lin['qweight'].shape
            meta = QMeta(bits=4, group_size=128, symmetric=False,
                         out_features=N, in_features=2 * K2)
            codes = unpack_weight(lin['qweight'], meta)
            got = unpack_awq_order(flat[f'{pre}.qweight'].cuda(), 4).t()
            assert int((got.float() != codes).sum()) == 0, pre
            z = unpack_awq_order(flat[f'{pre}.qzeros'].cuda(), 4).t()
            assert torch.equal(z.float(), lin['zeros']), pre
            assert torch.equal(flat[f'{pre}.scales'].cuda().t(),
                               lin['scales'].to(torch.float16)), pre


@pytest.mark.gpu
def test_offloaded_model_on_the_card(cuda_device):  # noqa: F811
    """Blocks in pinned host memory between steps, the embedding and head
    on the card; the streaming and the plain PPL equal the resident
    model's."""
    from llmc_tpu_torch.eval.ppl import PerplexityEval
    from llmc_tpu_torch.utils import offload_model_blocks, streaming_ppl
    _, card = _pair(cuda_device)
    ids = np.random.RandomState(0).randint(0, 256, (4 * 64,))
    pe = PerplexityEval(ids, seq_len=64, bs=2)
    ref = pe.eval(card)
    offload_model_blocks(card)
    blocks = card.params['blocks']
    for i in range(len(blocks)):
        host = blocks.host(i)
        w = host['self_attn']['q_proj']['w']
        assert w.device.type == 'cpu' and w.is_pinned()
    assert card.params['embed_tokens']['w'].device.type == 'cuda'
    assert blocks[0]['self_attn']['q_proj']['w'].device.type == 'cuda'
    assert pe.eval(card) == pytest.approx(ref, rel=1e-6)
    assert streaming_ppl(card, pe.chunks, bs=2) == pytest.approx(ref,
                                                                 rel=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('family', ['Llama', 'Opt'])
def test_offloaded_save_keeps_one_block_on_the_card(
        cuda_device, tmp_path, family):  # noqa: F811
    """``save_trans`` / ``save_fake`` of an offloaded model gathers each
    tensor to the host as its block is read: the device's peak over what
    was allocated before the save does not grow with depth (2 and 8
    layers, less than one block apart)."""
    from llmc_tpu_torch.export.exporter import leaf_paths
    from llmc_tpu_torch.models import LlamaAdapter, LlamaConfig
    from llmc_tpu_torch.models.adapter import OptAdapter
    from llmc_tpu_torch.models.opt import OptConfig
    from llmc_tpu_torch.utils import offload_model_blocks
    peaks = {}
    for layers in (2, 8):
        if family == 'Llama':
            model = LlamaAdapter.random(LlamaConfig(
                **dict(CARD, num_hidden_layers=layers)), seed=1,
                device=cuda_device, offload=True)
        else:
            model = OptAdapter.random(OptConfig(
                vocab_size=256, hidden_size=256, ffn_dim=512,
                num_hidden_layers=layers, num_attention_heads=4,
                max_position_embeddings=64), seed=1, device=cuda_device)
            offload_model_blocks(model)
        block = sum(t.numel() * t.element_size()
                    for _, t in leaf_paths(model.params['blocks'].host(0)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        start = torch.cuda.memory_allocated(cuda_device)
        model.save_to_hf(str(tmp_path / f'{family}{layers}'))
        peaks[layers] = torch.cuda.max_memory_allocated(cuda_device) - start
        del model
    assert peaks[8] - peaks[2] < block, (peaks, block)
