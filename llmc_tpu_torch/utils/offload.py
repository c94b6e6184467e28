"""Block params in host memory, one block on the device at a time (port of
``llmc_tpu/utils/offload.py``): a model larger than one card is
calibrated, evaluated and exported block by block.

An offloaded model's ``params['blocks']`` is a ``HostBlocks`` list: its
block trees are CPU tensors (pinned where the model's device is CUDA),
reading a block uploads it to the device and storing one takes it back to
the host.  So every step that computes with ``model.blocks[i]`` (the
calibration's block step, the evals, ``deploy`` and the weight baking, the
exporters) has that one block on the device for the step, and nothing
else of the blocks; the embedding, final norm and head stay resident.
Uploads from pinned memory are ``non_blocking``.  The reference's JAX
leaves the upload implicit wherever a host array meets a jitted function.

``streaming_ppl`` is the block-outer PPL of ``inference_per_block``: each
block is uploaded once and every chunk's activations go through it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return tree if tree is None or not isinstance(tree, torch.Tensor) \
        else fn(tree)


def tree_to_host(tree, pin: bool = False):
    """Every tensor of ``tree`` as a CPU tensor (in pinned memory with
    ``pin``); CPU tensors pass as they are unless they must be pinned."""
    def host(t):
        if t.device.type == 'cpu' and (not pin or t.is_pinned()):
            return t
        out = torch.empty(t.shape, dtype=t.dtype, device='cpu',
                          pin_memory=pin)
        return out.copy_(t)
    return _tree_map(host, tree)


def tree_to_device(tree, device):
    """Every tensor of ``tree`` on ``device`` (non-blocking from pinned
    memory)."""
    device = torch.device(device)
    return _tree_map(lambda t: t.to(device, non_blocking=t.is_pinned()),
                     tree)


class HostBlocks(list):
    """The block list of an offloaded model: host trees, uploaded to
    ``device`` where a block is read (an index, a slice or iteration) and
    taken back to the host where one is stored (``[i] =``, ``append``)."""

    def __init__(self, blocks, device):
        super().__init__()
        self.device = torch.device(device)
        self.pin = self.device.type == 'cuda'
        for b in blocks:
            self.append(b)

    def host(self, idx: int):
        """Block ``idx``'s host tree, not uploaded."""
        return list.__getitem__(self, idx)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [tree_to_device(b, self.device)
                    for b in list.__getitem__(self, idx)]
        return tree_to_device(list.__getitem__(self, idx), self.device)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __setitem__(self, idx, block):
        list.__setitem__(self, idx, tree_to_host(block, self.pin))

    def append(self, block):
        list.append(self, tree_to_host(block, self.pin))


def offload_model_blocks(model) -> None:
    """Move every block's params to host memory; the embedding, final norm
    and head stay on the model's device (every step needs them)."""
    if not isinstance(model.params['blocks'], HostBlocks):
        model.params['blocks'] = HostBlocks(
            [list.__getitem__(model.params['blocks'], i)
             for i in range(model.n_blocks)], model.device)
    model.offloaded = True


def streaming_ppl(model, chunks: np.ndarray, qmap=None, bs: int = 8
                  ) -> float:
    """Block-outer PPL (``inference_per_block``): the activations of every
    chunk are carried across the blocks, so each block is uploaded once."""
    dev = model.device
    bfn = model.block_fn()
    head = model.head_fn()
    chunks = torch.as_tensor(np.asarray(chunks), dtype=torch.long)
    with torch.no_grad():
        xs, kws = [], []
        for i in range(0, len(chunks), bs):
            x, kw = model.embed_and_rope_p(model.params,
                                           chunks[i:i + bs].to(dev))
            xs.append(x)
            kws.append(kw)
        blocks = model.params['blocks']
        for bi in range(len(blocks)):
            bp = blocks[bi]
            xs = [bfn(bp, x, kw, qmap=qmap)[0] for x, kw in zip(xs, kws)]
            del bp
        total, count = 0.0, 0
        for i, x in enumerate(xs):
            ids = chunks[i * bs:(i + 1) * bs].to(dev)
            logits = head(model.params, x)
            lp = torch.log_softmax(logits[:, :-1].to(F32), dim=-1)
            nll = -torch.gather(lp, -1, ids[:, 1:, None])
            total += float(nll.sum())
            count += nll.numel()
    return float(math.exp(total / count))
