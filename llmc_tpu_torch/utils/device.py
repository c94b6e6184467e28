"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Without a card that raises: the
    port never carries on quietly on the CPU — pass ``device='cpu'``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'the plain PyTorch path on the CPU')
        return torch.device('cuda')
    return torch.device(device)


def tree_device(tree):
    """Device of the first tensor found in a nested dict/list tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        d = tree_device(v)
        if d is not None:
            return d
    return None


def check_on(tree, device: torch.device, what: str) -> None:
    d = tree_device(tree)
    if d is not None and d.type != device.type:
        raise ValueError(f'{what} lives on {d}, but device={device} was '
                         f'asked for')


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
