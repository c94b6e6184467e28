"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import collections
import functools
import subprocess

import torch

# Data-sheet peaks (dense): memory bytes/s, bf16 tensor-core flop/s,
# f32 CUDA-core flop/s, int8 tensor-core op/s, fp8 tensor-core flop/s.
# H100 SXM at 700 W unless the name says otherwise.
Peaks = collections.namedtuple('Peaks', 'bw bf16 f32 int8 fp8')
PEAKS = {
    'H100 SXM': Peaks(3.35e12, 989e12, 67e12, 1979e12, 1979e12),
    'H100 PCIe': Peaks(2.0e12, 756e12, 51e12, 1513e12, 1513e12),
    'H100 NVL': Peaks(3.9e12, 835e12, 60e12, 1671e12, 1671e12),
}


def peaks_for(name: str):
    """(table row, Peaks) for a card's name; the SXM part by default."""
    for key in ('H100 PCIe', 'H100 NVL'):
        if key.split()[1] in name and 'H100' in name:
            return key, PEAKS[key]
    return 'H100 SXM', PEAKS['H100 SXM']


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


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ''
