"""Time a decode-attention kernel, B2 (``flash_decode_cuda``) or B5
(``batch_decode_cuda``), of two checkouts of the repository on one card,
in turns, at the attention rows of ``chip_smoke.py`` (``FLASH_SHAPES``),
so that a redesign is read beside its parent inside one run.

    python -m llmc_tpu_torch.tools.ab_attention TREE_A TREE_B \
        [--kernel flash_decode|batch_decode] [--graph]

Each run is a subprocess in a tree's root that builds that tree's kernels
and times its kernel on ``chip_smoke.flash_inputs`` (seed 2, two layers,
alternated) at each row's valid positions: int8 and bf16 caches, CUDA
events over 200 launches as the host enqueues them, and with ``--graph``
also the device's time a launch through a CUDA graph of 20
(``chip_smoke.graph_ms``).  The trees run in the order A, B, B, A; one
JSON line a row, tagged with its tree and turn, the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .ab_serve import in_turns, run_code

# (B, Smax, KVH, H, valid positions timed): chip_smoke.FLASH_SHAPES
ROWS = ((128, 96, 32, 32, (64,)), (8, 1024, 32, 32, (64, 1000)),
        (1, 4096, 32, 32, (4000,)), (8, 4096, 32, 32, (4000,)),
        (8, 4096, 8, 32, (4000,)))

_RUN = '''
import json, torch
import chip_smoke as C
from llmc_tpu_torch.ops import _build
from llmc_tpu_torch.ops.{kernel} import {kernel}_cuda as kernel
from llmc_tpu_torch.utils.profiler import cuda_ms
dev = torch.device('cuda')
_build.lib()
for B, smax, kvh, H, valids in {rows!r}:
    for quant in (True, False):
        q, kb, vb, ks, vs = C.flash_inputs(dev, B, smax, kvh, H, 128,
                                           quant=quant)
        for valid in valids:
            pos = torch.full((B,), valid - 1, dtype=torch.int32, device=dev)
            it = [0]

            def kern():
                it[0] += 1
                return kernel(q, kb, vb, ks, vs, pos, it[0] % 2)
            rec = dict(kernel={kernel!r}, B=B, smax=smax, kvh=kvh, H=H,
                       cache='int8' if quant else 'bf16', valid=valid,
                       kernel_ms=cuda_ms(kern, 200, 5))
            if {graph!r}:
                rec['graph_ms'] = C.graph_ms(kern)
            print(json.dumps(rec), flush=True)
        del q, kb, vb, ks, vs
        torch.cuda.empty_cache()
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree_a', type=Path)
    ap.add_argument('tree_b', type=Path)
    ap.add_argument('--kernel', choices=('flash_decode', 'batch_decode'),
                    default='flash_decode')
    ap.add_argument('--graph', action='store_true',
                    help='also time each row through a CUDA graph')
    args = ap.parse_args(argv)
    code = _RUN.format(rows=ROWS, kernel=args.kernel, graph=args.graph)
    return in_turns('ab_attention', args.tree_a, args.tree_b,
                    lambda tree, tag, turn: run_code(tree, code, tag, turn))


if __name__ == '__main__':
    sys.exit(main())
