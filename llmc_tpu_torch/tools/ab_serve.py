"""Time the serving phases of two checkouts of the repository on one card,
in turns, so that they are compared inside one run (a host's speed
differs from run to run, the card's does not).

    python -m llmc_tpu_torch.tools.ab_serve TREE_A TREE_B [--modes w4a16 w8a16]
        [--batch 128] [--prefill 32]

Each run is a subprocess in a tree's root: it imports that tree's
``chip_smoke`` and ``llmc_tpu_torch``, builds that tree's kernels and, for
each serving mode, makes the random packed Llama-2-7B of ``chip_smoke``
(seed 0) and runs its ``throughput`` phase (``--batch`` slots, a prefill
of ``--prefill`` tokens each, 64 decode steps: TTFT and ms a step; the
bench's B=128 and 32 by default) and its ``profile`` phase at the same
shape (device ms a step).  ``--batch 8 --prefill 1024`` is the
long-context row of ``chip_smoke``'s profile.
The trees run in the order A, B, B, A; every phase prints one JSON line
tagged with its tree and turn, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from ..utils.device import nvidia_smi_line

_RUN = '''
import json, torch
import chip_smoke as C
from llmc_tpu_torch.ops import _build
dev = torch.device('cuda')
torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
for mode in {modes!r}:
    model, qmap = C.make_model(mode, C.LLAMA2_7B, dev)
    for rec in (C.phase_throughput(dev, model, qmap, B={batch},
                                   prefill={prefill}, mode=mode),
                C.phase_profile(dev, model, qmap, B={batch},
                                prefill={prefill}, mode=mode)):
        ok = rec.pop('launches') == rec.pop('expected_launches')
        print(json.dumps(dict(rec, launches_as_expected=ok)), flush=True)
    del model, qmap
    torch.cuda.empty_cache()
'''


def run_tree(tree: Path, modes, tag: str, turn: int, batch: int = 128,
             prefill: int = 32) -> list:
    """One subprocess in ``tree``: its records, tagged."""
    code = _RUN.format(modes=modes, batch=int(batch), prefill=int(prefill))
    return run_code(tree, code, tag, turn)


def run_code(tree: Path, code: str, tag: str, turn: int) -> list:
    """``python -c code`` in ``tree``'s root: the JSON lines it prints,
    tagged with the tree and the turn."""
    out = subprocess.run([sys.executable, '-c', code], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f'{tree}: exit {out.returncode}\n'
                           f'{out.stderr[-4000:]}')
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith('{')]
    return [dict(r, tree=tag, turn=turn) for r in recs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('tree_a', type=Path)
    ap.add_argument('tree_b', type=Path)
    ap.add_argument('--modes', nargs='+', default=['w4a16', 'w8a16'])
    ap.add_argument('--batch', type=int, default=128,
                    help='slots of the throughput and profile phases')
    ap.add_argument('--prefill', type=int, default=32,
                    help='prompt tokens a slot before the decode steps')
    args = ap.parse_args(argv)
    return in_turns('ab_serve', args.tree_a, args.tree_b,
                    lambda tree, tag, turn: run_tree(
                        tree, list(args.modes), tag, turn, args.batch,
                        args.prefill))


def in_turns(tool: str, tree_a: Path, tree_b: Path, run) -> int:
    """``run(tree, tag, turn)`` in the order A, B, B, A, printing its
    records after the card's name and power limit; 2 without a card."""
    import torch
    if not torch.cuda.is_available():
        print(f'{tool}: no CUDA device', file=sys.stderr)
        return 2
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': nvidia_smi_line()}), flush=True)
    order = [('A', tree_a), ('B', tree_b), ('B', tree_b), ('A', tree_a)]
    for turn, (tag, tree) in enumerate(order):
        for rec in run(tree.resolve(), tag, turn):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
