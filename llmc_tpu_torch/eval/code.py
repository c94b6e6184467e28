"""HumanEval code generation (port of ``llmc_tpu/eval/code.py``): each
problem's prompt, greedily continued through ``serve.decode.
greedy_generate`` (on the card, B2 reads the cache where the graph lets a
kernel take it), cut at the reference's stop strings and written to
``samples.jsonl``; each task's generated token ids stay on the object
(``token_ids``), for holding one run to another where the decode or the
stop strings could hide a difference.  pass@k comes from the optional
``human_eval`` package; without it the samples path is returned with the
reference's note.
Problems come from a JSONL file (``path``) or, without one, from
``human_eval``'s own set.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

STOPS = ('\ndef ', '\nclass ', '\nif __name__', '\nprint(', '\n#')


class HumanEval:
    def __init__(self, problem_file: Optional[str] = None,
                 max_new_tokens: int = 256, n_samples_per_task: int = 1,
                 res_path: str = './humaneval_out'):
        self.problem_file = problem_file
        self.max_new_tokens = max_new_tokens
        self.n_samples = n_samples_per_task
        self.res_path = res_path

    def _load_problems(self) -> Dict[str, Dict]:
        if self.problem_file and os.path.exists(self.problem_file):
            problems = {}
            with open(self.problem_file) as f:
                for line in f:
                    if line.strip():
                        p = json.loads(line)
                        problems[p['task_id']] = p
            return problems
        from human_eval.data import read_problems  # optional package
        return read_problems()

    @staticmethod
    def _truncate(completion: str) -> str:
        """Cut at each stop string in turn (the first top-level statement
        after the function body)."""
        for stop in STOPS:
            idx = completion.find(stop)
            if idx >= 0:
                completion = completion[:idx]
        return completion

    def eval(self, model, qmap=None) -> Dict:
        from ..serve.decode import greedy_generate
        problems = self._load_problems()
        tok = model.tokenizer
        samples: List[Dict] = []
        self.token_ids: Dict[str, List[int]] = {}
        for task_id, prob in problems.items():
            ids = np.asarray(tok(prob['prompt'])['input_ids'],
                             np.int64)[None, :]
            out = greedy_generate(model, ids, self.max_new_tokens, qmap=qmap,
                                  device=model.device)
            new = out[0, ids.shape[1]:].cpu().numpy()
            self.token_ids[task_id] = new.tolist()
            samples.append({'task_id': task_id, 'completion': self._truncate(
                tok.decode(new, skip_special_tokens=True))})
        os.makedirs(self.res_path, exist_ok=True)
        sample_file = os.path.join(self.res_path, 'samples.jsonl')
        with open(sample_file, 'w') as f:
            for s in samples:
                f.write(json.dumps(s) + '\n')
        try:
            from human_eval.evaluation import evaluate_functional_correctness
        except ImportError:
            return {'samples': sample_file,
                    'note': 'human_eval package not installed; '
                            'completions written for offline scoring'}
        return evaluate_functional_correctness(sample_file)
