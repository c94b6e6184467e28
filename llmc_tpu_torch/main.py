"""The compression pipeline (port of ``llmc_tpu/main.py``): config -> model ->
calibration data -> blockwise optimization -> evals -> save.  Entry points:

    python -m llmc_tpu_torch --config cfg.yml [--device cpu]
    run_pipeline(cfg_dict, device=None)

``device=None`` is the CUDA device, and raises without one; the CPU is
taken only when asked for.  Every model of ``MODEL_REGISTRY`` builds from
``model.path`` or an inline ``model.arch``: Llama and the Llama-family and
generalized-graph families (Qwen2, Qwen3, Gemma2, Bloom, ...) and the MoE
families.  Ported: the quantization methods registered
in ``ALGO_REGISTRY`` (RTN, Awq, SmoothQuant, GPTQ, Quarot, OsPlus,
LlmInt8, HQQ, AdaDim, QUIK, SpQR, DGQ, and the gradient-trained
NormTweaking, OmniQuant and TesseraQ; their options checked by
``check_special`` before any heavy work), weight and activation
quantization, the KV-cache quantizers (``quant.kvcache``: Naive, Kivi,
SinkKV, ShadowKV), the sparsifiers of a ``sparse`` section (Dense,
Magnitude, Wanda, ShortGPT: deployed before the transformed eval, where
ShortGPT removes its blocks), the PPL, decode-PPL, token-consistency,
latency, custom-generation and code evals at ``pretrain`` /
``transformed`` / ``fake_quant`` / ``fake_quant_wo_kv`` (the fake-quant
deploy over an fp KV cache; a PPL entry also block by block with
``inference_per_block``), ``save_trans`` / ``save_fake`` (OPT's in its own
HF names), the backend exports (``save_vllm``, ``save_sgl``,
``save_lightllm``, ``save_autoawq``, ``save_mlcllm``, ``save_trtllm``:
``export/``), ``model.offload`` (the blocks in host memory, one on the
device at a time: ``utils/offload.py``) and the opencompass shell-out.
The LLaVA tier (``Llava``, ``LlavaHf``, ``VideoLlava``), ``Qwen2vl``,
``InternVL2``, ``LlavaOneVision`` and ``Vit`` run with their ``vision``
modality (``MiniCPMV`` compresses its LM only, as in the reference): a
``quant: {vision: ..., language: ...}`` section calibrates the tower, then
the LM (``set_modality``), and the fake-quant evals take each modality's
own deploy (``ModalQMap``: each tower takes only its own QMap, ROADMAP
C); ``sparse: {method: TokenReduction}`` installs a token reduction; the
``acc`` and ``vqa`` evals build their labels from the pretrain model
before any calibration.
Another model's ``vision`` modality raises (ROADMAP A13e).
Data parallel calibration raises ``NotImplementedError`` (ROADMAP A14),
``save_lightx2v`` too (it needs the Wan model, ROADMAP A13e), and so does
a backend export of float weights, before any work (the reference fails
on it after its evals: ROADMAP C).

As in the reference, a ``sparse.kvcache`` section reaches no eval: a
sparsifier has no KV policy (ROADMAP C).  The port warns that it is not
applied and otherwise computes what the reference computes.  A
sparsifier's ``deploy`` returns no QMap, so its fake-quant evals run its
params as they are, where the reference's ShortGPT passes its list of
removed blocks on as a QMap and fails (ROADMAP C).
"""

from __future__ import annotations

import argparse
import os
import time
import warnings
from typing import Dict

import torch

from . import compression  # noqa: F401  (registers ALGO_REGISTRY entries)
from .data import CalibDataset
from .eval.orchestrate import EvalOrchestrator
from .export import BACKENDS, export_backends
from .models import build_model
from .models.adapter import ModalQMap
from .quant.qspec import spec_from_config
from .utils import (ALGO_REGISTRY, Cfg, check_config, get_modality,
                    load_config, resolve_device, seed_all)
from .utils.profiler import PhaseTimer, trace


# the model types whose vision modality the port calibrates, and those
# whose reference compresses the language model only
VISION_MODELS = ('Llava', 'LlavaHf', 'VideoLlava', 'VideoLLaVA', 'Vit',
                 'Qwen2vl', 'InternVL2', 'LlavaOneVision')
LANGUAGE_ONLY_VLMS = ('MiniCPMV',)


def deploy_modalities(model, opts, quant_format: str):
    """The deploy of ``quant_format`` over every modality's algorithm, in
    (modality, algorithm) order: each deploys on its own block stack.  A
    VLM whose tower was compressed gets a ``ModalQMap`` (the LM's QMap, and
    the tower's beside it); otherwise the last algorithm's deploy, as in
    the reference."""
    if not opts:
        return None
    if not hasattr(model, 'set_modality'):
        return opts[-1][1].deploy(quant_format)
    qmaps = {}
    for modality, opt in opts:
        model.set_modality(modality)
        qmaps[modality] = opt.deploy(quant_format)
    model.set_modality('language')
    if qmaps.get('vision') is None:
        return qmaps.get('language')
    return ModalQMap(qmaps.get('language'), qmaps['vision'])


def _check_ported(config: Cfg) -> None:
    """Raise before any heavy work for what the port does not run yet."""
    if int((config.get('parallel', {}) or {}).get('dp', 1) or 1) > 1:
        raise NotImplementedError(
            'parallel.dp > 1 (data-parallel calibration) is not ported yet '
            '(ROADMAP A14)')
    save = config.get('save', {}) or {}
    if save.get('save_lightx2v'):
        raise NotImplementedError(
            'save.save_lightx2v (the Wan video export) is not ported yet '
            '(ROADMAP A13e)')
    if 'opencompass' in config and not save.get('save_trans'):
        raise ValueError('opencompass eval requires save.save_trans')
    exports = [f for f in BACKENDS if save.get(f)]
    for modality, mcfg in get_modality(config):
        if modality != 'language' and config['model']['type'] in \
                LANGUAGE_ONLY_VLMS:
            raise ValueError(
                f'{config["model"]["type"]} compresses the language model '
                f'only, as in the reference: no {modality!r} modality')
        if modality != 'language' and not (
                modality == 'vision'
                and config['model']['type'] in VISION_MODELS):
            raise NotImplementedError(
                f'modality {modality!r} of {config["model"]["type"]} is not '
                f'ported yet (ROADMAP A13e)')
        wspec = spec_from_config(mcfg.get('weight')) if exports else None
        if wspec is not None and wspec.is_float:
            raise NotImplementedError(
                f'save.{exports[0]} of float weights: the reference writes no '
                f'float-quantized checkpoint (it fails on int('
                f'{mcfg["weight"].get("bit")!r}) after its evals: ROADMAP C)')
        # an unknown algorithm raises here; an invalid option combination
        # raises before any heavy work (eval_pretrain can take minutes)
        check = getattr(ALGO_REGISTRY[mcfg['method']], 'check_special', None)
        if check is not None:
            check(mcfg.get('special', {}) or {})


def run_pipeline(config: Dict, device=None) -> Dict:
    """Run the whole pipeline; returns the eval metrics per position, the
    wall time of every phase (``phase_times``, each ending in a device
    synchronise), the model (``model``), the algorithm object (``opt``)
    and the fake-quant evals' deploy (``deploy``: a VLM's ``ModalQMap``;
    None where no fake-quant eval ran)."""
    dev = resolve_device(device)
    config = Cfg(config)
    check_config(config)
    _check_ported(config)
    if 'kvcache' in (config.get('sparse', {}) or {}):
        warnings.warn(
            'sparse.kvcache is not applied: a sparsifier has no KV-cache '
            'policy, so no eval reads it, as in the reference (ROADMAP C)')
    seed_all(config.get('base', {}).get('seed', 42))
    results = {}
    timer = PhaseTimer()
    t0 = time.time()

    with timer.phase('build_model'):
        model = build_model(config, device=dev)
    orch = EvalOrchestrator(config, model)
    with timer.phase('eval_pretrain'):
        # the VQA answers and synthetic accuracy labels are the pretrain
        # model's: built before calibration changes the weights
        orch.prebuild(model)
        if orch.wants('pretrain'):
            results.update(orch.run('pretrain', model))

    blockwise_opt, opts = None, []
    for modality, mcfg in get_modality(config):
        if hasattr(model, 'set_modality'):
            model.set_modality(modality)
        calib_cfg = config.get('calib')
        algo_cls = ALGO_REGISTRY[mcfg['method']]
        if calib_cfg and getattr(algo_cls, 'needs_calib', True):
            with timer.phase('calib_data'):
                dataset = CalibDataset(calib_cfg, model.tokenizer)
                batches, padding_mask = dataset.get_calib_dataset()
                xs, kws = model.collect_first_block_input(batches)
            inputs = {'data': xs, 'kwargs': kws}
        else:
            inputs, padding_mask = {'data': [], 'kwargs': []}, None
        blockwise_opt = algo_cls(model, mcfg, inputs, padding_mask, config)
        with timer.phase(f"calib_{mcfg['method']}"), \
                trace(config.get('base', {}).get('trace_dir')):
            blockwise_opt.run_block_loop()
        opts.append((modality, blockwise_opt))
    if hasattr(model, 'set_modality'):
        model.set_modality('language')   # the evals run the LM's stack

    if orch.wants('transformed'):
        # an online-rotate checkpoint keeps its Hadamard in the fp evals;
        # ShortGPT removes its blocks here, as in the reference
        tmap = deploy_modalities(model, opts, 'transformed')
        with timer.phase('eval_transformed'):
            results.update(orch.run('transformed', model, qmap=tmap))
    qmap = None
    if blockwise_opt is not None and (orch.wants('fake_quant')
                                      or orch.wants('fake_quant_wo_kv')):
        qmap = deploy_modalities(model, opts, 'fake_quant')
        if orch.wants('fake_quant'):
            with timer.phase('eval_fake_quant'):
                results.update(orch.run('fake_quant', model, qmap=qmap,
                                        kv_policy=blockwise_opt.kv_module))
        if orch.wants('fake_quant_wo_kv'):
            # the same deploy over an fp KV cache: what the KV quantizer
            # costs, apart
            with timer.phase('eval_fake_quant_wo_kv'):
                results.update(orch.run('fake_quant_wo_kv', model,
                                        qmap=qmap))

    save = config.get('save', {}) or {}
    if save.get('save_trans') or save.get('save_fake'):
        out = save.get('save_path', './save')
        # skip the baking if a fake_quant deploy already did it: a second
        # pass would compute minmax qparams on quantized weights
        if save.get('save_fake') and blockwise_opt is not None \
                and not getattr(blockwise_opt, '_baked', False):
            blockwise_opt.bake_fake_quant_weights()
            blockwise_opt._baked = True
        with timer.phase('save'):
            model.save_to_hf(out)
        results['saved_to'] = out
    if any(save.get(f) for f in list(BACKENDS) + ['save_trtllm']):
        with timer.phase('save'):
            outs = export_backends(model, blockwise_opt, save)
        if outs:
            results['saved_to'] = outs[-1]
    if 'opencompass' in config:
        results['opencompass_rc'] = run_opencompass(
            config['opencompass'], save)

    results['wall_s'] = time.time() - t0
    results['phase_times'] = timer.as_dict()
    results['device'] = (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else 'cpu')
    results['model'] = model
    results['opt'] = blockwise_opt
    results['deploy'] = qmap
    return results


def run_opencompass(oc: Dict, save: Dict) -> int:
    """The OpenCompass eval on the saved transformed checkpoint, in a
    process of its own (the reference's shell-out): its exit code.  Raises
    ``ValueError`` without ``save.save_trans`` and ``RuntimeError``, with
    the command line, where the ``opencompass`` binary is missing."""
    if not save.get('save_trans'):
        raise ValueError('opencompass eval requires save.save_trans')
    import shutil
    import subprocess
    binary = shutil.which('opencompass')
    cmd = [binary or 'opencompass', oc['cfg_path'], '-w', oc['output_path'],
           '--llmc_eval_mode', 'quant', '--llmc_model_path',
           os.path.abspath(save.get('save_path', './save'))]
    if binary is None:
        raise RuntimeError(
            'opencompass is not installed; install it and re-run: '
            + ' '.join(cmd))
    return subprocess.call(cmd)


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m llmc_tpu_torch')
    ap.add_argument('--config', required=True)
    ap.add_argument('--device', default=None,
                    help="'cpu' to run the plain PyTorch path on the CPU; "
                         'default: the CUDA device')
    ap.add_argument('--task_id', default='0')
    args = ap.parse_args(argv)
    results = run_pipeline(load_config(args.config), device=args.device)
    for k, v in results.items():
        if isinstance(v, (int, float, str)):
            print(f'{k}: {v}')
    for k, v in results['phase_times'].items():
        print(f'phase {k}: {v:.3f} s')


if __name__ == '__main__':
    main()
