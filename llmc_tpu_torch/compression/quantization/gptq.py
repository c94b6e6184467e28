"""GPTQ (port of ``llmc_tpu/compression/quantization/gptq.py``):
error-compensated rounding from each linear's input Hessian.

H = 2/n sum x x^T per capture key, damped by ``percdamp`` times its mean
diagonal; the upper Cholesky factor of H^-1 drives a column loop in blocks
of ``blocksize`` columns: each column is quantized, its error divided by
the factor's diagonal is pushed onto the block's later columns, and each
block's errors onto the columns after it.  Options: ``actorder`` (columns
by descending diag H), ``static_groups`` (group qparams from the original
weight), OWQ (``owq`` / ``n_outs``: the most sensitive columns stay fp),
the mse calibration, and ``quant_out`` (the next block's inputs through the
static qparams the loop chose).  The layer keeps its compensated fp weight
and the loop's qparams ('gptq_scales' / 'gptq_zeros' / 'perm'), which
``static_w_qdq`` applies at deploy.

The reference runs the column loop as a ``lax.fori_loop`` inside one jit;
here it is a Python loop of torch ops on the weight's device.  The qparams
inside the loop are computed as the jitted reference computes them
(``folded``).  f32 Cholesky factors and the block-tail matmuls differ in
their last bits between XLA and torch, and the error feedback carries that
on, so codes agree with the reference's in most places, not all.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ...models.adapter import QMap
from ...models.base import LinearQcfg, get_path, set_path
from ...quant.quantizer import (fake_quant_weight_static, minmax_range,
                                mse_range, qparams_from_range, stored_qparams)
from ...utils.registry import ALGO_REGISTRY
from ..blockwise import BakedAtDeploy

F32 = torch.float32


@ALGO_REGISTRY.register(name='GPTQ')
class GPTQ(BakedAtDeploy):
    def __init__(self, model, quant_config, inputs, padding_mask, config):
        super().__init__(model, quant_config, inputs, padding_mask, config)
        sp = self.special
        self.static_groups = sp.get('static_groups', False)
        self.actorder = sp.get('actorder', False)
        self.percdamp = sp.get('percdamp', 0.01)
        self.blocksize = sp.get('blocksize', 128)
        # OWQ: the n_out columns of highest diag H stay fp; permuted to the
        # end, their error never propagates, and deploy restores them
        self.owq = sp.get('owq', False)
        self.n_outs = sp.get('n_outs', 0) if self.owq else 0
        if self.wspec.granularity == 'per_group' and not self.static_groups:
            # the in-loop group qparam search needs block == group
            self.blocksize = self.wspec.group_size
        self.check_special(sp)
        # seconds of the column loops, and their column steps (chip_smoke
        # reports their share of a block)
        self.loop_stats = {'column_loop_s': 0.0, 'columns': 0}

    @classmethod
    def check_special(cls, sp):
        """Option validation without a model (the pipeline's fail-fast
        check, before any heavy work)."""
        if sp.get('static_groups') and sp.get('owq'):
            raise ValueError('GPTQ: static_groups with owq not supported')
        if sp.get('owq') and 'n_outs' not in sp:
            raise ValueError('GPTQ: special.owq requires special.n_outs')

    # ------------------------------------------------------------------
    @staticmethod
    def _hessian(batches) -> torch.Tensor:
        """H = 2/n sum x x^T over the tokens of every batch."""
        H, n = None, 0
        for x in batches:
            x2 = x.reshape(-1, x.shape[-1]).to(F32)
            h = x2.T @ x2
            H = h if H is None else H + h
            n += x2.shape[0]
        return H * (2.0 / max(n, 1))

    # ------------------------------------------------------------------
    def block_opt(self, idx: int):
        """``quant_out`` re-forwards through the static qparams the loop
        chose, not a dynamic re-calibration."""
        block = self.model.blocks[idx]
        outs, feats = self.block_forward_capture(
            block, qmap=self.transform_qmap())
        if not self.quant_out:
            self.inputs = outs
        block = self.block_transform(idx, block, feats)
        self.model.set_block(idx, block)
        if self.quant_out:
            baked = block
            for path in self.layout.linears:
                lin = get_path(baked, path)
                if 'gptq_scales' in lin:
                    baked = set_path(baked, path,
                                     dict(lin, w=self.static_w_qdq(lin)))
            qmap = QMap({p: self.with_rotation(
                LinearQcfg(a_spec=self.aspec), p)
                for p in self.layout.linears})
            self.inputs = self.block_forward(baked, qmap=qmap)

    def subset_transform(self, idx, block, subset, feats):
        batches = feats[subset.input_key]
        # GPTQ on a QuaRot checkpoint: the rotated weight reads
        # Hadamard-rotated activations, so H is taken in that basis
        ph = self._pre_had_for(subset.layers[0])
        if ph is not None:
            from ...ops.hadamard import pre_had_apply
            batches = [pre_had_apply(x, ph[0], ph[1]) for x in batches]
        H = self._hessian(batches)
        for path in subset.layers:
            lin = get_path(block, path)
            block = set_path(block, path,
                             self.layer_transform(lin, H, path=path))
        return block

    def _n_out_of(self, path: Optional[str]) -> int:
        if not self.owq:
            return 0
        if isinstance(self.n_outs, (list, tuple)):
            return int(self.n_outs[self.layout.linears.index(path)])
        return int(self.n_outs)

    def layer_transform(self, lin: Dict, H: torch.Tensor,
                        path: Optional[str] = None) -> Dict:
        W = lin['w'].to(F32)
        oc, C = W.shape
        dead = torch.diagonal(H) == 0
        Hd = H + torch.diag(dead.to(F32))
        W = torch.where(dead[None, :], torch.zeros_like(W), W)

        n_out = self._n_out_of(path)
        perm = None
        if n_out > 0:
            # outlier columns go last
            desc = torch.argsort(-torch.diagonal(Hd), stable=True)
            if self.actorder:
                perm = torch.cat([desc[n_out:], desc[:n_out]])
            else:
                keep = torch.ones((C,), dtype=torch.bool, device=W.device)
                keep[desc[:n_out]] = False
                perm = torch.cat([torch.arange(C, device=W.device)[keep],
                                  desc[:n_out]])
        elif self.actorder:
            perm = torch.argsort(-torch.diagonal(Hd), stable=True)
        # static_groups + actorder: the group qparams of the ORIGINAL
        # column order; each permuted column looks its group up
        static_actorder = (self.static_groups and self.actorder
                           and self.wspec.granularity == 'per_group')
        static_qp = perm_gidx = None
        if static_actorder:
            gs = self.wspec.group_size
            sc, zr = [], []
            for g in range(C // gs):
                qp = self._qp_of_eager(W[:, g * gs:(g + 1) * gs])
                sc.append(qp.scales)
                zr.append(torch.broadcast_to(qp.zeros.to(F32),
                                             qp.scales.shape))
            static_qp = (torch.cat(sc, 1), torch.cat(zr, 1))
            perm_gidx = perm // gs

        if perm is not None:
            W = W[:, perm]
            Hd = Hd[perm][:, perm]

        Wq, scales, zeros, mask = self._layer_core(
            W, Hd, n_out=n_out, static_qp=static_qp, perm_gidx=perm_gidx)

        if perm is not None:
            invperm = torch.argsort(perm)
            Wq = Wq[:, invperm]
            if mask is not None:
                mask = mask[:, invperm]
        out = dict(lin, w=Wq.to(lin['w'].dtype), gptq_scales=scales)
        if zeros is not None:
            out['gptq_zeros'] = zeros
        if perm is not None:
            out['perm'] = perm
            if not static_actorder:
                # the in-loop group search's qparams follow the PERMUTED
                # columns; static_actorder keeps the original groups'
                out['gptq_perm_qp'] = True
        if mask is not None:
            out['spqr_mask'] = mask   # SpQR's fp outliers
        if n_out > 0:
            out['owq_n_out'] = n_out
        return out

    # ------------------------------------------------------------------
    def _qp_of_eager(self, cols):
        spec = self.wspec
        pc = spec.replace(granularity='per_channel')
        rng = mse_range(pc, cols) if spec.calib_algo == 'mse' \
            else minmax_range(pc, cols)
        return qparams_from_range(spec, rng)

    def _qp_of(self, cols, valid=None):
        """qparams of a column group of the current W, as the jitted loop
        computes them; ``valid`` masks OWQ's outlier columns out of the
        range (minmax)."""
        spec = self.wspec
        if valid is not None:
            big = 3e38
            lo = torch.amin(torch.where(valid, cols, torch.full_like(cols, big)),
                            dim=1, keepdim=True)
            hi = torch.amax(torch.where(valid, cols,
                                        torch.full_like(cols, -big)),
                            dim=1, keepdim=True)
            lo = torch.clamp(lo, max=0.0)
            hi = torch.clamp(hi, min=0.0)
            return qparams_from_range(spec, (lo, hi), folded=True)
        pc = spec.replace(granularity='per_channel')
        rng = mse_range(pc, cols) if spec.calib_algo == 'mse' \
            else minmax_range(pc, cols)
        return qparams_from_range(spec, rng, folded=True)

    # hooks of the column loop, which SpQR overrides
    def _outlier_threshold(self, W, Hinv) -> Optional[torch.Tensor]:
        """The threshold on a column's squared error (over the factor's
        diagonal) above which an element stays fp; None: none does."""
        return None

    def _group_qparams(self, Wb, Hb, valid, thr):
        """(scales, zeros) [oc, 1] of the block ``Wb`` that is one group
        (``Hb`` its block of the factor; ``valid`` OWQ's mask)."""
        qp = self._qp_of(Wb, valid=valid)
        return qp.scales, torch.broadcast_to(qp.zeros.to(F32),
                                             qp.scales.shape)

    def _column_err(self, w, qdq, d, thr):
        """(the error of column ``w`` against its quantized ``qdq`` over
        the factor's diagonal ``d``, its fp outlier marks or None)."""
        return (w - qdq) / d, None

    def _layer_core(self, W, H, n_out: int = 0, static_qp=None,
                    perm_gidx=None):
        """Damping, Cholesky and the blocked compensation.  Returns (the
        compensated W, scales [oc, ng], zeros [oc, ng] or None, the fp
        outlier marks [oc, C] where ``_outlier_threshold`` sets a
        threshold, else None).  With ``n_out`` (OWQ) the last n_out columns
        are left out of every qparam range; with ``static_qp`` each column
        takes its original group's qparams through ``perm_gidx``."""
        t0 = time.perf_counter()
        spec = self.wspec
        oc, C = W.shape
        dev = W.device
        n_nonout = C - n_out
        eye = torch.eye(C, dtype=F32, device=dev)
        damp = self.percdamp * (torch.diagonal(H).sum() * (1.0 / C))
        H = H + damp * eye
        # the upper Cholesky factor U of H^-1 (H^-1 = U^T U)
        Lc = torch.linalg.cholesky(H)
        Hinv = torch.linalg.cholesky(torch.cholesky_solve(eye, Lc)).T
        thr = self._outlier_threshold(W, Hinv)
        bs = min(self.blocksize, C)
        gs = spec.group_size if spec.granularity == 'per_group' else C
        ng = C // gs
        use_perm_groups = static_qp is not None
        # static_groups without actorder: a block may span several groups
        # or part of one; each column's group qparams come from the
        # per-original-group table
        static_group_cols = (spec.granularity == 'per_group'
                             and self.static_groups and not use_perm_groups)
        if spec.granularity != 'per_group':
            qp_static = self._qp_of(W[:, :n_nonout] if n_out else W)
        elif static_group_cols:
            sc, zr = [], []
            for g in range(ng):
                qp = self._qp_of(W[:, g * gs:(g + 1) * gs])
                sc.append(qp.scales)
                zr.append(torch.broadcast_to(qp.zeros.to(F32),
                                             qp.scales.shape))
            qp_groups = (torch.cat(sc, 1), torch.cat(zr, 1))

        scales_out = torch.zeros((oc, ng), dtype=F32, device=dev)
        zeros_out = torch.zeros((oc, ng), dtype=F32, device=dev)
        W = W.clone()
        Q = torch.zeros_like(W)
        mask = None if thr is None else torch.zeros_like(W)
        assert C % bs == 0, (C, bs)
        for i1 in range(0, C, bs):
            Wb = W[:, i1:i1 + bs].clone()
            Hb = Hinv[i1:i1 + bs, i1:i1 + bs]
            s = z = None
            if use_perm_groups or static_group_cols:
                gcol = (perm_gidx[i1:i1 + bs] if use_perm_groups else
                        torch.arange(i1, i1 + bs, device=dev) // gs)
                table = static_qp if use_perm_groups else qp_groups
                s_cols = table[0][:, gcol]           # [oc, bs]
                z_cols = table[1][:, gcol]
            elif spec.granularity == 'per_group':
                # block == group; OWQ masks the outlier tail out
                valid = ((i1 + torch.arange(bs, device=dev))[None, :]
                         < n_nonout) if n_out else None
                s, z = self._group_qparams(Wb, Hb, valid, thr)
                g0 = i1 // gs
                scales_out[:, g0:g0 + bs // gs] = s
                zeros_out[:, g0:g0 + bs // gs] = z
            else:
                s = qp_static.scales
                z = torch.broadcast_to(qp_static.zeros.to(F32), s.shape)
            Errb = torch.zeros_like(Wb)
            for i in range(bs):
                # column i of Wb is final from here on (the updates below
                # reach the later columns only): after the loop Wb holds
                # every column's compensated pre-quant value
                w = Wb[:, i:i + 1]
                d = Hb[i, i]
                if s is None:
                    si, zi = s_cols[:, i:i + 1], z_cols[:, i:i + 1]
                else:
                    si, zi = s, z
                if spec.round_zp:
                    q = torch.clamp(torch.round(w / si) + zi, spec.qmin,
                                    spec.qmax)
                else:
                    q = torch.clamp(torch.round(
                        w / torch.clamp(si, min=1e-9) + zi),
                        spec.qmin, spec.qmax)
                err, m = self._column_err(w, (q - zi) * si, d, thr)
                if m is not None:
                    mask[:, i1 + i:i1 + i + 1] = m
                Wb[:, i + 1:] -= err * Hb[i, i + 1:][None, :]
                Errb[:, i:i + 1] = err
            Q[:, i1:i1 + bs] = Wb
            if i1 + bs < C:
                W[:, i1 + bs:] -= Errb @ Hinv[i1:i1 + bs, i1 + bs:]
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        self.loop_stats['column_loop_s'] += time.perf_counter() - t0
        self.loop_stats['columns'] += C

        # Q holds the compensated pre-quant weights: 'transformed' saves
        # stay usable, and a static qdq with the stored qparams reproduces
        # the loop's quantization
        if use_perm_groups:
            scales_out, zeros_out = static_qp
        elif static_group_cols:
            scales_out, zeros_out = qp_groups
        zeros_ret = None if (spec.symmetric and spec.round_zp) else zeros_out
        if spec.granularity != 'per_group':
            scales_ret = qp_static.scales.reshape(oc, -1)
        else:
            scales_ret = scales_out
        return Q, scales_ret, zeros_ret, mask

    # ------------------------------------------------------------------
    # deploy: the static qdq with the loop's qparams
    # ------------------------------------------------------------------
    def static_w_qdq(self, lin: Dict,
                     n_out: Optional[int] = None) -> torch.Tensor:
        w = lin['w'].to(F32)
        C = w.shape[1]
        perm = lin.get('perm')
        if self.static_groups:
            # static group qparams live on the ORIGINAL columns: the qdq is
            # per column, so the permutation does not matter
            perm = None
        if perm is not None:
            w = w[:, perm]
        out = fake_quant_weight_static(self.wspec, w, stored_qparams(lin))
        if n_out is None:
            n_out = lin.get('owq_n_out', 0)
        if n_out:  # OWQ: the outlier tail stays fp
            out = torch.cat([out[:, :C - n_out], w[:, C - n_out:]], dim=1)
        if perm is not None:
            out = out[:, torch.argsort(perm)]
        return out.to(lin['w'].dtype)
