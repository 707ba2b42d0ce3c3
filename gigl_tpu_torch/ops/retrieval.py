"""Fused in-batch retrieval loss (port of the device work of
``gigl_tpu/losses/losses.py`` ``retrieval_loss``, :95-152).

Kernel K5 ``retrieval_loss`` (``csrc/retrieval_loss.cu``) takes the score
matrix ``S [Q, C]`` (fp32 or bf16) with the query / candidate ids and
validity masks and, row by row, rebuilds the label, duplicate-query and
accidental-hit masks from the ids, so no ``[Q, C]`` mask is materialised.
The masked logit is computed in fp32 as the reference computes it::

    v_ij = S_ij / T + (dup_ij - label_ij) * finfo(S.dtype).min
    v_ij = finfo(S.dtype).min      where candidate j is masked

With a candidate sampling probability ``p [C]`` (the logQ correction,
``losses.py:119-123``; a template flag of the kernel), ``S_ij / T`` becomes
``S_ij / T - round(log(max(p_j, 1e-10)))``, the log rounded to S's type as
the reference rounds it; no cotangent flows to ``p``.

Forward (one launch): per-row ``lse`` (saved for the backward), per-row
``ce`` (0 for a masked query), ``loss_sum`` from a fixed-order reduction
(a repeat run is bit-equal) and ``count``, the number of valid queries;
the block that finishes last sums them, found by a per-device ticket
counter that is 0 between calls (:func:`forward_ticket` reads it). K5's
forward calls on one device must be ordered on one stream. Backward::

    dS_ij = g * qmask_i * (exp(v_ij - lse_i) - label_ij) * (cmask_j ? 1/T : 0)

in S's type, rounded once from fp32. :func:`_retrieval_fwd_plain` and
:func:`_retrieval_bwd_plain` are the plain twins, used for CPU tensors only;
:class:`RetrievalLoss` is the ``torch.autograd.Function`` over either pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from gigl_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class RetrievalMasks:
    """The inputs that define the masked logits besides the scores.
    ``query_ids`` ([Q] int32) turns on the duplicate-query mask;
    ``remove_accidental_hits`` needs ``candidate_ids`` ([C] int32); masks
    are bool ([Q] / [C]) or None for all valid;
    ``candidate_sampling_probability`` ([C] fp32 or None) turns on the logQ
    correction."""

    temperature: float = 1.0
    query_ids: Optional[torch.Tensor] = None
    candidate_ids: Optional[torch.Tensor] = None
    remove_accidental_hits: bool = False
    query_mask: Optional[torch.Tensor] = None
    candidate_mask: Optional[torch.Tensor] = None
    candidate_sampling_probability: Optional[torch.Tensor] = None


def _masked_logits_plain(scores: torch.Tensor,
                         a: RetrievalMasks) -> torch.Tensor:
    """v [Q, C] in fp32, exactly as the kernel forms it."""
    q, c = scores.shape
    fmin = torch.finfo(scores.dtype).min
    v = scores.float() / a.temperature
    if a.candidate_sampling_probability is not None:
        p = a.candidate_sampling_probability.float()
        v = v - torch.log(torch.clamp(p, min=1e-10)).to(scores.dtype).float()
    if a.query_ids is not None or a.remove_accidental_hits:
        dup = torch.zeros((q, c), dtype=torch.bool, device=scores.device)
        if a.query_ids is not None:
            dup[:, :q] = a.query_ids[:, None] == a.query_ids[None, :]
        if a.remove_accidental_hits:
            cids = a.candidate_ids
            dup = dup | (cids[:q, None] == cids[None, :])
        label = torch.eye(q, c, dtype=torch.float32, device=scores.device)
        v = v + (dup.float() - label) * fmin
    if a.candidate_mask is not None:
        v = torch.where(a.candidate_mask[None, :], v, fmin)
    return v


def _retrieval_fwd_plain(scores: torch.Tensor, a: RetrievalMasks
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Plain twin of K5's forward: (loss_sum f32 [], count int32 [],
    lse f32 [Q], ce f32 [Q])."""
    q, c = scores.shape
    v = _masked_logits_plain(scores, a)
    lse = torch.logsumexp(v, dim=-1)
    n = min(q, c)
    diag = torch.zeros((q,), dtype=torch.float32, device=scores.device)
    diag[:n] = v.diagonal()[:n]
    ce = lse - diag
    if a.query_mask is not None:
        ce = torch.where(a.query_mask, ce, 0.0)
        count = a.query_mask.sum().to(torch.int32)
    else:
        count = torch.tensor(q, dtype=torch.int32, device=scores.device)
    return ce.sum(), count, lse, ce


def _retrieval_bwd_plain(scores: torch.Tensor, a: RetrievalMasks,
                         lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5's backward: dS [Q, C] in scores' type."""
    q, c = scores.shape
    v = _masked_logits_plain(scores, a)
    label = torch.eye(q, c, dtype=torch.float32, device=scores.device)
    gq = g.float().expand(q)
    if a.query_mask is not None:
        gq = torch.where(a.query_mask, gq, 0.0)
    d = gq[:, None] * (torch.exp(v - lse[:, None]) - label) / a.temperature
    if a.candidate_mask is not None:
        d = torch.where(a.candidate_mask[None, :], d, 0.0)
    return d.to(scores.dtype)


def _kernel_args(scores: torch.Tensor, a: RetrievalMasks):
    """Validate for K5 and return the C arguments after S, Q, C, dtype."""
    q, c = scores.shape
    opt = [t for t in (a.query_ids, a.candidate_ids, a.query_mask,
                       a.candidate_mask, a.candidate_sampling_probability)
           if t is not None]
    device = _build.require_cuda("retrieval_loss", scores, *opt)
    if scores.dtype not in _DTYPES:
        raise ValueError(f"retrieval_loss: dtype {scores.dtype} not supported")
    for name, t, n, dtype in (("query_ids", a.query_ids, q, torch.int32),
                              ("candidate_ids", a.candidate_ids, c,
                               torch.int32),
                              ("query_mask", a.query_mask, q, torch.bool),
                              ("candidate_mask", a.candidate_mask, c,
                               torch.bool),
                              ("candidate_sampling_probability",
                               a.candidate_sampling_probability, c,
                               torch.float32)):
        if t is not None and (t.shape != (n,) or t.dtype != dtype):
            raise ValueError(f"retrieval_loss: {name} must be {dtype} [{n}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    if a.remove_accidental_hits and a.candidate_ids is None:
        raise ValueError("remove_accidental_hits requires candidate_ids")
    if (a.query_ids is not None or a.remove_accidental_hits) and c < q:
        raise ValueError("retrieval_loss: id masks need C >= Q")
    return device, (
        _build.ptr(a.query_ids), _build.ptr(a.candidate_ids),
        _build.ptr(a.query_mask), _build.ptr(a.candidate_mask),
        _build.ptr(a.candidate_sampling_probability), float(a.temperature),
        float(torch.finfo(scores.dtype).min),
        int(a.query_ids is not None), int(a.remove_accidental_hits))


def retrieval_fwd(scores: torch.Tensor, a: RetrievalMasks):
    """K5 forward: (loss_sum f32 [], count int32 [], lse f32 [Q],
    ce f32 [Q]). CPU tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _retrieval_fwd_plain(scores, a)
    device, args = _kernel_args(scores, a)
    q, c = scores.shape
    lse = torch.empty((q,), dtype=torch.float32, device=device)
    ce = torch.empty((q,), dtype=torch.float32, device=device)
    loss_sum = torch.empty((), dtype=torch.float32, device=device)
    count = torch.empty((), dtype=torch.int32, device=device)
    _build.launch("retrieval_loss", "gigl_retrieval_loss_fwd", device,
                  scores.data_ptr(), q, c, _DTYPES[scores.dtype], *args,
                  lse.data_ptr(), ce.data_ptr(), loss_sum.data_ptr(),
                  count.data_ptr())
    return loss_sum, count, lse, ce


def retrieval_bwd(scores: torch.Tensor, a: RetrievalMasks,
                  lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 backward: dS [Q, C] in scores' type for the cotangent ``g`` (a
    0-d fp32 tensor, read on the device) of loss_sum. CPU tensors take
    the plain twin."""
    if scores.device.type == "cpu":
        return _retrieval_bwd_plain(scores, a, lse, g)
    device, args = _kernel_args(scores, a)
    g = g.to(torch.float32).reshape(()).contiguous()
    _build.require_cuda("retrieval_loss", scores, lse, g)
    q, c = scores.shape
    if lse.shape != (q,) or lse.dtype != torch.float32:
        raise ValueError("retrieval_loss: lse must be f32 [Q]")
    ds = torch.empty_like(scores)
    _build.launch("retrieval_loss", "gigl_retrieval_loss_bwd", device,
                  scores.data_ptr(), q, c, _DTYPES[scores.dtype], *args,
                  lse.data_ptr(), g.data_ptr(), ds.data_ptr())
    return ds


def forward_ticket(device: torch.device) -> int:
    """K5's forward ticket counter on ``device`` (0 whenever no forward is
    in flight there), read after the work queued on the current stream."""
    out = torch.empty((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _build.library().gigl_retrieval_loss_ticket(
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gigl_retrieval_loss_ticket: cudaError {rc}")
    return int(out)


class RetrievalLoss(torch.autograd.Function):
    """(loss_sum, count) = fwd(scores, masks)[:2], differentiable in
    ``scores`` through ``bwd``. ``losses.retrieval_loss`` passes the K5
    wrappers (:func:`retrieval_fwd`, :func:`retrieval_bwd`); a caller can
    pass the plain twins instead."""

    @staticmethod
    def forward(ctx, scores, masks: RetrievalMasks, fwd: Callable,
                bwd: Callable):
        loss_sum, count, lse, _ = fwd(scores, masks)
        ctx.masks, ctx.bwd = masks, bwd
        ctx.save_for_backward(scores, lse)
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, g_loss, g_count):
        scores, lse = ctx.saved_tensors
        return ctx.bwd(scores, ctx.masks, lse, g_loss), None, None, None

