"""Losses (port of ``gigl_tpu/losses/losses.py``: ``margin_loss``,
``softmax_loss``, ``retrieval_loss`` for link prediction,
``cross_entropy_loss`` for node classification).

Every loss returns ``(loss_sum, count)`` over static-shape scores with
validity masks, as the reference does. ``retrieval_loss`` runs on kernel K5
(``gigl_tpu_torch/ops/retrieval.py``), forward and backward; the others are
plain PyTorch (differentiated by autograd) — the reference has no kernel
for them either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gigl_tpu_torch.ops.retrieval import (
    RetrievalLoss,
    RetrievalMasks,
    retrieval_bwd,
    retrieval_fwd,
)

Tensor = torch.Tensor


def margin_loss(
    pos_scores: Tensor,          # [Q, P]
    neg_scores: Tensor,          # [Q, N]  (hard negs ++ random negs)
    *,
    margin: float = 0.5,
    pos_mask: Optional[Tensor] = None,   # [Q, P] bool
    neg_mask: Optional[Tensor] = None,   # [Q, N] bool
) -> Tuple[Tensor, Tensor]:
    """Margin ranking over all valid (pos, neg) pairs, sum reduction;
    count = number of valid pairs."""
    diff = torch.clamp(
        margin - pos_scores[:, :, None] + neg_scores[:, None, :], min=0.0)
    if pos_mask is None:
        pos_mask = torch.ones(pos_scores.shape, dtype=torch.bool,
                              device=pos_scores.device)
    if neg_mask is None:
        neg_mask = torch.ones(neg_scores.shape, dtype=torch.bool,
                              device=neg_scores.device)
    pair_mask = pos_mask[:, :, None] & neg_mask[:, None, :]
    return (torch.where(pair_mask, diff, 0.0).sum(),
            pair_mask.sum().to(torch.int32))


def softmax_loss(
    pos_scores: Tensor,          # [Q, P]
    neg_scores: Tensor,          # [Q, N]
    *,
    temperature: float = 1.0,
    pos_mask: Optional[Tensor] = None,
    neg_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-positive softmax CE against the shared negatives (masked
    negatives at dtype-min), sum reduction; count = valid positives."""
    if pos_mask is None:
        pos_mask = torch.ones(pos_scores.shape, dtype=torch.bool,
                              device=pos_scores.device)
    neg = neg_scores
    if neg_mask is not None:
        neg = torch.where(neg_mask, neg_scores,
                          torch.finfo(neg_scores.dtype).min)
    logits = torch.cat(
        [pos_scores[:, :, None],
         neg[:, None, :].expand(pos_scores.shape + (neg.shape[-1],))],
        dim=-1) / temperature
    ce = torch.logsumexp(logits, dim=-1) - logits[..., 0]
    return (torch.where(pos_mask, ce, 0.0).sum(),
            pos_mask.sum().to(torch.int32))


def retrieval_masks(
    *,
    temperature: Optional[float] = None,
    query_ids: Optional[Tensor] = None,
    candidate_ids: Optional[Tensor] = None,
    remove_accidental_hits: bool = False,
    query_mask: Optional[Tensor] = None,
    candidate_mask: Optional[Tensor] = None,
    candidate_sampling_probability: Optional[Tensor] = None,
) -> RetrievalMasks:
    """K5's description of the masked logits (ids as int32, masks as
    bool, the sampling probability as fp32); the arguments are
    :func:`retrieval_loss`'s."""
    if remove_accidental_hits and candidate_ids is None:
        raise ValueError("remove_accidental_hits requires candidate_ids")

    def opt(t, dtype):
        return None if t is None else t.to(dtype).contiguous()

    return RetrievalMasks(
        temperature=1.0 if temperature is None else float(temperature),
        query_ids=opt(query_ids, torch.int32),
        candidate_ids=opt(candidate_ids if remove_accidental_hits else None,
                          torch.int32),
        remove_accidental_hits=bool(remove_accidental_hits),
        query_mask=opt(query_mask, torch.bool),
        candidate_mask=opt(candidate_mask, torch.bool),
        candidate_sampling_probability=opt(candidate_sampling_probability,
                                           torch.float32))


def retrieval_loss(
    scores: Tensor,                              # [Q, C]
    *,
    temperature: Optional[float] = None,
    candidate_sampling_probability: Optional[Tensor] = None,  # [C]
    query_ids: Optional[Tensor] = None,          # [Q]
    candidate_ids: Optional[Tensor] = None,      # [C]
    remove_accidental_hits: bool = False,
    query_mask: Optional[Tensor] = None,         # [Q] valid rows
    candidate_mask: Optional[Tensor] = None,     # [C] valid columns
) -> Tuple[Tensor, Tensor]:
    """In-batch sampled-softmax retrieval loss, sum reduction: labels are
    the diagonal of ``[Q, C]``; duplicate-query and accidental-hit cells
    and masked candidate columns go to dtype-min. With
    ``candidate_sampling_probability`` (the count-min sketch's estimate) each
    column's logit loses ``log(max(p_j, 1e-10))``, rounded to the scores'
    type (the logQ correction). Returns (loss_sum f32, count int32). Runs on
    kernel K5 (plain twin on the CPU)."""
    if candidate_sampling_probability is not None \
            and tuple(candidate_sampling_probability.shape) \
            != (scores.shape[1],):
        raise ValueError("candidate_sampling_probability must be [C] = "
                         f"[{scores.shape[1]}], got "
                         f"{tuple(candidate_sampling_probability.shape)}")
    masks = retrieval_masks(
        temperature=temperature, query_ids=query_ids,
        candidate_ids=candidate_ids,
        remove_accidental_hits=remove_accidental_hits,
        query_mask=query_mask, candidate_mask=candidate_mask,
        candidate_sampling_probability=candidate_sampling_probability)
    return RetrievalLoss.apply(scores.contiguous(), masks, retrieval_fwd,
                               retrieval_bwd)


def cross_entropy_loss(logits: Tensor, labels: Tensor, *,
                       mask: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor]:
    """Softmax cross entropy ``logsumexp(logits) - logits[label]`` per row,
    sum reduction, over the rows where ``mask`` (bool [N]) is set; count =
    the masked rows (int32), or every row without a mask."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    ce = logz - ll
    if mask is not None:
        return (torch.where(mask, ce, 0.0).sum(),
                mask.sum().to(torch.int32))
    return ce.sum(), torch.tensor(logits.shape[0], dtype=torch.int32,
                                  device=logits.device)
