"""Eval metrics: Hits@K and mean reciprocal rank for link prediction,
accuracy for node classification (port of ``gigl_tpu/losses/metrics.py``
``_ranks``, ``hits_at_k``, ``mean_reciprocal_rank``, ``accuracy``). Each
returns sums and a count; the caller divides."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


def _ranks(pos_scores: Tensor, neg_scores: Tensor,
           neg_mask: Optional[Tensor] = None) -> Tensor:
    """Rank of each positive among [pos, negatives], 1 = best. neg_scores
    is [Q, N] or a shared [N]; ties count against the positive
    (``(neg >= pos).sum() + 1``)."""
    if neg_scores.dim() == 1:
        neg_scores = neg_scores[None, :].expand(pos_scores.shape[0], -1)
    ge = neg_scores >= pos_scores[:, None]
    if neg_mask is not None:
        ge = ge & (neg_mask[None, :] if neg_mask.dim() == 1 else neg_mask)
    return ge.sum(dim=-1) + 1


def _valid(pos_scores: Tensor, pos_mask: Optional[Tensor]) -> Tensor:
    if pos_mask is None:
        return torch.ones(pos_scores.shape, dtype=torch.bool,
                          device=pos_scores.device)
    return pos_mask


def hits_at_k(
    pos_scores: Tensor,
    neg_scores: Tensor,
    ks: Sequence[int],
    *,
    pos_mask: Optional[Tensor] = None,
    neg_mask: Optional[Tensor] = None,
) -> Tuple[Dict[int, Tensor], Tensor]:
    """({k: number of valid positives ranked <= k}, count)."""
    ranks = _ranks(pos_scores, neg_scores, neg_mask)
    valid = _valid(pos_scores, pos_mask)
    hits = {int(k): (valid & (ranks <= k)).sum() for k in ks}
    return hits, valid.sum()


def mean_reciprocal_rank(
    pos_scores: Tensor,
    neg_scores: Tensor,
    *,
    pos_mask: Optional[Tensor] = None,
    neg_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(sum of 1/rank over valid positives, count)."""
    rr = 1.0 / _ranks(pos_scores, neg_scores, neg_mask).float()
    valid = _valid(pos_scores, pos_mask)
    return torch.where(valid, rr, 0.0).sum(), valid.sum()


def accuracy(logits: Tensor, labels: Tensor, *,
             mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(number of rows whose argmax is the label, count) over the rows
    where ``mask`` is set, or every row."""
    correct = logits.argmax(dim=-1) == labels
    if mask is not None:
        return (correct & mask).sum(), mask.sum()
    return correct.sum(), torch.tensor(labels.shape[0], dtype=torch.int32,
                                       device=labels.device)
