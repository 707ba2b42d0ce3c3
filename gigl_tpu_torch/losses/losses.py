"""Losses (port of ``gigl_tpu/losses/losses.py``: ``margin_loss``,
``softmax_loss``, ``retrieval_loss`` for link prediction,
``cross_entropy_loss`` for node classification, and the self-supervised
and ranking family: ``grace_loss``, ``bgrl_loss``, ``tbgrl_loss``,
``gbt_loss``, ``whitening_decorrelation_loss``,
``feature_reconstruction_loss``, ``alignment_loss``, ``uniformity_loss``,
``kl_loss``, ``llp_ranking_loss``).

The link-prediction and classification losses return ``(loss_sum,
count)`` over static-shape scores with validity masks, as the reference's
do; the self-supervised ones a mean, with the reference's epsilons (1e-8
in the cosines, 1e-12 in the alignment and uniformity norms) and its
biased standard deviation (ddof 0). ``retrieval_loss`` runs on kernel K5
(``gigl_tpu_torch/ops/retrieval.py``), forward and backward; the others are
plain PyTorch (differentiated by autograd) — the reference has no kernel
for them either: their products are ``[B, D]`` by ``[D, B]`` or ``[D, D]``
matrix products. Stop-gradients are ``detach()``.
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


# ---------------------------------------------------------------------------
# Self-supervised losses (two-view / regularization family)
# ---------------------------------------------------------------------------

def _unit(a: Tensor, eps: float) -> Tensor:
    return a * torch.rsqrt(torch.clamp((a * a).sum(-1, keepdim=True),
                                       min=eps))


def _cosine(a: Tensor, b: Tensor, eps: float = 1e-8) -> Tensor:
    return (_unit(a, eps) * _unit(b, eps)).sum(-1)


def _pairwise_cosine(a: Tensor, b: Tensor, eps: float = 1e-8) -> Tensor:
    return _unit(a, eps) @ _unit(b, eps).T


def grace_loss(z1: Tensor, z2: Tensor, *, temperature: float = 0.5
               ) -> Tensor:
    """GRACE: symmetric InfoNCE where node i's positive is its counterpart
    in the other view and its negatives every other node of both views
    (mean reduction)."""
    def half(a, b):
        n = a.shape[0]
        sim_inter = _pairwise_cosine(a, b) / temperature
        sim_intra = _pairwise_cosine(a, a) / temperature
        eye = torch.eye(n, dtype=torch.bool, device=a.device)
        pos = torch.diagonal(sim_inter)
        denom = (torch.exp(torch.where(eye, -torch.inf, sim_intra)).sum(-1)
                 + torch.exp(sim_inter).sum(-1))
        return -(pos - torch.log(torch.clamp(denom, min=1e-12))).mean()

    return 0.5 * (half(z1, z2) + half(z2, z1))


def bgrl_loss(online_pred: Tensor, target_proj: Tensor) -> Tensor:
    """BGRL: the negative mean cosine of the online predictions and the
    (stop-gradient) target projections."""
    return -_cosine(online_pred, target_proj.detach()).mean()


def tbgrl_loss(online_pred: Tensor, target_proj: Tensor,
               corrupted_target_proj: Tensor) -> Tensor:
    """Triplet-BGRL: mean(cos(pred, corrupted) - cos(pred, target)), the
    targets stop-gradient."""
    pos = _cosine(online_pred, target_proj.detach())
    neg = _cosine(online_pred, corrupted_target_proj.detach())
    return (neg - pos).mean()


def _standardize(z: Tensor, eps: float) -> Tensor:
    return (z - z.mean(0)) / torch.clamp(z.std(0, correction=0), min=eps)


def gbt_loss(z1: Tensor, z2: Tensor, *, eps: float = 1e-8) -> Tensor:
    """Graph Barlow Twins: the cross-correlation of the standardised views
    pushed to the identity, off-diagonal terms weighted 1 / D."""
    n, d = z1.shape
    c = (_standardize(z1, eps).T @ _standardize(z2, eps)) / n
    diag = torch.diagonal(c)
    on_diag = ((diag - 1.0) ** 2).sum()
    off_diag = (c ** 2).sum() - (diag ** 2).sum()
    return on_diag + (1.0 / d) * off_diag


def whitening_decorrelation_loss(z1: Tensor, z2: Tensor) -> Tensor:
    """CCA-SSG: invariance MSE of the standardised views plus each view's
    correlation matrix pushed to the identity."""
    n, d = z1.shape
    z1n, z2n = _standardize(z1, 1e-8), _standardize(z2, 1e-8)
    inv = ((z1n - z2n) ** 2).sum() / n
    eye = torch.eye(d, device=z1.device)
    c1 = (z1n.T @ z1n) / n
    c2 = (z2n.T @ z2n) / n
    return inv + (((c1 - eye) ** 2).sum() + ((c2 - eye) ** 2).sum()) / d


def feature_reconstruction_loss(reconstructed: Tensor, target: Tensor, *,
                                gamma: float = 2.0) -> Tensor:
    """Scaled cosine error: mean of (1 - cos)^gamma."""
    return ((1.0 - _cosine(reconstructed, target)) ** gamma).mean()


def alignment_loss(q: Tensor, c: Tensor, *, alpha: float = 2.0) -> Tensor:
    """DirectAU alignment: mean |q/|q| - c/|c||^alpha of positive pairs."""
    return (((_unit(q, 1e-12) - _unit(c, 1e-12)) ** 2).sum(-1)
            ** (alpha / 2.0)).mean()


def uniformity_loss(z: Tensor, *, t: float = 2.0) -> Tensor:
    """DirectAU uniformity: log of the mean Gaussian potential
    exp(-t |zi - zj|^2) over the ordered pairs i != j of unit rows."""
    zn = _unit(z, 1e-12)
    d2 = ((zn[:, None, :] - zn[None, :, :]) ** 2).sum(-1)
    n = z.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=z.device)
    return torch.log(torch.where(off, torch.exp(-t * d2), 0.0).sum()
                     / max(n * (n - 1), 1))


def kl_loss(p_scores: Tensor, q_scores: Tensor, *,
            temperature: float = 1.0) -> Tensor:
    """KL(p || q) of the two score distributions' softmaxes, mean over
    rows."""
    logp = torch.log_softmax(p_scores / temperature, dim=-1)
    logq = torch.log_softmax(q_scores / temperature, dim=-1)
    return (torch.exp(logp) * (logp - logq)).sum(-1).mean()


def llp_ranking_loss(pos_scores: Tensor, neg_scores: Tensor, *,
                     temperature: float = 1.0) -> Tensor:
    """ListNet top-1: softmax cross entropy of each positive against
    ``[pos || negatives]``, mean over queries."""
    logits = torch.cat([pos_scores[:, None], neg_scores], dim=-1)
    return (torch.logsumexp(logits / temperature, dim=-1)
            - logits[:, 0] / temperature).mean()
