"""The retrieval loss with the candidate pool SHARDED across a mesh (port of
``gigl_tpu/losses/sharded_retrieval.py``: ``ring_retrieval_loss`` and
``ring_candidate_pool``).

Each shard holds its own candidate block (its positives, hard negatives
and its 1/P slice of the shared random negatives); the softmax over the
GLOBAL pool runs as a ring: over P steps a shard scores its query rows
against one shard's block ([Ql, Cl] logits from a plain matmul), folds the
block into a running (max, exp-sum, positive score) — the streaming
logsumexp — and passes the block on (``Mesh.ppermute``). On the port's
single controller a block's trip round the ring is an index into the
per-shard list, so every shard's call gets the P blocks in ring order:
shard p sees its own block first, then shard p - 1's, and so on.

Kernel K17 ``ring_retrieval`` (``csrc/ring_retrieval.cu``): its fold entry
point (:func:`ring_fold`) masks one block's scores in the reference's
order (temperature, logQ, duplicate-query and accidental-hit masks, the
candidate mask, the own block's labels) and folds it in place; its
backward entry point (:func:`ring_block_bwd`) gives the block's
``dS = g * (softmax - labels) / T`` from the final logsumexp. Both count
under ``ring_retrieval``; :func:`_ring_fold_plain` and
:func:`_ring_block_bwd_plain` are their twins, used for CPU tensors only.
:class:`RingRetrievalLoss` is the ``torch.autograd.Function`` of one
shard: ``dq`` and each block's ``dcand`` are plain matmuls of the blocks'
``dS``, and autograd returns each block's cotangent to the shard that
owns it, as ``ppermute``'s transpose does in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from gigl_tpu_torch.ops import _build

FMIN = float(torch.finfo(torch.float32).min)


@dataclass(frozen=True)
class RingColumns:
    """One candidate block's column data: ids [Cl] int32 (read by the
    accidental-hit mask; None turns it off), the query id of each
    positive column [Cl] int32 (-1 = not a positive), the candidate mask
    [Cl] bool (None = all valid) and the logQ term [Cl] fp32 (or None)."""

    ids: Optional[torch.Tensor]
    pos_qids: torch.Tensor
    mask: Optional[torch.Tensor] = None
    log_q: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class RingRows:
    """The query rows' data: the temperature (None = 1), the own block's
    label column of each row [Ql] int32, the query ids [Ql] int32 (None:
    no duplicate-query mask) and the row's own positive id [Ql] int32
    (None: no accidental-hit mask)."""

    temperature: Optional[float]
    label_cols: torch.Tensor
    query_ids: Optional[torch.Tensor] = None
    own_pos_ids: Optional[torch.Tensor] = None


def _divide(x: torch.Tensor, t: float) -> torch.Tensor:
    """x / t in IEEE fp32 division, as the kernel and the reference divide
    (PyTorch multiplies a CUDA tensor by the reciprocal of a Python
    scalar, which can move a logit of ~400 by an ulp; a 0-d tensor on the
    device divides; ``full`` fills it without a host copy, so CUDA graphs
    capture it)."""
    return x / torch.full((), t, dtype=torch.float32, device=x.device)


def _masked_block_plain(scores: torch.Tensor, rows: RingRows,
                        cols: RingColumns, own: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v [Ql, Cl] fp32 as the kernel forms it, labels [Ql, Cl] bool)."""
    ql, cl = scores.shape
    v = scores.float()
    if rows.temperature is not None:
        v = _divide(v, rows.temperature)
    if cols.log_q is not None:
        v = v - cols.log_q[None, :]
    col = torch.arange(cl, device=scores.device)
    labels = (col[None, :] == rows.label_cols[:, None]) if own else \
        torch.zeros((ql, cl), dtype=torch.bool, device=scores.device)
    dup = torch.zeros((ql, cl), dtype=torch.bool, device=scores.device)
    if rows.query_ids is not None:
        dup = dup | (rows.query_ids[:, None] == cols.pos_qids[None, :])
    if rows.own_pos_ids is not None and cols.ids is not None:
        dup = dup | (rows.own_pos_ids[:, None] == cols.ids[None, :])
    v = torch.where(dup & ~labels, v + FMIN, v)
    if cols.mask is not None:
        v = torch.where(cols.mask[None, :], v, FMIN)
    return v, labels


def _ring_fold_plain(scores, rows: RingRows, cols: RingColumns, own: bool,
                     m_run, s_run, pos_score) -> None:
    """Plain twin of K17's fold: updates m_run, s_run, pos_score [Ql] in
    place."""
    v, labels = _masked_block_plain(scores, rows, cols, own)
    pos_score += torch.where(labels, v, 0.0).sum(1)
    m_new = torch.maximum(m_run, v.max(1).values)
    scale = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_new), 0.0)
    s_run.mul_(scale).add_(torch.exp(torch.where(
        torch.isfinite(v), v - m_new[:, None], FMIN)).sum(1))
    m_run.copy_(m_new)


def _ring_block_bwd_plain(scores, rows: RingRows, cols: RingColumns,
                          own: bool, lse, g) -> torch.Tensor:
    """Plain twin of K17's backward: dS [Ql, Cl] fp32 for row cotangents
    ``g`` [Ql] and the final ``lse`` [Ql]."""
    v, labels = _masked_block_plain(scores, rows, cols, own)
    t = rows.temperature if rows.temperature is not None else 1.0
    d = _divide(g[:, None] * (torch.exp(v - lse[:, None]) - labels.float()),
                t)
    if cols.mask is not None:
        d = torch.where(cols.mask[None, :], d, 0.0)
    return d


def _kernel_args(name: str, scores, rows: RingRows, cols: RingColumns,
                 own: bool):
    ql, cl = scores.shape
    opt = [t for t in (rows.query_ids, rows.own_pos_ids, cols.ids,
                       cols.mask, cols.log_q) if t is not None]
    device = _build.require_cuda(name, scores, rows.label_cols,
                                 cols.pos_qids, *opt)
    if scores.dtype != torch.float32:
        raise ValueError(f"{name}: scores must be fp32")
    for what, t, n, dtype in (
            ("label_cols", rows.label_cols, ql, torch.int32),
            ("query_ids", rows.query_ids, ql, torch.int32),
            ("own_pos_ids", rows.own_pos_ids, ql, torch.int32),
            ("ids", cols.ids, cl, torch.int32),
            ("pos_qids", cols.pos_qids, cl, torch.int32),
            ("mask", cols.mask, cl, torch.bool),
            ("log_q", cols.log_q, cl, torch.float32)):
        if t is not None and (t.shape != (n,) or t.dtype != dtype):
            raise ValueError(f"{name}: {what} must be {dtype} [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    t = rows.temperature if rows.temperature is not None else 1.0
    own_pos = rows.own_pos_ids if cols.ids is not None else None
    return device, (
        scores.data_ptr(), ql, cl,
        rows.label_cols.data_ptr() if own else None,
        _build.ptr(rows.query_ids), cols.pos_qids.data_ptr(),
        _build.ptr(own_pos), _build.ptr(cols.ids), _build.ptr(cols.mask),
        _build.ptr(cols.log_q), float(t), FMIN)


def _check_rows(name: str, scores, *per_row) -> None:
    """Each per-row tensor a contiguous fp32 [Ql] on the scores' device."""
    _build.require_cuda(name, scores, *per_row)
    for t in per_row:
        if t.dtype != torch.float32 or t.shape != scores.shape[:1]:
            raise ValueError(f"{name}: per-row tensors must be fp32 "
                             f"[{scores.shape[0]}]")


def ring_fold(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
              own: bool, m_run: torch.Tensor, s_run: torch.Tensor,
              pos_score: torch.Tensor) -> None:
    """K17 fold: one block's fp32 scores [Ql, Cl] masked and folded into
    the running max, exp-sum and positive score ([Ql] fp32, in place).
    ``own``: the block is the shard's own (its label columns apply). CPU
    tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_fold_plain(scores, rows, cols, own, m_run, s_run,
                                pos_score)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    _check_rows("ring_retrieval", scores, m_run, s_run, pos_score)
    _build.launch("ring_retrieval", "gigl_ring_fold", device, *args,
                  m_run.data_ptr(), s_run.data_ptr(), pos_score.data_ptr())


def ring_block_bwd(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
                   own: bool, lse: torch.Tensor, g: torch.Tensor
                   ) -> torch.Tensor:
    """K17 backward: dS [Ql, Cl] fp32 of one block for the row cotangents
    ``g`` [Ql] (query mask folded in) and the final logsumexp ``lse``.
    CPU tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_block_bwd_plain(scores, rows, cols, own, lse, g)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    lse, g = lse.contiguous(), g.to(torch.float32).contiguous()
    _check_rows("ring_retrieval", scores, lse, g)
    ds = torch.empty_like(scores)
    _build.launch("ring_retrieval", "gigl_ring_block_bwd", device, *args,
                  lse.data_ptr(), g.data_ptr(), ds.data_ptr())
    return ds


class RingRetrievalLoss(torch.autograd.Function):
    """One shard's (ce_sum, count) over the P candidate blocks in ring
    order (its own first), differentiable in the query rows and in every
    block."""

    @staticmethod
    def forward(ctx, rows: RingRows, cols: Sequence[RingColumns],
                query_mask: Optional[torch.Tensor], q, *cands):
        ql = q.shape[0]
        m_run = torch.full((ql,), FMIN, dtype=torch.float32, device=q.device)
        s_run = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        pos_score = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        scores = []
        for t, (c, col) in enumerate(zip(cands, cols)):
            s = (q @ c.T).float().contiguous()
            ring_fold(s, rows, col, t == 0, m_run, s_run, pos_score)
            scores.append(s)
        lse = torch.log(torch.clamp(s_run, min=1e-30)) + m_run
        ce = lse - pos_score
        if query_mask is not None:
            ce = torch.where(query_mask, ce, 0.0)
            count = query_mask.sum().to(torch.int32)
        else:
            count = torch.tensor(ql, dtype=torch.int32, device=q.device)
        ctx.rows, ctx.cols, ctx.query_mask = rows, cols, query_mask
        ctx.save_for_backward(q, lse, *cands, *scores)
        ctx.mark_non_differentiable(count)
        return ce.sum(), count

    @staticmethod
    def backward(ctx, g_sum, g_count):
        q, lse, *rest = ctx.saved_tensors
        n = len(rest) // 2
        cands, scores = rest[:n], rest[n:]
        g = g_sum.float().expand(q.shape[0])
        if ctx.query_mask is not None:
            g = torch.where(ctx.query_mask, g, 0.0)
        dq = torch.zeros_like(q)
        dcands = []
        for t, (c, s, col) in enumerate(zip(cands, scores, ctx.cols)):
            ds = ring_block_bwd(s, ctx.rows, col, t == 0, lse, g).to(q.dtype)
            dq = dq + ds @ c
            dcands.append(ds.T @ q)
        return (None, None, None, dq, *dcands)


def ring_retrieval_loss(
    q_local: torch.Tensor,
    cand_blocks: Sequence[torch.Tensor],
    block_cols: Sequence[RingColumns],
    *,
    temperature: Optional[float] = None,
    label_local_cols: Optional[torch.Tensor] = None,
    query_ids: Optional[torch.Tensor] = None,
    own_pos_ids: Optional[torch.Tensor] = None,
    query_mask: Optional[torch.Tensor] = None,
    remove_accidental_hits: bool = True,
    own_block_bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce_sum, count) of one shard's query rows ``q_local`` [Ql, D]
    against the GLOBAL candidate pool, given as the P blocks [Cl, D] in
    ring order (this shard's own first) with each block's columns.
    ``label_local_cols[r]`` (default r) is row r's positive column in the
    own block. Combine across shards as psum(sum) / psum(count). Scores
    are inner products (a cosine decoder normalises its rows first)."""
    if own_block_bias is not None:
        raise NotImplementedError(
            "ring_retrieval_loss(own_block_bias=...): the label-edge "
            "scorer's own-block bias is not ported yet (ROADMAP A15, rest)")
    ql = q_local.shape[0]
    if label_local_cols is None:
        label_local_cols = torch.arange(ql, dtype=torch.int32,
                                        device=q_local.device)
    rows = RingRows(temperature=temperature, label_cols=label_local_cols,
                    query_ids=query_ids,
                    own_pos_ids=own_pos_ids if remove_accidental_hits
                    else None)
    return RingRetrievalLoss.apply(rows, list(block_cols), query_mask,
                                   q_local, *cand_blocks)


def ring_candidate_pool(batch, pos, hard, rand_emb_l, rand_ids_local
                        ) -> Tuple[torch.Tensor, RingColumns]:
    """One shard's candidate block for the ring loss: columns [own
    positives | own hard negatives | own R/P shared-negative slice].
    Returns (cand_local [Cl, D], its columns, without a logQ term)."""
    b, p_, d = pos.shape
    dev = pos.device
    parts = [pos.reshape(b * p_, d)]
    ids = [batch.pos.reshape(-1)]
    mask = [batch.pos_mask.reshape(-1)]
    pos_qids = [batch.anchors.repeat_interleave(p_)]
    if hard is not None and hard.shape[1] > 0:
        h = hard.shape[1]
        parts.append(hard.reshape(b * h, d))
        ids.append(batch.hard_neg.reshape(-1))
        mask.append(batch.hard_neg_mask.reshape(-1))
        pos_qids.append(torch.full((b * h,), -1, dtype=torch.int32,
                                   device=dev))
    r = rand_emb_l.shape[0]
    parts.append(rand_emb_l)
    ids.append(rand_ids_local)
    mask.append(torch.ones((r,), dtype=torch.bool, device=dev))
    pos_qids.append(torch.full((r,), -1, dtype=torch.int32, device=dev))
    return torch.cat(parts), RingColumns(
        ids=torch.cat(ids).to(torch.int32),
        pos_qids=torch.cat(pos_qids).to(torch.int32),
        mask=torch.cat(mask))


def ring_blocks(mesh, blocks: Sequence) -> List[list]:
    """Every shard's view of the ring: entry p lists the P per-shard
    ``blocks`` in the order shard p folds them (its own first, then what
    each ppermute step brings)."""
    views = [[b] for b in blocks]
    cur = list(blocks)
    for _ in range(mesh.num_shards - 1):
        cur = mesh.ppermute(cur)
        for p, b in enumerate(cur):
            views[p].append(b)
    return views
