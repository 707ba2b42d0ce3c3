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
point (:func:`ring_fold`) masks a shard's P blocks of scores ``[P, Ql,
Cl]`` in the reference's order (temperature, logQ, duplicate-query and
accidental-hit masks, the candidate mask, the own block's labels) and
folds them, in ring order, into the running state in one launch; its
backward entry point (:func:`ring_block_bwd`) gives every block's
``dS = g * (softmax - labels) / T`` from the final logsumexp in one
launch. The blocks' columns are stacked ``[P, Cl]``
(:func:`stack_columns`). Both count under ``ring_retrieval``;
:func:`_ring_fold_plain` and :func:`_ring_block_bwd_plain` are their
twins (one block after another), used for CPU tensors only.
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
    [Cl] bool (None = all valid) and the logQ term [Cl] fp32 (or None).
    Stacked (:func:`stack_columns`), P blocks' columns as [P, Cl]."""

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


def stack_columns(cols: Sequence[RingColumns]) -> RingColumns:
    """The P blocks' columns as one RingColumns of [P, Cl] tensors (every
    block the same Cl and the same optional columns)."""
    fields = ("ids", "pos_qids", "mask", "log_q")
    for f in fields:
        present = {getattr(c, f) is not None for c in cols}
        if len(present) > 1:
            raise ValueError(f"ring_retrieval: some blocks have {f} and "
                             "some do not")
    if len({c.pos_qids.shape for c in cols}) > 1:
        raise ValueError("ring_retrieval: blocks of different widths "
                         f"{[tuple(c.pos_qids.shape) for c in cols]}")
    return RingColumns(**{f: None if getattr(cols[0], f) is None else
                          torch.stack([getattr(c, f) for c in cols])
                          for f in fields})


def _block_cols(cols: RingColumns, t: int) -> RingColumns:
    """Block t's [Cl] columns out of stacked [P, Cl] ones."""
    return RingColumns(*(None if x is None else x[t] for x in (
        cols.ids, cols.pos_qids, cols.mask, cols.log_q)))


def _blocks(scores, cols):
    """(scores [P, Ql, Cl], columns [P, Cl]) of a call given one block
    ([Ql, Cl], columns [Cl]) or P blocks."""
    if scores.dim() == 3:
        return scores, cols
    return scores[None], RingColumns(*(None if x is None else x[None]
                                       for x in (cols.ids, cols.pos_qids,
                                                 cols.mask, cols.log_q)))


def _masked_block_plain(scores: torch.Tensor, rows: RingRows,
                        cols: RingColumns, own: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(v [Ql, Cl] fp32 as the kernel forms it, labels [Ql, Cl] bool) of
    one block."""
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
    """Plain twin of K17's fold: the blocks of scores [P, Ql, Cl] (or one
    [Ql, Cl]) folded one after another into m_run, s_run, pos_score [Ql]
    in place; ``own``: block 0 is the shard's own."""
    scores, cols = _blocks(scores, cols)
    for t in range(scores.shape[0]):
        v, labels = _masked_block_plain(scores[t], rows, _block_cols(cols, t),
                                        own and t == 0)
        pos_score += torch.where(labels, v, 0.0).sum(1)
        m_new = torch.maximum(m_run, v.max(1).values)
        scale = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_new),
                            0.0)
        s_run.mul_(scale).add_(torch.exp(torch.where(
            torch.isfinite(v), v - m_new[:, None], FMIN)).sum(1))
        m_run.copy_(m_new)


def _ring_block_bwd_plain(scores, rows: RingRows, cols: RingColumns,
                          own: bool, lse, g) -> torch.Tensor:
    """Plain twin of K17's backward: dS fp32 shaped as scores ([P, Ql, Cl]
    or [Ql, Cl]) for row cotangents ``g`` [Ql] and the final ``lse``."""
    s3, cols3 = _blocks(scores, cols)
    t_ = rows.temperature if rows.temperature is not None else 1.0
    out = []
    for t in range(s3.shape[0]):
        blk = _block_cols(cols3, t)
        v, labels = _masked_block_plain(s3[t], rows, blk, own and t == 0)
        d = _divide(g[:, None] * (torch.exp(v - lse[:, None])
                                  - labels.float()), t_)
        if blk.mask is not None:
            d = torch.where(blk.mask[None, :], d, 0.0)
        out.append(d)
    ds = torch.stack(out) if out else torch.zeros_like(s3,
                                                        dtype=torch.float32)
    return ds.reshape(scores.shape)


def _kernel_args(name: str, scores, rows: RingRows, cols: RingColumns,
                 own: bool):
    s3, cols = _blocks(scores, cols)
    p, ql, cl = s3.shape
    opt = [t for t in (rows.query_ids, rows.own_pos_ids, cols.ids,
                       cols.mask, cols.log_q) if t is not None]
    device = _build.require_cuda(name, s3, rows.label_cols,
                                 cols.pos_qids, *opt)
    if s3.dtype != torch.float32:
        raise ValueError(f"{name}: scores must be fp32")
    for what, t, n, dtype in (
            ("label_cols", rows.label_cols, (ql,), torch.int32),
            ("query_ids", rows.query_ids, (ql,), torch.int32),
            ("own_pos_ids", rows.own_pos_ids, (ql,), torch.int32),
            ("ids", cols.ids, (p, cl), torch.int32),
            ("pos_qids", cols.pos_qids, (p, cl), torch.int32),
            ("mask", cols.mask, (p, cl), torch.bool),
            ("log_q", cols.log_q, (p, cl), torch.float32)):
        if t is not None and (t.shape != n or t.dtype != dtype):
            raise ValueError(f"{name}: {what} must be {dtype} {list(n)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    t = rows.temperature if rows.temperature is not None else 1.0
    own_pos = rows.own_pos_ids if cols.ids is not None else None
    return device, (
        s3.data_ptr(), p, ql, cl,
        rows.label_cols.data_ptr() if own else None,
        _build.ptr(rows.query_ids), cols.pos_qids.data_ptr(),
        _build.ptr(own_pos), _build.ptr(cols.ids), _build.ptr(cols.mask),
        _build.ptr(cols.log_q), float(t), FMIN)


def _check_rows(name: str, ql: int, scores, *per_row) -> None:
    """Each per-row tensor a contiguous fp32 [Ql] on the scores' device."""
    _build.require_cuda(name, scores, *per_row)
    for t in per_row:
        if t.dtype != torch.float32 or t.shape != (ql,):
            raise ValueError(f"{name}: per-row tensors must be fp32 [{ql}]")


def ring_fold(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
              own: bool, m_run: torch.Tensor, s_run: torch.Tensor,
              pos_score: torch.Tensor) -> None:
    """K17 fold: a shard's fp32 scores [P, Ql, Cl] (P blocks in ring
    order, columns stacked [P, Cl]; or one block [Ql, Cl] with [Cl]
    columns) masked and folded, block after block, into the running max,
    exp-sum and positive score ([Ql] fp32, in place) in one launch.
    ``own``: block 0 is the shard's own (its label columns apply). CPU
    tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_fold_plain(scores, rows, cols, own, m_run, s_run,
                                pos_score)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    _check_rows("ring_retrieval", args[2], scores, m_run, s_run, pos_score)
    _build.launch("ring_retrieval", "gigl_ring_fold", device, *args,
                  m_run.data_ptr(), s_run.data_ptr(), pos_score.data_ptr())


def ring_block_bwd(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
                   own: bool, lse: torch.Tensor, g: torch.Tensor
                   ) -> torch.Tensor:
    """K17 backward: dS fp32 shaped as ``scores`` ([P, Ql, Cl] or one
    block [Ql, Cl], as :func:`ring_fold` takes them) for the row
    cotangents ``g`` [Ql] (query mask folded in) and the final logsumexp
    ``lse``, in one launch. CPU tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_block_bwd_plain(scores, rows, cols, own, lse, g)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    lse, g = lse.contiguous(), g.to(torch.float32).contiguous()
    _check_rows("ring_retrieval", args[2], scores, lse, g)
    ds = torch.empty_like(scores)
    _build.launch("ring_retrieval", "gigl_ring_block_bwd", device, *args,
                  lse.data_ptr(), g.data_ptr(), ds.data_ptr())
    return ds


def _block_scores(q: torch.Tensor, cands: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """The P blocks' fp32 scores [P, Ql, Cl], block t the bits of
    ``(q @ cands[t].T).float()``."""
    widths = {c.shape[0] for c in cands}
    if len(widths) != 1:
        raise ValueError(f"ring_retrieval: blocks of different widths "
                         f"{sorted(widths)}")
    scores = torch.empty((len(cands), q.shape[0], widths.pop()),
                         dtype=torch.float32, device=q.device)
    for t, c in enumerate(cands):
        scores[t].copy_(q @ c.T)
    return scores


class RingRetrievalLoss(torch.autograd.Function):
    """One shard's (ce_sum, count) over the P candidate blocks in ring
    order (its own first), differentiable in the query rows and in every
    block: one K17 fold and one K17 backward launch."""

    @staticmethod
    def forward(ctx, rows: RingRows, cols: Sequence[RingColumns],
                query_mask: Optional[torch.Tensor], q, *cands):
        ql = q.shape[0]
        m_run = torch.full((ql,), FMIN, dtype=torch.float32, device=q.device)
        s_run = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        pos_score = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        stacked = stack_columns(cols)
        scores = _block_scores(q, cands)
        ring_fold(scores, rows, stacked, True, m_run, s_run, pos_score)
        lse = torch.log(torch.clamp(s_run, min=1e-30)) + m_run
        ce = lse - pos_score
        if query_mask is not None:
            ce = torch.where(query_mask, ce, 0.0)
            count = query_mask.sum().to(torch.int32)
        else:
            count = torch.tensor(ql, dtype=torch.int32, device=q.device)
        ctx.rows, ctx.cols, ctx.query_mask = rows, stacked, query_mask
        ctx.save_for_backward(q, lse, scores, *cands)
        ctx.mark_non_differentiable(count)
        return ce.sum(), count

    @staticmethod
    def backward(ctx, g_sum, g_count):
        q, lse, scores, *cands = ctx.saved_tensors
        g = g_sum.float().expand(q.shape[0])
        if ctx.query_mask is not None:
            g = torch.where(ctx.query_mask, g, 0.0)
        ds = ring_block_bwd(scores, ctx.rows, ctx.cols, True, lse, g).to(
            q.dtype)
        dq = torch.zeros_like(q)
        dcands = []
        for t, c in enumerate(cands):
            dq = dq + ds[t] @ c
            dcands.append(ds[t].T @ q)
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
