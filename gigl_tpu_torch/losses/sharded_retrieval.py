"""The retrieval loss with the candidate pool SHARDED across a mesh (port of
``gigl_tpu/losses/sharded_retrieval.py``: ``ring_retrieval_loss``,
``ring_candidate_pool`` and ``ring_own_block_edge_bias``).

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


@dataclass(frozen=True)
class OwnBlockBias:
    """The label edges' raw-score terms on a shard's own candidate block,
    whose query rows are B anchors x ``num_pos`` positives (Ql = B * p):
    ``e_pos`` [Ql] fp32 adds to row r's own positive, column r; ``e_hard``
    [B * h] fp32 (``num_hard`` = h hard negatives an anchor) adds to
    column Ql + c of every row r with r // p == c // h. Either may be
    None."""

    e_pos: Optional[torch.Tensor]
    e_hard: Optional[torch.Tensor]
    num_pos: int
    num_hard: int

    def dense(self, num_rows: int, num_cols: int) -> torch.Tensor:
        """The reference's [Ql, Cl] fp32 bias matrix (differentiable in
        ``e_pos`` and ``e_hard``)."""
        ql, p, h = num_rows, self.num_pos, self.num_hard
        ref = self.e_pos if self.e_pos is not None else self.e_hard
        dev = ref.device
        parts = [torch.diag(self.e_pos) if self.e_pos is not None else
                 torch.zeros((ql, ql), dtype=torch.float32, device=dev)]
        used = ql
        if self.e_hard is not None and h > 0:
            row_b = torch.arange(ql, device=dev) // p
            col_b = torch.arange(self.e_hard.shape[0], device=dev) // h
            parts.append(torch.where(row_b[:, None] == col_b[None, :],
                                     self.e_hard[None, :], 0.0))
            used += self.e_hard.shape[0]
        parts.append(torch.zeros((ql, num_cols - used), dtype=torch.float32,
                                 device=dev))
        return torch.cat(parts, dim=1)

    def detached(self) -> "OwnBlockBias":
        return OwnBlockBias(*(None if e is None else
                              e.detach().to(torch.float32).contiguous()
                              for e in (self.e_pos, self.e_hard)),
                            self.num_pos, self.num_hard)


def ring_own_block_edge_bias(edge_score_fn, batch
                             ) -> Optional[OwnBlockBias]:
    """The label edges' score terms of ``batch`` for the own block (the
    reference's ``ring_own_block_edge_bias``, without its dense matrix):
    ``edge_score_fn`` (the model's ``edge_score``) of each positive's edge
    row for that row's own column, of each hard negative's for its
    anchor's rows; None when the batch carries no label-edge features."""
    if batch.pos_edge_feats is None and batch.hard_neg_edge_feats is None:
        return None
    b, p_ = batch.pos.shape
    h = batch.hard_neg.shape[1]
    e_pos = e_hard = None
    if batch.pos_edge_feats is not None:
        e_pos = edge_score_fn(batch.pos_edge_feats.reshape(b * p_, -1)).to(
            torch.float32)
    if h > 0 and batch.hard_neg_edge_feats is not None:
        e_hard = edge_score_fn(batch.hard_neg_edge_feats.reshape(
            b * h, -1)).to(torch.float32)
    if e_pos is None and e_hard is None:
        return None
    return OwnBlockBias(e_pos, e_hard, p_, h)


def _with_bias(scores: torch.Tensor, bias: OwnBlockBias) -> torch.Tensor:
    """scores ([P, Ql, Cl] or [Ql, Cl]) with the dense bias added to the
    own block, block 0 (a new tensor)."""
    s3 = scores if scores.dim() == 3 else scores[None]
    own = s3[0] + bias.dense(s3.shape[1], s3.shape[2])
    return torch.cat([own[None], s3[1:]]).reshape(scores.shape)


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
                     m_run, s_run, pos_score,
                     bias: Optional[OwnBlockBias] = None) -> None:
    """Plain twin of K17's fold: the blocks of scores [P, Ql, Cl] (or one
    [Ql, Cl]) folded one after another into m_run, s_run, pos_score [Ql]
    in place; ``own``: block 0 is the shard's own (its ``bias`` added)."""
    if bias is not None:
        scores = _with_bias(scores, bias.detached())
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
                          own: bool, lse, g,
                          bias: Optional[OwnBlockBias] = None):
    """Plain twin of K17's backward: dS fp32 shaped as scores ([P, Ql, Cl]
    or [Ql, Cl]) for row cotangents ``g`` [Ql] and the final ``lse``; with
    ``bias``, (dS, d e_pos, d e_hard), the bias's cotangents by autograd
    through its dense matrix."""
    if bias is not None:
        ds = _ring_block_bwd_plain(_with_bias(scores, bias.detached()), rows,
                                   cols, own, lse, g)
        ds3 = ds if ds.dim() == 3 else ds[None]
        leaves = [None if e is None else
                  e.detach().to(torch.float32).requires_grad_()
                  for e in (bias.e_pos, bias.e_hard)]
        with torch.enable_grad():
            dense = OwnBlockBias(*leaves, bias.num_pos, bias.num_hard).dense(
                ds3.shape[1], ds3.shape[2])
            grads = iter(torch.autograd.grad(
                dense, [e for e in leaves if e is not None], ds3[0]))
        return (ds, *(None if e is None else next(grads) for e in leaves))
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


def _check_bias(bias: OwnBlockBias, ql: int, cl: int) -> int:
    """Raise unless ``bias`` fits Ql query rows (anchors x p positives)
    and a block of Cl columns; returns the hard columns' count B * h."""
    p, h = int(bias.num_pos), int(bias.num_hard)
    if p < 1 or ql % p:
        raise ValueError(f"ring_retrieval: {ql} query rows are not anchors "
                         f"x {p} positives")
    n_hard = (ql // p) * h if bias.e_hard is not None else 0
    for what, e, n in (("e_pos", bias.e_pos, ql),
                       ("e_hard", bias.e_hard, n_hard)):
        if e is not None and tuple(e.shape) != (n,):
            raise ValueError(f"ring_retrieval: {what} must be [{n}], got "
                             f"{tuple(e.shape)}")
    if ql + n_hard > cl:
        raise ValueError(f"ring_retrieval: {ql} + {n_hard} biased columns "
                         f"past the block's {cl}")
    return n_hard


def _bias_args(bias: OwnBlockBias, own: bool, ql: int, cl: int, device):
    """K17's bias-mode arguments (e_pos, e_hard, p, h, B * h), checked."""
    if not own:
        raise ValueError("ring_retrieval: the bias applies to the own block")
    n_hard = _check_bias(bias, ql, cl)
    for e in (bias.e_pos, bias.e_hard):
        if e is not None and (e.dtype != torch.float32 or e.device != device):
            raise ValueError(f"ring_retrieval: bias terms must be fp32 on "
                             f"{device}, got {e.dtype} on {e.device}")
    return (_build.ptr(bias.e_pos), _build.ptr(bias.e_hard),
            int(bias.num_pos), max(int(bias.num_hard), 1), n_hard)


def ring_fold(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
              own: bool, m_run: torch.Tensor, s_run: torch.Tensor,
              pos_score: torch.Tensor,
              bias: Optional[OwnBlockBias] = None) -> None:
    """K17 fold: a shard's fp32 scores [P, Ql, Cl] (P blocks in ring
    order, columns stacked [P, Cl]; or one block [Ql, Cl] with [Cl]
    columns) masked and folded, block after block, into the running max,
    exp-sum and positive score ([Ql] fp32, in place) in one launch.
    ``own``: block 0 is the shard's own (its label columns apply, and
    ``bias``: K17's bias mode). CPU tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_fold_plain(scores, rows, cols, own, m_run, s_run,
                                pos_score, bias)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    _check_rows("ring_retrieval", args[2], scores, m_run, s_run, pos_score)
    if bias is None:
        _build.launch("ring_retrieval", "gigl_ring_fold", device, *args,
                      m_run.data_ptr(), s_run.data_ptr(),
                      pos_score.data_ptr())
        return None
    bias = bias.detached()
    _build.launch("ring_retrieval", "gigl_ring_fold_bias", device, *args,
                  *_bias_args(bias, own, args[2], args[3], device),
                  m_run.data_ptr(), s_run.data_ptr(), pos_score.data_ptr())
    _build.launches["ring_retrieval_bias"] += 1
    return None


def ring_block_bwd(scores: torch.Tensor, rows: RingRows, cols: RingColumns,
                   own: bool, lse: torch.Tensor, g: torch.Tensor,
                   bias: Optional[OwnBlockBias] = None):
    """K17 backward: dS fp32 shaped as ``scores`` ([P, Ql, Cl] or one
    block [Ql, Cl], as :func:`ring_fold` takes them) for the row
    cotangents ``g`` [Ql] (query mask folded in) and the final logsumexp
    ``lse``, in one launch; with ``bias`` (dS, d e_pos, d e_hard), the
    bias's cotangents (None for an absent one) from the same launch. CPU
    tensors take the plain twin."""
    if scores.device.type == "cpu":
        return _ring_block_bwd_plain(scores, rows, cols, own, lse, g, bias)
    device, args = _kernel_args("ring_retrieval", scores, rows, cols, own)
    lse, g = lse.contiguous(), g.to(torch.float32).contiguous()
    _check_rows("ring_retrieval", args[2], scores, lse, g)
    ds = torch.empty_like(scores)
    if bias is None:
        _build.launch("ring_retrieval", "gigl_ring_block_bwd", device, *args,
                      lse.data_ptr(), g.data_ptr(), ds.data_ptr())
        return ds
    bias = bias.detached()
    extra = _bias_args(bias, own, args[2], args[3], device)
    de_pos, de_hard = (None if e is None else torch.empty_like(e)
                       for e in (bias.e_pos, bias.e_hard))
    _build.launch("ring_retrieval", "gigl_ring_block_bwd_bias", device,
                  *args, *extra, lse.data_ptr(), g.data_ptr(),
                  ds.data_ptr(), _build.ptr(de_pos), _build.ptr(de_hard))
    _build.launches["ring_retrieval_bias"] += 1
    return ds, de_pos, de_hard


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
    order (its own first), differentiable in the query rows, in every
    block and in the own block's bias terms (``e_pos``, ``e_hard``, each
    None without): one K17 fold and one K17 backward launch."""

    @staticmethod
    def forward(ctx, rows: RingRows, cols: Sequence[RingColumns],
                query_mask: Optional[torch.Tensor], bias_shape, q, e_pos,
                e_hard, *cands):
        ql = q.shape[0]
        m_run = torch.full((ql,), FMIN, dtype=torch.float32, device=q.device)
        s_run = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        pos_score = torch.zeros((ql,), dtype=torch.float32, device=q.device)
        stacked = stack_columns(cols)
        scores = _block_scores(q, cands)
        bias = None if bias_shape is None else OwnBlockBias(
            e_pos, e_hard, *bias_shape).detached()
        ring_fold(scores, rows, stacked, True, m_run, s_run, pos_score, bias)
        lse = torch.log(torch.clamp(s_run, min=1e-30)) + m_run
        ce = lse - pos_score
        if query_mask is not None:
            ce = torch.where(query_mask, ce, 0.0)
            count = query_mask.sum().to(torch.int32)
        else:
            count = torch.tensor(ql, dtype=torch.int32, device=q.device)
        ctx.rows, ctx.cols, ctx.query_mask = rows, stacked, query_mask
        ctx.bias = bias
        ctx.save_for_backward(q, lse, scores, *cands)
        ctx.mark_non_differentiable(count)
        return ce.sum(), count

    @staticmethod
    def backward(ctx, g_sum, g_count):
        q, lse, scores, *cands = ctx.saved_tensors
        g = g_sum.float().expand(q.shape[0])
        if ctx.query_mask is not None:
            g = torch.where(ctx.query_mask, g, 0.0)
        de = (None, None)
        if ctx.bias is None:
            ds = ring_block_bwd(scores, ctx.rows, ctx.cols, True, lse, g)
        else:   # the terms' cotangents (autograd casts them to their type)
            ds, *de = ring_block_bwd(scores, ctx.rows, ctx.cols, True, lse,
                                     g, ctx.bias)
        ds = ds.to(q.dtype)
        dq = torch.zeros_like(q)
        dcands = []
        for t, c in enumerate(cands):
            dq = dq + ds[t] @ c
            dcands.append(ds[t].T @ q)
        return (None, None, None, None, dq, *de, *dcands)


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
    own_block_bias: Optional[OwnBlockBias] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce_sum, count) of one shard's query rows ``q_local`` [Ql, D]
    against the GLOBAL candidate pool, given as the P blocks [Cl, D] in
    ring order (this shard's own first) with each block's columns.
    ``label_local_cols[r]`` (default r) is row r's positive column in the
    own block; ``own_block_bias`` (:func:`ring_own_block_edge_bias`) the
    label edges' raw-score terms on the own block, added before the
    temperature. Combine across shards as psum(sum) / psum(count). Scores
    are inner products (a cosine decoder normalises its rows first)."""
    if own_block_bias is not None and not isinstance(own_block_bias,
                                                     OwnBlockBias):
        raise TypeError(
            "ring_retrieval_loss(own_block_bias=...) takes an OwnBlockBias "
            "(ring_own_block_edge_bias), not the reference's dense [Ql, Cl] "
            f"matrix; got {type(own_block_bias).__name__}")
    ql = q_local.shape[0]
    if own_block_bias is not None:
        _check_bias(own_block_bias, ql, cand_blocks[0].shape[0])
    if label_local_cols is None:
        label_local_cols = torch.arange(ql, dtype=torch.int32,
                                        device=q_local.device)
    rows = RingRows(temperature=temperature, label_cols=label_local_cols,
                    query_ids=query_ids,
                    own_pos_ids=own_pos_ids if remove_accidental_hits
                    else None)
    b = own_block_bias
    return RingRetrievalLoss.apply(
        rows, list(block_cols), query_mask,
        None if b is None else (b.num_pos, b.num_hard), q_local,
        None if b is None else b.e_pos, None if b is None else b.e_hard,
        *cand_blocks)


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
