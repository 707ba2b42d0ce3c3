"""Degree-bucketed dense-block (ELL) full-graph aggregation (port of
``gigl_tpu/ops/ell.py``).

Nodes are grouped into degree buckets, each bucket's in-neighborhoods
padded to the bucket width, and one global permutation orders nodes by
bucket, so each bucket's destination rows are a contiguous slice of the
permuted feature matrix; neighbor ids are pre-remapped into permuted space.
A forward pass costs one permute-gather in, L rounds of per-bucket
aggregation, and one inverse-permute gather out.

The tables are built on the host with numpy exactly as the reference builds
them (bit-equal, including the transpose tables ``t_*`` and ``edge_pos``)
and moved to the device as int32 / bool / float32 tensors. Two derived
tables serve the backward: ``t_perm``, the inverse of ``t_rank`` (the x_p
row of each transpose row), and ``ent_row``, the destination row of each
flat forward entry ``p = ent_off[b] + i * W_b + j`` (row
``boundaries[b] + i``).

:func:`ell_layer` is one conv layer over every bucket: ``conv.ell(x_p,
ell)``. It never materialises the reference's ``x_p[nbr]`` block
``[n_b, W, D]`` (``ell_gather``, :237-247): the convs read neighbor rows
through the index tables inside kernel K6 ``ell_aggregate`` (SAGE, GCN,
GIN; ``ops/ell_aggregate.py``) or K7 ``fanout_attention`` (GAT, GATv2,
Transformer; ``ops/attention.py``), one autograd node per layer whose
forward launches the kernel once per bucket into one ``[N, D_out]`` output
and whose backward walks the transpose tables once (K6b, after K7b for
attention) — the scatter-free custom VJP of :237-286. Masked slots point
at row 0 (``rank[v] * m``); the kernels honour the mask, never the index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device

EDGE_FEATURES_NOT_PORTED = (
    "edge features on the ELL path need ell_gather_edges "
    "(gigl_tpu/ops/ell.py:289-316), which is not ported yet (ROADMAP B6 "
    "edges)")


def default_widths(max_degree: int) -> Tuple[int, ...]:
    """Power-of-2 bucket widths covering max_degree (4, 8, 16, ...)."""
    widths: List[int] = []
    w = 4
    while True:
        widths.append(w)
        if w >= max(max_degree, 1):
            return tuple(widths)
        w *= 2


def _bucketize_rows(
    indptr: np.ndarray,      # [R+1]
    values: np.ndarray,      # [M] payload per slot
    widths: Tuple[int, ...],
) -> Tuple[np.ndarray, np.ndarray, List[int],
           List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Group CSR-like rows into width buckets and pad each bucket dense.

    Returns (perm, rank, boundaries, padded_values_per_bucket,
    masks_per_bucket, slot_index_per_bucket); slot_index holds the source
    position in ``values`` of each valid padded entry. Degree-0 rows fall
    into bucket 0 as all-masked rows (``side="left"``)."""
    r = len(indptr) - 1
    deg = np.diff(indptr)
    max_deg = int(deg.max()) if r else 0
    if max_deg > widths[-1]:
        raise ValueError(f"max degree {max_deg} exceeds last width "
                         f"{widths[-1]}")
    bucket_of = np.searchsorted(np.asarray(widths), deg, side="left")
    perm = np.argsort(bucket_of, kind="stable").astype(np.int64)
    rank = np.empty(r, np.int64)
    rank[perm] = np.arange(r)
    boundaries = [0]
    padded, masks, slot_idx = [], [], []
    for b, w in enumerate(widths):
        rows_b = perm[bucket_of[perm] == b]
        boundaries.append(boundaries[-1] + len(rows_b))
        val = np.zeros((len(rows_b), w), np.int64)
        mk = np.zeros((len(rows_b), w), bool)
        sl = np.zeros((len(rows_b), w), np.int64)
        d = deg[rows_b]
        rr = np.repeat(np.arange(len(rows_b)), d)
        cc = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        # The reference concatenates arange(indptr[v], indptr[v+1]) row by
        # row; the same positions, vectorised.
        flat_pos = np.repeat(indptr[rows_b], d) + cc
        val[rr, cc] = values[flat_pos]
        mk[rr, cc] = True
        sl[rr, cc] = flat_pos
        padded.append(val)
        masks.append(mk)
        slot_idx.append(sl)
    return perm, rank, boundaries, padded, masks, slot_idx


@dataclass
class EllGraph:
    """Bucketed padded adjacency in permuted node space.

    perm[i] = original node id at permuted row i (bucket-contiguous);
    rank[v] = permuted row of original node v; deg_p = in-degree in
    permuted order. Per bucket b: nbr[b] [n_b, W_b] permuted-space neighbor
    rows, mask[b] validity, edge_slots[b] original COO edge row per entry;
    its dst rows are boundaries[b]:boundaries[b+1]. The transpose tables
    (t_rank, t_nbr, t_mask, t_boundaries, t_widths) serve the backward
    (K6b), with the derived t_perm (inverse of t_rank) and ent_row /
    ent_off (flat entry -> dst row, bucket b's first entry); edge_pos is
    for edge features (not ported)."""

    perm: torch.Tensor                 # [N] int32
    rank: torch.Tensor                 # [N] int32
    deg_p: torch.Tensor                # [N] float32, permuted order
    nbr: Tuple[torch.Tensor, ...]      # per bucket [n_b, W_b] int32
    mask: Tuple[torch.Tensor, ...]     # per bucket [n_b, W_b] bool
    edge_slots: Tuple[torch.Tensor, ...]
    t_rank: torch.Tensor               # [N] int32
    t_nbr: Tuple[torch.Tensor, ...]
    t_mask: Tuple[torch.Tensor, ...]
    edge_pos: torch.Tensor             # [E] int32
    boundaries: Tuple[int, ...]
    widths: Tuple[int, ...]
    t_boundaries: Tuple[int, ...]
    t_widths: Tuple[int, ...]
    t_perm: torch.Tensor               # [N] int32, t-row -> x_p row
    ent_row: torch.Tensor              # [P] int32, flat entry -> dst row
    ent_off: Tuple[int, ...]           # len = num_buckets + 1

    @property
    def num_nodes(self) -> int:
        return self.perm.shape[0]

    @classmethod
    def from_csr(cls, csr, widths: Optional[Sequence[int]] = None,
                 device: DeviceLike = None) -> "EllGraph":
        """Tables of a dst-anchored CSR (``graph.csr(et, anchor="dst")``),
        on ``device`` (CUDA unless given)."""
        device = resolve_device(device)
        indptr = np.asarray(csr.indptr, np.int64)
        indices = np.asarray(csr.indices, np.int64)
        n = len(indptr) - 1
        deg = np.diff(indptr)
        max_deg = int(deg.max()) if n else 1
        ws = tuple(int(w) for w in (widths or default_widths(max_deg)))
        if ws != tuple(sorted(ws)):
            raise ValueError(f"widths must be ascending: {ws}")
        perm, rank, boundaries, padded_nbr, masks, slot_idx = (
            _bucketize_rows(indptr, indices, ws))
        nbrs = [rank[v] * m for v, m in zip(padded_nbr, masks)]
        eid = (np.asarray(csr.edge_ids, np.int64)
               if csr.edge_ids is not None else np.arange(len(indices)))
        slots_l = [eid[s] * m for s, m in zip(slot_idx, masks)]

        # Transpose structure over flat forward entry positions: bucket b
        # entry (i, j) sits at off_b + i * W_b + j.
        offs = []
        off = 0
        for b, w in enumerate(ws):
            offs.append(off)
            off += (boundaries[b + 1] - boundaries[b]) * w
        us, ps = [], []
        edge_pos = np.zeros(len(indices), np.int64)
        for b, w in enumerate(ws):
            mk = masks[b]
            if not mk.size:
                continue
            ii, jj = np.nonzero(mk)
            pos = offs[b] + ii * w + jj
            us.append(nbrs[b][ii, jj])
            ps.append(pos)
            edge_pos[slots_l[b][ii, jj]] = pos
        us = np.concatenate(us) if us else np.zeros((0,), np.int64)
        ps = np.concatenate(ps) if ps else np.zeros((0,), np.int64)
        order = np.argsort(us, kind="stable")
        us, ps = us[order], ps[order]
        t_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(us, minlength=n), out=t_indptr[1:])
        t_deg_max = int(np.diff(t_indptr).max()) if n else 0
        t_ws = default_widths(max(t_deg_max, 1))
        t_perm, t_rank_rows, t_boundaries, t_padded, t_masks, _ = (
            _bucketize_rows(t_indptr, ps, t_ws))
        offs.append(off)
        ent_row = np.repeat(np.arange(n), np.repeat(
            np.asarray(ws), np.diff(boundaries)))

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        def bools(a):
            return torch.as_tensor(a, device=device)

        return cls(
            perm=i32(perm), rank=i32(rank),
            deg_p=torch.as_tensor(deg[perm].astype(np.float32), device=device),
            nbr=tuple(i32(v) for v in nbrs),
            mask=tuple(bools(m) for m in masks),
            edge_slots=tuple(i32(s) for s in slots_l),
            t_rank=i32(t_rank_rows), edge_pos=i32(edge_pos),
            t_nbr=tuple(i32(v) for v in t_padded),
            t_mask=tuple(bools(m) for m in t_masks),
            boundaries=tuple(int(b) for b in boundaries), widths=ws,
            t_boundaries=tuple(int(b) for b in t_boundaries),
            t_widths=tuple(t_ws), t_perm=i32(t_perm), ent_row=i32(ent_row),
            ent_off=tuple(int(o) for o in offs))


def ell_layer(conv, x_p: torch.Tensor, ell: EllGraph,
              edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv layer over the whole permuted graph: x_p [N, D] in
    permuted order -> [N, D_out] in permuted order (``conv.ell``; GCN
    reads the in-degrees ``ell.deg_p`` for both ends)."""
    if edge_attr is not None:
        raise NotImplementedError(EDGE_FEATURES_NOT_PORTED)
    return conv.ell(x_p, ell)
