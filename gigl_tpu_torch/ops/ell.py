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
and moved to the device as int32 / bool / float32 tensors. Derived tables
serve the backward: ``t_perm``, the inverse of ``t_rank`` (the x_p row of
each transpose row), and, per flat forward entry ``p = ent_off[b] + i *
W_b + j``, its destination row ``ent_row`` (``boundaries[b] + i``), its
source row ``ent_src`` (the concatenated ``nbr``) and its COO edge
``ent_edge`` (the concatenated ``edge_slots``); masked entries hold 0 in
the last two, and ``ent_mask`` says which entries are real. Per transpose
bucket, ``t_row = ent_row[t_nbr]`` where ``t_mask`` holds and -1 elsewhere:
each transpose slot's destination row, composed in walk order, which K6b
reads in place of the mask, the entry position and ``ent_row``; and
``t_edge = ent_edge[t_nbr]`` the same way, each transpose slot's COO edge,
which K6b's sum reads to add a per-edge table into the source rows
(GATv2 with edge rows: the key table's gradient is the edge table's
summed along the source walk).

:func:`ell_layer` is one conv layer over every bucket: ``conv.ell(x_p,
ell)``, or ``conv.ell(x_p, ell, edge_attr)`` with edge features in
original COO order. It never materialises the reference's ``x_p[nbr]``
block ``[n_b, W, D]`` (``ell_gather``, :237-247) nor its ``edge_attr[
edge_slots]`` block (``ell_gather_edges``, :289-316): the convs read
neighbor and edge rows through the index tables inside kernel K6
``ell_aggregate`` (SAGE, GCN, GIN, GINE; ``ops/ell_aggregate.py``) or K7
``fanout_attention`` (GAT, GATv2, Transformer, with the edge rows as an
addend; ``ops/attention.py``), one autograd node per layer whose forward
fills one ``[N, D_out]`` output (K6: one launch over every bucket; K7:
one launch per bucket) and whose backward walks the transpose tables once
(K6b, after K7b for attention) — the scatter-free custom VJP of :237-286 —
and writes the edge table's gradient once per edge (K11
:func:`ell_edge_grad`, the permutation VJP of :303-313). K11's COO form,
:func:`coo_edge_grad`, writes the same terms for an edge table beside COO
edges, walking a destination ``SegmentIndex`` (the ``coo`` forms of the
edge convs). Masked slots
point at row 0 (``rank[v] * m``, ``eid * m``); the kernels honour the
mask (K6 as each row's count: the mask is its left-packed prefix), never
the index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.segment import gather_mode

EDGE_GRAD_MODES = {"gine": 0, "gat": 1, "transformer": 2, "gatv2": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check_prefix_masks(masks: Sequence[np.ndarray], deg_p: np.ndarray,
                        boundaries: Sequence[int]) -> None:
    """Raise unless every bucket's mask is a left-packed prefix whose row
    sums are the rows' in-degrees ``deg_p`` (permuted order): the valid
    slots of a row are then exactly its first ``deg_p`` entries, which is
    all that K6 reads of the mask."""
    for b, mk in enumerate(masks):
        deg = np.asarray(deg_p[boundaries[b]:boundaries[b + 1]])
        if mk.shape[0] != deg.shape[0] or not np.array_equal(
                mk, np.arange(mk.shape[1])[None, :] < deg[:, None]):
            raise ValueError(f"EllGraph: bucket {b}'s mask is not the "
                             "left-packed prefix of its rows' in-degrees")


@dataclass
class EllGraph:
    """Bucketed padded adjacency in permuted node space.

    perm[i] = original node id at permuted row i (bucket-contiguous);
    rank[v] = permuted row of original node v; deg_p = in-degree in
    permuted order. Per bucket b: nbr[b] [n_b, W_b] permuted-space neighbor
    rows, mask[b] validity, edge_slots[b] original COO edge row per entry;
    its dst rows are boundaries[b]:boundaries[b+1]. The transpose tables
    (t_rank, t_nbr, t_mask, t_boundaries, t_widths) serve the backward
    (K6b), with the derived t_perm (inverse of t_rank), t_row and t_edge
    (per transpose bucket, each slot's dst row and COO edge, -1 where
    masked), ent_row /
    ent_src / ent_edge / ent_mask (flat entry -> dst row, source row, COO
    edge, validity: the masks flattened once) and ent_off (bucket b's
    first entry); edge_pos (COO edge -> flat entry) serves the edge
    features' backward (K11). Each bucket's mask is the left-packed prefix
    of its rows' in-degrees (``from_csr`` checks it): K6 walks a row's
    first ``deg_p`` entries of ``ent_src`` and reads no mask."""

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
    ent_src: torch.Tensor              # [P] int32, flat entry -> x_p row
    ent_edge: torch.Tensor             # [P] int32, flat entry -> COO edge
    ent_mask: torch.Tensor             # [P] bool, flat entry validity
    t_row: Tuple[torch.Tensor, ...]    # per t-bucket [m, Wt] int32, dst row
    t_edge: Tuple[torch.Tensor, ...]   # per t-bucket [m, Wt] int32, edge

    @property
    def num_edges(self) -> int:
        return self.edge_pos.shape[0]

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
        _check_prefix_masks(masks, deg[perm], boundaries)
        nbrs = [rank[v] * m for v, m in zip(padded_nbr, masks)]
        eid = (np.asarray(csr.edge_ids, np.int64)
               if csr.edge_ids is not None else np.arange(len(indices)))
        # (an edgeless graph has no slot to read: its tables are all 0)
        slots_l = [eid[s] * m if len(eid) else np.zeros_like(s)
                   for s, m in zip(slot_idx, masks)]

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

        def flat(tables):
            return (np.concatenate([t.reshape(-1) for t in tables])
                    if tables else np.zeros((0,), np.int64))

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        def bools(a):
            return torch.as_tensor(a, device=device)

        ent_edge = flat(slots_l)

        def composed(t_nbr, t_mask, table):
            rows = np.full(t_nbr.shape, -1, np.int64)
            rows[t_mask] = table[t_nbr[t_mask]]
            return rows

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
            ent_off=tuple(int(o) for o in offs), ent_src=i32(flat(nbrs)),
            ent_edge=i32(ent_edge),
            ent_mask=bools(flat(masks).astype(bool)),
            t_row=tuple(i32(composed(v, m, ent_row))
                        for v, m in zip(t_padded, t_masks)),
            t_edge=tuple(i32(composed(v, m, ent_edge))
                         for v, m in zip(t_padded, t_masks)))


def _edge_rows(ea, slots):
    """ea[slots] in fp32 (slots of masked entries are 0; a graph without
    edges has no valid entry to read)."""
    if ea.shape[0] == 0:
        return torch.zeros(slots.shape + ea.shape[1:], dtype=torch.float32,
                           device=ea.device)
    return ea[slots.long()].float()


def _leaky_grad(z, negative_slope):
    """LeakyReLU's derivative, 1 at z >= 0 as JAX's."""
    return torch.where(z >= 0, 1.0, negative_slope)


def _ell_edge_grad_plain(g, ell, mode, x=None, ea=None, alpha=None,
                         coef=None, vec=None, xd=None, heads=1,
                         negative_slope=0.2):
    """Plain twin of K11, as the reference's ``_ell_ge_bwd``: the flat
    ``[P, D]`` cotangent of the gathered edge rows (each entry's term from
    its destination row of ``g``), masked, then gathered by ``edge_pos``.
    fp32 arithmetic, one rounding."""
    d = g.shape[1]
    if ell.num_edges == 0:
        return torch.zeros((0, d), dtype=g.dtype, device=g.device)
    r = ell.ent_row.long()
    gf = g.float()[r]                                      # [P, D]
    if mode == "gine":
        z = x.float()[ell.ent_src.long()] + _edge_rows(ea, ell.ent_edge)
        flat = torch.where(z > 0, gf, 0.0)
    elif mode == "gatv2":
        dh = d // heads
        z = (x.float()[ell.ent_src.long()] + _edge_rows(ea, ell.ent_edge)
             + xd.float()[r])
        flat = (alpha.repeat_interleave(dh, dim=1) * gf
                + coef.repeat_interleave(dh, dim=1) * vec.float()[None, :]
                * _leaky_grad(z, negative_slope))
    else:
        dh = d // heads
        other = (vec.float()[None, :] if mode == "gat"
                 else xd.float()[r])
        flat = (alpha.repeat_interleave(dh, dim=1) * gf
                + coef.repeat_interleave(dh, dim=1) * other)
    flat = flat * ell.ent_mask[:, None]
    return flat[ell.edge_pos.long()].to(g.dtype)


def ell_edge_grad(g: torch.Tensor, ell: EllGraph, mode: str, *,
                  x: Optional[torch.Tensor] = None,
                  ea: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None,
                  coef: Optional[torch.Tensor] = None,
                  vec: Optional[torch.Tensor] = None,
                  xd: Optional[torch.Tensor] = None,
                  heads: int = 1,
                  negative_slope: float = 0.2) -> torch.Tensor:
    """K11: the gradient of an ELL layer's edge table, [E, D] in COO edge
    order, each row written once from edge e's entry ``edge_pos[e]`` (the
    kernel walks the valid entries in destination order). ``g``
    [N, D]: the layer's output cotangent by destination row. ``mode``
    ``gine``: ``g[row] * 1[x[src] + ea[e] > 0]`` (x [N, D] the layer's
    input, ea [E, D] its edge table); ``gat``: ``alpha[p, h] * g[row] +
    coef[p, h] * vec`` (alpha, coef [P, H] fp32 from K7b, vec [D] fp32
    att_src); ``transformer``: ``alpha * g[row] + coef * xd[row]`` (xd
    [N, D] the query rows; K7b's coef is divided by sqrt(Dh) already);
    ``gatv2``: ``alpha * g[row] + coef * vec * leaky'((x[src] + ea[e]) +
    xd[row])`` (x the key table, xd the destination rows, vec att, coef
    the logit cotangent; leaky' 1 at >= 0, else ``negative_slope``)."""
    if mode not in EDGE_GRAD_MODES:
        raise ValueError(f"ell_edge_grad: unknown mode {mode!r}")
    need = {"gine": (x, ea), "gat": (alpha, coef, vec),
            "transformer": (alpha, coef, xd),
            "gatv2": (x, ea, alpha, coef, vec, xd)}[mode]
    if any(t is None for t in need):
        raise ValueError(f"ell_edge_grad: mode {mode!r} is missing an "
                         "operand")
    d = g.shape[1]
    if d % heads:
        raise ValueError(f"ell_edge_grad: {d} not divisible by {heads} "
                         "heads")
    if g.device.type == "cpu":
        return _ell_edge_grad_plain(g, ell, mode, x, ea, alpha, coef, vec,
                                    xd, heads, negative_slope)
    device = _build.require_cuda("ell_edge_grad", g, ell.ent_mask,
                                 ell.ent_row, ell.ent_src, ell.ent_edge,
                                 *need)
    n, e, p_total = ell.num_nodes, ell.num_edges, ell.ent_row.shape[0]
    if g.dim() != 2 or g.shape[0] != n or g.dtype not in _DTYPES:
        raise ValueError("ell_edge_grad: g must be [N, D], fp32 or bf16")
    rows = {"x": (x, (n, d)), "ea": (ea, (e, d)), "xd": (xd, (n, d))}
    for name, (t, shape) in rows.items():
        if t is not None and (t.shape != shape or t.dtype != g.dtype):
            raise ValueError(f"ell_edge_grad: {name} must be {shape} of "
                             "g's type")
    for t in (alpha, coef):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (p_total, heads)):
            raise ValueError("ell_edge_grad: alpha / coef must be fp32 "
                             f"[P={p_total}, {heads}]")
    if vec is not None and (vec.dtype != torch.float32 or vec.shape != (d,)):
        raise ValueError(f"ell_edge_grad: vec must be fp32 [{d}]")
    out = torch.empty((e, d), dtype=g.dtype, device=device)
    vec_path = int((d * g.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, x, ea, xd, out)
        if t is not None))
    _build.launch("ell_edge_grad", "gigl_ell_edge_grad", device,
                  g.data_ptr(), ell.ent_mask.data_ptr(),
                  ell.ent_row.data_ptr(), ell.ent_src.data_ptr(),
                  ell.ent_edge.data_ptr(), _build.ptr(x), _build.ptr(ea),
                  _build.ptr(alpha), _build.ptr(coef), _build.ptr(vec),
                  _build.ptr(xd), out.data_ptr(), p_total, d, heads,
                  d // heads, _DTYPES[g.dtype], EDGE_GRAD_MODES[mode],
                  vec_path, None, 0, float(negative_slope))
    if mode == "gatv2":
        _build.launches["ell_edge_grad_gatv2"] += 1
    return out



def _coo_edge_grad_plain(g, src, dst, mode, x=None, ea=None, alpha=None,
                         coef=None, vec=None, xd=None, heads=1,
                         negative_slope=0.2):
    """Plain twin of K11's COO form: per edge e, its term from its
    destination's row of ``g``, fp32 arithmetic, one rounding."""
    d = g.shape[1]
    gf = g.float()[dst.long()]                             # [E, D]
    if mode == "gine":
        z = x.float()[src.long()] + ea.float()
        return torch.where(z > 0, gf, 0.0).to(g.dtype)
    dh = d // heads
    out = alpha.float().repeat_interleave(dh, dim=1) * gf
    if mode == "gatv2":
        z = x.float()[src.long()] + ea.float() + xd.float()[dst.long()]
        return (out + coef.float().repeat_interleave(dh, dim=1)
                * vec.float()[None, :]
                * _leaky_grad(z, negative_slope)).to(g.dtype)
    if coef is not None:
        other = (vec.float()[None, :] if mode == "gat"
                 else xd.float()[dst.long()])
        out = out + coef.float().repeat_interleave(dh, dim=1) * other
    return out.to(g.dtype)


def coo_edge_grad(g: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  index, mode: str, *, x: Optional[torch.Tensor] = None,
                  ea: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None,
                  coef: Optional[torch.Tensor] = None,
                  vec: Optional[torch.Tensor] = None,
                  xd: Optional[torch.Tensor] = None,
                  heads: int = 1,
                  negative_slope: float = 0.2) -> torch.Tensor:
    """K11's COO form: the gradient [E, D] of an edge table read beside
    COO edges ``src`` -> ``dst`` (each edge's row by its id), walking
    ``index`` (the destination ``SegmentIndex``: its order and pointers;
    with gine also its ``gathered`` source rows when ``src`` is the tensor
    it was built from). ``mode`` ``gine``: ``g[dst] * 1[x[src] + ea > 0]``;
    ``gat``: ``alpha[e, h] * g[dst] + coef[e, h] * vec`` (coef None: the
    first term alone); ``transformer``: ``alpha * g[dst] + coef * xd[dst]``;
    ``gatv2``: ``alpha * g[dst] + coef * vec * leaky'((x[src] + ea) +
    xd[dst])`` (leaky' 1 at >= 0, else ``negative_slope``). alpha and coef
    are fp32 [E, H]."""
    if mode not in EDGE_GRAD_MODES:
        raise ValueError(f"coo_edge_grad: unknown mode {mode!r}")
    need = {"gine": (x, ea), "gat": (alpha,) + (
        () if coef is None else (vec,)), "transformer": (alpha, coef, xd),
        "gatv2": (x, ea, alpha, coef, vec, xd)}[mode]
    if any(t is None for t in need):
        raise ValueError(f"coo_edge_grad: mode {mode!r} is missing an "
                         "operand")
    d = g.shape[1]
    if d % heads:
        raise ValueError(f"coo_edge_grad: {d} not divisible by {heads} "
                         "heads")
    if g.device.type == "cpu":
        return _coo_edge_grad_plain(g, src, dst, mode, x, ea, alpha, coef,
                                    vec, xd, heads, negative_slope)
    e = src.shape[0]
    if index is None or index.num_edges != e \
            or index.num_segments != g.shape[0]:
        raise ValueError("coo_edge_grad: needs the destination SegmentIndex "
                         "of these edges")
    rows = None
    if mode in ("gine", "gatv2"):
        rows = (index.gathered if gather_mode(src, index) == "composed"
                else src.long()[index.order.long()].to(torch.int32))
    coef_c = None if coef is None else coef.contiguous()
    alpha_c = None if alpha is None else alpha.contiguous()
    tabs = [t for t in (x, ea, alpha_c, coef_c, vec, xd, rows)
            if t is not None]
    device = _build.require_cuda("ell_edge_grad", g, index.order, index.ptr,
                                 *tabs)
    if g.dim() != 2 or g.dtype not in _DTYPES:
        raise ValueError("coo_edge_grad: g must be [S, D], fp32 or bf16")
    shapes = {"x": (x, None), "ea": (ea, (e, d)),
              "xd": (xd, tuple(g.shape))}
    for name, (t, shape) in shapes.items():
        if t is not None and ((shape is not None and t.shape != shape)
                              or t.dtype != g.dtype or t.shape[-1] != d):
            raise ValueError(f"coo_edge_grad: {name} must be [.., {d}] of "
                             "g's type")
    for t in (alpha_c, coef_c):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (e, heads)):
            raise ValueError("coo_edge_grad: alpha / coef must be fp32 "
                             f"[E={e}, {heads}]")
    if vec is not None and (vec.dtype != torch.float32 or vec.shape != (d,)):
        raise ValueError(f"coo_edge_grad: vec must be fp32 [{d}]")
    out = torch.empty((e, d), dtype=g.dtype, device=device)
    vec_path = int((d * g.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (g, x, ea, xd, out)
        if t is not None))
    if e:
        _build.launch("ell_edge_grad", "gigl_ell_edge_grad", device,
                      g.data_ptr(), None, None, _build.ptr(rows),
                      index.order.data_ptr(), _build.ptr(x), _build.ptr(ea),
                      _build.ptr(alpha_c), _build.ptr(coef_c),
                      _build.ptr(vec), _build.ptr(xd), out.data_ptr(), e, d,
                      heads, d // heads, _DTYPES[g.dtype],
                      EDGE_GRAD_MODES[mode], vec_path, index.ptr.data_ptr(),
                      g.shape[0], float(negative_slope))
        _build.launches["ell_edge_grad_coo"] += 1
        if mode == "gatv2":
            _build.launches["ell_edge_grad_gatv2"] += 1
    return out

def ell_layer(conv, x_p: torch.Tensor, ell: EllGraph,
              edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv layer over the whole permuted graph: x_p [N, D] in
    permuted order -> [N, D_out] in permuted order (``conv.ell``; GCN
    reads the in-degrees ``ell.deg_p`` for both ends). ``edge_attr`` [E,
    De] in original COO order, reached through ``ell.edge_slots``: the
    edge convs read it, the others ignore it as the reference's blocks
    do."""
    if edge_attr is None:
        return conv.ell(x_p, ell)
    if edge_attr.shape[0] != ell.num_edges:
        raise ValueError(f"edge_attr has {edge_attr.shape[0]} rows for "
                         f"{ell.num_edges} edges")
    return conv.ell(x_p, ell, edge_attr)
