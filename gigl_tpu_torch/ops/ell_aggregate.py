"""Indexed masked neighbor aggregation and its backward: kernels K6
``ell_aggregate`` and K6b ``ell_transpose_aggregate``.

``csrc/ell_aggregate.cu`` replaces ``gigl_tpu/ops/ell.py`` ``ell_gather``
(:237-247) fused with the masked reduce each conv applies to the gathered
``[n, W, D]`` block (``gigl_tpu/ops/fanout.py:34-53``; GCN's weighted sum,
``gigl_tpu/models/convs.py:107-112``), without writing that block:

    out[i] = reduce_{j < W, mask[i, j]} w_ij * x[nbr[i, j]]

``reduce`` is ``mean``, ``sum`` or ``max`` (w = 1), ``gcn``: a sum with
``w_ij = rsqrt(deg_dst[i] + 1) * rsqrt(deg_tab[nbr[i, j]] + 1)``, or
``gine``: GINE's ``sum_j relu(x[nbr[i, j]] + ea[eslot[i, j]])``
(``GINEConv.block``, ``convs.py:217-223``) with the forward of
``ell_gather_edges`` (``gigl_tpu/ops/ell.py:289-316``) fused in: the edge
rows are read through the bucket's edge slots, no ``[n, W, D]`` edge block.
fp32 accumulation (GINE: the add and the relu too), one rounding to x's
type; rows with no valid slot give 0. One launch covers every bucket of an
:class:`~gigl_tpu_torch.ops.ell.EllGraph` (:func:`_ell_aggregate_fwd`): it
walks the flat entry tables ``ent_src`` / ``ent_edge`` up to each row's
count ``deg_p`` (its mask is that left-packed prefix, which ``from_csr``
checks), so it reads no mask. :func:`_ell_aggregate_plain` is the
reference's arithmetic over one bucket's ``nbr`` / ``mask`` and
:func:`_ell_aggregate_graph_plain` the same over every bucket from the flat
tables: K6's plain twin, run for CPU tensors only.

``csrc/ell_transpose.cu`` (K6b) replaces ``_ell_gather_bwd`` (:255-283),
the scatter-free custom VJP of ``ell_gather``, fused with the reduce's
cotangent: it walks the transpose tables (each slot's destination row
composed in ``EllGraph.t_row``) and writes each source row's gradient
once, in x_p order (see :func:`ell_transpose_aggregate`). Its
plain twin :func:`_ell_transpose_plain` follows the reference's
formulation: the flat ``[P, D]`` entry cotangents, ``flat[t_nbr] * t_mask``
summed per transpose bucket, gathered back by ``t_rank``.

:func:`ell_aggregate_graph` is the trainable form over a whole
:class:`~gigl_tpu_torch.ops.ell.EllGraph`: one ``autograd.Function`` whose
forward launches K6 once into one ``[N, D]`` output and whose
backward is K6b (mean, sum, gcn, and max: the cotangent shared among the
slots equal to the max, as ``jax.vjp`` of ``jnp.max`` shares it, from tie
counts taken over the forward tables; gine: each entry gated by its relu)
and, for GINE's edge table, K11 (``ops/ell.py`` ``ell_edge_grad``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.ell import _edge_rows, ell_edge_grad
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain

OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3, "gine": 4}
T_OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3, "weighted": 4,
         "gatv2": 5, "gine": 6}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Non-empty buckets one K6 launch walks (csrc/ell_aggregate.cu kMaxSegments):
# default widths give far fewer; a graph with more takes a launch per this
# many of them.
MAX_SEGMENTS = 48


def _ell_aggregate_plain(x, nbr, mask, op, deg_dst=None, deg_tab=None,
                         ea=None, eslot=None):
    """Plain twin of K6: fp32 arithmetic, one rounding to x's type."""
    feats = x[nbr.long()].float()                        # [n, W, D]
    if op == "gine":
        if ea is not None:
            feats = feats + _edge_rows(ea, eslot)
        feats, op = torch.relu(feats), "sum"
    if op == "gcn":
        w = torch.rsqrt(deg_dst.float() + 1.0)[:, None] * torch.rsqrt(
            deg_tab.float()[nbr.long()] + 1.0)
        feats, op = feats * w[..., None], "sum"
    return _masked_reduce_plain(feats, mask, op).to(x.dtype)


def _rows_of(ell, rows):
    """The graph rows [lo, hi) a K6 call covers (all by default)."""
    lo, hi = (0, ell.num_nodes) if rows is None else (int(rows[0]),
                                                      int(rows[1]))
    if not 0 <= lo <= hi <= ell.num_nodes:
        raise ValueError(f"ell_aggregate: rows [{lo}, {hi}) outside the "
                         f"graph's {ell.num_nodes}")
    return lo, hi


def _bucket_parts(ell, lo, hi):
    """Per bucket b meeting [lo, hi): (b, its first and last row + 1 there,
    the flat entry of that first row), in bucket order."""
    parts = []
    for b, w in enumerate(ell.widths):
        r0 = max(lo, ell.boundaries[b])
        r1 = min(hi, ell.boundaries[b + 1])
        if r1 > r0:
            parts.append((b, r0, r1,
                          ell.ent_off[b] + (r0 - ell.boundaries[b]) * w))
    return parts


def _ell_aggregate_graph_plain(x, ell, op, ea=None, rows=None):
    """Plain twin of K6 over ``ell``'s rows [lo, hi): per bucket, the
    reference's gather and masked reduce (:func:`_ell_aggregate_plain`)
    over its block of the flat entry tables, the mask each row's count
    ``deg_p`` as a left-packed prefix."""
    lo, hi = _rows_of(ell, rows)
    outs = []
    for b, r0, r1, e0 in _bucket_parts(ell, lo, hi):
        w = ell.widths[b]
        ent = slice(e0, e0 + (r1 - r0) * w)
        deg = ell.deg_p[r0:r1]
        mask = torch.arange(w, device=deg.device)[None, :] < deg[:, None]
        eslot = None if ea is None else ell.ent_edge[ent].view(-1, w)
        outs.append(_ell_aggregate_plain(
            x, ell.ent_src[ent].view(-1, w), mask, op, deg, ell.deg_p, ea,
            eslot))
    if not outs:
        return torch.zeros((hi - lo, x.shape[1]), dtype=x.dtype,
                           device=x.device)
    return torch.cat(outs)


def _ell_aggregate_fwd(x, ell, op, ea=None, rows=None):
    """K6 launch (plain twin for CPU tensors): x [N, D] in permuted order
    -> [hi - lo, D], every row r of ``ell`` in ``rows`` = (lo, hi) (all
    by default) reduced over its in-neighbors, in one launch (one per
    ``MAX_SEGMENTS`` non-empty buckets past that many). ``op`` "gcn"
    reads ``ell.deg_p`` for both ends; "gine" takes ea [E, D] of x's type
    (read through ``ell.ent_edge``), or None (relu of the neighbor rows
    alone)."""
    if op not in OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if ea is not None and op != "gine":
        raise ValueError("ell_aggregate: edge rows in gine mode only")
    lo, hi = _rows_of(ell, rows)
    if x.device.type == "cpu":
        return _ell_aggregate_graph_plain(x, ell, op, ea, (lo, hi))
    edges = (ea, ell.ent_edge) if ea is not None else ()
    device = _build.require_cuda("ell_aggregate", x, ell.ent_src, ell.deg_p,
                                 *edges)
    if x.dim() != 2 or x.shape[0] != ell.num_nodes \
            or x.dtype not in _DTYPES:
        raise ValueError(f"ell_aggregate: x must be [N={ell.num_nodes}, D], "
                         f"fp32 or bf16, got {x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    if ea is not None and (ea.shape != (ell.num_edges, d)
                           or ea.dtype != x.dtype):
        raise ValueError(f"ell_aggregate: gine needs ea [E={ell.num_edges}, "
                         "D] of x's type")
    out = torch.empty((hi - lo, d), dtype=x.dtype, device=device)
    # the widest bucket's rows first: hub rows do not form the tail
    parts = _bucket_parts(ell, lo, hi)[::-1]
    if not parts:
        return out
    segs = np.array([(r0, r1 - r0, e0, ell.widths[b])
                     for b, r0, r1, e0 in parts], np.int64).reshape(-1, 4)
    vec = int((d * x.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, out, ea) if t is not None))
    ids4 = int(all(e0 % 4 == 0 and ell.widths[b] % 4 == 0
                   for b, _, _, e0 in parts) and all(
        t.data_ptr() % 16 == 0 for t in (ell.ent_src, *edges[1:])))
    for k in range(0, len(segs), MAX_SEGMENTS):
        chunk = segs[k:k + MAX_SEGMENTS]                 # rows: contiguous
        _build.launch("ell_aggregate", "gigl_ell_aggregate", device,
                      x.data_ptr(), ell.ent_src.data_ptr(),
                      _build.ptr(edges[1] if edges else None),
                      ell.deg_p.data_ptr(), _build.ptr(ea), out.data_ptr(),
                      chunk.ctypes.data, len(chunk), lo, d,
                      _DTYPES[x.dtype], OPS[op], vec, ids4)
    return out


def _entry_weights(ell, op, wt, wt2, vec, heads, d, rows2, table,
                   negative_slope):
    """The flat [P, D] multiplier of each entry's cotangent row (and the
    additive GAT / GATv2 term), in the reference's layout."""
    deg = ell.deg_p.float()
    r = ell.ent_row.long()
    src = torch.cat([nb.reshape(-1) for nb in ell.nbr]).long()
    if op == "mean":
        return 1.0 / deg[r].clamp(min=1.0)[:, None], None
    if op == "sum":
        return None, None
    if op == "gcn":
        return (torch.rsqrt(deg[r] + 1.0)
                * torch.rsqrt(deg[src] + 1.0))[:, None], None
    dh = d // heads
    add = None
    if op == "gatv2":
        z = table.float()[src] + rows2.float()[r]           # key + query
        add = (vec.float()[None, :] * wt2.float().repeat_interleave(dh, 1)
               * torch.where(z >= 0, 1.0, negative_slope))
    elif wt2 is not None:
        add = vec.float()[None, :] * wt2.float().repeat_interleave(dh, dim=1)
    return wt.float().repeat_interleave(dh, dim=1), add


def _tie_count_plain(table, ell, ref):
    """Plain twin of the tie counts: per row, the valid slots whose
    ``table`` value equals ``ref`` (the forward's max), fp32 [N, D]."""
    cnt = torch.zeros(ref.shape, dtype=torch.float32, device=ref.device)
    for b in range(len(ell.widths)):
        lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
        if hi > lo:
            eq = table[ell.nbr[b].long()] == ref[lo:hi, None]
            cnt[lo:hi] = (eq & ell.mask[b][..., None]).sum(1).float()
    return cnt


def _ell_transpose_plain(rows, ell, op, wt=None, wt2=None, vec=None,
                         heads=1, rows2=None, table=None,
                         negative_slope=0.2, ea=None):
    """Plain twin of K6b, as the reference's ``_ell_gather_bwd``: the flat
    entry cotangents ``flat [P, D]`` (each entry's destination row of
    ``rows``, times its weight), ``flat[t_nbr] * t_mask`` summed per
    transpose bucket, concatenated in t-row order and gathered back to x_p
    order by ``t_rank``. fp32 arithmetic, one rounding."""
    d = rows.shape[1]
    r = ell.ent_row.long()
    flat = rows.float()[r]                               # [P, D]
    if op == "max":
        src = torch.cat([nb.reshape(-1) for nb in ell.nbr]).long()
        cnt = _tie_count_plain(table, ell, rows2)
        flat = torch.where(table[src] == rows2[r], flat / cnt[r].clamp(
            min=1.0), 0.0)
    elif op == "gine":
        z = table.float()[ell.ent_src.long()]
        if ea is not None:
            z = z + _edge_rows(ea, ell.ent_edge)
        flat = torch.where(z > 0, flat, 0.0)
    else:
        mul, add = _entry_weights(ell, op, wt, wt2, vec, heads, d, rows2,
                                  table, negative_slope)
        if mul is not None:
            flat = flat * mul
        if add is not None:
            flat = flat + add
    return _transpose_sum(flat, ell, rows.dtype)


def _transpose_sum(flat, ell, dtype):
    """The flat [P, D] entry rows summed per source: ``flat[t_nbr] *
    t_mask`` per transpose bucket, gathered back to x_p order by
    ``t_rank``, rounded once to ``dtype``."""
    parts = []
    for tb in range(len(ell.t_widths)):
        if ell.t_nbr[tb].shape[0] == 0:
            continue
        g = flat[ell.t_nbr[tb].long()]                   # [m, Wt, D]
        parts.append((g * ell.t_mask[tb][..., None]).sum(dim=1))
    if not parts:
        return torch.zeros((ell.num_nodes, flat.shape[1]), dtype=dtype,
                           device=flat.device)
    dx_t = torch.cat(parts, dim=0)                        # t-row order
    return dx_t[ell.t_rank.long()].to(dtype)


def _ell_edge_rows_sum_plain(rows, ell):
    """Plain twin of K6b's sum over t_edge: the flat entry rows
    ``rows[ent_edge]`` (masked) summed per transpose bucket as the
    reference's ``_ell_gather_bwd`` does."""
    d = rows.shape[1]
    flat = (rows.float()[ell.ent_edge.long()] if ell.num_edges
            else torch.zeros((ell.ent_edge.shape[0], d), device=rows.device))
    return _transpose_sum(flat * ell.ent_mask[:, None], ell, rows.dtype)


def ell_edge_rows_sum(rows: torch.Tensor, ell) -> torch.Tensor:
    """K6b's sum over ``EllGraph.t_edge``: for every x_p row v, the sum
    of ``rows[e]`` over the COO edges e whose entries read v -> [N, D] in
    x_p order. ``rows`` [E, D] is a per-edge table in COO edge order (GATv2
    with edge rows: the edge table's gradient, which is also each entry's
    key-row cotangent). The kernel is K6b's sum mode given ``t_edge`` in
    place of ``t_row``: each slot's row read through the edge id composed
    at build, fp32 sums in slot order, one rounding
    (:func:`_ell_edge_rows_sum_plain` is its twin)."""
    n, e = ell.num_nodes, ell.num_edges
    if rows.dim() != 2 or rows.shape[0] != e or rows.dtype not in _DTYPES:
        raise ValueError(f"ell_edge_rows_sum: rows must be [E={e}, D], "
                         "fp32 or bf16")
    d = rows.shape[1]
    if rows.device.type == "cpu":
        return _ell_edge_rows_sum_plain(rows, ell)
    device = _build.require_cuda("ell_transpose_aggregate", rows, ell.t_perm,
                                 *ell.t_edge)
    out = torch.empty((n, d), dtype=rows.dtype, device=device)
    vec_path = int((d * rows.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (rows, out)))
    for tb, tw in enumerate(ell.t_widths):
        lo, hi = ell.t_boundaries[tb], ell.t_boundaries[tb + 1]
        if hi == lo:
            continue
        _build.launch("ell_transpose_aggregate",
                      "gigl_ell_transpose_aggregate", device,
                      rows.data_ptr(), None, ell.t_edge[tb].data_ptr(),
                      ell.t_perm[lo:hi].data_ptr(), None, None, None, None,
                      None, None, None, None, None, out.data_ptr(), hi - lo,
                      tw, d, 1, d, _DTYPES[rows.dtype], T_OPS["sum"],
                      vec_path, 0.0)
        _build.launches["ell_transpose_edge_rows"] += 1
    return out


def ell_transpose_aggregate(rows: torch.Tensor, ell, op: str,
                            wt: Optional[torch.Tensor] = None,
                            wt2: Optional[torch.Tensor] = None,
                            vec: Optional[torch.Tensor] = None,
                            heads: int = 1,
                            rows2: Optional[torch.Tensor] = None,
                            table: Optional[torch.Tensor] = None,
                            negative_slope: float = 0.2,
                            ea: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K6b: for every x_p row v, ``sum over the forward entries p that read
    v of w(p) * rows[ent_row[p]]`` -> [N, D] in x_p order, one launch per
    non-empty transpose bucket. ``rows`` [N, D] is the cotangent of the
    layer's output in permuted order (weighted: any [N, D] table whose rows
    are indexed by destination row). ``op``: ``mean`` (w = 1 / the dst's
    in-degree), ``sum`` (1), ``gcn`` (rsqrt(deg[dst] + 1) * rsqrt(deg[v] +
    1)), ``weighted`` (w = wt[p, h] for head h of the value, wt [P, H]
    fp32 in flat entry order; with wt2 [P, H] and vec [D], plus vec[e] *
    sum_p wt2[p, h]), ``gatv2`` (wt[p, h] * rows[dst] + wt2[p, h] *
    vec[e] * leaky'(table[v] + rows2[dst]): GATv2's value and key
    gradients, with rows2 the query table and table the key table [N, D],
    leaky' 1 at >= 0, else ``negative_slope``), ``max`` (rows[dst] /
    ties where table[v] equals rows2[dst], the forward's max of ``table``;
    the tie counts come from the forward tables first) or ``gine``
    (rows[dst] where table[v] + ea[ent_edge[p]] > 0: the relu's gate, with
    table the layer's input and ea [E, D] its edge rows, or None)."""
    if op not in T_OPS:
        raise ValueError(f"ell_transpose_aggregate: unknown mode {op!r}")
    n, d = ell.num_nodes, rows.shape[1]
    if op in ("weighted", "gatv2"):
        if wt is None or (wt2 is None) != (vec is None):
            raise ValueError("ell_transpose_aggregate: weighted takes wt, "
                             "and wt2 with vec or neither")
        if d % heads:
            raise ValueError(f"ell_transpose_aggregate: {d} not divisible "
                             f"by {heads} heads")
    if op in ("gatv2", "max") and (
            rows2 is None or table is None or rows2.shape != rows.shape
            or table.shape != rows.shape or rows2.dtype != rows.dtype
            or table.dtype != rows.dtype):
        raise ValueError(f"ell_transpose_aggregate: {op} takes rows2 and "
                         "table shaped and typed as rows")
    if op == "gatv2" and wt2 is None:
        raise ValueError("ell_transpose_aggregate: gatv2 takes wt, wt2 and "
                         "vec")
    if op == "gine" and (table is None or table.shape != rows.shape
                         or table.dtype != rows.dtype):
        raise ValueError("ell_transpose_aggregate: gine takes table shaped "
                         "and typed as rows")
    if ea is not None and (op != "gine" or ea.dim() != 2
                           or ea.shape[1] != d or ea.dtype != rows.dtype):
        raise ValueError("ell_transpose_aggregate: ea [E, D] of rows' type, "
                         "in gine mode only")
    if rows.device.type == "cpu":
        return _ell_transpose_plain(rows, ell, op, wt, wt2, vec, heads,
                                    rows2, table, negative_slope, ea)
    extra = tuple(t for t in (wt, wt2, vec, rows2, table, ea)
                  if t is not None)
    device = _build.require_cuda("ell_transpose_aggregate", rows,
                                 ell.t_perm, ell.deg_p, *ell.t_row, *extra)
    # the modes that read each slot's flat entry beside its row
    by_entry = op in ("weighted", "gatv2") or ea is not None
    if rows.dim() != 2 or rows.shape[0] != n or rows.dtype not in _DTYPES:
        raise ValueError("ell_transpose_aggregate: rows must be [N, D], "
                         "fp32 or bf16")
    p_total = ell.ent_row.shape[0]
    for t in (wt, wt2):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != (p_total, heads)):
            raise ValueError("ell_transpose_aggregate: wt / wt2 must be "
                             f"fp32 [P={p_total}, {heads}]")
    if vec is not None and (vec.dtype != torch.float32 or vec.shape != (d,)):
        raise ValueError(f"ell_transpose_aggregate: vec must be fp32 [{d}]")
    out = torch.empty((n, d), dtype=rows.dtype, device=device)
    vec_path = int((d * rows.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (rows, out, rows2, table, ea)
        if t is not None))
    cnt = None
    if op == "max":
        cnt = torch.empty((n, d), dtype=torch.float32, device=device)
        for b, bw in enumerate(ell.widths):
            lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
            if hi == lo:
                continue
            _build.launch("ell_transpose_aggregate", "gigl_ell_tie_count",
                          device, table.data_ptr(), ell.nbr[b].data_ptr(),
                          ell.mask[b].data_ptr(), rows2[lo:hi].data_ptr(),
                          cnt[lo:hi].data_ptr(), hi - lo, bw, d,
                          _DTYPES[rows.dtype], vec_path)
    for tb, tw in enumerate(ell.t_widths):
        lo, hi = ell.t_boundaries[tb], ell.t_boundaries[tb + 1]
        if hi == lo:
            continue
        _build.launch("ell_transpose_aggregate",
                      "gigl_ell_transpose_aggregate", device,
                      rows.data_ptr(),
                      _build.ptr(ell.t_nbr[tb] if by_entry else None),
                      ell.t_row[tb].data_ptr(), ell.t_perm[lo:hi].data_ptr(),
                      ell.deg_p.data_ptr(), _build.ptr(wt), _build.ptr(wt2),
                      _build.ptr(vec), _build.ptr(rows2), _build.ptr(table),
                      _build.ptr(cnt),
                      _build.ptr(ea),
                      _build.ptr(None if ea is None else ell.ent_edge),
                      out.data_ptr(),
                      hi - lo, tw, d, heads, d // heads, _DTYPES[rows.dtype],
                      T_OPS[op], vec_path, float(negative_slope))
    return out


class EllAggregateGraph(torch.autograd.Function):
    """K6 over every bucket in one launch into one [N, D] output; the
    backward is K6b (and, for GINE's edge table, K11)."""

    @staticmethod
    def forward(ctx, src, ea, ell, op):
        out = _ell_aggregate_fwd(src, ell, op, ea=ea)
        ctx.ell, ctx.op = ell, op
        if op == "max":
            ctx.save_for_backward(src, out)
        elif op == "gine":
            ctx.save_for_backward(src, ea)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        g = grad_out.contiguous()
        d_src = d_ea = None
        if ctx.op == "gine":
            src, ea = ctx.saved_tensors
            if ctx.needs_input_grad[0]:
                d_src = ell_transpose_aggregate(g, ctx.ell, "gine",
                                                table=src, ea=ea)
            if ctx.needs_input_grad[1]:
                d_ea = ell_edge_grad(g, ctx.ell, "gine", x=src, ea=ea)
            return d_src, d_ea, None, None
        if ctx.needs_input_grad[0]:
            saved = dict(zip(("table", "rows2"), ctx.saved_tensors))
            d_src = ell_transpose_aggregate(g, ctx.ell, ctx.op, **saved)
        return d_src, None, None, None


def ell_aggregate_graph(src: torch.Tensor, ell, op: str,
                        ea: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every row's aggregate over its whole in-neighborhood: src [N, D] in
    permuted order -> [N, D] (``op`` mean | sum | max | gcn | gine; gcn
    reads ``ell.deg_p`` for both ends; gine sums relu(src[j] + ea[e]) with
    ``ea`` [E, D] in COO edge order, or relu(src[j]) without).
    Differentiable in ``src`` through K6b and in ``ea`` through K11."""
    if op not in OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if ea is not None and op != "gine":
        raise ValueError("ell_aggregate_graph: edge rows in gine mode only")
    return EllAggregateGraph.apply(
        src.contiguous(), None if ea is None else ea.contiguous(), ell, op)
