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
type; rows with no valid slot give 0. :func:`_ell_aggregate_plain` is its
plain twin, run for CPU tensors only.

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
forward launches K6 per bucket into one ``[N, D]`` output and whose
backward is K6b (mean, sum, gcn, and max: the cotangent shared among the
slots equal to the max, as ``jax.vjp`` of ``jnp.max`` shares it, from tie
counts taken over the forward tables; gine: each entry gated by its relu)
and, for GINE's edge table, K11 (``ops/ell.py`` ``ell_edge_grad``).
"""

from __future__ import annotations

from typing import Optional

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.ell import _edge_rows, ell_edge_grad
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain

OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3, "gine": 4}
T_OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3, "weighted": 4,
         "gatv2": 5, "gine": 6}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _ell_aggregate_fwd(x, nbr, mask, op, deg_dst=None, deg_tab=None,
                       out=None, ea=None, eslot=None):
    """K6 launch (plain twin for CPU tensors): x [M, D], nbr [n, W] int32
    rows of x, mask [n, W] bool -> [n, D], into ``out`` when given; ``op``
    "gcn" also takes deg_dst [n] and deg_tab [M] (f32 in-degrees, without
    the self loop), "gine" ea [E, D] of x's type with eslot [n, W] int32
    (its rows per slot), or neither (relu of the neighbor rows alone)."""
    if op not in OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if op == "gcn" and (deg_dst is None or deg_tab is None):
        raise ValueError("ell_aggregate: gcn needs deg_dst and deg_tab")
    if (ea is None) != (eslot is None) or (ea is not None and op != "gine"):
        raise ValueError("ell_aggregate: ea and eslot go together, in gine "
                         "mode only")
    if x.device.type == "cpu":
        got = _ell_aggregate_plain(x, nbr, mask, op, deg_dst, deg_tab, ea,
                                   eslot)
        return got if out is None else out.copy_(got)
    degs = (deg_dst, deg_tab) if op == "gcn" else ()
    edges = (ea, eslot) if ea is not None else ()
    device = _build.require_cuda("ell_aggregate", x, nbr, mask, *degs,
                                 *edges)
    if x.dim() != 2 or nbr.dim() != 2 or mask.shape != nbr.shape:
        raise ValueError("ell_aggregate: expected x [M, D], nbr and mask "
                         f"[n, W], got {tuple(x.shape)} / {tuple(nbr.shape)} "
                         f"/ {tuple(mask.shape)}")
    if nbr.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("ell_aggregate: nbr must be int32 and mask bool")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ell_aggregate: dtype {x.dtype} not supported")
    (n, w), d = nbr.shape, x.shape[1]
    if op == "gcn" and (deg_dst.dtype != torch.float32 or deg_dst.shape != (n,)
                        or deg_tab.dtype != torch.float32
                        or deg_tab.shape != (x.shape[0],)):
        raise ValueError("ell_aggregate: gcn needs f32 deg_dst [n] and "
                         "deg_tab [M]")
    if ea is not None and (ea.dim() != 2 or ea.shape[1] != d
                           or ea.dtype != x.dtype or eslot.shape != nbr.shape
                           or eslot.dtype != torch.int32):
        raise ValueError("ell_aggregate: gine needs ea [E, D] of x's type "
                         "and eslot [n, W] int32")
    if out is None:
        out = torch.empty((n, d), dtype=x.dtype, device=device)
    elif out.shape != (n, d) or out.dtype != x.dtype \
            or not out.is_contiguous() or out.device != device:
        raise ValueError("ell_aggregate: out must be a contiguous [n, D] "
                         "tensor of x's type on x's device")
    vec = int((d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0
              and (ea is None or ea.data_ptr() % 16 == 0))
    _build.launch("ell_aggregate", "gigl_ell_aggregate", device,
                  x.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                  _build.ptr(deg_dst if degs else None),
                  _build.ptr(deg_tab if degs else None), _build.ptr(ea),
                  _build.ptr(eslot), out.data_ptr(),
                  n, w, d, _DTYPES[x.dtype], OPS[op], vec)
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
    parts = []
    for tb in range(len(ell.t_widths)):
        if ell.t_nbr[tb].shape[0] == 0:
            continue
        g = flat[ell.t_nbr[tb].long()]                   # [m, Wt, D]
        parts.append((g * ell.t_mask[tb][..., None]).sum(dim=1))
    if not parts:
        return torch.zeros((ell.num_nodes, d), dtype=rows.dtype,
                           device=rows.device)
    dx_t = torch.cat(parts, dim=0)                        # t-row order
    return dx_t[ell.t_rank.long()].to(rows.dtype)


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
    """K6 per bucket into one [N, D] output; the backward is K6b (and, for
    GINE's edge table, K11)."""

    @staticmethod
    def forward(ctx, src, ea, ell, op):
        out = torch.empty((ell.num_nodes, src.shape[1]), dtype=src.dtype,
                          device=src.device)
        for b in range(len(ell.widths)):
            lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
            if hi == lo:
                continue
            degs = (ell.deg_p[lo:hi], ell.deg_p) if op == "gcn" else (None,
                                                                      None)
            _ell_aggregate_fwd(src, ell.nbr[b], ell.mask[b], op, *degs,
                               out=out[lo:hi], ea=ea,
                               eslot=None if ea is None else ell.edge_slots[b])
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
