"""The COO per-edge attention terms (port of the ``coo`` forms of
``gigl_tpu/models/convs.py``: GATv2's logits, :312-328; EdgeAttrGAT's
edge rows in the logits and the messages, :312-328; the Transformer's edge
rows in the keys and the values, :379-392), each one ``autograd.Function``
over the segment kernels of ``ops/segment.py`` and K11's COO form
(``ops/ell.py`` :func:`coo_edge_grad`).

- :func:`gatv2_scores`: ``z[e, h] = sum_d att[h, d] * leaky(hs[src e] +
  hd[dst e])[h, d]`` by K10's gatv2 mode; backward K8b's gatv2 mode for
  ``hs`` (the source walk) and K8's for ``hd`` and ``att`` (one walk of the
  destination index, the d att partials summed in a fixed order).
- :func:`coo_gat_edges` (EdgeAttrGAT): the logit ``leaky(pre + <he,
  att_src>)`` (``pre`` = ``a_src[src] + a_dst[dst]``, made by the caller,
  the per-edge dot a plain row op), K9, and the messages ``alpha * (hs[src]
  + he)`` by K8's add mode; backward K8b (weighted) for ``hs``, K10 with the
  addend for alpha's cotangent, K9b, and K11 gat for ``he``: ``alpha * g +
  dpre * att_src`` in one pass.
- :func:`coo_gatv2_edges` (GATv2 with edge rows): the logit ``att .
  leaky((hs[src] + he) + hd[dst])`` by K10's gatv2 mode with the edge row,
  K9, and the messages ``alpha * (hs[src] + he)`` by K8's add mode;
  backward K10 with the addend for alpha's cotangent, K9b, K11 gatv2 for
  ``he`` (``alpha * g + dlog * att * leaky'(z)``, each edge once), K8b's
  sum of that table along the source walk for ``hs`` (``hs[src]`` and
  ``he`` enter the layer identically, so their cotangents are one table),
  and K8's gatv2 destination walk with the edge rows for ``hd`` and
  ``att``.
- :func:`coo_transformer_edges`: K10 with the key addend ``<q[dst], k[src]
  + he> * scale``, K9, K8 add over ``v`` and ``he``; backward K8b for v,
  K10 with the addend, K9b, K10b's coefficients, K8 add for dq, K8b for dk,
  and K11 transformer for ``he``: ``alpha * g + coef * q[dst]``.

The edge table ``he`` is [E, H * D] by edge id, in the caller's edge
order: ``GNNEncoder.encode_coo`` passes the walk-ordered graph
(``ops/segment.py`` :func:`coo_walk`), where the destination walks read it
in sequence. On CPU tensors every kernel wrapper takes its plain twin.
LeakyReLU's derivative at 0 is 1, as JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from gigl_tpu_torch.ops.ell import coo_edge_grad
from gigl_tpu_torch.ops.segment import (
    SegmentIndex,
    _grad_on,
    _pair,
    _sddmm_fwd,
    _segment_reduce_fwd,
    _segment_softmax_fwd,
    edge_rows_by_source,
    gatv2_dst_bwd,
    gatv2_src_bwd,
    sddmm_bwd_coef,
    segment_reduce_bwd,
    segment_softmax_bwd,
)


def _leaky(z, slope):
    return torch.where(z >= 0, z, slope * z)


class GatV2Scores(torch.autograd.Function):
    """K10 gatv2; backward K8b gatv2 (hs) and K8 gatv2 (hd, att)."""

    @staticmethod
    def forward(ctx, hs, hd, att, src, dst, slope, index, src_index):
        out = _sddmm_fwd(src, dst, hd, hs, index=index, att=att,
                         negative_slope=slope)
        ctx.save_for_backward(hs, hd, att, src, dst)
        ctx.cfg = (slope, index, src_index)
        return out

    @staticmethod
    def backward(ctx, gl):
        hs, hd, att, src, dst = ctx.saved_tensors
        slope, index, src_index = ctx.cfg
        gl = gl.float().contiguous()
        dhs = dhd = datt = None
        if ctx.needs_input_grad[0]:
            dhs = gatv2_src_bwd(gl, src, dst, hs, hd, att,
                                negative_slope=slope,
                                src_index=src_index).reshape(hs.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dhd, datt = gatv2_dst_bwd(gl, src, dst, hs, hd, att,
                                      negative_slope=slope, index=index)
            dhd = dhd.reshape(hd.shape)
            datt = datt.reshape(att.shape).to(att.dtype)
        return dhs, dhd, datt, None, None, None, None, None


def gatv2_scores(src: torch.Tensor, dst: torch.Tensor, hs: torch.Tensor,
                 hd: torch.Tensor, att: torch.Tensor, *,
                 negative_slope: float = 0.2,
                 index: Optional[SegmentIndex] = None,
                 src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """GATv2's logits [E, H] over COO edges: hs, hd [N, H, D] (the source
    and destination projections), att [H, D]."""
    if hs.dim() != 3 or hd.shape[1:] != hs.shape[1:] \
            or att.shape != hs.shape[1:]:
        raise ValueError("gatv2_scores: hs, hd [N, H, D] and att [H, D]")
    if hs.device.type != "cpu":
        index, src_index = _pair(src, dst, hs.shape[0], hd.shape[0], index,
                                 src_index)
    if not _grad_on(hs, hd, att):
        return _sddmm_fwd(src, dst, hd, hs, index=index, att=att,
                          negative_slope=negative_slope)
    return GatV2Scores.apply(hs, hd, att, src, dst, negative_slope, index,
                             src_index)


class CooGatEdges(torch.autograd.Function):
    """EdgeAttrGAT's logits and messages (see the module docstring)."""

    @staticmethod
    def forward(ctx, hs, he, pre, att_src, src, dst, num_dst, slope, index,
                src_index):
        e, (n, h, dh) = src.shape[0], hs.shape
        he3 = he.reshape(e, h, dh)
        z = pre + (he3 * att_src.to(he.dtype)).sum(-1)
        alpha = _segment_softmax_fwd(_leaky(z, slope), dst, num_dst, index)
        out = _segment_reduce_fwd(hs, dst, num_dst, "sum", src, alpha, index,
                                  he3, "add")
        ctx.save_for_backward(hs, he, z, alpha, att_src, src, dst)
        ctx.cfg = (num_dst, slope, index, src_index)
        return out.reshape(num_dst, h * dh)

    @staticmethod
    def backward(ctx, g):
        hs, he, z, alpha, att_src, src, dst = ctx.saved_tensors
        num_dst, slope, index, src_index = ctx.cfg
        e, (n, h, dh) = src.shape[0], hs.shape
        g = g.contiguous()
        dhs = segment_reduce_bwd(g, dst, n, src=src, weight=alpha,
                                 index=index, src_index=src_index)
        dalpha = _sddmm_fwd(src, dst, g.reshape(num_dst, h, dh), hs,
                            index=index, edge=he.reshape(e, h, dh))
        dlog = segment_softmax_bwd(alpha, dalpha, dst, num_dst, index=index)
        dz = torch.where(z >= 0, dlog, slope * dlog)
        dhe = coo_edge_grad(g, src, dst, index, "gat", alpha=alpha.float(),
                            coef=dz.float(), vec=att_src.float().reshape(-1),
                            heads=h)
        datt = torch.einsum("eh,ehd->hd", dz.float(),
                            he.float().reshape(e, h, dh))
        return (dhs.reshape(hs.shape), dhe, dz.to(z.dtype),
                datt.to(att_src.dtype), None, None, None, None, None, None)


def coo_gat_edges(src: torch.Tensor, dst: torch.Tensor, num_dst: int,
                  hs: torch.Tensor, he: torch.Tensor, pre: torch.Tensor,
                  att_src: torch.Tensor, *, negative_slope: float = 0.2,
                  index: Optional[SegmentIndex] = None,
                  src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """EdgeAttrGAT over COO edges -> [num_dst, H * D]: ``alpha = softmax(
    leaky(pre + <he, att_src>))`` per destination and ``sum alpha * (hs[src]
    + he)``. hs [N, H, D], he [E, H * D] by edge id, pre [E, H] (``a_src[src]
    + a_dst[dst]``), att_src [H, D]."""
    e = src.shape[0]
    if hs.dim() != 3 or he.shape != (e, hs.shape[1] * hs.shape[2]) \
            or pre.shape != (e, hs.shape[1]) or att_src.shape != hs.shape[1:]:
        raise ValueError("coo_gat_edges: hs [N, H, D], he [E, H * D], pre "
                         "[E, H], att_src [H, D]")
    if hs.device.type != "cpu":
        index, src_index = _pair(src, dst, hs.shape[0], num_dst, index,
                                 src_index)
    return CooGatEdges.apply(hs, he, pre, att_src, src, dst, num_dst,
                             negative_slope, index, src_index)


class CooGatv2Edges(torch.autograd.Function):
    """GATv2's logits and messages with edge rows (module docstring)."""

    @staticmethod
    def forward(ctx, hs, hd, he, att, src, dst, slope, index, src_index):
        e, (n, h, dh) = src.shape[0], hs.shape
        he3 = he.reshape(e, h, dh)
        logits = _sddmm_fwd(src, dst, hd, hs, index=index, edge=he3, att=att,
                            negative_slope=slope)
        alpha = _segment_softmax_fwd(logits, dst, hd.shape[0], index)
        out = _segment_reduce_fwd(hs, dst, hd.shape[0], "sum", src, alpha,
                                  index, he3, "add")
        ctx.save_for_backward(hs, hd, he, att, alpha, src, dst)
        ctx.cfg = (slope, index, src_index)
        return out.reshape(hd.shape[0], h * dh)

    @staticmethod
    def backward(ctx, g):
        hs, hd, he, att, alpha, src, dst = ctx.saved_tensors
        slope, index, src_index = ctx.cfg
        e, (n, h, dh) = src.shape[0], hs.shape
        num_dst = hd.shape[0]
        he3 = he.reshape(e, h, dh)
        g = g.contiguous()
        dalpha = _sddmm_fwd(src, dst, g.reshape(num_dst, h, dh), hs,
                            index=index, edge=he3)
        dlog = segment_softmax_bwd(alpha, dalpha, dst, num_dst, index=index)
        dhe = coo_edge_grad(g, src, dst, index, "gatv2", x=hs.reshape(n, -1),
                            ea=he, alpha=alpha.float(), coef=dlog.float(),
                            vec=att.detach().float().reshape(-1),
                            xd=hd.reshape(num_dst, -1), heads=h,
                            negative_slope=slope)
        dhs = dhd = datt = None
        if ctx.needs_input_grad[0]:
            dhs = edge_rows_by_source(dhe, src, n, src_index=src_index
                                      ).reshape(hs.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[3]:
            dhd, datt = gatv2_dst_bwd(dlog, src, dst, hs, hd, att,
                                      negative_slope=slope, index=index,
                                      edge=he3)
            dhd = dhd.reshape(hd.shape)
            datt = datt.reshape(att.shape).to(att.dtype)
        return (dhs, dhd, dhe if ctx.needs_input_grad[2] else None, datt,
                None, None, None, None, None)


def coo_gatv2_edges(src: torch.Tensor, dst: torch.Tensor, hs: torch.Tensor,
                    hd: torch.Tensor, he: torch.Tensor, att: torch.Tensor, *,
                    negative_slope: float = 0.2,
                    index: Optional[SegmentIndex] = None,
                    src_index: Optional[SegmentIndex] = None
                    ) -> torch.Tensor:
    """GATv2 with edge rows over COO edges -> [N_dst, H * D]: ``alpha =
    softmax(att . leaky((hs[src] + he) + hd[dst]))`` per destination and
    ``sum alpha * (hs[src] + he)``. hs [N, H, D], hd [N_dst, H, D], he
    [E, H * D] by edge id, att [H, D]."""
    e = src.shape[0]
    if hs.dim() != 3 or hd.shape[1:] != hs.shape[1:] \
            or he.shape != (e, hs.shape[1] * hs.shape[2]) \
            or att.shape != hs.shape[1:]:
        raise ValueError("coo_gatv2_edges: hs, hd [N, H, D], he [E, H * D], "
                         "att [H, D]")
    if hs.device.type != "cpu":
        index, src_index = _pair(src, dst, hs.shape[0], hd.shape[0], index,
                                 src_index)
    return CooGatv2Edges.apply(hs, hd, he, att, src, dst, negative_slope,
                               index, src_index)


class CooTransformerEdges(torch.autograd.Function):
    """The Transformer's attention with edge rows (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, he, scale, src, dst, index, src_index):
        e, (n, h, dh) = src.shape[0], q.shape
        he3 = he.reshape(e, h, dh)
        logits = _sddmm_fwd(src, dst, q, k, scale, index, edge=he3)
        alpha = _segment_softmax_fwd(logits, dst, n, index)
        out = _segment_reduce_fwd(v, dst, n, "sum", src, alpha, index, he3,
                                  "add")
        ctx.save_for_backward(q, k, v, he, scale, alpha, src, dst)
        ctx.cfg = (index, src_index)
        return out.reshape(n, h * dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v, he, scale, alpha, src, dst = ctx.saved_tensors
        index, src_index = ctx.cfg
        e, (n, h, dh) = src.shape[0], q.shape
        he3 = he.reshape(e, h, dh)
        g = g.contiguous()
        dv = segment_reduce_bwd(g, dst, n, src=src, weight=alpha,
                                index=index, src_index=src_index)
        dalpha = _sddmm_fwd(src, dst, g.reshape(n, h, dh), v, index=index,
                            edge=he3)
        dlog = segment_softmax_bwd(alpha, dalpha, dst, n, index=index)
        coef, _ = sddmm_bwd_coef(dlog.reshape(e, h), scale)
        dq = _segment_reduce_fwd(k, dst, n, "sum", src, coef, index, he3,
                                 "add")
        dk = segment_reduce_bwd(q.reshape(n, h * dh), dst, n, src=src,
                                weight=coef, index=index,
                                src_index=src_index)
        dhe = coo_edge_grad(g, src, dst, index, "transformer",
                            alpha=alpha.float(), coef=coef,
                            xd=q.reshape(n, h * dh), heads=h)
        return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape),
                dhe, None, None, None, None, None)


def coo_transformer_edges(src: torch.Tensor, dst: torch.Tensor,
                          q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          he: torch.Tensor, scale: torch.Tensor, *,
                          index: Optional[SegmentIndex] = None,
                          src_index: Optional[SegmentIndex] = None
                          ) -> torch.Tensor:
    """The Transformer's attention over COO edges with edge rows -> [N,
    H * D]: ``alpha = softmax(<q[dst], k[src] + he> * scale)`` per
    destination and ``sum alpha * (v[src] + he)``. q, k, v [N, H, D], he
    [E, H * D] by edge id, scale fp32 [H] (a constant)."""
    e = src.shape[0]
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape \
            or he.shape != (e, q.shape[1] * q.shape[2]):
        raise ValueError("coo_transformer_edges: q, k, v [N, H, D], he "
                         "[E, H * D]")
    if q.device.type != "cpu":
        index, src_index = _pair(src, dst, q.shape[0], q.shape[0], index,
                                 src_index)
    return CooTransformerEdges.apply(q, k, v, he, scale, src, dst, index,
                                     src_index)
