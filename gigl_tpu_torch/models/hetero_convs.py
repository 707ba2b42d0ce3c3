"""Heterogeneous message-passing convolutions (port of
``gigl_tpu/models/hetero_convs.py``: ``HGTConv``, ``SimpleHGNConv`` and
``RGCNConv``).

Each conv has two forms:

- ``forward(x_dst, dst_node_type, children)``: the dense typed-block form
  of sampled encoding, with ``children = [(x_nbr [M, K_r, D], mask [M,
  K_r], edge_type, src_node_type), ...]``, one entry per child relation;
- ``coo(h, edges, num_nodes, segments=None)``: one layer over every node
  of every type through its exact full in-neighborhood, the
  ``{node_type: [N, D]}`` tables ``h`` and the COO edges ``edges[et] =
  (src, dst)``, on the segment kernels of ``ops/segment.py`` (B7) over the
  :class:`TypedSegments` of the graph (built once per graph, on the host);
  differentiable through their backward kernels (K8b, K9b, K10b), which
  walk the segments' source indexes.

Kernels by form. HGT's block runs K7 ``fanout_attention_block`` in its
Transformer mode; its ``coo`` form runs K10 ``sddmm`` (logits), K9
``segment_softmax`` and K8 ``segment_reduce`` (the weighted sum).
SimpleHGN's block runs K7 in its GAT mode over the relations' concatenated
slots, with the per-relation logit term as K7's per-slot bias (backward
K7b, whose per-slot bias cotangent is summed per relation by autograd);
its ``coo`` form computes the logits by row gathers of per-node terms,
then K9 and K8. RGCN's block runs K4 ``masked_mean`` per relation,
its ``coo`` form K8 in mean mode per relation (``coo_spmm``).

Where the reference applies the relation maps ``W_att`` / ``W_msg``
(SimpleHGN: ``w``) to each gathered edge row (``:150-155, 271``), the
``coo`` forms apply them once per source node and gather the results: the
values are the same row by row, only the GEMMs' rounding differs. The
parameter names follow flax's (``k_{type}``, ``watt_{edge type}``, ...,
through ``_safe``), so ``convert.params_from_flax`` maps them one to one;
dense layers compute in ``dtype`` from fp32 parameters, as the homogeneous
convs do. GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.device import DeviceLike
from gigl_tpu_torch.models.convs import linear
from gigl_tpu_torch.models.layers import leaky_relu
from gigl_tpu_torch.ops.attention import fanout_attention_block
from gigl_tpu_torch.ops.fanout import masked_mean
from gigl_tpu_torch.ops.segment import (
    SegmentIndex,
    coo_spmm,
    gather_edges,
    sddmm,
    segment_softmax,
)
from gigl_tpu_torch.types.graph import EdgeType


def _safe(name: str) -> str:
    """A type name as a parameter key (``gigl_tpu/models/hetero_convs.py``
    ``_safe``)."""
    return name.replace("/", "_").replace(".", "_").replace(":", "_")


def _src_dst(et: str) -> Tuple[str, str]:
    t = EdgeType.from_str(et)
    return str(t.src_node_type), str(t.dst_node_type)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


@dataclass
class TypedSegments:
    """The SegmentIndexes of a typed COO graph. ``by="dst"`` (HGT,
    SimpleHGN): per destination type, its incoming edge types in the order
    of ``edges`` (the reference's ``by_dst``), their edges concatenated in
    that order (``dst_ids``), the source ids offset into the table stacked
    from the relations' per-node source tables (``src_stack``), the index
    of ``dst_ids`` and, for the backward's walks, the index of
    ``src_stack`` (``src_index``) and each relation's own pair of
    destination and source indexes (``rel``: HGT's per-relation logits and
    SimpleHGN's per-relation gathers). ``by="relation"`` (RGCN): one
    destination and one source index per edge type. Built without the
    backward's source indexes (``backward=False``: ``src_index`` empty,
    ``rel`` holding each relation's destination index alone, which K10
    walks) for inference, which never walks them; a gradient through such
    segments builds them on the host at each call."""

    by: str
    by_dst: Dict[str, List[str]]
    dst_ids: Dict[str, torch.Tensor]
    src_stack: Dict[str, torch.Tensor]
    index: Dict[str, SegmentIndex]   # dst type (by="dst") or edge type
    src_index: Dict[str, SegmentIndex]   # same keys: the source-sorted twin
    rel: Dict[str, Tuple[SegmentIndex, SegmentIndex]]   # by="dst" only

    def rel_pair(self, et: str):
        """The relation's (destination, source) indexes, or Nones."""
        return self.rel.get(et, (None, None))

    @classmethod
    def build(cls, edges: Mapping[str, Tuple], num_nodes: Mapping[str, int],
              by: str = "dst", device: DeviceLike = None,
              backward: bool = True) -> "TypedSegments":
        """From ``edges[et] = (src, dst)`` (tensors or numpy arrays); the
        sorts run on the host with numpy, the tables go to ``device`` (the
        edges' own device when they are tensors)."""
        if by not in ("dst", "relation"):
            raise ValueError(f"TypedSegments: by={by!r}")

        def host(a):
            return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))

        if device is None:
            first = next(iter(edges.values()), (None,))[0]
            if isinstance(first, torch.Tensor):
                device = first.device
        by_dst: Dict[str, List[str]] = {}
        for et in edges:
            by_dst.setdefault(_src_dst(et)[1], []).append(et)

        def pair(et):
            """The relation's destination and (backward) source indexes."""
            s_nt, d_nt = _src_dst(et)
            src, dst = (host(a) for a in edges[et])
            return (SegmentIndex.from_ids(dst, num_nodes[d_nt], device,
                                          gather=edges[et][0]),
                    SegmentIndex.from_ids(src, num_nodes[s_nt], device,
                                          gather=edges[et][1])
                    if backward else None)

        # each destination index is built with its edges' source ids and
        # each source index with their destination ids (the callers' own
        # tensors, or src_stack and dst_ids), so that K8 and K8b read them
        # composed in walk order
        if by == "relation":
            index = {et: SegmentIndex.from_ids(
                host(edges[et][1]), num_nodes[_src_dst(et)[1]], device,
                gather=edges[et][0]) for et in edges}
            src_index = ({et: SegmentIndex.from_ids(
                host(edges[et][0]), num_nodes[_src_dst(et)[0]], device,
                gather=edges[et][1]) for et in edges} if backward else {})
            return cls(by, by_dst, {}, {}, index, src_index, {})
        dst_ids, src_stack, index, src_index = {}, {}, {}, {}
        for nt, ets in by_dst.items():
            srcs, dsts, offset = [], [], 0
            for et in ets:
                src, dst = (host(a).astype(np.int64) for a in edges[et])
                srcs.append(src + offset)
                dsts.append(dst)
                offset += num_nodes[_src_dst(et)[0]]
            d, s_ = np.concatenate(dsts), np.concatenate(srcs)
            index[nt] = SegmentIndex.from_ids(d, num_nodes[nt], device,
                                              gather=s_.astype(np.int32))
            src_stack[nt] = index[nt].gather
            dst_ids[nt] = torch.from_numpy(d.astype(np.int32)).to(
                index[nt].device)
            if backward:   # stacked as src_stack is
                src_index[nt] = SegmentIndex.from_ids(s_, offset, device,
                                                      gather=dst_ids[nt])
                dst_ids[nt] = src_index[nt].gather
        return cls(by, by_dst, dst_ids, src_stack, index, src_index,
                   {et: pair(et) for et in edges})


def _segments(segments, edges, num_nodes, by):
    if segments is None:
        return TypedSegments.build(edges, num_nodes, by)
    if segments.by != by:
        raise ValueError(f"this conv needs TypedSegments by={by!r}")
    return segments


class _TypedConv(nn.Module):
    """Per-type dense layers registered under flax's names."""

    def _add_linears(self, prefix: str, names: Sequence[str], in_dim: int,
                     out_dim: int, bias: bool = True) -> None:
        for name in names:
            self.add_module(f"{prefix}_{_safe(name)}",
                            nn.Linear(in_dim, out_dim, bias=bias))

    def _add_params(self, prefix: str, names: Sequence[str], shape,
                    fill: float = 0.0) -> None:
        for name in names:
            self.register_parameter(f"{prefix}_{_safe(name)}", nn.Parameter(
                torch.full(shape, fill, dtype=torch.float32)))

    def _get(self, prefix: str, name: str):
        return getattr(self, f"{prefix}_{_safe(name)}")

    def _lin(self, prefix: str, name: str, x: torch.Tensor) -> torch.Tensor:
        return linear(self._get(prefix, name), x, self.dtype)


class HGTConv(_TypedConv):
    """Heterogeneous Graph Transformer conv: per-node-type K/Q/V/output
    projections, per-edge-type attention and message maps ``W_att``,
    ``W_msg`` [H, dk, dk] and prior [H], one softmax over all relations'
    neighbors, a gated residual (skip) per node type."""

    segments_by = "dst"

    def __init__(self, in_dim: int, out_dim: int, node_types: Sequence[str],
                 edge_types: Sequence[str], heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_dim % heads:
            raise ValueError(f"out_dim {out_dim} % heads {heads}")
        self.out_dim, self.heads, self.dtype = out_dim, heads, dtype
        dk = out_dim // heads
        for prefix in ("k", "q", "v"):
            self._add_linears(prefix, node_types, in_dim, out_dim)
        self._add_linears("a", node_types, out_dim, out_dim)
        self._add_params("skip", node_types, (1,), 1.0)
        self._add_params("watt", edge_types, (heads, dk, dk))
        self._add_params("wmsg", edge_types, (heads, dk, dk))
        self._add_params("prior", edge_types, (heads,), 1.0)

    def _rel(self, prefix, et, x):
        """x [..., H, dk] times the relation's [H, dk, dk] map, per head."""
        return torch.einsum("...hd,hde->...he", x,
                            self._get(prefix, et).to(self.dtype))

    def _finish(self, nt, agg, x):
        out = self._lin("a", nt, _gelu(agg))
        if x.shape[-1] == self.out_dim:   # gated residual when dims align
            alpha = torch.sigmoid(self._get("skip", nt)).to(self.dtype)
            out = alpha * out + (1.0 - alpha) * x
        return out

    def forward(self, x_dst, dst_node_type: str, children, train=False):
        """Dense typed-block form on K7 (Transformer mode). The reference's
        logit ``(kr · q) * prior / sqrt(dk)`` (``:95-97``) is reassociated
        as ``q · (kr * prior) / sqrt(dk)``: each child's relation keys are
        scaled by their prior per head before the blocks are concatenated,
        which turns it into K7's ``q · k / sqrt(dk)`` over the
        ``[M * K_tot, H * dk]`` tables (fp32: within 1e-6 of the output's
        scale of the reference, tests/test_torch_hetero.py)."""
        if not children:
            return x_dst[..., : self.out_dim]
        m = x_dst.shape[0]
        h, d = self.heads, self.out_dim
        q = self._lin("q", dst_node_type, x_dst)
        keys, msgs, masks = [], [], []
        for x_nbr, mask, et, src_nt in children:
            k = self._lin("k", src_nt, x_nbr).reshape(m, -1, h, d // h)
            v = self._lin("v", src_nt, x_nbr).reshape(m, -1, h, d // h)
            prior = self._get("prior", et).to(self.dtype)[:, None]
            keys.append(self._rel("watt", et, k) * prior)
            msgs.append(self._rel("wmsg", et, v))
            masks.append(mask)
        keys = torch.cat(keys, 1).reshape(-1, d)        # [M * K_tot, H*dk]
        msgs = torch.cat(msgs, 1).reshape(-1, d)
        agg = fanout_attention_block(q, keys, msgs, torch.cat(masks, 1),
                                     "transformer", h)
        return self._finish(dst_node_type, agg, x_dst)

    def coo(self, h: Dict[str, torch.Tensor],
            edges: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
            num_nodes: Mapping[str, int],
            segments: Optional[TypedSegments] = None
            ) -> Dict[str, torch.Tensor]:
        """Full-graph form: per destination type, each incoming relation's
        ``kr = k_src @ W_att`` and ``mr = v_src @ W_msg`` once per source
        node; K10 logits ``q[dst] · kr[src] * prior / sqrt(dk)``; K9 over
        all the type's in-edges; K8 sums the gathered ``mr`` rows weighted
        per head (no [E, H, dk] block). Differentiable: the prior trains
        as K10's scale (its gradient from K10b), the rest through K8b, K9b
        and K8, walking the segments' source and per-relation indexes."""
        seg = _segments(segments, edges, num_nodes, "dst")
        hh, d = self.heads, self.out_dim
        dk = d // hh
        q, k, v = ({nt: self._lin(p, nt, x).reshape(-1, hh, dk)
                    for nt, x in h.items()} for p in ("q", "k", "v"))
        out = {}
        for nt, x in h.items():
            incoming = seg.by_dst.get(nt, [])
            if not incoming:
                out[nt] = x[..., :d]      # childless contract (dense form)
                continue
            logits, msgs = [], []
            for et in incoming:
                src, dst = edges[et]
                s_nt = _src_dst(et)[0]
                scale = self._get("prior", et).float() / math.sqrt(dk)
                r_index, r_src_index = seg.rel_pair(et)
                logits.append(sddmm(src, dst, q[nt],
                                    self._rel("watt", et, k[s_nt]),
                                    scale=scale, index=r_index,
                                    src_index=r_src_index))
                msgs.append(self._rel("wmsg", et, v[s_nt]))
            att = segment_softmax(torch.cat(logits), seg.dst_ids[nt],
                                  num_nodes[nt], index=seg.index[nt])
            agg = coo_spmm(seg.src_stack[nt], seg.dst_ids[nt],
                           torch.cat(msgs), num_nodes[nt], edge_weight=att,
                           index=seg.index[nt],
                           src_index=seg.src_index.get(nt)).reshape(-1, d)
            out[nt] = self._finish(nt, agg, x)
        return out


class SimpleHGNConv(_TypedConv):
    """SimpleHGN conv: GAT-style attention whose logits carry a learnable
    edge-type embedding term, plus a residual ``w_res``."""

    segments_by = "dst"

    def __init__(self, in_dim: int, out_dim: int, node_types: Sequence[str],
                 edge_types: Sequence[str], heads: int = 4,
                 edge_type_emb_dim: int = 16, negative_slope: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_dim % heads:
            raise ValueError(f"out_dim {out_dim} % heads {heads}")
        self.out_dim, self.heads, self.dtype = out_dim, heads, dtype
        self.negative_slope = negative_slope
        self.edge_types = tuple(edge_types)
        dk = out_dim // heads
        self.w = nn.Linear(in_dim, out_dim, bias=False)
        self.w_res = nn.Linear(in_dim, out_dim, bias=False)
        self.edge_emb = nn.Parameter(torch.zeros(len(edge_types),
                                                 edge_type_emb_dim))
        self.w_rel = nn.Parameter(torch.zeros(edge_type_emb_dim, out_dim))
        for name in ("att_src", "att_dst", "att_rel"):
            self.register_parameter(name, nn.Parameter(
                torch.zeros(1, 1, heads, dk)))

    def _att(self, name):
        return getattr(self, name).to(self.dtype).reshape(self.heads, -1)

    def _rel_term(self, et) -> torch.Tensor:
        """[H]: the edge type's embedding through ``w_rel``, dotted with
        ``att_rel`` per head."""
        i = self.edge_types.index(et)
        rel = (self.edge_emb[i] @ self.w_rel).reshape(self.heads, -1)
        return (rel.to(self.dtype) * self._att("att_rel")).sum(-1)

    def forward(self, x_dst, dst_node_type: str, children, train=False):
        """Dense typed-block form (``hetero_convs.py:210-239``) on K7's GAT
        mode: the relations' slots concatenated into one block (``w x`` is
        both key and value), the logit ``leaky_relu(a_src + a_dst +
        a_rel[r])`` with ``a_rel[r]`` as K7's bias over relation r's slot
        columns, the softmax over all slots. A row with no valid slot gets
        0 (the reference's ``finfo.min`` masking gives the same)."""
        if not children:
            return linear(self.w_res, x_dst, self.dtype)
        m = x_dst.shape[0]
        wd = linear(self.w, x_dst, self.dtype)                  # [M, H*dk]
        vals, masks, bias = [], [], []
        for x_nbr, mask, et, _src_nt in children:
            vals.append(linear(self.w, x_nbr, self.dtype))      # [M, K_r, d]
            masks.append(mask)
            bias.append(self._rel_term(et).float().expand(mask.shape[1], -1))
        val = torch.cat(vals, 1)
        agg = fanout_attention_block(
            wd, val.reshape(-1, val.shape[-1]), None, torch.cat(masks, 1),
            "gat", self.heads, self.att_src.to(self.dtype),
            self.att_dst.to(self.dtype), negative_slope=self.negative_slope,
            bias=torch.cat(bias))
        return agg.reshape(m, self.out_dim) \
            + linear(self.w_res, x_dst, self.dtype)

    def coo(self, h: Dict[str, torch.Tensor],
            edges: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
            num_nodes: Mapping[str, int],
            segments: Optional[TypedSegments] = None
            ) -> Dict[str, torch.Tensor]:
        """Full-graph form: per-node terms ``w x`` (also the messages),
        ``a_src`` and ``a_dst``; per-edge logits by row gathers (whose
        backward is K8 over the relation's indexes), K9 over all the
        destination type's in-edges, K8 sums the gathered ``w x`` rows
        weighted per head."""
        seg = _segments(segments, edges, num_nodes, "dst")
        hh = self.heads
        w = {nt: linear(self.w, x, self.dtype).reshape(x.shape[0], hh, -1)
             for nt, x in h.items()}
        a_src = {nt: (t * self._att("att_src")).sum(-1) for nt, t in w.items()}
        a_dst = {nt: (t * self._att("att_dst")).sum(-1) for nt, t in w.items()}
        out = {}
        for nt, x in h.items():
            incoming = seg.by_dst.get(nt, [])
            if not incoming:
                out[nt] = linear(self.w_res, x, self.dtype)  # childless
                continue
            logits, vals = [], []
            for et in incoming:
                src, dst = edges[et]
                s_nt = _src_dst(et)[0]
                r_index, r_src_index = seg.rel_pair(et)
                a = gather_edges(a_src[s_nt], src, index=r_src_index) \
                    + gather_edges(a_dst[nt], dst, index=r_index) \
                    + self._rel_term(et)
                logits.append(leaky_relu(a, self.negative_slope))
                vals.append(w[s_nt])
            att = segment_softmax(torch.cat(logits), seg.dst_ids[nt],
                                  num_nodes[nt], index=seg.index[nt])
            agg = coo_spmm(seg.src_stack[nt], seg.dst_ids[nt],
                           torch.cat(vals), num_nodes[nt], edge_weight=att,
                           index=seg.index[nt],
                           src_index=seg.src_index.get(nt))
            out[nt] = agg.reshape(-1, self.out_dim) \
                + linear(self.w_res, x, self.dtype)
        return out


class RGCNConv(_TypedConv):
    """Relational GCN conv: ``h_v = W_self x_v + sum_r W_r mean_{u in
    N_r(v)} x_u``, optionally with ``W_r = sum_b a_rb B_b`` (``num_bases``
    > 0)."""

    segments_by = "relation"

    def __init__(self, in_dim: int, out_dim: int, node_types: Sequence[str],
                 edge_types: Sequence[str], num_bases: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim, self.num_bases, self.dtype = out_dim, num_bases, dtype
        self.edge_types = tuple(edge_types)
        self.w_self = nn.Linear(in_dim, out_dim)
        if num_bases > 0:
            self.basis_coeff = nn.Parameter(torch.zeros(len(edge_types),
                                                        num_bases))
            self._add_linears("basis", [str(b) for b in range(num_bases)],
                              in_dim, out_dim, bias=False)
        else:
            self._add_linears("w", edge_types, in_dim, out_dim, bias=False)

    def _rel_transform(self, et: str, x: torch.Tensor) -> torch.Tensor:
        if self.num_bases > 0:
            coeff = self.basis_coeff[self.edge_types.index(et)].to(self.dtype)
            stacked = torch.stack([self._lin("basis", str(b), x)
                                   for b in range(self.num_bases)])
            return torch.tensordot(coeff, stacked, dims=([0], [0]))
        return self._lin("w", et, x)

    def forward(self, x_dst, dst_node_type: str, children, train=False):
        """Dense typed-block form: a K4 masked mean per child relation."""
        out = linear(self.w_self, x_dst, self.dtype)
        for x_nbr, mask, et, _src_nt in children:
            out = out + self._rel_transform(et, masked_mean(
                x_nbr.to(self.dtype).contiguous(), mask))
        return out

    def coo(self, h: Dict[str, torch.Tensor],
            edges: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
            num_nodes: Mapping[str, int],
            segments: Optional[TypedSegments] = None
            ) -> Dict[str, torch.Tensor]:
        """Full-graph form: per relation, K8's mean of the source rows over
        each destination's real in-edges (``coo_spmm``, mean)."""
        seg = _segments(segments, edges, num_nodes, "relation")
        out = {nt: linear(self.w_self, x, self.dtype) for nt, x in h.items()}
        for et, (src, dst) in edges.items():
            s_nt, d_nt = _src_dst(et)
            mean_x = coo_spmm(src, dst, h[s_nt], num_nodes[d_nt],
                              reduce="mean", index=seg.index[et],
                              src_index=seg.src_index.get(et))
            out[d_nt] = out[d_nt] + self._rel_transform(et, mean_x)
        return out
