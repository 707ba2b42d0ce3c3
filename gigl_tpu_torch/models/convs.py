"""Message-passing convolution layers (port of ``gigl_tpu/models/convs.py``).

Ported: ``SAGEConv``, ``GCNConv``, ``GINConv``, ``GINEConv``, ``GATConv``
(v1 and ``v2=True``, with ``use_edge_attr``: EdgeAttrGAT) and
``TransformerConv`` (with ``use_edge_attr``). Each has

- ``block(x_dst, nbr, mask, edge_attr=None, degrees=None)``: the dense
  fanout-block path (``nbr [N, K, Din]``, ``edge_attr [N, K, De]``) of
  sampled encoding;
- ``ell(x_p, ell, edge_attr=None)``: the whole permuted graph of an
  ``EllGraph`` at once (``ops/ell.py`` ``ell_layer``; ``edge_attr [E, De]``
  in COO edge order), where the neighbor and edge rows are read through
  the bucket index tables inside kernel K6 (SAGE, GCN, GIN, GINE;
  ``ell_aggregate_graph``) or K7 (GAT, GATv2, Transformer, the projected
  edge rows as K7's addend; ``fanout_attention_ell``) instead of being
  gathered into ``[n, W, D]`` blocks first; the linear layers run once
  over all N rows (and E edge rows);
- ``coo(x, src, dst, num_nodes, edge_attr=None, *, index, src_index)``:
  the whole graph as COO edges over the segment ops (``ops/segment.py``,
  B7), walking the destination ``index`` and, in the backward, the
  source-sorted ``src_index`` (both ``SegmentIndex``es, built once per
  graph): SAGE, GCN and GIN on K8 (backward K8b); GAT v1 on per-node
  attention terms gathered per edge, K9 and a per-head weighted K8 over the
  source table (backward K8 for the gathers, K9b, K8b and K10 for the
  weights); GATv2 on K10's gatv2 mode, K9 and the weighted K8 (backward
  K8b's and K8's gatv2 modes); Transformer on K10, K9 and K8 (backward adds
  K10b). With edge rows ``edge_attr [E, De]`` beside the edges (by edge
  id): GINE on K8's gine mode (backward K8b's gine gate, K11's COO form);
  EdgeAttrGAT and the Transformer on ``ops/coo_edges.py`` (K8's add mode,
  K10's key addend; backward K11's COO form for the edge rows); GATv2 with
  edge rows on K10's gatv2 mode with the edge row, K9 and K8's add mode
  (``coo_gatv2_edges``; backward K11's gatv2 mode, K8b's sum of its table
  by source, K8's gatv2 walk with the edge rows).

The convs without edge features (SAGE, GCN, GIN, GAT without
``use_edge_attr``) ignore ``edge_attr`` in their block and ELL forms, as
the reference's blocks do.

SAGE, GCN, GIN and GINE keep the reference's dense block (K4, trainable
through K4b; GINE takes ``relu(nbr + edge_attr)`` elementwise first); the
attention convs' dense block projects the flattened ``[N*K, Din]`` block
once (and the edge block with ``lin_edge``, added elementwise as the
reference adds it) and runs K7 over it (``fanout_attention_block``,
trainable through K7b). The ELL forms train through K6b (SAGE, GCN, GIN,
GINE) and K7b + K6b (GAT, GATv2, Transformer), the edge tables through K11
(GINE, EdgeAttrGAT, Transformer, GATv2); the ``coo`` forms as listed above.
``block_cached`` (SAGE, GCN, GIN) serves the cached-hop path. Parameters
are fp32; the layer computes in ``dtype`` the way flax's ``Dense(dtype=
bf16, param_dtype=fp32)`` does: input, weight and bias are cast to the
compute type at the call (no autocast).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.ops.attention import (
    fanout_attention_block,
    fanout_attention_ell,
)
from gigl_tpu_torch.models.layers import leaky_relu, linear
from gigl_tpu_torch.ops.coo_edges import (
    coo_gat_edges,
    coo_gatv2_edges,
    coo_transformer_edges,
    gatv2_scores,
)
from gigl_tpu_torch.ops.ell_aggregate import ell_aggregate_graph
from gigl_tpu_torch.ops.fanout import masked_max, masked_mean, masked_sum
from gigl_tpu_torch.ops.segment import (
    SegmentIndex,
    coo_spmm,
    gather_edges,
    sddmm,
    segment_softmax,
)

class SAGEConv(nn.Module):
    """GraphSAGE conv: W_self x + b + W_nbr agg(neighbors)."""

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "mean",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if aggr not in ("mean", "sum", "max"):
            raise ValueError(f"Unknown SAGE aggr {aggr!r}")
        self.aggr = aggr
        self.dtype = dtype
        self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
        self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

    def _combine(self, x_dst, agg):
        return (linear(self.lin_self, x_dst, self.dtype)
                + linear(self.lin_nbr, agg, self.dtype))

    @property
    def cached_agg_kind(self) -> str:
        if self.aggr not in ("mean", "sum"):
            raise ValueError(f"SAGE aggr {self.aggr!r} is not cacheable")
        return self.aggr

    def block_cached(self, x_dst, agg, degrees_dst=None):
        """Cached-hop path: ``agg`` [N, Din] is the precomputed
        sampled-neighbor aggregate (ops/hopcache.py)."""
        return self._combine(x_dst, agg.to(x_dst.dtype))

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        """x_dst [N, Din], nbr [N, K, Din], mask [N, K] -> [N, Dout]."""
        if self.aggr == "mean":
            agg = masked_mean(nbr, mask)
        elif self.aggr == "max":
            agg = masked_max(nbr, mask)
        else:
            agg = masked_sum(nbr, mask)
        return self._combine(x_dst, agg)

    def ell(self, x_p, ell, edge_attr=None):
        """ELL form over the whole permuted graph (K6, backward K6b)."""
        return self._combine(x_p, ell_aggregate_graph(x_p, ell, self.aggr))

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form (K8, backward K8b); edge features are ignored, as the
        reference's are."""
        return self._combine(x, coo_spmm(src, dst, x, num_nodes,
                                         reduce=self.aggr, index=index,
                                         src_index=src_index))

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)


def _indexes(src, dst, num_nodes, index, src_index):
    """The destination and source SegmentIndexes of a COO graph, built on
    the host where not given (a training path passes both, built once),
    each composing the other side's ids."""
    if index is None:
        index = SegmentIndex.from_ids(dst, num_nodes, gather=src)
    if src_index is None:
        src_index = SegmentIndex.from_ids(src, num_nodes, gather=dst)
    return index, src_index


def _flat_block(nbr):
    """[N, K, Din] -> [N*K, Din]: slot j of row i at row i*K + j."""
    return nbr.reshape(-1, nbr.shape[-1])


class GCNConv(nn.Module):
    """GCN conv, D^-1/2 (A+I) D^-1/2 X W: with ``degrees`` the exact
    symmetric normalization 1/sqrt((deg_dst+1)(deg_src+1)), otherwise the
    local valid-slot count (the sampled-GCN approximation)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lin = nn.Linear(in_dim, out_dim, bias=use_bias)

    @property
    def cached_agg_kind(self) -> str:
        return "gcn"

    def block_cached(self, x_dst, agg, degrees_dst=None):
        """``agg`` = sum_j x_j * rsqrt(deg_j + 1) (hopcache agg="gcn");
        needs the true dst degrees."""
        if degrees_dst is None:
            raise ValueError("GCN cached path requires dst degrees")
        d = degrees_dst.to(x_dst.dtype) + 1.0
        agg = agg.to(x_dst.dtype) * torch.rsqrt(d)[:, None]
        return linear(self.lin, agg + x_dst / d[:, None], self.dtype)

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        """``degrees``: optional (dst_deg [N], nbr_deg [N, K])."""
        if degrees is not None:
            dst_deg, nbr_deg = degrees
            dst_deg = dst_deg.to(x_dst.dtype) + 1.0
            nbr_deg = nbr_deg.to(x_dst.dtype) + 1.0
            w = torch.rsqrt(dst_deg)[:, None] * torch.rsqrt(nbr_deg)
            agg = masked_sum(nbr * w[..., None], mask)
            return linear(self.lin, agg + x_dst / dst_deg[:, None],
                          self.dtype)
        deg = mask.sum(dim=1, keepdim=True).to(x_dst.dtype)
        norm = 1.0 / (deg + 1.0)
        agg = masked_sum(nbr, mask) * norm
        return linear(self.lin, agg + x_dst * norm, self.dtype)

    def ell(self, x_p, ell, edge_attr=None):
        """ELL form: the in-degree ``ell.deg_p`` for both ends, as
        ``encode_ell`` uses it (``gigl_tpu/ops/ell.py:218, 342-344``); K6
        computes the weights from it (backward K6b)."""
        agg = ell_aggregate_graph(x_p, ell, "gcn")
        d = ell.deg_p.to(x_p.dtype) + 1.0
        return linear(self.lin, agg + x_p / d[:, None], self.dtype)

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form, as the reference's ``coo`` (``convs.py:133-140``): the
        destination's in-degree and the *source's out-degree*, each plus 1
        for the self loop and counted in x's type, from the two indexes'
        pointers (ROADMAP C2: ``encode_ell`` uses the in-degree at both
        ends); K8 sums the weighted rows (backward K8b)."""
        index, src_index = _indexes(src, dst, num_nodes, index, src_index)
        deg = (index.ptr[1:] - index.ptr[:-1]).to(x.dtype) + 1.0
        deg_src = (src_index.ptr[1:] - src_index.ptr[:-1]).to(x.dtype) + 1.0
        w = torch.rsqrt(deg[dst.long()]) * torch.rsqrt(deg_src[src.long()])
        agg = coo_spmm(src, dst, x, num_nodes, edge_weight=w, index=index,
                       src_index=src_index)
        return linear(self.lin, agg + x / deg[:, None], self.dtype)

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)


class _GINBase(nn.Module):
    """GIN's and GINE's MLP and learnable eps."""

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dim: Optional[int] = None, train_eps: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        h = hidden_dim or out_dim
        # Indices 0 and 2 match flax's nn.Sequential names layers_0/_2.
        self.mlp = nn.Sequential(nn.Linear(in_dim, h), nn.ReLU(),
                                 nn.Linear(h, out_dim))
        if train_eps:
            self.eps = nn.Parameter(torch.zeros(()))
        else:
            self.eps = 0.0

    def _mlp(self, x):
        h = F.relu(linear(self.mlp[0], x, self.dtype))
        return linear(self.mlp[2], h, self.dtype)

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)


class GINConv(_GINBase):
    """GIN conv: MLP((1 + eps) x + sum(neighbors)), learnable eps."""

    @property
    def cached_agg_kind(self) -> str:
        return "sum"

    def block_cached(self, x_dst, agg, degrees_dst=None):
        return self._mlp((1.0 + self.eps) * x_dst + agg.to(x_dst.dtype))

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self._mlp((1.0 + self.eps) * x_dst + masked_sum(nbr, mask))

    def ell(self, x_p, ell, edge_attr=None):
        return self._mlp((1.0 + self.eps) * x_p
                         + ell_aggregate_graph(x_p, ell, "sum"))

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form (K8, backward K8b)."""
        return self._mlp((1.0 + self.eps) * x + coo_spmm(
            src, dst, x, num_nodes, index=index, src_index=src_index))


class GINEConv(_GINBase):
    """GIN-E conv: MLP((1 + eps) x + sum_j relu(x_j + e_ij)), learnable eps.
    The edge rows are added to the neighbor rows, so they must be as wide
    (the encoder projects them to ``hid_dim``; the reference's test notes
    the same constraint, ``tests/test_ell.py:85-103``)."""

    def _edges(self, edge_attr, width):
        if edge_attr is None:
            return None
        if edge_attr.shape[-1] != width:
            raise ValueError(
                f"GINE adds the edge rows ({edge_attr.shape[-1]} wide) to "
                f"the node rows ({width} wide): incompatible shapes")
        return edge_attr

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        """relu(nbr + edge_attr) elementwise, then K4's masked sum."""
        ea = self._edges(edge_attr, nbr.shape[-1])
        nbr = torch.relu(nbr if ea is None else nbr + ea.to(nbr.dtype))
        return self._mlp((1.0 + self.eps) * x_dst + masked_sum(nbr, mask))

    def ell(self, x_p, ell, edge_attr=None):
        """K6 in gine mode reads each entry's edge row through the bucket's
        edge slots (backward: K6b gine for x_p, K11 for the edge table)."""
        ea = self._edges(edge_attr, x_p.shape[-1])
        return self._mlp((1.0 + self.eps) * x_p + ell_aggregate_graph(
            x_p, ell, "gine", ea=None if ea is None else ea.to(x_p.dtype)))

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form (``convs.py:222-228``): ``relu(x[src] + edge_attr)``
        summed per destination by K8's gine mode, the edge rows [E, D] by
        edge id (backward: K8b's gine gate for x, K11's COO form for the
        edge rows); without edge features ``relu(x)[src]`` (K8, backward
        K8b)."""
        ea = self._edges(edge_attr, x.shape[-1])
        if ea is None:
            agg = coo_spmm(src, dst, torch.relu(x), num_nodes, index=index,
                           src_index=src_index)
        else:
            agg = coo_spmm(src, dst, x, num_nodes, index=index,
                           src_index=src_index, edge_rows=ea.to(x.dtype),
                           edge_mode="gine")
        return self._mlp((1.0 + self.eps) * x + agg)


def _edge_linear(conv, edge_attr):
    """``lin_edge(edge_attr)`` in the conv's type, or None when the conv
    reads no edge features."""
    if edge_attr is None or not conv.use_edge_attr:
        return None
    if conv.lin_edge is None:
        raise ValueError(f"{type(conv).__name__} was built without edge_dim: "
                         "it has no lin_edge for edge features")
    return linear(conv.lin_edge, edge_attr, conv.dtype)


def _glorot_param(heads, head_dim):
    # glorot-uniform, flax's initializer for att*: limit sqrt(6 / (H + Dh)).
    return nn.Parameter(nn.init.xavier_uniform_(torch.empty(heads, head_dim)))


class GATConv(nn.Module):
    """Multi-head graph attention. v1: score = LeakyReLU(a_src·W_src x_j +
    a_dst·W_dst x_i); ``v2=True``: a·LeakyReLU(W_src x_j + W_dst x_i).
    Heads are concatenated (head-major) or, with ``concat_heads=False``,
    averaged; the bias is added after."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
                 concat_heads: bool = True, negative_slope: float = 0.2,
                 v2: bool = False, use_edge_attr: bool = False,
                 edge_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if concat_heads and out_dim % heads:
            raise ValueError(
                f"out_dim {out_dim} not divisible by heads {heads}")
        self.heads = heads
        self.concat_heads = concat_heads
        self.negative_slope = negative_slope
        self.v2 = v2
        self.dtype = dtype
        self.head_dim = out_dim // heads if concat_heads else out_dim
        d = heads * self.head_dim
        self.lin_src = nn.Linear(in_dim, d, bias=False)
        self.lin_dst = nn.Linear(in_dim, d, bias=False)
        # EdgeAttrGAT: lin_edge(e) added to lin_src(x_j), as the key and the
        # value; ``edge_dim`` is the edge rows' width (flax infers it)
        self.use_edge_attr = use_edge_attr
        self.lin_edge = (nn.Linear(edge_dim, d, bias=False)
                         if use_edge_attr and edge_dim is not None else None)
        if v2:
            self.att = _glorot_param(heads, self.head_dim)
        else:
            self.att_src = _glorot_param(heads, self.head_dim)
            self.att_dst = _glorot_param(heads, self.head_dim)
        self.bias = nn.Parameter(torch.zeros(
            out_dim if concat_heads else self.head_dim))

    def _finish(self, out):
        # out: [n, H*Dh], head-major
        if not self.concat_heads:
            out = out.reshape(-1, self.heads, self.head_dim).mean(1)
        return out + self.bias.to(out.dtype)

    def _attend(self, attend, x_dst, x_src, *where, he=None, block_he=None):
        """Project, then logits, masked softmax and the weighted sum in K7
        (``attend``: ``fanout_attention_block`` or ``fanout_attention_ell``,
        ``where`` its mask or EllGraph). The reference projects the
        gathered neighbor rows (convs.py:295); a row gather commutes with a
        linear layer, so projecting the source table changes the order of
        operations, not the function. EdgeAttrGAT: ``he``, the ELL form's
        projected edge table (K7's addend), or ``block_he``, the dense
        block's projected edge rows, added elementwise as the reference
        adds them (convs.py:296-298)."""
        src = linear(self.lin_src, x_src, self.dtype)
        hd = linear(self.lin_dst, x_dst, self.dtype)
        if block_he is not None:
            src = src + block_he
        edges = {} if he is None else {"he": he}
        if self.v2:
            out = attend(hd, src, None, *where, "gatv2", self.heads,
                         self.att, negative_slope=self.negative_slope,
                         **edges)
        else:
            out = attend(hd, src, None, *where, "gat", self.heads,
                         self.att_src, self.att_dst,
                         negative_slope=self.negative_slope, **edges)
        return self._finish(out)

    def ell(self, x_p, ell, edge_attr=None):
        """ELL form over the whole permuted graph (K7, backward K7b +
        K6b); EdgeAttrGAT's ``lin_edge`` projects the [E, De] edge table
        once and K7 adds its rows to the source rows (backward: K11)."""
        return self._attend(fanout_attention_ell, x_p, x_p, ell,
                            he=_edge_linear(self, edge_attr))

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        he = _edge_linear(self, edge_attr)
        return self._attend(fanout_attention_block, x_dst, _flat_block(nbr),
                            mask, block_he=None if he is None
                            else he.reshape(-1, he.shape[-1]))

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form (``convs.py:312-328``). GAT v1: the attention terms
        ``a_src = <W_src x, att_src>`` and ``a_dst`` once per node ([N, H]
        tables), the logits LeakyReLU(a_src[src] + a_dst[dst]) by per-edge
        gathers (backward: K8 over each index), K9 per destination, and the
        message sum as K8 weighted per head over the [N, H*Dh] source table
        — no [E, H, Dh] block (backward: K8b for the table, K10 for the
        weights, K9b for the logits). EdgeAttrGAT (``use_edge_attr``):
        ``lin_edge(edge_attr)`` [E, H*Dh] by edge id joins the logits and
        the values (``ops/coo_edges.py`` :func:`coo_gat_edges`). GATv2: the
        logits by K10's gatv2 mode (backward K8b's and K8's gatv2 modes),
        then K9 and the weighted K8 as v1; with edge rows, ``lin_edge(
        edge_attr)`` joins the gate and the values (:func:`coo_gatv2_edges`)."""
        index, src_index = _indexes(src, dst, num_nodes, index, src_index)
        h, dh = self.heads, self.head_dim
        hs = linear(self.lin_src, x, self.dtype).reshape(-1, h, dh)
        hd = linear(self.lin_dst, x, self.dtype).reshape(-1, h, dh)
        he = _edge_linear(self, edge_attr)
        if self.v2:
            if he is not None:
                return self._finish(coo_gatv2_edges(
                    src, dst, hs, hd, he, self.att.to(self.dtype),
                    negative_slope=self.negative_slope, index=index,
                    src_index=src_index))
            logits = gatv2_scores(src, dst, hs, hd, self.att.to(self.dtype),
                                  negative_slope=self.negative_slope,
                                  index=index, src_index=src_index)
        else:
            a_src = (hs * self.att_src.to(self.dtype)).sum(-1)    # [N, H]
            a_dst = (hd * self.att_dst.to(self.dtype)).sum(-1)
            pre = (gather_edges(a_src, src, index=src_index)
                   + gather_edges(a_dst, dst, index=index))
            if he is not None:
                return self._finish(coo_gat_edges(
                    src, dst, num_nodes, hs, he, pre,
                    self.att_src.to(self.dtype),
                    negative_slope=self.negative_slope, index=index,
                    src_index=src_index))
            logits = leaky_relu(pre, self.negative_slope)
        alpha = segment_softmax(logits, dst, num_nodes, index=index)
        out = coo_spmm(src, dst, hs, num_nodes, edge_weight=alpha,
                       index=index, src_index=src_index)
        return self._finish(out.reshape(-1, h * dh))

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)


class TransformerConv(nn.Module):
    """Graph transformer conv: scaled dot-product attention of Q (dst)
    over K/V (neighbors) per head, plus a root skip ``lin_skip(x_dst)``."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 1,
                 use_edge_attr: bool = False, edge_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_dim % heads:
            raise ValueError("out_dim must divide heads")
        self.heads = heads
        self.head_dim = out_dim // heads
        self.dtype = dtype
        self.lin_q = nn.Linear(in_dim, out_dim)
        self.lin_k = nn.Linear(in_dim, out_dim)
        self.lin_v = nn.Linear(in_dim, out_dim)
        self.lin_skip = nn.Linear(in_dim, out_dim)
        # lin_edge(e) added to k and v (convs.py:367-370)
        self.use_edge_attr = use_edge_attr
        self.lin_edge = (nn.Linear(edge_dim, out_dim, bias=False)
                         if use_edge_attr and edge_dim is not None else None)

    def _attend(self, attend, x_dst, x_src, *where, he=None, block_he=None):
        """K and V of every source row once (the reference projects the
        gathered block, convs.py:365-366): the order of operations changes,
        not the function. ``he``: the ELL form's projected edge table (K7's
        addend); ``block_he``: the dense block's projected edge rows, added
        to k and v elementwise as the reference adds them."""
        k = linear(self.lin_k, x_src, self.dtype)
        v = linear(self.lin_v, x_src, self.dtype)
        q = linear(self.lin_q, x_dst, self.dtype)
        if block_he is not None:
            k, v = k + block_he, v + block_he
        edges = {} if he is None else {"he": he}
        out = attend(q, k, v, *where, "transformer", self.heads, **edges)
        return out + linear(self.lin_skip, x_dst, self.dtype)

    def ell(self, x_p, ell, edge_attr=None):
        """ELL form over the whole permuted graph (K7, backward K7b +
        K6b; with edges, ``lin_edge`` over the [E, De] table once and K7's
        addend, backward K11)."""
        return self._attend(fanout_attention_ell, x_p, x_p, ell,
                            he=_edge_linear(self, edge_attr))

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        he = _edge_linear(self, edge_attr)
        return self._attend(fanout_attention_block, x_dst, _flat_block(nbr),
                            mask, block_he=None if he is None
                            else he.reshape(-1, he.shape[-1]))

    def coo(self, x, src, dst, num_nodes, edge_attr=None, *, index=None,
            src_index=None):
        """COO form (``convs.py:379-392``): K10 logits ``<q[dst], k[src]> /
        sqrt(Dh)``, K9 per destination, K8 sums the v rows weighted per
        head, plus ``lin_skip(x)`` (backward: K8b and K10 for the sum, K9b,
        then K10b's coefficients with K8 for q and K8b for k). Rounding: the
        reference divides the bf16 dot by sqrt(Dh) in bf16 (two roundings);
        K10 multiplies the fp32 dot by an fp32 1/sqrt(Dh) and rounds once.
        With ``use_edge_attr``, ``lin_edge(edge_attr)`` [E, H*Dh] by edge id
        joins the keys and the values (``ops/coo_edges.py``
        :func:`coo_transformer_edges`: K10's key addend and K8's add mode;
        backward K11's COO form for the edge rows)."""
        index, src_index = _indexes(src, dst, num_nodes, index, src_index)
        h, dh = self.heads, self.head_dim
        q = linear(self.lin_q, x, self.dtype).reshape(-1, h, dh)
        k = linear(self.lin_k, x, self.dtype).reshape(-1, h, dh)
        v = linear(self.lin_v, x, self.dtype).reshape(-1, h, dh)
        scale = torch.full((h,), dh ** -0.5, dtype=torch.float32,
                           device=x.device)
        he = _edge_linear(self, edge_attr)
        if he is not None:
            out = coo_transformer_edges(src, dst, q, k, v, he, scale,
                                        index=index, src_index=src_index)
            return out + linear(self.lin_skip, x, self.dtype)
        logits = sddmm(src, dst, q, k, scale=scale, index=index,
                       src_index=src_index)
        alpha = segment_softmax(logits, dst, num_nodes, index=index)
        out = coo_spmm(src, dst, v, num_nodes, edge_weight=alpha,
                       index=index, src_index=src_index)
        return out.reshape(-1, h * dh) + linear(self.lin_skip, x, self.dtype)

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)
