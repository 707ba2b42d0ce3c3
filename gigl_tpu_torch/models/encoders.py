"""Homogeneous GNN encoder over dense fanout blocks (port of
``gigl_tpu/models/encoders.py`` ``GNNEncoder``).

``forward(hop_feats, masks, ..., cached_agg=None)`` is the sampled
dense-block path: ``hop_feats[d]`` is ``[B, K1..Kd, D]`` and layer i
updates depths 0..L-1-i from depth d+1 neighbors. With ``cached_agg``
(precomputed deepest-hop aggregates, ops/hopcache.py) the tree is one hop
shallower and layer 1 consumes the cache through ``conv.block_cached``.
The per-layer epilogue keeps the reference ordering: no activation after
the last conv (unless asked), activation otherwise.

``encode_ell(x, ell, edge_attr=None)`` is the exact full-graph path: a
permute-gather in (K3), one ``ell_layer`` per conv over the degree buckets
(K6 or K7, the edge rows read through the buckets' edge slots), and the
inverse gather out (K3). It trains: the gathers' backward is K3 through
the inverse permutation, the layers' K6b (after K7b for the attention
convs), the edge tables' K11.

``encode_coo(x, src, dst, num_nodes, edge_attr=None)`` is the same exact
full-graph encode over COO edges: each conv's ``coo`` form on the segment
kernels (K8-K10, backward K8b-K10b), in original node order, walking the
two ``SegmentIndex``es of the graph (given, or built once per call). With
edge features (``edge_attr`` [E, De] in COO edge order) and an edge conv,
the layers run over the graph relabelled in its destination walk order
(``ops/segment.py`` :func:`coo_walk`, built once and kept on the index):
the edge table is permuted once (K3, trainable through its inverse) and
projected row by row, so the destination walks read its rows in
sequence.

Edge features: with ``edge_dim`` and an edge conv (GINE, EdgeAttrGAT,
Transformer) the raw edge rows are projected once to ``hid_dim`` by
``edge_in_proj`` (no bias), as the reference does; EdgeAttrGAT and the
Transformer (with ``conv_kwargs={"use_edge_attr": True}``) then project
them per layer with ``lin_edge``, GINE adds them to the neighbor rows (so
its layer 1 needs ``in_dim == hid_dim``). The other convs ignore edge
features, as the reference's do.

The options of the reference's ``BasicHomogeneousGNN`` run on all three
paths: a feature embedding and DCN cross layers on the input (``_pre``:
after the cast to the compute type, so a bf16 id is rounded before its
truncation), batch norm before or after the activation (``bn_{i}``: one
a layer with jumping knowledge, else one a layer but the last), jumping
knowledge over every layer's output (``cat`` / ``max`` / ``lstm``; the
last layer then takes activation, batch norm and dropout too, and its
conv is ``hid_dim`` wide), and the final linear layer after the output
L2 normalisation (``_post``). On the sampled block path batch norm runs
on each depth's flattened ``[rows, hid]`` block, padding slots
included, once a depth, so in train mode its running statistics move
once a call, in order. The cached path refuses a feature embedding and
DCN, as the reference does (the cache aggregates raw features). Train-mode
dropout draws its keep mask from an explicit ``torch.Generator`` (its bits
differ from flax's); rate 0 is the identity, as in flax. ``train`` sets
batch norm's mode too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.models.convs import (
    GATConv,
    GCNConv,
    GINConv,
    GINEConv,
    SAGEConv,
    TransformerConv,
    linear,
)
from gigl_tpu_torch.models.layers import (
    BatchNorm,
    DCNCross,
    FeatureEmbeddingLayer,
    JumpingKnowledge,
    dropout,
    l2_normalize,
)
from gigl_tpu_torch.ops.ell import EllGraph, ell_layer
from gigl_tpu_torch.ops.gather import permute_rows
from gigl_tpu_torch.ops.segment import SegmentIndex, coo_walk

CONV_TYPES = (
    "graphsage", "gcn", "gin", "gine", "gat", "gatv2", "edge_attr_gat",
    "transformer",
)

# Convs for which ``edge_dim`` builds ``edge_in_proj`` (encoders.py:70).
_CONVS_WITH_EDGE_ATTR = {"gine", "edge_attr_gat", "transformer"}

# Convs whose first-layer neighbor aggregation is weight-independent and can
# therefore consume a precomputed hop cache (ops/hopcache.py).
CACHEABLE_CONVS = {"graphsage", "gcn", "gin"}


def cached_agg_kind(conv: str, conv_kwargs=None) -> str:
    """The hopcache aggregation kind layer 1 of ``conv`` consumes."""
    if conv == "graphsage":
        aggr = (conv_kwargs or {}).get("aggr", "mean")
        if aggr not in ("mean", "sum"):
            raise ValueError(f"SAGE aggr {aggr!r} is not cacheable")
        return aggr
    if conv == "gcn":
        return "gcn"
    if conv == "gin":
        return "sum"
    raise ValueError(
        f"conv {conv!r} is not hop-cacheable (weight-dependent aggregation); "
        f"cacheable: {sorted(CACHEABLE_CONVS)}")


def _make_conv(conv: str, in_dim: int, out_dim: int, dtype,
               kwargs: Dict[str, Any], edge_dim: Optional[int]) -> nn.Module:
    """One conv; ``edge_dim`` is the width of the edge rows it would read
    (``lin_edge``'s input), None without edge features."""
    kw = dict(kwargs)
    if conv == "graphsage":
        return SAGEConv(in_dim, out_dim, dtype=dtype, **kw)
    if conv == "gcn":
        return GCNConv(in_dim, out_dim, dtype=dtype, **kw)
    if conv == "gin":
        return GINConv(in_dim, out_dim, dtype=dtype, **kw)
    if conv == "gine":
        return GINEConv(in_dim, out_dim, dtype=dtype, **kw)
    if conv == "gat":
        return GATConv(in_dim, out_dim, dtype=dtype, edge_dim=edge_dim, **kw)
    if conv == "gatv2":
        return GATConv(in_dim, out_dim, v2=True, dtype=dtype,
                       edge_dim=edge_dim, **kw)
    if conv == "edge_attr_gat":
        return GATConv(in_dim, out_dim, use_edge_attr=True, dtype=dtype,
                       edge_dim=edge_dim, **kw)
    if conv == "transformer":
        return TransformerConv(in_dim, out_dim, dtype=dtype,
                               edge_dim=edge_dim, **kw)
    raise ValueError(f"Unknown conv type {conv!r}; known: {CONV_TYPES}")


class GNNEncoder(nn.Module):
    """Stacked message-passing encoder (see module docstring). ``in_dim``
    is the raw feature width; with ``feature_embedding`` the convs read
    ``feature_embedding.out_dim(in_dim)`` columns."""

    def __init__(
        self,
        in_dim: int,
        hid_dim: int,
        out_dim: int,
        num_layers: int = 2,
        conv: str = "graphsage",
        conv_kwargs: Optional[Dict[str, Any]] = None,
        activation: Callable = F.relu,
        activation_before_norm: bool = False,
        activation_after_last_conv: bool = False,
        dropout: float = 0.0,
        batchnorm: bool = False,
        linear_layer: bool = False,
        l2_normalize_output: bool = False,
        jk_mode: Optional[str] = None,
        edge_dim: Optional[int] = None,
        feature_embedding: Optional[FeatureEmbeddingLayer] = None,
        feature_interaction_layers: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if conv not in CONV_TYPES:
            raise ValueError(f"Unknown conv type {conv!r}; known: {CONV_TYPES}")
        self.conv = conv
        self.conv_kwargs = conv_kwargs
        self.num_layers = num_layers
        self.out_dim = out_dim
        self.activation = activation
        self.activation_before_norm = activation_before_norm
        self.activation_after_last_conv = activation_after_last_conv
        self.dropout = dropout
        self.l2_normalize_output = l2_normalize_output
        self.jk_mode = jk_mode or None
        self.dtype = dtype
        self.feature_embedding = feature_embedding
        if feature_embedding is not None:
            in_dim = feature_embedding.out_dim(in_dim)
        self.dcn = (DCNCross(in_dim, feature_interaction_layers, dtype)
                    if feature_interaction_layers else None)
        last_dim = hid_dim if (linear_layer or self.jk_mode) else out_dim
        dims = [in_dim] + [hid_dim] * (num_layers - 1) + [last_dim]
        # raw edge rows projected once to hid_dim (encoders.py:138-141)
        self.edge_in_proj = (nn.Linear(edge_dim, hid_dim, bias=False)
                             if edge_dim is not None
                             and conv in _CONVS_WITH_EDGE_ATTR else None)
        edge_in = hid_dim if self.edge_in_proj is not None else edge_dim
        self.convs = nn.ModuleList(
            _make_conv(conv, dims[i], dims[i + 1], dtype, conv_kwargs or {},
                       edge_in)
            for i in range(num_layers))
        n_bn = (num_layers if self.jk_mode else num_layers - 1) \
            if batchnorm else 0
        self.bns = nn.ModuleList(BatchNorm(hid_dim, dtype=dtype)
                                 for _ in range(n_bn))
        self.jk = (JumpingKnowledge(
            self.jk_mode, hid_dim, num_layers,
            out_dim=hid_dim if linear_layer else out_dim, dtype=dtype)
            if self.jk_mode else None)
        self.final_linear = (nn.Linear(hid_dim, out_dim) if linear_layer
                             else None)

    def _epilogue(self, x, layer_idx, is_last, train, generator):
        """Activation, batch norm and dropout after conv ``layer_idx``
        (``homogeneous.py:131-147``'s order); the last conv's output goes
        on untouched unless JK or ``activation_after_last_conv`` asks."""
        if is_last and not self.jk_mode and not self.activation_after_last_conv:
            return x
        if self.activation_before_norm:
            x = self.activation(x)
        if layer_idx < len(self.bns):
            x = self.bns[layer_idx](x, train)
        if not self.activation_before_norm:
            x = self.activation(x)
        return dropout(x, self.dropout, train, generator)

    def _pre(self, x):
        if self.feature_embedding is not None:
            x = self.feature_embedding(x)
        if self.dcn is not None:
            x = self.dcn(x)
        return x

    def _post(self, x):
        if self.l2_normalize_output:
            x = l2_normalize(x)
        if self.final_linear is not None:
            x = linear(self.final_linear, x, self.dtype)
        return x

    def reads_edges(self) -> bool:
        """Whether the convs read edge features (GINE; EdgeAttrGAT and the
        Transformer with ``use_edge_attr``): the others ignore them."""
        conv = self.convs[0]
        return isinstance(conv, GINEConv) or getattr(conv, "use_edge_attr",
                                                     False)

    def _edge_in(self, edge_attr):
        """The edge rows the convs read: ``edge_in_proj(edge_attr)`` in the
        compute type where the encoder has it, else as given."""
        if edge_attr is None or self.edge_in_proj is None:
            return edge_attr
        return linear(self.edge_in_proj, edge_attr, self.dtype)

    def forward(
        self,
        hop_feats: Sequence[torch.Tensor],
        masks: Sequence[torch.Tensor],
        edge_feats=None,
        train: bool = False,
        hop_degrees: Optional[Sequence[torch.Tensor]] = None,
        cached_agg: Optional[Sequence[torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """hop_feats[d]: [B, K1..Kd, Din]; masks[d]: [B, K1..Kd] bool;
        edge_feats (optional): edge_feats[d] [B, K1..Kd, De] the features of
        the edges into level d's slots (None for the roots). With
        cached_agg (cached_agg[d] [B, K1..Kd, Din]) the tree has num_layers
        levels, otherwise num_layers + 1. Returns [B, out_dim]. ``train``
        turns dropout on, drawn from ``generator``, and batch norm's batch
        statistics."""
        L = self.num_layers
        if cached_agg is not None:
            if self.conv not in CACHEABLE_CONVS:
                raise ValueError(f"conv {self.conv!r} cannot use a hop cache")
            if len(hop_feats) != L:
                raise ValueError(
                    f"cached path needs {L} hop levels for {L} layers, "
                    f"got {len(hop_feats)}")
        elif len(hop_feats) != L + 1:
            raise ValueError(
                f"need {L + 1} hop levels for {L} layers, got {len(hop_feats)}")
        if cached_agg is not None and (self.feature_embedding is not None
                                       or self.dcn is not None):
            # The cache aggregates RAW features; a nonlinear per-node input
            # transform would make agg(transform(x)) != transform(agg(x)).
            raise ValueError(
                "hop cache is incompatible with feature_embedding / DCN")
        h = [self._pre(f.to(self.dtype)) for f in hop_feats]
        if edge_feats is not None:
            edge_feats = [None if e is None else self._edge_in(e)
                          for e in edge_feats]
        jk_xs = []
        for i, conv in enumerate(self.convs):
            is_last = i == L - 1
            new_h = []
            if i == 0 and cached_agg is not None:
                for d in range(L):
                    dst = h[d]
                    lead, dim = dst.shape[:-1], dst.shape[-1]
                    deg = (None if hop_degrees is None
                           else hop_degrees[d].reshape(-1))
                    out = conv.block_cached(dst.reshape(-1, dim),
                                            cached_agg[d].reshape(-1, dim),
                                            deg)
                    out = self._epilogue(out, i, is_last, train, generator)
                    new_h.append(out.reshape(lead + (out.shape[-1],)))
                h = new_h
                jk_xs.append(h[0])
                continue
            for d in range(L - i):
                dst, nbr = h[d], h[d + 1]
                lead = dst.shape[:-1]
                k = nbr.shape[len(lead)]
                degs = None
                if hop_degrees is not None:
                    degs = (hop_degrees[d].reshape(-1),
                            hop_degrees[d + 1].reshape(-1, k))
                ea = None
                if edge_feats is not None and edge_feats[d + 1] is not None:
                    ea = edge_feats[d + 1].reshape(
                        -1, k, edge_feats[d + 1].shape[-1])
                out = conv.block(dst.reshape(-1, dst.shape[-1]),
                                 nbr.reshape(-1, k, nbr.shape[-1]),
                                 masks[d + 1].reshape(-1, k), ea, degs)
                out = self._epilogue(out, i, is_last, train, generator)
                new_h.append(out.reshape(lead + (out.shape[-1],)))
            h = new_h
            jk_xs.append(h[0])
        return self._post(self.jk(jk_xs) if self.jk is not None else h[0])

    def encode_ell(
        self,
        x: torch.Tensor,
        ell: EllGraph,
        edge_attr: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Exact full-graph encode through degree-bucketed blocks
        (ops/ell.py): x [N, Din] in original node order, on ``ell``'s
        device -> [N, out_dim] in original node order. The permute-gathers
        in and out run through K3 (differentiable, ``permute_rows``); each
        layer's aggregation through K6 or K7, their backward through K6b
        and K7b. ``edge_attr`` [E, De] in original COO edge order (the
        layers reach it through ``ell.edge_slots``; its gradient is K11's).
        ``train`` turns dropout on, drawn from ``generator``, and batch
        norm's batch statistics (over the N rows)."""
        x_p = permute_rows(self._pre(x.to(self.dtype)), ell.perm, ell.rank)
        edge_attr = self._edge_in(edge_attr)
        jk_xs = []
        for i, conv in enumerate(self.convs):
            is_last = i == self.num_layers - 1
            x_p = ell_layer(conv, x_p, ell, edge_attr)
            x_p = self._epilogue(x_p, i, is_last, train, generator)
            jk_xs.append(x_p)
        if self.jk is not None:
            x_p = self.jk(jk_xs)
        return permute_rows(self._post(x_p), ell.rank, ell.perm)

    def encode_coo(
        self,
        x: torch.Tensor,
        src: torch.Tensor,
        dst: torch.Tensor,
        num_nodes: int,
        edge_attr: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        *,
        index: Optional[SegmentIndex] = None,
        src_index: Optional[SegmentIndex] = None,
    ) -> torch.Tensor:
        """Exact full-graph encode over COO edges (``encoders.py:303-324``):
        x [N, Din], ``src`` / ``dst`` [E] int32 on x's device, messages
        flowing src -> dst -> [N, out_dim]. ``index`` / ``src_index``: the
        SegmentIndexes of ``dst`` and ``src`` over the N nodes, built here
        on the host when not given (a trainer builds them once per graph).
        ``edge_attr`` [E, De] in COO edge order: projected by
        ``edge_in_proj`` as the reference does and read by the edge convs,
        over the graph in its destination walk order (module docstring);
        its gradient reaches the caller in COO order. ``train`` turns
        dropout on, drawn from ``generator``, and batch norm's batch
        statistics."""
        if index is None:
            index = SegmentIndex.from_ids(dst, num_nodes, gather=src)
        if src_index is None:
            src_index = SegmentIndex.from_ids(src, num_nodes, gather=dst)
        if edge_attr is not None and not self.reads_edges():
            edge_attr = None
        if edge_attr is not None:
            walk = coo_walk(index, src)
            src, dst = walk.src, walk.dst
            index, src_index = walk.index, walk.src_index
            # fp32 rows are whole 4-byte words, which K3 moves
            edge_attr = self._edge_in(permute_rows(
                edge_attr.float(), walk.perm, walk.rank).to(self.dtype))
        x = self._pre(x.to(self.dtype))
        jk_xs = []
        for i, conv in enumerate(self.convs):
            is_last = i == self.num_layers - 1
            x = conv.coo(x, src, dst, num_nodes, edge_attr, index=index,
                         src_index=src_index)
            x = self._epilogue(x, i, is_last, train, generator)
            jk_xs.append(x)
        if self.jk is not None:
            x = self.jk(jk_xs)
        return self._post(x)


def encoder_from_config(args: Dict[str, Any], **overrides) -> GNNEncoder:
    """A GNNEncoder from a flat string-map config (the reference's
    trainerArgs: ``hid_dim``, ``out_dim``, ``num_layers``, ``conv``,
    ``num_heads``, ``dropout``, ``batchnorm``, ``linear_layer``,
    ``should_l2_normalize_embedding_layer_output``, ``jk_mode``,
    ``use_bf16``; the reference's keys and defaults). ``overrides`` go to
    the constructor as they are; the raw feature width ``in_dim``, which
    flax infers, comes among them."""
    def geti(k, d):
        return int(args.get(k, d))

    def getf(k, d):
        return float(args.get(k, d))

    def getb(k, d):
        v = args.get(k, d)
        return v if isinstance(v, bool) else str(v).lower() in ("1", "true",
                                                                "yes")

    conv_kwargs: Dict[str, Any] = {}
    if "num_heads" in args:
        conv_kwargs["heads"] = int(args["num_heads"])
    cfg = dict(
        hid_dim=geti("hid_dim", 128),
        out_dim=geti("out_dim", 128),
        num_layers=geti("num_layers", 2),
        conv=str(args.get("conv", "graphsage")),
        conv_kwargs=conv_kwargs,
        dropout=getf("dropout", 0.0),
        batchnorm=getb("batchnorm", False),
        linear_layer=getb("linear_layer", False),
        l2_normalize_output=getb("should_l2_normalize_embedding_layer_output",
                                 False),
        jk_mode=args.get("jk_mode") or None,
        dtype=torch.bfloat16 if getb("use_bf16", False) else torch.float32,
    )
    cfg.update(overrides)
    return GNNEncoder(**cfg)
