"""Heterogeneous GNN encoder (port of ``gigl_tpu/models/hetero_encoders.py``:
``HeteroGNNEncoder``, ``HETERO_CONV_TYPES``, ``hetero_encoder_from_config``).

Per-node-type input projections ``in_{type}``, ``num_layers`` typed convs
(HGT, SimpleHGN or RGCN, each ``hid_dim`` wide), an optional final linear
``out_proj`` and L2 normalisation. Two paths:

- ``forward(blocks, feats)``: the sampled typed block tree
  (``sampling/hetero_sampler.TypedBlocks``): layer l updates every tree
  entry at depth <= L-1-l from its child blocks, one per relation, through
  the convs' dense block form;
- ``encode_full(features, edges, num_nodes)``: every node of every type
  through its exact full neighborhood, layer by layer, through the convs'
  ``coo`` form on the segment kernels (K8, K9, K10), O(E) memory per
  layer. The graph's :class:`~gigl_tpu_torch.models.hetero_convs.
  TypedSegments` are built once, before the first layer.

Unlike flax's lazily shaped ``Dense``, the port's linear layers need their
input widths: ``in_dims`` maps each node type to its feature width.
Train-mode dropout draws from an explicit ``torch.Generator`` as
``GNNEncoder`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from gigl_tpu_torch.models.convs import linear
from gigl_tpu_torch.models.hetero_convs import (
    HGTConv,
    RGCNConv,
    SimpleHGNConv,
    TypedSegments,
    _safe,
)
from gigl_tpu_torch.models.layers import dropout, l2_normalize

HETERO_CONV_TYPES = ("hgt", "simple_hgn", "rgcn")


class HeteroGNNEncoder(nn.Module):
    """Stacked typed message-passing encoder (see the module docstring).
    ``node_types`` / ``edge_types`` fix the parameter sets; any block tree
    over a subset of them can be encoded."""

    def __init__(
        self,
        hid_dim: int,
        out_dim: int,
        node_types: Sequence[str],
        edge_types: Sequence[str],
        in_dims: Mapping[str, int],
        num_layers: int = 2,
        conv: str = "hgt",
        heads: int = 4,
        num_bases: int = 0,
        dropout: float = 0.0,
        l2_normalize_output: bool = False,
        final_linear: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if conv not in HETERO_CONV_TYPES:
            raise ValueError(f"Unknown hetero conv {conv!r}; known: "
                             f"{HETERO_CONV_TYPES}")
        self.node_types = tuple(str(t) for t in node_types)
        self.edge_types = tuple(str(t) for t in edge_types)
        self.conv, self.num_layers, self.dtype = conv, num_layers, dtype
        self.dropout, self.final_linear = dropout, final_linear
        self.l2_normalize_output = l2_normalize_output
        for nt in self.node_types:
            self.add_module(f"in_{_safe(nt)}",
                            nn.Linear(int(in_dims[nt]), hid_dim))
        types = (hid_dim, hid_dim, self.node_types, self.edge_types)
        make = {"hgt": lambda: HGTConv(*types, heads=heads, dtype=dtype),
                "simple_hgn": lambda: SimpleHGNConv(*types, heads=heads,
                                                    dtype=dtype),
                "rgcn": lambda: RGCNConv(*types, num_bases=num_bases,
                                         dtype=dtype)}[conv]
        self.convs = nn.ModuleList(make() for _ in range(num_layers))
        if final_linear:
            self.out_proj = nn.Linear(hid_dim, out_dim)

    def _in(self, nt: str, x: torch.Tensor) -> torch.Tensor:
        return linear(getattr(self, f"in_{_safe(nt)}"), x, self.dtype)

    def _post(self, x: torch.Tensor) -> torch.Tensor:
        if self.final_linear:
            x = linear(self.out_proj, x, self.dtype)
        if self.l2_normalize_output:
            x = l2_normalize(x)
        return x

    def forward(self, blocks, feats: Sequence[torch.Tensor],
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``feats[0]``: root features [B, D_root]; ``feats[i + 1]``:
        ``spec[i]``'s block features [B, K1..Kd, D_type]. Returns the root
        embeddings [B, out_dim]."""
        spec = blocks.spec
        L = self.num_layers
        max_depth = max((s.depth for s in spec), default=0)
        if max_depth < L:
            raise ValueError(f"block tree depth {max_depth} < num_layers {L}")

        def node_type(entry: int) -> str:
            return (blocks.root_node_type if entry == 0
                    else spec[entry - 1].neighbor_node_type)

        def depth(entry: int) -> int:
            return 0 if entry == 0 else spec[entry - 1].depth

        h: List[Optional[torch.Tensor]] = [self._in(node_type(e), f)
                                           for e, f in enumerate(feats)]
        for l, conv in enumerate(self.convs):
            new_h: List[Optional[torch.Tensor]] = [None] * len(h)
            for e in range(len(h)):
                if h[e] is None or depth(e) > L - 1 - l:
                    continue
                lead = h[e].shape[:-1]
                m = lead.numel()
                children = []
                for c in (i + 1 for i, s in enumerate(spec)
                          if s.parent == e - 1):
                    xc = h[c]
                    k = xc.shape[len(lead)]
                    children.append((xc.reshape(m, k, xc.shape[-1]),
                                     blocks.masks[c].reshape(m, k),
                                     spec[c - 1].edge_type,
                                     spec[c - 1].neighbor_node_type))
                out = conv(h[e].reshape(m, h[e].shape[-1]), node_type(e),
                           children, train=train)
                out = dropout(out, self.dropout, train, generator)
                new_h[e] = out.reshape(lead + (out.shape[-1],))
            h = new_h
        return self._post(h[0])

    def segments(self, edges: Mapping[str, Tuple],
                 num_nodes: Mapping[str, int], device=None,
                 backward: bool = True) -> TypedSegments:
        """The SegmentIndexes this encoder's convs walk, built on the host
        once per graph (``TypedSegments.build``; ``backward=False`` leaves
        out the indexes only a gradient walks). Given the very tensors the
        pass reads, each destination index keeps its source ids composed
        in walk order for K8."""
        return TypedSegments.build(edges, num_nodes,
                                   self.convs[0].segments_by, device,
                                   backward=backward)

    def encode_full(self, features: Mapping[str, torch.Tensor],
                    edges: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
                    num_nodes: Mapping[str, int], train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    segments: Optional[TypedSegments] = None
                    ) -> Dict[str, torch.Tensor]:
        """Full-graph layerwise encode of every node of every type through
        its exact full neighborhood (the convs' ``coo`` form);
        ``edges[et] = (src_ids, dst_ids)`` on the features' device, messages
        flowing src -> dst. Types absent from ``in_dims`` are skipped, as
        the reference skips types its ``in_proj`` lacks. ``segments``: the
        prebuilt :meth:`segments` (built here otherwise). Returns
        ``{node_type: [N, out_dim]}``."""
        if segments is None:
            segments = self.segments(edges, num_nodes)
        h = {nt: self._in(nt, x) for nt, x in features.items()
             if nt in self.node_types}
        for conv in self.convs:
            h = conv.coo(h, edges, num_nodes, segments)
            h = {nt: dropout(x, self.dropout, train, generator)
                 for nt, x in h.items()}
        return {nt: self._post(x) for nt, x in h.items()}


def hetero_encoder_from_config(args: Mapping[str, Any],
                               node_types: Sequence[str],
                               edge_types: Sequence[str],
                               in_dims: Mapping[str, int],
                               **overrides) -> HeteroGNNEncoder:
    """Build from the flat trainer-args string map, with the reference's
    keys and defaults (hid_dim 128, out_dim 128, num_layers 2, conv hgt,
    num_heads 4, num_bases 0, dropout 0, no L2 normalisation, fp32 unless
    use_bf16)."""
    def geti(k, d):
        return int(args.get(k, d))

    def getb(k, d):
        v = args.get(k, d)
        return v if isinstance(v, bool) else str(v).lower() in ("1", "true")

    cfg = dict(
        hid_dim=geti("hid_dim", 128),
        out_dim=geti("out_dim", 128),
        num_layers=geti("num_layers", 2),
        conv=str(args.get("conv", "hgt")),
        heads=geti("num_heads", 4),
        num_bases=geti("num_bases", 0),
        dropout=float(args.get("dropout", 0.0)),
        l2_normalize_output=getb(
            "should_l2_normalize_embedding_layer_output", False),
        node_types=tuple(str(n) for n in node_types),
        edge_types=tuple(str(e) for e in edge_types),
        in_dims=dict(in_dims),
        dtype=torch.bfloat16 if getb("use_bf16", False) else torch.float32,
    )
    cfg.update(overrides)
    return HeteroGNNEncoder(**cfg)
