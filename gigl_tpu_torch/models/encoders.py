"""Homogeneous GNN encoder over dense fanout blocks (port of
``gigl_tpu/models/encoders.py`` ``GNNEncoder``).

``forward(hop_feats, masks, ..., cached_agg=None)`` is the sampled
dense-block path: ``hop_feats[d]`` is ``[B, K1..Kd, D]`` and layer i
updates depths 0..L-1-i from depth d+1 neighbors. With ``cached_agg``
(precomputed deepest-hop aggregates, ops/hopcache.py) the tree is one hop
shallower and layer 1 consumes the cache through ``conv.block_cached``.
The per-layer epilogue keeps the reference ordering: no activation after
the last conv (unless asked), activation otherwise.

Ported so far: GraphSAGE convs, activation placement, output L2
normalization, and eval mode. Other convs, batch norm, jumping knowledge,
the final linear layer, edge features, feature embeddings / DCN and
training-mode dropout raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.models.convs import SAGEConv
from gigl_tpu_torch.models.layers import l2_normalize

CONV_TYPES = (
    "graphsage", "gcn", "gin", "gine", "gat", "gatv2", "edge_attr_gat",
    "transformer",
)

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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (gigl_tpu.models.encoders.GNNEncoder)")


class GNNEncoder(nn.Module):
    """Stacked message-passing encoder (see module docstring)."""

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
        feature_interaction_layers: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if conv not in CONV_TYPES:
            raise ValueError(f"Unknown conv type {conv!r}; known: {CONV_TYPES}")
        if conv != "graphsage":
            raise _not_ported(f"conv {conv!r}")
        for flag, what in ((batchnorm, "batchnorm"),
                           (linear_layer, "linear_layer"),
                           (jk_mode, "jk_mode"), (edge_dim, "edge_dim"),
                           (feature_interaction_layers,
                            "feature_interaction_layers")):
            if flag:
                raise _not_ported(what)
        self.conv = conv
        self.conv_kwargs = conv_kwargs
        self.num_layers = num_layers
        self.activation = activation
        self.activation_after_last_conv = activation_after_last_conv
        self.dropout = dropout
        self.l2_normalize_output = l2_normalize_output
        self.dtype = dtype
        dims = [in_dim] + [hid_dim] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], dtype=dtype, **(conv_kwargs or {}))
            for i in range(num_layers))

    def _epilogue(self, x, is_last):
        if is_last and not self.activation_after_last_conv:
            return x
        # No batch norm is ported, so activation placement relative to it
        # does not matter; dropout is the identity in eval mode.
        return self.activation(x)

    def _post(self, x):
        if self.l2_normalize_output:
            x = l2_normalize(x)
        return x

    def forward(
        self,
        hop_feats: Sequence[torch.Tensor],
        masks: Sequence[torch.Tensor],
        edge_feats=None,
        train: bool = False,
        hop_degrees: Optional[Sequence[torch.Tensor]] = None,
        cached_agg: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """hop_feats[d]: [B, K1..Kd, Din]; masks[d]: [B, K1..Kd] bool.
        With cached_agg (cached_agg[d] [B, K1..Kd, Din]) the tree has
        num_layers levels, otherwise num_layers + 1. Returns [B, out_dim]."""
        if train:
            raise _not_ported("training mode")
        if edge_feats is not None and any(e is not None for e in edge_feats):
            raise _not_ported("edge features")
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
        h = [f.to(self.dtype) for f in hop_feats]
        for i, conv in enumerate(self.convs):
            is_last = i == L - 1
            new_h = []
            if i == 0 and cached_agg is not None:
                for d in range(L):
                    dst = h[d]
                    lead, dim = dst.shape[:-1], dst.shape[-1]
                    out = conv.block_cached(dst.reshape(-1, dim),
                                            cached_agg[d].reshape(-1, dim))
                    out = self._epilogue(out, is_last)
                    new_h.append(out.reshape(lead + (out.shape[-1],)))
                h = new_h
                continue
            for d in range(L - i):
                dst, nbr = h[d], h[d + 1]
                lead = dst.shape[:-1]
                k = nbr.shape[len(lead)]
                out = conv.block(dst.reshape(-1, dst.shape[-1]),
                                 nbr.reshape(-1, k, nbr.shape[-1]),
                                 masks[d + 1].reshape(-1, k))
                out = self._epilogue(out, is_last)
                new_h.append(out.reshape(lead + (out.shape[-1],)))
            h = new_h
        return self._post(h[0])
