"""Link-prediction model wrappers and decoders (port of
``gigl_tpu/models/link_prediction.py``: the inner-product, cosine, ``mlp``
and ``hadamard_mlp`` decoders, ``EdgeFeatureScorer``,
``LinkPredictionGNN`` and ``HeteroLinkPredictionGNN``, each with an
optional label-edge scorer)."""

from __future__ import annotations

import enum
from typing import Optional

import torch
from torch import nn

from gigl_tpu_torch.models.convs import linear


class DecoderType(str, enum.Enum):
    INNER_PRODUCT = "inner_product"
    COSINE = "cosine"
    MLP = "mlp"
    HADAMARD_MLP = "hadamard_mlp"


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                       min=1e-12))


class LinkPredictionDecoder(nn.Module):
    """Scores (query, candidate) embedding pairs: ``forward(q, c)``
    broadcasts q [..., D] against c [..., D]; ``all_pairs(q, c)`` gives the
    [Nq, Nc] score matrix. The MLP decoders (``mlp``: ``[q || c]``,
    ``hadamard_mlp``: ``q * c``, then ``mlp1(relu(mlp0(.)))``, computed in
    ``dtype`` from fp32 parameters) need the embedding width ``in_dim``,
    which flax infers; their ``all_pairs`` broadcasts ``q[:, None]``
    against ``c[None]``, a [Nq, Nc, hidden_dim] intermediate, as the
    reference's does."""

    def __init__(self, decoder_type=DecoderType.INNER_PRODUCT,
                 hidden_dim: int = 128, dtype: torch.dtype = torch.float32,
                 in_dim: Optional[int] = None):
        super().__init__()
        self.decoder_type = DecoderType(decoder_type)
        self.dtype = dtype
        if self.is_mlp:
            if in_dim is None:
                raise ValueError(f"decoder {self.decoder_type.value!r} "
                                 "needs the embedding width in_dim")
            width = 2 * in_dim if self.decoder_type == DecoderType.MLP \
                else in_dim
            self.mlp0 = nn.Linear(width, hidden_dim)
            self.mlp1 = nn.Linear(hidden_dim, 1)

    @property
    def is_mlp(self) -> bool:
        return self.decoder_type in (DecoderType.MLP,
                                     DecoderType.HADAMARD_MLP)

    def forward(self, q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.decoder_type == DecoderType.HADAMARD_MLP:
            h = q * c
        elif self.decoder_type == DecoderType.MLP:
            h = torch.cat(torch.broadcast_tensors(q, c), dim=-1)
        else:
            if self.decoder_type == DecoderType.COSINE:
                q, c = _unit(q), _unit(c)
            return (q * c).sum(-1)
        h = torch.relu(linear(self.mlp0, h, self.dtype))
        return linear(self.mlp1, h, self.dtype)[..., 0]

    def all_pairs(self, q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """q: [Nq, D], c: [Nc, D] -> [Nq, Nc]."""
        if self.is_mlp:
            return self(q[:, None, :], c[None, :, :])
        if self.decoder_type == DecoderType.COSINE:
            q, c = _unit(q), _unit(c)
        return q @ c.T


class EdgeFeatureScorer(nn.Module):
    """Scores a supervision (label) edge from its own features:
    ``e1(relu(e0(edge_feats)))[..., 0]`` (``link_prediction.py:101-116``),
    added to the pair score by ``decode(q, c, edge_feats)``. ``in_dim`` is
    the edge features' width (flax infers it); the layers compute in
    ``dtype`` from fp32 parameters."""

    def __init__(self, in_dim: int, hidden_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.e0 = nn.Linear(in_dim, hidden_dim)
        self.e1 = nn.Linear(hidden_dim, 1)

    def forward(self, edge_feats: torch.Tensor) -> torch.Tensor:
        h = torch.relu(linear(self.e0, edge_feats, self.dtype))
        return linear(self.e1, h, self.dtype)[..., 0]


class _Scored(nn.Module):
    """``decode`` / ``edge_score`` with the optional edge scorer, shared by
    both link-prediction models (as the reference's are alike)."""

    def decode(self, q, c, edge_feats=None):
        s = self.decoder(q, c)
        if edge_feats is not None and self.edge_scorer is not None:
            s = s + self.edge_scorer(edge_feats)
        return s

    def decode_all_pairs(self, q, c):
        return self.decoder.all_pairs(q, c)

    def edge_score(self, edge_feats):
        if self.edge_scorer is None:
            raise ValueError("model built without an edge_scorer")
        return self.edge_scorer(edge_feats)


class LinkPredictionGNN(_Scored):
    """Encoder + decoder bundle: ``forward`` encodes, ``decode`` scores
    pairs (plus the edge scorer's term of their label edges when given),
    ``decode_all_pairs`` scores every (query, candidate) pair."""

    def __init__(self, encoder: nn.Module, decoder: LinkPredictionDecoder,
                 edge_scorer: Optional[EdgeFeatureScorer] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.edge_scorer = edge_scorer

    def forward(self, hop_feats, masks, edge_feats=None, train: bool = False,
                hop_degrees=None, cached_agg=None, generator=None):
        return self.encoder(hop_feats, masks, edge_feats, train=train,
                            hop_degrees=hop_degrees, cached_agg=cached_agg,
                            generator=generator)

    def encode_coo(self, x, src, dst, num_nodes, edge_attr=None,
                   train: bool = False, generator=None, *, index=None,
                   src_index=None):
        """The encoder's full-graph COO path (``GNNEncoder.encode_coo``)."""
        return self.encoder.encode_coo(x, src, dst, num_nodes, edge_attr,
                                       train=train, generator=generator,
                                       index=index, src_index=src_index)


class HeteroLinkPredictionGNN(_Scored):
    """Typed encoder (``HeteroGNNEncoder``) + decoder bundle, with the
    optional label-edge scorer of typed supervision edges."""

    def __init__(self, encoder: nn.Module, decoder: LinkPredictionDecoder,
                 edge_scorer: Optional[EdgeFeatureScorer] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.edge_scorer = edge_scorer

    def forward(self, blocks, feats, train: bool = False, generator=None):
        return self.encoder(blocks, feats, train=train, generator=generator)
