"""Link-prediction model wrappers and decoders (port of
``gigl_tpu/models/link_prediction.py``: inner-product and cosine decoders,
``LinkPredictionGNN``, ``HeteroLinkPredictionGNN`` without an edge
scorer)."""

from __future__ import annotations

import enum

import torch
from torch import nn


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
    [Nq, Nc] score matrix."""

    def __init__(self, decoder_type=DecoderType.INNER_PRODUCT):
        super().__init__()
        self.decoder_type = DecoderType(decoder_type)
        if self.decoder_type not in (DecoderType.INNER_PRODUCT,
                                     DecoderType.COSINE):
            raise NotImplementedError(
                f"decoder {self.decoder_type.value!r} is not ported yet "
                "(gigl_tpu.models.link_prediction.LinkPredictionDecoder)")

    def forward(self, q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.decoder_type == DecoderType.COSINE:
            q, c = _unit(q), _unit(c)
        return (q * c).sum(-1)

    def all_pairs(self, q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """q: [Nq, D], c: [Nc, D] -> [Nq, Nc]."""
        if self.decoder_type == DecoderType.COSINE:
            q, c = _unit(q), _unit(c)
        return q @ c.T


class LinkPredictionGNN(nn.Module):
    """Encoder + decoder bundle: ``forward`` encodes, ``decode`` scores
    pairs, ``decode_all_pairs`` scores every (query, candidate) pair."""

    def __init__(self, encoder: nn.Module, decoder: LinkPredictionDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

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

    def decode(self, q, c):
        return self.decoder(q, c)

    def decode_all_pairs(self, q, c):
        return self.decoder.all_pairs(q, c)


class HeteroLinkPredictionGNN(nn.Module):
    """Typed encoder (``HeteroGNNEncoder``) + decoder bundle. The
    label-edge-feature scorer is not ported (ROADMAP A12, label-edge
    features): ``decode`` ignores ``edge_feats`` as the reference does
    without a scorer, and ``edge_score`` raises."""

    def __init__(self, encoder: nn.Module, decoder: LinkPredictionDecoder):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def forward(self, blocks, feats, train: bool = False, generator=None):
        return self.encoder(blocks, feats, train=train, generator=generator)

    def decode(self, q, c, edge_feats=None):
        return self.decoder(q, c)

    def decode_all_pairs(self, q, c):
        return self.decoder.all_pairs(q, c)

    def edge_score(self, edge_feats):
        raise NotImplementedError(
            "the label-edge-feature scorer is not ported yet (ROADMAP A12, "
            "label-edge features)")
