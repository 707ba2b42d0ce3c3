"""Link-prediction model wrapper and decoders (port of
``gigl_tpu/models/link_prediction.py``: inner-product and cosine decoders,
``LinkPredictionGNN``)."""

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
                hop_degrees=None, cached_agg=None):
        return self.encoder(hop_feats, masks, edge_feats, train=train,
                            hop_degrees=hop_degrees, cached_agg=cached_agg)

    def decode(self, q, c):
        return self.decoder(q, c)

    def decode_all_pairs(self, q, c):
        return self.decoder.all_pairs(q, c)
