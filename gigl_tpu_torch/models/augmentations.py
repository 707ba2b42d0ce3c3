"""Graph augmentations for contrastive SSL views (port of
``gigl_tpu/models/augmentations.py``).

The augmentations act on the sampled dense blocks (the hop-feature tensors
and masks of a fanout tree): dropping a neighbour slot's mask is edge
dropout in block form, and zeroing feature columns is feature (dimension)
dropout. Each function is split into its draw, from an explicit
``torch.Generator`` (its bits differ from JAX's), and a pure apply, so a
test can feed both packages the same masks:

- ``feature_dropout``: ``keep [D]`` with probability ``1 - rate``, the
  same columns zeroed for every node of the level (``feats * keep``);
- ``edge_dropout_masks``: a keep mask per level below the roots (``mask &
  keep``); ``masks[0]`` is never dropped;
- ``augment_view``: one of each a level, as the reference composes them.

At rate 0 nothing is drawn and the input comes back as it is; at rate 1
every keep is False. Both are deterministic, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


def _keep(shape, rate: float, generator: torch.Generator,
          device) -> torch.Tensor:
    """Bernoulli(1 - rate) of ``shape`` on ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < 1.0 - rate).to(device)


def draw_feature_keep(generator: torch.Generator, feats: torch.Tensor,
                      rate: float) -> Optional[torch.Tensor]:
    """The kept columns [D] of ``feature_dropout``; None at rate <= 0."""
    if rate <= 0.0:
        return None
    return _keep((feats.shape[-1],), rate, generator, feats.device)


def apply_feature_keep(feats: torch.Tensor,
                       keep: Optional[torch.Tensor]) -> torch.Tensor:
    return feats if keep is None else feats * keep.to(feats.dtype)


def feature_dropout(generator: torch.Generator, feats: torch.Tensor,
                    rate: float) -> torch.Tensor:
    """Zero whole feature columns with probability ``rate``."""
    return apply_feature_keep(feats, draw_feature_keep(generator, feats,
                                                       rate))


def draw_edge_keeps(generator: torch.Generator,
                    masks: Sequence[torch.Tensor], rate: float
                    ) -> Optional[List[torch.Tensor]]:
    """The keep masks of levels 1.. of ``edge_dropout_masks``; None at
    rate <= 0."""
    if rate <= 0.0:
        return None
    return [_keep(m.shape, rate, generator, m.device) for m in masks[1:]]


def apply_edge_keeps(masks: Sequence[torch.Tensor],
                     keeps: Optional[Sequence[torch.Tensor]]
                     ) -> List[torch.Tensor]:
    if keeps is None:
        return list(masks)
    return [masks[0]] + [m & k for m, k in zip(masks[1:], keeps)]


def edge_dropout_masks(generator: torch.Generator,
                       masks: Sequence[torch.Tensor], rate: float
                       ) -> List[torch.Tensor]:
    """Drop sampled neighbour slots with probability ``rate``; the roots'
    mask is kept."""
    return apply_edge_keeps(masks, draw_edge_keeps(generator, masks, rate))


@dataclass
class ViewDraw:
    """The draws of one augmented view: a column keep per level (None
    each at feature rate 0), the slot keeps of levels 1.. (None at edge
    rate 0) and, for a corrupted view, the permutation of the roots."""

    feature_keeps: List[Optional[torch.Tensor]]
    edge_keeps: Optional[List[torch.Tensor]]
    perm: Optional[torch.Tensor] = None


def draw_view(generator: torch.Generator, hop_feats: Sequence[torch.Tensor],
              masks: Sequence[torch.Tensor], *, feature_drop_rate: float = 0.2,
              edge_drop_rate: float = 0.2, corrupt: bool = False) -> ViewDraw:
    """The draws of ``augment_view`` (and, with ``corrupt``, a random
    permutation of the roots: TBGRL's negative view)."""
    feature_keeps = [draw_feature_keep(generator, f, feature_drop_rate)
                     for f in hop_feats]
    edge_keeps = draw_edge_keeps(generator, masks, edge_drop_rate)
    perm = None
    if corrupt:
        perm = torch.randperm(hop_feats[0].shape[0], generator=generator,
                              device=generator.device).to(
                                  hop_feats[0].device)
    return ViewDraw(feature_keeps, edge_keeps, perm)


def apply_view(hop_feats: Sequence[torch.Tensor],
               masks: Sequence[torch.Tensor], draw: ViewDraw
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One augmented view from its draws: each level's columns kept, the
    slots kept, and the roots' rows permuted for a corrupted view."""
    feats = [apply_feature_keep(f, k)
             for f, k in zip(hop_feats, draw.feature_keeps)]
    if draw.perm is not None:
        feats[0] = feats[0][draw.perm]
    return feats, apply_edge_keeps(masks, draw.edge_keeps)


def augment_view(generator: torch.Generator,
                 hop_feats: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor], *,
                 feature_drop_rate: float = 0.2,
                 edge_drop_rate: float = 0.2
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One augmented view of a sampled neighbourhood: per-level feature
    masking and neighbour-slot dropout."""
    return apply_view(hop_feats, masks, draw_view(
        generator, hop_feats, masks, feature_drop_rate=feature_drop_rate,
        edge_drop_rate=edge_drop_rate))
