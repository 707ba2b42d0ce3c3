"""Self-supervised task heads (port of ``gigl_tpu/models/ssl_tasks.py``).

Each head is an ``nn.Module`` owning its projector / predictor / decoder
layers (flax's names: ``proj`` and ``predictor`` of ``fc1``, ``fc2``;
``dec1``, ``dec2``), whose ``forward`` returns its loss over encoder
outputs (``losses/losses.py``). The layers compute in ``dtype`` from fp32
parameters; flax infers their input widths, the port takes the
embedding width ``in_dim`` (and ``feature_dim`` for the reconstruction).
BGRL and TBGRL take the target views' embeddings from an EMA copy of the
encoder, kept by the caller and moved by :func:`ema_update`. The
stop-gradients are ``detach()``.

``MultiTaskSSL`` sums the losses of named ``WeightedTask``s, each weighted
and fed the named tensors it asks for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.losses.losses import (
    alignment_loss,
    bgrl_loss,
    feature_reconstruction_loss,
    gbt_loss,
    grace_loss,
    tbgrl_loss,
    uniformity_loss,
    whitening_decorrelation_loss,
)
from gigl_tpu_torch.models.convs import linear


class _Projector(nn.Module):
    """Dense, elu, Dense: the contrastive projection head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.elu(linear(self.fc1, x, self.dtype)),
                      self.dtype)


class GraceTask(nn.Module):
    """GRACE: both views projected, InfoNCE between them."""

    def __init__(self, in_dim: int, hidden_dim: int = 128, out_dim: int = 64,
                 temperature: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temperature = temperature
        self.proj = _Projector(in_dim, hidden_dim, out_dim, dtype)

    def forward(self, z1, z2):
        return grace_loss(self.proj(z1), self.proj(z2),
                          temperature=self.temperature)


class WhiteningDecorrelationTask(nn.Module):
    """W-MSE-style whitening decorrelation of the projected views."""

    def __init__(self, in_dim: int, hidden_dim: int = 128, out_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = _Projector(in_dim, hidden_dim, out_dim, dtype)

    def forward(self, z1, z2):
        return whitening_decorrelation_loss(self.proj(z1), self.proj(z2))


class GBTTask(nn.Module):
    """Graph Barlow Twins on the views as they are (no parameters)."""

    def forward(self, z1, z2):
        return gbt_loss(z1, z2)


class FeatureReconstructionTask(nn.Module):
    """Decode embeddings back to the input features (``dec2(relu(dec1(z)))``),
    scaled cosine error against them."""

    def __init__(self, in_dim: int, feature_dim: int, hidden_dim: int = 128,
                 gamma: float = 2.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = gamma
        self.dtype = dtype
        self.dec1 = nn.Linear(in_dim, hidden_dim)
        self.dec2 = nn.Linear(hidden_dim, feature_dim)

    def forward(self, z, x):
        h = torch.relu(linear(self.dec1, z, self.dtype))
        return feature_reconstruction_loss(linear(self.dec2, h, self.dtype),
                                           x, gamma=self.gamma)


class BGRLTask(nn.Module):
    """BGRL: each online view's prediction against the other view's EMA
    target embedding, both directions."""

    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.predictor = _Projector(in_dim, hidden_dim, in_dim, dtype)

    def forward(self, online_z1, online_z2, target_z1, target_z2):
        p1, p2 = self.predictor(online_z1), self.predictor(online_z2)
        return bgrl_loss(p1, target_z2.detach()) + bgrl_loss(
            p2, target_z1.detach())


class TBGRLTask(nn.Module):
    """Triplet-BGRL: BGRL with a corrupted negative view pushed away."""

    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.predictor = _Projector(in_dim, hidden_dim, in_dim, dtype)

    def forward(self, online_z1, online_z2, target_z1, target_z2, neg_z):
        p1, p2 = self.predictor(online_z1), self.predictor(online_z2)
        neg = neg_z.detach()
        return (tbgrl_loss(p1, target_z2.detach(), neg)
                + tbgrl_loss(p2, target_z1.detach(), neg))


class DirectAUTask(nn.Module):
    """DirectAU: alignment of positive pairs plus ``gamma`` times the mean
    uniformity of both sides."""

    def __init__(self, gamma: float = 1.0):
        super().__init__()
        self.gamma = gamma

    def forward(self, q, pos):
        a = alignment_loss(q, pos)
        u = 0.5 * (uniformity_loss(q) + uniformity_loss(pos))
        return a + self.gamma * u


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, decay: float) -> None:
    """The target network's EMA step, in place: every parameter and
    buffer ``t <- decay * t + (1 - decay) * o``, as the reference writes
    it."""
    o_state = online.state_dict()
    for name, t in target.state_dict().items():
        t.copy_(decay * t + (1.0 - decay) * o_state[name])


@dataclass
class WeightedTask:
    """One entry of the multi-task container: a head, its weight, and the
    names of the tensors its ``forward`` takes (e.g. ``("z1", "z2")``)."""

    name: str
    module: nn.Module
    weight: float = 1.0
    inputs: Tuple[str, ...] = ("z1", "z2")


class MultiTaskSSL(nn.Module):
    """Weighted sum of SSL task losses; the heads are registered under
    their task names."""

    def __init__(self, tasks: Sequence[WeightedTask]):
        super().__init__()
        names = [t.name for t in tasks]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate task names: {names}")
        self.tasks = list(tasks)
        self.heads = nn.ModuleDict({t.name: t.module for t in tasks})

    def loss(self, **tensors) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the weighted sum in fp32, each task's loss)."""
        total = None
        per_task = {}
        for t in self.tasks:
            loss = self.heads[t.name](*[tensors[k] for k in t.inputs]).to(
                torch.float32)
            per_task[t.name] = loss
            total = t.weight * loss if total is None else total + (
                t.weight * loss)
        return total, per_task
