"""Normalization helpers (port of ``l2_normalize`` in
``gigl_tpu/models/layers.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """x / sqrt(max(sum(x^2), eps)) along ``dim``."""
    return x * torch.rsqrt(
        torch.clamp((x * x).sum(dim=dim, keepdim=True), min=eps))
