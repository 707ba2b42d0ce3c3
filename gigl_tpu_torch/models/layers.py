"""Normalization, activation and dropout helpers (port of ``l2_normalize``
in ``gigl_tpu/models/layers.py``; ``jax.nn.leaky_relu``; flax
``nn.Dropout``)."""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """x / sqrt(max(sum(x^2), eps)) along ``dim``."""
    return x * torch.rsqrt(
        torch.clamp((x * x).sum(dim=dim, keepdim=True), min=eps))


def leaky_relu(z: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(z >= 0, z, slope * z)``. Its
    derivative at exactly 0 is 1, as JAX's (``F.leaky_relu``'s is the
    slope there), the convention the port's attention kernels share."""
    return torch.where(z >= 0, z, negative_slope * z)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), the keep mask drawn from ``generator`` (its bits differ
    from flax's); the identity in eval mode or at rate 0."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = (u >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)
