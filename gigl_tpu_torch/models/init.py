"""Seeded weight initialization as flax's defaults for the port's modules.

:func:`init_params` works on any module tree (a ``GNNEncoder``, a
``LinkPredictionGNN``), with or without a trainer. It draws from a seeded
``torch.Generator`` on the CPU, so the same seed gives the same weights on
every device:

- every ``nn.Linear`` weight: flax ``Dense``'s lecun-normal, a normal
  truncated to [-2, 2] times sqrt(1 / fan_in) / 0.8796; biases 0;
- GAT's ``att``, ``att_src``, ``att_dst`` ``[H, Dh]``: glorot-uniform,
  uniform in +-sqrt(6 / (H + Dh)) (flax ``glorot_uniform`` with fan_in =
  H, fan_out = Dh);
- conv-level ``bias`` and GIN's ``eps``: 0.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax's lecun_normal: a normal truncated to [-2, 2] whose std is
# sqrt(1 / fan_in) after truncation (0.8796... is the std of the truncated
# unit normal).
_TRUNC_STD = 0.87962566103423978
_GLOROT = ("att", "att_src", "att_dst")
_ZEROS = ("bias", "eps")


def init_params(model: nn.Module, seed: int = 0) -> None:
    """Initialize ``model``'s parameters in place, deterministically from
    ``seed`` (see module docstring)."""
    gen = torch.Generator().manual_seed(int(seed))
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2, 2))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                u = torch.rand(mod.weight.shape, generator=gen,
                               dtype=torch.float64) * (hi - lo) + lo
                z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(
                    -2.0, 2.0)
                std = math.sqrt(1.0 / mod.in_features) / _TRUNC_STD
                mod.weight.copy_(z * std)
                if mod.bias is not None:
                    mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name in _GLOROT:
                    fan_in, fan_out = p.shape[-2], p.shape[-1]
                    limit = math.sqrt(6.0 / (fan_in + fan_out))
                    u = torch.rand(p.shape, generator=gen,
                                   dtype=torch.float64)
                    p.copy_((2.0 * u - 1.0) * limit)
                elif name in _ZEROS:
                    p.zero_()
                else:
                    raise ValueError(f"init_params: no initializer for "
                                     f"{type(mod).__name__}.{name}")
