"""Message-passing convolution layers (port of ``gigl_tpu/models/convs.py``).

Only ``SAGEConv`` is ported so far, with its dense fanout-block path
(``block``) and its cached-hop path (``block_cached``). Parameters are fp32;
the layer computes in ``dtype`` the way flax's ``Dense(dtype=bf16,
param_dtype=fp32)`` does: input, weight and bias are cast to the compute
type at the call (no autocast).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.ops.fanout import masked_max, masked_mean, masked_sum


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lin(x)`` computed in ``dtype`` from fp32 parameters."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class SAGEConv(nn.Module):
    """GraphSAGE conv: W_self x + b + W_nbr agg(neighbors)."""

    def __init__(self, in_dim: int, out_dim: int, aggr: str = "mean",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if aggr not in ("mean", "sum", "max"):
            raise ValueError(f"Unknown SAGE aggr {aggr!r}")
        self.aggr = aggr
        self.dtype = dtype
        self.lin_self = nn.Linear(in_dim, out_dim, bias=use_bias)
        self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

    def _combine(self, x_dst, agg):
        return (linear(self.lin_self, x_dst, self.dtype)
                + linear(self.lin_nbr, agg, self.dtype))

    @property
    def cached_agg_kind(self) -> str:
        if self.aggr not in ("mean", "sum"):
            raise ValueError(f"SAGE aggr {self.aggr!r} is not cacheable")
        return self.aggr

    def block_cached(self, x_dst, agg, degrees_dst=None):
        """Cached-hop path: ``agg`` [N, Din] is the precomputed
        sampled-neighbor aggregate (ops/hopcache.py)."""
        return self._combine(x_dst, agg.to(x_dst.dtype))

    def block(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        """x_dst [N, Din], nbr [N, K, Din], mask [N, K] -> [N, Dout]."""
        if self.aggr == "mean":
            agg = masked_mean(nbr, mask)
        elif self.aggr == "max":
            agg = masked_max(nbr, mask)
        else:
            agg = masked_sum(nbr, mask)
        return self._combine(x_dst, agg)

    def forward(self, x_dst, nbr, mask, edge_attr=None, degrees=None):
        return self.block(x_dst, nbr, mask, edge_attr, degrees)
