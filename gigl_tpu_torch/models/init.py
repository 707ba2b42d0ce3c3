"""Seeded weight initialization as flax's defaults for the port's modules.

:func:`init_params` works on any module tree (a ``GNNEncoder``, a
``LinkPredictionGNN``), with or without a trainer. It draws from a seeded
``torch.Generator`` on the CPU, so the same seed gives the same weights on
every device:

- every ``nn.Linear`` weight: flax ``Dense``'s lecun-normal, a normal
  truncated to [-2, 2] times sqrt(1 / fan_in) / 0.8796; biases 0;
- glorot-uniform, uniform in +-sqrt(6 / (fan_in + fan_out)) with flax's
  fans (fan_in = shape[-2] * r, fan_out = shape[-1] * r, r the product of
  the leading dims): GAT's ``att``, ``att_src``, ``att_dst`` ``[H, Dh]``
  (fans H and Dh), SimpleHGN's ``att_*`` ``[1, 1, H, dk]`` and ``w_rel``,
  RGCN's ``basis_coeff``, HGT's ``watt_*`` / ``wmsg_*`` ``[H, dk, dk]``
  (fans H·dk each);
- SimpleHGN's ``edge_emb``: normal with std 0.02;
- HGT's ``skip_*`` and ``prior_*``: 1;
- conv-level ``bias`` and GIN's ``eps``: 0;
- batch norm: ``scale`` 1, ``bias`` 0, and its running ``mean`` 0 and
  ``var`` 1;
- an embedding table ``embedding`` [V, D]: flax ``Embed``'s
  variance-scaling normal (truncated, fan_in = D, so std sqrt(1 / D));
- an LSTM cell: its input kernels lecun-normal (as every ``nn.Linear``),
  its hidden kernels ``h{i,f,g,o}`` orthogonal (flax ``orthogonal``: the
  Q of a normal matrix's QR with R's diagonal signs), its biases 0.

The distributions are flax's; the bits are not.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gigl_tpu_torch.models.layers import BatchNorm, LSTMCell

# flax's lecun_normal: a normal truncated to [-2, 2] whose std is
# sqrt(1 / fan_in) after truncation (0.8796... is the std of the truncated
# unit normal).
_TRUNC_STD = 0.87962566103423978
_GLOROT = ("att", "att_src", "att_dst", "att_rel", "w_rel", "basis_coeff",
           "watt_", "wmsg_")
_ZEROS = ("bias", "eps")
_ONES = ("skip_", "prior_", "scale")


def _kind(name: str) -> str:
    """A non-Linear parameter's initializer, by its (flax) name; names
    ending in "_" above are prefixes (one parameter per type)."""
    for kind, names in (("glorot", _GLOROT), ("zeros", _ZEROS),
                        ("ones", _ONES), ("normal", ("edge_emb",)),
                        ("embed", ("embedding",))):
        if any(name.startswith(n) if n.endswith("_") else name == n
               for n in names):
            return kind
    raise ValueError(f"no initializer for parameter {name!r}")


def init_params(model: nn.Module, seed: int = 0) -> None:
    """Initialize ``model``'s parameters in place, deterministically from
    ``seed`` (see module docstring)."""
    gen = torch.Generator().manual_seed(int(seed))
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2, 2))

    def truncated(shape, fan_in):
        u = torch.rand(shape, generator=gen, dtype=torch.float64) * (
            hi - lo) + lo
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
        return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)

    recurrent = {id(lin) for mod in model.modules()
                 if isinstance(mod, LSTMCell) for lin in mod.recurrent()}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                if id(mod) in recurrent:
                    a = torch.randn(mod.weight.shape, generator=gen,
                                    dtype=torch.float64)
                    q, r = torch.linalg.qr(a)
                    mod.weight.copy_(q * torch.sign(torch.diagonal(r)))
                else:
                    mod.weight.copy_(truncated(mod.weight.shape,
                                               mod.in_features))
                if mod.bias is not None:
                    mod.bias.zero_()
                continue
            if isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
            for name, p in mod.named_parameters(recurse=False):
                kind = _kind(name)
                if kind == "glorot":
                    r = math.prod(p.shape[:-2])
                    fan_in, fan_out = p.shape[-2] * r, p.shape[-1] * r
                    limit = math.sqrt(6.0 / (fan_in + fan_out))
                    u = torch.rand(p.shape, generator=gen,
                                   dtype=torch.float64)
                    p.copy_((2.0 * u - 1.0) * limit)
                elif kind == "embed":
                    p.copy_(truncated(p.shape, p.shape[-1]))
                elif kind == "normal":
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen,
                                               dtype=torch.float64))
                else:
                    p.fill_(1.0 if kind == "ones" else 0.0)
