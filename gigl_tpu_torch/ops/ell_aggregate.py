"""Indexed masked neighbor aggregation: kernel K6 ``ell_aggregate``.

``csrc/ell_aggregate.cu`` replaces ``gigl_tpu/ops/ell.py`` ``ell_gather``
(:237-247) fused with the masked reduce each conv applies to the gathered
``[n, W, D]`` block (``gigl_tpu/ops/fanout.py:34-53``; GCN's weighted sum,
``gigl_tpu/models/convs.py:107-112``), without writing that block:

    out[i] = reduce_{j < W, mask[i, j]} w_ij * x[nbr[i, j]]

``reduce`` is ``mean``, ``sum`` or ``max`` (w = 1), or ``gcn``: a sum with
``w_ij = rsqrt(deg_dst[i] + 1) * rsqrt(deg_tab[nbr[i, j]] + 1)``. fp32
accumulation, one rounding to x's type; rows with no valid slot give 0.
:func:`_ell_aggregate_plain` is its plain twin, run for CPU tensors only.

The wrapper is forward-only: it is a ``torch.autograd.Function`` whose
backward raises, so a graph built through it cannot train with silently
missing gradients (the backward over the transpose tables is ROADMAP B6
backward).
"""

from __future__ import annotations

from typing import Optional

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain

OPS = {"mean": 0, "sum": 1, "max": 2, "gcn": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
B6_BACKWARD = ("the backward of ell_aggregate (K6) is not ported yet: "
               "ROADMAP B6 backward (gigl_tpu/ops/ell.py:255-283)")


def _ell_aggregate_plain(x, nbr, mask, op, deg_dst=None, deg_tab=None):
    """Plain twin of K6: fp32 arithmetic, one rounding to x's type."""
    feats = x[nbr.long()].float()                        # [n, W, D]
    if op == "gcn":
        w = torch.rsqrt(deg_dst.float() + 1.0)[:, None] * torch.rsqrt(
            deg_tab.float()[nbr.long()] + 1.0)
        feats, op = feats * w[..., None], "sum"
    return _masked_reduce_plain(feats, mask, op).to(x.dtype)


def _ell_aggregate_fwd(x, nbr, mask, op, deg_dst=None, deg_tab=None):
    """K6 launch (plain twin for CPU tensors)."""
    if x.device.type == "cpu":
        return _ell_aggregate_plain(x, nbr, mask, op, deg_dst, deg_tab)
    degs = (deg_dst, deg_tab) if op == "gcn" else ()
    device = _build.require_cuda("ell_aggregate", x, nbr, mask, *degs)
    if x.dim() != 2 or nbr.dim() != 2 or mask.shape != nbr.shape:
        raise ValueError("ell_aggregate: expected x [M, D], nbr and mask "
                         f"[n, W], got {tuple(x.shape)} / {tuple(nbr.shape)} "
                         f"/ {tuple(mask.shape)}")
    if nbr.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("ell_aggregate: nbr must be int32 and mask bool")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ell_aggregate: dtype {x.dtype} not supported")
    (n, w), d = nbr.shape, x.shape[1]
    if op == "gcn" and (deg_dst.dtype != torch.float32 or deg_dst.shape != (n,)
                        or deg_tab.dtype != torch.float32
                        or deg_tab.shape != (x.shape[0],)):
        raise ValueError("ell_aggregate: gcn needs f32 deg_dst [n] and "
                         "deg_tab [M]")
    out = torch.empty((n, d), dtype=x.dtype, device=device)
    vec = int((d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    _build.launch("ell_aggregate", "gigl_ell_aggregate", device,
                  x.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                  _build.ptr(deg_dst if degs else None),
                  _build.ptr(deg_tab if degs else None), out.data_ptr(),
                  n, w, d, _DTYPES[x.dtype], OPS[op], vec)
    return out


class EllAggregate(torch.autograd.Function):
    """K6 forward; the backward raises (ROADMAP B6 backward)."""

    @staticmethod
    def forward(ctx, x, nbr, mask, op, deg_dst, deg_tab):
        return _ell_aggregate_fwd(x, nbr, mask, op, deg_dst, deg_tab)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(B6_BACKWARD)


def ell_aggregate(x: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                  op: str, deg_dst: Optional[torch.Tensor] = None,
                  deg_tab: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: x [M, D], nbr [n, W] int32 rows of x, mask [n, W] bool ->
    [n, D]; ``op`` "gcn" also takes deg_dst [n] and deg_tab [M] (f32
    in-degrees, without the self loop)."""
    if op not in OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if op == "gcn" and (deg_dst is None or deg_tab is None):
        raise ValueError("ell_aggregate: gcn needs deg_dst and deg_tab")
    return EllAggregate.apply(x.contiguous(), nbr, mask, op, deg_dst,
                              deg_tab)
