"""Dense fanout-block neighborhood ops (port of ``gigl_tpu/ops/fanout.py``).

Sampled neighborhoods are static-shape dense blocks — a neighbor index
matrix ``[N, K]`` plus a validity mask — so aggregation is gather -> masked
reduce over K -> matmul.

Kernel K4 ``masked_reduce`` (``csrc/masked_reduce.cu``) replaces
``masked_mean`` / ``masked_sum`` / ``masked_max`` (:34-53): ``[M, K, D]``
(fp32 or bf16) and a mask ``[M, K]`` -> ``[M, D]``, accumulated in fp32 and
rounded once to the input type. :func:`_masked_reduce_plain` is its plain
twin, used for CPU tensors only. A row with no valid slot reduces to 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.gather import gather_rows

_OPS = {"mean": 0, "sum": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_neighbors(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """x: [M, D] node features; nbr_idx: [N, K] -> [N, K, D]."""
    return gather_rows(x, nbr_idx.to(torch.int32))[0]


def _masked_reduce_plain(x: torch.Tensor, mask: torch.Tensor, op: str):
    acc = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    m = mask[..., None]
    if op == "max":
        out = torch.where(m, acc, float("-inf")).amax(dim=1)
        out = torch.where(mask.any(dim=1, keepdim=True), out, 0.0)
    else:
        out = torch.where(m, acc, 0.0).sum(dim=1)
        if op == "mean":
            out = out / mask.sum(dim=1, keepdim=True).clamp(min=1).to(acc.dtype)
    return out.to(x.dtype)


def masked_reduce(x: torch.Tensor, mask: torch.Tensor, op: str) -> torch.Tensor:
    """K4: x [M, K, D], mask [M, K] bool -> [M, D] mean/sum/max over valid K."""
    if op not in _OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if x.device.type == "cpu":
        return _masked_reduce_plain(x, mask, op)
    device = _build.require_cuda("masked_reduce", x, mask)
    if x.dim() != 3 or mask.shape != x.shape[:2] or mask.dtype != torch.bool:
        raise ValueError("masked_reduce: expected x [M, K, D] and bool mask "
                         f"[M, K], got {tuple(x.shape)} / {tuple(mask.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"masked_reduce: dtype {x.dtype} not supported")
    m, k, d = x.shape
    if (d * x.element_size()) % 16:
        raise ValueError("masked_reduce: rows must be a multiple of 16 bytes")
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    _build.launch("masked_reduce", "gigl_masked_reduce", device,
                  x.data_ptr(), mask.data_ptr(), out.data_ptr(), m, k, d,
                  _DTYPES[x.dtype], _OPS[op])
    return out


def masked_mean(nbr_feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """nbr_feats: [N, K, D]; mask: [N, K] bool -> [N, D] mean over valid K."""
    return masked_reduce(nbr_feats, mask, "mean")


def masked_sum(nbr_feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return masked_reduce(nbr_feats, mask, "sum")


def masked_max(nbr_feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """All-masked rows (isolated nodes) -> 0."""
    return masked_reduce(nbr_feats, mask, "max")


def fanout_aggregate(
    x: torch.Tensor,
    nbr_idx: torch.Tensor,
    mask: torch.Tensor,
    *,
    reduce: str = "mean",
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[n] = reduce_k x[nbr_idx[n, k]] over valid k.
    x: [M, D]; nbr_idx/mask (+ optional edge_weight): [N, K] -> [N, D]."""
    feats = gather_neighbors(x, nbr_idx)
    if edge_weight is not None:
        feats = feats * edge_weight[..., None]
    return masked_reduce(feats, mask, reduce)
