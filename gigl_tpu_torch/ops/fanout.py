"""Dense fanout-block neighborhood ops (port of ``gigl_tpu/ops/fanout.py``).

Sampled neighborhoods are static-shape dense blocks — a neighbor index
matrix ``[N, K]`` plus a validity mask — so aggregation is gather -> masked
reduce over K -> matmul.

Kernel K4 ``masked_reduce`` (``csrc/masked_reduce.cu``) replaces
``masked_mean`` / ``masked_sum`` / ``masked_max`` (:34-53): ``[M, K, D]``
(fp32 or bf16) and a mask ``[M, K]`` -> ``[M, D]``, accumulated in fp32 and
rounded once to the input type. :func:`_masked_reduce_plain` is its plain
twin, used for CPU tensors only. A row with no valid slot reduces to 0.

Kernel K4b ``masked_reduce_bwd`` (same source) is its backward, which the
reference gets from autodiff: ``grad_out [M, D]`` -> ``grad_x [M, K, D]``
(mean: ``mask * g / max(cnt, 1)``; sum: ``mask * g``; max: ``g`` shared
equally among the valid slots equal to the output, as ``jax.vjp`` of
``jnp.max`` shares it; all-masked rows get 0), with
:func:`_masked_reduce_bwd_plain` as its twin. :func:`masked_reduce` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is K4b
(the plain twins for CPU tensors).

:func:`masked_softmax` (``:83-95``) is plain PyTorch; the attention convs
reach it through kernel K7 (``ops/attention.py``), whose plain twin uses it.
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


def _masked_reduce_fwd(x: torch.Tensor, mask: torch.Tensor,
                       op: str) -> torch.Tensor:
    """K4 launch (plain twin for CPU tensors)."""
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


def _masked_reduce_bwd_plain(grad_out, mask, op, x=None, out=None):
    """Plain twin of K4b: fp32 arithmetic, one rounding to x's type."""
    g = grad_out.float()[:, None, :]
    m = mask[..., None]
    if op == "max":
        ties = m & (x.float() == out.float()[:, None, :])
        share = g / ties.sum(dim=1, keepdim=True).clamp(min=1).float()
        grad = torch.where(ties, share, 0.0)
    else:
        if op == "mean":
            g = g / mask.sum(dim=1).clamp(min=1).float()[:, None, None]
        grad = torch.where(m, g, 0.0)
    return grad.to(grad_out.dtype)


def masked_reduce_bwd(grad_out: torch.Tensor, mask: torch.Tensor, op: str,
                      x: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4b: grad_out [M, D], mask [M, K] -> grad_x [M, K, D] in
    grad_out's type. ``x`` and ``out`` (the forward's input and result)
    are needed for max only."""
    if op not in _OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if op == "max" and (x is None or out is None):
        raise ValueError("masked_reduce_bwd: max needs the forward's x, out")
    if grad_out.device.type == "cpu":
        return _masked_reduce_bwd_plain(grad_out, mask, op, x, out)
    saved = (x, out) if op == "max" else ()
    device = _build.require_cuda("masked_reduce_bwd", grad_out, mask, *saved)
    if grad_out.dim() != 2 or mask.dim() != 2 or mask.dtype != torch.bool:
        raise ValueError("masked_reduce_bwd: expected grad_out [M, D] and "
                         "bool mask [M, K]")
    (m, k), d = mask.shape, grad_out.shape[1]
    if grad_out.shape[0] != m or any(
            t.dtype != grad_out.dtype for t in saved) or (saved and (
                x.shape != (m, k, d) or out.shape != (m, d))):
        raise ValueError("masked_reduce_bwd: expected grad_out [M, D], mask "
                         "[M, K] and, for max, x [M, K, D] and out [M, D] "
                         "of grad_out's type")
    if grad_out.dtype not in _DTYPES:
        raise ValueError(f"masked_reduce_bwd: dtype {grad_out.dtype} not "
                         "supported")
    if (d * grad_out.element_size()) % 16:
        raise ValueError("masked_reduce_bwd: rows must be a multiple of 16 "
                         "bytes")
    grad_x = torch.empty((m, k, d), dtype=grad_out.dtype, device=device)
    _build.launch("masked_reduce_bwd", "gigl_masked_reduce_bwd", device,
                  grad_out.data_ptr(), mask.data_ptr(), _build.ptr(x),
                  _build.ptr(out), grad_x.data_ptr(), m, k, d,
                  _DTYPES[grad_out.dtype], _OPS[op])
    return grad_x


class MaskedReduce(torch.autograd.Function):
    """``fwd(x, mask, op)`` with ``bwd(grad_out, mask, op, x, out)`` as
    its gradient. :func:`masked_reduce` passes the K4 / K4b wrappers; a
    caller can pass the plain twins to run both directions plainly on any
    device."""

    @staticmethod
    def forward(ctx, x, mask, op, fwd, bwd):
        out = fwd(x, mask, op)
        ctx.op, ctx.bwd = op, bwd
        if op == "max":
            ctx.save_for_backward(mask, x, out)
        else:
            ctx.save_for_backward(mask)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        mask, *saved = ctx.saved_tensors
        grad_x = ctx.bwd(grad_out.contiguous(), mask, ctx.op, *saved)
        return grad_x, None, None, None, None


def masked_reduce(x: torch.Tensor, mask: torch.Tensor, op: str) -> torch.Tensor:
    """K4: x [M, K, D], mask [M, K] bool -> [M, D] mean/sum/max over valid
    K; differentiable in x through K4b."""
    if op not in _OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    return MaskedReduce.apply(x, mask, op, _masked_reduce_fwd,
                              masked_reduce_bwd)


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


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   axis: int = -1) -> torch.Tensor:
    """Softmax over ``axis`` with invalid slots at zero weight (plain
    PyTorch, as ``gigl_tpu/ops/fanout.py:83-95``): masked logits are filled
    with ``finfo(dtype).min`` (not -inf), the max carries no gradient, the
    denominator is clamped at 1e-16, and rows with no valid slot get 0.
    logits, mask: [..., K]."""
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(mask, logits, neg)
    m = masked.amax(dim=axis, keepdim=True).detach()
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    denom = e.sum(dim=axis, keepdim=True)
    return e / torch.clamp(denom, min=1e-16)
