"""Per-destination multi-head attention over indexed neighbor slots:
kernel K7 ``fanout_attention``.

``csrc/fanout_attention.cu`` replaces what ``gigl_tpu/models/convs.py``
computes between the projections in ``GATConv.block`` (:292-310) and
``TransformerConv.block`` (:361-377), with ``masked_softmax``
(``gigl_tpu/ops/fanout.py:83-95``). Rows are ``[H * Dh]``, head-major:

- ``xd [n, H*Dh]``: the projected destination rows (GAT ``lin_dst``,
  Transformer ``lin_q``);
- ``ks``, ``vs [M, H*Dh]``: the projected source tables (GAT: both
  ``lin_src``; Transformer: ``lin_k``, ``lin_v``), read through
  ``nbr [n, W]`` int32 under ``mask [n, W]``;
- ``mode`` "gat": logit = leaky_relu(ks·att_src + xd·att_dst, slope);
  "gatv2": att · leaky_relu(ks + xd, slope); "transformer": xd·ks /
  sqrt(Dh); then the masked softmax over the W slots and the weighted sum
  of the ``vs`` rows -> ``[n, H*Dh]`` in xd's type.

fp32 arithmetic, one rounding. :func:`_fanout_attention_plain` is the
plain twin (CPU tensors only). The wrapper is forward-only: an
``autograd.Function`` whose backward raises (ROADMAP B8 backward).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.fanout import masked_softmax

MODES = {"gat": 0, "gatv2": 1, "transformer": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64            # kChunk of the kernel: shared memory per block
_SMEM_LIMIT = 48 * 1024
B8_BACKWARD = ("the backward of fanout_attention (K7) is not ported yet: "
               "ROADMAP B8 backward (autodiff of gigl_tpu/models/convs.py "
               "GATConv.block / TransformerConv.block)")


def _fanout_attention_plain(xd, ks, vs, nbr, mask, mode, heads, att=None,
                            att2=None, negative_slope=0.2):
    """Plain twin of K7: fp32 arithmetic, one rounding to xd's type."""
    idx = nbr.long()
    n, w = nbr.shape
    dh = ks.shape[1] // heads
    k = ks[idx].float().reshape(n, w, heads, dh)
    q = xd.float().reshape(n, 1, heads, dh)
    if mode == "gat":
        logits = F.leaky_relu((k * att.reshape(heads, dh)).sum(-1) + (
            q * att2.reshape(heads, dh)).sum(-1), negative_slope)
    elif mode == "gatv2":
        logits = (F.leaky_relu(k + q, negative_slope)
                  * att.reshape(heads, dh)).sum(-1)
    else:
        logits = (q * k).sum(-1) / math.sqrt(dh)             # [n, W, H]
    alpha = masked_softmax(logits.transpose(1, 2), mask[:, None, :],
                           axis=-1)                          # [n, H, W]
    v = vs[idx].float().reshape(n, w, heads, dh)
    out = torch.einsum("nhw,nwhd->nhd", alpha, v)
    return out.reshape(n, heads * dh).to(xd.dtype)


def _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, heads, att, att2,
                          negative_slope):
    """K7 launch (plain twin for CPU tensors)."""
    if xd.device.type == "cpu":
        return _fanout_attention_plain(xd, ks, vs, nbr, mask, mode, heads,
                                       att, att2, negative_slope)
    atts = tuple(a for a in (att, att2) if a is not None)
    device = _build.require_cuda("fanout_attention", xd, ks, vs, nbr, mask,
                                 *atts)
    n, hd = xd.shape
    if (nbr.dim() != 2 or mask.shape != nbr.shape or nbr.shape[0] != n
            or ks.dim() != 2 or ks.shape[1] != hd or vs.shape != ks.shape):
        raise ValueError("fanout_attention: expected xd [n, H*Dh], ks and vs "
                         "[M, H*Dh], nbr and mask [n, W]")
    if nbr.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError("fanout_attention: nbr must be int32 and mask bool")
    if xd.dtype not in _DTYPES or ks.dtype != xd.dtype \
            or vs.dtype != xd.dtype:
        raise ValueError("fanout_attention: xd, ks and vs must share one "
                         "dtype, fp32 or bf16")
    if hd % heads:
        raise ValueError(f"fanout_attention: {hd} not divisible by {heads}")
    need = {"gat": 2, "gatv2": 1, "transformer": 0}[mode]
    if len(atts) != need or any(a.dtype != torch.float32 or a.numel() != hd
                                for a in atts):
        raise ValueError(f"fanout_attention: mode {mode!r} takes {need} f32 "
                         "attention vector(s) of H*Dh values")
    if 4 * (3 * hd + heads * _CHUNK + 4 * heads) > _SMEM_LIMIT:
        raise ValueError(f"fanout_attention: H*Dh = {hd} exceeds the "
                         "kernel's shared memory")
    w = nbr.shape[1]
    out = torch.empty((n, hd), dtype=xd.dtype, device=device)
    _build.launch("fanout_attention", "gigl_fanout_attention", device,
                  xd.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  nbr.data_ptr(), mask.data_ptr(), _build.ptr(att),
                  _build.ptr(att2), out.data_ptr(), n, w, heads, hd // heads,
                  _DTYPES[xd.dtype], MODES[mode], float(negative_slope),
                  float(math.sqrt(hd // heads)))
    return out


class FanoutAttention(torch.autograd.Function):
    """K7 forward; the backward raises (ROADMAP B8 backward)."""

    @staticmethod
    def forward(ctx, xd, ks, vs, nbr, mask, mode, heads, att, att2,
                negative_slope):
        return _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, heads, att,
                                     att2, negative_slope)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(B8_BACKWARD)


def fanout_attention(xd: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                     nbr: torch.Tensor, mask: torch.Tensor, mode: str,
                     heads: int, att: Optional[torch.Tensor] = None,
                     att2: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2) -> torch.Tensor:
    """K7 (see module docstring). ``att``/``att2``: GAT ``att_src`` /
    ``att_dst`` [H, Dh]; GATv2 ``att`` [H, Dh]; Transformer none."""
    if mode not in MODES:
        raise ValueError(f"Unknown attention mode {mode!r}")

    def flat(a):
        return None if a is None else a.float().reshape(-1).contiguous()

    return FanoutAttention.apply(xd.contiguous(), ks.contiguous(),
                                 vs.contiguous(), nbr, mask, mode, heads,
                                 flat(att), flat(att2), negative_slope)
