"""Per-destination multi-head attention over indexed neighbor slots and its
backward: kernels K7 ``fanout_attention`` and K7b ``fanout_attention_bwd``.

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

Two optional operands: ``he [E, H*Dh]``, an edge row per slot read
through ``eidx [n, W]`` (an ELL bucket's edge slots) and added to the
slot's key and value rows (EdgeAttrGAT's ``lin_src(x_j) + lin_edge(e)``,
``convs.py:296-298``; the Transformer's ``k + e`` and ``v + e``,
``:367-370``), and ``bias [W, H]`` fp32 (GAT v1 only), a logit term per
slot column added before the leaky_relu (SimpleHGN's relation term,
``gigl_tpu/models/hetero_convs.py:221-228``).

fp32 arithmetic, one rounding. :func:`_fanout_attention_plain` is the
plain twin (CPU tensors only).

``csrc/fanout_attention_bwd.cu`` (K7b) is its backward in every mode (the
reference's autodiff): it recomputes alpha from the (max, denominator) K7
saved per (row, head) and writes ``d_xd``, the attention vectors'
gradients and, per slot, either the entry's alpha and logit cotangent (the
ELL graph, for K6b's transpose walk: weighted mode, or its GATv2 mode) or
the key / value rows' gradients (a dense block, where every source row is
read once); with a bias, the identity layout also writes the entry's
pre-activation cotangent, the bias's cotangent per slot.
:func:`_fanout_attention_bwd_plain` is its twin.

Two entry points, both trainable:

- :func:`fanout_attention_block` over a dense block (slot j of row i reads
  source row ``i * W + j``), with an optional ``bias``: K7 / K7b (the
  bias's gradient is K7b's per-slot coefficient summed over the rows);
- :func:`fanout_attention_ell` over an ELL graph, with an optional edge
  table ``he`` in COO edge order: K7 per bucket, backward K7b per bucket
  then K6b (``ops/ell_aggregate.py``) for the source tables and K11
  (``ops/ell.py`` ``ell_edge_grad``) for ``he``. GATv2 with edge rows
  (``att . leaky((ks[src] + he) + xd)``) takes K11's gatv2 mode for ``he``
  and sums that table into the key table along the source walk (K6b's sum
  over ``EllGraph.t_edge``): the key row and the edge row enter the layer
  identically, so their cotangents are one table.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.ell import _edge_rows, ell_edge_grad
from gigl_tpu_torch.ops.ell_aggregate import (
    ell_edge_rows_sum,
    ell_transpose_aggregate,
)
from gigl_tpu_torch.ops.fanout import masked_softmax

MODES = {"gat": 0, "gatv2": 1, "transformer": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64            # kChunk of the kernel: shared memory per block
_SMEM_LIMIT = 48 * 1024
_BWD_WARPS = 4         # kWarps of K7b
_BWD_BLOCKS_PER_SM = 8


class AttentionGrads(NamedTuple):
    """What K7b computes for one call (None where the layout has none)."""

    d_xd: torch.Tensor                   # [n, H*Dh] xd's type
    alpha: Optional[torch.Tensor]        # ELL: [n*W, H] fp32
    coef: Optional[torch.Tensor]         # ELL: [n*W, H] fp32
    d_ks: Optional[torch.Tensor]         # block: [n*W, H*Dh]
    d_vs: Optional[torch.Tensor]         # block, two tables: [n*W, H*Dh]
    d_att: Optional[torch.Tensor]        # GAT(v2): [2, H*Dh] fp32 (src, dst;
                                         # GATv2: att, zeros)


def _slot_rows(ks, vs, nbr, he, eidx, heads):
    """The slots' key and value rows [n, W, H, Dh] in fp32, with the edge
    rows added when ``he`` is given."""
    n, w = nbr.shape
    dh = ks.shape[1] // heads
    idx = nbr.long()
    k, v = ks[idx].float(), vs[idx].float()
    if he is not None:
        e = _edge_rows(he, eidx)
        k, v = k + e, v + e
    return (k.reshape(n, w, heads, dh), v.reshape(n, w, heads, dh))


def _fanout_attention_plain(xd, ks, vs, nbr, mask, mode, heads, att=None,
                            att2=None, negative_slope=0.2, he=None,
                            eidx=None, bias=None):
    """Plain twin of K7: fp32 arithmetic, one rounding to xd's type."""
    n, w = nbr.shape
    dh = ks.shape[1] // heads
    k, v = _slot_rows(ks, vs, nbr, he, eidx, heads)
    q = xd.float().reshape(n, 1, heads, dh)
    if mode == "gat":
        pre = (k * att.reshape(heads, dh)).sum(-1) + (
            q * att2.reshape(heads, dh)).sum(-1)
        if bias is not None:
            pre = pre + bias
        logits = F.leaky_relu(pre, negative_slope)
    elif mode == "gatv2":
        logits = (F.leaky_relu(k + q, negative_slope)
                  * att.reshape(heads, dh)).sum(-1)
    else:
        logits = (q * k).sum(-1) / math.sqrt(dh)             # [n, W, H]
    alpha = masked_softmax(logits.transpose(1, 2), mask[:, None, :],
                           axis=-1)                          # [n, H, W]
    out = torch.einsum("nhw,nwhd->nhd", alpha, v)
    return out.reshape(n, heads * dh).to(xd.dtype)


def _check_fwd(xd, ks, vs, nbr, mask, mode, heads, atts, he=None,
               eidx=None, bias=None):
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
    if (he is None) != (eidx is None) or (he is not None and (
            he.dim() != 2 or he.shape[1] != hd or he.dtype != xd.dtype
            or eidx.shape != nbr.shape or eidx.dtype != torch.int32)):
        raise ValueError("fanout_attention: he [E, H*Dh] of xd's type goes "
                         "with eidx [n, W] int32")
    if bias is not None and (mode != "gat" or bias.dtype != torch.float32
                             or bias.shape != (nbr.shape[1], heads)):
        raise ValueError("fanout_attention: bias is fp32 [W, H], GAT v1 "
                         "only")


def _fanout_attention_fwd(xd, ks, vs, nbr, mask, mode, heads, att, att2,
                          negative_slope, out=None, stats=None, he=None,
                          eidx=None, bias=None):
    """K7 launch (plain twin for CPU tensors; see the module docstring),
    into ``out`` [n, H*Dh] when given. ``att``/``att2``: fp32 [H*Dh], GAT
    ``att_src`` / ``att_dst``; GATv2 ``att`` and None; Transformer None.
    ``he`` / ``eidx`` / ``bias``: the optional edge rows and logit term.
    On the card ``stats`` (fp32 [n, H, 2] or None) receives each (row,
    head)'s softmax max and denominator for K7b."""
    if mode not in MODES:
        raise ValueError(f"Unknown attention mode {mode!r}")
    if xd.device.type == "cpu":
        got = _fanout_attention_plain(xd, ks, vs, nbr, mask, mode, heads,
                                      att, att2, negative_slope, he, eidx,
                                      bias)
        return got if out is None else out.copy_(got)
    atts = tuple(a for a in (att, att2) if a is not None)
    extra = tuple(t for t in (he, eidx, bias) if t is not None)
    device = _build.require_cuda("fanout_attention", xd, ks, vs, nbr, mask,
                                 *atts, *extra)
    _check_fwd(xd, ks, vs, nbr, mask, mode, heads, atts, he, eidx, bias)
    n, hd = xd.shape
    if 4 * (3 * hd + heads * _CHUNK + 4 * heads) > _SMEM_LIMIT:
        raise ValueError(f"fanout_attention: H*Dh = {hd} exceeds the "
                         "kernel's shared memory")
    w = nbr.shape[1]
    if out is None:
        out = torch.empty((n, hd), dtype=xd.dtype, device=device)
    for t, shape, dtype in ((out, (n, hd), xd.dtype),
                            (stats, (n, heads, 2), torch.float32)):
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != device):
            raise ValueError("fanout_attention: out must be [n, H*Dh] of "
                             "xd's type and stats fp32 [n, H, 2], contiguous "
                             "on xd's device")
    _build.launch("fanout_attention", "gigl_fanout_attention", device,
                  xd.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                  nbr.data_ptr(), mask.data_ptr(), _build.ptr(att),
                  _build.ptr(att2), _build.ptr(he), _build.ptr(eidx),
                  _build.ptr(bias), out.data_ptr(), _build.ptr(stats), n, w,
                  heads, hd // heads, _DTYPES[xd.dtype], MODES[mode],
                  float(negative_slope), float(math.sqrt(hd // heads)))
    return out


def _fanout_attention_bwd_plain(g, xd, ks, vs, nbr, mask, out, mode, heads,
                                att=None, att2=None, negative_slope=0.2,
                                identity=False, same_table=False, he=None,
                                eidx=None, bias=None) -> AttentionGrads:
    """Plain twin of K7b: the same formulas in fp32 (alpha recomputed by
    ``masked_softmax``, ``t = g · out``), one rounding of the row outputs
    to xd's type."""
    n, w = nbr.shape
    hd = xd.shape[1]
    dh = hd // heads
    k, v = _slot_rows(ks, vs, nbr, he, eidx, heads)
    q = xd.float().reshape(n, heads, dh)
    gf = g.float().reshape(n, heads, dh)
    if mode == "gat":
        a_src, a_dst = att.reshape(heads, dh), att2.reshape(heads, dh)
        pre = (k * a_src).sum(-1) + (q * a_dst).sum(-1)[:, None]
        if bias is not None:
            pre = pre + bias
        logits = F.leaky_relu(pre, negative_slope)
    elif mode == "gatv2":
        a_v2 = att.reshape(heads, dh)
        z = k + q[:, None]                                   # [n, W, H, Dh]
        logits = (F.leaky_relu(z, negative_slope) * a_v2).sum(-1)
    else:
        logits = (q[:, None] * k).sum(-1) / math.sqrt(dh)    # [n, W, H]
    alpha = masked_softmax(logits.transpose(1, 2), mask[:, None, :],
                           axis=-1).transpose(1, 2)         # [n, W, H]
    d_alpha = (gf[:, None] * v).sum(-1)
    t = (gf * out.float().reshape(n, heads, dh)).sum(-1)    # [n, H]
    dlog = torch.where(mask[..., None], alpha * (d_alpha - t[:, None]), 0.0)
    if mode == "gat":
        coef = dlog * torch.where(pre >= 0, 1.0, negative_slope)
        s = coef.sum(1)                                     # [n, H]
        d_xd = s[..., None] * a_dst
        d_att = torch.stack([torch.einsum("nwh,nwhd->hd", coef, k),
                             torch.einsum("nh,nhd->hd", s, q)]).reshape(2, hd)
        d_k = coef[..., None] * a_src
    elif mode == "gatv2":
        coef = dlog
        d_k = coef[..., None] * a_v2 * torch.where(z >= 0, 1.0,
                                                   negative_slope)
        d_xd = d_k.sum(1)
        d_att = torch.stack([torch.einsum(
            "nwh,nwhd->hd", coef, F.leaky_relu(z, negative_slope)),
            torch.zeros_like(a_v2)]).reshape(2, hd)
    else:
        coef = dlog / math.sqrt(dh)
        d_xd = torch.einsum("nwh,nwhd->nhd", coef, k)
        d_att = None
        d_k = coef[..., None] * q[:, None]
    d_xd = d_xd.reshape(n, hd).to(xd.dtype)
    if not identity:
        return AttentionGrads(d_xd, alpha.reshape(n * w, heads),
                              coef.reshape(n * w, heads), None, None, d_att)
    d_v = alpha[..., None] * gf[:, None]
    coef_b = None if bias is None else coef.reshape(n * w, heads)
    if same_table:
        return AttentionGrads(d_xd, None, coef_b,
                              (d_k + d_v).reshape(n * w, hd).to(ks.dtype),
                              None, d_att)
    return AttentionGrads(d_xd, None, coef_b,
                          d_k.reshape(n * w, hd).to(ks.dtype),
                          d_v.reshape(n * w, hd).to(vs.dtype), d_att)


def fanout_attention_bwd(g, xd, ks, vs, nbr, mask, out, stats, mode, heads,
                         att=None, att2=None, negative_slope=0.2,
                         identity=False, same_table=False, d_xd=None,
                         alpha=None, coef=None, he=None, eidx=None,
                         bias=None) -> AttentionGrads:
    """K7b (plain twin for CPU tensors): the gradients of one K7 call whose
    output was ``out`` and softmax statistics ``stats`` (K7's, [n, H, 2];
    unused by the twin), for the cotangent ``g`` [n, H*Dh]. ``identity``:
    the dense-block layout (``nbr[i, j] = i * W + j``): the key / value
    row gradients per entry (``same_table``: keys and values are one table,
    their sum in ``d_ks``) and, with a ``bias``, the per-entry coefficient
    (its cotangent) [n*W, H]; otherwise the per-entry alpha and
    coefficient [n*W, H]. ``he`` / ``eidx`` / ``bias``: K7's optional
    operands. ``d_xd``, ``alpha``, ``coef``: optional output buffers."""
    if mode not in MODES:
        raise ValueError(f"Unknown attention mode {mode!r}")
    if xd.device.type == "cpu":
        got = _fanout_attention_bwd_plain(
            g, xd, ks, vs, nbr, mask, out, mode, heads, att, att2,
            negative_slope, identity, same_table, he, eidx, bias)
        fills = {"d_xd": d_xd, "alpha": alpha, "coef": coef}
        return got._replace(**{k: buf.copy_(getattr(got, k))
                               for k, buf in fills.items()
                               if buf is not None})
    atts = tuple(a for a in (att, att2) if a is not None)
    extra = tuple(t for t in (he, eidx, bias) if t is not None)
    device = _build.require_cuda("fanout_attention_bwd", g, xd, ks, vs, nbr,
                                 mask, out, stats, *atts, *extra)
    _check_fwd(xd, ks, vs, nbr, mask, mode, heads, atts, he, eidx, bias)
    n, hd = xd.shape
    w, dh = nbr.shape[1], hd // heads
    if g.shape != (n, hd) or out.shape != (n, hd) or g.dtype != xd.dtype \
            or out.dtype != xd.dtype or stats.dtype != torch.float32 \
            or stats.shape != (n, heads, 2):
        raise ValueError("fanout_attention_bwd: g and out must be [n, H*Dh] "
                         "of xd's type, stats fp32 [n, H, 2]")
    smem = 4 * (5 * hd + 4 * _BWD_WARPS * hd + 5 * heads
                + 3 * _BWD_WARPS * heads)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fanout_attention_bwd: H*Dh = {hd} exceeds the "
                         "kernel's shared memory")

    def buf(t, shape, dtype):
        if t is None:
            return torch.empty(shape, dtype=dtype, device=device)
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous() \
                or t.device != device:
            raise ValueError("fanout_attention_bwd: an output buffer has "
                             "the wrong shape, type or layout")
        return t

    d_xd = buf(d_xd, (n, hd), xd.dtype)
    d_ks = d_vs = None
    if identity:
        d_ks = torch.empty((n * w, hd), dtype=ks.dtype, device=device)
        if not same_table:
            d_vs = torch.empty((n * w, hd), dtype=vs.dtype, device=device)
        alpha = None
        coef = (None if bias is None
                else buf(coef, (n * w, heads), torch.float32))
    else:
        alpha = buf(alpha, (n * w, heads), torch.float32)
        coef = buf(coef, (n * w, heads), torch.float32)
    grid = max(1, min(n, torch.cuda.get_device_properties(
        device).multi_processor_count * _BWD_BLOCKS_PER_SM))
    part = d_att = None
    if mode != "transformer":
        part = torch.empty((grid, 2 * hd), dtype=torch.float32, device=device)
        d_att = torch.zeros((2, hd), dtype=torch.float32, device=device)
    _build.launch("fanout_attention_bwd", "gigl_fanout_attention_bwd",
                  device, g.data_ptr(), xd.data_ptr(), ks.data_ptr(),
                  vs.data_ptr(), out.data_ptr(), stats.data_ptr(),
                  nbr.data_ptr(), mask.data_ptr(), _build.ptr(att),
                  _build.ptr(att2), _build.ptr(he), _build.ptr(eidx),
                  _build.ptr(bias), d_xd.data_ptr(), _build.ptr(alpha),
                  _build.ptr(coef), _build.ptr(d_ks), _build.ptr(d_vs),
                  _build.ptr(part), _build.ptr(d_att), n, w, heads, dh,
                  _DTYPES[xd.dtype], MODES[mode], float(negative_slope),
                  float(math.sqrt(dh)), grid)
    return AttentionGrads(d_xd, alpha, coef, d_ks, d_vs, d_att)


def _flat(a):
    return None if a is None else a.float().reshape(-1).contiguous()


def _att_grads(d_att, needs):
    """(d_att_src, d_att_dst) for GAT's two vectors, None where unneeded."""
    if d_att is None:
        return None, None
    return (d_att[0] if needs[0] else None, d_att[1] if needs[1] else None)


def _stats(ctx, xd, heads):
    """K7's softmax statistics buffer when a gradient will be needed."""
    if xd.device.type == "cpu" or not any(ctx.needs_input_grad):
        return None
    return torch.empty((xd.shape[0], heads, 2), dtype=torch.float32,
                       device=xd.device)


class FanoutAttentionBlock(torch.autograd.Function):
    """K7 over a dense block (slot j of row i reads source row i*W + j);
    the backward is K7b in identity mode. ``vs`` None: one table for keys
    and values. ``bias`` [W, H] fp32 or None: its gradient is K7b's
    per-entry coefficient summed over the rows."""

    @staticmethod
    def forward(ctx, xd, ks, vs, mask, att, att2, bias, mode, heads,
                negative_slope):
        n, w = mask.shape
        nbr = torch.arange(n * w, dtype=torch.int32,
                           device=xd.device).reshape(n, w)
        stats = _stats(ctx, xd, heads)
        vs_ = ks if vs is None else vs
        out = _fanout_attention_fwd(xd, ks, vs_, nbr, mask, mode, heads,
                                    att, att2, negative_slope, stats=stats,
                                    bias=bias)
        ctx.save_for_backward(xd, ks, vs_, nbr, mask, att, att2, bias, out,
                              stats)
        ctx.cfg = (mode, heads, negative_slope, vs is None)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (xd, ks, vs, nbr, mask, att, att2, bias, out,
         stats) = ctx.saved_tensors
        mode, heads, slope, same = ctx.cfg
        r = fanout_attention_bwd(grad_out.contiguous(), xd, ks, vs, nbr,
                                 mask, out, stats, mode, heads, att, att2,
                                 slope, identity=True, same_table=same,
                                 bias=bias)
        needs = ctx.needs_input_grad
        d_bias = None
        if needs[6]:
            d_bias = r.coef.reshape(nbr.shape + (heads,)).sum(0)
        return (r.d_xd if needs[0] else None, r.d_ks if needs[1] else None,
                r.d_vs if needs[2] else None,
                None, *_att_grads(r.d_att, needs[4:6]), d_bias, None, None,
                None)


def fanout_attention_block(xd: torch.Tensor, ks: torch.Tensor,
                           vs: Optional[torch.Tensor], mask: torch.Tensor,
                           mode: str, heads: int,
                           att: Optional[torch.Tensor] = None,
                           att2: Optional[torch.Tensor] = None,
                           negative_slope: float = 0.2,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Attention of each row ``i`` over its dense block: xd [n, H*Dh], ks
    (and vs, or None for one shared table) [n*W, H*Dh] with slot j of row i
    at row ``i * W + j``, mask [n, W]; ``bias`` [W, H] (GAT v1): a logit
    term per slot column, before the leaky_relu. Trainable (K7b)."""
    if mode not in MODES:
        raise ValueError(f"Unknown attention mode {mode!r}")
    return FanoutAttentionBlock.apply(
        xd.contiguous(), ks.contiguous(),
        None if vs is None else vs.contiguous(), mask, _flat(att),
        _flat(att2), None if bias is None else bias.float().contiguous(),
        mode, heads, negative_slope)


class FanoutAttentionEll(torch.autograd.Function):
    """K7 per ELL bucket into one [N, H*Dh] output; the backward is K7b per
    bucket (per-entry alpha and coefficients at the flat entry positions),
    then K6b in weighted mode over the transpose tables for the source
    tables (GATv2 with edge rows: K11's gatv2 mode, then K6b's sum of its
    table over ``t_edge``)."""

    @staticmethod
    def forward(ctx, xd, ks, vs, att, att2, he, ell, mode, heads,
                negative_slope):
        stats = _stats(ctx, xd, heads)
        vs_ = ks if vs is None else vs
        out = torch.empty_like(xd)
        for b in range(len(ell.widths)):
            lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
            if hi == lo:
                continue
            _fanout_attention_fwd(
                xd[lo:hi], ks, vs_, ell.nbr[b], ell.mask[b], mode, heads,
                att, att2, negative_slope, out=out[lo:hi],
                stats=None if stats is None else stats[lo:hi], he=he,
                eidx=None if he is None else ell.edge_slots[b])
        ctx.save_for_backward(xd, ks, vs_, att, att2, he, out, stats)
        ctx.ell = ell
        ctx.cfg = (mode, heads, negative_slope, vs is None)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        xd, ks, vs, att, att2, he, out, stats = ctx.saved_tensors
        ell = ctx.ell
        mode, heads, slope, same = ctx.cfg
        g = grad_out.contiguous()
        n_ent = ell.ent_row.shape[0]
        alpha = torch.empty((n_ent, heads), dtype=torch.float32,
                            device=xd.device)
        coef = torch.empty_like(alpha)
        d_xd = torch.empty_like(xd)
        d_att = None
        for b in range(len(ell.widths)):
            lo, hi = ell.boundaries[b], ell.boundaries[b + 1]
            if hi == lo:
                continue
            e0, e1 = ell.ent_off[b], ell.ent_off[b + 1]
            r = fanout_attention_bwd(
                g[lo:hi], xd[lo:hi], ks, vs, ell.nbr[b], ell.mask[b],
                out[lo:hi], None if stats is None else stats[lo:hi], mode,
                heads, att, att2, slope, d_xd=d_xd[lo:hi],
                alpha=alpha[e0:e1], coef=coef[e0:e1], he=he,
                eidx=None if he is None else ell.edge_slots[b])
            if r.d_att is not None:
                d_att = r.d_att if d_att is None else d_att + r.d_att
        needs = ctx.needs_input_grad
        d_ks = d_vs = d_he = None
        if mode == "gatv2" and he is not None:
            # the edge row joins the key row inside the gate and the value:
            # one cotangent per entry (K11), summed by source for the keys
            if needs[1] or needs[5]:
                d_he = ell_edge_grad(g, ell, "gatv2", x=ks, ea=he,
                                     alpha=alpha, coef=coef, vec=att, xd=xd,
                                     heads=heads, negative_slope=slope)
            if needs[1]:
                d_ks = ell_edge_rows_sum(d_he, ell)
            return (d_xd if needs[0] else None, d_ks, None,
                    *_att_grads(d_att, needs[3:5]),
                    d_he if needs[5] else None, None, None, None, None)
        if mode == "gat":
            # one table: values through alpha, keys through att_src * the
            # summed pre-activation cotangents
            if needs[1]:
                d_ks = ell_transpose_aggregate(g, ell, "weighted", alpha,
                                               coef, att, heads)
        elif mode == "gatv2":
            # one table: values through alpha, keys through each (key,
            # query) pair's leaky_relu derivative
            if needs[1]:
                d_ks = ell_transpose_aggregate(g, ell, "gatv2", alpha, coef,
                                               att, heads, rows2=xd,
                                               table=ks,
                                               negative_slope=slope)
        else:
            if needs[1]:
                d_ks = ell_transpose_aggregate(xd, ell, "weighted", coef,
                                               heads=heads)
            if needs[2]:
                d_vs = ell_transpose_aggregate(g, ell, "weighted", alpha,
                                               heads=heads)
        if needs[5]:
            # each edge's row is added to one entry's key and value: its
            # gradient is that entry's (K11, once per edge)
            d_he = ell_edge_grad(g, ell, mode, alpha=alpha, coef=coef,
                                 vec=att if mode == "gat" else None,
                                 xd=xd if mode == "transformer" else None,
                                 heads=heads)
        return (d_xd if needs[0] else None, d_ks, d_vs,
                *_att_grads(d_att, needs[3:5]), d_he, None, None, None, None)


def fanout_attention_ell(xd: torch.Tensor, ks: torch.Tensor,
                         vs: Optional[torch.Tensor], ell, mode: str,
                         heads: int, att: Optional[torch.Tensor] = None,
                         att2: Optional[torch.Tensor] = None,
                         negative_slope: float = 0.2,
                         he: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of every row of an ELL graph over its whole in-neighborhood:
    xd [N, H*Dh], ks (and vs, or None for one shared table) [N, H*Dh], all
    in permuted order -> [N, H*Dh]. ``he`` [E, H*Dh]: edge rows in COO edge
    order, added to each entry's key and value rows (GATv2: inside its gate
    too). Trainable (K7b, K6b; K11 for ``he``)."""
    if mode not in MODES:
        raise ValueError(f"Unknown attention mode {mode!r}")
    if mode != "transformer" and vs is not None:
        raise ValueError("fanout_attention_ell: GAT reads one table for "
                         "keys and values (vs=None)")
    return FanoutAttentionEll.apply(
        xd.contiguous(), ks.contiguous(),
        None if vs is None else vs.contiguous(), _flat(att), _flat(att2),
        None if he is None else he.contiguous(), ell, mode, heads,
        negative_slope)
