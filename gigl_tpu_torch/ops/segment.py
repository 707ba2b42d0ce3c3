"""COO segment ops (port of ``gigl_tpu/ops/segment.py``): gather source
rows per edge and reduce them into destination segments, the per-segment
softmax, and per-edge scores — the compute core of the ``coo`` forms of
the typed convs (``models/hetero_convs.py``) and so of exact typed
full-graph inference.

Three kernels replace the reference's segment ops (B7):

- K8 ``segment_reduce`` (``csrc/segment_reduce.cu``): ``segment_sum``,
  ``segment_mean``, ``segment_max`` and ``coo_spmm`` — the gather and the
  reduce in one pass, optionally weighted per edge ``[E]`` or per edge and
  head ``[E, H]``;
- K9 ``segment_softmax`` (``csrc/segment_softmax.cu``);
- K10 ``sddmm`` (``csrc/sddmm.cu``), with an optional per-head scale.

The kernels walk a :class:`SegmentIndex`: the edge ids sorted by segment
(a stable sort, so each segment keeps its edges' original order) and the
segment pointers. It is built once per graph on the host with numpy, as
``EllGraph.from_csr`` is, and every function takes it as ``index=``. A call
on CUDA without one builds it first, on the host: that copies the ids to
the host and waits for the device. The kernels use no atomics and write
each output row once, so they give the same bits on every run.

Each kernel has a plain PyTorch twin (``_segment_reduce_plain``,
``_segment_softmax_plain``, ``_sddmm_plain``), which runs for CPU tensors
only and is differentiable. On CUDA tensors only the forward is ported:
a wrapper given a CUDA tensor that requires grad raises (the backward of
B7 is slice 6). fp32 accumulation, one rounding to the data's type; the
mean divides by the edge count rounded to the data's type first, as the
reference counts in it (``segment.py:32-36``), at least 1.

The port's functions take the reference's arguments and keyword
``index``; ``coo_spmm`` also takes ``[E, H]`` weights for a table of ``H``
heads (``[N, H, dk]`` or ``[N, H * dk]``), and ``sddmm`` a per-head
``scale``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops import _build

_OPS = {"sum": 0, "mean": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BACKWARD_NOT_PORTED = ("the backward of the COO segment ops (B7) is not "
                       "ported yet: it is slice 6 (typed training); call "
                       "under torch.no_grad() or inference_mode")


@dataclass
class SegmentIndex:
    """Edges grouped by segment: ``order[ptr[s]:ptr[s + 1]]`` are the ids
    (positions in the original edge order) of segment ``s``'s edges, in
    that order. int32 tensors on one device."""

    order: torch.Tensor  # [E] int32
    ptr: torch.Tensor    # [S + 1] int32
    num_segments: int

    @property
    def num_edges(self) -> int:
        return int(self.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.order.device

    @classmethod
    def from_ids(cls, segment_ids, num_segments: int,
                 device: DeviceLike = None) -> "SegmentIndex":
        """Build on the host from ``segment_ids`` [E] (numpy or a tensor)
        with a stable argsort and a bincount cumsum; the tables go to
        ``device`` (a tensor's own device when not given, else CUDA unless
        asked). Ids must lie in [0, num_segments)."""
        if isinstance(segment_ids, torch.Tensor):
            if device is None:
                device = segment_ids.device
            ids = segment_ids.detach().cpu().numpy()
        else:
            ids = np.asarray(segment_ids)
        device = resolve_device(device)
        if ids.ndim != 1:
            raise ValueError(f"segment ids must be 1-D, got {ids.shape}")
        if len(ids) >= 2**31:
            raise ValueError(f"{len(ids)} edges exceed the int32 index")
        if len(ids) and (ids.min() < 0 or ids.max() >= num_segments):
            raise ValueError(f"segment ids must lie in [0, {num_segments})")
        order = np.argsort(ids, kind="stable").astype(np.int32)
        ptr = np.zeros(int(num_segments) + 1, np.int32)
        np.cumsum(np.bincount(ids, minlength=int(num_segments)), out=ptr[1:])

        def put(a):
            return torch.from_numpy(a).to(device)

        return cls(order=put(order), ptr=put(ptr),
                   num_segments=int(num_segments))


def _cols(t: torch.Tensor) -> int:
    """Columns of an [E] (1) or [E, W] tensor."""
    return 1 if t.dim() == 1 else t.shape[1]


def _no_grad_on_card(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: {BACKWARD_NOT_PORTED}")


def _index(segment_ids, num_segments, index, num_edges):
    """``index``, or one built now on the host (see the module docstring)."""
    if index is None:
        index = SegmentIndex.from_ids(segment_ids, num_segments)
    if index.num_segments != num_segments or index.num_edges != num_edges:
        raise ValueError(
            f"index covers {index.num_edges} edges in {index.num_segments} "
            f"segments, the call {num_edges} edges in {num_segments}")
    return index


# -- K8 segment_reduce ----------------------------------------------------------
def _segment_reduce_plain(x, segment_ids, num_segments, op="sum", src=None,
                          weight=None):
    """Plain twin of K8 (the reference's gather and segment reduce): fp32
    arithmetic, one rounding to x's type."""
    rows = x if src is None else x[src.long()]
    e, trailing = rows.shape[0], tuple(rows.shape[1:])
    c = math.prod(trailing)
    acc = rows.float().reshape(e, c)
    if weight is not None:
        w = weight.float().reshape(e, _cols(weight))
        acc = (acc.reshape(e, w.shape[1], c // w.shape[1])
               * w[..., None]).reshape(e, c)
    ids = segment_ids.long()
    if op == "max":
        out = torch.full((num_segments, c), float("-inf"), device=acc.device)
        out = out.scatter_reduce(0, ids[:, None].expand(e, c), acc, "amax")
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        out = torch.zeros((num_segments, c), device=acc.device).index_add(
            0, ids, acc)
        if op == "mean":
            cnt = torch.zeros(num_segments, device=acc.device).index_add(
                0, ids, torch.ones(e, device=acc.device))
            cnt = cnt.to(x.dtype).float().clamp(min=1.0)  # counted in x's type
            out = out / cnt[:, None]
    return out.to(x.dtype).reshape((num_segments,) + trailing)


def segment_reduce(x: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, op: str = "sum",
                   src: Optional[torch.Tensor] = None,
                   weight: Optional[torch.Tensor] = None,
                   index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K8: ``out[s] = op_{e: segment_ids[e] = s} weight[e] * row(e)`` with
    ``row(e) = x[src[e]]`` (src given) or ``x[e]``; x [M, ...], weight
    [E] or [E, W] (W columns over the flattened trailing values: per head
    for a [.., H, dk] row), op ``sum`` | ``mean`` | ``max`` -> [S, ...].
    Empty segments give 0."""
    if op not in _OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    e = segment_ids.shape[0]
    if (src is None and x.shape[0] != e) or (
            src is not None and src.shape != (e,)):
        raise ValueError(f"segment_reduce: {e} segment ids for "
                         f"{x.shape[0] if src is None else src.shape[0]} "
                         "rows")
    if weight is not None and (weight.dim() not in (1, 2)
                               or weight.shape[0] != e):
        raise ValueError("segment_reduce: weight must be [E] or [E, W]")
    if x.device.type == "cpu":
        return _segment_reduce_plain(x, segment_ids, num_segments, op, src,
                                     weight)
    _no_grad_on_card("segment_reduce", x, weight)
    index = _index(segment_ids, num_segments, index, e)
    c = math.prod(x.shape[1:])
    xf = x.contiguous().reshape(x.shape[0], c)
    gather = None if src is None else src.to(torch.int32).contiguous()
    w = (None if weight is None
         else weight.float().reshape(e, _cols(weight)).contiguous())
    extra = tuple(t for t in (gather, w) if t is not None)
    device = _build.require_cuda("segment_reduce", xf, index.order,
                                 index.ptr, *extra)
    if xf.dtype not in _DTYPES:
        raise ValueError(f"segment_reduce: dtype {x.dtype} not supported")
    w_cols = 1 if w is None else w.shape[1]
    if c % w_cols:
        raise ValueError(f"segment_reduce: {c} values per row do not split "
                         f"into {w_cols} weight columns")
    wc = c // w_cols
    out = torch.empty((num_segments, c), dtype=x.dtype, device=device)
    esize = xf.element_size()
    vec = int((c * esize) % 16 == 0 and (wc * esize) % 16 == 0
              and xf.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    if num_segments * c:
        _build.launch("segment_reduce", "gigl_segment_reduce", device,
                      xf.data_ptr(), _build.ptr(gather), index.order.data_ptr(),
                      index.ptr.data_ptr(), _build.ptr(w), out.data_ptr(),
                      num_segments, c, wc, w_cols, _DTYPES[x.dtype],
                      _OPS[op], vec)
    return out.reshape((num_segments,) + tuple(x.shape[1:]))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *,
                index: Optional[SegmentIndex] = None) -> torch.Tensor:
    return segment_reduce(data, segment_ids, num_segments, op="sum",
                          index=index)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *,
                 index: Optional[SegmentIndex] = None) -> torch.Tensor:
    return segment_reduce(data, segment_ids, num_segments, op="mean",
                          index=index)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *,
                index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """Empty segments (and any non-finite maximum) give 0."""
    return segment_reduce(data, segment_ids, num_segments, op="max",
                          index=index)


def coo_spmm(src: torch.Tensor, dst: torch.Tensor, x: torch.Tensor,
             num_dst: int, *, edge_weight: Optional[torch.Tensor] = None,
             reduce: str = "sum",
             index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """Sparse A @ X over COO edges: ``out[d] = reduce_{(s, d) in E} w *
    x[s]`` (K8 in gather mode); ``edge_weight`` [E], or [E, H] for x
    [N, H, dk] / [N, H * dk]. ``index`` is the SegmentIndex of ``dst``."""
    if reduce not in _OPS:
        raise ValueError(f"Unknown reduce {reduce!r}")
    return segment_reduce(x, dst, num_dst, op=reduce, src=src,
                          weight=edge_weight, index=index)


# -- K9 segment_softmax ---------------------------------------------------------
def _segment_softmax_plain(logits, segment_ids, num_segments):
    """Plain twin of K9, the reference's formulation in fp32: the segment
    max (0 where not finite), exp of the shifted logits, their segment sum
    clamped at 1e-16; one rounding to the logits' type."""
    flat = logits.float().reshape(logits.shape[0], _cols(logits))
    ids = segment_ids.long()
    idx = ids[:, None].expand_as(flat)
    m = torch.full((num_segments, flat.shape[1]), float("-inf"),
                   device=flat.device).scatter_reduce(0, idx, flat, "amax")
    m = torch.where(torch.isfinite(m), m, 0.0).detach()
    ex = torch.exp(flat - m[ids])
    denom = torch.zeros_like(m).index_add(0, ids, ex)
    out = ex / torch.clamp(denom[ids], min=1e-16)
    return out.reshape(logits.shape).to(logits.dtype)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *,
                    index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K9: softmax of ``logits`` [E] or [E, H] within each segment, in the
    original edge order."""
    e = segment_ids.shape[0]
    if logits.dim() not in (1, 2) or logits.shape[0] != e:
        raise ValueError("segment_softmax: logits must be [E] or [E, H]")
    if logits.device.type == "cpu":
        return _segment_softmax_plain(logits, segment_ids, num_segments)
    _no_grad_on_card("segment_softmax", logits)
    index = _index(segment_ids, num_segments, index, e)
    lg = logits.contiguous()
    device = _build.require_cuda("segment_softmax", lg, index.order,
                                 index.ptr)
    if lg.dtype not in _DTYPES:
        raise ValueError(f"segment_softmax: dtype {lg.dtype} not supported")
    heads = _cols(lg)
    out = torch.empty_like(lg)
    if num_segments and e:
        _build.launch("segment_softmax", "gigl_segment_softmax", device,
                      lg.data_ptr(), index.order.data_ptr(),
                      index.ptr.data_ptr(), out.data_ptr(), num_segments,
                      heads, _DTYPES[lg.dtype])
    return out


# -- K10 sddmm ------------------------------------------------------------------
def _sddmm_plain(src, dst, q, k, scale=None):
    """Plain twin of K10: fp32 products summed over the last axis, one
    rounding to q's type."""
    out = (q.float()[dst.long()] * k.float()[src.long()]).sum(-1)
    if scale is not None:
        out = out * scale.float()
    return out.to(q.dtype)


def sddmm(src: torch.Tensor, dst: torch.Tensor, q: torch.Tensor,
          k: torch.Tensor, *,
          scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: per-edge score ``<q[dst_e], k[src_e]>``; q [N_dst, H, D] or
    [N_dst, D], k likewise -> [E, H] or [E], each head's score times
    ``scale[h]`` (fp32 [H], or [1] without heads) when given."""
    if q.dim() not in (2, 3) or k.dim() != q.dim() \
            or k.shape[1:] != q.shape[1:]:
        raise ValueError("sddmm: q and k must be [N, H, D] or [N, D] with "
                         "the same trailing shape")
    heads = q.shape[1] if q.dim() == 3 else 1
    if scale is not None and scale.shape != (heads,):
        raise ValueError(f"sddmm: scale must be [{heads}]")
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError("sddmm: src and dst must be [E]")
    if q.device.type == "cpu":
        return _sddmm_plain(src, dst, q, k, scale)
    _no_grad_on_card("sddmm", q, k)
    c = math.prod(q.shape[1:])
    qf = q.contiguous().reshape(q.shape[0], c)
    kf = k.contiguous().reshape(k.shape[0], c)
    s32, d32 = (t.to(torch.int32).contiguous() for t in (src, dst))
    sc = None if scale is None else scale.float().contiguous()
    extra = () if sc is None else (sc,)
    device = _build.require_cuda("sddmm", qf, kf, s32, d32, *extra)
    if qf.dtype not in _DTYPES or kf.dtype != qf.dtype:
        raise ValueError("sddmm: q and k must share one dtype, fp32 or bf16")
    e = src.shape[0]
    out = torch.empty((e, heads), dtype=q.dtype, device=device)
    esize = qf.element_size()
    vec = int(((c // heads) * esize) % 16 == 0 and qf.data_ptr() % 16 == 0
              and kf.data_ptr() % 16 == 0)
    if e:
        _build.launch("sddmm", "gigl_sddmm", device, qf.data_ptr(),
                      kf.data_ptr(), s32.data_ptr(), d32.data_ptr(),
                      _build.ptr(sc), out.data_ptr(), e, c, heads,
                      _DTYPES[q.dtype], vec)
    return out if q.dim() == 3 else out.reshape(e)
