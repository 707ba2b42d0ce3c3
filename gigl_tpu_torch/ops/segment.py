"""COO segment ops (port of ``gigl_tpu/ops/segment.py``): gather source
rows per edge and reduce them into destination segments, the per-segment
softmax, and per-edge scores — the compute core of the ``coo`` forms of
the homogeneous convs (``models/convs.py``: ``GNNEncoder.encode_coo``,
``FullBatchTrainer(build_ell=False)``) and of the typed convs
(``models/hetero_convs.py``: exact typed full-graph inference).

Three kernels replace the reference's segment ops (B7), and three more
their backward (jax's autodiff of the same functions):

- K8 ``segment_reduce`` (``csrc/segment_reduce.cu``): ``segment_sum``,
  ``segment_mean``, ``segment_max`` and ``coo_spmm`` — the gather and the
  reduce in one pass, optionally weighted per edge ``[E]`` or per edge and
  head ``[E, H]``;
- K9 ``segment_softmax`` (``csrc/segment_softmax.cu``): each edge's [H]
  logits row read once, held in registers for all heads;
- K10 ``sddmm`` (``csrc/sddmm.cu``), with an optional per-head scale,
  walking the destination index for rows of 512 bytes and more (q read
  once a segment), in edge order below;
- K8b ``segment_reduce_bwd`` (``csrc/segment_reduce_bwd.cu``): the rows'
  cotangent, each source row the sum of its edges' cotangent rows (the
  mean's count and the max's tie share applied), walking the
  source-sorted index, reading each slot's destination composed there
  (as K8 reads its rows); the weights' cotangent is K10's forward on the
  cotangent and the rows;
- K9b ``segment_softmax_bwd`` (``csrc/segment_softmax_bwd.cu``):
  ``alpha * (g - sum_seg(alpha * g))``;
- K10b ``sddmm_bwd`` (``csrc/sddmm_bwd.cu``): the per-edge coefficients
  ``g * scale`` and the scale's cotangent in one launch; ``dq`` is K8 and
  ``dk`` K8b over the two indexes.

The kernels walk a :class:`SegmentIndex`: the edge ids sorted by segment (a
stable sort, so each segment keeps its edges' original order) and the
segment pointers. It is built once per graph on the host with numpy, as
``EllGraph.from_csr`` is, and every function takes it as ``index=``; the
backward of a gather also walks the same sort of the source ids, passed as
``src_index=``. A call on CUDA without one builds it first, on the host:
that copies the ids to the host and waits for the device (a training path
passes both, built once). A destination index built with the edges' source
ids (``SegmentIndex.from_ids(dst, n, gather=src)``) also holds ``gathered =
src[order]``, each slot's row composed in walk order: K8 reads it when it
is given that very ``src`` tensor, unchanged since the build (its composed
mode), and reads ``order`` then ``src`` for any other (its chained mode).
A source index built with the destination ids
(``SegmentIndex.from_ids(src, n, gather=dst)``) holds ``dst[order]`` the
same way, which K8b reads when its ``segment_ids`` are that ``dst``. Every
path builds both indexes with their gathers, and a call on CUDA without an
index builds one with its own ids. The kernels use no
atomics and write each output row once, so they give the same bits on
every run.

Each kernel has a plain PyTorch twin (``_segment_reduce_plain``,
``_segment_softmax_plain``, ``_sddmm_plain``, ``_segment_reduce_bwd_plain``,
``_segment_softmax_bwd_plain``, ``_sddmm_bwd_coef_plain``), which runs for
CPU tensors only; the forward twins are differentiable by PyTorch's
autograd. The public functions are ``autograd.Function``s on every device:
their backward calls the kernel wrappers, which take their twins on the
CPU (the tests hold that composition to ``jax.vjp``) and launch the kernels
on CUDA tensors. fp32 accumulation, one rounding to the data's type; the
mean divides by the edge count rounded to the data's type first, as the
reference counts in it (``segment.py:32-36``), at least 1.

The port's functions take the reference's arguments and keyword
``index``; ``coo_spmm`` also takes ``[E, H]`` weights for a table of ``H``
heads (``[N, H, dk]`` or ``[N, H * dk]``), and ``sddmm`` a per-head
``scale`` (differentiable: HGT's ``prior`` trains through it).

The COO per-edge terms (the ``coo`` forms of GINE, EdgeAttrGAT, the
Transformer with edge rows and GATv2) are modes of the same kernels, each
with its twin here: K8 adds an edge row (by edge id) to each gathered row
(``coo_spmm(edge_rows=, edge_mode="add")``) or takes the relu of the sum
(``"gine"``), and walks GATv2's destinations (:func:`gatv2_dst_bwd`, with
or without edge rows); K8b gates the source walk by GINE's relu
(:func:`gine_bwd`), walks GATv2's sources (:func:`gatv2_src_bwd`) or sums
a per-edge table into the source rows (:func:`edge_rows_by_source`); K10
adds the edge row to the key or scores GATv2's ``att . leaky(hs[src] +
hd[dst])``, with or without an edge row added to ``hs[src]``. :func:`coo_walk`
relabels a graph's edges in its destination walk order, where the
destination walks read an edge table in sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.gather import gather_rows

_OPS = {"sum": 0, "mean": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass
class SegmentIndex:
    """Edges grouped by segment: ``order[ptr[s]:ptr[s + 1]]`` are the ids
    (positions in the original edge order) of segment ``s``'s edges, in
    that order. int32 tensors on one device. An index built with the
    edges' ``gather`` ids (the source rows they read) also holds that
    tensor and ``gathered = gather[order]``, each slot's row composed in
    walk order: K8 (K8b) reads it when it is called with this very
    ``gather`` tensor as ``src`` (``segment_ids``). ``gather_version``
    records that tensor's version counter at the build, so that one changed
    in place since then takes the chained mode. An inference tensor keeps
    no version counter: the index keeps its own copy of such a gather,
    made outside inference mode, which callers pass on as
    ``index.gather``."""

    order: torch.Tensor  # [E] int32
    ptr: torch.Tensor    # [S + 1] int32
    num_segments: int
    gather: Optional[torch.Tensor] = None    # [E], the ids it was built for
    gathered: Optional[torch.Tensor] = None  # [E] int32, gather[order]
    gather_version: Optional[int] = None      # gather._version at the build
    walk: Optional["CooWalk"] = field(default=None, repr=False,
                                      compare=False)  # coo_walk's cache

    @property
    def num_edges(self) -> int:
        return int(self.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.order.device

    @classmethod
    def from_ids(cls, segment_ids, num_segments: int,
                 device: DeviceLike = None, gather=None) -> "SegmentIndex":
        """Build on the host from ``segment_ids`` [E] (numpy or a tensor)
        with a stable argsort and a bincount cumsum; the tables go to
        ``device`` (a tensor's own device when not given, else CUDA unless
        asked). Ids must lie in [0, num_segments). ``gather`` [E] (numpy
        or a tensor): the row each edge reads (or, for a source index, the
        destination it adds to); the index keeps it on the device (the
        tensor itself when it is there already and not an inference
        tensor, so that callers pass that object on; else a copy) and
        composes ``gathered``."""
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

        kept = gathered = None
        if gather is not None:
            rows = (gather.detach().cpu().numpy()
                    if isinstance(gather, torch.Tensor)
                    else np.asarray(gather))
            if rows.shape != ids.shape:
                raise ValueError(f"gather {rows.shape} for {ids.shape} "
                                 "segment ids")
            gathered = put(rows[order].astype(np.int32))
            kept = gather
            if not (isinstance(gather, torch.Tensor)
                    and gather.device == gathered.device
                    and not gather.is_inference()):
                with torch.inference_mode(False):  # a version counter
                    kept = put(np.ascontiguousarray(rows))
        return cls(order=put(order), ptr=put(ptr),
                   num_segments=int(num_segments), gather=kept,
                   gathered=gathered,
                   gather_version=None if kept is None else kept._version)


def _cols(t: torch.Tensor) -> int:
    """Columns of an [E] (1) or [E, W] tensor."""
    return 1 if t.dim() == 1 else t.shape[1]


def _grad_on(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _index(segment_ids, num_segments, index, num_edges, gather=None):
    """``index``, or one built now on the host (see the module docstring),
    with ``gather``'s rows composed when given."""
    if index is None:
        index = SegmentIndex.from_ids(segment_ids, num_segments,
                                      gather=gather)
    if index.num_segments != num_segments or index.num_edges != num_edges:
        raise ValueError(
            f"index covers {index.num_edges} edges in {index.num_segments} "
            f"segments, the call {num_edges} edges in {num_segments}")
    return index


def _counts(segment_ids, num_segments, index, dtype):
    """The mean's divisor per segment, fp32 [S]: the edge count rounded to
    ``dtype`` (the reference counts in the data's type), at least 1; from
    the index's pointers when given (no host synchronisation)."""
    if index is not None:
        cnt = index.ptr[1:] - index.ptr[:-1]
    else:
        ids = segment_ids.long()
        cnt = torch.zeros(num_segments, dtype=torch.int64,
                          device=ids.device).index_add(0, ids,
                                                       torch.ones_like(ids))
    return cnt.to(dtype).float().clamp(min=1.0)


# -- K8 segment_reduce ----------------------------------------------------------


def _per_column(t, w):
    """[E, C] values times w [E, W], each weight column over C / W values."""
    if w is None:
        return t
    e, c = t.shape
    return (t.reshape(e, w.shape[1], c // w.shape[1])
            * w[..., None]).reshape(e, c)


def gather_mode(ids, index) -> Optional[str]:
    """The mode of K8 for a gather ``src`` over its destination index, and
    of K8b for its ``segment_ids`` over its source index: ``composed``
    (each slot's id read from ``index.gathered``) when ``ids`` is the very
    tensor the index was built from and has not been changed in place
    since — an identity test and the version counter, so nothing is
    compared on the device; the index's own tensor is never an inference
    tensor, so every change shows — ``chained`` (order, then ids) for any
    other ids, None without them."""
    if ids is None:
        return None
    return ("composed" if ids is index.gather
            and ids._version == index.gather_version else "chained")


def _segment_reduce_plain(x, segment_ids, num_segments, op="sum", src=None,
                          weight=None, edge=None, edge_mode=None):
    """Plain twin of K8 (the reference's gather and segment reduce): fp32
    arithmetic, one rounding to x's type. The rows are widened before the
    gather, so that autograd of this twin sums a gathered row's cotangent
    in fp32 too, as K8b does. ``edge`` [E, ...]: each edge's row added to
    its gathered row (``edge_mode`` add), then relu'd (gine)."""
    rows = x.float() if src is None else x.float()[src.long()]
    if edge is not None:
        rows = rows + edge.float().reshape(rows.shape)
        if edge_mode == "gine":
            rows = torch.relu(rows)
    e, trailing = rows.shape[0], tuple(rows.shape[1:])
    c = math.prod(trailing)
    acc = _per_column(rows.reshape(e, c), None if weight is None
                      else weight.float().reshape(e, _cols(weight)))
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


_EDGE_MODES = {None: 0, "add": 1, "gine": 2}


def _segment_reduce_fwd(x, segment_ids, num_segments, op="sum", src=None,
                        weight=None, index=None, edge=None, edge_mode=None):
    """K8 launch (plain twin for CPU tensors): see :func:`segment_reduce`
    and, for ``edge`` [E, C] with ``edge_mode`` add | gine, :func:`coo_spmm`."""
    if x.device.type == "cpu":
        return _segment_reduce_plain(x, segment_ids, num_segments, op, src,
                                     weight, edge, edge_mode)
    e = segment_ids.shape[0]
    index = _index(segment_ids, num_segments, index, e, src)
    c = math.prod(x.shape[1:])
    xf = x.contiguous().reshape(x.shape[0], c)
    ea = None
    if edge is not None:
        ea = edge.contiguous().reshape(e, c)
        if ea.dtype != xf.dtype or op != "sum":
            raise ValueError("segment_reduce: the edge rows join a sum, in "
                             "x's type")
    mode = gather_mode(src, index)
    composed = mode == "composed"
    gathered = index.gathered if composed else None
    gather = (None if src is None or composed
              else src.to(torch.int32).contiguous())
    w = (None if weight is None
         else weight.float().reshape(e, _cols(weight)).contiguous())
    extra = tuple(t for t in (gather, gathered, w, ea) if t is not None)
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
    vec = int((c * esize) % 16 == 0 and (wc * esize) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (xf, out, ea) if t is not None))
    if num_segments * c:
        _build.launch("segment_reduce", "gigl_segment_reduce", device,
                      xf.data_ptr(), _build.ptr(gather),
                      index.order.data_ptr(), _build.ptr(gathered),
                      index.ptr.data_ptr(), _build.ptr(w), out.data_ptr(),
                      num_segments, c, wc, w_cols, _DTYPES[x.dtype],
                      _OPS[op], vec, _build.ptr(ea), _EDGE_MODES[edge_mode],
                      None, None, 0.0, None, None, 0)
        if mode is not None:
            _build.launches[f"segment_reduce_{mode}"] += 1
        if edge_mode is not None:
            _build.launches[f"segment_reduce_{edge_mode}"] += 1
    return out.reshape((num_segments,) + tuple(x.shape[1:]))


# -- K8b segment_reduce_bwd -----------------------------------------------------
def _segment_reduce_bwd_plain(g, segment_ids, num_rows, op="sum", src=None,
                              weight=None, x=None):
    """Plain twin of K8b, the reference's autodiff: each edge's cotangent
    row ``g[dst]`` (divided by the mean's count; for max, g's share among
    the segment's ties, none where the maximum is not finite) times its
    weight, summed into its source row (or kept per edge without ``src``).
    fp32 arithmetic, one rounding; [num_rows, C]."""
    s = g.shape[0]
    c = math.prod(g.shape[1:])
    ids = segment_ids.long()
    e = ids.shape[0]
    gf = g.float().reshape(s, c)
    w = None if weight is None else weight.float().reshape(e, _cols(weight))
    if op == "max":
        rows = x.float().reshape(x.shape[0], c)
        vals = _per_column(rows if src is None else rows[src.long()], w)
        m = torch.full((s, c), float("-inf"), device=gf.device).scatter_reduce(
            0, ids[:, None].expand(e, c), vals, "amax")
        tie = vals == m[ids]
        ties = torch.zeros((s, c), device=gf.device).index_add(0, ids,
                                                               tie.float())
        share = torch.where(torch.isfinite(m), gf / ties.clamp(min=1.0), 0.0)
        contrib = _per_column(torch.where(tie, share[ids], 0.0), w)
    else:
        contrib = gf[ids]
        if op == "mean":
            contrib = contrib / _counts(segment_ids, s, None,
                                        g.dtype)[ids][:, None]
        contrib = _per_column(contrib, w)
    if src is not None:
        contrib = torch.zeros((num_rows, c), device=gf.device).index_add(
            0, src.long(), contrib)
    return contrib.to(g.dtype)


def segment_reduce_bwd(g: torch.Tensor, segment_ids: torch.Tensor,
                       num_rows: int, *, op: str = "sum",
                       src: Optional[torch.Tensor] = None,
                       weight: Optional[torch.Tensor] = None,
                       x: Optional[torch.Tensor] = None,
                       index: Optional[SegmentIndex] = None,
                       src_index: Optional[SegmentIndex] = None
                       ) -> torch.Tensor:
    """K8b: the cotangent [num_rows, C] of the rows ``x`` of ``out =
    segment_reduce(x, segment_ids, S, op=op, src=src, weight=weight)``
    from the output's cotangent ``g`` [S, ...]:
    ``dx[r] = sum_{e: row(e) = r} w_e * c_e * g[segment_ids[e]]`` (c: 1, the
    mean's 1 / count, or max's tie share, which needs ``x``). With ``src``
    the kernel walks ``src_index`` (the SegmentIndex of ``src`` over
    ``num_rows``; built here when not given), reading each slot's
    destination from ``src_index.gathered`` when ``segment_ids`` is the
    tensor it was built from (:func:`gather_mode`), else through its order;
    without, row r is edge r's. ``index`` is the forward's (mean: its
    pointers; max: the tie pass walks it)."""
    if op not in _OPS:
        raise ValueError(f"Unknown reduce {op!r}")
    if op == "max" and x is None:
        raise ValueError("segment_reduce_bwd: max needs the forward's rows x")
    e, s = segment_ids.shape[0], g.shape[0]
    if (src is None and num_rows != e) or (
            src is not None and src.shape != (e,)):
        raise ValueError(f"segment_reduce_bwd: {e} edges for {num_rows} rows")
    if g.device.type == "cpu":
        return _segment_reduce_bwd_plain(g, segment_ids, num_rows, op, src,
                                         weight, x)
    c = math.prod(g.shape[1:])
    gf = g.contiguous().reshape(s, c)
    if op != "sum":
        index = _index(segment_ids, s, index, e)
    walk = gathered = mode = None
    if src is not None:
        if src_index is None:   # built with the ids: they run composed
            src_index = _index(src, num_rows, None, e, segment_ids)
            segment_ids = src_index.gather
        else:
            src_index = _index(src, num_rows, src_index, e)
        walk = (src_index.order, src_index.ptr)
        mode = gather_mode(segment_ids, src_index)
        if mode == "composed":
            gathered = src_index.gathered
    dst32 = segment_ids.to(torch.int32).contiguous()
    w = (None if weight is None
         else weight.float().reshape(e, _cols(weight)).contiguous())
    xf = None if op != "max" else x.contiguous().reshape(x.shape[0], c)
    tables = [t for t in (w, xf, gathered) if t is not None]
    tables += [] if walk is None else list(walk)
    tables += [] if op == "sum" else [index.order, index.ptr]
    device = _build.require_cuda("segment_reduce_bwd", gf, dst32, *tables)
    if gf.dtype not in _DTYPES or (xf is not None and xf.dtype != gf.dtype):
        raise ValueError(f"segment_reduce_bwd: dtype {g.dtype} not supported "
                         "(fp32 or bf16, x of g's type)")
    if xf is not None and xf.shape[0] != num_rows:
        raise ValueError("segment_reduce_bwd: x must have num_rows rows")
    w_cols = 1 if w is None else w.shape[1]
    if c % w_cols:
        raise ValueError(f"segment_reduce_bwd: {c} values per row do not "
                         f"split into {w_cols} weight columns")
    wc = c // w_cols
    out = torch.empty((num_rows, c), dtype=g.dtype, device=device)
    esize = gf.element_size()
    vec = int((c * esize) % 16 == 0 and (wc * esize) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (gf, out, xf) if t is not None))
    dtype = _DTYPES[g.dtype]
    gs = mref = None
    if op == "max":
        mref = torch.empty((s, c), dtype=torch.float32, device=device)
        gs = torch.empty_like(mref)
        gather = None if src is None else src.to(torch.int32).contiguous()
        if s * c:
            _build.launch("segment_reduce_bwd", "gigl_segment_max_ties",
                          device, gf.data_ptr(), xf.data_ptr(),
                          _build.ptr(gather), index.order.data_ptr(),
                          index.ptr.data_ptr(), _build.ptr(w),
                          mref.data_ptr(), gs.data_ptr(), s, c, wc, w_cols,
                          dtype, vec)
    if num_rows * c:
        _build.launch("segment_reduce_bwd", "gigl_segment_reduce_bwd", device,
                      gf.data_ptr(), _build.ptr(gs), _build.ptr(mref),
                      _build.ptr(xf), dst32.data_ptr(),
                      _build.ptr(None if walk is None else walk[0]),
                      _build.ptr(gathered),
                      _build.ptr(None if walk is None else walk[1]),
                      _build.ptr(index.ptr if op == "mean" else None),
                      _build.ptr(w), out.data_ptr(), num_rows, c, wc, w_cols,
                      dtype, _OPS[op], vec, 0, None, None, 0.0)
        if mode is not None:
            _build.launches[f"segment_reduce_bwd_{mode}"] += 1
    return out



def _edge_bwd_plain(g, segment_ids, num_rows, mode, src, weight, x, edge,
                    att, negative_slope):
    """Plain twin of K8b's gine and gatv2 modes (:func:`gine_bwd`,
    :func:`gatv2_src_bwd`): per edge, the gated or GATv2 term, summed into
    its source row; fp32 arithmetic, one rounding."""
    e = segment_ids.shape[0]
    c = math.prod(g.shape[1:])
    gd = g.float().reshape(g.shape[0], c)[segment_ids.long()]     # [E, C]
    xs = x.float().reshape(x.shape[0], c)[src.long()]
    w = None if weight is None else weight.float().reshape(e, _cols(weight))
    if mode == "gine":
        z = xs + edge.float().reshape(e, c)
        contrib = _per_column(torch.where(z > 0, gd, 0.0), w)
    else:
        z = xs + gd
        dz = _per_column(att.float().reshape(1, c).expand(e, c), w)
        contrib = torch.where(z >= 0, dz, negative_slope * dz)
    return torch.zeros((num_rows, c), device=g.device).index_add(
        0, src.long(), contrib).to(g.dtype)


def _segment_edge_bwd(g, segment_ids, num_rows, mode, src, weight, x, *,
                      edge=None, att=None, negative_slope=0.2,
                      src_index=None):
    """K8b's gine and gatv2 modes over the source walk (the module's
    wrappers below say what each computes)."""
    e = segment_ids.shape[0]
    if g.device.type == "cpu":
        return _edge_bwd_plain(g, segment_ids, num_rows, mode, src, weight,
                               x, edge, att, negative_slope)
    c = math.prod(g.shape[1:])
    gf = g.contiguous().reshape(g.shape[0], c)
    if src_index is None:   # built with the ids: they run composed
        src_index = _index(src, num_rows, None, e, segment_ids)
        segment_ids = src_index.gather
    else:
        src_index = _index(src, num_rows, src_index, e)
    mode_name = gather_mode(segment_ids, src_index)
    gathered = src_index.gathered if mode_name == "composed" else None
    dst32 = segment_ids.to(torch.int32).contiguous()
    w = (None if weight is None
         else weight.float().reshape(e, _cols(weight)).contiguous())
    xf = x.contiguous().reshape(x.shape[0], c)
    ea = None if edge is None else edge.contiguous().reshape(e, c)
    at = None if att is None else att.detach().float().contiguous().reshape(c)
    device = _build.require_cuda("segment_reduce_bwd", gf, dst32, xf,
                                 src_index.order, src_index.ptr, *(
                                     t for t in (w, ea, at, gathered)
                                     if t is not None))
    if gf.dtype not in _DTYPES or xf.dtype != gf.dtype or (
            ea is not None and ea.dtype != gf.dtype):
        raise ValueError(f"segment_reduce_bwd: dtype {g.dtype} not supported "
                         "(fp32 or bf16; x and the edge rows of g's type)")
    if xf.shape[0] != num_rows:
        raise ValueError("segment_reduce_bwd: x must have num_rows rows")
    w_cols = 1 if w is None else w.shape[1]
    if c % w_cols:
        raise ValueError(f"segment_reduce_bwd: {c} values per row do not "
                         f"split into {w_cols} weight columns")
    wc = c // w_cols
    out = torch.empty((num_rows, c), dtype=g.dtype, device=device)
    esize = gf.element_size()
    vec = int((c * esize) % 16 == 0 and (wc * esize) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (gf, out, xf, ea) if t is not None))
    if num_rows * c:
        _build.launch("segment_reduce_bwd", "gigl_segment_reduce_bwd", device,
                      gf.data_ptr(), None, None, xf.data_ptr(),
                      dst32.data_ptr(), src_index.order.data_ptr(),
                      _build.ptr(gathered), src_index.ptr.data_ptr(), None,
                      _build.ptr(w), out.data_ptr(), num_rows, c, wc, w_cols,
                      _DTYPES[g.dtype], _OPS["sum"], vec,
                      {"gine": 1, "gatv2": 2}[mode], _build.ptr(ea),
                      _build.ptr(at), float(negative_slope))
        _build.launches[f"segment_reduce_bwd_{mode_name}"] += 1
        _build.launches[f"segment_reduce_bwd_{mode}"] += 1
    return out


def gine_bwd(g: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             x: torch.Tensor, edge: torch.Tensor, *,
             src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K8b's gine mode: the cotangent [N, C] of x in ``out[d] = sum_{e:
    dst e = d} relu(x[src e] + edge[e])`` (GINEConv.coo), ``dx[r] =
    sum_{e: src e = r} 1[x[r] + edge[e] > 0] * g[dst e]`` (strict:
    ``jax.nn.relu``'s derivative at 0 is 0), walking ``src_index`` (the
    SegmentIndex of ``src`` over x's rows); each slot's edge row read by
    its edge id."""
    return _segment_edge_bwd(g, dst, x.shape[0], "gine", src, None, x,
                             edge=edge, src_index=src_index)


def gatv2_src_bwd(gl: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  hs: torch.Tensor, hd: torch.Tensor, att: torch.Tensor, *,
                  negative_slope: float = 0.2,
                  src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K8b's gatv2 mode: the cotangent [N, H * D] of the source table ``hs``
    [N, H, D] in GATv2's logits ``z[e, h] = sum_d att[h, d] * leaky(hs[src
    e] + hd[dst e])[h, d]`` from theirs ``gl`` [E, H]: ``sum_{e: src e = r}
    leaky'(hs[r] + hd[dst e]) * gl[e, h] * att[h]`` (leaky' 1 at >= 0, as
    JAX's), walking ``src_index``."""
    n = hs.shape[0]
    return _segment_edge_bwd(hd.reshape(hd.shape[0], -1), dst, n, "gatv2",
                             src, gl, hs.reshape(n, -1), att=att,
                             negative_slope=negative_slope,
                             src_index=src_index)


def _edge_rows_by_source_plain(rows, src, num_rows):
    """Plain twin of :func:`edge_rows_by_source`: index_add in fp32, one
    rounding."""
    e = src.shape[0]
    c = math.prod(rows.shape[1:])
    return torch.zeros((num_rows, c), device=rows.device).index_add(
        0, src.long(), rows.float().reshape(e, c)).to(rows.dtype)


def edge_rows_by_source(rows: torch.Tensor, src: torch.Tensor,
                        num_rows: int, *,
                        src_index: Optional[SegmentIndex] = None
                        ) -> torch.Tensor:
    """K8b's sum over the source walk of a per-edge table: ``out[r] =
    sum_{e: src e = r} rows[e]`` -> [num_rows, C] (GATv2 with edge rows:
    the source table's cotangent is the edge table's, summed by source).
    The kernel is K8b's composed sum with the source index's ``order`` as
    each slot's row: slot j reads ``rows[order[j]]``, fp32 sums in walk
    order, one rounding."""
    e = src.shape[0]
    c = math.prod(rows.shape[1:])
    if rows.shape[0] != e:
        raise ValueError(f"edge_rows_by_source: {rows.shape[0]} rows for "
                         f"{e} edges")
    if rows.device.type == "cpu":
        return _edge_rows_by_source_plain(rows, src, num_rows)
    src_index = _index(src, num_rows, src_index, e)
    rf = rows.contiguous().reshape(e, c)
    device = _build.require_cuda("segment_reduce_bwd", rf, src_index.order,
                                 src_index.ptr)
    if rf.dtype not in _DTYPES:
        raise ValueError("edge_rows_by_source: rows must be fp32 or bf16")
    out = torch.empty((num_rows, c), dtype=rows.dtype, device=device)
    vec = int((c * rf.element_size()) % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (rf, out)))
    if num_rows * c:
        _build.launch("segment_reduce_bwd", "gigl_segment_reduce_bwd", device,
                      rf.data_ptr(), None, None, None, None,
                      src_index.order.data_ptr(), src_index.order.data_ptr(),
                      src_index.ptr.data_ptr(), None, None, out.data_ptr(),
                      num_rows, c, c, 1, _DTYPES[rf.dtype], _OPS["sum"], vec,
                      0, None, None, 0.0)
        _build.launches["segment_reduce_bwd_composed"] += 1
        _build.launches["segment_reduce_bwd_edge_rows"] += 1
    return out


# Rows of K8's gatv2 destination walk (its grid's threads over a row's
# pieces, each keeping its d att partial), at most: the partials' buffer.
_GATV2_PARTIAL_ROWS = 4096


def _gatv2_dst_plain(gl, src, dst, hs, hd, att, negative_slope, edge=None):
    """Plain twin of K8's gatv2 destination walk: (dhd, d att), fp32."""
    e = src.shape[0]
    n, c = hd.shape[0], math.prod(hd.shape[1:])
    ks = hs.float().reshape(hs.shape[0], c)[src.long()]
    if edge is not None:
        ks = ks + edge.float().reshape(e, c)
    z = ks + hd.float().reshape(n, c)[dst.long()]
    g = gl.float().reshape(e, _cols(gl))
    dz = _per_column(att.float().reshape(1, c).expand(e, c), g)
    dhd = torch.zeros((n, c), device=hd.device).index_add(
        0, dst.long(), torch.where(z >= 0, dz, negative_slope * dz))
    leaky = torch.where(z >= 0, z, negative_slope * z)
    datt = _per_column(leaky, g).sum(0)
    return dhd.to(hd.dtype), datt


def gatv2_dst_bwd(gl: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  hs: torch.Tensor, hd: torch.Tensor, att: torch.Tensor, *,
                  negative_slope: float = 0.2,
                  index: Optional[SegmentIndex] = None,
                  edge: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's gatv2 mode, one walk of the destination ``index``: the
    cotangents of ``hd`` ([N, H * D], ``sum_{e: dst e = i} leaky'(z) * gl *
    att``) and of ``att`` (fp32 [H * D], ``sum_e gl[e, h] * leaky(z)``) in
    GATv2's logits (:func:`gatv2_src_bwd`); with ``edge`` [E, ...] (GATv2
    with edge rows) ``z = (hs[src] + edge) + hd[dst]``. The d att partials
    are summed in a fixed order: the same bits on every run."""
    e = src.shape[0]
    if hd.device.type == "cpu":
        return _gatv2_dst_plain(gl, src, dst, hs, hd, att, negative_slope,
                                edge)
    n, c = hd.shape[0], math.prod(hd.shape[1:])
    index = _index(dst, n, index, e, src)
    composed = gather_mode(src, index) == "composed"
    gathered = index.gathered if composed else None
    s32 = None if composed else src.to(torch.int32).contiguous()
    hsf = hs.contiguous().reshape(hs.shape[0], c)
    hdf = hd.contiguous().reshape(n, c)
    g = gl.float().reshape(e, _cols(gl)).contiguous()
    at = att.detach().float().contiguous().reshape(c)
    ea = None if edge is None else edge.contiguous().reshape(e, c)
    device = _build.require_cuda("segment_reduce", hsf, hdf, g, at,
                                 index.order, index.ptr, *(
                                     t for t in (s32, gathered, ea)
                                     if t is not None))
    if hsf.dtype not in _DTYPES or hdf.dtype != hsf.dtype or (
            ea is not None and ea.dtype != hsf.dtype):
        raise ValueError("gatv2_dst_bwd: hs, hd and the edge rows must "
                         "share one dtype, fp32 or bf16")
    heads = g.shape[1]
    if c % heads:
        raise ValueError(f"gatv2_dst_bwd: {c} values for {heads} heads")
    dh = c // heads
    dhd = torch.empty((n, c), dtype=hd.dtype, device=device)
    datt = torch.empty(c, dtype=torch.float32, device=device)
    partial = torch.empty((min(n, _GATV2_PARTIAL_ROWS), c),
                          dtype=torch.float32, device=device)
    esize = hsf.element_size()
    vec = int((c * esize) % 16 == 0 and (dh * esize) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (hsf, hdf, dhd, ea)
        if t is not None))
    _build.launch("segment_reduce", "gigl_segment_reduce", device,
                  hsf.data_ptr(), _build.ptr(s32), index.order.data_ptr(),
                  _build.ptr(gathered), index.ptr.data_ptr(), g.data_ptr(),
                  dhd.data_ptr(), n, c, dh, heads, _DTYPES[hsf.dtype],
                  _OPS["sum"], vec, _build.ptr(ea), 3, hdf.data_ptr(),
                  at.data_ptr(),
                  float(negative_slope), datt.data_ptr(), partial.data_ptr(),
                  _GATV2_PARTIAL_ROWS)
    _build.launches["segment_reduce_" + ("composed" if composed
                                         else "chained")] += 1
    _build.launches["segment_reduce_gatv2"] += 1
    if ea is not None:
        _build.launches["segment_reduce_gatv2_edge"] += 1
    return dhd, datt

def _weight_grad(g, x, segment_ids, op, src, weight, index):
    """The weights' cotangent: per edge and weight column, the dot of the
    destination's cotangent with the edge's row (over the column's values),
    divided by the mean's count — K10's forward on (g, x)."""
    if op == "max":
        raise NotImplementedError(
            "segment_reduce: the weight gradient of the max mode is not "
            "ported (no conv trains a weighted max)")
    e, s = segment_ids.shape[0], g.shape[0]
    w_cols = _cols(weight)
    c = math.prod(x.shape[1:])
    rows = src if src is not None else torch.arange(
        e, dtype=torch.int32, device=x.device)
    dw = _sddmm_fwd(rows, segment_ids, g.reshape(s, w_cols, c // w_cols),
                    x.reshape(x.shape[0], w_cols, c // w_cols),
                    index=index).float()
    if op == "mean":
        dw = dw / _counts(segment_ids, s, index,
                          x.dtype)[segment_ids.long()][:, None]
    return dw.reshape(weight.shape).to(weight.dtype)


class SegmentReduce(torch.autograd.Function):
    """K8; the backward is K8b for the rows and K10 for the weights."""

    @staticmethod
    def forward(ctx, x, weight, segment_ids, num_segments, op, src, index,
                src_index):
        out = _segment_reduce_fwd(x, segment_ids, num_segments, op, src,
                                  weight, index)
        ctx.save_for_backward(x, weight, segment_ids, src)
        ctx.cfg = (op, index, src_index)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, ids, src = ctx.saved_tensors
        op, index, src_index = ctx.cfg
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = segment_reduce_bwd(
                g, ids, x.shape[0], op=op, src=src, weight=weight,
                x=x if op == "max" else None, index=index,
                src_index=src_index).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(g, x, ids, op, src, weight, index)
        return dx, dw, None, None, None, None, None, None


def segment_reduce(x: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, *, op: str = "sum",
                   src: Optional[torch.Tensor] = None,
                   weight: Optional[torch.Tensor] = None,
                   index: Optional[SegmentIndex] = None,
                   src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K8: ``out[s] = op_{e: segment_ids[e] = s} weight[e] * row(e)`` with
    ``row(e) = x[src[e]]`` (src given) or ``x[e]``; x [M, ...], weight
    [E] or [E, W] (W columns over the flattened trailing values: per head
    for a [.., H, dk] row), op ``sum`` | ``mean`` | ``max`` -> [S, ...].
    Empty segments give 0. Differentiable in x (K8b over ``src_index``)
    and in the weights of sum and mean (K10)."""
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
    if index is None and x.device.type != "cpu":
        index = _index(segment_ids, num_segments, None, e, src)
        if src is not None:   # the index's own src runs composed
            src = index.gather
    elif index is not None:
        index = _index(segment_ids, num_segments, index, e)
    if not _grad_on(x, weight):
        return _segment_reduce_fwd(x, segment_ids, num_segments, op, src,
                                   weight, index)
    return SegmentReduce.apply(x, weight, segment_ids, num_segments, op, src,
                               index, src_index)


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
             reduce: str = "sum", index: Optional[SegmentIndex] = None,
             src_index: Optional[SegmentIndex] = None,
             edge_rows: Optional[torch.Tensor] = None,
             edge_mode: str = "add") -> torch.Tensor:
    """Sparse A @ X over COO edges: ``out[d] = reduce_{(s, d) in E} w *
    x[s]`` (K8 in gather mode); ``edge_weight`` [E], or [E, H] for x
    [N, H, dk] / [N, H * dk]. ``index`` is the SegmentIndex of ``dst``,
    ``src_index`` that of ``src`` over x's rows (the backward's walk).

    ``edge_rows`` [E, ...] (one row of x's trailing shape and type per
    edge, by edge id): the COO per-edge terms, sum only. ``edge_mode``
    ``add``: ``w * (x[s] + edge_rows[e])`` (EdgeAttrGAT's and the
    Transformer's values; backward K8b for x, K10 with the addend for the
    weights, K11's COO form for the edge rows); ``gine``: ``relu(x[s] +
    edge_rows[e])``, no weights (GINEConv; backward K8b's gine gate and
    K11 gine). K8 reads each edge's row by its id, in sequence when the
    edges are in walk order (:func:`coo_walk`)."""
    if reduce not in _OPS:
        raise ValueError(f"Unknown reduce {reduce!r}")
    if edge_rows is None:
        return segment_reduce(x, dst, num_dst, op=reduce, src=src,
                              weight=edge_weight, index=index,
                              src_index=src_index)
    if edge_mode not in ("add", "gine") or reduce != "sum":
        raise ValueError(f"coo_spmm: edge rows join a sum, in mode add or "
                         f"gine (got {reduce!r}, {edge_mode!r})")
    e = src.shape[0]
    if dst.shape != (e,) or edge_rows.shape[0] != e \
            or math.prod(edge_rows.shape[1:]) != math.prod(x.shape[1:]):
        raise ValueError("coo_spmm: edge_rows must be [E, ...] with x's "
                         "trailing size")
    if edge_mode == "gine" and edge_weight is not None:
        raise ValueError("coo_spmm: the gine mode takes no weights")
    if x.device.type != "cpu":
        index, src_index = _pair(src, dst, x.shape[0], num_dst, index,
                                 src_index)
    if not _grad_on(x, edge_weight, edge_rows):
        return _segment_reduce_fwd(x, dst, num_dst, "sum", src, edge_weight,
                                   index, edge_rows, edge_mode)
    return CooEdgeSpmm.apply(x, edge_weight, edge_rows, src, dst, num_dst,
                             edge_mode, index, src_index)


def _pair(src, dst, num_src, num_dst, index, src_index):
    """The destination and source indexes of a call on the card, built
    here (each composing the other side's ids) where not given."""
    e = src.shape[0]
    index = _index(dst, num_dst, index, e, src)
    src_index = _index(src, num_src, src_index, e, dst)
    return index, src_index


class CooEdgeSpmm(torch.autograd.Function):
    """K8 with edge rows (:func:`coo_spmm`); the backward is K8b (weighted,
    or its gine gate) for x, K10 with the addend for the weights and K11's
    COO form for the edge rows."""

    @staticmethod
    def forward(ctx, x, weight, edge, src, dst, num_dst, mode, index,
                src_index):
        out = _segment_reduce_fwd(x, dst, num_dst, "sum", src, weight, index,
                                  edge, mode)
        ctx.save_for_backward(x, weight, edge, src, dst)
        ctx.cfg = (mode, index, src_index)
        return out

    @staticmethod
    def backward(ctx, g):
        from gigl_tpu_torch.ops.ell import coo_edge_grad
        x, weight, edge, src, dst = ctx.saved_tensors
        mode, index, src_index = ctx.cfg
        e, n = src.shape[0], x.shape[0]
        c = math.prod(x.shape[1:])
        g = g.contiguous().reshape(g.shape[0], c)
        dx = dw = de = None
        if mode == "gine":
            if ctx.needs_input_grad[0]:
                dx = gine_bwd(g, src, dst, x.reshape(n, c),
                              edge.reshape(e, c), src_index=src_index)
            if ctx.needs_input_grad[2]:
                de = coo_edge_grad(g, src, dst, index, "gine",
                                   x=x.reshape(n, c), ea=edge.reshape(e, c))
        else:
            w_cols = 1 if weight is None else _cols(weight)
            if ctx.needs_input_grad[0]:
                dx = segment_reduce_bwd(g, dst, n, src=src, weight=weight,
                                        index=index, src_index=src_index)
            if ctx.needs_input_grad[1]:
                dw = _sddmm_fwd(src, dst, g.reshape(-1, w_cols, c // w_cols),
                                x.reshape(n, w_cols, c // w_cols),
                                index=index,
                                edge=edge.reshape(e, w_cols, c // w_cols))
                dw = dw.reshape(weight.shape).to(weight.dtype)
            if ctx.needs_input_grad[2]:
                alpha = (torch.ones((e, 1), device=g.device)
                         if weight is None
                         else weight.float().reshape(e, w_cols))
                de = coo_edge_grad(g, src, dst, index, "gat", alpha=alpha,
                                   heads=alpha.shape[1])
        return (None if dx is None else dx.reshape(x.shape), dw,
                None if de is None else de.reshape(edge.shape),
                None, None, None, None, None, None)


@dataclass
class CooWalk:
    """A COO graph's edges relabelled in its destination walk order: walk
    slot j holds edge ``perm[j]`` (the destination index's ``order``), so
    ``src``, ``dst`` and any per-edge table permuted by ``perm`` list the
    same graph with every segment's edges contiguous and in their original
    order, and ``index`` / ``src_index`` are its SegmentIndexes (the
    destination one's order the identity). The segment kernels read an
    edge table of this graph by edge id, which is then its walk slot: in
    sequence in the destination walk (K8, K10, K11), at the composed
    position ``src_index.order`` (each source slot's destination-walk
    rank) in the source walk (K8b). Node outputs are unchanged: every
    segment sums the same edges in the same order."""

    src: torch.Tensor    # [E] int32, walk order
    dst: torch.Tensor    # [E] int32, sorted
    index: SegmentIndex
    src_index: SegmentIndex
    perm: torch.Tensor   # [E] int32: original edge id of walk slot j
    rank: torch.Tensor   # [E] int32: walk slot of original edge e


def coo_walk(index: SegmentIndex, src: torch.Tensor,
             num_src: Optional[int] = None) -> CooWalk:
    """The walk-ordered graph of the edges ``src`` -> the destinations of
    ``index`` (``num_src`` source rows, the destination count by default),
    built on the host. When ``src`` is the tensor the index was built from
    (:func:`gather_mode` composed) the walk is built once and kept on the
    index; for any other ``src`` it is built anew."""
    kept = gather_mode(src, index) == "composed"
    if kept and index.walk is not None:
        return index.walk
    if src.shape != (index.num_edges,):
        raise ValueError(f"coo_walk: {tuple(src.shape)} source ids for "
                         f"{index.num_edges} edges")
    device = index.device
    n = index.num_segments
    order = index.order.cpu().numpy()
    ptr = index.ptr.cpu().numpy()
    src_w = (index.gathered if kept else src.long()[index.order.long()]
             ).cpu().numpy().astype(np.int32)
    dst_w = np.repeat(np.arange(n, dtype=np.int32), np.diff(ptr))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order), dtype=np.int32)
    w_index = SegmentIndex.from_ids(dst_w, n, device, gather=src_w)
    w_src_index = SegmentIndex.from_ids(src_w, n if num_src is None
                                        else num_src, device, gather=dst_w)
    walk = CooWalk(src=w_index.gather, dst=w_src_index.gather,
                   index=w_index, src_index=w_src_index, perm=index.order,
                   rank=torch.from_numpy(rank).to(device))
    if kept:
        index.walk = walk
    return walk


def gather_edges(table: torch.Tensor, ids: torch.Tensor, *,
                 index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """``table[ids]``: a per-node table [N, ...] read per edge, ids [E].
    The forward is a row gather, K3 (a bf16 row of odd width padded to
    whole 4-byte words first); its backward sums each edge's
    cotangent row into its node's row with K8 over ``index`` (the
    SegmentIndex of ``ids``), not with a scatter."""
    if not _grad_on(table):
        return _gather_edge_rows(table, ids)
    if table.device.type != "cpu":
        index = _index(ids, table.shape[0], index, ids.shape[0])
    return _GatherEdges.apply(table, ids, index)


def _gather_edge_rows(table, ids):
    rows = table.reshape(table.shape[0], -1)
    w = rows.shape[1]
    if (w * rows.element_size()) % 4:
        # K3 moves 4-byte words: a bf16 row of odd width (the attention
        # terms of 1 or 3 heads) is padded by one column for the gather
        rows = torch.nn.functional.pad(rows, (0, 1))
    got, _ = gather_rows(rows.contiguous(), ids.to(torch.int32))
    return got[..., :w].reshape(tuple(ids.shape) + tuple(table.shape[1:]))


class _GatherEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, index):
        ctx.save_for_backward(ids)
        ctx.cfg = (table.shape[0], index)
        return _gather_edge_rows(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n, index = ctx.cfg
        return (_segment_reduce_fwd(g.contiguous(), ids, n, "sum",
                                    index=index), None, None)


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


def _softmax_streams(rows: torch.Tensor, tables: int = 2) -> bool:
    """K9's and K9b's evict-first reads: for rows narrower than a 32-byte
    sector (each written a part of a sector at a time) when the ``tables``
    [E, H] tables the kernel reads and writes (K9: the logits and alpha;
    K9b: alpha, g and dlogits) pass three quarters of the device's L2
    (PERF.md §6: K9 at 64 and 44.8 MB 1.8-1.9x faster; at 32 MB 12%
    slower, the L2 holding them)."""
    row = _cols(rows) * rows.element_size()
    l2 = torch.cuda.get_device_properties(rows.device).L2_cache_size
    return row < 32 and tables * rows.shape[0] * row > 0.75 * l2


def _segment_softmax_fwd(logits, segment_ids, num_segments, index=None):
    """K9 launch (plain twin for CPU tensors)."""
    if logits.device.type == "cpu":
        return _segment_softmax_plain(logits, segment_ids, num_segments)
    e = segment_ids.shape[0]
    index = _index(segment_ids, num_segments, index, e)
    lg = logits.contiguous()
    device = _build.require_cuda("segment_softmax", lg, index.order,
                                 index.ptr)
    if lg.dtype not in _DTYPES:
        raise ValueError(f"segment_softmax: dtype {lg.dtype} not supported")
    out = torch.empty_like(lg)
    heads = _cols(lg)
    vec = int(lg.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    if num_segments and e:
        _build.launch("segment_softmax", "gigl_segment_softmax", device,
                      lg.data_ptr(), index.order.data_ptr(),
                      index.ptr.data_ptr(), out.data_ptr(), num_segments,
                      heads, _DTYPES[lg.dtype], vec,
                      int(_softmax_streams(lg)))
    return out


def _segment_softmax_bwd_plain(alpha, g, segment_ids, num_segments):
    """Plain twin of K9b: ``alpha * (g - sum_seg(alpha * g))`` per head,
    fp32, one rounding to alpha's type."""
    e = alpha.shape[0]
    a = alpha.float().reshape(e, _cols(alpha))
    gf = g.float().reshape(a.shape)
    ids = segment_ids.long()
    s = torch.zeros((num_segments, a.shape[1]), device=a.device).index_add(
        0, ids, a * gf)
    return (a * (gf - s[ids])).reshape(alpha.shape).to(alpha.dtype)


def segment_softmax_bwd(alpha: torch.Tensor, g: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int, *,
                        index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K9b: the logits' cotangent from the softmax ``alpha`` [E] or [E, H]
    (K9's output) and its cotangent ``g``, walking the forward's
    ``index``."""
    e = segment_ids.shape[0]
    if alpha.shape != g.shape or alpha.shape[0] != e or alpha.dim() > 2:
        raise ValueError("segment_softmax_bwd: alpha and g must be [E] or "
                         "[E, H]")
    if alpha.device.type == "cpu":
        return _segment_softmax_bwd_plain(alpha, g, segment_ids, num_segments)
    index = _index(segment_ids, num_segments, index, e)
    a, gc = alpha.contiguous(), g.contiguous().to(alpha.dtype)
    device = _build.require_cuda("segment_softmax_bwd", a, gc, index.order,
                                 index.ptr)
    if a.dtype not in _DTYPES:
        raise ValueError(f"segment_softmax_bwd: dtype {a.dtype} not "
                         "supported")
    if _cols(a) > 16:
        raise ValueError(f"segment_softmax_bwd: {_cols(a)} heads (at most "
                         "16)")
    out = torch.empty_like(a)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (a, gc, out)))
    if num_segments and e:
        _build.launch("segment_softmax_bwd", "gigl_segment_softmax_bwd",
                      device, a.data_ptr(), gc.data_ptr(),
                      index.order.data_ptr(), index.ptr.data_ptr(),
                      out.data_ptr(), num_segments, _cols(a),
                      _DTYPES[a.dtype], vec,
                      int(_softmax_streams(a, 3)))  # alpha, g, dlogits
    return out


class SegmentSoftmax(torch.autograd.Function):
    """K9; the backward is K9b from the saved softmax."""

    @staticmethod
    def forward(ctx, logits, segment_ids, num_segments, index):
        out = _segment_softmax_fwd(logits, segment_ids, num_segments, index)
        ctx.save_for_backward(out, segment_ids)
        ctx.cfg = (num_segments, index)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, ids = ctx.saved_tensors
        n, index = ctx.cfg
        return segment_softmax_bwd(alpha, g, ids, n, index=index), None, \
            None, None


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, *,
                    index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K9: softmax of ``logits`` [E] or [E, H] within each segment, in the
    original edge order. Differentiable (K9b)."""
    e = segment_ids.shape[0]
    if logits.dim() not in (1, 2) or logits.shape[0] != e:
        raise ValueError("segment_softmax: logits must be [E] or [E, H]")
    if logits.device.type != "cpu":
        index = _index(segment_ids, num_segments, index, e)
    if not _grad_on(logits):
        return _segment_softmax_fwd(logits, segment_ids, num_segments, index)
    return SegmentSoftmax.apply(logits, segment_ids, num_segments, index)


# -- K10 sddmm ------------------------------------------------------------------
# Rows of this many bytes and more take K10's walk of the destination index
# (csrc/sddmm.cu's kWalkRowBytes); narrower rows run in edge order.
_SDDMM_WALK_ROW_BYTES = 512


def _sddmm_plain(src, dst, q, k, scale=None, edge=None, att=None,
                 negative_slope=0.2):
    """Plain twin of K10: fp32 products summed over the last axis, one
    rounding to q's type; with ``edge`` the key rows plus each edge's row;
    with ``att`` GATv2's ``sum att * leaky(k[src] + q[dst])``."""
    kv = k.float()[src.long()]
    if edge is not None:
        kv = kv + edge.float().reshape(kv.shape)
    if att is not None:
        z = kv + q.float()[dst.long()]
        z = torch.where(z >= 0, z, negative_slope * z)
        out = (z * att.float().reshape(q.shape[1:])).sum(-1)
    else:
        out = (q.float()[dst.long()] * kv).sum(-1)
    if scale is not None:
        out = out * scale.float()
    return out.to(q.dtype)


def _sddmm_fwd(src, dst, q, k, scale=None, index=None, edge=None, att=None,
               negative_slope=0.2):
    """K10 launch (plain twin for CPU tensors): see :func:`sddmm`; the
    kernel walks ``index``, the SegmentIndex of ``dst`` over q's rows, at
    rows of _SDDMM_WALK_ROW_BYTES and more (built here when not given), and
    reads no index below. With ``edge`` [E, ...] (the key addend) or
    ``att`` [H, D] (GATv2's scores of ``leaky(k[src] + q[dst])``; with both,
    ``leaky((k[src] + edge) + q[dst])``) it walks the index at every width
    (:func:`gatv2_scores`)."""
    if q.device.type == "cpu":
        return _sddmm_plain(src, dst, q, k, scale, edge, att, negative_slope)
    if edge is not None or att is not None:
        return _sddmm_edge_fwd(src, dst, q, k, scale, index, edge, att,
                               negative_slope)
    e = src.shape[0]
    heads = q.shape[1] if q.dim() == 3 else 1
    c = math.prod(q.shape[1:])
    if c * q.element_size() >= _SDDMM_WALK_ROW_BYTES:
        index = _index(dst, q.shape[0], index, e)
    qf = q.contiguous().reshape(q.shape[0], c)
    kf = k.contiguous().reshape(k.shape[0], c)
    s32, d32 = (t.to(torch.int32).contiguous() for t in (src, dst))
    sc = None if scale is None else scale.detach().float().contiguous()
    order, ptr = (None, None) if index is None else (index.order, index.ptr)
    device = _build.require_cuda("sddmm", *(
        t for t in (qf, kf, s32, d32, order, ptr, sc) if t is not None))
    if qf.dtype not in _DTYPES or kf.dtype != qf.dtype:
        raise ValueError("sddmm: q and k must share one dtype, fp32 or bf16")
    out = torch.empty((e, heads), dtype=q.dtype, device=device)
    if e:
        _build.launch("sddmm", "gigl_sddmm", device, qf.data_ptr(),
                      kf.data_ptr(), s32.data_ptr(), d32.data_ptr(),
                      _build.ptr(order), _build.ptr(ptr), _build.ptr(sc),
                      out.data_ptr(), e, q.shape[0], c, heads,
                      _DTYPES[q.dtype], 0, None, None, None, 0.0, 0)
    return out if q.dim() == 3 else out.reshape(e)


def _sddmm_edge_fwd(src, dst, q, k, scale, index, edge, att, negative_slope):
    """K10's addend and gatv2 modes (and gatv2 with the edge row added to
    the key, given both) over ``index``: its walk for rows of
    _SDDMM_WALK_ROW_BYTES and more (a lane map's shapes), else a thread per
    (destination, head), which reads each slot's row from the index's
    composed ``gathered`` when ``src`` is its gather (:func:`gather_mode`)."""
    e = src.shape[0]
    heads = q.shape[1] if q.dim() == 3 else 1
    c = math.prod(q.shape[1:])
    index = _index(dst, q.shape[0], index, e, src)
    qf = q.contiguous().reshape(q.shape[0], c)
    kf = k.contiguous().reshape(k.shape[0], c)
    ea = None if edge is None else edge.contiguous().reshape(e, c)
    at = None if att is None else att.detach().float().contiguous().reshape(c)
    composed = gather_mode(src, index) == "composed"
    gathered = index.gathered if composed else None
    s32 = src.to(torch.int32).contiguous()
    sc = None if scale is None else scale.detach().float().contiguous()
    device = _build.require_cuda("sddmm", *(
        t for t in (qf, kf, s32, index.order, index.ptr, gathered, sc, ea, at)
        if t is not None))
    if qf.dtype not in _DTYPES or kf.dtype != qf.dtype or (
            ea is not None and ea.dtype != qf.dtype):
        raise ValueError("sddmm: q, k and the edge rows must share one "
                         "dtype, fp32 or bf16")
    out = torch.empty((e, heads), dtype=q.dtype, device=device)
    mode = 1 if at is None else (2 if ea is None else 3)
    dk_bytes = (c // heads) * qf.element_size()
    vec = int(dk_bytes % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (qf, kf, ea) if t is not None))
    if e:
        _build.launch("sddmm", "gigl_sddmm", device, qf.data_ptr(),
                      kf.data_ptr(), _build.ptr(s32), None,
                      index.order.data_ptr(), index.ptr.data_ptr(),
                      _build.ptr(sc), out.data_ptr(), e, q.shape[0], c, heads,
                      _DTYPES[q.dtype], mode, _build.ptr(gathered),
                      _build.ptr(ea), _build.ptr(at), float(negative_slope),
                      vec)
        _build.launches[("sddmm_addend", "sddmm_gatv2",
                         "sddmm_gatv2_edge")[mode - 1]] += 1
    return out if q.dim() == 3 else out.reshape(e)


# -- K10b sddmm_bwd -------------------------------------------------------------
# Rows of K10b's buffer of the blocks' partial sums: its grid's largest
# size, at least what the SMs of an H100 hold at once (132 x 4 blocks).
_SDDMM_BWD_PARTIAL_ROWS = 1024


def _sddmm_bwd_coef_plain(g, scale=None, raw=None):
    """Plain twin of K10b: fp32 ``g * scale`` and ``sum_e g * raw``."""
    gf = g.float()
    coef = gf if scale is None else gf * scale.float()
    return coef, None if raw is None else (gf * raw.float()).sum(0)


def sddmm_bwd_coef(g: torch.Tensor, scale: Optional[torch.Tensor] = None,
                   raw: Optional[torch.Tensor] = None):
    """K10b: from the scores' cotangent ``g`` [E, H], the per-edge
    coefficients ``g * scale`` (fp32 [E, H]) that weigh dq's and dk's
    gathers, and, given the unscaled scores ``raw`` [E, H], the scale's
    cotangent ``sum_e g * raw`` (fp32 [H]; else None). One CUDA launch in
    every mode: the block that finishes last sums the blocks' partials of
    the scale's cotangent (in a buffer of this call's) in a fixed order (a
    repeat run is bit-equal), found by a per-device ticket counter that is
    0 between calls (:func:`sddmm_bwd_ticket` reads it). K10b's calls on
    one device must be ordered on one stream: two in flight at once on
    two streams would share the counter."""
    if g.dim() != 2 or (raw is not None and raw.shape != g.shape):
        raise ValueError("sddmm_bwd_coef: g (and raw) must be [E, H]")
    e, heads = g.shape
    if scale is not None and scale.shape != (heads,):
        raise ValueError(f"sddmm_bwd_coef: scale must be [{heads}]")
    if g.device.type == "cpu":
        return _sddmm_bwd_coef_plain(g, scale, raw)
    gc = g.contiguous()
    sc = None if scale is None else scale.detach().float().contiguous()
    rc = None if raw is None else raw.contiguous()
    if rc is not None and rc.dtype != gc.dtype:
        # the kernel reads both in one type: fp32, as the twin sums them
        # (g's values, and so coef, are the same)
        gc, rc = gc.float(), rc.float()
    device = _build.require_cuda(
        "sddmm_bwd", gc, *(t for t in (sc, rc) if t is not None))
    if gc.dtype not in _DTYPES:
        raise ValueError(f"sddmm_bwd_coef: dtype {g.dtype} not supported")
    if heads > 16:
        raise ValueError(f"sddmm_bwd_coef: {heads} heads (at most 16)")
    coef = torch.empty((e, heads), dtype=torch.float32, device=device)
    dscale = partial = None
    if rc is not None:
        dscale = torch.empty(heads, dtype=torch.float32, device=device)
        partial = torch.empty((_SDDMM_BWD_PARTIAL_ROWS, heads),
                              dtype=torch.float32, device=device)
    if e or dscale is not None:
        _build.launch("sddmm_bwd", "gigl_sddmm_bwd", device, gc.data_ptr(),
                      _build.ptr(sc), _build.ptr(rc), coef.data_ptr(),
                      _build.ptr(dscale), _build.ptr(partial), e, heads,
                      _SDDMM_BWD_PARTIAL_ROWS, _DTYPES[gc.dtype])
    return coef, dscale


def sddmm_bwd_ticket(device: torch.device) -> int:
    """K10b's ticket counter on ``device`` (0 whenever no launch with the
    scale's cotangent is in flight there), read after the work queued on
    the current stream."""
    out = torch.empty((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _build.library().gigl_sddmm_bwd_ticket(
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gigl_sddmm_bwd_ticket: cudaError {rc}")
    return int(out)


class SDDMM(torch.autograd.Function):
    """K10; the backward is K10b's coefficients (and the scale's
    cotangent, from a second, unscaled K10; without a scale the
    coefficients are the cotangent itself), then dq as K8 over the
    destination index and dk as K8b over the source index, both weighted
    per head by the coefficients."""

    @staticmethod
    def forward(ctx, q, k, scale, src, dst, index, src_index):
        out = _sddmm_fwd(src, dst, q, k, scale, index)
        ctx.save_for_backward(q, k, scale, src, dst)
        ctx.cfg = (index, src_index)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, scale, src, dst = ctx.saved_tensors
        index, src_index = ctx.cfg
        need_q, need_k, need_s = ctx.needs_input_grad[:3]
        e = src.shape[0]
        heads = q.shape[1] if q.dim() == 3 else 1
        c = math.prod(q.shape[1:])
        g2, raw = g.reshape(e, heads), None
        if need_s:
            # the unscaled scores and g in fp32: a bf16 K10 output would
            # round each term of the scale's cotangent once more
            raw = _sddmm_fwd(src, dst, q.float(), k.float(),
                             index=index).reshape(e, heads)
            g2 = g2.float()
        if scale is None:   # the coefficients are g itself (K8 / K8b widen it)
            coef, dscale = g2, None
        else:
            coef, dscale = sddmm_bwd_coef(g2, scale, raw)
        dq = dk = None
        if need_q:   # K8 over the destination index
            dq = _segment_reduce_fwd(k.reshape(k.shape[0], c), dst,
                                     q.shape[0], "sum", src, coef,
                                     index).reshape(q.shape)
        if need_k:   # K8b over the source index
            dk = segment_reduce_bwd(q.reshape(q.shape[0], c), dst,
                                    k.shape[0], src=src, weight=coef,
                                    index=index,
                                    src_index=src_index).reshape(k.shape)
        if dscale is not None:
            dscale = dscale.to(scale.dtype)
        return dq, dk, dscale, None, None, None, None


def sddmm(src: torch.Tensor, dst: torch.Tensor, q: torch.Tensor,
          k: torch.Tensor, *, scale: Optional[torch.Tensor] = None,
          index: Optional[SegmentIndex] = None,
          src_index: Optional[SegmentIndex] = None) -> torch.Tensor:
    """K10: per-edge score ``<q[dst_e], k[src_e]>``; q [N_dst, H, D] or
    [N_dst, D], k likewise -> [E, H] or [E], each head's score times
    ``scale[h]`` (fp32 [H], or [1] without heads) when given.
    Differentiable in q, k and scale (K10b, K8, K8b); ``index`` is the
    SegmentIndex of ``dst`` over q's rows
    (``SegmentIndex.from_ids(dst, q.shape[0])``), ``src_index`` that of
    ``src`` over k's rows. Only their sizes are checked against the call:
    on the card K10 reads the destinations of rows of 512 bytes and more
    from ``index`` alone, so an index of other destinations with the same
    counts gives wrong scores there. Without one, a CUDA call at those
    widths builds it on the host."""
    if q.dim() not in (2, 3) or k.dim() != q.dim() \
            or k.shape[1:] != q.shape[1:]:
        raise ValueError("sddmm: q and k must be [N, H, D] or [N, D] with "
                         "the same trailing shape")
    heads = q.shape[1] if q.dim() == 3 else 1
    if scale is not None and scale.shape != (heads,):
        raise ValueError(f"sddmm: scale must be [{heads}]")
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError("sddmm: src and dst must be [E]")
    if index is not None:
        index = _index(dst, q.shape[0], index, src.shape[0])
    if not _grad_on(q, k, scale):
        return _sddmm_fwd(src, dst, q, k, scale, index)
    return SDDMM.apply(q, k, scale, src, dst, index, src_index)
