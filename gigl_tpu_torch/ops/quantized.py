"""Quantized feature tables: per-row symmetric int8 rows with fp32 scales
(port of ``gigl_tpu/ops/quantized.py``).

A :class:`QuantizedTable` holds ``q`` ``[N, D]`` int8 and ``scale`` ``[N,
1]`` fp32: 4x less device memory than an fp32 table, the capacity lever for
graphs whose features do not fit (the reference's MAG240M regime). Rows are
quantized on the host with the reference's numpy recipe (abs-max per row
over 127, ``np.rint``, clipped to +-127), so the int8 values and scales are
bit-equal to the reference's. The reference packs four int8 values into an
int32 lane where ``D % 4 == 0``, a workaround for the TPU's gather; here
every table stays int8 ``[N, D]`` and :mod:`gigl_tpu_torch.convert` unpacks
a reference table (``quantized_table_from_jax``).

Kernel K12 ``gather_rows_q8`` (``csrc/gather_rows_q8.cu``) is the
dequantizing gather of ``__getitem__``: rows ``q[ids]`` times their scales,
rounded once to ``out_dtype``, optionally with a per-row scalar (the degree)
gathered alongside. One launch takes up to :data:`MAX_SEGMENTS` such
gathers (:func:`gather_rows_q8_many`, ``QuantizedTable.gather_many``): a
sampled batch hydrates every tree level of both int8 tables in one.
:func:`_gather_rows_q8_plain` is its plain twin (per segment), used for
CPU tensors only. The neighbor cache (K2) reads a quantized feature table
in place (``ops/hopcache.py``).

A quantized PARTITIONED graph (``training/dist_sampled.py``) keeps the
reference's bit-packed rows instead: ``[q D | scale_f | deg]`` int8, ``D +
8`` bytes, or ``[q D | qc Dc | scale_f | scale_c | deg]``, ``D + Dc + 12``,
once the deepest-hop cache is fused in, the tail's fp32 words
little-endian. :func:`decode_packed_rows` is the reference's
``decode_rows`` / ``split_rows`` on such rows; K12's packed-row mode
(:func:`gather_packed_rows_q8`) gathers and decodes them in one pass (one
shard's closed form of the routed gather; K16's int8 mode decodes them
after the all_to_all at P > 1, ``parallel/feature_lookup.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gather_rows_q8_plain(q, scale, ids, out_dtype, row_vals=None):
    """(``(float(q[ids]) * scale[ids]).to(out_dtype)`` [..., D],
    ``row_vals[ids]`` or None): the reference's arithmetic, one fp32
    multiply and one rounding."""
    idx = ids.to(torch.int64)
    rows = (q[idx].to(torch.float32) * scale.reshape(-1)[idx][..., None]
            ).to(out_dtype)
    return rows, (None if row_vals is None else row_vals[idx])


# Gathers one K12 launch takes: csrc/gather_rows_q8.cu kMaxSegments.
MAX_SEGMENTS = 8

# A K12 gather: (q [N, D] int8, scale [N, 1] or [N] fp32, ids [...] int32,
# out_dtype, row_vals [N] fp32 or None).
Segment = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.dtype,
                Optional[torch.Tensor]]


def _gather_rows_q8_many_plain(segments: Sequence[Segment]):
    """The twin of :func:`gather_rows_q8_many`: each segment's plain
    gather."""
    return [_gather_rows_q8_plain(*seg) for seg in segments]


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def gather_rows_q8_many(
    segments: Sequence[Segment],
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """K12 over several gathers in one launch (one per
    :data:`MAX_SEGMENTS`): for each ``(q, scale, ids, out_dtype,
    row_vals)``, ``(rows [..., D] out_dtype, row_vals[ids] [...] fp32 or
    None)`` as :func:`gather_rows_q8` returns them. The outputs share one
    allocation, each at a 16-byte-aligned offset. CPU ids take the plain
    twin."""
    segments = list(segments)
    if not segments:
        return []
    if segments[0][2].device.type == "cpu":
        return _gather_rows_q8_many_plain(segments)
    device = None
    flats, sizes, total = [], [], 0
    for q, scale, ids, out_dtype, row_vals in segments:
        flat = ids.reshape(-1).contiguous()
        dev = _build.require_cuda("gather_rows_q8", flat, q, scale)
        if device is not None and dev != device:
            raise ValueError(f"gather_rows_q8: tensors on {device} and {dev}")
        device = dev
        if q.dtype != torch.int8 or q.dim() != 2:
            raise ValueError("gather_rows_q8: q must be a 2-D int8 table")
        n, d = q.shape
        if scale.dtype != torch.float32 or scale.numel() != n:
            raise ValueError("gather_rows_q8: scale must be f32 with one "
                             "value per row")
        if flat.dtype != torch.int32:
            raise ValueError("gather_rows_q8: ids must be int32")
        if out_dtype not in _DTYPES:
            raise ValueError(f"gather_rows_q8: out_dtype {out_dtype} not "
                             "supported (float32, bfloat16)")
        if n == 0 or d == 0:
            raise ValueError("gather_rows_q8: empty table")
        if row_vals is not None:
            _build.require_cuda("gather_rows_q8", flat, row_vals)
            if row_vals.dtype != torch.float32 or row_vals.shape != (n,):
                raise ValueError("gather_rows_q8: row_vals must be f32 [N]")
        m = flat.shape[0]
        rows_b = m * d * out_dtype.itemsize
        vals_b = 0 if row_vals is None else m * 4
        flats.append(flat)
        sizes.append((total, rows_b, vals_b))
        total += _aligned(rows_b) + _aligned(vals_b)
    buf = torch.empty((total,), dtype=torch.uint8, device=device)
    table = np.zeros((len(segments), 10), dtype=np.int64)
    outs = []
    for k, ((q, scale, ids, out_dtype, row_vals), flat,
            (at, rows_b, vals_b)) in enumerate(zip(segments, flats, sizes)):
        n, d = q.shape
        m = flat.shape[0]
        out = buf[at:at + rows_b].view(out_dtype).view(m, d)
        vals = None
        if row_vals is not None:
            v_at = at + _aligned(rows_b)
            vals = buf[v_at:v_at + vals_b].view(torch.float32)
        table[k] = (q.data_ptr(), scale.data_ptr(), n, d, flat.data_ptr(), m,
                    _DTYPES[out_dtype], out.data_ptr(),
                    _build.ptr(row_vals) or 0, _build.ptr(vals) or 0)
        shape = tuple(ids.shape)
        outs.append((out.reshape(shape + (d,)),
                     None if vals is None else vals.reshape(shape)))
    for k in range(0, len(segments), MAX_SEGMENTS):
        chunk = np.ascontiguousarray(table[k:k + MAX_SEGMENTS])
        _build.launch("gather_rows_q8", "gigl_gather_rows_q8_many", device,
                      chunk.ctypes.data, chunk.shape[0])
    return outs


def gather_rows_q8(
    q: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    row_vals: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K12: q [N, D] int8, scale [N, 1] (or [N]) fp32, ids [...] int32 ->
    (rows [..., D] ``out_dtype`` (fp32 or bf16), row_vals[ids] [...] fp32
    or None): one segment of :func:`gather_rows_q8_many`. CPU tensors take
    the plain twin."""
    if ids.device.type == "cpu":
        return _gather_rows_q8_plain(q, scale, ids, out_dtype, row_vals)
    return gather_rows_q8_many([(q, scale, ids, out_dtype, row_vals)])[0]


def packed_row_bytes(feat_dim: int, cache_dim: int = 0) -> int:
    """Bytes of a bit-packed int8 partitioned row."""
    return feat_dim + cache_dim + (12 if cache_dim else 8)


def decode_packed_rows(rows: torch.Tensor, feat_dim: int, cache_dim: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  Optional[torch.Tensor]]:
    """Bit-packed int8 rows [G, W] -> (features [G, D] fp32, degrees [G]
    fp32, cache [G, Dc] fp32 or None): ``float(q) * scale`` (one multiply,
    as the reference's ``q.astype(f32) * tail``), the tail's words bit-cast
    from their little-endian bytes."""
    d, dc = feat_dim, cache_dim
    if rows.shape[-1] != packed_row_bytes(d, dc):
        raise ValueError(f"packed rows of {rows.shape[-1]} bytes, not "
                         f"{packed_row_bytes(d, dc)} (D {d}, Dc {dc})")
    tail = rows[:, d + dc:].contiguous().view(torch.float32)  # [G, 2 or 3]
    feats = rows[:, :d].to(torch.float32) * tail[:, 0:1]
    if dc == 0:
        return feats, tail[:, 1], None
    return (feats, tail[:, 2],
            rows[:, d:d + dc].to(torch.float32) * tail[:, 1:2])


def _gather_packed_rows_q8_plain(table, ids, feat_dim, cache_dim=0):
    """Plain twin of K12's packed-row mode: the clamped gather, then
    :func:`decode_packed_rows`."""
    idx = ids.reshape(-1).to(torch.int64).clamp(0, table.shape[0] - 1)
    f, deg, c = decode_packed_rows(table[idx], feat_dim, cache_dim)
    shape = tuple(ids.shape)
    return (f.reshape(shape + (feat_dim,)), deg.reshape(shape),
            None if c is None else c.reshape(shape + (cache_dim,)))


def gather_packed_rows_q8(table: torch.Tensor, ids: torch.Tensor,
                          feat_dim: int, cache_dim: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     Optional[torch.Tensor]]:
    """K12's packed-row mode: bit-packed int8 rows ``table`` [N, W] by
    ``ids`` [...] int32 (clamped into [0, N - 1]) -> (features [..., D],
    degrees [...], cache [..., Dc] or None), fp32, decoded in the gather.
    CPU tensors take the plain twin."""
    if ids.device.type == "cpu":
        return _gather_packed_rows_q8_plain(table, ids, feat_dim, cache_dim)
    flat = ids.reshape(-1).contiguous()
    device = _build.require_cuda("gather_rows_q8", flat, table)
    d, dc = int(feat_dim), int(cache_dim)
    if table.dtype != torch.int8 or table.dim() != 2 \
            or table.shape[1] != packed_row_bytes(d, dc) or d < 1:
        raise ValueError(f"gather_packed_rows_q8: table must be int8 [N, "
                         f"{packed_row_bytes(d, dc)}] packed rows")
    if flat.dtype != torch.int32 or table.shape[0] == 0:
        raise ValueError("gather_packed_rows_q8: int32 ids into a non-empty "
                         "table")
    m = flat.shape[0]
    feats = torch.empty((m, d), dtype=torch.float32, device=device)
    degs = torch.empty((m,), dtype=torch.float32, device=device)
    cache = (torch.empty((m, dc), dtype=torch.float32, device=device)
             if dc else None)
    _build.launch("gather_rows_q8", "gigl_gather_packed_q8", device,
                  table.data_ptr(), table.shape[0], table.shape[1], d, dc,
                  flat.data_ptr(), m, feats.data_ptr(), _build.ptr(cache),
                  degs.data_ptr())
    _build.launches["gather_rows_q8_packed"] += 1
    shape = tuple(ids.shape)
    return (feats.reshape(shape + (d,)), degs.reshape(shape),
            None if cache is None else cache.reshape(shape + (dc,)))


@dataclass
class QuantizedTable:
    """Per-row symmetric int8 quantized table: ``q`` [N, D] int8, ``scale``
    [N, 1] fp32; ``table[ids]`` dequantizes to ``out_dtype`` (K12)."""

    q: torch.Tensor        # [N, D] int8
    scale: torch.Tensor    # [N, 1] f32
    out_dtype: torch.dtype = torch.float32

    @classmethod
    def quantize(cls, x, out_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> "QuantizedTable":
        """Quantize ``x`` [N, D] (numpy or a tensor) on the host with the
        reference's recipe, then move it to ``device`` (CUDA unless
        given)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        absmax = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-12)
        scale = absmax / 127.0
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        device = resolve_device(device)
        return cls(q=torch.from_numpy(q).to(device),
                   scale=torch.from_numpy(scale).to(device),
                   out_dtype=out_dtype)

    @property
    def dim(self) -> int:
        return int(self.q.shape[1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self.q.shape[0]), self.dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.out_dtype

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Device bytes of the table (int8 rows and fp32 scales)."""
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def gather(self, ids: torch.Tensor,
               row_vals: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(rows [..., D] ``out_dtype``, ``row_vals[ids]`` or None) for
        int32 ``ids`` of any shape (K12)."""
        return gather_rows_q8(self.q, self.scale, ids, self.out_dtype,
                              row_vals)

    @staticmethod
    def gather_many(
        parts: Sequence[Tuple["QuantizedTable", torch.Tensor,
                              Optional[torch.Tensor]]],
    ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """``table.gather(ids, row_vals)`` for each ``(table, ids,
        row_vals)``, all in one K12 launch (one per
        :data:`MAX_SEGMENTS`)."""
        return gather_rows_q8_many([(t.q, t.scale, ids, t.out_dtype, rv)
                                    for t, ids, rv in parts])

    def __getitem__(self, idx) -> torch.Tensor:
        """Dequantizing gather; any integer index shape -> [..., D]."""
        ids = torch.as_tensor(idx, device=self.device).to(torch.int32)
        return self.gather(ids)[0]
