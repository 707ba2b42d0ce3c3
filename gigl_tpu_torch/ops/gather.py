"""Row gathers of the tabularized path: table expansion and row hydration.

Kernel K3 ``gather_rows`` (``csrc/gather_rows.cu``) replaces the gathers
of ``gigl_tpu/training/dataset.py`` ``sample_hop_blocks_tabularized``
(:387-417) and ``hydrate_fused`` (:419-434) — the work the deleted Pallas
``gather_rows`` kernel did. One kernel, two modes:

- :func:`expand_table`: gather packed ``[N, k]`` int32 sample-table rows
  (-1 = no neighbor) and propagate the mask ``row >= 0 & parent``;
- :func:`gather_rows`: gather rows of a 2-D table (the fused ``[x | agg]``
  rows, plain features or the cache, through the table's row stride) and,
  optionally, a per-row scalar such as the degree.

Both are bit-equal to the plain gathers (:func:`_expand_table_plain`,
:func:`_gather_rows_plain`), which run for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gigl_tpu_torch.ops import _build


def _expand_table_plain(table, frontier, parent):
    row = table[frontier.to(torch.int64)]
    m = (row >= 0) & parent[..., None]
    return torch.where(m, row, 0), m


def expand_table(
    table: torch.Tensor, frontier: torch.Tensor, parent: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 expand mode: table [N, k] int32, frontier [...] int32 ids,
    parent [...] bool -> (nbr [..., k] int32, mask [..., k] bool)."""
    if frontier.device.type == "cpu":
        return _expand_table_plain(table, frontier, parent)
    flat = frontier.reshape(-1).contiguous()
    par = parent.reshape(-1).contiguous()
    device = _build.require_cuda("expand_table", flat, table, par)
    if table.dtype != torch.int32 or flat.dtype != torch.int32:
        raise ValueError("expand_table: table and frontier must be int32")
    if par.dtype != torch.bool or par.shape != flat.shape:
        raise ValueError("expand_table: parent must be bool, frontier-shaped")
    n, k = table.shape
    m = flat.shape[0]
    nbr = torch.empty((m, k), dtype=torch.int32, device=flat.device)
    mask = torch.empty((m, k), dtype=torch.bool, device=flat.device)
    _build.launch("gather_rows", "gigl_gather_rows", device,
                  table.data_ptr(), n, k, k, flat.data_ptr(), m,
                  par.data_ptr(), nbr.data_ptr(), mask.data_ptr(), None, None)
    shape = tuple(frontier.shape) + (k,)
    return nbr.reshape(shape), mask.reshape(shape)


def _gather_rows_plain(table, ids, row_vals=None):
    idx = ids.to(torch.int64)
    return table[idx], (None if row_vals is None else row_vals[idx])


def gather_rows(
    table: torch.Tensor, ids: torch.Tensor,
    row_vals: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3 rows mode: table [N, W] (rows contiguous, any row stride, row
    width a multiple of 4 bytes), ids [...] int32 -> (rows [..., W],
    row_vals[ids] [...] f32 or None)."""
    if ids.device.type == "cpu":
        return _gather_rows_plain(table, ids, row_vals)
    flat = ids.reshape(-1).contiguous()
    device = _build.require_cuda("gather_rows", flat)
    if table.device != flat.device or table.dim() != 2 or table.stride(1) != 1:
        raise ValueError("gather_rows: table must be a 2-D CUDA tensor with "
                         "contiguous rows, on the ids' device")
    if flat.dtype != torch.int32:
        raise ValueError("gather_rows: ids must be int32")
    n, w = table.shape
    esize = table.element_size()
    if (w * esize) % 4 or (table.stride(0) * esize) % 4 \
            or table.data_ptr() % 4:
        raise ValueError("gather_rows: row width, row stride and base must "
                         "be multiples of 4 bytes")
    if row_vals is not None:
        _build.require_cuda("gather_rows", flat, row_vals)
        if row_vals.dtype != torch.float32 or row_vals.shape != (n,):
            raise ValueError("gather_rows: row_vals must be f32 [N]")
    m = flat.shape[0]
    out = torch.empty((m, w), dtype=table.dtype, device=flat.device)
    vals = (None if row_vals is None
            else torch.empty((m,), dtype=torch.float32, device=flat.device))
    _build.launch("gather_rows", "gigl_gather_rows", device,
                  table.data_ptr(), n, table.stride(0) * esize // 4,
                  w * esize // 4, flat.data_ptr(), m, None, out.data_ptr(),
                  None, _build.ptr(row_vals), _build.ptr(vals))
    shape = tuple(ids.shape)
    return (out.reshape(shape + (w,)),
            None if vals is None else vals.reshape(shape))
