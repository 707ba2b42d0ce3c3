"""Count-min sketch for the sampled-softmax candidate probability (port of
``gigl_tpu/losses/count_min_sketch.py``).

The retrieval loss's logQ correction estimates each candidate's sampling
probability as its count in a ``[depth, width]`` int32 sketch over the
total count. The hash of an id into row ``r`` is the sampler's integer
finalizer of ``uint32(id) + r * 0x9E3779B9`` modulo ``width``, all in
uint32 (bit-equal to the reference's ``_cms_hash``). The sketch's table and
total live on the device, so a training step reads and updates them with no
host synchronisation, and :func:`cms_add` is functional as the reference's
is: it returns a new sketch and never writes its input.

Kernels (``csrc/cms.cu``): K13 ``cms_add`` (one count per row for every id,
masked candidates included, and ``total + n``) and K14 ``cms_estimate`` (the
minimum over the rows, with ``est / max(total, 1)`` for
:func:`cms_sampling_probability`; a programmatic dependent launch, whose
blocks may start while the kernel before it on the stream — K13, or the
op that makes the ids — finishes, and wait for its writes before their
first read). :func:`_cms_hash_plain`,
:func:`_cms_add_plain`, :func:`_cms_estimate_plain` and
:func:`_cms_probability_plain` are their plain twins, used for CPU tensors
only; the twins hash in int64 masked to 32 bits, each multiply split into
16-bit halves (``neighbor_sampler._mul32``) as PyTorch's CPU uint32 lacks
the shifts and the modulo.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.sampling.neighbor_sampler import _M32, _mix32, _mul32

_ROW_MULT = 0x9E3779B9


class CountMinSketch(NamedTuple):
    table: torch.Tensor  # [depth, width] int32
    total: torch.Tensor  # [] int32, on the table's device

    @property
    def depth(self) -> int:
        return int(self.table.shape[0])

    @property
    def width(self) -> int:
        return int(self.table.shape[1])


def cms_init(depth: int = 5, width: int = 2048,
             device: DeviceLike = None) -> CountMinSketch:
    """An empty sketch on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    return CountMinSketch(
        table=torch.zeros((depth, width), dtype=torch.int32, device=device),
        total=torch.zeros((), dtype=torch.int32, device=device))


def _cms_hash_plain(ids: torch.Tensor, depth: int, width: int
                    ) -> torch.Tensor:
    """Per-row buckets [depth, n] int64 in [0, width) of the flat ids."""
    x = ids.reshape(-1).to(torch.int64) & _M32
    rows = torch.arange(depth, dtype=torch.int64, device=ids.device)
    x = (x[None, :] + _mul32(rows, _ROW_MULT)[:, None]) & _M32
    return _mix32(x) % width


def _cms_add_plain(sketch: CountMinSketch, ids: torch.Tensor
                   ) -> CountMinSketch:
    flat = ids.reshape(-1)
    buckets = _cms_hash_plain(flat, sketch.depth, sketch.width)
    table = sketch.table.clone()
    table.scatter_add_(1, buckets, torch.ones_like(buckets, dtype=torch.int32))
    total = ((sketch.total.to(torch.int64) + flat.shape[0]) & _M32)
    total = torch.where(total >= 2**31, total - 2**32, total)
    return CountMinSketch(table=table, total=total.to(torch.int32))


def _cms_estimate_plain(sketch: CountMinSketch, ids: torch.Tensor
                        ) -> torch.Tensor:
    buckets = _cms_hash_plain(ids, sketch.depth, sketch.width)
    counts = torch.gather(sketch.table, 1, buckets)
    return counts.min(0).values.reshape(ids.shape)


def _cms_probability_plain(sketch: CountMinSketch, ids: torch.Tensor
                           ) -> torch.Tensor:
    est = _cms_estimate_plain(sketch, ids).to(torch.float32)
    return est / torch.clamp(sketch.total.to(torch.float32), min=1.0)


def _check(name: str, sketch: CountMinSketch, ids: torch.Tensor):
    flat = ids.reshape(-1).contiguous()
    device = _build.require_cuda(name, flat, sketch.table, sketch.total)
    if flat.dtype != torch.int32 or sketch.table.dtype != torch.int32 \
            or sketch.total.dtype != torch.int32 or sketch.table.dim() != 2 \
            or sketch.total.numel() != 1:
        raise ValueError(f"{name}: ids, table [depth, width] and total [] "
                         "must be int32")
    if sketch.depth < 1 or sketch.width < 1:
        raise ValueError(f"{name}: empty sketch")
    return device, flat


def cms_add(sketch: CountMinSketch, ids: torch.Tensor) -> CountMinSketch:
    """A new sketch with every id (each count 1) added (K13; the plain twin
    for CPU tensors)."""
    if ids.device.type == "cpu":
        return _cms_add_plain(sketch, ids)
    device, flat = _check("cms_add", sketch, ids)
    table = torch.empty_like(sketch.table)
    total = torch.empty_like(sketch.total)
    _build.launch("cms_add", "gigl_cms_add", device,
                  sketch.table.data_ptr(), sketch.depth, sketch.width,
                  flat.data_ptr(), flat.shape[0], sketch.total.data_ptr(),
                  table.data_ptr(), total.data_ptr())
    return CountMinSketch(table=table, total=total)


def cms_estimate(sketch: CountMinSketch, ids: torch.Tensor) -> torch.Tensor:
    """Estimated counts (the minimum over the rows), int32 of ``ids``'
    shape (K14)."""
    if ids.device.type == "cpu":
        return _cms_estimate_plain(sketch, ids)
    device, flat = _check("cms_estimate", sketch, ids)
    est = torch.empty(flat.shape, dtype=torch.int32, device=device)
    _build.launch("cms_estimate", "gigl_cms_estimate", device,
                  sketch.table.data_ptr(), sketch.depth, sketch.width,
                  flat.data_ptr(), flat.shape[0], None, est.data_ptr(), None)
    return est.reshape(ids.shape)


def cms_sampling_probability(sketch: CountMinSketch, ids: torch.Tensor
                             ) -> torch.Tensor:
    """frequency / max(total, 1) in fp32, of ``ids``' shape: the candidate
    sampling probability of the retrieval loss's logQ correction (K14)."""
    if ids.device.type == "cpu":
        return _cms_probability_plain(sketch, ids)
    device, flat = _check("cms_estimate", sketch, ids)
    prob = torch.empty(flat.shape, dtype=torch.float32, device=device)
    _build.launch("cms_estimate", "gigl_cms_estimate", device,
                  sketch.table.data_ptr(), sketch.depth, sketch.width,
                  flat.data_ptr(), flat.shape[0], sketch.total.data_ptr(),
                  None, prob.data_ptr())
    return prob.reshape(ids.shape)
