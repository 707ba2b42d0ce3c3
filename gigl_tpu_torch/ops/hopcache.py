"""Cached deepest-hop neighbor aggregates ("tabularized" hop caching).

Port of ``gigl_tpu/ops/hopcache.py``. The first GNN layer's neighbor
aggregation (mean / sum / gcn) does not depend on the weights, so the
deepest hop's gather + aggregate is computed once per refresh as a per-node
table ``M[v] = agg({x_u : u in sampled_nbrs(v)})``; every occurrence of a
node reuses the same frozen sample (the reference's v1 precomputed-subgraph
regime). The cache draws with the same (seed, node, hop, slot) keys as the
live sampler, so for a given (seed, hop_key) it equals what the on-the-fly
path computes.

Kernel K2 ``build_neighbor_cache`` (``csrc/neighbor_cache.cu``) fuses the
draw, the k-row gather and the reduce, one warp per node, and writes each
row through a row stride — straight into the right half of the fused
``[N, D + D]`` table when ``out`` is that half (an in-place write into a
buffer the caller allocated). :func:`_neighbor_cache_plain` is its plain
twin, used for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain
from gigl_tpu_torch.sampling.neighbor_sampler import (
    DeviceCSR,
    _sample_uniform_plain,
    sample_neighbors,
)

CACHEABLE_AGGS = ("mean", "sum", "gcn")
_AGG_CODES = {"mean": 0, "sum": 1, "gcn": 2}
_M32 = 0xFFFFFFFF


def _neighbor_cache_plain(csr, features, fanout, seed, hop_key, agg,
                          degrees, out, chunk=8192):
    n = csr.num_anchor_nodes
    for s in range(0, n, chunk):
        ids = torch.arange(s, min(s + chunk, n), dtype=torch.int32,
                           device=features.device)
        nbr, mask, _ = _sample_uniform_plain(csr.indptr, csr.indices, ids,
                                             fanout, seed, hop_key)
        x = features[nbr.to(torch.int64)]                      # [C, k, D]
        if agg == "gcn":
            w = torch.rsqrt(degrees[nbr.to(torch.int64)] + 1.0)
            x = x * w[..., None]
        out[s: s + ids.shape[0]] = _masked_reduce_plain(
            x, mask, "mean" if agg == "mean" else "sum")
    return out


def build_neighbor_cache(
    csr: DeviceCSR,
    features: torch.Tensor,          # [N, D] f32
    *,
    fanout: int,
    seed: int = 0,
    hop_key: int = 1,
    agg: str = "mean",
    degrees: Optional[torch.Tensor] = None,  # [N] f32 (agg="gcn")
    method: str = "uniform",
    out: Optional[torch.Tensor] = None,      # [N, D] f32, rows contiguous
) -> torch.Tensor:
    """Per-node sampled-neighbor aggregate table M [N, D], written into
    ``out`` when given. ``hop_key`` must match the hop index the live
    sampler uses for the cached hop (len(fanouts) for the deepest hop)."""
    if agg not in CACHEABLE_AGGS:
        raise ValueError(f"agg={agg!r} not in {CACHEABLE_AGGS}")
    if agg == "gcn" and degrees is None:
        raise ValueError('agg="gcn" requires true node degrees')
    if method != "uniform":
        raise NotImplementedError(
            f"sampling method {method!r} is not ported yet "
            "(gigl_tpu.ops.hopcache.build_neighbor_cache, method=weighted/top_k)")
    n, d = csr.num_anchor_nodes, features.shape[-1]
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=features.device)
    if features.device.type == "cpu":
        return _neighbor_cache_plain(csr, features, int(fanout), seed,
                                     hop_key, agg, degrees, out)
    device = _build.require_cuda("build_neighbor_cache", features,
                                 csr.indptr, csr.indices)
    if features.dtype != torch.float32 or out.dtype != torch.float32:
        raise ValueError("build_neighbor_cache: features and out must be f32")
    if d % 4 or out.shape != (n, d) or out.stride(1) != 1 \
            or out.stride(0) % 4 or out.data_ptr() % 16 \
            or out.device != device:
        raise ValueError("build_neighbor_cache: D and the out row stride "
                         "must be multiples of 4, out 16-byte aligned")
    if agg == "gcn":
        _build.require_cuda("build_neighbor_cache", features, degrees)
    _build.launch(
        "build_neighbor_cache", "gigl_build_neighbor_cache", device,
        csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.indices.shape[0],
        n, features.data_ptr(), d,
        degrees.data_ptr() if agg == "gcn" else None,
        int(fanout), int(seed) & _M32, int(hop_key) & _M32, _AGG_CODES[agg],
        out.data_ptr(), out.stride(0))
    return out


def build_sample_table(
    csr: DeviceCSR,
    *,
    fanout: int,
    seed: int = 0,
    hop_key: int = 1,
    method: str = "uniform",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frozen per-node neighbor-sample table: (ids [N, fanout] int32,
    mask [N, fanout] bool) — row v holds the draw sample_neighbors makes for
    node v at (seed, hop_key). Rows of isolated nodes are fully masked."""
    n = csr.num_anchor_nodes
    ids = torch.arange(n, dtype=torch.int32, device=csr.indptr.device)
    nbr, mask, _ = sample_neighbors(csr, ids, int(fanout), seed=seed,
                                    hop=hop_key, method=method)
    return nbr, mask
