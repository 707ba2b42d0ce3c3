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
draw, the k-row gather and the reduce, a group of lanes per node (each
lane a 16-byte piece of a row: a warp for fp32 D 128, 8 lanes for int8 D
128), the node's slots drawn once and every drawn row's load in flight
before the adds, and writes each row through a row stride — straight into the right half of the fused
``[N, D + D]`` table when ``out`` is that half (an in-place write into a
buffer the caller allocated). Over a quantized feature table
(``ops/quantized.py``, the reference's ``features[nbr]`` through
``QuantizedTable.__getitem__``) K2 runs in its int8 mode: it reads each
neighbor's int8 row and scale and dequantizes as K12 does before the same
fp32 accumulation. With ``method="weighted"`` / ``"top_k"`` (a CSR with
edge weights) K2 runs in its weighted mode: each node's draw is K19's
(``sample_neighbors``' weighted / top-k draw over the first 128 CSR slots)
by the same warp device code, a warp per node. :func:`_neighbor_cache_plain` is its plain
twin, used for CPU tensors only.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from gigl_tpu_torch.ops import _build
from gigl_tpu_torch.ops.fanout import _masked_reduce_plain
from gigl_tpu_torch.ops.quantized import QuantizedTable, _gather_rows_q8_plain
from gigl_tpu_torch.sampling.neighbor_sampler import (
    WEIGHTED_METHODS,
    DeviceCSR,
    _sample_uniform_plain,
    _sample_weighted_plain,
    sample_neighbors,
)

CACHEABLE_AGGS = ("mean", "sum", "gcn")
_AGG_CODES = {"mean": 0, "sum": 1, "gcn": 2}
_M32 = 0xFFFFFFFF
CACHE_WEIGHT_WINDOW = 128   # sample_neighbors' default weight_window


def _neighbor_cache_plain(csr, features, fanout, seed, hop_key, agg,
                          degrees, out, chunk=8192, method="uniform"):
    n = csr.num_anchor_nodes
    for s in range(0, n, chunk):
        ids = torch.arange(s, min(s + chunk, n), dtype=torch.int32,
                           device=features.device)
        if method == "uniform":
            nbr, mask, _ = _sample_uniform_plain(
                csr.indptr, csr.indices, ids, fanout, seed, hop_key)
        else:
            nbr, mask, _ = _sample_weighted_plain(
                csr.indptr, csr.indices, csr.edge_weights, ids, fanout,
                CACHE_WEIGHT_WINDOW, method, seed, hop_key)
        if isinstance(features, QuantizedTable):
            x = _gather_rows_q8_plain(features.q, features.scale, nbr,
                                      torch.float32)[0]       # [C, k, D]
        else:
            x = features[nbr.to(torch.int64)]                  # [C, k, D]
        if agg == "gcn":
            w = torch.rsqrt(degrees[nbr.to(torch.int64)] + 1.0)
            x = x * w[..., None]
        out[s: s + ids.shape[0]] = _masked_reduce_plain(
            x, mask, "mean" if agg == "mean" else "sum")
    return out


def build_neighbor_cache(
    csr: DeviceCSR,
    features: Union[torch.Tensor, QuantizedTable],   # [N, D] f32 or int8
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
    weighted = method != "uniform"
    if weighted:
        if method not in WEIGHTED_METHODS:
            raise ValueError(f"Unknown sampling method {method!r}")
        if csr.edge_weights is None:
            raise ValueError(f"method={method!r} requires edge_weights")
        if not 0 < int(fanout) <= CACHE_WEIGHT_WINDOW:
            raise ValueError(f"fanout {fanout} must lie in [1, window "
                             f"{CACHE_WEIGHT_WINDOW}]")
    quantized = isinstance(features, QuantizedTable)
    if quantized and features.out_dtype != torch.float32:
        raise ValueError("build_neighbor_cache: a quantized table must "
                         "dequantize to f32")
    n, d = csr.num_anchor_nodes, features.shape[-1]
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=features.device)
    if features.device.type == "cpu":
        return _neighbor_cache_plain(csr, features, int(fanout), seed,
                                     hop_key, agg, degrees, out,
                                     method=method)
    table = features.q if quantized else features
    device = _build.require_cuda("build_neighbor_cache", table, csr.indptr,
                                 csr.indices)
    if quantized:
        _build.require_cuda("build_neighbor_cache", table, features.scale)
        if features.scale.dtype != torch.float32 \
                or features.scale.numel() != table.shape[0]:
            raise ValueError("build_neighbor_cache: scale must be f32 [N, 1]")
    if (not quantized and features.dtype != torch.float32) \
            or out.dtype != torch.float32:
        raise ValueError("build_neighbor_cache: features (unless quantized) "
                         "and out must be f32")
    if d % 4 or out.shape != (n, d) or out.stride(1) != 1 \
            or out.stride(0) % 4 or out.data_ptr() % 16 \
            or table.data_ptr() % 16 or out.device != device:
        raise ValueError("build_neighbor_cache: D and the out row stride "
                         "must be multiples of 4, out and the features "
                         "16-byte aligned")
    if agg == "gcn":
        _build.require_cuda("build_neighbor_cache", table, degrees)
    weights = csr.edge_weights if weighted else None
    if weighted:
        _build.require_cuda("build_neighbor_cache", table, weights)
        if weights.dtype != torch.float32:
            raise ValueError("build_neighbor_cache: edge weights must be f32")
    _build.launch(
        "build_neighbor_cache", "gigl_build_neighbor_cache", device,
        csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.indices.shape[0],
        n, table.data_ptr(), features.scale.data_ptr() if quantized else None,
        d, degrees.data_ptr() if agg == "gcn" else None,
        _build.ptr(weights), 0 if weights is None else weights.shape[0],
        WEIGHTED_METHODS.get(method, 0), int(fanout), int(seed) & _M32,
        int(hop_key) & _M32, _AGG_CODES[agg], out.data_ptr(), out.stride(0))
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
    node v at (seed, hop_key) by ``method`` (K1, or K19 for weighted /
    top-k). Rows of isolated nodes are fully masked."""
    n = csr.num_anchor_nodes
    ids = torch.arange(n, dtype=torch.int32, device=csr.indptr.device)
    nbr, mask, _ = sample_neighbors(csr, ids, int(fanout), seed=seed,
                                    hop=hop_key, method=method)
    return nbr, mask
