"""Embedding inference over the whole graph (port of ``InferenceConfig``,
``node_batches``, ``run_inference`` and ``run_full_graph_inference`` in
``gigl_tpu/inference/inferencer.py``).

``run_inference`` iterates node-id ranges on the host; each batch is moved
to the device and encoded by the inferencer's ``infer_batch``.
``run_full_graph_inference`` encodes every node over its exact full
neighborhood in one pass through the degree-bucketed ELL path
(``GNNEncoder.encode_ell``). Either way the embeddings go to any exporter
with ``add_embeddings(ids, emb)`` and ``flush()``, as fp32 numpy arrays
(numpy has no bf16).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.training.base import BaseInferencer

logger = logging.getLogger(__name__)


@dataclass
class InferenceConfig:
    batch_size: int = 512
    # Rank-strided sharding of the node range across workers.
    worker_rank: int = 0
    num_workers: int = 1
    log_every_n_batches: int = 50


def node_batches(
    num_nodes: int, cfg: InferenceConfig
) -> Iterator[Tuple[np.ndarray, int]]:
    """Static-size batches of node ids for this worker, with the count of
    real ids in each (the tail batch is padded with id 0)."""
    ids = np.arange(cfg.worker_rank, num_nodes, cfg.num_workers)
    for i in range(0, len(ids), cfg.batch_size):
        chunk = ids[i: i + cfg.batch_size]
        if len(chunk) < cfg.batch_size:
            pad = np.zeros(cfg.batch_size - len(chunk), dtype=chunk.dtype)
            yield np.concatenate([chunk, pad]), len(chunk)
        else:
            yield chunk, cfg.batch_size


def run_full_graph_inference(
    encoder,
    params: Optional[Mapping[str, torch.Tensor]],
    graph,
    exporter,
    *,
    edge_attr=None,
    export_batch: int = 65536,
    allow_zero_features: bool = False,
    device: DeviceLike = None,
) -> int:
    """Full-neighborhood inference of a homogeneous ``HeteroGraph`` in one
    pass on ``device`` (CUDA unless given): build the ELL tables of the
    dst-anchored CSR, run ``encoder.encode_ell`` (a ``GNNEncoder``; its
    weights, or ``params`` — a state dict, e.g. from ``params_from_flax``
    — loaded first) under ``torch.inference_mode()``, and export every
    node's row in chunks of ``export_batch``. Returns the row count."""
    device = resolve_device(device)
    nt = graph.metadata.node_types[0]
    et = graph.metadata.edge_types[0]
    n = graph.num_nodes[nt]
    if nt not in graph.node_features:
        # A config mistake (wrong node-type name) must not silently yield
        # the embeddings of a zeros-feature graph; structure-only graphs
        # opt in explicitly.
        if not allow_zero_features:
            raise ValueError(
                f"node type {nt!r} has no feature table (have "
                f"{sorted(graph.node_features)}); fix the graph's "
                f"node_features, or pass allow_zero_features=True for a "
                f"deliberately structure-only graph")
        feats = np.zeros((n, 1), np.float32)
    else:
        feats = graph.node_features[nt]
    if params is not None:
        encoder.load_state_dict(params)
    encoder.to(device).eval()
    ell = EllGraph.from_csr(graph.csr(et, anchor="dst"), device=device)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    with torch.inference_mode():
        emb = encoder.encode_ell(x, ell, edge_attr)
        emb = emb.float().cpu().numpy()
    for s in range(0, n, export_batch):
        ids = np.arange(s, min(s + export_batch, n))
        exporter.add_embeddings(ids, emb[ids])
    exporter.flush()
    return n


def run_inference(
    inferencer: BaseInferencer,
    num_nodes: int,
    exporter,
    cfg: Optional[InferenceConfig] = None,
    device: DeviceLike = None,
) -> int:
    """Embed every node of this worker's shard on ``device`` (CUDA unless
    given) and export. Returns the row count."""
    cfg = cfg or InferenceConfig()
    device = resolve_device(device)
    total = 0
    t0 = time.time()
    for batch_idx, (ids, valid) in enumerate(node_batches(num_nodes, cfg)):
        ids_t = torch.as_tensor(ids, dtype=torch.int32, device=device)
        emb = inferencer.infer_batch(ids_t)
        emb = emb[:valid].float().cpu().numpy()
        exporter.add_embeddings(ids[:valid], emb)
        total += valid
        if (batch_idx + 1) % cfg.log_every_n_batches == 0:
            rate = total / max(time.time() - t0, 1e-9)
            logger.info("inference: %d nodes embedded (%.0f nodes/s)",
                        total, rate)
    exporter.flush()
    return total
