"""Embedding inference over the whole graph (port of ``InferenceConfig``,
``node_batches``, ``run_inference``, ``run_full_graph_inference``,
``exact_full_neighborhood_paths``, ``run_full_graph_inference_hetero``
and ``run_partitioned_inference`` in ``gigl_tpu/inference/inferencer.py``).

``run_inference`` iterates node-id ranges on the host; each batch is moved
to the device and encoded by the inferencer's ``infer_batch`` (a typed
graph's sampled path: ``HeteroNALPTrainer.encode_batch(ids, node_type)``
over ``node_batches`` of each node type, as the reference's task spec
drives it). ``run_full_graph_inference`` encodes every node over its exact
full neighborhood in one pass through the degree-bucketed ELL path
(``GNNEncoder.encode_ell``); ``run_full_graph_inference_hetero`` does so
for every node of every type of a typed graph through the COO segment
kernels (``HeteroGNNEncoder.encode_full``); ``run_partitioned_inference``
streams every node through a partitioned trainer's ``encode_batch`` (one
program over the mesh's shards). The embeddings go to any
exporter with ``add_embeddings(ids, emb)`` and ``flush()``, as fp32 numpy
arrays (numpy has no bf16).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.sampling.hetero_sampler import OpSpec
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
    — loaded first) under ``torch.inference_mode()`` with ``edge_attr``
    ([E, De] in the graph's COO edge order, an array or a tensor; moved to
    ``device`` as fp32), and export every node's row in chunks of
    ``export_batch``. Returns the row count."""
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
    if edge_attr is not None:
        edge_attr = torch.as_tensor(edge_attr, dtype=torch.float32,
                                    device=device)
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


def exact_full_neighborhood_paths(graph, num_layers: int
                                  ) -> Dict[str, Tuple[OpSpec, ...]]:
    """Per root node type, the full-neighborhood op tree: at every level one
    INCOMING op per edge type arriving at a frontier type, with fanout =
    that edge type's largest in-degree (at least 1), so every draw takes all
    neighbors and encoding through these paths is exact. Host numpy."""
    max_deg, by_dst = {}, {}
    for et, coo in graph.edges.items():
        dst = np.asarray(coo[1])
        n_dst = graph.num_nodes[et.dst_node_type]
        deg = np.bincount(dst, minlength=n_dst) if len(dst) else np.zeros(1)
        max_deg[str(et)] = max(int(deg.max()), 1)
        by_dst.setdefault(str(et.dst_node_type), []).append(et)
    paths = {}
    for root_nt in graph.metadata.node_types:
        ops = []
        frontier = [(-1, str(root_nt))]   # (op index or -1 = root, type)
        for depth in range(1, num_layers + 1):
            nxt = []
            for parent_idx, nt in frontier:
                for et in by_dst.get(nt, []):
                    ops.append(OpSpec(
                        name=f"{et}@d{depth}p{parent_idx}",
                        edge_type=str(et), frontier_node_type=nt,
                        neighbor_node_type=str(et.src_node_type),
                        fanout=max_deg[str(et)], parent=parent_idx,
                        depth=depth, direction="INCOMING"))
                    nxt.append((len(ops) - 1, str(et.src_node_type)))
            frontier = nxt
        paths[str(root_nt)] = tuple(ops)
    return paths


def run_full_graph_inference_hetero(
    model,
    params: Optional[Mapping[str, torch.Tensor]],
    graph,
    exporters,
    *,
    num_layers: int = 2,
    batch_size: int = 512,
    node_types: Optional[Tuple[str, ...]] = None,
    device: DeviceLike = None,
) -> Dict[str, int]:
    """Exact full-neighborhood inference of every node of every (or the
    given) node type(s) of a typed ``HeteroGraph`` on ``device`` (CUDA
    unless given): ``model`` (a ``HeteroGNNEncoder`` or a
    ``HeteroLinkPredictionGNN``; ``params`` — a state dict, e.g. from
    ``params_from_flax`` — loaded first) runs ``encode_full`` under
    ``torch.inference_mode()`` on the segment kernels, with the graph's
    SegmentIndexes built once on the host before the first layer; each
    node type's rows go to ``exporters[node_type]`` in chunks of 65,536.
    O(E) memory per layer: hubs cost edges, not padding. ``num_layers`` /
    ``batch_size`` are the reference's API (the encoder's depth governs, the
    whole graph is one pass). Returns {node_type: rows}."""
    del num_layers, batch_size
    device = resolve_device(device)
    wanted = tuple(str(t) for t in (node_types or graph.metadata.node_types))
    known = {str(t) for t in graph.metadata.node_types}
    for nt in wanted:
        if nt not in known:
            raise ValueError(f"unknown node type {nt!r}; have "
                             f"{sorted(known)}")
    if params is not None:
        model.load_state_dict(params)
    model.to(device).eval()
    encoder = getattr(model, "encoder", model)
    features = {}
    for t in graph.metadata.node_types:
        f = (graph.node_features[t] if t in graph.node_features
             else np.zeros((graph.num_nodes[t], 1), np.float32))
        features[str(t)] = torch.as_tensor(np.asarray(f, np.float32),
                                           device=device)
    edges = {str(et): tuple(torch.as_tensor(np.asarray(row), device=device)
                            .to(torch.int32) for row in coo[:2])
             for et, coo in graph.edges.items()}
    num_nodes = {str(t): int(graph.num_nodes[t])
                 for t in graph.metadata.node_types}
    # built from the device tensors the pass reads, so that each
    # destination index composes its own source ids (K8's composed mode)
    segments = encoder.segments(edges, num_nodes, device, backward=False)
    with torch.inference_mode():
        embs = encoder.encode_full(features, edges, num_nodes,
                                   segments=segments)
        embs = {nt: embs[nt].float().cpu().numpy() for nt in wanted}
    counts = {}
    for nt in wanted:
        n = num_nodes[nt]
        for s in range(0, n, 65536):
            ids = np.arange(s, min(s + 65536, n))
            exporters[nt].add_embeddings(ids, embs[nt][ids])
        exporters[nt].flush()
        counts[nt] = n
    return counts


def run_partitioned_inference(
    trainer,
    num_nodes: int,
    exporter,
    cfg: Optional[InferenceConfig] = None,
    *,
    node_type: Optional[str] = None,
    device: DeviceLike = None,
) -> int:
    """Full-graph inference over a PARTITIONED backend: every node of this
    worker's range, in ``node_batches``, through the trainer's sharded
    ``encode_batch`` (a ``PartitionedNALPTrainer``, a
    ``PartitionedNodeClassificationTrainer``, whose logits it exports, or,
    with ``node_type``, a ``PartitionedHeteroNALPTrainer`` over that node
    type's ids; the mesh lives on ``device``: CUDA unless given) into the
    exporter. The trainer holds its parameters, so there is no ``params``
    argument. Returns the row count."""
    cfg = cfg or InferenceConfig()
    device = resolve_device(device)
    if trainer.device != device:
        raise ValueError(f"the trainer's mesh lives on {trainer.device}, "
                         f"inference asked for {device}")
    total = 0
    t0 = time.time()
    for batch_idx, (ids, valid) in enumerate(node_batches(num_nodes, cfg)):
        ids_t = torch.as_tensor(ids, dtype=torch.int32, device=device)
        emb = (trainer.encode_batch(ids_t) if node_type is None else
               trainer.encode_batch(ids_t, node_type=node_type))
        emb = emb[:valid].float().cpu().numpy()
        exporter.add_embeddings(ids[:valid], emb)
        total += valid
        if (batch_idx + 1) % cfg.log_every_n_batches == 0:
            rate = total / max(time.time() - t0, 1e-9)
            logger.info("partitioned inference: %d nodes (%.0f nodes/s)",
                        total, rate)
    exporter.flush()
    return total
