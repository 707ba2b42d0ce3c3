"""Batch embedding inference over the whole graph (port of
``InferenceConfig``, ``node_batches`` and ``run_inference`` in
``gigl_tpu/inference/inferencer.py``).

Node-id ranges are iterated on the host; each batch is moved to the device
and encoded by the inferencer's ``infer_batch``; the embeddings go to any
exporter with ``add_embeddings(ids, emb)`` and ``flush()``, as fp32 numpy
arrays (numpy has no bf16).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
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
