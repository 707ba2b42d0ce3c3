"""Heterogeneous node-anchor link-prediction trainer, inference subset (port
of ``gigl_tpu/training/hetero_trainer.py``: ``HeteroNALPTrainerConfig``
and ``HeteroNALPTrainer``'s ``refresh_tables``, ``encode_batch`` and
``init_params``).

``encode_batch(node_ids, node_type)`` is the sampled typed serving path:
the node type's op tree is drawn live through K1 (keyed by the config's
seed) or, with ``tabularized``, expanded from frozen sample tables through
K3; the feature rows are gathered through K3 (``hydrate``) and encoded
through the typed block tree (HGT: K7; RGCN: K4; SimpleHGN: plain).

Typed training — ``init_state``, ``train_step(s)``, ``evaluate``, ``fit``
and the negative samplers they use — is slice 6: those methods raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.sampling.hetero_sampler import OpSpec
from gigl_tpu_torch.training.base import BaseInferencer
from gigl_tpu_torch.training.hetero_dataset import (
    TRAINING_NOT_PORTED,
    HeteroDeviceGraph,
)


@dataclass
class HeteroNALPTrainerConfig:
    anchor_node_type: str
    candidate_node_type: str
    num_positives: int = 1
    num_hard_negs: int = 0
    num_random_negs: int = 512
    loss_type: str = "retrieval"
    margin: float = 0.5
    temperature: float = 0.07
    remove_accidental_hits: bool = True
    eval_ks: Tuple[int, ...] = (1, 5, 10, 50, 100)
    seed: int = 0
    # Frozen per-(CSR, fanout) sample tables: one table-row gather per op;
    # refresh_tables(epoch) re-runs the sampler with a new seed.
    tabularized: bool = False
    # Partitioned trainers only (not ported).
    global_candidate_pool: bool = False


class HeteroNALPTrainer(BaseInferencer):
    """Typed NALP trainer over a HeteroDeviceGraph; ``paths`` holds each
    node type's resolved op tree. Serving only in this slice."""

    def __init__(
        self,
        model,  # HeteroLinkPredictionGNN
        graph: HeteroDeviceGraph,
        paths: Mapping[str, Tuple[OpSpec, ...]],
        config: HeteroNALPTrainerConfig,
        optimizer_args: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        for nt in (config.anchor_node_type, config.candidate_node_type):
            if str(nt) not in paths:
                raise ValueError(f"no sampling path for node type {nt!r}")
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.model = model.to(self.device).eval()
        self.graph = graph
        self.paths = {k: tuple(v) for k, v in paths.items()}
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        if self.cfg.tabularized:
            self.refresh_tables(0)

    def refresh_tables(self, epoch: int = 0) -> None:
        """(Re)freeze the per-node samples with a new seed."""
        self.graph = self.graph.with_sample_tables(
            self.paths, seed=self.cfg.seed + 1_299_709 * epoch)

    def init_params(self, seed: int = 0) -> None:
        """Initialize every module of every path (all node types' and edge
        types' parameters) as flax's defaults do, from ``seed``."""
        init_params(self.model, seed)

    def _encode_impl(self, graph: HeteroDeviceGraph, node_ids: torch.Tensor,
                     node_type: str, seed_offset: int, train: bool,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        shape = tuple(node_ids.shape)
        if self.cfg.tabularized and graph.sample_tables is not None:
            blocks = graph.sample_tabularized(node_ids, node_type,
                                              self.paths[node_type])
        else:
            blocks = graph.sample(node_ids, node_type, self.paths[node_type],
                                  seed=self.cfg.seed + seed_offset)
        feats, _ = graph.hydrate(blocks)
        emb = self.model(blocks, feats, train=train, generator=generator)
        return emb.reshape(shape + (emb.shape[-1],))

    def encode_batch(self, node_ids, node_type: Optional[str] = None
                     ) -> torch.Tensor:
        """Inference encode of node ids (array or tensor) of ``node_type``
        (the anchor type by default)."""
        nt = str(node_type or self.cfg.anchor_node_type)
        ids = torch.as_tensor(node_ids, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return self._encode_impl(self.graph, ids, nt, 0, False)

    def infer_batch(self, batch) -> torch.Tensor:
        """batch: anchor-type node ids -> embeddings [B, D]."""
        return self.encode_batch(batch)

    def _training(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    init_state = train_step = train_steps = evaluate = fit = _training
