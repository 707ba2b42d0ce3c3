"""Node-anchor link prediction trainer — the inference subset (port of
``gigl_tpu/training/trainer.py`` ``NALPTrainerConfig`` and ``NALPTrainer``:
``__init__``, ``refresh_cache``, ``_encode_impl``, ``encode_batch``).

Training, evaluation and ``fit`` are not ported yet. The model's weights
live in the model (``nn.Module``); ``init_params(seed)`` initializes them
from a ``torch.Generator``, and ``gigl_tpu_torch.convert.params_from_flax``
turns a reference param tree into a state dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.models.encoders import cached_agg_kind
from gigl_tpu_torch.models.link_prediction import LinkPredictionGNN
from gigl_tpu_torch.training.base import BaseInferencer
from gigl_tpu_torch.training.dataset import DeviceGraph


@dataclass
class NALPTrainerConfig:
    fanouts: Tuple[int, ...] = (10, 5)
    num_positives: int = 1
    num_hard_negs: int = 0
    num_random_negs: int = 512
    loss_type: str = "retrieval"  # retrieval | margin | softmax
    margin: float = 0.5
    temperature: float = 0.07
    remove_accidental_hits: bool = True
    use_cms_correction: bool = False
    eval_ks: Tuple[int, ...] = (1, 5, 10, 50, 100)
    seed: int = 0
    # Neighbor-sampling method; only "uniform" is ported.
    sampling_method: str = "uniform"
    # Tabularized deepest-hop cache (ops/hopcache.py): gather per-node
    # precomputed aggregates instead of resampling the deepest hop.
    cached_hop: bool = False
    # int8 hop cache (not ported).
    quantize_cache: bool = False
    # One fused [N, D + D] table of features and aggregates, so layer-1
    # hydration is one row gather per tree level.
    fused_cache: bool = False
    # Partitioned trainers only (not ported).
    global_candidate_pool: bool = False


class NALPTrainer(BaseInferencer):
    """Node-anchor link prediction model over a DeviceGraph (inference)."""

    def __init__(
        self,
        model: LinkPredictionGNN,
        graph: DeviceGraph,
        config: NALPTrainerConfig,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.model = model.to(self.device).eval()
        self.graph = graph
        self.cfg = config
        if config.quantize_cache:
            raise NotImplementedError(
                "quantize_cache is not ported yet "
                "(gigl_tpu.ops.quantized.QuantizedTable)")
        if self.cfg.cached_hop:
            # Validates the conv is cacheable up front and builds the tables.
            self.refresh_cache(0)

    def init_params(self, seed: int = 0) -> None:
        """Initialize every Linear from a seeded ``torch.Generator`` on the
        CPU (so the same seed gives the same weights on every device):
        kernels ~ N(0, 1/fan_in) (flax's lecun-normal scale), biases 0."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.model.modules():
                if isinstance(mod, nn.Linear):
                    w = torch.randn(mod.weight.shape, generator=gen)
                    mod.weight.copy_(w / math.sqrt(mod.in_features))
                    if mod.bias is not None:
                        mod.bias.zero_()

    # -- hop cache -------------------------------------------------------------
    def refresh_cache(self, epoch: int = 0) -> None:
        """(Re)build the tabularized tables with a new seed — the analog of
        re-running the reference's Subgraph Sampler."""
        enc = self.model.encoder
        self.graph = self.graph.with_neighbor_cache(
            fanout=int(self.cfg.fanouts[-1]),
            seed=self.cfg.seed + 1_299_709 * epoch,
            hop_key=len(self.cfg.fanouts),
            agg=cached_agg_kind(enc.conv, enc.conv_kwargs),
            table_fanouts=self.cfg.fanouts[:-1],
            quantize=self.cfg.quantize_cache,
            fuse_features=self.cfg.fused_cache,
            method=self.cfg.sampling_method)

    # -- encoding --------------------------------------------------------------
    def _encode_impl(self, graph: DeviceGraph, node_ids: torch.Tensor,
                     seed_offset: int, train: bool) -> torch.Tensor:
        """Encode an arbitrary-shaped node id tensor -> embeddings of the
        same leading shape + [D]."""
        shape = tuple(node_ids.shape)
        if self.cfg.cached_hop and graph.nbr_cache is not None:
            # The tree is one hop shallower; layer 1 reads the cached table.
            if graph.sample_tables is not None:
                blocks = graph.sample_hop_blocks_tabularized(
                    node_ids, self.cfg.fanouts[:-1])
            else:
                blocks = graph.sample_hop_blocks(
                    node_ids, self.cfg.fanouts[:-1],
                    seed=self.cfg.seed + seed_offset,
                    method=self.cfg.sampling_method)
            if graph.fused_table is not None:
                feats, masks, degs, cached = graph.hydrate_fused(blocks)
            else:
                feats, masks, degs = graph.hydrate(blocks)
                cached = graph.hydrate_cached(blocks)
            emb = self.model(feats, masks, None, train=train,
                             hop_degrees=degs, cached_agg=cached)
            return emb.reshape(shape + (emb.shape[-1],))
        blocks = graph.sample_hop_blocks(
            node_ids, self.cfg.fanouts, seed=self.cfg.seed + seed_offset,
            method=self.cfg.sampling_method)
        feats, masks, degs = graph.hydrate(blocks)
        emb = self.model(feats, masks, None, train=train, hop_degrees=degs)
        return emb.reshape(shape + (emb.shape[-1],))

    def encode_batch(self, node_ids) -> torch.Tensor:
        """Inference encode of a batch of node ids (array or tensor)."""
        ids = torch.as_tensor(node_ids, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return self._encode_impl(self.graph, ids, 0, False)

    def infer_batch(self, batch) -> torch.Tensor:
        """batch: node ids -> embeddings [B, D]."""
        return self.encode_batch(batch)
