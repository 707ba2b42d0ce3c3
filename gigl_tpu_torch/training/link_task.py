"""Supervised link classification (port of
``gigl_tpu/training/link_task.py``: ``EdgeClassifierHead``,
``LinkClassificationModel``, ``LinkClassificationTrainerConfig`` and
``LinkClassificationTrainer``).

Each labelled edge's endpoints are encoded by one sampled-block GNN
encoder (their fanout trees drawn by K1, or K19 with
``sampling_method="weighted"`` / ``"top_k"``, keyed by the config's seed on
every step as the reference's are; hydrated by K3; GraphSAGE's
aggregation K4, backward K4b), combined (``hadamard`` or ``concat``) and
classified by a two-layer head; the loss is the mean cross entropy, the
evaluation the edge accuracy. The encoder runs without degrees
(``hop_degrees=None``), as the reference passes. A train step refuses a
batch-norm encoder, as the reference's raises (``training/base.py``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.losses.losses import cross_entropy_loss
from gigl_tpu_torch.losses.metrics import accuracy
from gigl_tpu_torch.models.convs import linear
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.training.base import refuse_batch_norm_training
from gigl_tpu_torch.training.dataset import AnchorBatchIterator, DeviceGraph
from gigl_tpu_torch.training.early_stop import EarlyStopper
from gigl_tpu_torch.training.trainer import (
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
)

logger = logging.getLogger(__name__)


class EdgeClassifierHead(nn.Module):
    """Combine two endpoint embeddings [B, in_dim] (``hadamard``: the
    elementwise product; ``concat``) and classify: ``Dense_1(relu(
    Dense_0(z)))``, flax's automatic names, computed in ``dtype``."""

    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int = 64,
                 combine: str = "hadamard",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if combine not in ("hadamard", "concat"):
            raise ValueError(f"unknown combine {combine!r}")
        self.combine = combine
        self.dtype = dtype
        width = in_dim if combine == "hadamard" else 2 * in_dim
        self.Dense_0 = nn.Linear(width, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, num_classes)

    def forward(self, src_emb: torch.Tensor, dst_emb: torch.Tensor):
        if self.combine == "hadamard":
            z = src_emb * dst_emb
        else:
            z = torch.cat([src_emb, dst_emb], dim=-1)
        z = torch.relu(linear(self.Dense_0, z, self.dtype))
        return linear(self.Dense_1, z, self.dtype)


class LinkClassificationModel(nn.Module):
    """One GNN encoder for both endpoints, then the edge classifier."""

    def __init__(self, encoder: nn.Module, head: EdgeClassifierHead):
        super().__init__()
        self.encoder = encoder
        self.head = head

    def forward(self, src_feats, src_masks, dst_feats, dst_masks,
                train: bool = False, hop_degrees=None, generator=None):
        zs = self.encoder(src_feats, src_masks, None, train=train,
                          hop_degrees=hop_degrees, generator=generator)
        zd = self.encoder(dst_feats, dst_masks, None, train=train,
                          hop_degrees=hop_degrees, generator=generator)
        return self.head(zs, zd)


@dataclass
class LinkClassificationTrainerConfig:
    fanouts: Tuple[int, ...] = (10, 5)
    seed: int = 0
    sampling_method: str = "uniform"


class LinkClassificationTrainer:
    """Edge classification over a DeviceGraph and a labelled edge list:
    ``labeled_edges`` [2, E] (source row 0, destination row 1),
    ``edge_labels`` [E] class ids; batches are edge-index batches. Runs on
    CUDA unless ``device`` says otherwise."""

    def __init__(self, model: LinkClassificationModel, graph: DeviceGraph,
                 labeled_edges, edge_labels,
                 config: LinkClassificationTrainerConfig,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.model = model.to(self.device).eval()
        self.graph = graph
        self.edges = torch.as_tensor(np.asarray(labeled_edges),
                                     dtype=torch.int32).to(self.device)
        self.labels = torch.as_tensor(np.asarray(edge_labels),
                                      dtype=torch.int32).to(self.device)
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0

    # -- state -----------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        init_params(self.model, seed)

    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from ``params_from_flax``)
        or initialize the weights from ``seed``, then build the optimizer
        (``batch_size`` is the reference's tracing shape, unused)."""
        del batch_size
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        return TrainState(step=0, optimizer=opt)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.int32, device=self.device)

    # -- forward ---------------------------------------------------------------
    def _encode_inputs(self, graph: DeviceGraph, node_ids: torch.Tensor):
        """One endpoint side's fanout tree: drawn with the config's seed
        (the same draw every step), hydrated."""
        blocks = graph.sample_hop_blocks(node_ids, self.cfg.fanouts,
                                         seed=self.cfg.seed,
                                         method=self.cfg.sampling_method)
        feats, masks, _ = graph.hydrate(blocks)
        return feats, masks

    def _logits(self, graph: DeviceGraph, src: torch.Tensor,
                dst: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None):
        sf, sm = self._encode_inputs(graph, src)
        df, dm = self._encode_inputs(graph, dst)
        return self.model(sf, sm, df, dm, train=train, generator=generator)

    def predict_batch(self, src, dst) -> torch.Tensor:
        """Per-edge class logits [B, classes] (the inference surface)."""
        with torch.inference_mode():
            return self._logits(self.graph, self._ids(src), self._ids(dst),
                                False)

    # -- training --------------------------------------------------------------
    def loss(self, edge_idx, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Train-mode mean cross entropy of the labelled edges
        ``edge_idx`` (differentiable in the model's weights)."""
        refuse_batch_norm_training(self.model)
        idx = self._ids(edge_idx).long()
        logits = self._logits(self.graph, self.edges[0, idx],
                              self.edges[1, idx], True, generator)
        s, c = cross_entropy_loss(logits, self.labels[idx])
        return s / torch.clamp(c.to(torch.float32), min=1.0)

    def train_step(self, state: TrainState, edge_idx,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step: sample, forward, backward, update; the loss stays on
        the device."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(edge_idx, generator)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    # -- evaluation ------------------------------------------------------------
    def _eval_step(self, edge_idx: torch.Tensor):
        idx = edge_idx.long()
        logits = self._logits(self.graph, self.edges[0, idx],
                              self.edges[1, idx], False)
        return accuracy(logits, self.labels[idx])

    def evaluate(self, edge_indices, batch_size: int = 512) -> float:
        """Edge accuracy over ``edge_indices`` in batches (the last one
        padded by wrapping, as the reference does); one host sync."""
        it = AnchorBatchIterator(np.asarray(edge_indices), batch_size,
                                 drop_remainder=False)
        with torch.inference_mode():
            parts = [self._eval_step(self._ids(b)) for b in it.epoch(0)]
            if not parts:
                return 0.0
            correct, total = (torch.stack(p).sum().cpu()
                              for p in zip(*parts))
        return float(correct) / max(float(total), 1.0)

    def fit(self, state: TrainState, train_idx, val_idx, *,
            batch_size: int, num_epochs: int = 10,
            early_stop_patience: int = 5, log_every: int = 50
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Epochs of shuffled edge batches, a val evaluation after each,
        early stopping on val accuracy; the best weights are loaded back.
        Returns the best val accuracy."""
        it = AnchorBatchIterator(np.asarray(train_idx), batch_size,
                                 seed=self.cfg.seed)
        stopper = EarlyStopper(patience=early_stop_patience)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        step = 0
        for epoch in range(num_epochs):
            for b in it.epoch(epoch):
                state, loss = self.train_step(state, b, generator)
                step += 1
                if log_every and step % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f", epoch, step,
                                float(loss))
            acc = self.evaluate(val_idx, batch_size)
            logger.info("epoch %d val edge-accuracy %.4f", epoch, acc)
            snap = {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}
            if stopper.update(acc, snap):
                break
        if stopper.best_state is not None:
            self.model.load_state_dict(stopper.best_state)
        return state, {"accuracy": stopper.best_value or 0.0}
