"""Heterogeneous node-anchor link-prediction trainer (port of
``gigl_tpu/training/hetero_trainer.py``: ``HeteroNALPTrainerConfig`` and
``HeteroNALPTrainer``).

``encode_batch(node_ids, node_type)`` is the sampled typed serving path:
the node type's op tree is drawn live through K1 (keyed by the config's
seed) or, with ``tabularized``, expanded from frozen sample tables through
K3; the feature rows are gathered through K3 (``hydrate``) and encoded
through the typed block tree (HGT: K7; RGCN: K4; SimpleHGN: K7 with its
relation bias).

Training follows the reference, which trains typed models through the
block form only: a step draws the batch (``HeteroDeviceGraph.
sample_nalp_batch``: positives and hard negatives through K1, random
negatives of the candidate type through K1b), encodes the anchors,
positives, random negatives (and hard negatives) through their node
types' op trees (K1, K3, then HGT's K7 or RGCN's K4, whose backward is K7b
or K4b), scores them with ``decode_all_pairs`` and takes the loss
(``nalp_loss_from_embeddings``: K5 for the retrieval loss), then the
backward and the optimizer update. The model's weights live in the model
(``nn.Module``); ``TrainState`` holds the step and the ``torch.optim``
optimizer. Dropout draws from an explicit ``torch.Generator``; the model is
kept in ``eval()`` and each call's ``train=`` turns dropout on. Evaluation
ranks each positive against the batch's random negatives (MRR, hits@k);
``fit`` validates every ``val_every_n_batches`` steps with early stopping,
re-freezing the sample tables each epoch when tabularized. With the
model's ``EdgeFeatureScorer`` and the graph's label-edge features, the
batch carries each drawn edge's features and the loss (and evaluation's
positive scores) add the scorer's term, as the homogeneous trainer does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.losses.metrics import hits_at_k, mean_reciprocal_rank
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.sampling.hetero_sampler import OpSpec
from gigl_tpu_torch.training.base import BaseInferencer
from gigl_tpu_torch.training.dataset import NALPBatch
from gigl_tpu_torch.training.fit_loop import nalp_fit_loop
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.trainer import (
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
    nalp_loss_from_embeddings,
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
    # Partitioned trainers only (training/dist_hetero.py): the ring loss
    # over every shard's candidates.
    global_candidate_pool: bool = False


class HeteroNALPTrainer(BaseInferencer):
    """Typed NALP trainer over a HeteroDeviceGraph; ``paths`` holds each
    node type's resolved op tree (see the module docstring)."""

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
        self.grad_clip_norm = 0.0
        if self.cfg.tabularized:
            self.refresh_tables(0)

    def refresh_tables(self, epoch: int = 0) -> None:
        """(Re)freeze the per-node samples with a new seed."""
        self.graph = self.graph.with_sample_tables(
            self.paths, seed=self.cfg.seed + 1_299_709 * epoch)

    # -- state -----------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Initialize every module of every path (all node types' and edge
        types' parameters) as flax's defaults do, from ``seed``."""
        init_params(self.model, seed)

    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from ``params_from_flax``)
        or initialize every node type's and edge type's weights from
        ``seed``, then build the optimizer. ``batch_size`` is the
        reference's tracing shape; the port's weights do not depend on
        it."""
        del batch_size
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        return TrainState(step=0, optimizer=opt)

    # -- encoding --------------------------------------------------------------
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

    def _ids(self, node_ids) -> torch.Tensor:
        return torch.as_tensor(node_ids, dtype=torch.int32,
                               device=self.device)

    def encode_batch(self, node_ids, node_type: Optional[str] = None
                     ) -> torch.Tensor:
        """Inference encode of node ids (array or tensor) of ``node_type``
        (the anchor type by default)."""
        nt = str(node_type or self.cfg.anchor_node_type)
        with torch.inference_mode():
            return self._encode_impl(self.graph, self._ids(node_ids), nt, 0,
                                     False)

    def infer_batch(self, batch) -> torch.Tensor:
        """batch: anchor-type node ids -> embeddings [B, D]."""
        return self.encode_batch(batch)

    def _scores(self, graph: HeteroDeviceGraph, batch: NALPBatch,
                train: bool, generator: Optional[torch.Generator] = None):
        """Per-group encoder passes: anchors (anchor type), positives,
        random negatives and hard negatives (candidate type; None when
        there are none)."""
        a_nt = str(self.cfg.anchor_node_type)
        c_nt = str(self.cfg.candidate_node_type)
        q = self._encode_impl(graph, batch.anchors, a_nt, 0, train,
                              generator)
        pos = self._encode_impl(graph, batch.pos, c_nt, 1, train, generator)
        rand = self._encode_impl(graph, batch.random_neg, c_nt, 2, train,
                                 generator)
        hard = None
        if batch.hard_neg.shape[-1] > 0:
            hard = self._encode_impl(graph, batch.hard_neg, c_nt, 3, train,
                                     generator)
        return q, pos, hard, rand

    # -- training --------------------------------------------------------------
    def sample_batch(self, anchors, step: int, *,
                     num_hard_negs: Optional[int] = None,
                     seed: Optional[int] = None) -> NALPBatch:
        """The batch of ``step`` for ``anchors`` (the reference's
        ``_sample_batch``; the config's hard negatives and seed unless
        given)."""
        return self.graph.sample_nalp_batch(
            self._ids(anchors), self.cfg.candidate_node_type,
            num_positives=self.cfg.num_positives,
            num_hard_negs=(self.cfg.num_hard_negs if num_hard_negs is None
                           else num_hard_negs),
            num_random_negs=self.cfg.num_random_negs,
            seed=self.cfg.seed if seed is None else seed, step=step)

    def loss(self, batch: NALPBatch,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train-mode mean loss of ``batch`` (differentiable in the
        model's weights)."""
        q, pos, hard, rand = self._scores(self.graph, batch, True, generator)
        return nalp_loss_from_embeddings(self.model, self.cfg, batch, q, pos,
                                         hard, rand)[0]

    def train_step(self, state: TrainState, anchors,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step: sample, forward, backward, update. Returns the new
        state and the loss as a 0-d device tensor (no host sync)."""
        batch = self.sample_batch(anchors, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, generator)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def train_steps(self, state: TrainState, anchors_kb,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[TrainState, torch.Tensor]:
        """``anchors_kb.shape[0]`` consecutive steps; returns the state and
        the per-step losses as a device tensor [K], with no host sync."""
        anchors_kb = self._ids(anchors_kb)
        losses = torch.empty((anchors_kb.shape[0],), dtype=torch.float32,
                             device=self.device)
        for k in range(anchors_kb.shape[0]):
            state, loss = self.train_step(state, anchors_kb[k], generator)
            losses[k] = loss
        return state, losses

    # -- evaluation ------------------------------------------------------------
    def _eval_step(self, graph: HeteroDeviceGraph, anchors: torch.Tensor,
                   step: int):
        """Rank each positive against the random negatives only (negatives
        equal to the row's positive are masked): (rr sum, hits sums [len
        eval_ks], count)."""
        batch = self.sample_batch(anchors, step, num_hard_negs=0,
                                  seed=self.cfg.seed + 7_777_777)
        q, pos, _, rand = self._scores(graph, batch, train=False)
        p = pos.shape[1]
        pos_flat = self.model.decode(q[:, None, :], pos,
                                     batch.pos_edge_feats).reshape(-1)
        neg_rep = self.model.decode_all_pairs(q, rand).repeat_interleave(
            p, dim=0)                                              # [B*P, R]
        mask_flat = batch.pos_mask.reshape(-1)
        neg_mask = batch.pos.reshape(-1)[:, None] != batch.random_neg[None, :]
        rr, cnt = mean_reciprocal_rank(pos_flat, neg_rep, pos_mask=mask_flat,
                                       neg_mask=neg_mask)
        hits, _ = hits_at_k(pos_flat, neg_rep, self.cfg.eval_ks,
                            pos_mask=mask_flat, neg_mask=neg_mask)
        return rr, torch.stack([hits[int(k)] for k in self.cfg.eval_ks]), cnt

    def evaluate(self, anchor_batches, step: int = 0) -> Dict[str, float]:
        """MRR and hits@k over ``anchor_batches`` (batch i keyed by step +
        i); one host sync at the end."""
        with torch.inference_mode():
            parts = [self._eval_step(self.graph, self._ids(anchors), step + i)
                     for i, anchors in enumerate(anchor_batches)]
            rr, hits, cnt = (torch.stack(p).sum(0).cpu() for p in zip(*parts))
        cnt_total = max(float(cnt), 1.0)
        out = {"mrr": float(rr) / cnt_total}
        for i, k in enumerate(self.cfg.eval_ks):
            out[f"hits@{k}"] = float(hits[i]) / cnt_total
        return out

    def fit(self, state: TrainState, train_anchors: np.ndarray,
            val_anchors: np.ndarray, *, batch_size: int, num_epochs: int = 1,
            val_every_n_batches: int = 100, num_val_batches: int = 8,
            early_stop_patience: int = 5,
            log_every: int = 50) -> Tuple[TrainState, Dict[str, float]]:
        """The typed train loop (``hetero_trainer.py:283-330``): shuffled
        anchor batches, the sample tables re-frozen each epoch after the
        first when tabularized, a validation of ``num_val_batches`` val
        batches at every ``val_every_n_batches``-th step with early
        stopping on val MRR; the best weights are loaded back, and the
        final val metrics returned."""
        return nalp_fit_loop(
            self, state, np.asarray(train_anchors), val_anchors,
            batch_size=batch_size, num_epochs=num_epochs,
            val_every_n_batches=val_every_n_batches,
            num_val_batches=num_val_batches,
            early_stop_patience=early_stop_patience, log_every=log_every,
            refresh=self.refresh_tables if self.cfg.tabularized else None,
            global_cadence=True)
