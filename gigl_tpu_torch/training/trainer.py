"""Trainers for node-anchor link prediction and node classification (port
of ``gigl_tpu/training/trainer.py``: ``TrainState``, ``make_optimizer``,
``NALPTrainerConfig``, ``nalp_loss_from_embeddings``, ``NALPTrainer``,
``NodeClassificationTrainerConfig`` and ``NodeClassificationTrainer``).

One training step is: ``sample_nalp_batch`` (K1 positives, K1b random
negatives), three encode chains (anchors, positives, random negatives;
message-graph draws through K1, or K19 with ``sampling_method="weighted"``
/ ``"top_k"``; K3 gathers and K4 reduces forward, K4b backward),
``decode_all_pairs`` (a plain matmul), the loss (K5 for the retrieval
loss), backward and the optimizer update. The model's weights live in the model (``nn.Module``);
``TrainState`` holds the step and the ``torch.optim`` optimizer over them.
Steps run eagerly on the current stream; ``train_steps`` keeps the losses
on the device, so a chunk of steps does no host synchronisation.

With message-edge features the live encode hydrates the drawn edges'
rows too (``hydrate_edges``, K3) and the encoder's edge convs read them;
with an ``EdgeFeatureScorer`` on the model and label-edge features on the
graph, each positive's and hard negative's score gains the scorer's term
of its own label edge (``nalp_loss_from_embeddings``), added to the score
matrix before K5.

A node-classification step samples the labeled nodes' fanout tree live
(K1, keyed by the config's seed on every step, as the reference does),
hydrates it (K3), encodes it on the dense-block path (GraphSAGE: K4 / K4b;
GAT and Transformer: K7 / K7b) and takes the mean cross entropy.

With ``use_cms_correction`` the state carries a count-min sketch: each
retrieval step adds all its candidate ids to it (K13, padded slots
included, as the reference counts them), estimates their sampling
probability from the new sketch (K14) and subtracts its log from the
logits inside K5 (the logQ correction). With ``quantize_cache`` (and a graph
from ``from_hetero(quantize_features=True)``) the cache (and the features)
are int8 tables, hydrated through K12: one launch an encode chain for
every tree level of both tables.

Not ported: checkpointing in ``fit``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.losses.count_min_sketch import (
    CountMinSketch,
    cms_add,
    cms_init,
    cms_sampling_probability,
)
from gigl_tpu_torch.losses.losses import (
    cross_entropy_loss,
    margin_loss,
    retrieval_loss,
    softmax_loss,
)
from gigl_tpu_torch.losses.metrics import (
    accuracy,
    hits_at_k,
    mean_reciprocal_rank,
)
from gigl_tpu_torch.models.encoders import cached_agg_kind
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.link_prediction import LinkPredictionGNN
from gigl_tpu_torch.training.base import (
    BaseInferencer,
    refuse_batch_norm_training,
)
from gigl_tpu_torch.training.dataset import (
    AnchorBatchIterator,
    DeviceGraph,
    NALPBatch,
)
from gigl_tpu_torch.training.early_stop import EarlyStopper

logger = logging.getLogger(__name__)


class TrainState(NamedTuple):
    step: int                          # host int; keys the per-step draws
    optimizer: torch.optim.Optimizer   # over the model's parameters
    cms: Optional[CountMinSketch] = None  # retrieval candidate sketch


def make_optimizer(args: Mapping[str, Any], params: Iterable[nn.Parameter]
                   ) -> Tuple[torch.optim.Optimizer, float]:
    """Optimizer from a flat string map (``learning_rate`` / ``optim_lr``,
    ``optimizer`` adam | adamw | sgd, ``weight_decay``, ``momentum``,
    ``grad_clip_norm``) with optax's defaults: Adam b1 0.9, b2 0.999,
    eps 1e-8 outside the square root; AdamW weight decay 0.0 unless given;
    SGD momentum 0.9. Returns (optimizer, clip norm; 0 = no clipping)."""
    lr = float(args.get("learning_rate", args.get("optim_lr", 1e-3)))
    wd = float(args.get("weight_decay", 0.0))
    name = str(args.get("optimizer", "adam")).lower()
    clip = float(args.get("grad_clip_norm", 0.0))
    params = list(params)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(args.get("momentum", 0.9)))
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return opt, clip


def clip_by_global_norm_(params: Iterable[nn.Parameter],
                         max_norm: float) -> None:
    """optax ``clip_by_global_norm``: when the global L2 norm of the
    gradients reaches ``max_norm``, scale them by ``max_norm / norm`` (no
    epsilon; computed on the device, no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


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
    # Neighbor-sampling method of the message graph: uniform (K1), or
    # weighted / top_k (K19; a graph from from_hetero(sampling_weight_index)).
    # The label-edge draws (positives, hard negatives) stay uniform.
    sampling_method: str = "uniform"
    # Tabularized deepest-hop cache (ops/hopcache.py): gather per-node
    # precomputed aggregates instead of resampling the deepest hop.
    cached_hop: bool = False
    # Store the hop cache int8-quantized (4x less device memory; features
    # are quantized at DeviceGraph.from_hetero(quantize_features=True)).
    quantize_cache: bool = False
    # One fused [N, D + D] table of features and aggregates, so layer-1
    # hydration is one row gather per tree level.
    fused_cache: bool = False
    # Partitioned trainer only: the retrieval softmax over every shard's
    # candidates, as a ring (losses/sharded_retrieval.py).
    global_candidate_pool: bool = False


def nalp_loss_from_embeddings(model, cfg: NALPTrainerConfig,
                              batch: NALPBatch, q, pos, hard, rand,
                              cms: Optional[CountMinSketch] = None,
                              counted: bool = False
                              ) -> Tuple[torch.Tensor,
                                         Optional[CountMinSketch]]:
    """(mean NALP loss, updated sketch) from the encoded groups (q [B, D],
    pos [B, P, D], hard [B, H, D] or None, rand [R, D]).

    Retrieval: queries repeated once per positive; candidates = positives
    ++ hard negatives ++ random negatives, padded positive / hard slots
    masked as candidate columns; diagonal labels, duplicate-query and
    accidental-hit masks (K5). With a sketch ``cms``, every candidate id
    (padded ones too) is added to it first (K13), and the new sketch's
    estimate of each candidate's sampling probability (K14) is K5's logQ
    term; with ``counted`` the sketch already holds them (the partitioned
    trainer adds every shard's candidates first) and is only read.
    Margin / softmax: each positive against the hard and random
    negatives; the sketch is returned as given.

    Label-edge terms (``trainer.py:152-192``): with the model's
    ``edge_scorer`` and the batch's label-edge features, the scorer's term
    of each supervision edge is added to that pair's score — never to a
    random negative. Retrieval: row r's own positive is column r (the
    diagonal of the positive block); anchor b's hard edge (b, j) scores
    against all of b's query rows."""
    has_scorer = getattr(model, "edge_scorer", None) is not None
    use_pos_ef = has_scorer and batch.pos_edge_feats is not None
    use_hard_ef = (has_scorer and hard is not None
                   and batch.hard_neg_edge_feats is not None)
    B, P, D = pos.shape
    if cfg.loss_type == "retrieval":
        parts = [pos.reshape(B * P, D)]
        id_parts = [batch.pos.reshape(-1)]
        cmask_parts = [batch.pos_mask.reshape(-1)]
        if hard is not None and hard.shape[1] > 0:
            parts.append(hard.reshape(-1, D))
            id_parts.append(batch.hard_neg.reshape(-1))
            cmask_parts.append(batch.hard_neg_mask.reshape(-1))
        parts.append(rand)
        id_parts.append(batch.random_neg)
        cmask_parts.append(torch.ones(rand.shape[0], dtype=torch.bool,
                                      device=rand.device))
        scores = model.decode_all_pairs(q.repeat_interleave(P, dim=0),
                                        torch.cat(parts))      # [B*P, C]
        if use_pos_ef or use_hard_ef:
            scores = scores + _label_edge_terms(model, batch, scores, B, P,
                                                use_pos_ef, use_hard_ef)
        cids = torch.cat(id_parts)
        prob = None
        if cms is not None:
            if not counted:
                cms = cms_add(cms, cids)
            prob = cms_sampling_probability(cms, cids)
        loss_sum, count = retrieval_loss(
            scores,
            temperature=cfg.temperature,
            candidate_sampling_probability=prob,
            query_ids=batch.anchors.repeat_interleave(P),
            candidate_ids=cids,
            remove_accidental_hits=cfg.remove_accidental_hits,
            query_mask=batch.pos_mask.reshape(-1),
            candidate_mask=torch.cat(cmask_parts))
    else:
        pos_scores = model.decode(
            q[:, None, :], pos,
            batch.pos_edge_feats if use_pos_ef else None)      # [B, P]
        neg_scores = model.decode_all_pairs(q, rand)           # [B, R]
        neg_mask = torch.ones(neg_scores.shape, dtype=torch.bool,
                              device=neg_scores.device)
        if hard is not None:
            neg_scores = torch.cat(
                [model.decode(q[:, None, :], hard,
                              batch.hard_neg_edge_feats if use_hard_ef
                              else None), neg_scores], -1)
            neg_mask = torch.cat([batch.hard_neg_mask, neg_mask], -1)
        if cfg.loss_type == "margin":
            loss_sum, count = margin_loss(
                pos_scores, neg_scores, margin=cfg.margin,
                pos_mask=batch.pos_mask, neg_mask=neg_mask)
        elif cfg.loss_type == "softmax":
            loss_sum, count = softmax_loss(
                pos_scores, neg_scores, temperature=cfg.temperature,
                pos_mask=batch.pos_mask, neg_mask=neg_mask)
        else:
            raise ValueError(f"Unknown loss {cfg.loss_type!r}")
    return loss_sum / torch.clamp(count.to(torch.float32), min=1.0), cms


def _label_edge_terms(model, batch: NALPBatch, scores: torch.Tensor, B: int,
                      P: int, use_pos: bool, use_hard: bool) -> torch.Tensor:
    """The [B*P, C] addend of the retrieval scores: the positive edges'
    scorer terms on the positive block's diagonal and the hard edges' on
    their anchor's rows of the hard block, zero elsewhere (in the scores'
    type, as the reference's scatter-add casts them)."""
    C = scores.shape[1]
    cols = []
    if use_pos:
        e_pos = model.edge_score(batch.pos_edge_feats.reshape(B * P, -1))
        cols.append(torch.diag(e_pos))
    else:
        cols.append(scores.new_zeros((B * P, B * P)))
    if use_hard:
        H = batch.hard_neg.shape[1]
        e_hard = model.edge_score(
            batch.hard_neg_edge_feats.reshape(B * H, -1))       # [B*H]
        row_b = torch.arange(B * P, device=scores.device) // P
        col_b = torch.arange(B * H, device=scores.device) // H
        cols.append(torch.where(row_b[:, None] == col_b[None, :],
                                e_hard[None, :], 0.0))
    used = sum(c.shape[1] for c in cols)
    cols.append(scores.new_zeros((B * P, C - used)))
    return torch.cat([c.to(scores.dtype) for c in cols], dim=1)


class NALPTrainer(BaseInferencer):
    """Node-anchor link prediction trainer over a DeviceGraph."""

    def __init__(
        self,
        model: LinkPredictionGNN,
        graph: DeviceGraph,
        config: NALPTrainerConfig,
        optimizer_args: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.model = model.to(self.device).eval()
        self.graph = graph
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        # Graph for evaluate() when the val/test supervision edges differ
        # from the train graph's.
        self.eval_graph: Optional[DeviceGraph] = None
        if self.cfg.cached_hop:
            # Validates the conv is cacheable up front and builds the tables.
            self.refresh_cache(0)

    # -- state -----------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Initialize the model as flax's defaults do, from ``seed``
        (``gigl_tpu_torch.models.init.init_params``)."""
        init_params(self.model, seed)

    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from ``params_from_flax``)
        or initialize the weights from ``seed``, then build the optimizer
        (and, with ``use_cms_correction``, an empty sketch on the device).
        ``batch_size`` is the reference's tracing shape; the port's weights
        do not depend on it."""
        del batch_size
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        cms = cms_init(device=self.device) if self.cfg.use_cms_correction \
            else None
        return TrainState(step=0, optimizer=opt, cms=cms)

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
                     seed_offset: int, train: bool,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
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
                feats, masks, degs, cached = graph.hydrate_with_cache(blocks)
            emb = self.model(feats, masks, None, train=train,
                             hop_degrees=degs, cached_agg=cached,
                             generator=generator)
            return emb.reshape(shape + (emb.shape[-1],))
        blocks = graph.sample_hop_blocks(
            node_ids, self.cfg.fanouts, seed=self.cfg.seed + seed_offset,
            method=self.cfg.sampling_method)
        feats, masks, degs = graph.hydrate(blocks)
        emb = self.model(feats, masks, graph.hydrate_edges(blocks),
                         train=train, hop_degrees=degs, generator=generator)
        return emb.reshape(shape + (emb.shape[-1],))

    def _ids(self, node_ids) -> torch.Tensor:
        return torch.as_tensor(node_ids, dtype=torch.int32,
                               device=self.device)

    def encode_batch(self, node_ids) -> torch.Tensor:
        """Inference encode of a batch of node ids (array or tensor)."""
        with torch.inference_mode():
            return self._encode_impl(self.graph, self._ids(node_ids), 0,
                                     False)

    def infer_batch(self, batch) -> torch.Tensor:
        """batch: node ids -> embeddings [B, D]."""
        return self.encode_batch(batch)

    def _scores(self, graph: DeviceGraph, batch: NALPBatch, train: bool,
                generator: Optional[torch.Generator] = None):
        """Per-group encoder passes: anchors, positives, random negatives,
        hard negatives (None when there are none)."""
        q = self._encode_impl(graph, batch.anchors, 0, train, generator)
        pos = self._encode_impl(graph, batch.pos, 1, train, generator)
        rand = self._encode_impl(graph, batch.random_neg, 2, train, generator)
        hard = None
        if batch.hard_neg.shape[-1] > 0:
            hard = self._encode_impl(graph, batch.hard_neg, 3, train,
                                     generator)
        return q, pos, hard, rand

    # -- training --------------------------------------------------------------
    def sample_batch(self, anchors, step: int) -> NALPBatch:
        """The training batch of ``step`` for ``anchors``."""
        return self.graph.sample_nalp_batch(
            self._ids(anchors),
            num_positives=self.cfg.num_positives,
            num_hard_negs=self.cfg.num_hard_negs,
            num_random_negs=self.cfg.num_random_negs,
            seed=self.cfg.seed,
            step=step)

    def loss_and_sketch(self, batch: NALPBatch,
                        cms: Optional[CountMinSketch] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Optional[CountMinSketch]]:
        """(train-mode mean loss of ``batch``, differentiable in the
        model's weights; the sketch ``cms`` with the batch's candidates
        added, or None without one)."""
        refuse_batch_norm_training(self.model)
        q, pos, hard, rand = self._scores(self.graph, batch, True, generator)
        return nalp_loss_from_embeddings(self.model, self.cfg, batch, q, pos,
                                         hard, rand, cms)

    def loss(self, batch: NALPBatch,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Train-mode mean loss of ``batch`` without the logQ correction
        (differentiable in the model's weights)."""
        return self.loss_and_sketch(batch, None, generator)[0]

    def train_step(self, state: TrainState, anchors,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step: sample, forward, backward, update, and the sketch
        advanced. Returns the new state and the loss as a 0-d device tensor
        (no host sync)."""
        batch = self.sample_batch(anchors, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss, cms = self.loss_and_sketch(batch, state.cms, generator)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1, cms=cms), loss.detach()

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
    def _eval_step(self, graph: DeviceGraph, anchors: torch.Tensor,
                   step: int):
        """Rank each positive against the random negatives only (negatives
        equal to the row's positive are masked): (rr sum, hits sums [len
        eval_ks], count)."""
        batch = graph.sample_nalp_batch(
            anchors,
            num_positives=self.cfg.num_positives,
            num_hard_negs=0,
            num_random_negs=self.cfg.num_random_negs,
            seed=self.cfg.seed + 7_777_777,
            step=step)
        q, pos, _, rand = self._scores(graph, batch, train=False)
        P = pos.shape[1]
        pos_flat = self.model.decode(q[:, None, :], pos,
                                     batch.pos_edge_feats).reshape(-1)
        neg_rep = self.model.decode_all_pairs(q, rand).repeat_interleave(
            P, dim=0)                                              # [B*P, R]
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
        g = self.eval_graph if self.eval_graph is not None else self.graph
        with torch.inference_mode():
            parts = [self._eval_step(g, self._ids(anchors), step + i)
                     for i, anchors in enumerate(anchor_batches)]
            rr, hits, cnt = (torch.stack(p).sum(0).cpu() for p in zip(*parts))
        cnt_total = max(float(cnt), 1.0)
        out = {"mrr": float(rr) / cnt_total}
        for i, k in enumerate(self.cfg.eval_ks):
            out[f"hits@{k}"] = float(hits[i]) / cnt_total
        return out

    def fit(
        self,
        state: TrainState,
        train_anchors: np.ndarray,
        val_anchors: np.ndarray,
        *,
        batch_size: int,
        num_epochs: int = 1,
        val_every_n_batches: int = 100,
        num_val_batches: int = 8,
        early_stop_patience: int = 5,
        log_every: int = 50,
        scalar_logger=None,
        checkpoint_dir: Optional[str] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """The NALP train loop: batches with periodic validation and early
        stopping on val MRR; the best weights are loaded back at the end.
        ``scalar_logger``: any object with ``.log(step, **scalars)``."""
        from gigl_tpu_torch.training.fit_loop import nalp_fit_loop

        return nalp_fit_loop(
            self, state, train_anchors, val_anchors,
            batch_size=batch_size, num_epochs=num_epochs,
            val_every_n_batches=val_every_n_batches,
            num_val_batches=num_val_batches,
            early_stop_patience=early_stop_patience, log_every=log_every,
            scalar_logger=scalar_logger, checkpoint_dir=checkpoint_dir,
            refresh=self.refresh_cache if self.cfg.cached_hop else None)


# ---------------------------------------------------------------------------
# Node classification
# ---------------------------------------------------------------------------

@dataclass
class NodeClassificationTrainerConfig:
    fanouts: Tuple[int, ...] = (10, 5)
    seed: int = 0
    # Partitioned NC trainer only (not ported): this trainer samples live.
    cached_hop: bool = False
    # Kept for the reference's config; its NC trainer samples uniformly.
    sampling_method: str = "uniform"


class NodeClassificationTrainer:
    """Supervised node classification over a DeviceGraph with labels: CE
    loss on sampled fanout trees of labeled nodes, accuracy eval. The
    model is an encoder whose output width is the number of classes."""

    def __init__(self, model: nn.Module, graph: DeviceGraph,
                 config: NodeClassificationTrainerConfig,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        if graph.node_labels is None:
            raise ValueError("graph has no node labels")
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.model = model.to(self.device).eval()
        self.graph = graph
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        # Graph for evaluate() (inductive node classification swaps in the
        # val / test message graph).
        self.eval_graph: Optional[DeviceGraph] = None

    def init_params(self, seed: int = 0) -> None:
        init_params(self.model, seed)

    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` or initialize the weights from ``seed``, then
        build the optimizer (``batch_size`` is the reference's tracing
        shape, unused)."""
        del batch_size
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        return TrainState(step=0, optimizer=opt)

    def _ids(self, node_ids) -> torch.Tensor:
        return torch.as_tensor(node_ids, dtype=torch.int32,
                               device=self.device)

    def _forward(self, graph: DeviceGraph, nodes: torch.Tensor, train: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, classes]: the live sample keyed by ``cfg.seed`` (the
        same draw on every step, as the reference's), hydration, encode."""
        blocks = graph.sample_hop_blocks(nodes, self.cfg.fanouts,
                                         seed=self.cfg.seed)
        feats, masks, degs = graph.hydrate(blocks)
        return self.model(feats, masks, None, train=train, hop_degrees=degs,
                          generator=generator)

    def predict_batch(self, nodes) -> torch.Tensor:
        """Inference logits of a batch of node ids."""
        with torch.inference_mode():
            return self._forward(self.graph, self._ids(nodes), False)

    def loss(self, nodes, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Train-mode mean cross entropy of ``nodes`` (differentiable in
        the model's weights)."""
        refuse_batch_norm_training(self.model)
        nodes = self._ids(nodes)
        labels = self.graph.node_labels[nodes.long()]
        s, c = cross_entropy_loss(
            self._forward(self.graph, nodes, True, generator), labels)
        return s / torch.clamp(c.to(torch.float32), min=1.0)

    def train_step(self, state: TrainState, nodes,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step: sample, forward, backward, update; the loss stays on
        the device."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(nodes, generator)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def _eval_step(self, graph: DeviceGraph, nodes: torch.Tensor):
        logits = self._forward(graph, nodes, False)
        return accuracy(logits, graph.node_labels[nodes.long()])

    def evaluate(self, nodes, batch_size: int) -> float:
        """Accuracy over ``nodes`` in batches (the last one padded by
        wrapping, as the reference does); one host sync at the end."""
        g = self.eval_graph if self.eval_graph is not None else self.graph
        it = AnchorBatchIterator(np.asarray(nodes), batch_size,
                                 drop_remainder=False)
        with torch.inference_mode():
            parts = [self._eval_step(g, self._ids(b)) for b in it.epoch(0)]
            if not parts:
                return 0.0
            correct, total = (torch.stack(p).sum().cpu()
                              for p in zip(*parts))
        return float(correct) / max(float(total), 1.0)

    def fit(self, state: TrainState, train_nodes, val_nodes, *,
            batch_size: int, num_epochs: int = 10,
            early_stop_patience: int = 5, log_every: int = 50
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Epochs of shuffled train batches, a val evaluation after each,
        early stopping on val accuracy; the best weights are loaded back.
        Returns the best val accuracy."""
        it = AnchorBatchIterator(np.asarray(train_nodes), batch_size,
                                 seed=self.cfg.seed)
        stopper = EarlyStopper(patience=early_stop_patience)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        step = 0
        for epoch in range(num_epochs):
            for nodes in it.epoch(epoch):
                state, loss = self.train_step(state, nodes, generator)
                step += 1
                if log_every and step % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f", epoch, step,
                                float(loss))
            acc = self.evaluate(val_nodes, batch_size)
            logger.info("epoch %d val acc %.4f", epoch, acc)
            snap = {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}
            if stopper.update(acc, snap):
                break
        if stopper.best_state is not None:
            self.model.load_state_dict(stopper.best_state)
        return state, {"accuracy": stopper.best_value or 0.0}
