"""Full-batch (whole-graph) node classification (port of
``gigl_tpu/training/full_batch.py``: ``FullBatchData``,
``full_batch_data_from_graph``, ``FullBatchTrainerConfig``,
``FullBatchTrainer``).

One step encodes the whole graph through the ELL tables
(``GNNEncoder.encode_ell``: K3 permute-gathers, K6 or K7 per bucket) or,
built with ``build_ell=False``, over the COO edges (``encode_coo``: the
segment kernels K8-K10 walking the two ``SegmentIndex``es that
``full_batch_data_from_graph`` builds once), takes the masked cross
entropy over the train split divided by its count, runs the backward (ELL:
K3 through the inverse permutations, K6b over the transpose tables, K7b
for the attention convs; COO: K8b, K9b, K10b with K8 and K10) and the
optimizer from ``make_optimizer``. The graph tensors live on the device
once; a step does no host synchronisation. Split masks come from the hash
split of ``graph/splitters.py``, bit-equal to the reference's.

Edge features (``FullBatchData.edge_attr`` [E, De] in COO edge order, set
by the caller as in the reference) feed both paths: the edge convs read
them through the ELL tables' edge slots (K6 / K7), or over the COO graph
relabelled in its destination walk order (``encode_coo``; the trainer
builds that walk once, on the host, beside the indexes), and train them
through K11.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.graph.splitters import HashedNodeAnchorLinkSplitter
from gigl_tpu_torch.losses.losses import cross_entropy_loss
from gigl_tpu_torch.losses.metrics import accuracy
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.ops.ell import EllGraph
from gigl_tpu_torch.ops.segment import SegmentIndex, coo_walk
from gigl_tpu_torch.training.base import refuse_batch_norm_training
from gigl_tpu_torch.training.early_stop import EarlyStopper
from gigl_tpu_torch.training.trainer import (
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
)

logger = logging.getLogger(__name__)

@dataclass
class FullBatchData:
    """Whole-graph device tensors: features, the COO edge list, labels,
    the three split masks and the tables the trainer aggregates through:
    the ELL tables (by default) or, without them, the SegmentIndexes of
    ``dst`` (``index``) and ``src`` (``src_index``)."""

    x: torch.Tensor            # [N, D] f32
    src: torch.Tensor          # [E] int32
    dst: torch.Tensor          # [E] int32
    labels: torch.Tensor       # [N] int32
    train_mask: torch.Tensor   # [N] bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    edge_attr: Optional[torch.Tensor] = None
    ell: Optional[EllGraph] = None
    index: Optional[SegmentIndex] = None
    src_index: Optional[SegmentIndex] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device


def full_batch_data_from_graph(
    graph: HeteroGraph,
    *,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    seed: int = 0,
    build_ell: bool = True,
    device: DeviceLike = None,
) -> FullBatchData:
    """Device tensors and the deterministic hash-split masks of a
    homogeneous graph with labels, on ``device`` (CUDA unless given), with
    the ELL tables or (``build_ell=False``) the two SegmentIndexes, built
    on the host once. ``seed`` is kept for the reference's signature: the
    hash split does not draw."""
    del seed
    device = resolve_device(device)
    nt = graph.metadata.node_types[0]
    et = graph.metadata.edge_types[0]
    coo = graph.edges[et]
    n = graph.num_nodes[nt]
    labels = graph.node_labels[nt]
    ids = np.arange(n)
    splitter = HashedNodeAnchorLinkSplitter(
        sampling_direction="in", num_val=val_ratio,
        num_test=max(1.0 - train_ratio - val_ratio, 0.0))
    masks = []
    for sel in splitter(np.stack([ids, ids])):
        m = np.zeros(n, bool)
        m[sel] = True
        masks.append(torch.as_tensor(m).to(device))
    feats = (graph.node_features[nt] if nt in graph.node_features
             else np.zeros((n, 1), np.float32))

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32)).to(device)

    src, dst = i32(coo[0]), i32(coo[1])
    coo_tables = {}
    if not build_ell:   # each index composes the other side in walk order
        coo_tables = {"index": SegmentIndex.from_ids(coo[1], n, device,
                                                     gather=src),
                      "src_index": SegmentIndex.from_ids(coo[0], n, device,
                                                         gather=dst)}
        src, dst = (coo_tables[k].gather for k in ("index", "src_index"))
    return FullBatchData(
        x=torch.as_tensor(np.asarray(feats, np.float32)).to(device),
        src=src, dst=dst, labels=i32(labels),
        train_mask=masks[0], val_mask=masks[1], test_mask=masks[2],
        ell=(EllGraph.from_csr(graph.csr(et, anchor="dst"), device=device)
             if build_ell else None), **coo_tables)


@dataclass
class FullBatchTrainerConfig:
    num_epochs: int = 100
    eval_every: int = 10
    early_stop_patience: int = 10
    seed: int = 0


class FullBatchTrainer:
    """Whole-graph supervised node classification over the ELL tables, or
    over the COO segment ops when the data has none (``encode_coo``)."""

    def __init__(self, encoder: nn.Module, data: FullBatchData,
                 config: Optional[FullBatchTrainerConfig] = None,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if data.device != self.device:
            raise ValueError(f"data lives on {data.device}, trainer asked "
                             f"for {self.device}")
        self.encoder = encoder.to(self.device)
        if (data.edge_attr is not None and data.ell is None
                and data.index is not None
                and getattr(encoder, "reads_edges", lambda: False)()):
            coo_walk(data.index, data.src)   # built once, kept on the index
        self.data = data
        self.cfg = config or FullBatchTrainerConfig()
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0

    def init_state(self, seed: int = 0,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from ``params_from_flax``)
        or initialize the weights as flax does from ``seed``, then build
        the optimizer."""
        if params is None:
            init_params(self.encoder, seed)
        else:
            self.encoder.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.encoder.parameters())
        return TrainState(step=0, optimizer=opt)

    def logits(self, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[N, classes] in original node order: ``encode_ell`` over the ELL
        tables (with the data's edge features), else ``encode_coo``
        (``full_batch.py:124-142``)."""
        d = self.data
        if d.ell is not None:
            return self.encoder.encode_ell(d.x, d.ell, d.edge_attr,
                                           train=train, generator=generator)
        return self.encoder.encode_coo(d.x, d.src, d.dst, d.num_nodes,
                                       d.edge_attr, train=train,
                                       generator=generator, index=d.index,
                                       src_index=d.src_index)

    def loss(self, generator: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Train-mode mean cross entropy over the train split."""
        refuse_batch_norm_training(self.encoder)
        s, c = cross_entropy_loss(self.logits(True, generator),
                                  self.data.labels,
                                  mask=self.data.train_mask)
        return s / torch.clamp(c.to(torch.float32), min=1.0)

    def train_step(self, state: TrainState,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One epoch-step: forward, backward, update. Returns the new state
        and the loss as a 0-d device tensor (no host sync)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(generator)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.encoder.parameters(),
                                 self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def accuracy(self, split: str = "val") -> float:
        """Eval-mode accuracy of the encoder's current weights on
        ``split`` (train | val | test)."""
        mask = {"train": self.data.train_mask, "val": self.data.val_mask,
                "test": self.data.test_mask}[split]
        with torch.inference_mode():
            c, n = accuracy(self.logits(False), self.data.labels, mask=mask)
        return float(c) / max(float(n), 1.0)

    def fit(self, state: Optional[TrainState] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """``num_epochs`` steps with a val evaluation every ``eval_every``
        and early stopping on val accuracy; the best weights are loaded
        back. Returns the val and test accuracy of those weights."""
        if state is None:
            state = self.init_state(self.cfg.seed)
        stopper = EarlyStopper(patience=self.cfg.early_stop_patience)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        for epoch in range(self.cfg.num_epochs):
            state, loss = self.train_step(state, generator)
            if (epoch + 1) % self.cfg.eval_every == 0:
                acc = self.accuracy("val")
                logger.info("epoch %d loss %.4f val acc %.4f", epoch + 1,
                            float(loss), acc)
                snap = {k: v.detach().clone()
                        for k, v in self.encoder.state_dict().items()}
                if stopper.update(acc, snap):
                    break
        if stopper.best_state is not None:
            self.encoder.load_state_dict(stopper.best_state)
        return state, {"accuracy": self.accuracy("val"),
                       "test_accuracy": self.accuracy("test")}
