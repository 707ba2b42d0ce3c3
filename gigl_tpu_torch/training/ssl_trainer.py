"""Self-supervised GNN training over sampled neighbourhoods (port of
``gigl_tpu/training/ssl_trainer.py``: ``SSLTrainState``,
``SSLTrainerConfig`` and ``SSLTrainer`` for the seven heads of
``models/ssl_tasks.py``).

A step draws a node batch's fanout tree (K1) with the config's seed and
no step, hydrates it (K3), and encodes augmented views of it
(``models/augmentations.py``: column keeps and slot keeps from an
explicit ``torch.Generator``) in eval mode, as the reference's encoder is
applied (so dropout is off and batch norm reads its running statistics);
GraphSAGE aggregates with K4, backward K4b. The reference's draws are
kept as they are: its views re-sample the same tree, so every view of a
step, the target views and every step see one neighbourhood, drawn once a
step here; BGRL / TBGRL encode the target views with the EMA copy of the
encoder in the state from the same view draws as the online views;
DirectAU's positive comes from ``sample_nalp_batch(..., step=step)`` (K1
and K1b) and is encoded without augmentation; TBGRL's negative view
permutes the roots' features. After the optimizer's update the EMA target
moves by ``ema_update``.

``draw_views`` makes a step's draws and ``loss(nodes, views, step,
target)`` the loss from them, so a caller (a test) can hand the same
masks and permutation to the reference.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.models.augmentations import ViewDraw, apply_view, draw_view
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.ssl_tasks import (
    BGRLTask,
    DirectAUTask,
    FeatureReconstructionTask,
    GBTTask,
    GraceTask,
    TBGRLTask,
    WhiteningDecorrelationTask,
    ema_update,
)
from gigl_tpu_torch.training.dataset import AnchorBatchIterator, DeviceGraph
from gigl_tpu_torch.training.trainer import clip_by_global_norm_, make_optimizer

logger = logging.getLogger(__name__)

SSL_TASKS = ("grace", "gbt", "whitening", "feature_recon", "bgrl", "tbgrl",
             "directau")
# the views each task draws a step: two augmented ones, and TBGRL's
# corrupted negative
_VIEWS = {"feature_recon": ("v1",), "directau": ("v1",),
          "tbgrl": ("v1", "v2", "neg")}


class SSLTrainState(NamedTuple):
    step: int                          # host int; keys DirectAU's batch
    optimizer: torch.optim.Optimizer   # over the encoder and the head
    target: Optional[nn.Module] = None  # EMA encoder copy (bgrl / tbgrl)


@dataclass
class SSLTrainerConfig:
    task: str = "grace"
    fanouts: Tuple[int, ...] = (10, 5)
    feature_drop_rate: float = 0.2
    edge_drop_rate: float = 0.2
    ema_decay: float = 0.99
    num_positives: int = 1  # directau draws supervision positives
    seed: int = 0


class SSLModel(nn.Module):
    """The trained modules, under the reference's names: ``encoder`` and
    ``head`` (so ``params_from_flax`` of the reference's ``{"encoder":
    ..., "head": ...}`` loads into it)."""

    def __init__(self, encoder: nn.Module, head: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.head = head


class SSLTrainer:
    """Trains a GNNEncoder with a self-supervised objective; runs on CUDA
    unless ``device`` says otherwise."""

    def __init__(self, encoder: nn.Module, graph: DeviceGraph,
                 config: SSLTrainerConfig,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        if config.task not in SSL_TASKS:
            raise ValueError(
                f"Unknown SSL task {config.task!r}; known: {SSL_TASKS}")
        self.device = resolve_device(device)
        if graph.device != self.device:
            raise ValueError(f"graph lives on {graph.device}, trainer "
                             f"asked for {self.device}")
        self.graph = graph
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        self.model = SSLModel(encoder, self._make_head(encoder.out_dim)).to(
            self.device).eval()

    @property
    def encoder(self) -> nn.Module:
        return self.model.encoder

    @property
    def head(self) -> nn.Module:
        return self.model.head

    def _make_head(self, dim: int) -> nn.Module:
        return {
            "grace": lambda: GraceTask(dim),
            "gbt": lambda: GBTTask(),
            "whitening": lambda: WhiteningDecorrelationTask(dim),
            "feature_recon": lambda: FeatureReconstructionTask(
                dim, self.graph.node_features.shape[-1]),
            "bgrl": lambda: BGRLTask(dim),
            "tbgrl": lambda: TBGRLTask(dim),
            "directau": lambda: DirectAUTask(),
        }[self.cfg.task]()

    # -- state -----------------------------------------------------------------
    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> SSLTrainState:
        """Load ``params`` (the state dict of ``self.model``, e.g. from
        ``params_from_flax``) or initialize the weights from ``seed``; build
        the optimizer over the encoder and the head, and for BGRL / TBGRL
        the target: a copy of the encoder without gradients."""
        del batch_size
        if params is None:
            init_params(self.model, seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        target = None
        if self.cfg.task in ("bgrl", "tbgrl"):
            target = copy.deepcopy(self.encoder).requires_grad_(False)
        return SSLTrainState(step=0, optimizer=opt, target=target)

    def _ids(self, node_ids) -> torch.Tensor:
        return torch.as_tensor(node_ids, dtype=torch.int32,
                               device=self.device)

    # -- encoding --------------------------------------------------------------
    def _tree(self, nodes: torch.Tensor):
        """The batch's fanout tree, drawn with the config's seed (no
        step), hydrated: (feats, masks, degrees)."""
        blocks = self.graph.sample_hop_blocks(nodes, self.cfg.fanouts,
                                              seed=self.cfg.seed)
        return self.graph.hydrate(blocks)

    @staticmethod
    def _encode(encoder, feats, masks, degs) -> torch.Tensor:
        return encoder(feats, masks, None, train=False, hop_degrees=degs)

    def encode_batch(self, nodes) -> torch.Tensor:
        """Inference embeddings of a batch of node ids."""
        with torch.inference_mode():
            return self._encode(self.encoder, *self._tree(self._ids(nodes)))

    # -- draws and loss --------------------------------------------------------
    def draw_views(self, batch_size: int, generator: torch.Generator
                   ) -> Dict[str, ViewDraw]:
        """The step's view draws for ``batch_size`` roots: ``v1``, and per
        task ``v2`` and TBGRL's corrupted ``neg``."""
        shapes = [(batch_size,) + tuple(self.cfg.fanouts[:d])
                  for d in range(len(self.cfg.fanouts) + 1)]
        d = self.graph.node_features.shape[-1]
        # shapes only: one element each, expanded
        one = torch.empty((), device=self.device)
        feats = [one.expand(s + (d,)) for s in shapes]
        masks = [one.bool().expand(s) for s in shapes]
        return {name: draw_view(generator, feats, masks,
                                feature_drop_rate=self.cfg.feature_drop_rate,
                                edge_drop_rate=self.cfg.edge_drop_rate,
                                corrupt=name == "neg")
                for name in _VIEWS.get(self.cfg.task, ("v1", "v2"))}

    def loss(self, nodes, views: Mapping[str, ViewDraw], step: int,
             target: Optional[nn.Module] = None) -> torch.Tensor:
        """The task's loss for ``nodes`` from the step's view draws
        (differentiable in the encoder's and the head's weights)."""
        nodes = self._ids(nodes)
        task, enc = self.cfg.task, self.encoder
        feats, masks, degs = self._tree(nodes)

        def view(encoder, name):
            f, m = apply_view(feats, masks, views[name])
            return self._encode(encoder, f, m, degs)

        z1 = view(enc, "v1")
        if task == "feature_recon":
            return self.head(z1, self.graph.node_features[nodes.long()])
        if task == "directau":
            batch = self.graph.sample_nalp_batch(
                nodes, num_positives=1, num_random_negs=1,
                seed=self.cfg.seed, step=step)
            zp = self._encode(enc, *self._tree(batch.pos[:, 0]))
            return self.head(z1, zp)
        z2 = view(enc, "v2")
        if task in ("grace", "gbt", "whitening"):
            return self.head(z1, z2)
        with torch.no_grad():
            t1, t2 = view(target, "v1"), view(target, "v2")
            neg = view(target, "neg") if task == "tbgrl" else None
        if task == "bgrl":
            return self.head(z1, z2, t1, t2)
        return self.head(z1, z2, t1, t2, neg)

    # -- steps -----------------------------------------------------------------
    def train_step(self, state: SSLTrainState, nodes,
                   generator: Optional[torch.Generator] = None,
                   views: Optional[Mapping[str, ViewDraw]] = None
                   ) -> Tuple[SSLTrainState, torch.Tensor]:
        """One step: the views drawn from ``generator`` (or ``views`` as
        given), forward, backward, update, and the EMA target moved.
        Returns the new state and the loss as a 0-d device tensor."""
        nodes = self._ids(nodes)
        if views is None:
            if generator is None:
                raise ValueError("an SSL step draws its views from a "
                                 "torch.Generator")
            views = self.draw_views(nodes.shape[0], generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(nodes, views, state.step, state.target)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        if state.target is not None:
            ema_update(state.target, self.encoder, self.cfg.ema_decay)
        return state._replace(step=state.step + 1), loss.detach()

    def fit(self, state: SSLTrainState, nodes, *, batch_size: int,
            num_epochs: int = 1, log_every: int = 50
            ) -> Tuple[SSLTrainState, float]:
        """Epochs of shuffled node batches; returns the state and the last
        loss."""
        it = AnchorBatchIterator(np.asarray(nodes), batch_size,
                                 seed=self.cfg.seed)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        loss, step = None, 0
        for epoch in range(num_epochs):
            for batch in it.epoch(epoch):
                state, loss = self.train_step(state, batch, generator)
                step += 1
                if log_every and step % log_every == 0:
                    logger.info("ssl[%s] epoch %d step %d loss %.4f",
                                self.cfg.task, epoch, step, float(loss))
        return state, 0.0 if loss is None else float(loss)

