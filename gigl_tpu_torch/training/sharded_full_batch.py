"""Graph-sharded full-batch training: a whole-graph GNN over a mesh of
shards (port of ``gigl_tpu/training/sharded_full_batch.py``:
``ShardedFullBatchConfig``, ``_gcn_norm`` and ``ShardedFullBatchTrainer``).

Node rows (features, activations, labels, split masks) are RANGE-sharded
over the P shards of a :class:`~gigl_tpu_torch.parallel.mesh.Mesh`: the
node state is one ``[P * per, D]`` tensor whose shard s is the row view
``[s * per, (s + 1) * per)``. Every neighbor aggregation is a ring SpMM
(``parallel/halo.py``, K18); the dense layers run once over all rows, as
XLA runs them on every shard, and with one parameter set autograd sums the
parameter gradient over the shards, as the reference's all-reduce of its
replicated parameters does. Padded rows carry zero features, label 0,
False in every mask and 0 in the GCN self factor.

Layer math (the reference's COO semantics):
  - "gcn": h' = (sum_e w_e h_src + h / (deg_in + 1)) W + b with
    w_e = 1 / sqrt((deg_in(dst) + 1)(deg_out(src) + 1)), folded into the
    ring schedule's edge weights once;
  - "graphsage": h' = mean_{in-nbr}(h) W_nbr + h W_self + b.
ReLU between layers; the masked cross entropy over the train split divided
by its count; the optimizer from ``make_optimizer``. Parameters are the
reference's ``[in, out]`` matrices (used as ``h @ w``), held by the trainer
(``self.model``: ``layers.{i}.w`` / ``w_self`` / ``w_nbr`` / ``b``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gigl_tpu_torch.losses.losses import cross_entropy_loss
from gigl_tpu_torch.losses.metrics import accuracy
from gigl_tpu_torch.parallel.halo import (
    build_ring_schedule,
    put_ring_schedule,
    ring_spmm,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.early_stop import EarlyStopper
from gigl_tpu_torch.training.trainer import (
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
)

logger = logging.getLogger(__name__)


@dataclass
class ShardedFullBatchConfig:
    hid_dim: int = 64
    out_dim: int = 7
    num_layers: int = 2
    conv: str = "gcn"  # "gcn" | "graphsage"
    num_epochs: int = 100
    eval_every: int = 10
    early_stop_patience: int = 10
    seed: int = 0


def _gcn_norm(edges: np.ndarray, num_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """GCN propagation weights with implicit self-loops: per edge
    1 / sqrt((deg_in(dst) + 1)(deg_out(src) + 1)) and per node the
    self-loop factor 1 / (deg_in + 1), from float64 degrees, as fp32."""
    deg_out = np.zeros(num_nodes, np.float64)
    deg_in = np.zeros(num_nodes, np.float64)
    np.add.at(deg_out, edges[0], 1.0)
    np.add.at(deg_in, edges[1], 1.0)
    w = 1.0 / np.sqrt((deg_in[edges[1]] + 1.0) * (deg_out[edges[0]] + 1.0))
    inv_self = 1.0 / (deg_in + 1.0)
    return w.astype(np.float32), inv_self.astype(np.float32)


class ShardedLayers(nn.Module):
    """The trainer's parameters: one ``nn.ParameterDict`` a layer, and the
    activation between layers (ReLU)."""

    def __init__(self, dims, conv: str):
        super().__init__()
        names = ("w",) if conv == "gcn" else ("w_self", "w_nbr")
        self.layers = nn.ModuleList(nn.ParameterDict(
            {**{k: nn.Parameter(torch.zeros(dims[i], dims[i + 1]))
                for k in names},
             "b": nn.Parameter(torch.zeros(dims[i + 1]))})
            for i in range(len(dims) - 1))
        self.activation = F.relu


class ShardedFullBatchTrainer:
    """Whole-graph node classification with node-sharded state. Inputs are
    host arrays; the trainer shards them over ``mesh`` (on its device:
    ``make_mesh(P)`` is CUDA unless given ``device="cpu"``)."""

    def __init__(
        self,
        edges: np.ndarray,          # [2, E] global node ids
        features: np.ndarray,       # [N, D]
        labels: np.ndarray,         # [N]
        train_mask: np.ndarray,     # [N] bool
        val_mask: np.ndarray,
        test_mask: np.ndarray,
        mesh: Mesh,
        config: Optional[ShardedFullBatchConfig] = None,
        optimizer_args: Optional[Dict[str, Any]] = None,
    ):
        self.cfg = config or ShardedFullBatchConfig()
        self.mesh = mesh
        self.device = mesh.device
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        if self.cfg.conv not in ("gcn", "graphsage"):
            raise ValueError(
                f"sharded full-batch supports gcn|graphsage, got "
                f"{self.cfg.conv!r} (attention convs are weight-dependent; "
                f"use FullBatchTrainer)")

        edges = np.asarray(edges)
        n = features.shape[0]
        self.num_nodes = n
        inv_self = None
        if self.cfg.conv == "gcn":
            w, inv_self = _gcn_norm(edges, n)
        else:
            w = None
        sched = build_ring_schedule(edges, n, mesh.num_shards, edge_weight=w)
        self._sched = put_ring_schedule(sched, mesh)
        self._reduce = "sum" if self.cfg.conv == "gcn" else "mean"
        self.n_pad = sched.padded_num_nodes

        def pad_rows(a, fill=0):
            pad = self.n_pad - a.shape[0]
            if pad == 0:
                return a
            width = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
            return np.pad(a, width, constant_values=fill)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.x = dev(pad_rows(np.asarray(features, np.float32)))
        self.labels = dev(pad_rows(np.asarray(labels, np.int32)))
        # Padded rows carry False in every mask: inert in loss and metrics.
        self.masks = {name: dev(pad_rows(np.asarray(m, bool)))
                      for name, m in (("train", train_mask),
                                      ("val", val_mask), ("test", test_mask))}
        self.inv_self = (dev(pad_rows(inv_self)) if inv_self is not None
                         else None)
        dims = ([self.x.shape[1]] + [self.cfg.hid_dim]
                * (self.cfg.num_layers - 1) + [self.cfg.out_dim])
        self.model = ShardedLayers(dims, self.cfg.conv).to(self.device)

    # -- model ------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Fresh weights: each matrix normal x 1 / sqrt(fan_in), drawn from
        a ``torch.Generator`` seeded with ``seed`` (not JAX's values), the
        biases zero. Loaded into ``self.model``; returns its state dict."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for layer in self.model.layers:
                for k, p in layer.items():
                    if k == "b":
                        p.zero_()
                    else:
                        p.copy_(torch.randn(p.shape, generator=gen)
                                / np.sqrt(p.shape[0]))
        return self.model.state_dict()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        layers = self.model.layers
        for i, layer in enumerate(layers):
            agg = ring_spmm(h, self._sched, self.mesh, reduce=self._reduce)
            if self.cfg.conv == "gcn":
                h = (agg + h * self.inv_self[:, None]) @ layer["w"] \
                    + layer["b"]
            else:
                h = agg @ layer["w_nbr"] + h @ layer["w_self"] + layer["b"]
            if i + 1 < len(layers):
                h = self.model.activation(h)
        return h

    # -- steps ------------------------------------------------------------
    def init_state(self, seed: int = 0,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from
        ``convert.sharded_params_from_jax``) or draw them from ``seed``,
        then build the optimizer."""
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        return TrainState(step=0, optimizer=opt)

    def loss(self) -> torch.Tensor:
        """Mean cross entropy over the train split."""
        s, c = cross_entropy_loss(self._forward(self.x), self.labels,
                                  mask=self.masks["train"])
        return s / torch.clamp(c.to(torch.float32), min=1.0)

    def train_step(self, state: TrainState
                   ) -> Tuple[TrainState, torch.Tensor]:
        """Forward, backward, update. Returns the new state and the loss as
        a 0-d device tensor (no host sync)."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss()
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(),
                                 self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach()

    def logits(self) -> torch.Tensor:
        """[N, out_dim] logits of the real rows."""
        with torch.no_grad():
            return self._forward(self.x)[: self.num_nodes]

    def accuracy(self, split: str = "val") -> float:
        with torch.no_grad():
            c, n = accuracy(self._forward(self.x), self.labels,
                            mask=self.masks[split])
        return float(c) / max(float(n), 1.0)

    def fit(self, state: Optional[TrainState] = None
            ) -> Tuple[TrainState, Dict[str, float]]:
        """``num_epochs`` steps with a val evaluation every ``eval_every``
        and early stopping on val accuracy; the best weights are loaded
        back. Returns the val and test accuracy of those weights."""
        if state is None:
            state = self.init_state(self.cfg.seed)
        stopper = EarlyStopper(patience=self.cfg.early_stop_patience)
        for epoch in range(self.cfg.num_epochs):
            state, loss = self.train_step(state)
            if (epoch + 1) % self.cfg.eval_every == 0:
                acc = self.accuracy("val")
                logger.info("epoch %d loss %.4f val acc %.4f", epoch + 1,
                            float(loss), acc)
                snap = {k: v.detach().clone()
                        for k, v in self.model.state_dict().items()}
                if stopper.update(acc, snap):
                    break
        if stopper.best_state is not None:
            self.model.load_state_dict(stopper.best_state)
        return state, {"accuracy": self.accuracy("val"),
                       "test_accuracy": self.accuracy("test")}
