"""User-facing inference plugin interface (port of ``BaseInferencer`` in
``gigl_tpu/training/base.py``) and the train steps' refusal of batch
norm."""

from __future__ import annotations

import abc
from typing import Any

from torch import nn

from gigl_tpu_torch.models.layers import BatchNorm


class BaseInferencer(abc.ABC):
    """Inference plugin: produces embeddings for one batch of node ids."""

    @abc.abstractmethod
    def infer_batch(self, batch: Any) -> Any:
        """Produce embeddings and/or predictions for one batch."""


def refuse_batch_norm_training(model: nn.Module) -> None:
    """Raise for a model with batch norm before a train step. The
    reference's trainers apply the model in train mode without
    ``mutable=["batch_stats"]``, so a batch-norm encoder raises there
    (flax's ``ModifyScopeVariableError``); the port's train steps refuse it
    the same way, and carry no statistics of their own. Evaluation and
    inference run batch norm from its running statistics."""
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        raise ValueError(
            "a train step cannot run a batch-norm encoder: the reference's "
            "train step applies the model without mutable batch_stats and "
            "raises there too; train batch norm on the module directly "
            "(encoder(..., train=True)) or build the encoder without it")
