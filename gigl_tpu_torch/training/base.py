"""User-facing inference plugin interface (port of ``BaseInferencer`` in
``gigl_tpu/training/base.py``)."""

from __future__ import annotations

import abc
from typing import Any


class BaseInferencer(abc.ABC):
    """Inference plugin: produces embeddings for one batch of node ids."""

    @abc.abstractmethod
    def infer_batch(self, batch: Any) -> Any:
        """Produce embeddings and/or predictions for one batch."""
