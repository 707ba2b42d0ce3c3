"""Early stopping on a validation metric (port of
``gigl_tpu/training/early_stop.py``): patience-based, tracks the best value
(greater or less is better) and holds a snapshot of the best state."""

from __future__ import annotations

from typing import Any, Optional


class EarlyStopper:
    def __init__(self, patience: int = 5, greater_is_better: bool = True,
                 min_delta: float = 0.0):
        self.patience = patience
        self.greater_is_better = greater_is_better
        self.min_delta = min_delta
        self.best_value: Optional[float] = None
        self.best_state: Any = None
        self.num_bad_evals = 0

    def update(self, value: float, state: Any = None) -> bool:
        """Record an eval result; returns True if training should stop."""
        improved = (
            self.best_value is None
            or (self.greater_is_better and value > self.best_value + self.min_delta)
            or (not self.greater_is_better and value < self.best_value - self.min_delta)
        )
        if improved:
            self.best_value = value
            self.best_state = state
            self.num_bad_evals = 0
            return False
        self.num_bad_evals += 1
        return self.num_bad_evals >= self.patience
