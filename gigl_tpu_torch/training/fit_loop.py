"""The NALP fit loop: validation cadence and early stopping (port of
``gigl_tpu/training/fit_loop.py`` ``nalp_fit_loop``, replicated and
partitioned, and of the typed trainer's loop,
``gigl_tpu/training/hetero_trainer.py`` :283-330).

Steps run in chunks through ``trainer.train_steps``. The homogeneous
cadence cuts each epoch into chunks of ``val_every_n_batches`` and
evaluates after each full chunk; the typed trainer's (``global_cadence``)
evaluates at every ``val_every_n_batches``-th step counted over all
epochs. An evaluation takes ``num_val_batches`` val batches, and early
stopping on val MRR keeps a clone of the best weights, loaded back into
the model at the end. ``refresh(epoch)``, when given, re-freezes the
tabularized tables each epoch after the first. ``num_shards`` > 1 (the
partitioned trainer) needs a batch size that the shards divide and pads
the val pool by wrapping to a multiple of the shard count;
``fixed_val_batch_size`` (a trainer whose steps take one batch size, the
streamed-partitioned tier) wrap-pads the train pool to a full batch and
pins the val batches to that size. Checkpointing is not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.training.dataset import AnchorBatchIterator
from gigl_tpu_torch.training.early_stop import EarlyStopper

logger = logging.getLogger(__name__)


def _take(gen, n):
    for i, x in enumerate(gen):
        if i >= n:
            return
        yield x


def nalp_fit_loop(
    trainer,
    state,
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
    refresh: Optional[Callable[[int], None]] = None,
    global_cadence: bool = False,
    num_shards: int = 1,
    fixed_val_batch_size: Optional[int] = None,
) -> Tuple[object, Dict[str, float]]:
    """Train ``trainer`` from ``state``; returns (state, final val
    metrics) with the best weights (by val MRR) in the model."""
    if num_shards > 1 and batch_size % num_shards:
        raise ValueError(f"batch_size {batch_size} must divide the "
                         f"{num_shards}-shard mesh axis")
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir: training/checkpoint.py is not ported yet "
            "(ROADMAP A11)")
    cfg = trainer.cfg
    val_pool = np.asarray(val_anchors)
    if fixed_val_batch_size is not None:
        train_anchors = np.resize(np.asarray(train_anchors),
                                  max(len(train_anchors), batch_size))
    it = AnchorBatchIterator(train_anchors, batch_size, seed=cfg.seed)
    if fixed_val_batch_size is not None:
        val_bs = int(fixed_val_batch_size)
        val_pool = np.resize(val_pool, max(len(val_pool), val_bs))
    elif num_shards > 1:
        val_bs = max(num_shards, min(batch_size, len(val_pool))
                     // num_shards * num_shards)
        val_pool = np.resize(val_pool, max(len(val_pool), val_bs))
    else:
        val_bs = max(1, min(batch_size, len(val_pool)))
    val_it = AnchorBatchIterator(val_pool, val_bs, seed=cfg.seed + 1)
    stopper = EarlyStopper(patience=early_stop_patience)
    generator = torch.Generator(device=trainer.device).manual_seed(cfg.seed)
    global_step = 0
    t0 = time.time()
    stop = False
    for epoch in range(num_epochs):
        if epoch > 0 and refresh is not None:
            # Resample the frozen tabularized tables — the analog of
            # re-running the reference's Subgraph Sampler.
            refresh(epoch)
        batches = np.stack(list(it.epoch(epoch)))
        start = 0
        while start < len(batches):
            n = val_every_n_batches - (
                global_step % val_every_n_batches if global_cadence else 0)
            chunk = batches[start: start + n]
            start += len(chunk)
            state, losses = trainer.train_steps(state, chunk, generator)
            global_step += len(chunk)
            if log_every:
                logger.info(
                    "epoch %d step %d loss %.4f (%.1f steps/s)",
                    epoch, global_step, float(losses[-1]),
                    len(chunk) / max(time.time() - t0, 1e-9))
                t0 = time.time()
            if scalar_logger is not None:
                scalar_logger.log(global_step, loss=float(losses[-1]))
            if (global_step % val_every_n_batches == 0 if global_cadence
                    else len(chunk) == val_every_n_batches):
                metrics = trainer.evaluate(
                    list(_take(val_it.epoch(global_step), num_val_batches)),
                    step=global_step)
                logger.info("eval @%d: %s", global_step, metrics)
                if scalar_logger is not None:
                    scalar_logger.log(global_step, **metrics)
                snap = {k: v.detach().clone()
                        for k, v in trainer.model.state_dict().items()}
                if stopper.update(metrics["mrr"], snap):
                    logger.info("early stop at step %d (best mrr %.4f)",
                                global_step, stopper.best_value)
                    stop = True
                    break
        if stop:
            break
    if stopper.best_state is not None:
        trainer.model.load_state_dict(stopper.best_state)
    final = trainer.evaluate(
        list(_take(val_it.epoch(10 ** 6), num_val_batches)))
    return state, final
