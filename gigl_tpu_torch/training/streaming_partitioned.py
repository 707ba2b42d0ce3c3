"""The streamed-partitioned tier: each shard's feature rows in HOST memory,
routed device lookups (port of ``gigl_tpu/training/streaming_partitioned.py``:
``ShardedHostStore``, the plan / host / apply step driver and the NALP,
typed NALP and node-classification trainers).

The two tiers the port already has compose here: the partitioned one
(``training/dist_sampled.py``, ``training/dist_hetero.py``: a mesh of P
shards, every lookup routed to the shard that owns the row) and the
out-of-core one (``training/streaming.py``: features on the host, gathered
by the host engine ``gigl_tpu_torch/native``). Each shard's rows of the
fused ``[features | degree | hop-cache aggregate]`` table (``2D + 1`` fp32
columns; a plain per-type table on the typed path) live in host RAM
(:class:`ShardedHostStore`); the device holds only the O(N/P) integer
adjacency: the frozen sample tables and the supervision / hard-negative
CSR blocks with their label edges' rows. A training step is the
partitioned tabularized step cut at the feature hydration's routed gather:

  plan (device):  the batch draws (K1's row-offset mode, K16, K1b), the
                  joint tree expansion over the frozen tables (K3's expand
                  mode at P = 1, routed table gathers at P > 1: K15, K3,
                  K16), and the front half of the hydration lookup
                  (``send_requests``: K15 and the request all_to_all) — it
                  ends with every shard holding the ids it owns (``recv``
                  [P, C] a shard; routed at one shard too);
  host:           the owner-side row gather from each shard's host store
                  (the engine's threaded gather, fp32 rows or their bf16
                  bits written in the same pass) straight into a pinned
                  [P, P, C, W] answer slot;
  apply (device): the back half (``receive_answers``: the answer all_to_all
                  and K16), the encoders (K4 / K4b; typed: K7 / K7b, K4 /
                  K4b), the loss (K5, or the ring K17 with its own-block
                  bias mode; K13 / K14 for the sketch), the gradients and
                  the update.

The H100 design of the host round trip (the reference dispatches two jit
programs around a host callback):

- ``recv`` is copied to a pinned host buffer by a ``non_blocking`` copy on
  the compute stream, and a CUDA event is recorded after it; the host waits
  on that event only (no ``.cpu()``, ``.item()`` or device synchronise);
- the answers are written into a pinned slot and copied to the device on a
  side stream; the compute stream waits on the copy's event before apply;
- two slots ring: a slot's host buffers are refilled only after the event
  of their last copy, and its device buffers are copied into only after
  the event of the apply that read them;
- ``run_steps`` is software-pipelined: plan t+1 is enqueued before step t's
  host gather, so the device order is ``plan_0, plan_1, apply_0, plan_2,
  apply_1, ...`` and the card runs plan t+1 while the host gathers step
  t's answers. Overflow counts stay on the device and are read once a
  chunk, as are the losses. Plan t+1 reads nothing that apply t writes (the
  draws are keyed by the global step over frozen tables), so both
  schedules compute the same losses to the bit.

The draws are the device-resident partitioned trainers' in tabularized mode
(``PartitionedNALPTrainer(cached_hop=True)``, the typed trainer, the NC
trainer), whose pieces the trainers here reuse, so the losses are theirs.
One controller drives every shard, so every shard is local
(``ShardedHostStore.local_shards`` keeps the split for a backend of one
process per card). On the CPU (a mesh made for ``device="cpu"``) the host
buffers are the apply's inputs, with no pinning and no streams.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch import native
from gigl_tpu_torch.parallel.feature_lookup import (
    receive_answers,
    request_capacity,
    routed_gather,
    send_requests,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.base import refuse_batch_norm_training
from gigl_tpu_torch.training.dataset import AnchorBatchIterator
from gigl_tpu_torch.training.dist_hetero import PartitionedHeteroNALPTrainer
from gigl_tpu_torch.training.dist_sampled import (
    OVERFLOW_POLICIES,
    PartitionedNALPTrainer,
    PartitionedNodeClassificationTrainer,
    _per_shard,
    _shard_csr,
    apply_overflow_policy,
)
from gigl_tpu_torch.training.early_stop import EarlyStopper
from gigl_tpu_torch.training.streaming import HostGraphStore
from gigl_tpu_torch.training.trainer import clip_by_global_norm_
from gigl_tpu_torch.utils.cast import stream_cast_from_str

logger = logging.getLogger(__name__)


class ShardedHostStore:
    """This process's rows of a row-sharded host table: the fused ``[feat |
    deg | agg]`` rows of the homogeneous tier, or a plain per-node-type
    table. ``local_shards`` are the global shard indices held (each shard
    ``rows_per_shard`` consecutive global rows, the last zero-padded)."""

    def __init__(self, fused_local: np.ndarray, rows_per_shard: int,
                 local_shards: Sequence[int]):
        self.table = np.ascontiguousarray(fused_local, np.float32)
        self.rows_per_shard = int(rows_per_shard)
        self.local_shards = tuple(int(s) for s in local_shards)
        self._lo = {s: i * self.rows_per_shard
                    for i, s in enumerate(self.local_shards)}

    @property
    def width(self) -> int:
        return self.table.shape[1]

    @staticmethod
    def _shards(num_shards: int, local_shards) -> Tuple[int, ...]:
        return tuple(range(num_shards) if local_shards is None
                     else (int(s) for s in local_shards))

    @classmethod
    def from_host_store(cls, store: HostGraphStore, *, num_shards: int,
                        local_shards: Optional[Sequence[int]] = None
                        ) -> "ShardedHostStore":
        """The fused ``[features | degree | hop-cache aggregate]`` rows (``2D
        + 1`` fp32 columns) of ``local_shards`` (default: all)."""
        n = store.num_nodes
        rows = -(-n // num_shards)
        local = cls._shards(num_shards, local_shards)
        d = store.features.shape[1]
        fused = np.zeros((len(local) * rows, 2 * d + 1), np.float32)
        for i, s in enumerate(local):
            lo, hi = s * rows, min((s + 1) * rows, n)
            if hi <= lo:
                continue
            blk = fused[i * rows: i * rows + (hi - lo)]
            ids = np.arange(lo, hi)
            blk[:, :d] = store.features.gather(ids)
            blk[:, d] = store.degrees[lo:hi]
            blk[:, d + 1:] = store.agg.gather(ids)
        return cls(fused, rows, local)

    @classmethod
    def from_array(cls, arr: np.ndarray, *, num_shards: int,
                   local_shards: Optional[Sequence[int]] = None
                   ) -> "ShardedHostStore":
        """A plain [N, W] table (no fusion): a node type's features on the
        typed tier."""
        arr = np.asarray(arr, np.float32)
        n, w = arr.shape
        rows = -(-n // num_shards)
        local = cls._shards(num_shards, local_shards)
        fused = np.zeros((len(local) * rows, w), np.float32)
        for i, s in enumerate(local):
            lo, hi = s * rows, min((s + 1) * rows, n)
            if hi > lo:
                fused[i * rows: i * rows + (hi - lo)] = arr[lo:hi]
        return cls(fused, rows, local)

    def _local(self, shard: int, global_ids: np.ndarray) -> np.ndarray:
        """Local rows of ``global_ids`` (all owned by ``shard``; a padding
        slot's id 0 may fall outside and is clipped into the shard's range —
        its answer is never read back)."""
        local = (np.asarray(global_ids, np.int64)
                 - shard * self.rows_per_shard)
        return np.clip(local, 0, self.rows_per_shard - 1) + self._lo[shard]

    def answer_shard(self, shard: int, global_ids: np.ndarray) -> np.ndarray:
        """The owner-side gather of one of the held shards: fp32 rows
        ``global_ids.shape + (W,)``."""
        return native.gather_f32(self.table, self._local(shard, global_ids))

    def answer_into(self, shard: int, global_ids: np.ndarray,
                    out: np.ndarray, bf16: bool = False) -> np.ndarray:
        """:meth:`answer_shard` written into ``out`` (a C-contiguous
        ``global_ids.shape + (W,)`` buffer: a shard's [P, C, W] view of a
        pinned answer slot), fp32 or, with ``bf16``, the rows' bfloat16
        bits (``uint16``) cast in the gather's pass."""
        return native.gather_f32(self.table, self._local(shard, global_ids),
                                 out=out, bf16=bf16)


class _Slot:
    """One ring slot of the host round trip: pinned ``recv`` buffers and
    pinned answer buffers (one per routed table), the answers' device
    copies, and the events that order the slot's reuse (``recv_ready``:
    the plan's ``recv`` is on the host; ``copied``: the answers were read
    by their copy; ``used``: the apply that read the device answers is
    done)."""

    def __init__(self, recv_shapes, ans_shapes, ans_dtype: torch.dtype,
                 device: torch.device):
        cuda = device.type == "cuda"
        with torch.inference_mode(False):
            self.recv = [torch.empty(s, dtype=torch.int32, pin_memory=cuda)
                         for s in recv_shapes]
            self.ans = [torch.empty(s, dtype=ans_dtype, pin_memory=cuda)
                        for s in ans_shapes]
            self.ans_dev = ([torch.empty(s, dtype=ans_dtype, device=device)
                             for s in ans_shapes] if cuda else self.ans)
        self.ans_np = [a.numpy() for a in self.ans]
        self.nbytes = sum(a.numel() * a.element_size() for a in self.ans)
        self.recv_ready = torch.cuda.Event() if cuda else None
        self.copied = torch.cuda.Event() if cuda else None
        self.used = torch.cuda.Event() if cuda else None


@dataclasses.dataclass
class _Plan:
    """A dispatched plan: ``recvs`` one [P, P, C] device tensor per routed
    table, ``coords`` each shard's (owner, pos, ok) per table, ``ctx`` the
    trainer's draws and trees, and the slot its round trip uses."""

    recvs: List[torch.Tensor]
    coords: list
    ctx: Any
    slot: _Slot


class _StreamedStepDriver:
    """The plan / host / apply driver shared by the streamed-partitioned
    trainers: the sequential and pipelined schedules, the deferred overflow
    fold, evaluation, the wrap-padded encode and the NALP fit contract.

    A trainer provides ``mesh``, ``device``, ``num_shards``, ``batch_size``,
    ``cfg``, ``model``, ``_plan_device(anchors, step, encode)`` -> (recv
    [P, C] per shard per table, coords per table, ctx), ``_stores(encode)``
    (one host store per table), ``_apply_train(state, ctx, rows, dropped,
    generators)``, ``_apply_eval(ctx, rows, dropped)`` and
    ``_apply_encode(ctx, rows)``; ``rows[table][shard]`` are fp32 answer
    rows in request order. Steps take exactly ``batch_size`` anchors."""

    def _init_driver(self, answer_dtype: str) -> None:
        if answer_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"answer_dtype must be float32 | bfloat16, got "
                             f"{answer_dtype!r}")
        self._answer_torch, answer_np, _ = stream_cast_from_str(answer_dtype)
        self._bf16 = answer_np != np.float32
        self._rings: Dict[tuple, List[_Slot]] = {}
        self._turn: Dict[tuple, int] = {}
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        # set to "warn" / "error" to run every plan and apply dispatch under
        # torch.cuda.set_sync_debug_mode (finds implicit host syncs)
        self.sync_debug_mode: Optional[str] = None
        # per-step host and copy timings of the last run_steps(timing=True)
        self.last_run: Dict[str, Any] = {}
        self._timing: Optional[Dict[str, list]] = None

    # -- the three parts of a round -------------------------------------------
    @contextlib.contextmanager
    def _dispatch(self):
        if self.sync_debug_mode is None or self.device.type != "cuda":
            yield
            return
        torch.cuda.set_sync_debug_mode(self.sync_debug_mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def _batch_ids(self, anchors) -> torch.Tensor:
        """The batch's ids on the device; host ids go through a pinned
        buffer by a ``non_blocking`` copy (a pageable one would wait for
        the device: the pipelined schedule's overlap gone)."""
        if isinstance(anchors, torch.Tensor):
            ids = anchors.to(dtype=torch.int32).reshape(-1)
        else:
            ids = torch.from_numpy(np.ascontiguousarray(anchors, np.int32)
                                   .reshape(-1))
        if ids.shape[0] != self.batch_size:
            raise ValueError(f"anchors batch {ids.shape[0]} != the "
                             f"configured batch_size {self.batch_size}")
        if self.device.type == "cuda" and ids.device.type == "cpu":
            ids = ids.pin_memory()
        return ids.to(self.device, non_blocking=True)

    def _slot(self, recvs, encode: bool) -> _Slot:
        widths = [st.width for st in self._stores(encode)]
        recv_shapes = tuple(tuple(r.shape) for r in recvs)
        key = (recv_shapes, tuple(widths))
        ring = self._rings.get(key)
        if ring is None:
            ring = [_Slot(recv_shapes, [s + (w,) for s, w in zip(
                recv_shapes, widths)], torch.int16 if self._bf16
                else torch.float32, self.device) for _ in range(2)]
            self._rings[key] = ring
            self._turn[key] = 0
        self._turn[key] += 1
        return ring[self._turn[key] % 2]

    def _plan(self, anchors, step: int, encode: bool = False) -> _Plan:
        """Dispatch a plan (on the card: enqueue it, then the non_blocking
        copy of its ``recv`` into the slot and the slot's event)."""
        ids = self._batch_ids(anchors)
        with self._dispatch():
            recvs, coords, ctx = self._plan_device(ids, step, encode)
            recvs = [torch.stack(r) for r in recvs]
        slot = self._slot(recvs, encode)
        if slot.recv_ready is not None:
            for buf, r in zip(slot.recv, recvs):
                buf.copy_(r, non_blocking=True)
            slot.recv_ready.record()
        return _Plan(recvs, coords, ctx, slot)

    def _host(self, plan: _Plan, encode: bool = False) -> List[torch.Tensor]:
        """The host part: wait for the plan's ``recv`` (its event only),
        answer every shard's requests from the host stores into the slot,
        and enqueue the answers' copy on the side stream, the compute
        stream made to wait for it. Returns the device answers."""
        slot = plan.slot
        t0 = time.perf_counter()
        if slot.recv_ready is not None:
            slot.recv_ready.synchronize()
            slot.copied.synchronize()   # its last copy has read the answers
            recvs = [b.numpy() for b in slot.recv]
        else:
            recvs = [r.numpy() for r in plan.recvs]
        t1 = time.perf_counter()
        for i, store in enumerate(self._stores(encode)):
            for s in range(self.num_shards):
                out = slot.ans_np[i][s]
                store.answer_into(s, recvs[i][s], out.view(np.uint16)
                                  if self._bf16 else out, self._bf16)
        t2 = time.perf_counter()
        answers = slot.ans
        if slot.recv_ready is not None:
            timing = self._timing
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(slot.used)
                if timing is not None:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record(self._copy_stream)
                for h, d in zip(slot.ans, slot.ans_dev):
                    d.copy_(h, non_blocking=True)
                if timing is not None:
                    ev[1].record(self._copy_stream)
                    timing["copy_events"].append(ev)
                slot.copied.record(self._copy_stream)
            compute.wait_event(slot.copied)
            answers = slot.ans_dev
        if self._timing is not None:
            self._timing["wait_s"].append(t1 - t0)
            self._timing["gather_s"].append(t2 - t1)
            self._timing["answer_bytes"].append(slot.nbytes)
        return [a.view(self._answer_torch) if self._bf16 else a
                for a in answers]

    def _unroute(self, plan: _Plan, answers: Sequence[torch.Tensor]):
        """The back half of every table's lookup: (rows[table][shard] fp32
        in request order, the requests dropped by bucket overflow)."""
        rows, dropped = [], 0
        for ans, coords in zip(answers, plan.coords):
            rows.append([r.float() for r in receive_answers(
                self.mesh, list(ans), coords)])
            dropped = dropped + sum((~c[2]).sum(dtype=torch.int32)
                                    for c in coords)
        if plan.slot.used is not None:
            plan.slot.used.record()
        return rows, dropped

    def _apply_round(self, state, plan: _Plan, answers, generators):
        with self._dispatch():
            rows, dropped = self._unroute(plan, answers)
            return self._apply_train(state, plan.ctx, rows, dropped,
                                     generators)

    # -- schedules ------------------------------------------------------------
    def _generators(self, generators):
        if isinstance(generators, torch.Generator):
            return [generators] * self.num_shards
        return generators

    def train_step(self, state, anchors, generators=None, *,
                   step: Optional[int] = None):
        """One plan -> host gather -> apply round (the sequential schedule)
        for ``batch_size`` anchors; ``step`` (default ``state.step``) is the
        global step index that keys the draws. The dropped requests are
        read at once and handled per ``overflow_policy``. Returns the state
        and the loss (a 0-d device tensor)."""
        step = state.step if step is None else int(step)
        generators = self._generators(generators)
        plan = self._plan(anchors, step)
        state, loss, ovf = self._apply_round(state, plan, self._host(plan),
                                             generators)
        apply_overflow_policy(self, int(ovf))
        return state, loss

    def _rounds(self, batches, start: int, apply, pipeline: bool = True):
        """Every batch's round (batch i keyed by global step ``start + i``):
        its plan, its host part, then ``apply(plan, answers)``; pipelined,
        the next batch's plan is dispatched before this batch's host part.
        Returns the applies' results."""
        n = len(batches)
        plans: List[Optional[_Plan]] = [None] * n
        out = []
        for t in range(n):
            if plans[t] is None:
                plans[t] = self._plan(batches[t], start + t)
            if pipeline and t + 1 < n:
                plans[t + 1] = self._plan(batches[t + 1], start + t + 1)
            out.append(apply(plans[t], self._host(plans[t])))
            plans[t] = None
        return out

    def run_steps(self, state, anchor_batches, generators=None, *,
                  start_step: Optional[int] = None, timing: bool = False,
                  pipeline: bool = True):
        """``len(anchor_batches)`` steps, software-pipelined: plan t+1 is
        dispatched before step t's host gather (the module docstring;
        ``pipeline=False``: after apply t, the sequential order). The
        global step of batch i is ``start_step + i`` (default: from
        ``state.step``). Returns the state and the losses (numpy, one host
        read at the end, as is the overflow count). ``timing``: ``last_run``
        gets each step's wait for ``recv``, host gather seconds, answer
        bytes and copy ms (CUDA events on the copy stream)."""
        if not len(anchor_batches):
            return state, np.zeros((0,), np.float32)
        start = state.step if start_step is None else int(start_step)
        generators = self._generators(generators)

        def step(plan, answers):
            nonlocal state
            state, loss, ovf = self._apply_round(state, plan, answers,
                                                 generators)
            return loss, ovf

        self._timing = ({"wait_s": [], "gather_s": [], "answer_bytes": [],
                         "copy_events": []} if timing else None)
        try:
            losses, ovfs = zip(*self._rounds(anchor_batches, start, step,
                                             pipeline))
            total = int(torch.stack(ovfs).sum())
            out = torch.stack(losses).float().cpu().numpy()
            if timing:
                tm = self._timing
                self.last_run = {
                    "wait_s": tm["wait_s"], "gather_s": tm["gather_s"],
                    "answer_bytes": tm["answer_bytes"],
                    "copy_ms": [a.elapsed_time(b)
                                for a, b in tm["copy_events"]]}
        finally:
            self._timing = None
        apply_overflow_policy(self, total)
        return state, out

    def train_steps(self, state, anchors_kb, generators=None):
        """``run_steps`` over global [K, B] anchors from ``state.step`` (the
        chunked-steps contract of the shared fit loop)."""
        return self.run_steps(state, list(np.asarray(anchors_kb, np.int32)),
                              generators)

    def _eval_rounds(self, batches, step: int):
        """Pipelined eval rounds: every batch's device sums, stacked."""
        results = self._rounds(batches, step, lambda plan, answers: (
            self._apply_eval(plan.ctx, *self._unroute(plan, answers))))
        return [torch.stack(list(x)) for x in zip(*results)]

    def evaluate(self, anchor_batches, step: int = 0) -> Dict[str, float]:
        """MRR and hits@k over ``anchor_batches`` of ``batch_size`` each
        (batch i keyed by step + i), pipelined as ``run_steps``; one host
        read at the end."""
        with torch.inference_mode():
            results = self._eval_rounds(list(anchor_batches), step)
            if results:
                rr, hits, cnt, ovf = (x.sum(0).cpu() for x in results)
        if not results:
            rr, cnt, ovf = 0.0, 0.0, 0
            hits = np.zeros(len(self.cfg.eval_ks))
        apply_overflow_policy(self, int(ovf))
        cnt_total = max(float(cnt), 1.0)
        out = {"mrr": float(rr) / cnt_total}
        for i, k in enumerate(self.cfg.eval_ks):
            out[f"hits@{k}"] = float(hits[i]) / cnt_total
        return out

    def encode_batch(self, node_ids) -> torch.Tensor:
        """Inference embeddings of ``node_ids``: chunks of ``batch_size``
        wrap-padded, each an anchors-only plan (only the anchor tree's rows
        make the host round trip), the pad rows dropped."""
        ids = np.asarray(node_ids, np.int32).reshape(-1)
        if not len(ids):   # the output width: one padded chunk's, no rows
            return self.encode_batch(np.zeros(1, np.int32))[:0]
        chunks = []
        with torch.inference_mode():
            for s in range(0, len(ids), self.batch_size):
                chunk = ids[s: s + self.batch_size]
                plan = self._plan(np.resize(chunk, self.batch_size), 0,
                                  encode=True)
                rows, _ = self._unroute(plan, self._host(plan, encode=True))
                chunks.append(self._apply_encode(plan.ctx, rows)[:len(chunk)])
            return torch.cat(chunks)

    def fit(self, state, train_anchors: np.ndarray, val_anchors: np.ndarray,
            *, batch_size: Optional[int] = None, num_epochs: int = 1,
            val_every_n_batches: int = 100, num_val_batches: int = 8,
            early_stop_patience: int = 5, log_every: int = 50,
            scalar_logger=None, checkpoint_dir: Optional[str] = None):
        """The NALP train loop (``fit_loop.nalp_fit_loop``): train and val
        batches of exactly ``batch_size`` (the train pool wrap-padded to one
        batch at least, the val batches pinned to that size)."""
        from gigl_tpu_torch.training.fit_loop import nalp_fit_loop

        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"batch_size {batch_size} != the configured "
                             f"batch_size {self.batch_size}")
        return nalp_fit_loop(
            self, state, train_anchors, val_anchors,
            batch_size=self.batch_size, num_epochs=num_epochs,
            val_every_n_batches=val_every_n_batches,
            num_val_batches=num_val_batches,
            early_stop_patience=early_stop_patience, log_every=log_every,
            scalar_logger=scalar_logger, checkpoint_dir=checkpoint_dir,
            num_shards=self.num_shards,
            fixed_val_batch_size=self.batch_size)

    # -- what a step moves ----------------------------------------------------
    def answer_slot_rows(self, encode: bool = False) -> Tuple[int, int]:
        """(rows a training (or encode) step requests over all shards, rows
        of its [P, P, C, W] answer slots): the slot answers every request
        slot, padding included."""
        p = self.num_shards
        sizes = self._union_sizes(encode)
        caps = [self._capacity(u) for u in sizes]
        return p * sum(sizes), p * p * sum(caps)

    def _capacity(self, union: int) -> int:
        return request_capacity(union, self.num_shards, self.capacity_factor)


@dataclasses.dataclass
class _HostFedGraph:
    """What the reused ``PartitionedNALPTrainer`` pieces read of a
    partitioned graph whose feature rows stay on the host: the node count,
    the shard layout, the frozen sample tables (per shard, -1 in invalid
    slots) and the fused row's split."""

    num_nodes: int
    rows_per_shard: int
    feat_dim: int
    sample_tables: Tuple[List[torch.Tensor], ...]
    table_fanouts: Tuple[int, ...]

    @property
    def cache_dim(self) -> int:
        return self.feat_dim

    def split_rows(self, rows: torch.Tensor):
        d = self.feat_dim
        return rows[:, :d], rows[:, d], rows[:, d + 1:]


def _sharded_tables(store: HostGraphStore, fanouts: Sequence[int],
                    num_shards: int, rows: int, device: torch.device):
    """(the in-tree fanouts, the store's frozen sample tables per shard,
    padded to P * rows with -1)."""
    tab_ks = tuple(sorted({int(k) for k in fanouts[:-1]}))
    if any(k not in store.sample_tables for k in tab_ks):
        raise ValueError(
            f"store lacks sample tables for fanouts {tab_ks}; build or "
            f"refresh the HostGraphStore with fanouts={tuple(fanouts)}")
    tables = []
    for k in tab_ks:
        ids_t, mask_t = store.sample_tables[k]
        pad = np.full((num_shards * rows, k), -1, np.int32)
        pad[: ids_t.shape[0]] = np.where(mask_t, ids_t, -1)
        tables.append(_per_shard(pad.reshape(num_shards, rows, k), device))
    return tab_ks, tuple(tables)


class StreamingPartitionedNALPTrainer(_StreamedStepDriver,
                                      PartitionedNALPTrainer):
    """NALP trainer over a :class:`HostGraphStore` and a :class:`Mesh`:
    every shard's fused rows in a :class:`ShardedHostStore`, the adjacency
    on the device, each step a plan / host / apply round. The API of
    ``PartitionedNALPTrainer`` (``init_state``, ``train_step(s)``,
    ``evaluate``, ``encode_batch``, ``fit``), whose draws, trees, losses
    and metrics it reuses; tabularized only (``cached_hop``), the per-shard
    pool or the ring (``global_candidate_pool``), the sketch
    (``use_cms_correction``), hard negatives and label-edge features (their
    rows stay sharded on the device with their CSR blocks and ride the
    draws). ``answer_dtype="bfloat16"`` halves the answers' bytes: the
    engine writes bf16 bits, K16 moves 2-byte words, and the rows are
    upcast before the encoder (degrees above 256 round in bf16)."""

    def __init__(self, model, store: HostGraphStore, mesh: Mesh, config, *,
                 batch_size: int,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn",
                 host_store: Optional[ShardedHostStore] = None,
                 answer_dtype: str = "float32"):
        cfg = config
        if not getattr(cfg, "cached_hop", False):
            raise ValueError(f"{type(self).__name__} is tabularized-only: "
                             "set cached_hop=True")
        if (getattr(cfg, "global_candidate_pool", False)
                and getattr(cfg, "loss_type", "retrieval") != "retrieval"):
            raise ValueError("global_candidate_pool is a retrieval-loss "
                             "contract (ring sampled softmax)")
        if getattr(cfg, "num_hard_negs", 0) and store.hard_neg_indptr is None:
            raise ValueError("num_hard_negs > 0 needs a store built with "
                             "hard_neg_edges")
        self._init_common(model, store, mesh, cfg, batch_size,
                          optimizer_args, capacity_factor, overflow_policy,
                          host_store)
        if cfg.num_random_negs % self.num_shards:
            raise ValueError("num_random_negs must divide the mesh axis "
                             "size")
        p, rows, dev = self.num_shards, self.pg.rows_per_shard, self.device

        def blocks(indptr, indices, ef):
            out = _shard_csr(indptr, indices, p, rows, weights=None
                             if ef is None else np.asarray(ef, np.float32))
            return [_per_shard(a, dev) for a in out] + [None] * (3 - len(out))

        sup_ip, sup_ix, self._sup_ef = blocks(
            store.supervision_indptr, store.supervision_indices,
            store.sup_edge_features)
        self._sup = (sup_ip, sup_ix)
        if store.hard_neg_indptr is not None:
            hard_ip, hard_ix, self._hard_ef = blocks(
                store.hard_neg_indptr, store.hard_neg_indices,
                store.hard_neg_edge_features)
            self._hard = (hard_ip, hard_ix)
        else:
            # an all-degree-0 CSR: hard draws mask to empty
            self._hard = ([torch.zeros((rows + 1,), dtype=torch.int32,
                                       device=dev) for _ in range(p)],
                          [torch.zeros((1,), dtype=torch.int32, device=dev)
                           for _ in range(p)])
            self._hard_ef = None
        self._init_driver(answer_dtype)

    def _init_common(self, model, store, mesh, cfg, batch_size,
                     optimizer_args, capacity_factor, overflow_policy,
                     host_store) -> None:
        """What the NALP and NC trainers share: the mesh, the model, the
        device-side frozen tables, the host store."""
        if overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(
                "overflow_policy must be warn | raise | silent | grow")
        p = mesh.num_shards
        if batch_size % p:
            raise ValueError(f"batch_size {batch_size} not divisible by {p} "
                             "shards")
        self.mesh = mesh
        self.device = mesh.device
        self.num_shards = p
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.store = store
        self.batch_size = int(batch_size)
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        self.capacity_factor = capacity_factor
        self.overflow_policy = overflow_policy
        self.overflow_total = 0
        self._cached = True
        rows = -(-store.num_nodes // p)
        tab_ks, tables = _sharded_tables(store, cfg.fanouts, p, rows,
                                         self.device)
        self.pg = _HostFedGraph(num_nodes=store.num_nodes,
                                rows_per_shard=rows,
                                feat_dim=store.features.shape[1],
                                sample_tables=tables, table_fanouts=tab_ks)
        self._host_auto = host_store is None
        self.host = (ShardedHostStore.from_host_store(store, num_shards=p)
                     if host_store is None else host_store)
        if self.host.width != 2 * self.pg.feat_dim + 1:
            raise ValueError(f"host_store rows are {self.host.width} wide, "
                             f"not the fused 2D + 1 = "
                             f"{2 * self.pg.feat_dim + 1}")

    # -- static shapes --------------------------------------------------------
    def _tree_size(self, roots: int) -> int:
        """Nodes of one root's tree over the frozen tables (the deepest
        hop is the cache)."""
        total = level = roots
        for k in self.cfg.fanouts[:-1]:
            level *= int(k)
            total += level
        return total

    def _union_sizes(self, encode: bool) -> List[int]:
        cfg, bb = self.cfg, self.batch_size // self.num_shards
        if encode:
            return [self._tree_size(bb)]
        roots = (bb + bb * cfg.num_positives
                 + cfg.num_random_negs // self.num_shards
                 + bb * max(cfg.num_hard_negs, 0))
        return [self._tree_size(roots)]

    def _stores(self, encode: bool) -> List[ShardedHostStore]:
        return [self.host]

    # -- plan and apply -------------------------------------------------------
    def _route(self, trees, encode: bool):
        """The front half of the hydration lookup over every shard's union:
        ([recv per shard], [coords])."""
        union = [self._union_ids(trees, s) for s in range(self.num_shards)]
        recv, coords = send_requests(
            self.mesh, union, self.pg.rows_per_shard,
            self._capacity(self._union_sizes(encode)[0]))
        return [recv], [coords]

    def _plan_device(self, anchors: torch.Tensor, step: int, encode: bool):
        parts = self._split(anchors)
        if encode:
            groups = [[(part, 0)] for part in parts]
            trees, ovf = self._draw_trees(groups)
            recvs, coords = self._route(trees, True)
            return recvs, coords, (None, trees, groups, ovf)
        batches, ovf = self._make_batches(parts, step)
        groups = self._groups(batches, self.cfg.num_hard_negs > 0)
        trees, ovf2 = self._draw_trees(groups)
        recvs, coords = self._route(trees, False)
        return recvs, coords, (batches, trees, groups, ovf + ovf2)

    def _embed(self, ctx, rows, train: bool, generators=None):
        _, trees, groups, _ = ctx
        vals = [self.pg.split_rows(r) for r in rows[0]]
        return self._encode_trees(trees, groups, vals, train, generators)

    def _apply_train(self, state, ctx, rows, dropped, generators):
        refuse_batch_norm_training(self.model)
        batches, _, _, ovf = ctx
        state.optimizer.zero_grad(set_to_none=True)
        embs = self._embed(ctx, rows, True, generators)
        loss, cms = self._loss_from_embeddings(batches, embs, state.cms)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return (state._replace(step=state.step + 1, cms=cms), loss.detach(),
                ovf + dropped)

    def _apply_eval(self, ctx, rows, dropped):
        batches, _, _, ovf = ctx
        embs = self._embed(ctx, rows, False)
        return (*self._eval_from_embeddings(batches, embs), ovf + dropped)

    def _apply_encode(self, ctx, rows):
        return torch.cat([e[0] for e in self._embed(ctx, rows, False)])

    # -- public API -----------------------------------------------------------
    def refresh_cache(self, epoch: int = 0) -> None:
        """Redraw the store's frozen tables and hop-cache aggregate with the
        seed of ``epoch`` (``cfg.seed + 1_299_709 * epoch``, as the
        device-resident trainers) and rebuild the device tables and the
        fused host store; the shapes do not change. Raises over a
        constructor-supplied ``host_store``."""
        if not self._host_auto:
            raise ValueError(
                "refresh_cache over a constructor-supplied host_store "
                "would rebuild it from store.refresh() and discard the "
                "custom layout; rebuild the ShardedHostStore yourself and "
                "construct a new trainer (or pass host_store=None)")
        self.store.refresh(fanouts=tuple(self.cfg.fanouts),
                           seed=self.cfg.seed + 1_299_709 * epoch)
        p, rows = self.num_shards, self.pg.rows_per_shard
        _, tables = _sharded_tables(self.store, self.cfg.fanouts, p, rows,
                                    self.device)
        self.pg = dataclasses.replace(self.pg, sample_tables=tables)
        self.host = ShardedHostStore.from_host_store(
            self.store, num_shards=p, local_shards=self.host.local_shards)


class StreamingPartitionedNodeClassificationTrainer(
        StreamingPartitionedNALPTrainer):
    """Node classification over the streamed-partitioned tier: each step
    routes only the anchor tree through the host stores; the labels stay
    row-sharded on the device and ride a routed gather inside the plan;
    the loss is the mean over shards of each shard's masked cross entropy
    (``PartitionedNodeClassificationTrainer``'s). The model is an encoder
    whose output width is the number of classes; ``config`` a
    ``NodeClassificationTrainerConfig`` with ``cached_hop``."""

    def __init__(self, model, store: HostGraphStore, mesh: Mesh, config, *,
                 batch_size: int,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn",
                 host_store: Optional[ShardedHostStore] = None,
                 answer_dtype: str = "float32"):
        if not getattr(config, "cached_hop", False):
            raise ValueError(f"{type(self).__name__} is tabularized-only: "
                             "set cached_hop=True")
        if store.node_labels is None:
            raise ValueError("store has no node_labels; build the "
                             "HostGraphStore with node_labels=")
        self._init_common(model, store, mesh, config, batch_size,
                          optimizer_args, capacity_factor, overflow_policy,
                          host_store)
        p, rows = self.num_shards, self.pg.rows_per_shard
        lab = np.zeros((p * rows, 1), np.int32)
        lab[: store.num_nodes, 0] = np.asarray(store.node_labels, np.int32)
        self._labels = _per_shard(lab.reshape(p, rows, 1), self.device)
        self._init_driver(answer_dtype)

    _loss_from_logits = PartitionedNodeClassificationTrainer._loss_from_logits
    _accuracy_sums = PartitionedNodeClassificationTrainer._accuracy_sums

    def _union_sizes(self, encode: bool) -> List[int]:
        return [self._tree_size(self.batch_size // self.num_shards)]

    def _plan_device(self, anchors: torch.Tensor, step: int, encode: bool):
        del step   # frozen tables: the draws do not depend on the step
        parts = self._split(anchors)
        groups = [[(part, 0)] for part in parts]
        trees, ovf = self._draw_trees(groups)
        recvs, coords = self._route(trees, encode)
        labels = None
        if not encode:
            lab, ok = routed_gather(self.mesh, self._labels, parts,
                                    capacity_factor=self.capacity_factor)
            ovf = ovf + sum((~o).sum(dtype=torch.int32) for o in ok)
            labels = [(r[:, 0], o) for r, o in zip(lab, ok)]
        return recvs, coords, (labels, trees, groups, ovf)

    def _logits_of(self, ctx, rows, train: bool, generators=None):
        labels = ctx[0]
        embs = self._embed(ctx, rows, train, generators)
        return [(e[0], lab, ok) for e, (lab, ok) in zip(embs, labels)]

    def _apply_train(self, state, ctx, rows, dropped, generators):
        refuse_batch_norm_training(self.model)
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_from_logits(self._logits_of(ctx, rows, True,
                                                      generators))
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach(), \
            ctx[3] + dropped

    def _apply_eval(self, ctx, rows, dropped):
        return (*self._accuracy_sums(self._logits_of(ctx, rows, False)),
                ctx[3] + dropped)

    def evaluate(self, node_batches, step: int = 0) -> float:
        """Global accuracy over ``node_batches`` (each wrap-padded to
        ``batch_size``: a padded node counts again), pipelined as
        ``run_steps``; one host read at the end."""
        batches = [np.resize(np.asarray(b, np.int32), self.batch_size)
                   for b in node_batches if len(b)]
        with torch.inference_mode():
            results = self._eval_rounds(batches, step)
            if not results:
                return 0.0
            correct, total, ovf = (x.sum().cpu() for x in results)
        apply_overflow_policy(self, int(ovf))
        return float(correct) / max(float(total), 1.0)

    def predict_batch(self, node_ids) -> torch.Tensor:
        """Logits of ``node_ids`` (the inference path: ``encode_batch``)."""
        return self.encode_batch(node_ids)

    def fit(self, state, train_nodes, val_nodes, *,
            batch_size: Optional[int] = None, num_epochs: int = 10,
            early_stop_patience: int = 5, log_every: int = 50):
        """Epochs of shuffled train batches through ``run_steps`` (the train
        pool wrap-padded to one batch at least), the accuracy of the first
        ``batch_size`` val nodes (wrapped) after each, early stopping on it;
        the best weights are loaded back. Returns the best val accuracy."""
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"batch_size {batch_size} != the configured "
                             f"batch_size {self.batch_size}")
        val = np.asarray(val_nodes)
        if len(val) == 0:
            raise ValueError("val_nodes is empty")
        val = np.resize(val, max(len(val), self.batch_size))
        train = np.resize(np.asarray(train_nodes),
                          max(len(train_nodes), self.batch_size))
        it = AnchorBatchIterator(train, self.batch_size, seed=self.cfg.seed)
        stopper = EarlyStopper(patience=early_stop_patience)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        for epoch in range(num_epochs):
            batches = list(np.stack(list(it.epoch(epoch))))
            state, losses = self.run_steps(state, batches, generator)
            if log_every:
                logger.info("epoch %d step %d loss %.4f", epoch, state.step,
                            float(losses[-1]))
            acc = self.evaluate([val[: self.batch_size]])
            logger.info("epoch %d val acc %.4f", epoch, acc)
            snap = {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}
            if stopper.update(acc, snap):
                break
        if stopper.best_state is not None:
            self.model.load_state_dict(stopper.best_state)
        return state, {"accuracy": stopper.best_value or 0.0}


class StreamingPartitionedHeteroNALPTrainer(_StreamedStepDriver,
                                            PartitionedHeteroNALPTrainer):
    """Typed NALP over per-node-type host stores and routed device lookups:
    the device holds only the typed adjacency (build the
    ``PartitionedHeteroGraph`` with ``features_on_device=False``). A step
    is ``PartitionedHeteroNALPTrainer``'s cut at its per-node-type
    hydration gathers: the plan draws the batch and every group's op tree
    (live or tabularized, as the config says) and routes each node type's
    union (K15 and the request all_to_all, node types in order); the host
    answers each type from its :class:`ShardedHostStore`; the apply runs
    each type's back half (the answer all_to_all, K16), the typed block
    tree (HGT on K7 / K7b, RGCN on K4 / K4b) and the loss (either pool, the
    label edges' terms). ``host_features={node type: [N, D]}`` or
    ``host_stores``."""

    def __init__(self, model, pgraph, paths, config, mesh: Mesh, *,
                 batch_size: int,
                 host_features: Optional[Dict[str, np.ndarray]] = None,
                 host_stores: Optional[Dict[str, ShardedHostStore]] = None,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn",
                 answer_dtype: str = "float32"):
        PartitionedHeteroNALPTrainer.__init__(
            self, model, pgraph, paths, config, mesh,
            optimizer_args=optimizer_args, capacity_factor=capacity_factor,
            overflow_policy=overflow_policy)
        p = self.num_shards
        if batch_size % p:
            raise ValueError(f"batch_size {batch_size} not divisible by {p} "
                             "shards")
        self.batch_size = int(batch_size)
        cfg, bb = config, batch_size // p
        a_nt, c_nt = str(cfg.anchor_node_type), str(cfg.candidate_node_type)
        roots = [(bb, a_nt), (bb * cfg.num_positives, c_nt),
                 (cfg.num_random_negs // p, c_nt)]
        if cfg.num_hard_negs > 0:
            roots.append((bb * cfg.num_hard_negs, c_nt))
        # rows of each node type a shard's train (encode: anchor tree
        # only) plan routes, in node-type order
        self._union = self._type_sizes(roots)
        self._enc_union = self._type_sizes(roots[:1])
        if host_stores is None:
            if host_features is None:
                raise ValueError("pass host_features={node_type: [N, D]} "
                                 "or host_stores")
            host_stores = {str(nt): ShardedHostStore.from_array(
                f, num_shards=p) for nt, f in host_features.items()}
        self.host_stores = {str(k): v for k, v in host_stores.items()}
        for nt in self._union:
            if nt not in self.host_stores:
                raise ValueError(f"no host store for node type {nt!r}")
            if self.host_stores[nt].width != pgraph.feat_dims[nt]:
                raise ValueError(
                    f"host store of {nt!r} is {self.host_stores[nt].width} "
                    f"wide, the graph's {nt!r} features "
                    f"{pgraph.feat_dims[nt]}")
        self._init_driver(answer_dtype)

    def _type_sizes(self, roots) -> Dict[str, int]:
        """{node type: rows of it in the trees of ``roots`` [(count, root
        type)]}, in node-type order."""
        sizes: Dict[str, int] = {}
        for count, nt in roots:
            levels = [count]
            types = [nt]
            for op in self.paths[nt]:
                levels.append(levels[op.parent + 1] * int(op.fanout))
                types.append(str(op.neighbor_node_type))
            for n, t in zip(levels, types):
                sizes[t] = sizes.get(t, 0) + n
        return dict(sorted(sizes.items()))

    def _union_sizes(self, encode: bool) -> List[int]:
        return list((self._enc_union if encode else self._union).values())

    def _stores(self, encode: bool) -> List[ShardedHostStore]:
        return [self.host_stores[nt] for nt in
                (self._enc_union if encode else self._union)]

    def _plan_device(self, anchors: torch.Tensor, step: int, encode: bool):
        parts = self._split(anchors)
        if encode:
            a_nt = str(self.cfg.anchor_node_type)
            batches, ovf = None, self._zero()
            groups = [[(part, a_nt, 0)] for part in parts]
        else:
            batches, ovf = self._make_batches(parts, step)
            groups = self._groups(batches, self.cfg.num_hard_negs > 0)
        trees, ovf2 = self._draw_trees(groups)
        sizes = self._enc_union if encode else self._union
        levels = self._levels_by_type(trees)
        if [nt for nt, _ in levels] != list(sizes):
            raise RuntimeError(f"the trees' node types {levels} are not the "
                               f"planned {list(sizes)}")
        recvs, coords = [], []
        for nt, lv in levels:
            recv, co = send_requests(
                self.mesh, [self._type_union(trees, lv, s)
                            for s in range(self.num_shards)],
                self.pg.rows[nt], self._capacity(sizes[nt]))
            recvs.append(recv)
            coords.append(co)
        return recvs, coords, (batches, trees, groups, ovf + ovf2,
                               list(sizes))

    def _embed(self, ctx, rows, train: bool, generators=None):
        _, trees, groups, _, types = ctx
        return self._encode_trees(trees, groups, dict(zip(types, rows)),
                                  train, generators)

    def _apply_train(self, state, ctx, rows, dropped, generators):
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_from_embeddings(
            ctx[0], self._embed(ctx, rows, True, generators))
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach(), \
            ctx[3] + dropped

    def _apply_eval(self, ctx, rows, dropped):
        return (*self._eval_from_embeddings(ctx[0], self._embed(ctx, rows,
                                                                False)),
                ctx[3] + dropped)

    def _apply_encode(self, ctx, rows):
        return torch.cat([e[0] for e in self._embed(ctx, rows, False)])

    def encode_batch(self, node_ids, node_type: Optional[str] = None
                     ) -> torch.Tensor:
        """Inference embeddings of anchor-type ``node_ids`` (the plan's
        groups are anchored: another node type needs a trainer with that
        type as anchor); only the anchor tree's node types make the host
        round trip."""
        nt = str(node_type or self.cfg.anchor_node_type)
        if nt != str(self.cfg.anchor_node_type):
            raise ValueError(
                f"encode_batch over the streamed-partitioned tier serves the "
                f"anchor node type {self.cfg.anchor_node_type!r}; got {nt!r}")
        return _StreamedStepDriver.encode_batch(self, node_ids)
