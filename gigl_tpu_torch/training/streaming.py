"""Out-of-core NALP training: host-resident features streamed to the card
per batch (port of ``gigl_tpu/training/streaming.py``).

The regime of graphs whose features do not fit in device memory (the
MAG240M recipe: 244M x 768 fp32 features are 750 GB): the topology and the
per-node tables stay on the host in a :class:`HostGraphStore`, the
features in RAM or in an ``np.memmap`` on disk. Per batch, the host builds
the tabularized fanout tree (frozen sample tables, hop-cache aggregates:
the device path's tabularized mode) and gathers every row the step needs
through the port's host engine (``gigl_tpu_torch/native``: its draws are
bit-equal to the device sampler's), and the step runs on the card over
those rows. No feature table exists on the device.

The H100 design of the batch pipe (the reference passes host arrays to a
jit step and lets a thread pool prefetch):

- a ring of ``prefetch + 1`` slots, each a full batch's host buffers in
  pinned (page-locked) memory, filled in place by the engine from worker
  threads (bf16 streaming: the engine writes the rows' bf16 bit patterns
  into ``int16`` buffers in the gather's own pass);
- each slot's rows copied to its device buffers with ``non_blocking=True``
  on a side copy stream; the compute stream waits on the copy's event
  before the step;
- a slot's host buffers are refilled only after the event of their copy,
  and its device buffers are copied into only after the event of the step
  that read them.

The step itself (the port's ``nalp_loss_from_embeddings``,
``make_optimizer``, the encoder's cached block path: K4 / K4b, K5, and K13
/ K14 with ``use_cms_correction``) runs on the compute stream, never on the
copy stream: K5's forward finds its last block by a per-device ticket
(``ops/retrieval.py``), so K5 calls on one device stay on one stream. It
launches no kernel of its own.

Exact parity: for the same seeds the streamed trainer computes the losses
of the device-resident ``NALPTrainer`` in tabularized mode (and of the
reference's streamed trainer): the streamed rows are the rows the device
path gathers from its tables. Scope: tabularized mode only; hard
negatives and label-edge features stream like the other groups.
``mesh=`` (data-parallel streamed training) is not ported (ROADMAP A16).
On the CPU (``device="cpu"``) the host buffers are the step's inputs,
with no pinning and no streams.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch import native
from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.graph.csr import build_csr
from gigl_tpu_torch.losses.count_min_sketch import cms_init
from gigl_tpu_torch.losses.metrics import hits_at_k, mean_reciprocal_rank
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.training.base import refuse_batch_norm_training
from gigl_tpu_torch.training.dataset import NALPBatch
from gigl_tpu_torch.training.trainer import (
    NALPTrainerConfig,
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
    nalp_loss_from_embeddings,
)
from gigl_tpu_torch.utils.cast import stream_cast_from_str


# -- numpy mirrors of the device counter RNG (bit-equal) ------------------------
def _np_mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x *= np.uint32(0x846CA68B)
        x ^= x >> np.uint32(16)
    return x


def np_counter_rng_uniform(node_ids: np.ndarray, seed: int, hop: int,
                           num_slots: int) -> np.ndarray:
    """numpy mirror of the device sampler's counter RNG (K1's bits)."""
    node_ids = np.asarray(node_ids)
    slots = np.broadcast_to(np.arange(num_slots, dtype=np.uint32),
                            node_ids.shape + (num_slots,))
    with np.errstate(over="ignore"):
        base = (node_ids.astype(np.uint32)[..., None] * np.uint32(0x9E3779B9)
                + np.uint32(seed & 0xFFFFFFFF) * np.uint32(0x85EBCA6B)
                + np.uint32(hop & 0xFFFFFFFF) * np.uint32(0xC2B2AE35))
        return _np_mix32(base ^ _np_mix32(slots + np.uint32(0x27220A95)))


def np_sample_fanout(indptr: np.ndarray, indices: np.ndarray,
                     roots: np.ndarray, fanout: int, *, seed: int,
                     hop: int, return_slots: bool = False):
    """numpy mirror of the uniform fanout draw (the plain version of the
    engine's ``sample_fanout`` and of K1): (nbr [R, fanout] int32, mask
    [R, fanout] bool[, CSR slots int64])."""
    roots = np.asarray(roots, np.int64)
    start = indptr[roots]
    deg = indptr[roots + 1] - start
    slot_iota = np.broadcast_to(np.arange(fanout, dtype=np.int64),
                                (len(roots), fanout))
    bits = np_counter_rng_uniform(roots, seed, hop, fanout)
    rand_off = (bits % np.maximum(deg, 1)[:, None].astype(np.uint32)).astype(
        np.int64)
    take_all = (deg <= fanout)[:, None]
    offsets = np.where(take_all,
                       np.minimum(slot_iota, np.maximum(deg - 1, 0)[:, None]),
                       rand_off)
    mask = np.where(take_all, slot_iota < deg[:, None], (deg > 0)[:, None])
    slots = np.clip(start[:, None] + offsets, 0, max(len(indices) - 1, 0))
    nbr = indices[slots] if len(indices) else np.zeros_like(slots, np.int32)
    nbr = np.where(mask, nbr, 0).astype(np.int32)
    return (nbr, mask, slots) if return_slots else (nbr, mask)


class HostTable:
    """An [N, D] float32 table on the host, in RAM or an ``np.memmap``
    (read where it lies: a C-contiguous float32 memmap is not copied);
    rows gathered by the host engine."""

    def __init__(self, table: np.ndarray):
        self.array = np.ascontiguousarray(table, np.float32)
        if self.array.ndim != 2:
            raise ValueError("HostTable needs an [N, D] table")

    @property
    def shape(self):
        return self.array.shape

    def gather(self, idx: np.ndarray) -> np.ndarray:
        return native.gather_f32(self.array, idx)


@dataclass
class HostGraphStore:
    """The host-side graph of streamed training, built once: the message,
    supervision (and hard-negative) CSRs, the features, and the device
    path's tabularized tables built on the host — ``agg`` the hop-cache
    aggregate (``ops/hopcache.py`` semantics), ``sample_tables[k]`` the
    frozen per-node draws of fanout k (ids 0 where masked)."""

    message_indptr: np.ndarray        # [N+1] int64
    message_indices: np.ndarray       # [E] int32
    supervision_indptr: np.ndarray
    supervision_indices: np.ndarray
    features: HostTable               # [N, D]
    agg: HostTable                    # [N, D]
    degrees: np.ndarray               # [N] float32
    sample_tables: Dict[int, Tuple[np.ndarray, np.ndarray]]
    num_nodes: int
    # user-defined hard negatives (hard_neg edges) as a CSR
    hard_neg_indptr: Optional[np.ndarray] = None
    hard_neg_indices: Optional[np.ndarray] = None
    # the label edges' features in CSR slot order, hydrated per drawn
    # positive / hard negative into the streamed batch
    sup_edge_features: Optional[np.ndarray] = None
    hard_neg_edge_features: Optional[np.ndarray] = None
    # node labels [N] int32 (kept beside the store; O(N) bytes)
    node_labels: Optional[np.ndarray] = None

    @classmethod
    def build(cls, *, message_edges: np.ndarray,
              supervision_edges: np.ndarray, features: np.ndarray,
              num_nodes: int, fanouts: Sequence[int], seed: int = 0,
              agg: str = "mean",
              hard_neg_edges: Optional[np.ndarray] = None,
              supervision_edge_features: Optional[np.ndarray] = None,
              hard_neg_edge_features: Optional[np.ndarray] = None,
              node_labels: Optional[np.ndarray] = None
              ) -> "HostGraphStore":
        """The store of ``message_edges`` [2, E] (sampled on dst),
        ``supervision_edges`` [2, Es] (and ``hard_neg_edges`` [2, Eh]),
        anchored on their second row, with ``features`` [N, D] (an
        ``np.memmap`` stays on disk), then :meth:`refresh`."""
        def csr(edges):
            return build_csr(edges[0], edges[1], num_anchor_nodes=num_nodes,
                             num_neighbor_nodes=num_nodes, anchor="dst")

        msg, sup = csr(message_edges), csr(supervision_edges)
        sup_ef = None
        if supervision_edge_features is not None:
            sup_ef = np.ascontiguousarray(np.asarray(
                supervision_edge_features, np.float32)[sup.edge_ids])
        hn_ip = hn_ix = hn_ef = None
        if hard_neg_edges is not None:
            hn = csr(hard_neg_edges)
            hn_ip = hn.indptr.astype(np.int64)
            hn_ix = hn.indices.astype(np.int32)
            if hard_neg_edge_features is not None:
                hn_ef = np.ascontiguousarray(np.asarray(
                    hard_neg_edge_features, np.float32)[hn.edge_ids])
        elif hard_neg_edge_features is not None:
            raise ValueError("hard_neg_edge_features needs hard_neg_edges")
        store = cls(
            message_indptr=msg.indptr.astype(np.int64),
            message_indices=msg.indices.astype(np.int32),
            supervision_indptr=sup.indptr.astype(np.int64),
            supervision_indices=sup.indices.astype(np.int32),
            features=HostTable(features),
            agg=HostTable(np.zeros((num_nodes, features.shape[1]),
                                   np.float32)),
            degrees=np.diff(msg.indptr).astype(np.float32),
            sample_tables={}, num_nodes=num_nodes,
            hard_neg_indptr=hn_ip, hard_neg_indices=hn_ix,
            sup_edge_features=sup_ef, hard_neg_edge_features=hn_ef,
            node_labels=(None if node_labels is None
                         else np.asarray(node_labels, np.int32)))
        store.refresh(fanouts=fanouts, seed=seed, agg=agg)
        return store

    def _sample(self, roots, fanout, seed, hop):
        nbr, mask, _ = native.sample_fanout(
            self.message_indptr, self.message_indices, roots, fanout,
            seed=seed, hop=hop)
        return nbr, mask

    def refresh(self, *, fanouts: Sequence[int], seed: int,
                agg: str = "mean", chunk: int = 65536) -> None:
        """(Re)build the hop-cache aggregate (the deepest hop's draws at
        hop ``len(fanouts)``, reduced on the host in fp32) and the frozen
        sample tables (hop 1) — the host counterpart of
        ``DeviceGraph.with_neighbor_cache``."""
        if agg not in ("mean", "sum", "gcn"):
            raise ValueError(f"unknown agg {agg!r}")
        n, k_deep = self.num_nodes, int(fanouts[-1])
        out = np.empty((n, self.features.shape[1]), np.float32)
        for s in range(0, n, chunk):
            ids = np.arange(s, min(s + chunk, n), dtype=np.int32)
            nbr, mask = self._sample(ids, k_deep, seed, len(fanouts))
            x = self.features.gather(nbr)                      # [C, k, D]
            m = mask[..., None].astype(np.float32)
            if agg == "mean":
                out[s: s + len(ids)] = (x * m).sum(1) / np.maximum(
                    m.sum(1), 1.0)
            elif agg == "sum":
                out[s: s + len(ids)] = (x * m).sum(1)
            else:
                w = 1.0 / np.sqrt(self.degrees[nbr] + 1.0)
                out[s: s + len(ids)] = (x * w[..., None] * m).sum(1)
        self.agg = HostTable(out)
        self.sample_tables = {}
        for k in sorted(set(int(k) for k in fanouts[:-1])):
            ids_t = np.empty((n, k), np.int32)
            mask_t = np.empty((n, k), bool)
            for s in range(0, n, chunk):
                ids = np.arange(s, min(s + chunk, n), dtype=np.int32)
                ids_t[s: s + len(ids)], mask_t[s: s + len(ids)] = (
                    self._sample(ids, k, seed, 1))
            self.sample_tables[k] = (ids_t, mask_t)


class GroupArrays(NamedTuple):
    """One encode group's streamed tree (level d: [M, k1..kd, ...])."""

    feats: Tuple[np.ndarray, ...]
    cached: Tuple[np.ndarray, ...]
    masks: Tuple[np.ndarray, ...]
    degs: Tuple[np.ndarray, ...]


class StreamedBatch(NamedTuple):
    """A streamed batch on the host: the draws (an ``NALPBatch`` of numpy
    arrays) and the trees of the anchors, positives, random negatives and
    hard negatives (None without). Rows are fp32, or the bf16 bit patterns
    (``int16``) with ``stream_dtype="bfloat16"``."""

    ids: NALPBatch
    q: GroupArrays
    pos: GroupArrays
    rand: GroupArrays
    hard: Optional[GroupArrays] = None


def np_tree(store: HostGraphStore, roots: np.ndarray,
            fanouts: Sequence[int]) -> GroupArrays:
    """The tree of ``roots`` assembled in numpy from the store's tables
    (the plain version of the engine's fused expand-and-gather), fp32."""
    levels = [np.asarray(roots).reshape(-1).astype(np.int32)]
    masks = [np.ones(levels[0].shape, bool)]
    frontier, parent = levels[0], masks[0]
    for k in fanouts:
        ids_t, mask_t = store.sample_tables[int(k)]
        m = mask_t[frontier] & parent[..., None]
        nbr = np.where(m, ids_t[frontier], 0)
        levels.append(nbr)
        masks.append(m)
        frontier, parent = nbr, m
    return GroupArrays(
        feats=tuple(store.features.array[lv] for lv in levels),
        cached=tuple(store.agg.array[lv] for lv in levels),
        masks=tuple(masks),
        degs=tuple(store.degrees[lv] for lv in levels))


_GROUPS = ("q", "pos", "rand", "hard")


class _Slot:
    """One ring slot: a batch's host buffers (pinned on a CUDA trainer),
    their device copies, and the events that order the slot's reuse
    (``copied``: its host buffers were read; ``used``: the step that read
    its device buffers is done)."""

    def __init__(self, layout, stream_np, device):
        cuda = device.type == "cuda"
        self.host: Dict[str, np.ndarray] = {}
        self.pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.dev: Dict[str, torch.Tensor] = {}
        for name, shape, kind, on_device in layout:
            dtype = {"i32": torch.int32, "bool": torch.bool,
                     "f32": torch.float32,
                     "rows": torch.float32 if stream_np == np.float32
                     else torch.int16}[kind]
            h = torch.empty(shape, dtype=dtype, pin_memory=cuda)
            self.host[name] = h.numpy()
            if on_device:
                d = (torch.empty(shape, dtype=dtype, device=device) if cuda
                     else h)
                self.dev[name] = d
                if cuda:
                    self.pairs.append((h, d))
        self.nbytes = sum(h.numel() * h.element_size() for h, _ in self.pairs)
        self.copied = torch.cuda.Event() if cuda else None
        self.used = torch.cuda.Event() if cuda else None
        self.copy_start = torch.cuda.Event(enable_timing=True) if cuda \
            else None
        self.copy_end = torch.cuda.Event(enable_timing=True) if cuda \
            else None


class StreamingNALPTrainer:
    """NALP trainer over a :class:`HostGraphStore`: no feature table on
    the card. The config, loss and evaluation follow ``NALPTrainer`` in
    tabularized mode (the reference's ``StreamingNALPTrainer``)."""

    def __init__(self, model, store: HostGraphStore,
                 config: NALPTrainerConfig,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 stream_dtype: Optional[str] = None, mesh=None,
                 axis: Optional[str] = None, device: DeviceLike = None):
        """``stream_dtype``: "bfloat16" halves the host-to-device bytes
        (the rows are cast on the host, the encoder upcasts them to its
        compute type); default fp32, exact parity with the device-resident
        path. ``mesh`` / ``axis``: not ported (ROADMAP A16)."""
        if mesh is not None or axis is not None:
            raise NotImplementedError(
                "StreamingNALPTrainer(mesh=): data-parallel streamed "
                "training over a mesh is not ported (ROADMAP A16)")
        if config.num_hard_negs and store.hard_neg_indptr is None:
            raise ValueError("num_hard_negs > 0 needs a store built with "
                             "hard_neg_edges")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.store = store
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        self.stream_torch, self.stream_np, self._cast = stream_cast_from_str(
            stream_dtype)
        self._ring: Dict[Tuple[int, int], List[_Slot]] = {}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # per-step timings of the last run_steps(timing=True)
        self.last_run: Dict[str, list] = {}

    # -- state -----------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        init_params(self.model, seed)

    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict) or initialize the weights from
        ``seed``, then the optimizer and, with ``use_cms_correction``, an
        empty sketch on the device (``NALPTrainer.init_state``)."""
        del batch_size
        if params is None:
            self.init_params(seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        cms = (cms_init(device=self.device) if self.cfg.use_cms_correction
               else None)
        return TrainState(step=0, optimizer=opt, cms=cms)

    # -- host batch assembly ---------------------------------------------------
    def _roots(self, b: int) -> Dict[str, int]:
        cfg = self.cfg
        roots = {"q": b, "pos": b * cfg.num_positives,
                 "rand": cfg.num_random_negs}
        if cfg.num_hard_negs > 0:
            roots["hard"] = b * cfg.num_hard_negs
        return roots

    def _layout(self, b: int):
        """(name, shape, kind, copied to the card) of every buffer of a
        batch of ``b`` anchors."""
        cfg, store = self.cfg, self.store
        p, h, r = cfg.num_positives, max(cfg.num_hard_negs, 0), \
            cfg.num_random_negs
        d = store.features.shape[1]
        out = [("anchors", (b,), "i32", True), ("pos", (b, p), "i32", True),
               ("pos_mask", (b, p), "bool", True),
               ("hard", (b, h), "i32", True),
               ("hard_mask", (b, h), "bool", True),
               ("rand", (r,), "i32", True)]
        if store.sup_edge_features is not None:
            out.append(("pos_ef", (b, p, store.sup_edge_features.shape[1]),
                        "rows", True))
        if h and store.hard_neg_edge_features is not None:
            out.append(("hard_ef",
                        (b, h, store.hard_neg_edge_features.shape[1]),
                        "rows", True))
        for g, m in self._roots(b).items():
            shape = (m,)
            for lv, k in enumerate((0,) + tuple(cfg.fanouts[:-1])):
                if lv:
                    shape = shape + (int(k),)
                    out.append((f"{g}.ids{lv}", shape, "i32", False))
                out += [(f"{g}.mask{lv}", shape, "bool", True),
                        (f"{g}.feat{lv}", shape + (d,), "rows", True),
                        (f"{g}.agg{lv}", shape + (d,), "rows", True),
                        (f"{g}.deg{lv}", shape, "f32", True)]
        return out

    def _rows_into(self, slot: _Slot, name: str, rows: np.ndarray) -> None:
        """Label-edge rows into a stream-typed buffer."""
        self._cast(rows, out=slot.host[name].view(self.stream_np))

    def _tree_into(self, slot: _Slot, g: str, roots: np.ndarray) -> None:
        """A group's tree, one engine call a level, written into the
        slot's buffers (bf16: cast in the engine's gather pass)."""
        store = self.store
        feats, agg, degs = (store.features.array, store.agg.array,
                            store.degrees)
        host = slot.host
        bf16 = self.stream_np != np.float32

        def rows(name):
            return host[name].view(self.stream_np)

        frontier = np.ascontiguousarray(roots, np.int32).reshape(-1)
        native.expand_gather(frontier, None, None, None, feats, agg, degs,
                             out=(None, None, rows(f"{g}.feat0"),
                                  rows(f"{g}.agg0"), host[f"{g}.deg0"]),
                             bf16=bf16)
        host[f"{g}.mask0"][...] = True
        parent = host[f"{g}.mask0"]
        for lv, k in enumerate(self.cfg.fanouts[:-1], 1):
            ids_t, mask_t = store.sample_tables[int(k)]
            native.expand_gather(
                frontier, parent, ids_t, mask_t, feats, agg, degs,
                out=(host[f"{g}.ids{lv}"], host[f"{g}.mask{lv}"],
                     rows(f"{g}.feat{lv}"), rows(f"{g}.agg{lv}"),
                     host[f"{g}.deg{lv}"]), bf16=bf16)
            frontier, parent = host[f"{g}.ids{lv}"], host[f"{g}.mask{lv}"]

    def _fill(self, slot: _Slot, anchors, step: int) -> float:
        """The batch of ``step`` for ``anchors`` written into the slot's
        host buffers: the positives (hop 1_000_003 + step), hard negatives
        (hop 2_000_003 + step) and random negatives (hop 3_000_017 + step)
        drawn as the device path draws them, then the four trees. Returns
        the host seconds it took."""
        t0 = time.perf_counter()
        if slot.copied is not None:
            slot.copied.synchronize()   # its last copy has read the buffers
        cfg, store, host = self.cfg, self.store, slot.host
        anchors = np.asarray(anchors, np.int32).reshape(-1)
        host["anchors"][...] = anchors
        pos, pos_mask, pos_slots = native.sample_fanout(
            store.supervision_indptr, store.supervision_indices, anchors,
            cfg.num_positives, seed=cfg.seed, hop=1_000_003 + step)
        host["pos"][...], host["pos_mask"][...] = pos, pos_mask
        if "pos_ef" in host:
            self._rows_into(slot, "pos_ef", np.where(
                pos_mask[..., None], store.sup_edge_features[pos_slots],
                0.0))
        bits = np_counter_rng_uniform(
            np.arange(cfg.num_random_negs, dtype=np.int32), cfg.seed,
            3_000_017 + step, 1)[:, 0]
        host["rand"][...] = (bits % np.uint32(store.num_nodes)).astype(
            np.int32)
        if cfg.num_hard_negs > 0:
            h, h_mask, h_slots = native.sample_fanout(
                store.hard_neg_indptr, store.hard_neg_indices, anchors,
                cfg.num_hard_negs, seed=cfg.seed, hop=2_000_003 + step)
            if "hard_ef" in host:
                self._rows_into(slot, "hard_ef", np.where(
                    h_mask[..., None],
                    store.hard_neg_edge_features[h_slots], 0.0))
            host["hard"][...] = np.where(h_mask, h, 0)
            host["hard_mask"][...] = h_mask
        for g in self._roots(len(anchors)):
            self._tree_into(slot, g, {"q": anchors, "pos": host["pos"],
                                      "rand": host["rand"],
                                      "hard": host["hard"]}[g])
        return time.perf_counter() - t0

    def _new_slot(self, b: int) -> _Slot:
        return _Slot(self._layout(b), self.stream_np, self.device)

    @staticmethod
    def _batch_of(arrays: Dict[str, Any], groups) -> Tuple[NALPBatch, Dict]:
        """(NALPBatch, {group: (feats, masks, degs, cached)}) of a slot's
        arrays (host or device)."""
        ids = NALPBatch(
            anchors=arrays["anchors"], pos=arrays["pos"],
            pos_mask=arrays["pos_mask"], hard_neg=arrays["hard"],
            hard_neg_mask=arrays["hard_mask"], random_neg=arrays["rand"],
            pos_edge_feats=arrays.get("pos_ef"),
            hard_neg_edge_feats=arrays.get("hard_ef"))
        trees = {}
        for g in groups:
            levels = sorted(int(k[len(g) + 5:]) for k in arrays
                            if k.startswith(f"{g}.mask"))
            trees[g] = tuple([arrays[f"{g}.{t}{lv}"] for lv in levels]
                             for t in ("feat", "mask", "deg", "agg"))
        return ids, trees

    def prepare_batch(self, anchors, step: int) -> StreamedBatch:
        """The host batch of ``step`` for ``anchors`` (fresh, unpinned
        buffers; ``run_steps`` fills its ring in place instead)."""
        anchors = np.asarray(anchors, np.int32).reshape(-1)
        slot = _Slot(self._layout(len(anchors)), self.stream_np,
                     torch.device("cpu"))
        self._fill(slot, anchors, step)
        ids, trees = self._batch_of(slot.host, self._roots(len(anchors)))
        groups = {g: GroupArrays(feats=tuple(f), cached=tuple(a),
                                 masks=tuple(m), degs=tuple(d))
                  for g, (f, m, d, a) in trees.items()}
        return StreamedBatch(ids=ids, q=groups["q"], pos=groups["pos"],
                             rand=groups["rand"], hard=groups.get("hard"))

    # -- the copy ----------------------------------------------------------------
    def _upload(self, slot: _Slot, timing: bool = False) -> Dict:
        """The slot's device arrays, its copies enqueued on the copy
        stream after the last step that read them, and the compute
        stream made to wait for the copies."""
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(slot.used)
                if timing:
                    slot.copy_start.record(self._copy_stream)
                for h, d in slot.pairs:
                    d.copy_(h, non_blocking=True)
                if timing:
                    slot.copy_end.record(self._copy_stream)
                slot.copied.record(self._copy_stream)
            compute.wait_event(slot.copied)
            arrays = slot.dev
        else:
            arrays = {k: torch.from_numpy(v) for k, v in slot.host.items()}
        return {k: (v.view(self.stream_torch)
                    if v.dtype == torch.int16 else v)
                for k, v in arrays.items()}

    def _to_device(self, batch: StreamedBatch) -> Dict:
        """A host StreamedBatch's arrays on the device (a synchronous
        copy; the ring's path is ``run_steps``)."""
        arrays = {"anchors": batch.ids.anchors, "pos": batch.ids.pos,
                  "pos_mask": batch.ids.pos_mask,
                  "hard": batch.ids.hard_neg,
                  "hard_mask": batch.ids.hard_neg_mask,
                  "rand": batch.ids.random_neg}
        for k, v in (("pos_ef", batch.ids.pos_edge_feats),
                     ("hard_ef", batch.ids.hard_neg_edge_feats)):
            if v is not None:
                arrays[k] = v
        for g in _GROUPS:
            ga = getattr(batch, g)
            if ga is None:
                continue
            for lv in range(len(ga.feats)):
                arrays.update({f"{g}.feat{lv}": ga.feats[lv],
                               f"{g}.agg{lv}": ga.cached[lv],
                               f"{g}.mask{lv}": ga.masks[lv],
                               f"{g}.deg{lv}": ga.degs[lv]})
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype == torch.int16:
                t = t.view(self.stream_torch)
            out[k] = t.to(self.device)
        return out

    # -- device steps ------------------------------------------------------------
    def _encode(self, tree, out_shape, train, generator=None):
        feats, masks, degs, cached = tree
        emb = self.model(feats, masks, None, train=train, hop_degrees=degs,
                         cached_agg=cached, generator=generator)
        return emb.reshape(tuple(out_shape) + (emb.shape[-1],))

    def _step(self, state: TrainState, arrays: Dict,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[TrainState, torch.Tensor]:
        refuse_batch_norm_training(self.model)
        ids, trees = self._batch_of(arrays, self._roots(
            arrays["anchors"].shape[0]))
        state.optimizer.zero_grad(set_to_none=True)
        b, p = ids.pos.shape
        q = self._encode(trees["q"], (b,), True, generator)
        pos = self._encode(trees["pos"], (b, p), True, generator)
        rand = self._encode(trees["rand"], ids.random_neg.shape, True,
                            generator)
        hard = (self._encode(trees["hard"], ids.hard_neg.shape, True,
                             generator) if "hard" in trees else None)
        loss, cms = nalp_loss_from_embeddings(self.model, self.cfg, ids, q,
                                              pos, hard, rand, state.cms)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1, cms=cms), loss.detach()

    def train_step(self, state: TrainState, batch: StreamedBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step over a host batch (copied synchronously); the loss as
        a 0-d device tensor."""
        return self._step(state, self._to_device(batch), generator)

    def run_steps(self, state: TrainState, anchor_batches, *,
                  start_step: int = 0, prefetch: int = 2,
                  generator: Optional[torch.Generator] = None,
                  timing: bool = False) -> Tuple[TrainState, np.ndarray]:
        """``len(anchor_batches)`` steps through the ring (module
        docstring): batches t+1..t+prefetch are drawn and gathered into
        their slots by ``prefetch`` worker threads while the card runs
        step t. Returns the state and the losses (one host sync at the
        end). ``timing``: ``last_run`` gets each step's host fill seconds
        and copy milliseconds (CUDA events on the copy stream)."""
        anchor_batches = [np.asarray(a, np.int32).reshape(-1)
                          for a in anchor_batches]
        k_total = len(anchor_batches)
        if k_total == 0:
            return state, np.zeros((0,), np.float32)
        n_slots = max(prefetch, 0) + 1
        b = len(anchor_batches[0])
        if any(len(a) != b for a in anchor_batches):
            raise ValueError("run_steps: every batch needs the same size")
        ring = self._ring.get((b, n_slots))
        if ring is None:
            ring = [self._new_slot(b) for _ in range(n_slots)]
            self._ring[(b, n_slots)] = ring
        losses, fills, copies = [], [], []
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max(prefetch, 1)) as pool:
            futs = {i: pool.submit(self._fill, ring[i % n_slots],
                                   anchor_batches[i], start_step + i)
                    for i in range(min(n_slots, k_total))}
            for i in range(k_total):
                slot = ring[i % n_slots]
                fills.append(futs.pop(i).result())
                arrays = self._upload(slot, timing)
                state, loss = self._step(state, arrays, generator)
                if slot.used is not None:
                    slot.used.record(torch.cuda.current_stream(self.device))
                    if timing:
                        copies.append(slot)
                losses.append(loss)
                nxt = i + n_slots
                if nxt < k_total:
                    futs[nxt] = pool.submit(self._fill, slot,
                                            anchor_batches[nxt],
                                            start_step + nxt)
        out = torch.stack(losses).float().cpu().numpy()
        if timing:
            self.last_run = {
                "fill_s": fills,
                "copy_ms": [s.copy_start.elapsed_time(s.copy_end)
                            for s in copies[-n_slots:]],
                "bytes_per_step": ring[0].nbytes}
        return state, out

    # -- evaluation --------------------------------------------------------------
    def _eval_step(self, arrays: Dict):
        ids, trees = self._batch_of(arrays, ("q", "pos", "rand"))
        b, p = ids.pos.shape
        q = self._encode(trees["q"], (b,), False)
        pos = self._encode(trees["pos"], (b, p), False)
        rand = self._encode(trees["rand"], ids.random_neg.shape, False)
        pos_flat = self.model.decode(q[:, None, :], pos).reshape(-1)
        neg_rep = self.model.decode_all_pairs(q, rand).repeat_interleave(
            p, dim=0)
        mask_flat = ids.pos_mask.reshape(-1)
        neg_mask = ids.pos.reshape(-1)[:, None] != ids.random_neg[None, :]
        rr, cnt = mean_reciprocal_rank(pos_flat, neg_rep, pos_mask=mask_flat,
                                       neg_mask=neg_mask)
        hits, _ = hits_at_k(pos_flat, neg_rep, self.cfg.eval_ks,
                            pos_mask=mask_flat, neg_mask=neg_mask)
        return rr, torch.stack([hits[int(k)] for k in self.cfg.eval_ks]), cnt

    def evaluate(self, anchor_batches, *, step: int = 0) -> Dict[str, float]:
        """MRR and hits@k over ``anchor_batches`` (batch i drawn at step
        7_777_777 + step + i, as the reference's streamed trainer draws
        it): each positive ranked against the random negatives; one host
        sync at the end."""
        with torch.inference_mode():
            parts = [self._eval_step(self._to_device(self.prepare_batch(
                anchors, 7_777_777 + step + i)))
                for i, anchors in enumerate(anchor_batches)]
            rr, hits, cnt = (torch.stack(p_).sum(0).cpu()
                             for p_ in zip(*parts))
        cnt_total = max(float(cnt), 1.0)
        out = {"mrr": float(rr) / cnt_total}
        for i, k in enumerate(self.cfg.eval_ks):
            out[f"hits@{k}"] = float(hits[i]) / cnt_total
        return out
