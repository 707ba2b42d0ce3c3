"""Sampled training over a graph PARTITIONED across a mesh of shards (port
of the homogeneous part of ``gigl_tpu/training/dist_sampled.py``:
``_shard_csr``, ``apply_overflow_policy``, ``PartitionedGraph`` with its
int8 rows, its tabularized layout and its label-edge features,
``PartitionedNALPTrainer``, live and ``cached_hop``, and
``PartitionedNodeClassificationTrainer``).

Every shard holds only its 1/P range of the graph — the feature rows with
the in-degree fused as the last column, and its blocks of the message,
supervision and hard-negative CSRs — and a training step is one program
over all shards (``parallel/mesh.py``: a single controller; a shard's state
is its own tensors):

  - frontier expansion is ``routed_sample_neighbors`` (frontier ids go to
    their owner shard, which draws fanout slots with the replicated
    sampler's counter RNG — K1 in its row-offset mode, or K19's for
    ``sampling_method="weighted"`` / ``"top_k"`` over the shard's edge
    weights — and the ids come back: K15, K16),
  - feature hydration is ONE ``routed_gather`` over the union of a shard's
    encode trees (anchors, positives, its slice of the shared random
    negatives, hard negatives; K15, K3 on the owner, K16),
  - random negatives are drawn identically on every shard (K1b keyed by
    the step), each shard encodes its R/P slice, and the candidate
    embeddings are all_gathered (the per-shard pool: K5 per shard, the
    sketch counts psum-reduced), or, with ``global_candidate_pool``, stay
    sharded and the softmax runs as a ring over every shard's block (K17),
  - the loss is the mean over shards (``pmean``); with one parameter set
    on one controller its gradient is the reference's pmean of gradients.

``PartitionedGraph.build(quantize_features=True)`` stores the reference's
bit-packed int8 rows ``[q D | scale_f | deg]`` (``D + 8`` bytes, the tail
fp32 little-endian): the owner side gathers them (K3, its byte mode at
widths that are not a multiple of 4) and K16's int8 mode decodes them after
the all_to_all (K12's packed-row mode on one shard). ``with_tabularized``
builds, per shard, the deepest-hop aggregate cache (each shard draws its
own rows' ``fanouts[-1]`` slots with K1's / K19's row-offset mode, keyed by
global id; the neighbor rows come by the routed gather and K4 reduces
them; an int8 graph quantizes each chunk's aggregates on the device) fused
into the rows, and the frozen sample tables; the ``cached_hop`` trainers
expand the tree through those tables (K3's expand mode on one shard, one
routed gather a hop for every group at P > 1) and feed the cache to layer 1.
``PartitionedNodeClassificationTrainer`` takes the mean of the per-shard
cross entropies, its labels routed from the row-sharded label column (a
dropped request masked out of the loss and the accuracy).

With capacity sized so no request overflows, a P-shard step computes the
same sample trees as P independent replicated steps on the per-shard
anchor slices with shared random negatives (the draws are keyed by global
id). One shard takes the closed forms of the routed lookups (plain K1 /
K3 calls, no collective), so its union gather is one K3 call (one K12
packed-row gather over int8 rows).

The label edges' features (``DeviceGraph.sup_edge_features`` /
``hard_neg_edge_features``) shard with their CSRs in slot order
(``sup_edge_feats`` / ``hard_edge_feats``); a batch's positives and hard
negatives carry their edges' rows, gathered on the owner (K3) and routed
back with the draw (K16), and the model's edge scorer adds their terms to
the pair scores: in the per-shard pool's loss as the replicated trainer
does, and in the ring as the own block's bias (K17's bias mode). The typed
partitioned trainer is ``training/dist_hetero.py``.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch.losses.count_min_sketch import (
    CountMinSketch,
    cms_add,
    cms_init,
    cms_sampling_probability,
)
from gigl_tpu_torch.losses.losses import cross_entropy_loss
from gigl_tpu_torch.losses.metrics import (
    accuracy,
    hits_at_k,
    mean_reciprocal_rank,
)
from gigl_tpu_torch.losses.sharded_retrieval import (
    ring_blocks,
    ring_candidate_pool,
    ring_own_block_edge_bias,
    ring_retrieval_loss,
)
from gigl_tpu_torch.models.encoders import cached_agg_kind
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.link_prediction import DecoderType, _unit
from gigl_tpu_torch.ops.fanout import masked_reduce
from gigl_tpu_torch.ops.gather import expand_table
from gigl_tpu_torch.ops.hopcache import CACHEABLE_AGGS
from gigl_tpu_torch.ops.quantized import decode_packed_rows
from gigl_tpu_torch.parallel.feature_lookup import (
    answer_draw,
    owner_draw,
    routed_gather,
    routed_sample_neighbors,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dataset import (
    AnchorBatchIterator,
    DeviceGraph,
    NALPBatch,
    draw_random_negatives,
)
from gigl_tpu_torch.training.base import refuse_batch_norm_training
from gigl_tpu_torch.training.early_stop import EarlyStopper
from gigl_tpu_torch.training.trainer import (
    NALPTrainerConfig,
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
    nalp_loss_from_embeddings,
)

logger = logging.getLogger(__name__)

OVERFLOW_POLICIES = ("warn", "raise", "silent", "grow")


def _shard_csr(indptr: np.ndarray, indices: np.ndarray, num_shards: int,
               rows_per_shard: int, weights: Optional[np.ndarray] = None):
    """Split a global CSR into per-shard row-range blocks: (local indptr
    [P, rows + 1] int32 rebased per shard, local indices [P, E_pad] int32
    global neighbor ids, zero-padded to the largest shard's edge count),
    plus the per-shard edge weights [P, E_pad] fp32 (zero-padded) when
    ``weights`` [E] (CSR slot order) is given — or the per-shard edge rows
    [P, E_pad, De] for weights [E, De] (label-edge features). Global row r lives on shard r
    // rows; when N does not divide P the last shards' trailing rows are
    empty."""
    n = indptr.shape[0] - 1
    blocks_ip, blocks_ix, blocks_w = [], [], []
    for p in range(num_shards):
        lo = min(p * rows_per_shard, n)
        hi = min(lo + rows_per_shard, n)
        ip = indptr[lo: hi + 1].astype(np.int64)
        if hi - lo < rows_per_shard:
            ip = np.concatenate(
                [ip, np.full(rows_per_shard - (hi - lo), ip[-1], np.int64)])
        blocks_ip.append((ip - ip[0]).astype(np.int32))
        blocks_ix.append(np.asarray(indices[indptr[lo]: indptr[hi]],
                                    np.int32))
        if weights is not None:
            blocks_w.append(np.asarray(weights[indptr[lo]: indptr[hi]],
                                       np.float32))
    e_pad = max(max(len(b) for b in blocks_ix), 1)
    ix_arr = np.zeros((num_shards, e_pad), np.int32)
    for p, b in enumerate(blocks_ix):
        ix_arr[p, : len(b)] = b
    if weights is None:
        return np.stack(blocks_ip), ix_arr
    w_arr = np.zeros((num_shards, e_pad) + weights.shape[1:], np.float32)
    for p, b in enumerate(blocks_w):
        w_arr[p, : len(b)] = b
    return np.stack(blocks_ip), ix_arr, w_arr


def apply_overflow_policy(trainer, count: int) -> None:
    """Routed-lookup overflow handling: add ``count`` dropped requests to
    ``trainer.overflow_total`` and act per ``trainer.overflow_policy``
    (warn | raise | silent | grow — grow doubles ``capacity_factor``, which
    the next lookup reads; the dropped requests of this chunk are already
    masked out of the loss)."""
    if not count:
        return
    trainer.overflow_total += int(count)
    msg = (f"routed lookup dropped {int(count)} requests this chunk "
           f"(bucket capacity overflow — skewed access pattern); "
           f"raise capacity_factor above {trainer.capacity_factor}")
    policy = trainer.overflow_policy
    if policy == "raise":
        raise RuntimeError(msg)
    if policy == "grow":
        trainer.capacity_factor *= 2.0
        logger.warning("%s — growing capacity_factor to %.1f", msg,
                       trainer.capacity_factor)
    elif policy == "warn":
        logger.warning(msg)


def _per_shard(stacked: np.ndarray, device: torch.device
               ) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(b)).to(device)
            for b in stacked]


@dataclass
class PartitionedGraph:
    """A range-partitioned graph: shard p's tensors are entry p of each
    list, on the mesh's device.

    feat_deg[p]: [rows, D + 1] fp32 — shard p's feature rows with the
    node's message in-degree fused as the LAST column, so hydration and
    the degree lookup are one routed gather. With ``quantized``: [rows, D +
    8] int8 — per-row symmetric int8 features with the fp32 scale and the
    fp32 degree bit-packed little-endian into the last 8 bytes (the
    reference's layout, 4x fewer bytes per shard and per all_to_all).
    With the deepest-hop cache fused in (``cache_dim`` Dc > 0,
    :meth:`with_tabularized`): fp32 ``[feat D | deg | cache Dc]``, int8
    ``[qfeat D | qcache Dc | scale_f | scale_c | deg]``. msg_* / sup_* /
    hard_*: the per-shard CSR blocks of :func:`_shard_csr` (supervision and
    hard negatives None when the graph has none). msg_weights[p]: [E_pad]
    fp32, shard p's message-edge sampling weights in slot order (None when
    the graph has none). labels[p]: [rows, 1] int32 node labels (None
    without). sample_tables: one per-shard list of [rows, k] int32 frozen
    sample tables (-1 in invalid slots) per distinct in-tree fanout, in
    the ascending order of ``table_fanouts``. sup_edge_feats[p] /
    hard_edge_feats[p]: [E_pad, De] fp32, the label edges' features of
    shard p's supervision / hard-negative blocks in slot order (None
    without), drawn with the positives and hard negatives."""

    feat_deg: List[torch.Tensor]
    msg_indptr: List[torch.Tensor]
    msg_indices: List[torch.Tensor]
    sup_indptr: Optional[List[torch.Tensor]]
    sup_indices: Optional[List[torch.Tensor]]
    hard_indptr: Optional[List[torch.Tensor]]
    hard_indices: Optional[List[torch.Tensor]]
    num_nodes: int
    rows_per_shard: int
    feat_dim: int
    msg_weights: Optional[List[torch.Tensor]] = None
    quantized: bool = False
    labels: Optional[List[torch.Tensor]] = None
    cache_dim: int = 0
    sample_tables: Optional[Tuple[List[torch.Tensor], ...]] = None
    table_fanouts: Optional[Tuple[int, ...]] = None
    sup_edge_feats: Optional[List[torch.Tensor]] = None
    hard_edge_feats: Optional[List[torch.Tensor]] = None

    @property
    def num_shards(self) -> int:
        return len(self.feat_deg)

    @property
    def device(self) -> torch.device:
        return self.feat_deg[0].device

    @classmethod
    def build(cls, device_graph: DeviceGraph, mesh: Mesh,
              quantize_features: bool = False) -> "PartitionedGraph":
        """Partition a DeviceGraph across ``mesh``'s shards, onto the
        mesh's device (CUDA unless the mesh was made for the CPU); with
        ``quantize_features`` the rows are the reference's bit-packed int8
        rows, quantized on the host with its numpy recipe."""
        dg = device_graph
        if not isinstance(dg.node_features, torch.Tensor):
            raise ValueError(
                "PartitionedGraph.build takes a DeviceGraph with fp32 node "
                "features; quantize_features=True stores int8 rows")
        p = mesh.num_shards
        n = dg.num_nodes
        rows = -(-n // p)
        feats = dg.node_features.detach().cpu().numpy().astype(np.float32)
        d = feats.shape[1]
        deg = (dg.degrees.cpu().numpy().astype(np.float32)
               if dg.degrees is not None else np.zeros((n,), np.float32))
        if quantize_features:
            absmax = np.maximum(np.abs(feats).max(axis=1, keepdims=True),
                                1e-12)
            scale = (absmax / 127.0).astype(np.float32)          # [n, 1]
            q = np.clip(np.rint(feats / scale), -127, 127).astype(np.int8)
            tail = np.concatenate(
                [scale.view(np.uint8).reshape(n, 4),
                 deg.astype(np.float32).reshape(n, 1).view(
                     np.uint8).reshape(n, 4)], axis=1).view(np.int8)
            fd = np.zeros((p * rows, d + 8), np.int8)
            fd[:n, :d] = q
            fd[:n, d:] = tail
        else:
            fd = np.zeros((p * rows, d + 1), np.float32)
            fd[:n, :d] = feats
            fd[:n, d] = deg
        labels = None
        if dg.node_labels is not None:
            lab = np.zeros((p * rows, 1), np.int32)
            lab[:n, 0] = dg.node_labels.cpu().numpy().astype(np.int32)
            labels = _per_shard(lab.reshape(p, rows, 1), mesh.device)

        def blocks(csr, w):
            """The CSR's per-shard blocks (indptr, indices and, given its
            slot-aligned edge weights [E] or label-edge rows [E, De], those
            too), or Nones."""
            if csr is None:
                return None, None, None
            out = _shard_csr(csr.indptr.cpu().numpy(),
                             csr.indices.cpu().numpy(), p, rows,
                             weights=None if w is None else w.cpu().numpy())
            return tuple(_per_shard(a, mesh.device) for a in out) + (
                None,) * (3 - len(out))

        msg_ip, msg_ix, msg_w = blocks(dg.message_csr,
                                       dg.message_csr.edge_weights)
        sup_ip, sup_ix, sup_ef = blocks(dg.supervision_csr,
                                        dg.sup_edge_features)
        hard_ip, hard_ix, hard_ef = blocks(dg.hard_neg_csr,
                                           dg.hard_neg_edge_features)
        return cls(feat_deg=_per_shard(fd.reshape(p, rows, -1), mesh.device),
                   msg_indptr=msg_ip, msg_indices=msg_ix,
                   sup_indptr=sup_ip, sup_indices=sup_ix,
                   hard_indptr=hard_ip, hard_indices=hard_ix,
                   num_nodes=n, rows_per_shard=rows, feat_dim=d,
                   msg_weights=msg_w, quantized=bool(quantize_features),
                   labels=labels, sup_edge_feats=sup_ef,
                   hard_edge_feats=hard_ef)

    def decode_rows(self, rows: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gathered table rows of the uncached layout -> (features [G, D]
        fp32, degrees [G]); int8 rows dequantize by their packed scale."""
        d = self.feat_dim
        if not self.quantized:
            return rows[:, :d], rows[:, d]
        return decode_packed_rows(rows, d)[:2]

    def split_rows(self, rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
        """Gathered table rows -> (features [G, D], degrees [G], cache [G,
        Dc] or None) for either layout (see ``cache_dim``)."""
        d, dc = self.feat_dim, self.cache_dim
        if self.quantized:
            return decode_packed_rows(rows, d, dc)
        if dc == 0:
            return rows[:, :d], rows[:, d], None
        return rows[:, :d], rows[:, d], rows[:, d + 1:]

    def gather_split(self, mesh: Mesh, ids: Sequence[torch.Tensor],
                     capacity_factor: float):
        """Every shard's ``ids`` rows split as :meth:`split_rows` does, by
        one routed gather (int8 rows decoded in its unroute pass, K16's int8
        mode, or K12's packed-row mode on one shard): (per shard (features,
        degrees, cache or None), per shard ok)."""
        if self.quantized:
            return routed_gather(mesh, self.feat_deg, ids,
                                 capacity_factor=capacity_factor,
                                 decode=(self.feat_dim, self.cache_dim))
        rows, ok = routed_gather(mesh, self.feat_deg, ids,
                                 capacity_factor=capacity_factor)
        return [self.split_rows(r) for r in rows], ok

    def with_tabularized(
        self,
        mesh: Mesh,
        *,
        fanouts: Sequence[int],
        agg: str = "mean",
        seed: int = 0,
        capacity_factor: float = 4.0,
        chunk: int = 4096,
        method: str = "uniform",
    ) -> "PartitionedGraph":
        """A copy with the tabularized tables built SHARDED over the mesh
        (the partitioned analog of ``DeviceGraph.with_neighbor_cache``).

        Per shard: the deepest-hop aggregate cache — the shard draws
        ``fanouts[-1]`` neighbors for each of its own rows (K1's or, with
        ``method`` weighted / top_k, K19's row-offset mode at hop
        ``len(fanouts)``, keyed by the global id, so the draws are the
        replicated builder's), hydrates them by the routed gather and
        reduces them with K4 (mean | sum; gcn: the rows scaled by
        rsqrt(deg + 1), then summed), ``chunk`` rows a round as the
        reference does — fused into the feature rows; on an int8 graph each
        chunk's aggregates are quantized on the device (``torch.round``,
        half to even as ``jnp.round``), so the fp32 cache never exists
        whole. And one frozen [rows, k] sample table per distinct fanout in
        ``fanouts[:-1]`` (hop 1, -1 in invalid slots). Raises if the
        cache's routed gather dropped a request."""
        if method != "uniform" and self.msg_weights is None:
            raise ValueError(f"method={method!r} needs a PartitionedGraph "
                             f"built from a DeviceGraph with edge weights")
        if self.cache_dim:
            raise ValueError(
                "already tabularized; rebuild (refresh) from the base "
                "PartitionedGraph — the trainer keeps it as pg_base")
        if agg not in CACHEABLE_AGGS:
            raise ValueError(f"agg={agg!r} not in {CACHEABLE_AGGS}")
        if len(fanouts) < 2:
            raise ValueError("tabularized mode needs >= 2 hops (the deepest"
                             " hop is cached, earlier hops use tables)")
        if mesh.num_shards != self.num_shards or mesh.device != self.device:
            raise ValueError("the graph is not partitioned over this mesh")
        p, rows, d = self.num_shards, self.rows_per_shard, self.feat_dim
        k_last = int(fanouts[-1])
        hop_key = len(fanouts)
        tab_ks = tuple(sorted({int(k) for k in fanouts[:-1]}))
        chunk = min(chunk, rows)
        n_chunks = -(-rows // chunk)
        dev = self.device
        w = self.msg_weights if method != "uniform" else [None] * p
        local = torch.arange(n_chunks * chunk, dtype=torch.int32,
                             device=dev).clamp(max=rows - 1)
        parts: List[list] = [[] for _ in range(p)]
        ovf = torch.zeros((), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for c in range(n_chunks):
                lid = local[c * chunk:(c + 1) * chunk]
                drawn = [owner_draw(self.msg_indptr[s], self.msg_indices[s],
                                    lid + s * rows, k_last, s * rows, seed,
                                    hop_key, method, w[s])[:2]
                         for s in range(p)]
                vals, oks = self.gather_split(
                    mesh, [nbr.reshape(-1) for nbr, _ in drawn],
                    capacity_factor)
                for s in range(p):
                    x, deg_n, _ = vals[s]
                    # fp32 rows split into views: K4 reads contiguous rows
                    x = x.contiguous().reshape(chunk, k_last, d)
                    m = drawn[s][1] & oks[s].reshape(chunk, k_last)
                    ovf = ovf + (~oks[s]).sum()
                    if agg == "gcn":
                        x = x * torch.rsqrt(
                            deg_n.reshape(chunk, k_last) + 1.0)[..., None]
                    if d % 4:
                        # K4 reduces rows of 16-byte multiples: zero
                        # columns pad an odd width and are cut off again
                        x = torch.nn.functional.pad(x, (0, -d % 4))
                    out = masked_reduce(x, m, "mean" if agg == "mean"
                                        else "sum")[:, :d]
                    if self.quantized:
                        absmax = torch.clamp(
                            out.abs().amax(dim=1, keepdim=True), min=1e-12)
                        scale_c = absmax / 127.0
                        out = (torch.clamp(torch.round(out / scale_c), -127,
                                           127).to(torch.int8), scale_c)
                    parts[s].append(out)
            n_drop = int(ovf)
            if n_drop:
                raise RuntimeError(
                    f"tabularized cache build dropped {n_drop} neighbor "
                    f"feature requests (bucket capacity overflow); raise "
                    f"capacity_factor above {capacity_factor}")
            fused = []
            for s in range(p):
                fd = self.feat_deg[s]
                if not self.quantized:
                    fused.append(torch.cat(
                        [fd, torch.cat(parts[s])[:rows]], dim=1))
                    continue
                qc = torch.cat([q_ for q_, _ in parts[s]])[:rows]
                scale_c = torch.cat([s_ for _, s_ in parts[s]])[:rows, 0]
                tail = fd[:, d:].contiguous().view(torch.float32)  # [rows, 2]
                new_tail = torch.stack([tail[:, 0], scale_c, tail[:, 1]],
                                       dim=1).contiguous().view(torch.int8)
                fused.append(torch.cat([fd[:, :d], qc, new_tail], dim=1))
            gids = [torch.arange(rows, dtype=torch.int32, device=dev) + s * rows
                    for s in range(p)]
            tables = tuple(
                [answer_draw(self.msg_indptr[s], self.msg_indices[s],
                             gids[s], k, s * rows, seed, 1, method, w[s])
                 for s in range(p)] for k in tab_ks)
        return dataclasses.replace(self, feat_deg=fused, cache_dim=d,
                                   sample_tables=tables,
                                   table_fanouts=tab_ks)


Groups = List[List[Tuple[torch.Tensor, int]]]   # per shard: (roots, offset)


class PartitionedNALPTrainer:
    """NALP trainer whose graph and features live partitioned across the
    shards of a :class:`Mesh`; the model's one parameter set drives every
    shard. Anchors arrive as global [B] batches split over the shards
    (B % P == 0). With ``cached_hop`` the trainer keeps the given graph as
    ``pg_base`` and trains over its :meth:`PartitionedGraph.with_tabularized`
    copy (or over the given graph, when it is tabularized already)."""

    def __init__(self, model, pgraph: PartitionedGraph, mesh: Mesh,
                 config: NALPTrainerConfig,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn"):
        p = mesh.num_shards
        if getattr(config, "num_random_negs", 0) % p:
            raise ValueError("num_random_negs must divide the mesh axis size")
        if (getattr(config, "global_candidate_pool", False)
                and getattr(config, "loss_type", "retrieval") != "retrieval"):
            raise ValueError("global_candidate_pool is a retrieval-loss "
                             "contract (ring sampled softmax); margin/"
                             "softmax losses use the per-shard pool")
        if overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(
                "overflow_policy must be warn | raise | silent | grow")
        if config.sampling_method != "uniform" and pgraph.msg_weights is None:
            raise ValueError(
                f"method={config.sampling_method!r} needs a PartitionedGraph "
                "built from a DeviceGraph with edge weights")
        if pgraph.num_shards != p or pgraph.device != mesh.device:
            raise ValueError("the graph is not partitioned over this mesh")
        self.mesh = mesh
        self.device = mesh.device
        self.num_shards = p
        self.model = model.to(self.device).eval()
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        self.capacity_factor = capacity_factor
        self.overflow_policy = overflow_policy
        # Routed-lookup requests dropped by bucket overflow (the RPC-timeout
        # analog), over every train and eval chunk.
        self.overflow_total = 0
        self.pg_base = pgraph
        self._cached = bool(config.cached_hop)
        if self._cached:
            # a link-prediction model wraps its encoder; an NC model is one
            enc = getattr(model, "encoder", model)
            self._cache_agg = cached_agg_kind(enc.conv, enc.conv_kwargs)
            self.pg = pgraph if pgraph.cache_dim else \
                self._tabularized(config.seed)
        else:
            self.pg = pgraph
        rows = pgraph.rows_per_shard
        zeros = [torch.zeros((rows + 1,), dtype=torch.int32,
                             device=self.device) for _ in range(p)]
        # no supervision CSR: positives come from the message CSR; no hard
        # CSR: an all-degree-0 one, so hard draws mask to empty
        self._sup = (pgraph.sup_indptr or pgraph.msg_indptr,
                     pgraph.sup_indices or pgraph.msg_indices)
        self._hard = (pgraph.hard_indptr or zeros,
                      pgraph.hard_indices or [torch.zeros(
                          (1,), dtype=torch.int32, device=self.device)
                          for _ in range(p)])
        # the label edges' rows, drawn with the positives / hard negatives
        self._sup_ef = pgraph.sup_edge_feats
        self._hard_ef = pgraph.hard_edge_feats

    def _tabularized(self, seed: int) -> PartitionedGraph:
        return self.pg_base.with_tabularized(
            self.mesh, fanouts=self.cfg.fanouts, agg=self._cache_agg,
            seed=seed, capacity_factor=self.capacity_factor,
            method=self.cfg.sampling_method)

    def refresh_cache(self, epoch: int = 0) -> None:
        """Redraw the frozen tabularized tables and cache with the seed of
        ``epoch`` (``cfg.seed + 1_299_709 * epoch``), the analog of
        re-running the reference's Subgraph Sampler; a no-op unless
        ``cached_hop``."""
        if self._cached:
            self.pg = self._tabularized(self.cfg.seed + 1_299_709 * epoch)

    # -- state -----------------------------------------------------------------
    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict) or initialize the weights from
        ``seed``, then build the optimizer (and, with
        ``use_cms_correction``, an empty sketch)."""
        del batch_size
        if params is None:
            init_params(self.model, seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        cms = (cms_init(device=self.device)
               if getattr(self.cfg, "use_cms_correction", False) else None)
        return TrainState(step=0, optimizer=opt, cms=cms)

    def _ids(self, node_ids) -> torch.Tensor:
        if isinstance(node_ids, torch.Tensor):
            return node_ids.to(device=self.device, dtype=torch.int32)
        return torch.as_tensor(np.asarray(node_ids), dtype=torch.int32,
                               device=self.device)

    def _split(self, ids: torch.Tensor) -> List[torch.Tensor]:
        if ids.shape[0] % self.num_shards:
            raise ValueError(f"batch size {ids.shape[0]} not divisible by "
                             f"{self.num_shards} shards")
        return list(ids.reshape(self.num_shards, -1).unbind(0))

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32, device=self.device)

    # -- sampling and encoding -------------------------------------------------
    def _sample_tree(self, roots: Sequence[torch.Tensor], seed_offset: int):
        """Every shard's fanout tree from its ``roots``: (node ids per shard
        per level, masks, dropped requests). Live: owner-routed draws, hop
        index from 1. Tabularized (one shard; see
        :meth:`_sample_trees_joint`): one K3 expand a hop through the frozen
        tables, a hop shallower (layer 1 reads the cache)."""
        ids = [[r.reshape(-1).to(torch.int32)] for r in roots]
        masks = [[torch.ones(i[0].shape, dtype=torch.bool,
                             device=self.device)] for i in ids]
        ovf = self._zero()
        if self._cached:
            for k in self.cfg.fanouts[:-1]:
                table = self.pg.sample_tables[
                    self.pg.table_fanouts.index(int(k))][0]
                nbr, m = expand_table(table, ids[0][-1], masks[0][-1])
                ids[0].append(nbr)
                masks[0].append(m)
            return ids, masks, ovf
        for hop, k in enumerate(self.cfg.fanouts, start=1):
            nbr, m, ok = routed_sample_neighbors(
                self.mesh, self.pg.msg_indptr, self.pg.msg_indices,
                [i[-1].reshape(-1) for i in ids], int(k),
                seed=self.cfg.seed + seed_offset, hop=hop,
                capacity_factor=self.capacity_factor,
                method=self.cfg.sampling_method,
                local_weights=self.pg.msg_weights)
            for s in range(self.num_shards):
                ovf = ovf + (~ok[s]).sum(dtype=torch.int32)
                shape = tuple(ids[s][-1].shape) + (int(k),)
                m_s = m[s].reshape(shape) & masks[s][-1][..., None]
                ids[s].append(torch.where(m_s, nbr[s].reshape(shape), 0))
                masks[s].append(m_s)
        return ids, masks, ovf

    def _sample_trees_joint(self, groups: "Groups"):
        """Tabularized expansion at P > 1 for ALL groups: each shard's group
        roots concatenated into one frontier, one routed gather of the
        frozen table a hop (one round trip a hop for every group), then the
        levels split back into each group's tree. Returns (trees, one
        (ids, masks) per group with ids[shard][level], dropped requests)."""
        p = self.num_shards
        n_groups = len(groups[0])
        roots = [[groups[s][g][0].reshape(-1).to(torch.int32)
                  for g in range(n_groups)] for s in range(p)]
        frontier = [torch.cat(r) for r in roots]
        pmask = [torch.ones(f.shape, dtype=torch.bool, device=self.device)
                 for f in frontier]
        levels = [(frontier, pmask)]
        ovf = self._zero()
        for k in self.cfg.fanouts[:-1]:
            table = self.pg.sample_tables[self.pg.table_fanouts.index(int(k))]
            rows, ok = routed_gather(self.mesh, table, frontier,
                                     capacity_factor=self.capacity_factor)
            nxt, nmask = [], []
            for s in range(p):
                ovf = ovf + (~ok[s]).sum(dtype=torch.int32)
                m = (rows[s] >= 0) & pmask[s][:, None] & ok[s][:, None]
                nxt.append(torch.where(m, rows[s], 0).reshape(-1))
                nmask.append(m.reshape(-1))
            frontier, pmask = nxt, nmask
            levels.append((frontier, pmask))
        trees = []
        offs = [0] * len(levels)
        for g in range(n_groups):
            ids = [[] for _ in range(p)]
            masks = [[] for _ in range(p)]
            shape = tuple(roots[0][g].shape)
            for li, (flat, fmask) in enumerate(levels):
                n_elem = int(np.prod(shape))
                for s in range(p):
                    ids[s].append(flat[s][offs[li]:offs[li] + n_elem]
                                  .reshape(shape))
                    masks[s].append(fmask[s][offs[li]:offs[li] + n_elem]
                                    .reshape(shape))
                offs[li] += n_elem
                if li < len(levels) - 1:
                    shape = shape + (int(self.cfg.fanouts[li]),)
            trees.append((ids, masks))
        return trees, ovf

    def _encode(self, vals, levels, masks, roots_shape, train: bool,
                generator):
        """Encode one group of one shard from its hydrated rows ``vals``
        (features, degrees, cache or None)."""
        feat_rows, deg_rows, cache_rows = vals
        d = self.pg.feat_dim
        feats, degs, cached = [], [], []
        offset = 0
        for lvl in levels:
            sl = slice(offset, offset + lvl.numel())
            offset += lvl.numel()
            shape = tuple(lvl.shape)
            feats.append(feat_rows[sl].contiguous().reshape(shape + (d,)))
            degs.append(deg_rows[sl].reshape(shape))
            if cache_rows is not None:
                cached.append(cache_rows[sl].contiguous().reshape(
                    shape + (self.pg.cache_dim,)))
        emb = self.model(feats, masks, None, train=train, hop_degrees=degs,
                         cached_agg=cached if self._cached else None,
                         generator=generator)
        return emb.reshape(tuple(roots_shape) + (emb.shape[-1],))

    def _draw_trees(self, groups: Groups):
        """Every shard's trees for its (roots, seed offset) groups: (one
        (ids, masks) per group with ids[shard][level], dropped requests)."""
        if self._cached and self.num_shards > 1:
            return self._sample_trees_joint(groups)
        trees, ovf = [], self._zero()
        for g in range(len(groups[0])):
            ids, masks, o = self._sample_tree(
                [groups[s][g][0] for s in range(self.num_shards)],
                groups[0][g][1])
            trees.append((ids, masks))
            ovf = ovf + o
        return trees, ovf

    @staticmethod
    def _union_ids(trees, shard: int) -> torch.Tensor:
        """A shard's tree ids, per group all its levels in turn: the order
        of the one hydration gather."""
        return torch.cat([lvl.reshape(-1) for ids, _ in trees
                          for lvl in ids[shard]])

    def _encode_trees(self, trees, groups: Groups, vals, train: bool,
                      generators=None) -> List[List[torch.Tensor]]:
        """Encode every shard's groups from the hydrated rows of its union
        (``vals[shard]``: features, degrees, cache or None, in the order
        of :meth:`_union_ids`): embeddings per shard per group."""
        p = self.num_shards
        gens = list(generators) if generators is not None else [None] * p
        outs: List[List[torch.Tensor]] = [[] for _ in range(p)]
        for s in range(p):
            offset = 0
            for g, (ids, masks) in enumerate(trees):
                n = sum(lvl.numel() for lvl in ids[s])
                sl = slice(offset, offset + n)
                outs[s].append(self._encode(
                    tuple(None if v is None else v[sl] for v in vals[s]),
                    ids[s], masks[s], groups[s][g][0].shape, train, gens[s]))
                offset += n
        return outs

    def _encode_groups(self, groups: Groups, train: bool,
                       generators: Optional[Sequence] = None):
        """Sample every shard's trees for its (roots, seed offset) groups,
        hydrate the UNION of each shard's tree ids with one routed gather,
        and encode: (embeddings per shard per group, dropped requests)."""
        trees, ovf = self._draw_trees(groups)
        vals, ok = self.pg.gather_split(
            self.mesh,
            [self._union_ids(trees, s) for s in range(self.num_shards)],
            self.capacity_factor)
        ovf = ovf + sum((~o).sum(dtype=torch.int32) for o in ok)
        return self._encode_trees(trees, groups, vals, train, generators), ovf

    # -- batches and losses ----------------------------------------------------
    def _make_batches(self, anchors: Sequence[torch.Tensor], step: int):
        """Every shard's NALP batch: routed positive (hop 1_000_003 + step)
        and hard-negative (2_000_003 + step) draws, with the drawn label
        edges' rows when the graph has them (the same round trip: K3 on the
        owner, K16), and the random negatives, the same global draw on
        every shard (K1b at 3_000_017 + step). Returns (batches, dropped
        requests)."""
        cfg = self.cfg
        pos, pos_mask, ok_p, *pos_ef = routed_sample_neighbors(
            self.mesh, *self._sup, list(anchors), cfg.num_positives,
            seed=cfg.seed, hop=1_000_003 + step,
            capacity_factor=self.capacity_factor,
            local_edge_feats=self._sup_ef)
        pos_ef = pos_ef[0] if pos_ef else [None] * len(anchors)
        ovf = sum((~o).sum(dtype=torch.int32) for o in ok_p)
        rand = draw_random_negatives(cfg.num_random_negs, self.pg.num_nodes,
                                     seed=cfg.seed, step=step,
                                     device=self.device)
        h = cfg.num_hard_negs
        hard_ef = [None] * len(anchors)
        if h > 0:
            hard, hard_mask, ok_h, *ef = routed_sample_neighbors(
                self.mesh, *self._hard, list(anchors), h, seed=cfg.seed,
                hop=2_000_003 + step, capacity_factor=self.capacity_factor,
                local_edge_feats=self._hard_ef)
            hard_ef = ef[0] if ef else hard_ef
            ovf = ovf + sum((~o).sum(dtype=torch.int32) for o in ok_h)
        else:
            hard = [torch.zeros(a.shape + (0,), dtype=torch.int32,
                                device=self.device) for a in anchors]
            hard_mask = [torch.zeros(a.shape + (0,), dtype=torch.bool,
                                     device=self.device) for a in anchors]
        batches = [NALPBatch(anchors=a.to(torch.int32), pos=pos[s],
                             pos_mask=pos_mask[s], hard_neg=hard[s],
                             hard_neg_mask=hard_mask[s], random_neg=rand,
                             pos_edge_feats=pos_ef[s],
                             hard_neg_edge_feats=hard_ef[s])
                   for s, a in enumerate(anchors)]
        return batches, ovf

    def _rand_local(self, rand: torch.Tensor, shard: int) -> torch.Tensor:
        r_per = self.cfg.num_random_negs // self.num_shards
        return rand[shard * r_per: (shard + 1) * r_per]

    @staticmethod
    def _plus(cms: CountMinSketch, table: torch.Tensor, total: torch.Tensor
              ) -> CountMinSketch:
        return CountMinSketch(cms.table + table, cms.total + total)

    def _psum_delta(self, ids: Sequence[torch.Tensor], cms: CountMinSketch
                    ) -> CountMinSketch:
        """The sketch plus the psum over shards of each shard's count delta
        of ``ids[shard]`` (K13 per shard, into an empty sketch)."""
        zero = CountMinSketch(torch.zeros_like(cms.table),
                              torch.zeros_like(cms.total))
        deltas = [cms_add(zero, i) for i in ids]
        return self._plus(cms, self.mesh.psum([d.table for d in deltas])[0],
                          self.mesh.psum([d.total for d in deltas])[0])

    def _groups(self, batches: Sequence[NALPBatch], hard: bool) -> Groups:
        """Every shard's encode groups: anchors, positives, its slice of the
        random negatives and, with ``hard``, the hard negatives."""
        groups = []
        for s, b in enumerate(batches):
            g = [(b.anchors, 0), (b.pos, 1),
                 (self._rand_local(b.random_neg, s), 2)]
            if hard:
                g.append((b.hard_neg, 3))
            groups.append(g)
        return groups

    def loss_and_sketch(self, anchors, step: int,
                        cms: Optional[CountMinSketch] = None,
                        generators=None):
        """(train-mode global mean loss of ``step`` for the global [B]
        ``anchors``, differentiable in the model's weights; the sketch with
        the step's candidates added, or None; the routed requests dropped,
        a device scalar)."""
        refuse_batch_norm_training(self.model)
        batches, ovf = self._make_batches(self._split(self._ids(anchors)),
                                          step)
        embs, ovf2 = self._encode_groups(
            self._groups(batches, self.cfg.num_hard_negs > 0), True,
            generators)
        loss, cms = self._loss_from_embeddings(batches, embs, cms)
        return loss, cms, ovf + ovf2

    def _loss_from_embeddings(self, batches: Sequence[NALPBatch], embs,
                              cms: Optional[CountMinSketch]):
        """(the global mean loss of every shard's batch from its groups'
        embeddings: the ring or the per-shard pool; the sketch with the
        step's candidates added, or None)."""
        cfg = self.cfg
        if cfg.global_candidate_pool:
            return self._ring_loss(batches, embs, cms)
        rand = self.mesh.all_gather([e[2] for e in embs])
        if cms is not None and cfg.loss_type == "retrieval":
            # own candidates (positives, hard negatives) psum-reduced; the
            # shared random negatives, the same on every shard, once
            own = [torch.cat([b.pos.reshape(-1), b.hard_neg.reshape(-1)])
                   for b in batches]
            counted = self._psum_delta(own, cms)
            shared = cms_add(CountMinSketch(torch.zeros_like(cms.table),
                                            torch.zeros_like(cms.total)),
                             batches[0].random_neg)
            cms = self._plus(counted, shared.table, shared.total)
        losses = []
        for s, b in enumerate(batches):
            q, pos, _ = embs[s][:3]
            hard = embs[s][3] if cfg.num_hard_negs > 0 else None
            loss, _ = nalp_loss_from_embeddings(
                self.model, cfg, b, q, pos, hard, rand[s], cms,
                counted=True)
            losses.append(loss)
        return self.mesh.pmean(losses)[0], cms

    def _ring_loss(self, batches: Sequence[NALPBatch], embs,
                   cms: Optional[CountMinSketch]):
        """The global-candidate-pool retrieval loss: every shard's query
        rows against every shard's candidate block, folded round the ring
        (K17); the global mean psum(ce) / psum(count) as the pmean of
        ce_sum * P / psum(count). With the model's edge scorer, the label
        edges' score terms ride on the own block (K17's bias mode)."""
        if self.model.decoder.is_mlp:
            raise NotImplementedError(
                "the global candidate pool folds inner-product scores (K17); "
                "an MLP decoder's ring is not ported")
        cfg, p = self.cfg, self.num_shards
        cands, cols = [], []
        for s, b in enumerate(batches):
            q, pos, rand_l = embs[s][:3]
            hard = embs[s][3] if cfg.num_hard_negs > 0 else None
            c, col = ring_candidate_pool(b, pos, hard, rand_l,
                                         self._rand_local(b.random_neg, s))
            cands.append(c)
            cols.append(col)
        if cms is not None:
            # every shard's candidates appear once in the global pool
            cms = self._psum_delta([c.ids for c in cols], cms)
            cols = [dataclasses.replace(c, log_q=torch.log(torch.clamp(
                cms_sampling_probability(cms, c.ids), min=1e-10)).to(
                    torch.float32)) for c in cols]
        if self.model.decoder.decoder_type == DecoderType.COSINE:
            cands = [_unit(c) for c in cands]
        cand_views, col_views = ring_blocks(self.mesh, cands), ring_blocks(
            self.mesh, cols)
        sums, counts = [], []
        for s, b in enumerate(batches):
            n_pos = b.pos.shape[1]
            q_rows = embs[s][0].repeat_interleave(n_pos, dim=0)
            if self.model.decoder.decoder_type == DecoderType.COSINE:
                q_rows = _unit(q_rows)
            bias = None
            if getattr(self.model, "edge_scorer", None) is not None:
                bias = ring_own_block_edge_bias(self.model.edge_score, b)
            ce_sum, count = ring_retrieval_loss(
                q_rows, cand_views[s], col_views[s],
                temperature=cfg.temperature,
                label_local_cols=torch.arange(
                    q_rows.shape[0], dtype=torch.int32, device=self.device),
                query_ids=b.anchors.repeat_interleave(n_pos),
                own_pos_ids=b.pos.reshape(-1),
                query_mask=b.pos_mask.reshape(-1),
                remove_accidental_hits=cfg.remove_accidental_hits,
                own_block_bias=bias)
            sums.append(ce_sum)
            counts.append(count)
        total = self.mesh.psum(counts)[0].to(torch.float32)
        losses = [c * p / torch.clamp(total, min=1.0) for c in sums]
        return self.mesh.pmean(losses)[0], cms

    # -- training --------------------------------------------------------------
    def _generators(self, generators):
        if isinstance(generators, torch.Generator):
            return [generators] * self.num_shards
        return generators

    def _step(self, state: TrainState, anchors: torch.Tensor, generators):
        state.optimizer.zero_grad(set_to_none=True)
        loss, cms, ovf = self.loss_and_sketch(anchors, state.step, state.cms,
                                              generators)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1, cms=cms), loss.detach(), \
            ovf

    def train_steps(self, state: TrainState, anchors_kb, generators=None
                    ) -> Tuple[TrainState, torch.Tensor]:
        """``anchors_kb.shape[0]`` consecutive steps over global [K, B]
        anchors; returns the state and the per-step losses [K] on the
        device. ``generators``: one ``torch.Generator`` per shard for
        dropout (or one shared by all). The dropped requests are read once
        at the end (one host sync) and handled per ``overflow_policy``."""
        anchors_kb = self._ids(anchors_kb)
        generators = self._generators(generators)
        losses = torch.empty((anchors_kb.shape[0],), dtype=torch.float32,
                             device=self.device)
        ovf = self._zero()
        for k in range(anchors_kb.shape[0]):
            state, losses[k], o = self._step(state, anchors_kb[k],
                                             generators)
            ovf = ovf + o
        apply_overflow_policy(self, int(ovf))
        return state, losses

    def train_step(self, state: TrainState, anchors, generators=None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One step (``train_steps`` of one batch)."""
        state, losses = self.train_steps(
            state, self._ids(anchors)[None, :], generators)
        return state, losses[0]

    # -- evaluation and inference ------------------------------------------------
    def _eval_step(self, anchors: torch.Tensor, step: int):
        """Positives ranked against the shared random negatives: (rr sum,
        hits sums, count, dropped requests), summed over shards."""
        batches, ovf = self._make_batches(self._split(anchors), step)
        embs, ovf2 = self._encode_groups(self._groups(batches, False), False)
        return (*self._eval_from_embeddings(batches, embs), ovf + ovf2)

    def _eval_from_embeddings(self, batches: Sequence[NALPBatch], embs):
        """(rr sum, hits sums, count) of every shard's batch from its
        groups' embeddings, summed over shards."""
        rand = self.mesh.all_gather([e[2] for e in embs])
        rr_t, hits_t, cnt_t = [], [], []
        for s, b in enumerate(batches):
            q, pos = embs[s][:2]
            n_pos = pos.shape[1]
            pos_flat = self.model.decode(q[:, None, :], pos).reshape(-1)
            neg_rep = self.model.decode_all_pairs(q, rand[s]) \
                .repeat_interleave(n_pos, dim=0)
            mask_flat = b.pos_mask.reshape(-1)
            neg_mask = b.pos.reshape(-1)[:, None] != b.random_neg[None, :]
            rr, cnt = mean_reciprocal_rank(pos_flat, neg_rep,
                                           pos_mask=mask_flat,
                                           neg_mask=neg_mask)
            hits, _ = hits_at_k(pos_flat, neg_rep, self.cfg.eval_ks,
                                pos_mask=mask_flat, neg_mask=neg_mask)
            rr_t.append(rr)
            hits_t.append(torch.stack([hits[int(k)]
                                       for k in self.cfg.eval_ks]))
            cnt_t.append(cnt)
        psum = self.mesh.psum
        return psum(rr_t)[0], psum(hits_t)[0], psum(cnt_t)[0]

    def evaluate(self, anchor_batches, step: int = 0) -> Dict[str, float]:
        """MRR and hits@k over ``anchor_batches`` (batch i keyed by step +
        i, each cut to a multiple of the shard count); one host sync at
        the end."""
        parts = []
        with torch.inference_mode():
            for i, a in enumerate(anchor_batches):
                a = np.asarray(a)
                a = a[: len(a) // self.num_shards * self.num_shards]
                if len(a):
                    parts.append(self._eval_step(self._ids(a), step + i))
            if parts:
                rr, hits, cnt, ovf = (torch.stack(x).sum(0).cpu()
                                      for x in zip(*parts))
        if not parts:
            rr, cnt, ovf = 0.0, 0.0, 0
            hits = np.zeros(len(self.cfg.eval_ks))
        apply_overflow_policy(self, int(ovf))
        cnt_total = max(float(cnt), 1.0)
        out = {"mrr": float(rr) / cnt_total}
        for i, k in enumerate(self.cfg.eval_ks):
            out[f"hits@{k}"] = float(hits[i]) / cnt_total
        return out

    def encode_batch(self, node_ids) -> torch.Tensor:
        """Inference embeddings of ``node_ids`` over the partitioned graph
        (padded with node 0 to a multiple of the shard count; the pad rows
        dropped)."""
        ids = self._ids(node_ids).reshape(-1)
        m = ids.shape[0]
        pad = -(-m // self.num_shards) * self.num_shards - m
        ids = torch.cat([ids, ids.new_zeros((pad,))])
        with torch.inference_mode():
            embs, _ = self._encode_groups(
                [[(part, 0)] for part in self._split(ids)], False)
            return torch.cat([e[0] for e in embs])[:m]

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
        """The NALP train loop (``fit_loop.nalp_fit_loop``) over the
        partitioned graph: the shard count drives batch divisibility and
        the val padding."""
        from gigl_tpu_torch.training.fit_loop import nalp_fit_loop

        return nalp_fit_loop(
            self, state, train_anchors, val_anchors,
            batch_size=batch_size, num_epochs=num_epochs,
            val_every_n_batches=val_every_n_batches,
            num_val_batches=num_val_batches,
            early_stop_patience=early_stop_patience, log_every=log_every,
            scalar_logger=scalar_logger, checkpoint_dir=checkpoint_dir,
            num_shards=self.num_shards)


class PartitionedNodeClassificationTrainer(PartitionedNALPTrainer):
    """Supervised node classification over the PARTITIONED graph (the
    reference's v2 loader serves node classification through the same
    routed sampling and hydration as link prediction). Each shard encodes
    its slice of the anchors, its labels come by a routed gather of the
    row-sharded label column (a dropped request is masked out of the cross
    entropy and the accuracy), and the loss is the mean of the per-shard
    mean cross entropies. The model is an encoder whose output width is
    the number of classes; ``config`` a ``NodeClassificationTrainerConfig``
    (fanouts, seed, ``cached_hop``, ``sampling_method``). The draws are keyed
    as the replicated ``NodeClassificationTrainer``'s (the config's seed on
    every step)."""

    def __init__(self, model, pgraph: PartitionedGraph, mesh: Mesh, config,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn"):
        if pgraph.labels is None:
            raise ValueError("PartitionedGraph has no labels; build from a "
                             "DeviceGraph with node_labels")
        super().__init__(model, pgraph, mesh, config,
                         optimizer_args=optimizer_args,
                         capacity_factor=capacity_factor,
                         overflow_policy=overflow_policy)

    def _logits(self, nodes, train: bool, generators=None):
        """Every shard's (logits, labels, ok) for its slice of the global
        ``nodes``, and the routed requests dropped."""
        parts = self._split(self._ids(nodes).reshape(-1))
        embs, ovf = self._encode_groups([[(part, 0)] for part in parts],
                                        train, generators)
        labels, ok = routed_gather(self.mesh, self.pg.labels, parts,
                                   capacity_factor=self.capacity_factor)
        ovf = ovf + sum((~o).sum(dtype=torch.int32) for o in ok)
        return [(e[0], lab[:, 0], o) for e, lab, o in zip(embs, labels, ok)], \
            ovf

    def loss_and_overflow(self, nodes, generators=None):
        """(train-mode loss of the global ``nodes``: the mean over shards of
        each shard's mean cross entropy over its labeled requests,
        differentiable in the model's weights; the requests dropped)."""
        refuse_batch_norm_training(self.model)
        out, ovf = self._logits(nodes, True, generators)
        return self._loss_from_logits(out), ovf

    def _loss_from_logits(self, out) -> torch.Tensor:
        """The mean over shards of each shard's mean cross entropy over its
        labeled requests (``out``: per shard (logits, labels, ok))."""
        losses = []
        for logits, labels, ok in out:
            s, c = cross_entropy_loss(logits, labels, mask=ok)
            losses.append(s / torch.clamp(c.to(torch.float32), min=1.0))
        return self.mesh.pmean(losses)[0]

    def _accuracy_sums(self, out):
        """(correct, counted) over every shard's labeled requests."""
        scores = [accuracy(lg, lab, mask=ok) for lg, lab, ok in out]
        return (self.mesh.psum([c for c, _ in scores])[0],
                self.mesh.psum([n for _, n in scores])[0])

    def _step(self, state: TrainState, nodes: torch.Tensor, generators):
        state.optimizer.zero_grad(set_to_none=True)
        loss, ovf = self.loss_and_overflow(nodes, generators)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach(), ovf

    def evaluate(self, node_batches) -> float:
        """Global accuracy over ``node_batches`` (each cut to a multiple of
        the shard count); one host sync at the end."""
        parts = []
        with torch.inference_mode():
            for b in node_batches:
                b = np.asarray(b)
                b = b[: len(b) // self.num_shards * self.num_shards]
                if not len(b):
                    continue
                out, ovf = self._logits(b, False)
                parts.append((*self._accuracy_sums(out), ovf))
            if parts:
                correct, total, ovf = (torch.stack(x).sum().cpu()
                                       for x in zip(*parts))
        if not parts:
            return 0.0
        apply_overflow_policy(self, int(ovf))
        return float(correct) / max(float(total), 1.0)

    def predict_batch(self, node_ids) -> torch.Tensor:
        """Logits of ``node_ids`` over the partitioned graph (the inference
        path: ``encode_batch``)."""
        return self.encode_batch(node_ids)

    def fit(self, state: TrainState, train_nodes, val_nodes, *,
            batch_size: int, num_epochs: int = 10,
            early_stop_patience: int = 5, log_every: int = 50
            ) -> Tuple[TrainState, Dict[str, float]]:
        """Epochs of shuffled train batches (``AnchorBatchIterator``), a val
        accuracy after each (the val nodes wrapped up to a multiple of the
        shard count, as the reference pads them), early stopping on it; the
        best weights are loaded back. Returns the best val accuracy."""
        p = self.num_shards
        if batch_size % p:
            raise ValueError(f"batch_size {batch_size} must divide the "
                             f"{p}-shard mesh axis")
        val = np.asarray(val_nodes)
        if len(val) == 0:
            raise ValueError("val_nodes is empty")
        val = np.resize(val, -(-len(val) // p) * p)
        it = AnchorBatchIterator(np.asarray(train_nodes), batch_size,
                                 seed=self.cfg.seed)
        stopper = EarlyStopper(patience=early_stop_patience)
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        step = 0
        for epoch in range(num_epochs):
            batches = np.stack(list(it.epoch(epoch)))
            state, losses = self.train_steps(state, batches, generator)
            step += len(batches)
            if log_every:
                logger.info("epoch %d step %d loss %.4f", epoch, step,
                            float(losses[-1]))
            acc = self.evaluate([val])
            logger.info("epoch %d val acc %.4f", epoch, acc)
            snap = {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}
            if stopper.update(acc, snap):
                break
        if stopper.best_state is not None:
            self.model.load_state_dict(stopper.best_state)
        return state, {"accuracy": stopper.best_value or 0.0}
