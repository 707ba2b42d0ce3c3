"""Typed NALP training over a graph PARTITIONED across a mesh of shards (port
of ``gigl_tpu/training/dist_hetero.py``: ``PartitionedHeteroGraph`` and
``PartitionedHeteroNALPTrainer``).

The typed extension of ``training/dist_sampled.py``: every shard holds the
1/P node-range slice of EVERY node type's feature table and of EVERY
(edge type, anchor) CSR that a sampling path uses, each CSR partitioned by
the range of its op's frontier node type (the side the draw starts from),
and the supervision / hard-negative CSRs (with their label edges' rows)
partitioned by the anchor node type's range. One training step is one
program over all shards (``parallel/mesh.py``: a single controller):

  - each node type's op tree is drawn op by op with
    ``routed_sample_neighbors`` (the frontier routed to the owners of its
    node type's rows, K15; the owner's draw keyed as the replicated typed
    sampler's, hop ``depth * 1_000_003 + op index``: K1's row-offset mode,
    or K19's for a weighted / top-k op over the shard's slot-aligned edge
    weights; the ids back through K16), so the trees are the replicated
    ``sample_typed_blocks``' bit for bit; with ``tabularized`` each op is
    one routed gather of its frozen, row-sharded sample table
    (:meth:`PartitionedHeteroGraph.with_sample_tables`, drawn as the
    replicated graph draws them, so the tables are the replicated ones);
  - feature hydration is ONE routed gather per node type over the union of
    that type's tree levels (K15, K3 on the owner, K16);
  - positives and hard negatives come from the label CSRs by routed draws
    (with their label edges' rows, K3 on the owner and K16), random
    negatives of the candidate type by K1b, the same global draw on every
    shard; each shard encodes its R/P slice, and the candidate embeddings
    are all_gathered (the per-shard pool: K5 per shard), or, with
    ``global_candidate_pool``, stay sharded and the softmax runs as a ring
    (K17, its own-block bias mode carrying the label edges' scorer terms);
  - the loss is the mean over shards; with one parameter set on one
    controller its gradient is the reference's pmean of gradients.

The anchor and the candidate node types may differ (bipartite link
prediction). Typed models encode through the block form: HGT (K7 / K7b),
RGCN (K4 / K4b), SimpleHGN (K7 with its relation bias).

``build(features_on_device=False)`` uploads no feature table (the dims are
still recorded): the beyond-HBM typed regime, where every node type's rows
live in host stores and the device holds only the adjacency
(``training/streaming_partitioned.py``); the device-resident trainer
refuses such a graph.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gigl_tpu_torch.losses.metrics import hits_at_k, mean_reciprocal_rank
from gigl_tpu_torch.losses.sharded_retrieval import (
    ring_blocks,
    ring_candidate_pool,
    ring_own_block_edge_bias,
    ring_retrieval_loss,
)
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.models.link_prediction import DecoderType, _unit
from gigl_tpu_torch.parallel.feature_lookup import (
    routed_gather,
    routed_sample_neighbors,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.sampling.hetero_sampler import OpSpec, TypedBlocks
from gigl_tpu_torch.training.dataset import NALPBatch, draw_random_negatives
from gigl_tpu_torch.training.dist_sampled import (
    OVERFLOW_POLICIES,
    _per_shard,
    _shard_csr,
    apply_overflow_policy,
)
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import HeteroNALPTrainerConfig
from gigl_tpu_torch.training.trainer import (
    TrainState,
    clip_by_global_norm_,
    make_optimizer,
    nalp_loss_from_embeddings,
)

logger = logging.getLogger(__name__)

Shards = List[torch.Tensor]   # entry p is shard p's tensor


def _anchor_of(paths: Mapping[str, Sequence[OpSpec]], key: str) -> Dict:
    """``OpSpec.<key>`` -> the frontier node type of the ops that use it."""
    return {getattr(op, key): str(op.frontier_node_type)
            for ops in paths.values() for op in ops}


@dataclass
class PartitionedHeteroGraph:
    """Per-node-type feature shards and per-(edge type, anchor) CSR shards:
    entry p of each list is shard p's, on the mesh's device.

    feats[nt][p]: [rows[nt], D_nt] fp32 (None when built with
    ``features_on_device=False``: the rows are on the host). csr_ip /
    csr_ix[key][p]: [rows + 1] / [E_pad] int32 blocks of the CSR keyed as
    ``HeteroDeviceGraph.csrs`` ("{edge_type}|{anchor}"), partitioned by the
    range of the node type its ops draw from; csr_w[key][p]: [E_pad] fp32
    slot-aligned edge weights of a CSR that an op samples weighted /
    top-k. sup_* / hard_*:
    the supervision / hard-negative CSR blocks partitioned by the anchor
    node type's range (their ids are of the candidate type), sup_ef /
    hard_ef[p] their label edges' rows [E_pad, De] in slot order (None
    without). sample_tables[table_key][p]: [rows, k] int32 frozen sample
    tables (-1 in invalid slots), row-sharded by the op's frontier type."""

    feats: Optional[Dict[str, Shards]]
    csr_ip: Dict[str, Shards]
    csr_ix: Dict[str, Shards]
    sup_ip: Optional[Shards]
    sup_ix: Optional[Shards]
    hard_ip: Optional[Shards]
    hard_ix: Optional[Shards]
    num_nodes: Dict[str, int]
    rows: Dict[str, int]
    feat_dims: Dict[str, int]
    anchor_node_type: str
    sample_tables: Optional[Dict[str, Shards]] = None
    csr_w: Optional[Dict[str, Shards]] = None
    sup_ef: Optional[Shards] = None
    hard_ef: Optional[Shards] = None

    def _some_shards(self) -> Shards:
        """A CSR's blocks (a node type's features when no op samples)."""
        return next(iter(self.csr_ip.values() if self.csr_ip
                         else self.feats.values()))

    @property
    def num_shards(self) -> int:
        return len(self._some_shards())

    @property
    def device(self) -> torch.device:
        return self._some_shards()[0].device

    def device_feats(self, node_type: str) -> Shards:
        """``node_type``'s feature shards; raises for a graph built without
        device features."""
        if self.feats is None:
            raise ValueError(
                "this PartitionedHeteroGraph was built with "
                "features_on_device=False: its feature rows are on the host, "
                "so a device-resident trainer cannot gather them; train it "
                "with StreamingPartitionedHeteroNALPTrainer "
                "(training/streaming_partitioned.py)")
        return self.feats[str(node_type)]

    @classmethod
    def build(cls, hdg: HeteroDeviceGraph,
              paths: Mapping[str, Sequence[OpSpec]], mesh: Mesh, *,
              anchor_node_type: str, features_on_device: bool = True
              ) -> "PartitionedHeteroGraph":
        """Partition ``hdg`` across ``mesh``'s shards, onto the mesh's
        device: every node type's features, every CSR an op of ``paths``
        uses (by its frontier type's range, with its edge weights when it
        has them), and the label CSRs with their edges' rows (by the
        anchor type's range). ``features_on_device=False``: no feature
        upload (``feats`` None, ``feat_dims`` still recorded)."""
        p, dev = mesh.num_shards, mesh.device
        rows = {nt: -(-int(n) // p) for nt, n in hdg.num_nodes.items()}
        feats, dims = ({} if features_on_device else None), {}
        for nt, f in hdg.node_features.items():
            dims[nt] = int(f.shape[1])
            if not features_on_device:
                continue
            f = (f.detach().cpu().numpy() if isinstance(f, torch.Tensor)
                 else np.asarray(f)).astype(np.float32)
            pad = np.zeros((p * rows[nt], f.shape[1]), np.float32)
            pad[: f.shape[0]] = f
            feats[nt] = _per_shard(pad.reshape(p, rows[nt], -1), dev)

        def blocks(csr, nt, w=None):
            out = _shard_csr(csr.indptr.cpu().numpy(),
                             csr.indices.cpu().numpy(), p, rows[nt],
                             weights=None if w is None else w.cpu().numpy())
            return tuple(_per_shard(a, dev) for a in out) + (None,) * (
                3 - len(out))

        anchor_of = _anchor_of(paths, "csr_key")
        csr_ip, csr_ix, csr_w = {}, {}, {}
        for key, csr in hdg.csrs.items():
            if key not in anchor_of:
                continue  # a CSR no path uses
            ip, ix, w = blocks(csr, anchor_of[key], csr.edge_weights)
            csr_ip[key], csr_ix[key] = ip, ix
            if w is not None:
                csr_w[key] = w
        a_nt = str(anchor_node_type)
        sup_ip = sup_ix = sup_ef = hard_ip = hard_ix = hard_ef = None
        if hdg.supervision_csr is not None:
            sup_ip, sup_ix, sup_ef = blocks(hdg.supervision_csr, a_nt,
                                            hdg.sup_edge_features)
        if hdg.hard_neg_csr is not None:
            hard_ip, hard_ix, hard_ef = blocks(hdg.hard_neg_csr, a_nt,
                                               hdg.hard_neg_edge_features)
        return cls(feats=feats, csr_ip=csr_ip, csr_ix=csr_ix,
                   sup_ip=sup_ip, sup_ix=sup_ix, hard_ip=hard_ip,
                   hard_ix=hard_ix,
                   num_nodes={nt: int(n) for nt, n in hdg.num_nodes.items()},
                   rows=rows, feat_dims=dims, anchor_node_type=a_nt,
                   csr_w=csr_w or None, sup_ef=sup_ef, hard_ef=hard_ef)

    def with_sample_tables(self, hdg: HeteroDeviceGraph,
                           paths: Mapping[str, Sequence[OpSpec]],
                           mesh: Mesh, *, seed: int = 0
                           ) -> "PartitionedHeteroGraph":
        """A copy with one frozen sample table per (CSR, fanout, method)
        that ``paths`` use, ROW-SHARDED by the op's frontier node type. The
        tables are drawn by the replicated graph's
        ``HeteroDeviceGraph.with_sample_tables`` (K1 / K19 keyed by global
        id), so the partitioned tabularized draws are the replicated ones;
        ``hdg`` supplies the whole CSRs at build time. A new seed is a
        re-run of the sampler."""
        p, dev = self.num_shards, self.device
        anchor_of = _anchor_of(paths, "table_key")
        tabbed = hdg.with_sample_tables(dict(paths), seed=seed)
        tables = dict(self.sample_tables or {})
        for key, table in tabbed.sample_tables.items():
            if key in tables or key not in anchor_of:
                continue
            nt = anchor_of[key]
            t = table.cpu().numpy()
            pad = np.full((p * self.rows[nt], t.shape[1]), -1, np.int32)
            pad[: t.shape[0]] = t
            tables[key] = _per_shard(pad.reshape(p, self.rows[nt], -1), dev)
        return dataclasses.replace(self, sample_tables=tables)


Group = Tuple[torch.Tensor, str, int]   # (node ids, node type, seed offset)


class PartitionedHeteroNALPTrainer:
    """Typed NALP trainer whose graph lives partitioned across the shards of
    a :class:`Mesh` (the API of ``HeteroNALPTrainer``); the model's one
    parameter set drives every shard. Anchors arrive as global [B] batches
    split over the shards (B % P == 0)."""

    def __init__(self, model, pgraph: PartitionedHeteroGraph,
                 paths: Mapping[str, Sequence[OpSpec]],
                 config: HeteroNALPTrainerConfig, mesh: Mesh,
                 optimizer_args: Optional[Dict[str, Any]] = None,
                 capacity_factor: float = 4.0,
                 overflow_policy: str = "warn"):
        if config.tabularized and pgraph.sample_tables is None:
            raise ValueError(
                "tabularized=True needs frozen tables: build the graph "
                "with pgraph.with_sample_tables(hdg, paths, mesh) first")
        for nt in (config.anchor_node_type, config.candidate_node_type):
            if str(nt) not in paths:
                raise ValueError(f"no sampling path for node type {nt!r}")
        if not config.tabularized:
            for ops in paths.values():
                for op in ops:
                    if (op.method != "uniform"
                            and op.csr_key not in (pgraph.csr_w or {})):
                        raise ValueError(
                            f"op {op.name!r} samples {op.method!r} but the "
                            f"partitioned graph has no edge weights for "
                            f"{op.csr_key!r}; build from a "
                            "HeteroDeviceGraph with weighted CSRs (the op "
                            "must be declared in `paths` at from_hetero "
                            "time) or use tabularized=True")
        if config.num_random_negs % mesh.num_shards:
            raise ValueError("num_random_negs must divide the mesh axis size")
        if (config.global_candidate_pool
                and config.loss_type != "retrieval"):
            raise ValueError("global_candidate_pool is a retrieval-loss "
                             "contract (ring sampled softmax); margin/"
                             "softmax losses use the per-shard pool")
        if overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(
                "overflow_policy must be warn | raise | silent | grow")
        if (pgraph.num_shards != mesh.num_shards
                or pgraph.device != mesh.device):
            raise ValueError("the graph is not partitioned over this mesh")
        self.mesh = mesh
        self.device = mesh.device
        self.num_shards = mesh.num_shards
        self.model = model.to(self.device).eval()
        self.pg = pgraph
        self.paths = {str(k): tuple(v) for k, v in paths.items()}
        self.cfg = config
        self.optimizer_args = dict(optimizer_args or {})
        self.grad_clip_norm = 0.0
        self.capacity_factor = capacity_factor
        self.overflow_policy = overflow_policy
        # Routed-lookup requests dropped by bucket overflow, over every
        # train and eval chunk.
        self.overflow_total = 0
        p, a_nt = self.num_shards, pgraph.anchor_node_type

        def empty_csr():
            """An all-degree-0 CSR over the anchor type's rows: its draws
            mask to empty."""
            return ([torch.zeros((pgraph.rows[a_nt] + 1,), dtype=torch.int32,
                                 device=self.device) for _ in range(p)],
                    [torch.zeros((1,), dtype=torch.int32, device=self.device)
                     for _ in range(p)])

        self._sup = ((pgraph.sup_ip, pgraph.sup_ix)
                     if pgraph.sup_ip is not None else empty_csr())
        self._hard = ((pgraph.hard_ip, pgraph.hard_ix)
                      if pgraph.hard_ip is not None else empty_csr())

    # -- state -----------------------------------------------------------------
    def init_state(self, seed: int = 0, batch_size: Optional[int] = None,
                   params: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> TrainState:
        """Load ``params`` (a state dict, e.g. from ``params_from_flax``)
        or initialize every node type's and edge type's weights from
        ``seed``, then build the optimizer."""
        del batch_size
        if params is None:
            init_params(self.model, seed)
        else:
            self.model.load_state_dict(params)
        opt, self.grad_clip_norm = make_optimizer(self.optimizer_args,
                                                  self.model.parameters())
        return TrainState(step=0, optimizer=opt)

    def refresh_tables(self, hdg: HeteroDeviceGraph, epoch: int = 0) -> None:
        """Re-freeze the sharded sample tables with the seed of ``epoch``
        (``cfg.seed + 1_299_709 * epoch``), the analog of re-running the
        reference's Subgraph Sampler; a no-op unless ``tabularized``.
        Needs the source ``HeteroDeviceGraph``."""
        if not self.cfg.tabularized:
            return
        self.pg = dataclasses.replace(
            self.pg, sample_tables=None).with_sample_tables(
                hdg, self.paths, self.mesh,
                seed=self.cfg.seed + 1_299_709 * epoch)

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

    @staticmethod
    def _dropped(oks: Sequence[torch.Tensor]) -> torch.Tensor:
        return sum((~o).sum(dtype=torch.int32) for o in oks)

    # -- sampling and encoding -------------------------------------------------
    def _sample_tree(self, roots: Sequence[torch.Tensor], root_nt: str,
                     seed: int):
        """Every shard's op tree from its ``roots``: (one TypedBlocks per
        shard, dropped requests). Live: one routed draw an op (hop ``depth
        * 1_000_003 + op index``; weighted / top-k ops over the shard's
        edge weights). Tabularized: one routed gather an op of its frozen
        table."""
        spec = self.paths[root_nt]
        p, pg = self.num_shards, self.pg
        ids = [[r.reshape(-1).to(torch.int32)] for r in roots]
        masks = [[torch.ones(i[0].shape, dtype=torch.bool,
                             device=self.device)] for i in ids]
        ovf = self._zero()
        for i, op in enumerate(spec):
            frontier = [ids[s][op.parent + 1] for s in range(p)]
            pmask = [masks[s][op.parent + 1] for s in range(p)]
            flat = [f.reshape(-1) for f in frontier]
            if self.cfg.tabularized:
                rows, ok = routed_gather(
                    self.mesh, pg.sample_tables[op.table_key], flat,
                    capacity_factor=self.capacity_factor)
                nbr = rows
                valid = [(r >= 0) & o[:, None] for r, o in zip(rows, ok)]
            else:
                nbr, valid, ok = routed_sample_neighbors(
                    self.mesh, pg.csr_ip[op.csr_key], pg.csr_ix[op.csr_key],
                    flat, int(op.fanout), seed=seed,
                    hop=op.depth * 1_000_003 + i,
                    capacity_factor=self.capacity_factor, method=op.method,
                    local_weights=(pg.csr_w[op.csr_key]
                                   if op.method != "uniform" else None))
            ovf = ovf + self._dropped(ok)
            for s in range(p):
                shape = tuple(frontier[s].shape) + (int(op.fanout),)
                m = valid[s].reshape(shape) & pmask[s][..., None]
                ids[s].append(torch.where(m, nbr[s].reshape(shape), 0))
                masks[s].append(m)
        return [TypedBlocks(root_node_type=root_nt, spec=spec,
                            node_ids=ids[s], masks=masks[s],
                            edge_slots=[None] * (len(spec) + 1))
                for s in range(p)], ovf

    def _draw_trees(self, groups: Sequence[Sequence[Group]]):
        """groups[shard]: [(node ids, node type, seed offset)], the same
        types and shapes on every shard. Every group's trees (one
        TypedBlocks per shard) and the dropped requests."""
        trees, ovf = [], self._zero()
        for g, (_, nt, off) in enumerate(groups[0]):
            t, o = self._sample_tree(
                [groups[s][g][0] for s in range(self.num_shards)], str(nt),
                self.cfg.seed + off)
            trees.append(t)
            ovf = ovf + o
        return trees, ovf

    @staticmethod
    def _levels_by_type(trees) -> List[Tuple[str, List[Tuple[int, int]]]]:
        """(node type, its (group, level) entries) in node-type order: the
        order of the hydration gathers and of the union of each."""
        by_type: Dict[str, List[Tuple[int, int]]] = {}
        for g, per_shard in enumerate(trees):
            blocks = per_shard[0]
            types = [blocks.root_node_type] + [op.neighbor_node_type
                                               for op in blocks.spec]
            for lvl, nt in enumerate(types):
                by_type.setdefault(str(nt), []).append((g, lvl))
        return sorted(by_type.items())

    @staticmethod
    def _type_union(trees, levels, shard: int) -> torch.Tensor:
        return torch.cat([trees[g][shard].node_ids[lvl].reshape(-1)
                          for g, lvl in levels])

    def _encode_trees(self, trees, groups, rows_by_type, train: bool,
                      generators=None) -> List[List[torch.Tensor]]:
        """Encode every shard's groups from each node type's hydrated rows
        (``rows_by_type[nt][shard]``: [G_nt, D_nt] in :meth:`_type_union`'s
        order): embeddings per shard per group."""
        p = self.num_shards
        gens = list(generators) if generators is not None else [None] * p
        gathered: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        for nt, levels in self._levels_by_type(trees):
            d = self.pg.feat_dims[nt]
            off = 0
            for g, lvl in levels:
                shape = tuple(trees[g][0].node_ids[lvl].shape)
                n = int(np.prod(shape))
                gathered[(g, lvl)] = [rows_by_type[nt][s][off:off + n]
                                      .reshape(shape + (d,))
                                      for s in range(p)]
                off += n
        outs: List[List[torch.Tensor]] = [[] for _ in range(p)]
        for g, per_shard in enumerate(trees):
            for s in range(p):
                blocks = per_shard[s]
                feats = [gathered[(g, lvl)][s]
                         for lvl in range(len(blocks.node_ids))]
                emb = self.model(blocks, feats, train=train,
                                 generator=gens[s])
                outs[s].append(emb.reshape(tuple(groups[s][g][0].shape)
                                           + (emb.shape[-1],)))
        return outs

    def _encode_groups(self, groups: Sequence[Sequence[Group]], train: bool,
                       generators: Optional[Sequence] = None):
        """Draws every group's trees, then hydrates with ONE routed gather
        per node type over the union of that type's tree levels, and
        encodes: (embeddings per shard per group, dropped requests)."""
        trees, ovf = self._draw_trees(groups)
        rows_by_type = {}
        for nt, levels in self._levels_by_type(trees):
            rows, ok = routed_gather(
                self.mesh, self.pg.device_feats(nt),
                [self._type_union(trees, levels, s)
                 for s in range(self.num_shards)],
                capacity_factor=self.capacity_factor)
            ovf = ovf + self._dropped(ok)
            rows_by_type[nt] = rows
        return self._encode_trees(trees, groups, rows_by_type, train,
                                  generators), ovf

    # -- batches and losses ----------------------------------------------------
    def _make_batches(self, anchors: Sequence[torch.Tensor], step: int):
        """Every shard's typed NALP batch: routed positive (hop 1_000_003 +
        step) and hard-negative (2_000_003 + step) draws over the label
        CSRs, with their label edges' rows when the graph has them, and the
        candidate type's random negatives, the same global draw on every
        shard (K1b at 3_000_017 + step). Returns (batches, dropped
        requests)."""
        cfg, pg = self.cfg, self.pg
        pos, pos_mask, ok_p, *pos_ef = routed_sample_neighbors(
            self.mesh, *self._sup, list(anchors), cfg.num_positives,
            seed=cfg.seed, hop=1_000_003 + step,
            capacity_factor=self.capacity_factor, local_edge_feats=pg.sup_ef)
        pos_ef = pos_ef[0] if pos_ef else [None] * len(anchors)
        ovf = self._dropped(ok_p)
        rand = draw_random_negatives(
            cfg.num_random_negs, pg.num_nodes[str(cfg.candidate_node_type)],
            seed=cfg.seed, step=step, device=self.device)
        h = cfg.num_hard_negs
        hard_ef = [None] * len(anchors)
        if h > 0:
            hard, hard_mask, ok_h, *ef = routed_sample_neighbors(
                self.mesh, *self._hard, list(anchors), h, seed=cfg.seed,
                hop=2_000_003 + step, capacity_factor=self.capacity_factor,
                local_edge_feats=pg.hard_ef)
            hard_ef = ef[0] if ef else hard_ef
            ovf = ovf + self._dropped(ok_h)
        else:
            hard = [torch.zeros(a.shape + (0,), dtype=torch.int32,
                                device=self.device) for a in anchors]
            hard_mask = [torch.zeros(a.shape + (0,), dtype=torch.bool,
                                     device=self.device) for a in anchors]
        return [NALPBatch(anchors=a.to(torch.int32), pos=pos[s],
                          pos_mask=pos_mask[s], hard_neg=hard[s],
                          hard_neg_mask=hard_mask[s], random_neg=rand,
                          pos_edge_feats=pos_ef[s],
                          hard_neg_edge_feats=hard_ef[s])
                for s, a in enumerate(anchors)], ovf

    def _rand_local(self, rand: torch.Tensor, shard: int) -> torch.Tensor:
        r_per = self.cfg.num_random_negs // self.num_shards
        return rand[shard * r_per: (shard + 1) * r_per]

    def _groups(self, batches: Sequence[NALPBatch], hard: bool):
        a_nt = str(self.cfg.anchor_node_type)
        c_nt = str(self.cfg.candidate_node_type)
        groups = []
        for s, b in enumerate(batches):
            g = [(b.anchors, a_nt, 0), (b.pos, c_nt, 1),
                 (self._rand_local(b.random_neg, s), c_nt, 2)]
            if hard:
                g.append((b.hard_neg, c_nt, 3))
            groups.append(g)
        return groups

    def loss_and_overflow(self, anchors, step: int, generators=None):
        """(train-mode global mean loss of ``step`` for the global [B]
        ``anchors``, differentiable in the model's weights; the routed
        requests dropped, a device scalar)."""
        batches, ovf = self._make_batches(self._split(self._ids(anchors)),
                                          step)
        embs, ovf2 = self._encode_groups(
            self._groups(batches, self.cfg.num_hard_negs > 0), True,
            generators)
        return self._loss_from_embeddings(batches, embs), ovf + ovf2

    def _loss_from_embeddings(self, batches: Sequence[NALPBatch], embs):
        """The global mean loss of every shard's batch from its groups'
        embeddings: the ring or the per-shard pool."""
        cfg = self.cfg
        if cfg.global_candidate_pool:
            return self._ring_loss(batches, embs)
        rand = self.mesh.all_gather([e[2] for e in embs])
        losses = []
        for s, b in enumerate(batches):
            q, pos, _ = embs[s][:3]
            hard = embs[s][3] if cfg.num_hard_negs > 0 else None
            loss, _ = nalp_loss_from_embeddings(self.model, cfg, b, q, pos,
                                                hard, rand[s])
            losses.append(loss)
        return self.mesh.pmean(losses)[0]

    def _ring_loss(self, batches: Sequence[NALPBatch], embs):
        """The typed global-candidate-pool retrieval loss (as
        ``PartitionedNALPTrainer._ring_loss``, without the sketch): every
        shard's query rows against every shard's candidate block folded
        round the ring (K17), the label edges' scorer terms on the own
        block (K17's bias mode)."""
        if self.model.decoder.is_mlp:
            raise NotImplementedError(
                "the global candidate pool folds inner-product scores (K17); "
                "an MLP decoder's ring is not ported")
        cfg, p = self.cfg, self.num_shards
        cosine = self.model.decoder.decoder_type == DecoderType.COSINE
        cands, cols = [], []
        for s, b in enumerate(batches):
            q, pos, rand_l = embs[s][:3]
            hard = embs[s][3] if cfg.num_hard_negs > 0 else None
            c, col = ring_candidate_pool(b, pos, hard, rand_l,
                                         self._rand_local(b.random_neg, s))
            cands.append(_unit(c) if cosine else c)
            cols.append(col)
        cand_views = ring_blocks(self.mesh, cands)
        col_views = ring_blocks(self.mesh, cols)
        sums, counts = [], []
        for s, b in enumerate(batches):
            n_pos = b.pos.shape[1]
            q_rows = embs[s][0].repeat_interleave(n_pos, dim=0)
            if cosine:
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
        return self.mesh.pmean([c * p / torch.clamp(total, min=1.0)
                                for c in sums])[0]

    # -- training --------------------------------------------------------------
    def _generators(self, generators):
        if isinstance(generators, torch.Generator):
            return [generators] * self.num_shards
        return generators

    def _step(self, state: TrainState, anchors: torch.Tensor, generators):
        state.optimizer.zero_grad(set_to_none=True)
        loss, ovf = self.loss_and_overflow(anchors, state.step, generators)
        loss.backward()
        if self.grad_clip_norm > 0:
            clip_by_global_norm_(self.model.parameters(), self.grad_clip_norm)
        state.optimizer.step()
        return state._replace(step=state.step + 1), loss.detach(), ovf

    def train_steps(self, state: TrainState, anchors_kb, generators=None
                    ) -> Tuple[TrainState, torch.Tensor]:
        """``anchors_kb.shape[0]`` consecutive steps over global [K, B]
        anchors; returns the state and the per-step losses [K] on the
        device. ``generators``: one ``torch.Generator`` per shard for
        dropout (or one shared by all). The dropped requests are read once
        at the end and handled per ``overflow_policy``."""
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
        """Positives ranked against the shared random negatives (scored
        with their label edges' terms when the model has a scorer): (rr
        sum, hits sums, count, dropped requests), summed over shards."""
        batches, ovf = self._make_batches(self._split(anchors), step)
        embs, ovf2 = self._encode_groups(self._groups(batches, False), False)
        return (*self._eval_from_embeddings(batches, embs), ovf + ovf2)

    def _eval_from_embeddings(self, batches: Sequence[NALPBatch], embs):
        """(rr sum, hits sums, count) of every shard's batch from its
        groups' embeddings, summed over shards."""
        rand = self.mesh.all_gather([e[2] for e in embs])
        scorer = getattr(self.model, "edge_scorer", None) is not None
        rr_t, hits_t, cnt_t = [], [], []
        for s, b in enumerate(batches):
            q, pos = embs[s][:2]
            n_pos = pos.shape[1]
            ef = b.pos_edge_feats if scorer else None
            pos_flat = self.model.decode(q[:, None, :], pos, ef).reshape(-1)
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

    def encode_batch(self, node_ids, node_type: Optional[str] = None
                     ) -> torch.Tensor:
        """Inference embeddings of ``node_ids`` of ``node_type`` (the anchor
        type by default) over the partitioned graph (padded with node 0 to
        a multiple of the shard count; the pad rows dropped)."""
        nt = str(node_type or self.cfg.anchor_node_type)
        ids = self._ids(node_ids).reshape(-1)
        m = ids.shape[0]
        pad = -(-m // self.num_shards) * self.num_shards - m
        ids = torch.cat([ids, ids.new_zeros((pad,))])
        with torch.inference_mode():
            embs, _ = self._encode_groups(
                [[(part, nt, 0)] for part in self._split(ids)], False)
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
        """The NALP train loop (``fit_loop.nalp_fit_loop``) over the typed
        partitioned graph; the frozen tabularized tables stay fixed for
        the run (``refresh_tables(hdg, epoch)`` between fits resamples)."""
        from gigl_tpu_torch.training.fit_loop import nalp_fit_loop

        return nalp_fit_loop(
            self, state, train_anchors, val_anchors,
            batch_size=batch_size, num_epochs=num_epochs,
            val_every_n_batches=val_every_n_batches,
            num_val_batches=num_val_batches,
            early_stop_patience=early_stop_patience, log_every=log_every,
            scalar_logger=scalar_logger, checkpoint_dir=checkpoint_dir,
            num_shards=self.num_shards)
