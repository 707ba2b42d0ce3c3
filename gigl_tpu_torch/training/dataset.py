"""Device-resident graph bundle and batches (port of
``gigl_tpu/training/dataset.py``: ``DeviceGraph`` with its node labels,
``NALPBatch``, ``NodeClassificationBatch``, ``sample_nalp_batch``,
``AnchorBatchIterator``).

The preprocessed graph lives on the device as CSR + feature tables; per
batch, neighbor sampling and feature hydration are device work. With
``with_neighbor_cache`` the v1 "tabularized" tables are precomputed once per
refresh: the deepest-hop aggregate table (K2), one frozen sample table per
in-tree fanout with -1 marking invalid slots (K1), and optionally the fused
``[N, D + D]`` table of features and aggregates. Each batch then expands the
tree by table-row gathers and hydrates both layer-1 inputs with one row
gather per level (K3).

``sample_nalp_batch`` draws per-anchor positives (and hard negatives) from
the supervision (hard-negative) CSR through K1 and the batch-shared random
negatives through K1b, bit-equal to the reference for every step; the typed
graph (``hetero_dataset.py``) draws through the same functions. With label
edge features (``supervision_edge_features`` / ``hard_neg_edge_features``,
kept in CSR slot order) the batch also carries each drawn edge's feature
row, gathered through K3 by the draw's CSR slots (the reference's
``label_edge_features``). Message-edge features (``edge_features``, CSR
slot order) reach the sampled tree through ``hydrate_edges``: one K3 row
gather per hop, by the slots the sampler drew.

The node features (``from_hetero(quantize_features=True)``) and the
neighbor cache (``with_neighbor_cache(quantize=True)``) may be int8
``QuantizedTable`` objects (``ops/quantized.py``), 4x smaller on the
device: ``hydrate`` and ``hydrate_cached`` then gather through K12, which
dequantizes on the fly, one launch for a tree's every level
(``hydrate_with_cache``: for both tables' levels where both are int8), and
K2 reads the quantized features in its int8 mode. The quantized cache is
K2's fp32 table quantized on the host, as the reference does it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (
    Dict,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Union,
)

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.graph.csr import CSR, HeteroGraph, build_csr
from gigl_tpu_torch.ops.gather import expand_table, gather_rows
from gigl_tpu_torch.ops.hopcache import build_neighbor_cache, build_sample_table
from gigl_tpu_torch.ops.quantized import QuantizedTable
from gigl_tpu_torch.sampling.neighbor_sampler import (
    DeviceCSR,
    SampledBlocks,
    sample_blocks,
    sample_neighbors,
    uniform_ids,
)
from gigl_tpu_torch.types.graph import EdgeType


Table = Union[torch.Tensor, QuantizedTable]


def _level_rows(table: Table, levels: Sequence[torch.Tensor],
                row_vals: Optional[torch.Tensor] = None):
    """[(``table[ids]``, ``row_vals[ids]`` or None)] for each tree level's
    ``ids``: one K12 launch for every level of a quantized table, a K3
    launch a level otherwise."""
    if isinstance(table, QuantizedTable):
        return QuantizedTable.gather_many([(table, ids, row_vals)
                                           for ids in levels])
    return [gather_rows(table, ids, row_vals) for ids in levels]


class NodeClassificationBatch(NamedTuple):
    nodes: torch.Tensor   # [B] int32
    labels: torch.Tensor  # [B] int32
    mask: torch.Tensor    # [B] bool (padding)


class NALPBatch(NamedTuple):
    """Node-anchor link prediction batch (device tensors): anchors with
    per-anchor positives and hard negatives plus batch-shared random
    negatives, and the drawn label edges' features when the graph has
    them (None otherwise)."""

    anchors: torch.Tensor        # [B] int32
    pos: torch.Tensor            # [B, P] int32
    pos_mask: torch.Tensor       # [B, P] bool
    hard_neg: torch.Tensor       # [B, H] int32 (H may be 0)
    hard_neg_mask: torch.Tensor  # [B, H] bool
    random_neg: torch.Tensor     # [R] int32
    pos_edge_feats: Optional[torch.Tensor] = None       # [B, P, De] f32
    hard_neg_edge_feats: Optional[torch.Tensor] = None  # [B, H, De] f32


def _edge_feats(table: Optional[torch.Tensor], slots: torch.Tensor,
                mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``table[slots]`` through K3 ([..., De], or None without a table);
    with ``mask``, the rows of invalid draws zeroed (the typed graph's
    draws, ``hetero_dataset.py:310-312``)."""
    if table is None:
        return None
    rows = gather_rows(table, slots)[0]
    return rows if mask is None else torch.where(mask[..., None], rows, 0.0)


def draw_positives(csr: Optional[DeviceCSR], anchors: torch.Tensor,
                   num: int, *, seed: int, step: int,
                   edge_features: Optional[torch.Tensor] = None,
                   zero_invalid: bool = False):
    """Per-anchor positives from the supervision CSR through K1 at hop
    1_000_003 + step (wrapping mod 2**32): (ids, mask, feats) [B, num],
    feats the drawn edges' rows of ``edge_features`` (CSR slot order; a
    padded slot reads its anchor's first slot, zeroed with
    ``zero_invalid``) or None."""
    if csr is None:
        raise ValueError("No supervision CSR registered for NALP sampling")
    pos, mask, slots = sample_neighbors(csr, anchors, num, seed=seed,
                                        hop=1_000_003 + step)
    return pos, mask, _edge_feats(edge_features, slots,
                                  mask if zero_invalid else None)


def draw_hard_negatives(csr: Optional[DeviceCSR], anchors: torch.Tensor,
                        num: int, *, seed: int, step: int,
                        edge_features: Optional[torch.Tensor] = None,
                        zero_invalid: bool = False):
    """Per-anchor hard negatives from the hard-negative CSR through K1 at
    hop 2_000_003 + step, with their edges' feature rows as
    :func:`draw_positives`; (zeros, False, None) [B, num] when there are
    none."""
    if num > 0 and csr is not None:
        hard, mask, slots = sample_neighbors(csr, anchors, num, seed=seed,
                                             hop=2_000_003 + step)
        return hard, mask, _edge_feats(edge_features, slots,
                                       mask if zero_invalid else None)
    shape = anchors.shape + (max(num, 0),)
    return (torch.zeros(shape, dtype=torch.int32, device=anchors.device),
            torch.zeros(shape, dtype=torch.bool, device=anchors.device),
            None)


def draw_random_negatives(num: int, num_nodes: int, *, seed: int, step: int,
                          device: torch.device) -> torch.Tensor:
    """``num`` batch-shared uniform candidate ids in [0, num_nodes) through
    K1b at hop 3_000_017 + step."""
    return uniform_ids(num, seed, 3_000_017 + step, num_nodes, device)


def sample_nalp_batch(supervision_csr: Optional[DeviceCSR],
                      hard_neg_csr: Optional[DeviceCSR], num_candidates: int,
                      anchors: torch.Tensor, *, num_positives: int,
                      num_hard_negs: int = 0, num_random_negs: int = 512,
                      seed: int = 0, step: int = 0,
                      sup_edge_features: Optional[torch.Tensor] = None,
                      hard_neg_edge_features: Optional[torch.Tensor] = None,
                      zero_invalid: bool = False) -> NALPBatch:
    """A NALP batch: positives (K1, hop 1_000_003 + step) and hard
    negatives (K1, hop 2_000_003 + step) from the label CSRs anchored on
    the anchors' side, with their label edges' feature rows when the
    tables are given (K3; ``zero_invalid``: rows of padded draws zeroed,
    as the typed graph does), and ``num_random_negs`` batch-shared uniform
    negatives of the ``num_candidates`` candidates (K1b, hop 3_000_017 +
    step). The homogeneous and the typed graphs both draw through it."""
    pos, pos_mask, pos_ef = draw_positives(
        supervision_csr, anchors, num_positives, seed=seed, step=step,
        edge_features=sup_edge_features, zero_invalid=zero_invalid)
    hard, hard_mask, hard_ef = draw_hard_negatives(
        hard_neg_csr, anchors, num_hard_negs, seed=seed, step=step,
        edge_features=hard_neg_edge_features, zero_invalid=zero_invalid)
    rand = draw_random_negatives(num_random_negs, num_candidates, seed=seed,
                                 step=step, device=anchors.device)
    return NALPBatch(anchors=anchors, pos=pos, pos_mask=pos_mask,
                     hard_neg=hard, hard_neg_mask=hard_mask,
                     random_neg=rand, pos_edge_feats=pos_ef,
                     hard_neg_edge_feats=hard_ef)


@dataclass
class DeviceGraph:
    """Homogeneous device-side graph bundle for training and inference.

    message_csr: adjacency for message passing (sampling direction "in":
    anchored on dst). supervision_csr / hard_neg_csr: label edges anchored
    on the anchor side, from which NALP batches draw positives and hard
    negatives. node_labels: int32 [N] class labels (node classification).
    edge_features: the message edges' features in CSR slot order (read by
    ``hydrate_edges``); sup_edge_features / hard_neg_edge_features: the
    label edges' features in their CSRs' slot order.
    """

    message_csr: DeviceCSR
    node_features: Table                 # [N, D] f32 (or int8, quantized)
    num_nodes: int
    supervision_csr: Optional[DeviceCSR] = None
    hard_neg_csr: Optional[DeviceCSR] = None
    node_labels: Optional[torch.Tensor] = None    # [N] int32
    degrees: Optional[torch.Tensor] = None        # [N] f32 in-degrees
    nbr_cache: Optional[Table] = None             # [N, D] hopcache table
    # Frozen per-node hop samples, one packed ids table [N, k] per in-tree
    # fanout k; invalid slots are -1.
    sample_tables: Optional[Dict[int, torch.Tensor]] = None
    # Fused [N, D + D] table concat(node_features, nbr_cache); nbr_cache is
    # then a view of its right half.
    fused_table: Optional[torch.Tensor] = None
    edge_features: Optional[torch.Tensor] = None           # [E, De] f32
    sup_edge_features: Optional[torch.Tensor] = None       # [Es, De] f32
    hard_neg_edge_features: Optional[torch.Tensor] = None  # [Eh, De] f32

    @property
    def device(self) -> torch.device:
        return self.node_features.device

    @classmethod
    def from_hetero(
        cls,
        graph: HeteroGraph,
        *,
        supervision_edges: Optional[np.ndarray] = None,  # [2, Es]
        hard_neg_edges: Optional[np.ndarray] = None,
        edge_type: Optional[EdgeType] = None,
        sampling_direction: str = "in",
        quantize_features: bool = False,
        sampling_weight_index: Optional[int] = None,
        supervision_edge_features: Optional[np.ndarray] = None,
        hard_neg_edge_features: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ) -> "DeviceGraph":
        """Move a homogeneous graph to ``device`` (CUDA unless given). The
        edge type's features (if the graph has them) and the label edges'
        features are reordered into their CSRs' slot order (``csr.
        edge_ids``), as the reference does. ``quantize_features``: the node
        features become an int8 :class:`QuantizedTable` (quantized on the
        host, 4x less device memory; gathers dequantize on the fly).
        ``sampling_weight_index``: the edge-feature column used as per-edge
        sampling weights (``method="weighted"`` / ``"top_k"``, the
        reference's RandomWeighted / TopK ops); every CSR row is then sorted
        by descending weight on the host (a stable sort, so equal weights
        keep CSR order), the indices, edge features and weights moved
        together, so the bounded window holds the heaviest edges."""
        if supervision_edge_features is not None and supervision_edges is None:
            raise ValueError(
                "supervision_edge_features needs supervision_edges")
        if hard_neg_edge_features is not None and hard_neg_edges is None:
            raise ValueError("hard_neg_edge_features needs hard_neg_edges")
        device = resolve_device(device)
        et = edge_type or graph.metadata.edge_types[0]
        nt = et.dst_node_type if sampling_direction == "in" else et.src_node_type
        anchor = "dst" if sampling_direction == "in" else "src"
        csr = graph.csr(et, anchor=anchor)
        n = graph.num_nodes[nt]
        feats = (graph.node_features[nt] if nt in graph.node_features
                 else np.zeros((n, 1), np.float32))

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(
                np.asarray(a, np.float32))).to(device)

        def label_csr(edges, feats):
            """(the label CSR, its edges' features in slot order)."""
            if edges is None:
                return None, None
            lc = build_csr(edges[0], edges[1], num_anchor_nodes=n,
                           num_neighbor_nodes=n, anchor=anchor)
            ef = (None if feats is None
                  else f32(np.asarray(feats)[lc.edge_ids]))
            return DeviceCSR.from_csr(lc, device), ef

        sup_csr, sup_ef = label_csr(supervision_edges,
                                    supervision_edge_features)
        hn_csr, hn_ef = label_csr(hard_neg_edges, hard_neg_edge_features)
        edge_rows = None   # the edge type's features in CSR slot order
        if str(et) in graph.edge_features:
            edge_rows = np.asarray(graph.edge_features[str(et)],
                                   np.float32)[csr.edge_ids]
        weights = None
        if sampling_weight_index is not None:
            if edge_rows is None:
                raise ValueError(
                    "sampling_weight_index requires edge features")
            weights = edge_rows[:, sampling_weight_index]
            row_of = np.repeat(np.arange(len(csr.indptr) - 1),
                               np.diff(csr.indptr))
            order = np.lexsort((-weights, row_of))
            csr = CSR(indptr=csr.indptr,
                      indices=np.asarray(csr.indices)[order],
                      edge_ids=(None if csr.edge_ids is None
                                else np.asarray(csr.edge_ids)[order]),
                      num_neighbor_nodes=csr.num_neighbor_nodes)
            edge_rows = edge_rows[order]
            weights = weights[order]
        edge_features = None if edge_rows is None else f32(edge_rows)
        labels = graph.node_labels.get(nt)
        if quantize_features:
            node_features = QuantizedTable.quantize(np.asarray(feats),
                                                    device=device)
        else:
            node_features = torch.as_tensor(
                np.asarray(feats, np.float32)).to(device)
        return cls(
            message_csr=DeviceCSR.from_csr(csr, device, edge_weights=weights),
            node_features=node_features,
            num_nodes=n,
            supervision_csr=sup_csr,
            hard_neg_csr=hn_csr,
            node_labels=(None if labels is None else torch.as_tensor(
                np.asarray(labels).astype(np.int32)).to(device)),
            degrees=torch.as_tensor(
                np.diff(csr.indptr).astype(np.float32)).to(device),
            edge_features=edge_features,
            sup_edge_features=sup_ef,
            hard_neg_edge_features=hn_ef,
        )

    # -- NALP batches -----------------------------------------------------------
    def sample_nalp_batch(
        self,
        anchors: torch.Tensor,
        *,
        num_positives: int,
        num_hard_negs: int = 0,
        num_random_negs: int = 512,
        seed: int = 0,
        step: int = 0,
    ) -> NALPBatch:
        """The step's batch for ``anchors`` (:func:`sample_nalp_batch`),
        with the drawn label edges' features when the graph has them
        (padded draws read their anchor's first slot, as the reference's
        do: the loss masks them)."""
        return sample_nalp_batch(
            self.supervision_csr, self.hard_neg_csr, self.num_nodes,
            anchors.to(device=self.device, dtype=torch.int32),
            num_positives=num_positives, num_hard_negs=num_hard_negs,
            num_random_negs=num_random_negs, seed=seed, step=step,
            sup_edge_features=self.sup_edge_features,
            hard_neg_edge_features=self.hard_neg_edge_features)

    # -- live sampling ----------------------------------------------------------
    def sample_hop_blocks(
        self,
        node_ids: torch.Tensor,
        fanouts: Sequence[int],
        *,
        seed: int = 0,
        method: str = "uniform",
    ) -> SampledBlocks:
        return sample_blocks(self.message_csr, node_ids.reshape(-1), fanouts,
                             seed=seed, method=method)

    def hydrate(self, blocks: SampledBlocks):
        """Gather hop features (+ per-hop degrees) for encoder input."""
        rows = _level_rows(self.node_features, blocks.node_ids, self.degrees)
        feats = [r for r, _ in rows]
        degs = None if self.degrees is None else [d for _, d in rows]
        return feats, blocks.masks, degs

    def hydrate_with_cache(self, blocks: SampledBlocks):
        """(feats, masks, degrees, cached): :meth:`hydrate` and
        :meth:`hydrate_cached` of one tree. Where both tables are int8,
        every level of both is gathered in one K12 launch."""
        if not (isinstance(self.node_features, QuantizedTable)
                and isinstance(self.nbr_cache, QuantizedTable)):
            feats, masks, degs = self.hydrate(blocks)
            return feats, masks, degs, self.hydrate_cached(blocks)
        levels = blocks.node_ids
        rows = QuantizedTable.gather_many(
            [(self.node_features, ids, self.degrees) for ids in levels]
            + [(self.nbr_cache, ids, None) for ids in levels])
        feat_rows, cached = rows[:len(levels)], rows[len(levels):]
        degs = None if self.degrees is None else [d for _, d in feat_rows]
        return ([r for r, _ in feat_rows], blocks.masks, degs,
                [r for r, _ in cached])

    # -- tabularized tables -------------------------------------------------------
    def with_neighbor_cache(
        self,
        *,
        fanout: int,
        seed: int = 0,
        hop_key: int = 1,
        agg: str = "mean",
        table_fanouts: Optional[Sequence[int]] = None,
        quantize: bool = False,
        fuse_features: bool = False,
        method: str = "uniform",
    ) -> "DeviceGraph":
        """Return a copy with the tabularized tables precomputed: the
        deepest-hop aggregate table and, when ``table_fanouts`` is given, one
        frozen packed sample table per distinct fanout. ``hop_key`` must
        equal the hop index the live sampler uses for the cached hop
        (len(fanouts)); the sample tables always use hop 1. ``quantize``:
        the aggregate table is stored int8 (K2's fp32 table quantized on the
        host, as the reference does); ``fuse_features`` needs both tables
        unquantized."""
        if fuse_features and quantize:
            raise ValueError("fuse_features requires an unquantized cache")
        if fuse_features and isinstance(self.node_features, QuantizedTable):
            raise ValueError("fuse_features requires unquantized features")
        fused = None
        out = None
        if fuse_features:
            d = self.node_features.shape[-1]
            fused = torch.empty((self.num_nodes, 2 * d), dtype=torch.float32,
                                device=self.device)
            fused[:, :d].copy_(self.node_features)
            out = fused[:, d:]  # K2 writes the aggregates here in place
        cache = build_neighbor_cache(
            self.message_csr, self.node_features, fanout=fanout, seed=seed,
            hop_key=hop_key, agg=agg, degrees=self.degrees, method=method,
            out=out)
        if quantize:
            cache = QuantizedTable.quantize(cache, device=self.device)
        tables = None
        if table_fanouts:
            tables = {}
            for k in sorted(set(int(k) for k in table_fanouts)):
                ids_t, mask_t = build_sample_table(
                    self.message_csr, fanout=k, seed=seed, hop_key=1,
                    method=method)
                tables[k] = torch.where(mask_t, ids_t, -1)
        return dataclasses.replace(self, nbr_cache=cache,
                                   sample_tables=tables, fused_table=fused)

    def sample_hop_blocks_tabularized(
        self,
        node_ids: torch.Tensor,
        fanouts: Sequence[int],
    ) -> SampledBlocks:
        """Build a fanout tree from the frozen sample tables (one table-row
        gather per hop; a node reuses its one per-fanout sample at every
        depth)."""
        if self.sample_tables is None:
            raise ValueError("no sample tables; with_neighbor_cache(..., "
                             "table_fanouts=...) first")
        roots = node_ids.reshape(-1).to(torch.int32)
        node_ids_l: List[torch.Tensor] = [roots]
        masks = [torch.ones(roots.shape, dtype=torch.bool, device=roots.device)]
        frontier, parent_mask = roots, masks[0]
        for k in fanouts:
            if int(k) not in self.sample_tables:
                raise ValueError(
                    f"no sample table for fanout {k}; have "
                    f"{sorted(self.sample_tables)}")
            nbr, m = expand_table(self.sample_tables[int(k)], frontier,
                                  parent_mask)
            node_ids_l.append(nbr)
            masks.append(m)
            frontier, parent_mask = nbr, m
        return SampledBlocks(node_ids=node_ids_l, masks=masks,
                             edge_slots=[None] * len(node_ids_l))

    def hydrate_fused(self, blocks: SampledBlocks):
        """One row gather per tree level hydrating both layer-1 inputs:
        (feats, masks, degrees, cached), feats[l] / cached[l] being views
        of the same gathered [..., D + D] rows."""
        if self.fused_table is None:
            raise ValueError("no fused table; with_neighbor_cache(..., "
                             "fuse_features=True) first")
        d = self.node_features.shape[-1]
        rows = [gather_rows(self.fused_table, ids, self.degrees)
                for ids in blocks.node_ids]
        feats = [r[..., :d] for r, _ in rows]
        cached = [r[..., d:] for r, _ in rows]
        degs = None if self.degrees is None else [g for _, g in rows]
        return feats, blocks.masks, degs, cached

    def hydrate_cached(self, blocks: SampledBlocks):
        """Gather the hopcache rows for every tree node."""
        if self.nbr_cache is None:
            raise ValueError("no neighbor cache; call with_neighbor_cache()")
        return [r for r, _ in _level_rows(self.nbr_cache, blocks.node_ids)]

    def hydrate_edges(self, blocks: SampledBlocks):
        """Per-hop edge features aligned to the block slots (K3 by the
        drawn CSR slots; None for the roots), or None without edge
        features. Padded slots read their node's first slot, as the
        reference's do: the mask excludes them downstream."""
        if self.edge_features is None:
            return None
        return [None] + [gather_rows(self.edge_features, es)[0]
                         for es in blocks.edge_slots[1:]]


@dataclass
class AnchorBatchIterator:
    """Host-side iterator over shuffled anchor-node batches (drops the
    remainder to keep shapes static; epochs reshuffle deterministically by
    epoch)."""

    anchor_ids: np.ndarray
    batch_size: int
    seed: int = 0
    drop_remainder: bool = True

    def num_batches(self) -> int:
        n = len(self.anchor_ids) // self.batch_size
        if not self.drop_remainder and len(self.anchor_ids) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch_idx: int) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch_idx)
        perm = rng.permutation(self.anchor_ids)
        n_full = len(perm) // self.batch_size
        for i in range(n_full):
            yield perm[i * self.batch_size: (i + 1) * self.batch_size]
        rem = len(perm) % self.batch_size
        if rem and not self.drop_remainder:
            # Pad the tail batch by wrapping (callers mask by position).
            tail = perm[-rem:]
            pad = perm[: self.batch_size - rem]
            yield np.concatenate([tail, pad])
