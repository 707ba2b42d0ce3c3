"""Device-resident graph bundle for sampled inference (port of
``gigl_tpu/training/dataset.py`` ``DeviceGraph``).

The preprocessed graph lives on the device as CSR + feature tables; per
batch, neighbor sampling and feature hydration are device work. With
``with_neighbor_cache`` the v1 "tabularized" tables are precomputed once per
refresh: the deepest-hop aggregate table (K2), one frozen sample table per
in-tree fanout with -1 marking invalid slots (K1), and optionally the fused
``[N, D + D]`` table of features and aggregates. Each batch then expands the
tree by table-row gathers and hydrates both layer-1 inputs with one row
gather per level (K3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.ops.gather import expand_table, gather_rows
from gigl_tpu_torch.ops.hopcache import build_neighbor_cache, build_sample_table
from gigl_tpu_torch.sampling.neighbor_sampler import (
    DeviceCSR,
    SampledBlocks,
    sample_blocks,
)
from gigl_tpu_torch.types.graph import EdgeType


def _not_ported(what: str, ref: str):
    return NotImplementedError(f"{what} is not ported yet ({ref})")


@dataclass
class DeviceGraph:
    """Homogeneous device-side graph bundle for inference.

    message_csr: adjacency for message passing (sampling direction "in":
    anchored on dst). supervision_csr / hard_neg_csr: label edges anchored
    on the anchor side (used by training, which is not ported yet).
    """

    message_csr: DeviceCSR
    node_features: torch.Tensor          # [N, D] f32
    num_nodes: int
    supervision_csr: Optional[DeviceCSR] = None
    hard_neg_csr: Optional[DeviceCSR] = None
    degrees: Optional[torch.Tensor] = None        # [N] f32 in-degrees
    nbr_cache: Optional[torch.Tensor] = None      # [N, D] hopcache table
    # Frozen per-node hop samples, one packed ids table [N, k] per in-tree
    # fanout k; invalid slots are -1.
    sample_tables: Optional[Dict[int, torch.Tensor]] = None
    # Fused [N, D + D] table concat(node_features, nbr_cache); nbr_cache is
    # then a view of its right half.
    fused_table: Optional[torch.Tensor] = None

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
        """Move a homogeneous graph to ``device`` (CUDA unless given)."""
        ref = "gigl_tpu.training.dataset.DeviceGraph.from_hetero"
        if quantize_features:
            raise _not_ported("quantize_features", ref)
        if sampling_weight_index is not None:
            raise _not_ported("sampling_weight_index", ref)
        if (supervision_edge_features is not None
                or hard_neg_edge_features is not None):
            raise _not_ported("label edge features", ref)
        device = resolve_device(device)
        et = edge_type or graph.metadata.edge_types[0]
        if str(et) in graph.edge_features:
            raise _not_ported("edge features",
                              "gigl_tpu.training.dataset.DeviceGraph."
                              "hydrate_edges")
        nt = et.dst_node_type if sampling_direction == "in" else et.src_node_type
        anchor = "dst" if sampling_direction == "in" else "src"
        csr = graph.csr(et, anchor=anchor)
        n = graph.num_nodes[nt]
        feats = (graph.node_features[nt] if nt in graph.node_features
                 else np.zeros((n, 1), np.float32))

        def label_csr(edges):
            if edges is None:
                return None
            return DeviceCSR.from_csr(
                build_csr(edges[0], edges[1], num_anchor_nodes=n,
                          num_neighbor_nodes=n, anchor=anchor), device)

        return cls(
            message_csr=DeviceCSR.from_csr(csr, device),
            node_features=torch.as_tensor(
                np.asarray(feats, np.float32)).to(device),
            num_nodes=n,
            supervision_csr=label_csr(supervision_edges),
            hard_neg_csr=label_csr(hard_neg_edges),
            degrees=torch.as_tensor(
                np.diff(csr.indptr).astype(np.float32)).to(device),
        )

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
        rows = [gather_rows(self.node_features, ids, self.degrees)
                for ids in blocks.node_ids]
        feats = [r for r, _ in rows]
        degs = None if self.degrees is None else [d for _, d in rows]
        return feats, blocks.masks, degs

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
        (len(fanouts)); the sample tables always use hop 1."""
        if quantize:
            raise _not_ported("quantize", "gigl_tpu.ops.quantized.QuantizedTable")
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
        return [gather_rows(self.nbr_cache, ids)[0] for ids in blocks.node_ids]
