"""Host graph containers: per-edge-type CSR adjacency + typed features.

A numpy-only copy of what the port needs from ``gigl_tpu/graph/csr.py``:
``CSR``, ``build_csr`` and the homogeneous ``HeteroGraph`` with its lazily
built, cached CSRs. Neighbor lists are ordered by (anchor, original edge
order) through a stable sort, so sampled draws are reproducible and equal
to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from gigl_tpu_torch.types.graph import (
    DEFAULT_HOMOGENEOUS_EDGE_TYPE,
    DEFAULT_HOMOGENEOUS_NODE_TYPE,
    EdgeType,
    GraphMetadata,
    NodeType,
)


@dataclass
class CSR:
    """Compressed sparse adjacency for one edge type, keyed by anchor node.

    ``indptr[v]:indptr[v+1]`` slices ``indices`` to the neighbor ids of
    anchor node ``v``; ``edge_ids`` maps each slot to its original COO row.
    """

    indptr: np.ndarray  # [num_anchor_nodes + 1], int64
    indices: np.ndarray  # [num_edges], int32 neighbor node ids
    edge_ids: Optional[np.ndarray] = None  # [num_edges], int64
    num_neighbor_nodes: int = 0

    @property
    def num_anchor_nodes(self) -> int:
        return len(self.indptr) - 1


def build_csr(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    num_anchor_nodes: Optional[int] = None,
    num_neighbor_nodes: Optional[int] = None,
    anchor: str = "dst",
) -> CSR:
    """CSR keyed on ``anchor`` ("dst" -> in-edges per node, "src" ->
    out-edges), neighbor lists in original edge order (stable sort)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(
            f"src/dst must be 1-D same-shape, got {src.shape}/{dst.shape}")
    key, nbr = (dst, src) if anchor == "dst" else (src, dst)
    n_anchor = int(num_anchor_nodes if num_anchor_nodes is not None
                   else (key.max() + 1 if len(key) else 0))
    n_nbr = int(num_neighbor_nodes if num_neighbor_nodes is not None
                else (nbr.max() + 1 if len(nbr) else 0))
    if len(key) and key.max() >= n_anchor:
        raise ValueError(f"anchor id {key.max()} >= num_anchor_nodes {n_anchor}")
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_anchor)
    indptr = np.zeros(n_anchor + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=nbr[order].astype(np.int32),
        edge_ids=order.astype(np.int64),
        num_neighbor_nodes=n_nbr,
    )


@dataclass
class HeteroGraph:
    """In-memory typed graph: COO edges per edge type, features, and CSRs
    built on demand per (edge type, anchor side)."""

    metadata: GraphMetadata
    num_nodes: Dict[NodeType, int]
    edges: Dict[EdgeType, np.ndarray]  # [2, E] (src row 0, dst row 1)
    node_features: Dict[NodeType, np.ndarray] = field(default_factory=dict)
    edge_features: Dict[str, np.ndarray] = field(default_factory=dict)
    _csr_cache: Dict[Tuple[EdgeType, str], CSR] = field(default_factory=dict)

    def __post_init__(self):
        for et, coo in self.edges.items():
            coo = np.asarray(coo)
            if coo.ndim != 2 or coo.shape[0] != 2:
                raise ValueError(f"edges[{et}] must be [2, E], got {coo.shape}")
            self.edges[et] = coo
            if et not in self.metadata.edge_types:
                raise ValueError(f"edge type {et} not in metadata")
        for nt in self.metadata.node_types:
            if nt not in self.num_nodes:
                raise ValueError(f"num_nodes missing for node type {nt!r}")

    def csr(self, edge_type: EdgeType, anchor: str = "dst") -> CSR:
        key = (edge_type, anchor)
        if key not in self._csr_cache:
            coo = self.edges[edge_type]
            self._csr_cache[key] = build_csr(
                coo[0], coo[1],
                num_anchor_nodes=self.num_nodes[
                    edge_type.dst_node_type if anchor == "dst"
                    else edge_type.src_node_type],
                num_neighbor_nodes=self.num_nodes[
                    edge_type.src_node_type if anchor == "dst"
                    else edge_type.dst_node_type],
                anchor=anchor,
            )
        return self._csr_cache[key]

    @classmethod
    def homogeneous(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        *,
        num_nodes: int,
        node_features: Optional[np.ndarray] = None,
        edge_features: Optional[np.ndarray] = None,
        make_undirected: bool = False,
    ) -> "HeteroGraph":
        """A homogeneous graph with the default node/edge type;
        ``make_undirected`` adds the reversed edges."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        ef = edge_features
        if make_undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            if ef is not None:
                ef = np.concatenate([ef, ef], axis=0)
        g = cls(
            metadata=GraphMetadata.homogeneous(),
            num_nodes={DEFAULT_HOMOGENEOUS_NODE_TYPE: int(num_nodes)},
            edges={DEFAULT_HOMOGENEOUS_EDGE_TYPE: np.stack([src, dst])},
        )
        if node_features is not None:
            g.node_features[DEFAULT_HOMOGENEOUS_NODE_TYPE] = np.asarray(
                node_features)
        if ef is not None:
            g.edge_features[str(DEFAULT_HOMOGENEOUS_EDGE_TYPE)] = np.asarray(ef)
        return g
