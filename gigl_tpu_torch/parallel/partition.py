"""Graph partitioning across shards (port of
``gigl_tpu/parallel/partition.py``: ``minimal_uint_dtype``,
``PartitionBook``, ``GraphPartition``, ``partition_edges``,
``partition_graph`` and ``shard_features_rowwise``).

Partition books are 1-D rank-per-id arrays in the smallest unsigned type
that holds the shard count; nodes are partitioned by range (or by a hash)
and edges go to the shard owning their anchor endpoint (dst for
``edge_dir="in"``, src for ``"out"``). All of it is host numpy, bit-equal to
the reference. ``shard_features_rowwise`` places a feature table on a
:class:`~gigl_tpu_torch.parallel.mesh.Mesh`: the single controller holds one
``[ceil(N / P) * P, D]`` tensor on the mesh's device whose shard s is the
row view ``[s * per, (s + 1) * per)``, the padded rows zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from gigl_tpu_torch.parallel.mesh import Mesh


def minimal_uint_dtype(num_shards: int):
    """The smallest unsigned numpy type that holds ``num_shards`` shard
    ids."""
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    if num_shards <= 2 ** 8:
        return np.uint8
    if num_shards <= 2 ** 16:
        return np.uint16
    return np.uint32


@dataclass
class PartitionBook:
    """rank-per-id array: book[i] = shard owning entity i."""

    book: np.ndarray  # [num_ids] minimal uint
    num_shards: int

    @classmethod
    def by_range(cls, num_ids: int, num_shards: int) -> "PartitionBook":
        """Contiguous ranges of ceil(num_ids / num_shards) ids a shard."""
        per = -(-num_ids // num_shards)
        book = (np.arange(num_ids) // per).astype(
            minimal_uint_dtype(num_shards))
        return cls(book=book, num_shards=num_shards)

    @classmethod
    def by_hash(cls, ids_hash: np.ndarray, num_shards: int) -> "PartitionBook":
        book = (ids_hash % num_shards).astype(minimal_uint_dtype(num_shards))
        return cls(book=book, num_shards=num_shards)

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        return self.book[ids]

    def ids_of_shard(self, shard: int) -> np.ndarray:
        return np.nonzero(self.book == shard)[0]

    @property
    def num_ids(self) -> int:
        return len(self.book)


@dataclass
class GraphPartition:
    """One shard's slice of the graph."""

    shard: int
    edges: np.ndarray                 # [2, E_s] global src/dst ids
    edge_ids: np.ndarray              # [E_s] original edge rows
    node_ids: np.ndarray              # [N_s] global node ids owned
    node_features: Optional[np.ndarray] = None  # [N_s, D] owned rows
    node_labels: Optional[np.ndarray] = None


def partition_edges(edges: np.ndarray, node_book: PartitionBook, *,
                    edge_dir: str = "in") -> List[np.ndarray]:
    """Per shard, the rows of the [2, E] ``edges`` whose anchor endpoint
    (dst for ``edge_dir`` "in", src for "out") it owns."""
    anchor = edges[1] if edge_dir == "in" else edges[0]
    owner = node_book.shard_of(anchor)
    return [np.nonzero(owner == s)[0] for s in range(node_book.num_shards)]


def partition_graph(
    edges: np.ndarray,
    num_nodes: int,
    num_shards: int,
    *,
    node_features: Optional[np.ndarray] = None,
    node_labels: Optional[np.ndarray] = None,
    edge_dir: str = "in",
    node_book: Optional[PartitionBook] = None,
) -> Tuple[PartitionBook, List[GraphPartition]]:
    """Nodes by range (or ``node_book``), edges with their anchor, features
    and labels with their nodes: (book, one GraphPartition a shard)."""
    book = node_book or PartitionBook.by_range(num_nodes, num_shards)
    per_shard_edges = partition_edges(edges, book, edge_dir=edge_dir)
    out = []
    for s in range(num_shards):
        rows = per_shard_edges[s]
        owned = book.ids_of_shard(s)
        out.append(GraphPartition(
            shard=s,
            edges=edges[:, rows],
            edge_ids=rows,
            node_ids=owned,
            node_features=(node_features[owned]
                           if node_features is not None else None),
            node_labels=(node_labels[owned]
                         if node_labels is not None else None)))
    return book, out


def shard_features_rowwise(features, mesh: Mesh) -> torch.Tensor:
    """A [N, D] table (numpy or tensor) as the mesh's row-sharded table:
    [ceil(N / P) * P, D] on ``mesh.device``, the padded rows zero."""
    x = torch.as_tensor(features).to(mesh.device)
    n = x.shape[0]
    n_pad = -(-n // mesh.num_shards) * mesh.num_shards
    if n_pad != n:
        x = torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))])
    return x.contiguous()
