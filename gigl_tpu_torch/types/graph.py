"""Graph typing primitives: node/edge types and the graph schema.

A copy of the parts of ``gigl_tpu/types/graph.py`` that the CSR code uses
(the port imports nothing of the JAX package). Node and edge types are
plain strings and frozen dataclasses; the schema checks that every edge type
names known node types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

NodeType = str
Relation = str

DEFAULT_HOMOGENEOUS_NODE_TYPE: NodeType = "default"
DEFAULT_HOMOGENEOUS_RELATION: Relation = "to"


@dataclass(frozen=True, order=True)
class EdgeType:
    """Typed edge triple (src_node_type, relation, dst_node_type)."""

    src_node_type: NodeType
    relation: Relation
    dst_node_type: NodeType

    def __str__(self) -> str:
        return f"{self.src_node_type}-{self.relation}-{self.dst_node_type}"

    @classmethod
    def from_str(cls, s: str) -> "EdgeType":
        parts = s.split("-")
        if len(parts) != 3:
            raise ValueError(
                f"EdgeType string must be 'src-relation-dst', got {s!r}")
        return cls(parts[0], parts[1], parts[2])


DEFAULT_HOMOGENEOUS_EDGE_TYPE = EdgeType(
    DEFAULT_HOMOGENEOUS_NODE_TYPE,
    DEFAULT_HOMOGENEOUS_RELATION,
    DEFAULT_HOMOGENEOUS_NODE_TYPE,
)


def _as_edge_type(e: Union[EdgeType, str, Sequence[str]]) -> EdgeType:
    if isinstance(e, EdgeType):
        return e
    if isinstance(e, str):
        return EdgeType.from_str(e)
    src, rel, dst = e
    return EdgeType(src, rel, dst)


@dataclass(frozen=True)
class GraphMetadata:
    """Schema of the graph: its node types and edge types."""

    node_types: Tuple[NodeType, ...]
    edge_types: Tuple[EdgeType, ...]

    def __post_init__(self):
        object.__setattr__(self, "node_types", tuple(self.node_types))
        object.__setattr__(
            self, "edge_types", tuple(_as_edge_type(e) for e in self.edge_types))
        if len(set(self.node_types)) != len(self.node_types):
            raise ValueError(f"Duplicate node types: {self.node_types}")
        if len(set(self.edge_types)) != len(self.edge_types):
            raise ValueError(f"Duplicate edge types: {self.edge_types}")
        for et in self.edge_types:
            for nt in (et.src_node_type, et.dst_node_type):
                if nt not in self.node_types:
                    raise ValueError(
                        f"Edge type {et} references unknown node type {nt!r}; "
                        f"known: {self.node_types}")

    @classmethod
    def homogeneous(cls) -> "GraphMetadata":
        return cls(
            node_types=(DEFAULT_HOMOGENEOUS_NODE_TYPE,),
            edge_types=(DEFAULT_HOMOGENEOUS_EDGE_TYPE,),
        )
