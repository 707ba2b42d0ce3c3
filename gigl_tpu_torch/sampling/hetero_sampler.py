"""Typed (heterogeneous) layerwise sampling over per-edge-type CSRs (port of
``gigl_tpu/sampling/hetero_sampler.py``).

A root node type's sampling strategy is a tree of :class:`SamplingOp`\\ s
(the reference's SubgraphSamplingStrategy DAG: each op samples one edge
type from the frontier its parent op produced). INCOMING ops sample the
in-edges of a frontier of the edge type's dst node type, so the neighbors
are of its src node type; OUTGOING ops the reverse. :func:`resolve_path`
turns the ops into a static tree of :class:`OpSpec`\\ s, and
:func:`sample_typed_blocks` draws it: each op contributes a dense block
``[B, K1, ..., Kd]``. Every draw goes through ``sample_neighbors`` —
kernel K1, or K19 for an op whose method is ``weighted`` / ``top_k`` (the
op's method overrides the call's) — with the reference's per-op hop salt,
``op.depth * 1_000_003 + i``, so the ids and masks are bit-equal to the
reference's.

``SamplingOp`` is a copy of ``gigl_tpu/config/task_config.py:40-70`` (the
port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gigl_tpu_torch.sampling.neighbor_sampler import DeviceCSR, sample_neighbors
from gigl_tpu_torch.types.graph import EdgeType, _as_edge_type

@dataclass
class SamplingOp:
    """One op of the subgraph-sampling DAG: sample ``num_nodes_to_sample``
    neighbors along ``edge_type`` in ``sampling_direction`` from the
    frontier of the ops named in ``input_op_names`` (empty: the root)."""

    op_name: str
    edge_type: EdgeType
    num_nodes_to_sample: int
    input_op_names: Tuple[str, ...] = ()
    sampling_method: str = "uniform"  # uniform | weighted | top_k
    sampling_direction: str = "INCOMING"
    edge_feature_weight_index: int = 0  # for weighted / top_k

    def __post_init__(self):
        self.edge_type = _as_edge_type(self.edge_type)
        self.input_op_names = tuple(self.input_op_names)
        if self.num_nodes_to_sample <= 0:
            raise ValueError(
                f"SamplingOp {self.op_name!r}: num_nodes_to_sample must be "
                "> 0")
        if self.sampling_direction not in ("INCOMING", "OUTGOING"):
            raise ValueError(
                f"SamplingOp {self.op_name!r}: bad direction "
                f"{self.sampling_direction!r}")


@dataclass(frozen=True)
class OpSpec:
    """One resolved sampling op. ``parent`` indexes the op list (-1: the
    root frontier); ``csr_key`` = "{edge_type}|{anchor}" selects the CSR,
    anchored on "dst" for INCOMING and "src" for OUTGOING."""

    name: str
    edge_type: str
    frontier_node_type: str
    neighbor_node_type: str
    fanout: int
    parent: int
    depth: int  # 1 for root-attached ops
    direction: str  # INCOMING | OUTGOING
    method: str = "uniform"  # uniform | weighted | top_k

    @property
    def anchor(self) -> str:
        return "dst" if self.direction == "INCOMING" else "src"

    @property
    def csr_key(self) -> str:
        return f"{self.edge_type}|{self.anchor}"

    @property
    def table_key(self) -> str:
        """Frozen-sample-table key; includes the draw method so ops sharing
        a CSR and fanout with different methods never share a table."""
        return f"{self.csr_key}#{self.fanout}#{self.method}"


def resolve_path(root_node_type: str,
                 ops: Sequence[SamplingOp]) -> Tuple[OpSpec, ...]:
    """Topologically resolve a message-passing path into an OpSpec tree,
    with the reference's checks: root ops' frontier is the root type, each
    op's frontier type is its parent's neighbor type, fanouts positive,
    names unique, the DAG acyclic and single-parent."""
    by_name: Dict[str, SamplingOp] = {}
    for op in ops:
        if op.op_name in by_name:
            raise ValueError(f"duplicate sampling op name {op.op_name!r}")
        by_name[op.op_name] = op

    resolved: List[OpSpec] = []
    index: Dict[str, int] = {}

    def frontier_type(op: SamplingOp) -> Tuple[str, str]:
        et = op.edge_type
        if op.sampling_direction == "INCOMING":
            return str(et.dst_node_type), str(et.src_node_type)
        return str(et.src_node_type), str(et.dst_node_type)

    remaining = list(ops)
    progress = True
    while remaining and progress:
        progress = False
        for op in list(remaining):
            if len(op.input_op_names) > 1:
                raise ValueError(
                    f"op {op.op_name!r}: multi-parent sampling ops are not "
                    "supported on the static block tree")
            if op.num_nodes_to_sample <= 0:
                raise ValueError(
                    f"op {op.op_name!r}: num_nodes_to_sample must be > 0")
            f_nt, n_nt = frontier_type(op)
            if not op.input_op_names:
                if f_nt != str(root_node_type):
                    raise ValueError(
                        f"root op {op.op_name!r} samples {op.edge_type} whose "
                        f"frontier type {f_nt!r} != root {root_node_type!r}")
                parent, depth = -1, 1
            else:
                pname = op.input_op_names[0]
                if pname not in index:
                    if pname not in by_name:
                        raise ValueError(
                            f"op {op.op_name!r}: unknown input op {pname!r}")
                    continue  # parent not resolved yet
                parent = index[pname]
                pspec = resolved[parent]
                if pspec.neighbor_node_type != f_nt:
                    raise ValueError(
                        f"op {op.op_name!r}: frontier type {f_nt!r} does not "
                        f"match parent {pname!r} neighbor type "
                        f"{pspec.neighbor_node_type!r}")
                depth = pspec.depth + 1
            index[op.op_name] = len(resolved)
            resolved.append(OpSpec(
                name=op.op_name, edge_type=str(op.edge_type),
                frontier_node_type=f_nt, neighbor_node_type=n_nt,
                fanout=int(op.num_nodes_to_sample), parent=parent,
                depth=depth, direction=op.sampling_direction,
                method=op.sampling_method))
            remaining.remove(op)
            progress = True
    if remaining:
        raise ValueError(
            f"sampling DAG has a cycle or missing parents: "
            f"{[o.op_name for o in remaining]}")
    return tuple(resolved)


def chain_path(root_node_type: str, edge_type: EdgeType,
               fanouts: Sequence[int],
               direction: str = "INCOMING") -> Tuple[OpSpec, ...]:
    """Uniform k-hop chain over one edge type (the ``fanouts=[15, 10]``
    shorthand)."""
    ops = []
    prev: Tuple[str, ...] = ()
    for i, k in enumerate(fanouts):
        ops.append(SamplingOp(
            op_name=f"hop_{i + 1}", edge_type=edge_type,
            num_nodes_to_sample=int(k), input_op_names=prev,
            sampling_direction=direction))
        prev = (f"hop_{i + 1}",)
    return resolve_path(root_node_type, ops)


@dataclass
class TypedBlocks:
    """A sampled typed block tree aligned with ``spec``: entry 0 is the
    root frontier ([B], all-True mask), entry i + 1 is ``spec[i]``'s block
    ``[B, K1, ..., Kd]``. ``edge_slots`` are the CSR slots of live draws
    (None for the root and for table draws)."""

    root_node_type: str
    spec: Tuple[OpSpec, ...]
    node_ids: List[torch.Tensor]
    masks: List[torch.Tensor]
    edge_slots: List[Optional[torch.Tensor]]

    @property
    def batch_size(self) -> int:
        return self.node_ids[0].shape[0]

    def children_of(self, parent: int) -> List[int]:
        """Indices into spec of the ops whose parent is ``parent``."""
        return [i for i, s in enumerate(self.spec) if s.parent == parent]


def sample_typed_blocks(csrs: Dict[str, DeviceCSR], roots: torch.Tensor,
                        root_node_type: str, spec: Sequence[OpSpec], *,
                        seed: int = 0, method: str = "uniform"
                        ) -> TypedBlocks:
    """Draw a resolved op tree from per-edge-type CSRs keyed by
    ``OpSpec.csr_key``; each op with hop ``op.depth * 1_000_003 + i`` (ops
    at one depth sampling other edge types draw independent bits), by the
    op's method (uniform ops take ``method``)."""
    node_ids: List[torch.Tensor] = [roots.to(torch.int32)]
    masks: List[torch.Tensor] = [torch.ones(roots.shape, dtype=torch.bool,
                                            device=roots.device)]
    edge_slots: List[Optional[torch.Tensor]] = [None]
    for i, op in enumerate(spec):
        op_method = op.method if op.method != "uniform" else method
        frontier = node_ids[op.parent + 1]
        parent_mask = masks[op.parent + 1]
        nbr, m, es = sample_neighbors(
            csrs[op.csr_key], frontier, op.fanout, seed=seed,
            hop=op.depth * 1_000_003 + i, method=op_method)
        m = m & parent_mask[..., None]
        node_ids.append(torch.where(m, nbr, 0))
        masks.append(m)
        edge_slots.append(es)
    return TypedBlocks(root_node_type=str(root_node_type), spec=tuple(spec),
                       node_ids=node_ids, masks=masks, edge_slots=edge_slots)
