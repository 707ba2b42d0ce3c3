"""Device-resident typed graph for heterogeneous training and inference
(port of ``gigl_tpu/training/hetero_dataset.py``: ``HeteroDeviceGraph``
with ``from_hetero``, ``sample``, ``hydrate``, ``with_sample_tables``,
``sample_tabularized``, the positive / hard-negative / random-negative
draws, and ``paths_from_config``).

Every (edge type, anchor) CSR that a sampling path uses is a
:class:`~gigl_tpu_torch.sampling.neighbor_sampler.DeviceCSR`, and every
node type's features a dense device table. Live typed sampling draws each
op through K1 (K19 for a weighted / top-k op, over a CSR whose edge
weights are column 0 of its edge type's features, rows NOT sorted, as the
reference builds them); the tabularized path freezes one sample table
per (CSR, fanout, method) the same way (``build_sample_table``) and
expands the op tree by table-row gathers through K3 (``expand_table``); ``hydrate``
gathers each entry's feature rows through K3 (``gather_rows``).
Training batches draw positives and hard negatives from the supervision /
hard-negative CSRs (anchored on the anchor type) through K1 and the
batch-shared random negatives of the candidate type through K1b, with the
homogeneous graph's functions (``training/dataset.py``), bit-equal to the
reference. The label edges' features (``supervision_edge_features`` /
``hard_neg_edge_features``, in their CSRs' slot order) come with the
draws, gathered through K3 by the drawn slots, with the rows of padded
draws zeroed (``hetero_dataset.py:301-330``).

``from_hetero(features_on_device=False)`` keeps every node type's table
on the host as a numpy array (dims intact, nothing uploaded): a graph for
builders that need only the topology and the dims, such as the typed
beyond-HBM tier (``PartitionedHeteroGraph.build(features_on_device=False)``
and per-type ``ShardedHostStore``s, ``training/streaming_partitioned.py``);
``hydrate`` refuses such a graph. The partitioned typed graph is
``training/dist_hetero.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gigl_tpu_torch.device import DeviceLike, resolve_device
from gigl_tpu_torch.graph.csr import HeteroGraph, build_csr
from gigl_tpu_torch.ops.gather import expand_table, gather_rows
from gigl_tpu_torch.ops.hopcache import build_sample_table
from gigl_tpu_torch.sampling.hetero_sampler import (
    OpSpec,
    SamplingOp,
    TypedBlocks,
    chain_path,
    resolve_path,
    sample_typed_blocks,
)
from gigl_tpu_torch.sampling.neighbor_sampler import DeviceCSR
from gigl_tpu_torch.training.dataset import (
    NALPBatch,
    draw_hard_negatives,
    draw_positives,
    draw_random_negatives,
    sample_nalp_batch,
)
from gigl_tpu_torch.types.graph import EdgeType

@dataclass
class HeteroDeviceGraph:
    """Typed device graph: per-(edge type, anchor) CSRs keyed
    "{edge_type}|{anchor}", per-node-type features, and optionally the
    supervision / hard-negative CSRs (with their edges' features in slot
    order) and frozen sample tables keyed ``OpSpec.table_key``
    ([N_anchor, fanout] int32, -1 = no neighbor)."""

    csrs: Dict[str, DeviceCSR]
    # node type -> [N_t, D_t] f32 on the device, or a host numpy array when
    # built with features_on_device=False
    node_features: Dict[str, Union[torch.Tensor, np.ndarray]]
    num_nodes: Dict[str, int]
    supervision_csr: Optional[DeviceCSR] = None
    hard_neg_csr: Optional[DeviceCSR] = None
    node_labels: Optional[Dict[str, torch.Tensor]] = None
    sample_tables: Optional[Dict[str, torch.Tensor]] = None
    sup_edge_features: Optional[torch.Tensor] = None       # [Es, De] f32
    hard_neg_edge_features: Optional[torch.Tensor] = None  # [Eh, De] f32

    @property
    def device(self) -> torch.device:
        if self.csrs:
            return next(iter(self.csrs.values())).indptr.device
        return next(iter(self.node_features.values())).device

    @property
    def features_on_device(self) -> bool:
        return all(isinstance(f, torch.Tensor)
                   for f in self.node_features.values())

    def device_features(self, node_type: str) -> torch.Tensor:
        """``node_type``'s feature table on the device; raises for a graph
        whose features stay on the host."""
        f = self.node_features[str(node_type)]
        if not isinstance(f, torch.Tensor):
            raise ValueError(
                f"node type {node_type!r}'s features are host-resident "
                "(HeteroDeviceGraph.from_hetero(features_on_device=False)): "
                "there is no device table to gather; use the streamed-"
                "partitioned tier (training/streaming_partitioned.py) or "
                "build with features_on_device=True")
        return f

    @classmethod
    def from_hetero(
        cls,
        graph: HeteroGraph,
        paths: Dict[str, Tuple[OpSpec, ...]],
        *,
        supervision_edge_type: Optional[EdgeType] = None,
        supervision_edges: Optional[np.ndarray] = None,  # [2, Es] src, dst
        hard_neg_edges: Optional[np.ndarray] = None,
        supervision_anchor: str = "dst",
        supervision_edge_features: Optional[np.ndarray] = None,
        hard_neg_edge_features: Optional[np.ndarray] = None,
        features_on_device: bool = True,
        device: DeviceLike = None,
    ) -> "HeteroDeviceGraph":
        """Move the CSRs the ``paths`` sample and every node type's features
        (zeros [N, 1] for a type without features) to ``device`` (CUDA
        unless given); with ``features_on_device=False`` the features stay
        host numpy arrays, dims intact. A CSR that a weighted / top-k op
        samples carries column 0 of its edge type's features as edge
        weights (its rows are not sorted). Supervision edges (and hard
        negatives) are anchored on ``supervision_anchor``'s side of
        ``supervision_edge_type``; their features (rows aligned to the
        edges' columns) are reordered into the CSRs' slot order."""
        if supervision_edge_features is not None and supervision_edges is None:
            raise ValueError("supervision_edge_features needs "
                             "supervision_edges")
        if hard_neg_edge_features is not None and hard_neg_edges is None:
            raise ValueError("hard_neg_edge_features needs hard_neg_edges")
        device = resolve_device(device)
        csrs: Dict[str, DeviceCSR] = {}
        for key in sorted({op.csr_key for ops in paths.values()
                           for op in ops}):
            methods = {op.method for ops in paths.values() for op in ops
                       if op.csr_key == key}
            et_str, anchor = key.rsplit("|", 1)
            et = next(e for e in graph.metadata.edge_types
                      if str(e) == et_str)
            csr = graph.csr(et, anchor=anchor)
            weights = None
            if methods & {"weighted", "top_k"}:
                ef = graph.edge_features.get(et_str)
                if ef is None:
                    raise ValueError(
                        f"edge type {et_str!r} sampled weighted/top_k but "
                        "has no edge features to use as weights")
                weights = np.asarray(ef)[csr.edge_ids, 0]
            csrs[key] = DeviceCSR.from_csr(csr, device, edge_weights=weights)
        feats = {}
        for nt in graph.metadata.node_types:
            f = (graph.node_features[nt] if nt in graph.node_features
                 else np.zeros((graph.num_nodes[nt], 1), np.float32))
            f = np.asarray(f, np.float32)
            feats[str(nt)] = (torch.as_tensor(f).to(device)
                              if features_on_device else f)
        if supervision_anchor not in ("src", "dst"):
            raise ValueError(f"bad supervision_anchor {supervision_anchor!r}")

        def label_csr(edges, feats):
            """(the label CSR, its edges' features in slot order)."""
            if edges is None or supervision_edge_type is None:
                return None, None
            et = supervision_edge_type
            anchor_nt, cand_nt = ((et.dst_node_type, et.src_node_type)
                                  if supervision_anchor == "dst"
                                  else (et.src_node_type, et.dst_node_type))
            lc = build_csr(edges[0], edges[1],
                           num_anchor_nodes=graph.num_nodes[anchor_nt],
                           num_neighbor_nodes=graph.num_nodes[cand_nt],
                           anchor=supervision_anchor)
            ef = None if feats is None else torch.as_tensor(
                np.ascontiguousarray(np.asarray(feats, np.float32)[
                    lc.edge_ids])).to(device)
            return DeviceCSR.from_csr(lc, device), ef

        if supervision_edges is not None and supervision_edge_type is None:
            raise ValueError("supervision_edges needs an edge type")
        labels = {str(nt): torch.as_tensor(
            np.asarray(lab).astype(np.int32)).to(device)
            for nt, lab in graph.node_labels.items()} or None
        sup_csr, sup_ef = label_csr(supervision_edges,
                                    supervision_edge_features)
        hn_csr, hn_ef = label_csr(hard_neg_edges, hard_neg_edge_features)
        return cls(csrs=csrs, node_features=feats,
                   num_nodes={str(nt): int(n)
                              for nt, n in graph.num_nodes.items()},
                   supervision_csr=sup_csr, hard_neg_csr=hn_csr,
                   node_labels=labels, sup_edge_features=sup_ef,
                   hard_neg_edge_features=hn_ef)

    # -- tabularized sampling ---------------------------------------------------
    def with_sample_tables(self, paths: Dict[str, Tuple[OpSpec, ...]], *,
                           seed: int = 0) -> "HeteroDeviceGraph":
        """A copy with one frozen sample table per (CSR, fanout, method)
        that an op of ``paths`` uses, drawn through K1 (K19 for a weighted /
        top-k op) at hop 1: a node reuses its one sample at every tree
        position (the reference's precomputed-sample regime). A new seed is a re-run of the sampler."""
        tables: Dict[str, torch.Tensor] = dict(self.sample_tables or {})
        for ops in paths.values():
            for op in ops:
                if op.table_key in tables:
                    continue
                ids_t, mask_t = build_sample_table(
                    self.csrs[op.csr_key], fanout=int(op.fanout), seed=seed,
                    hop_key=1, method=op.method)
                tables[op.table_key] = torch.where(mask_t, ids_t, -1)
        return dataclasses.replace(self, sample_tables=tables)

    def sample_tabularized(self, roots: torch.Tensor, root_node_type: str,
                           spec: Tuple[OpSpec, ...]) -> TypedBlocks:
        """The op tree from the frozen tables: one K3 table-row gather per
        op (``with_sample_tables(paths)`` first)."""
        if self.sample_tables is None:
            raise ValueError("no sample tables; with_sample_tables() first")
        roots = roots.reshape(-1).to(torch.int32)
        node_ids = [roots]
        masks = [torch.ones(roots.shape, dtype=torch.bool,
                            device=roots.device)]
        for op in spec:
            if op.table_key not in self.sample_tables:
                raise ValueError(f"no sample table {op.table_key!r}; have "
                                 f"{sorted(self.sample_tables)}")
            nbr, m = expand_table(self.sample_tables[op.table_key],
                                  node_ids[op.parent + 1],
                                  masks[op.parent + 1])
            node_ids.append(nbr)
            masks.append(m)
        return TypedBlocks(root_node_type=str(root_node_type),
                           spec=tuple(spec), node_ids=node_ids, masks=masks,
                           edge_slots=[None] * len(node_ids))

    # -- live sampling and hydration -------------------------------------------
    def sample(self, roots: torch.Tensor, root_node_type: str,
               spec: Tuple[OpSpec, ...], *, seed: int = 0) -> TypedBlocks:
        return sample_typed_blocks(self.csrs, roots.reshape(-1),
                                   str(root_node_type), spec, seed=seed)

    def hydrate(self, blocks: TypedBlocks):
        """Each entry's feature rows through K3: entry 0 of the root type,
        entry i + 1 of ``spec[i]``'s neighbor type. Returns (feats, masks)."""
        types = [blocks.root_node_type] + [op.neighbor_node_type
                                           for op in blocks.spec]
        feats = [gather_rows(self.device_features(nt), ids)[0]
                 for nt, ids in zip(types, blocks.node_ids)]
        return feats, blocks.masks

    # -- training draws (hetero_dataset.py:292-347) -----------------------------
    def sample_positives(self, anchors: torch.Tensor, num_positives: int, *,
                         seed: int, step: int):
        """(ids, mask) [B, P]: K1 over the supervision CSR at hop 1_000_003
        + step."""
        return draw_positives(self.supervision_csr, anchors, num_positives,
                              seed=seed, step=step)[:2]

    def sample_positives_with_feats(self, anchors, num_positives, *, seed,
                                    step):
        """(ids, mask, feats): the same draw with the drawn edges' feature
        rows [B, P, De] (K3; zero where the draw is padded), or None
        without label-edge features."""
        return draw_positives(self.supervision_csr, anchors, num_positives,
                              seed=seed, step=step,
                              edge_features=self.sup_edge_features,
                              zero_invalid=True)

    def sample_hard_negatives(self, anchors: torch.Tensor,
                              num_hard_negs: int, *, seed: int, step: int):
        """(ids, mask) [B, H]: K1 over the hard-negative CSR at hop
        2_000_003 + step; zeros and an all-False mask without one."""
        return draw_hard_negatives(self.hard_neg_csr, anchors, num_hard_negs,
                                   seed=seed, step=step)[:2]

    def sample_hard_negatives_with_feats(self, anchors, num_hard_negs, *,
                                         seed, step):
        """(ids, mask, feats): the same draw with the drawn edges' feature
        rows [B, H, De] (zero where padded), or None."""
        return draw_hard_negatives(self.hard_neg_csr, anchors, num_hard_negs,
                                   seed=seed, step=step,
                                   edge_features=self.hard_neg_edge_features,
                                   zero_invalid=True)

    def sample_random_negatives(self, num: int, candidate_node_type: str, *,
                                seed: int, step: int) -> torch.Tensor:
        """[num] ids of ``candidate_node_type``: K1b at hop 3_000_017 +
        step."""
        return draw_random_negatives(
            num, self.num_nodes[str(candidate_node_type)], seed=seed,
            step=step, device=self.device)

    def sample_nalp_batch(self, anchors: torch.Tensor,
                          candidate_node_type: str, *, num_positives: int,
                          num_hard_negs: int = 0, num_random_negs: int = 512,
                          seed: int = 0, step: int = 0) -> NALPBatch:
        """The typed batch of ``step`` (the reference's ``_sample_batch``):
        the three draws above, with the label edges' features, candidates
        of ``candidate_node_type``."""
        return sample_nalp_batch(
            self.supervision_csr, self.hard_neg_csr,
            self.num_nodes[str(candidate_node_type)],
            anchors.to(device=self.device, dtype=torch.int32),
            num_positives=num_positives, num_hard_negs=num_hard_negs,
            num_random_negs=num_random_negs, seed=seed, step=step,
            sup_edge_features=self.sup_edge_features,
            hard_neg_edge_features=self.hard_neg_edge_features,
            zero_invalid=True)


def paths_from_config(
    graph: HeteroGraph,
    sampling_cfg,
    root_node_types: Sequence[str],
    *,
    default_fanouts: Tuple[int, ...] = (10, 5),
) -> Dict[str, Tuple[OpSpec, ...]]:
    """Per root node type, the op tree of the config's
    ``message_passing_paths``, or the uniform ``fanouts`` expanded over the
    root type's incoming edge types: a chain for a single-edge-type graph,
    else one op per incoming edge type at each level."""
    paths: Dict[str, Tuple[OpSpec, ...]] = {}
    mpp = getattr(sampling_cfg, "message_passing_paths", {}) or {}
    fanouts = tuple(getattr(sampling_cfg, "fanouts", ()) or default_fanouts)
    edge_types = graph.metadata.edge_types
    for nt in root_node_types:
        nt = str(nt)
        if nt in mpp:
            paths[nt] = resolve_path(nt, mpp[nt])
            continue
        incident = [e for e in edge_types if str(e.dst_node_type) == nt]
        if not incident:
            raise ValueError(f"no in-edge types for root node type {nt!r}")
        if len(incident) == 1 and len({str(e) for e in edge_types}) == 1:
            paths[nt] = chain_path(nt, incident[0], fanouts)
            continue
        ops: List[SamplingOp] = []

        def extend(frontier_nt: str, parent_names: Tuple[str, ...],
                   depth: int, prefix: str):
            if depth >= len(fanouts):
                return
            for e in edge_types:
                if str(e.dst_node_type) != frontier_nt:
                    continue
                name = f"{prefix}/{e.relation}@{depth + 1}"
                ops.append(SamplingOp(
                    op_name=name, edge_type=e,
                    num_nodes_to_sample=fanouts[depth],
                    input_op_names=parent_names,
                    sampling_direction="INCOMING"))
                extend(str(e.src_node_type), (name,), depth + 1, name)

        extend(nt, (), 0, nt)
        paths[nt] = resolve_path(nt, ops)
    return paths
