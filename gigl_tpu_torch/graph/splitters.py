"""Deterministic node-anchor hash split and SSL positive-edge selection (a
numpy-only copy of what the port needs from
``gigl_tpu/graph/splitters.py:37-157, 432-449``: ``fast_hash``,
``HashedNodeAnchorLinkSplitter`` over a homogeneous ``[2, E]`` edge index
or a typed ``{EdgeType: [2, E]}`` map, and ``select_ssl_positive_edges``).

Anchor nodes of the supervision edges are deduplicated and ordered by an
integer mixing hash (argsorted on the SIGNED int64 view, as the reference
does); the first ``1 - val - test`` fraction is train, then val, then test.
A node lives in exactly one split. A typed map gathers the anchors of every
supervision edge type that anchors a node type before it splits that type.
Every output is bit-equal to the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from gigl_tpu_torch.types.graph import (
    DEFAULT_HOMOGENEOUS_EDGE_TYPE,
    DEFAULT_HOMOGENEOUS_NODE_TYPE,
    EdgeType,
    NodeType,
)

Splits = Tuple[np.ndarray, np.ndarray, np.ndarray]


def fast_hash(x: np.ndarray) -> np.ndarray:
    """Integer mixing hash: int32 inputs take the 32-bit lowbias finalizer,
    int64 the splitmix64 finalizer; ``fast_hash(0) == 0``. Shifts act on
    the signed view (arithmetic), multiplies on the unsigned view (they
    wrap as in C)."""
    x = np.asarray(x)
    if x.dtype in (np.int32, np.uint32):
        v = x.astype(np.int32).copy()
        v ^= v >> 16
        v = (v.view(np.uint32) * np.uint32(0x7FEB352D)).view(np.int32)
        v ^= v >> 15
        v = (v.view(np.uint32) * np.uint32(0x846CA68B)).view(np.int32)
        v ^= v >> 16
        return v
    if x.dtype in (np.int64, np.uint64):
        v = x.astype(np.int64).copy()
        v ^= v >> 30
        v = (v.view(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)).view(np.int64)
        v ^= v >> 27
        v = (v.view(np.uint64) * np.uint64(0x94D049BB133111EB)).view(np.int64)
        v ^= v >> 31
        return v
    raise ValueError(f"Unsupported dtype {x.dtype}")


class HashedNodeAnchorLinkSplitter:
    """Split the anchor nodes of supervision edges into (train, val, test)
    id arrays. ``num_val`` / ``num_test``: a fraction in (0, 1) or a
    count. Called with a ``[2, E]`` array it returns one triple; with a
    ``{EdgeType: [2, E]}`` map, a triple per anchor node type (the
    destination type for ``"in"``, the source type for ``"out"``) over the
    ``supervision_edge_types`` (default: the homogeneous edge type), each of
    which the map must hold."""

    def __init__(self, sampling_direction: str = "in",
                 num_val: Union[float, int] = 0.1,
                 num_test: Union[float, int] = 0.1,
                 supervision_edge_types: Optional[Sequence[EdgeType]] = None):
        if sampling_direction not in ("in", "out"):
            raise ValueError(
                f"Invalid sampling direction {sampling_direction!r}")
        for v in (num_val, num_test):
            if isinstance(v, float) and not (0 < v < 1):
                raise ValueError(
                    f"fractional num_val/num_test must be in (0,1): {v}")
            if isinstance(v, int) and isinstance(num_val, int) and v < 0:
                raise ValueError(f"num_val/num_test must be >= 0: {v}")
        self._direction = sampling_direction
        self._num_val = num_val
        self._num_test = num_test
        self._edge_types = (list(supervision_edge_types)
                            if supervision_edge_types
                            else [DEFAULT_HOMOGENEOUS_EDGE_TYPE])

    def __call__(self, edge_index: Union[np.ndarray,
                                         Mapping[EdgeType, np.ndarray]]
                 ) -> Union[Splits, Dict[NodeType, Splits]]:
        typed = not isinstance(edge_index, np.ndarray)
        if not typed:
            edge_index = {DEFAULT_HOMOGENEOUS_EDGE_TYPE: edge_index}
        else:
            missing = set(self._edge_types) - set(edge_index.keys())
            if missing:
                raise ValueError(f"Missing supervision edge types: {missing}")
        anchors: Dict[NodeType, List[np.ndarray]] = {}
        for et in self._edge_types:
            coo = np.asarray(edge_index[et])
            if coo.ndim != 2 or coo.shape[0] != 2:
                raise ValueError(f"edge index for {et} must be [2, E]")
            if self._direction == "in":
                anchors.setdefault(et.dst_node_type, []).append(coo[1])
            else:
                anchors.setdefault(et.src_node_type, []).append(coo[0])
        out = {nt: self._split(nt, np.unique(np.concatenate(rows)))
               for nt, rows in anchors.items()}
        return out if typed else out[DEFAULT_HOMOGENEOUS_NODE_TYPE]

    def _split(self, nt: NodeType, ids: np.ndarray) -> Splits:
        ids = ids[np.argsort(fast_hash(ids.astype(np.int64)), kind="stable")]
        n = len(ids)
        num_val = (self._num_val if isinstance(self._num_val, int)
                   else int(n * self._num_val))
        num_test = (self._num_test if isinstance(self._num_test, int)
                    else int(n * self._num_test))
        num_train = n - num_val - num_test
        if num_train <= 0:
            raise ValueError(f"No training nodes left for {nt!r}: n={n}, "
                             f"val={num_val}, test={num_test}")
        return (ids[:num_train], ids[num_train: num_train + num_val],
                ids[num_train + num_val:])


def select_ssl_positive_edges(edge_index: np.ndarray, positive_ratio: float,
                              seed: int = 0) -> np.ndarray:
    """A deterministic subset of the ``[2, E]`` structural edges as
    self-supervised positive labels: ``max(1, int(E * ratio))`` column ids
    (none for an edgeless graph) drawn without replacement by numpy's
    ``default_rng(seed)``, sorted."""
    if not (0 < positive_ratio <= 1):
        raise ValueError(f"positive_ratio must be in (0,1]: {positive_ratio}")
    num_edges = edge_index.shape[1]
    num_pos = max(1, int(num_edges * positive_ratio)) if num_edges else 0
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(num_edges, size=num_pos, replace=False))
