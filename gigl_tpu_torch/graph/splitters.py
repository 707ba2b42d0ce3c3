"""Deterministic node-anchor hash split (a numpy-only copy of what the port
needs from ``gigl_tpu/graph/splitters.py:37-157``: ``fast_hash`` and
``HashedNodeAnchorLinkSplitter`` for homogeneous edge indices).

Anchor nodes of the supervision edges are deduplicated and ordered by an
integer mixing hash (argsorted on the SIGNED int64 view, as the reference
does); the first ``1 - val - test`` fraction is train, then val, then test.
A node lives in exactly one split; the splits are bit-equal to the
reference's.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


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
    """Split the anchor nodes of a homogeneous ``[2, E]`` edge index into
    (train, val, test) id arrays. ``num_val`` / ``num_test``: a fraction in
    (0, 1) or a count. Heterogeneous edge-index maps are not ported."""

    def __init__(self, sampling_direction: str = "in",
                 num_val: Union[float, int] = 0.1,
                 num_test: Union[float, int] = 0.1):
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

    def __call__(self, edge_index: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not isinstance(edge_index, np.ndarray):
            raise NotImplementedError(
                "heterogeneous edge-index maps are not ported yet "
                "(gigl_tpu.graph.splitters.HashedNodeAnchorLinkSplitter)")
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError("edge index must be [2, E]")
        anchors = edge_index[1] if self._direction == "in" else edge_index[0]
        ids = np.unique(anchors)
        ids = ids[np.argsort(fast_hash(ids.astype(np.int64)), kind="stable")]
        n = len(ids)
        num_val = (self._num_val if isinstance(self._num_val, int)
                   else int(n * self._num_val))
        num_test = (self._num_test if isinstance(self._num_test, int)
                    else int(n * self._num_test))
        num_train = n - num_val - num_test
        if num_train <= 0:
            raise ValueError(f"No training nodes left: n={n}, "
                             f"val={num_val}, test={num_test}")
        return (ids[:num_train], ids[num_train: num_train + num_val],
                ids[num_train + num_val:])
