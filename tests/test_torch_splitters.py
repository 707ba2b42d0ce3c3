"""The port's host-side splitters against the JAX package's
(``gigl_tpu/graph/splitters.py``): the typed edge-index maps of
``HashedNodeAnchorLinkSplitter`` and ``select_ssl_positive_edges``.

Both are numpy on the host, so every output is held bit-equal (same ids,
same order, same dtype) to the reference's on the same seeded inputs.
"""

import numpy as np
import pytest

from gigl_tpu.graph import splitters as ref
from gigl_tpu.types.graph import EdgeType as RefEdgeType
from gigl_tpu_torch.graph import splitters as port
from gigl_tpu_torch.types.graph import (
    DEFAULT_HOMOGENEOUS_EDGE_TYPE,
    EdgeType,
)


def _same(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _same_splits(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)


def _typed_graph(seed):
    """Two edge types that anchor ``paper`` on the way in (and ``author``,
    ``paper`` on the way out), one that anchors ``venue``."""
    rng = np.random.default_rng(seed)
    cites = rng.integers(0, 300, (2, 900)).astype(np.int64)
    writes = np.stack([rng.integers(0, 120, 500),
                       rng.integers(0, 300, 500)]).astype(np.int64)
    at = np.stack([rng.integers(0, 300, 200),
                   rng.integers(0, 40, 200)]).astype(np.int64)
    names = {("paper", "cites", "paper"): cites,
             ("author", "writes", "paper"): writes,
             ("paper", "at", "venue"): at}
    return ({EdgeType(*k): v for k, v in names.items()},
            {RefEdgeType(*k): v for k, v in names.items()})


@pytest.mark.parametrize("direction", ["in", "out"])
@pytest.mark.parametrize("num_val,num_test", [(0.1, 0.2), (7, 11), (0.3, 5)])
@pytest.mark.parametrize("seed", [0, 3])
def test_typed_map_is_bit_equal(direction, num_val, num_test, seed):
    edges, ref_edges = _typed_graph(seed)
    types = list(edges)
    got = port.HashedNodeAnchorLinkSplitter(
        direction, num_val, num_test, supervision_edge_types=types)(edges)
    want = ref.HashedNodeAnchorLinkSplitter(
        direction, num_val, num_test,
        supervision_edge_types=list(ref_edges))(ref_edges)
    assert sorted(got) == sorted(want)
    for nt in want:
        _same_splits(got[nt], want[nt])


def test_two_edge_types_anchor_one_node_type():
    """``paper`` is anchored by ``cites`` and ``writes`` on the way in: its
    split covers the union of both edge types' destinations once each."""
    edges, ref_edges = _typed_graph(1)
    types = [t for t in edges if t.dst_node_type == "paper"]
    got = port.HashedNodeAnchorLinkSplitter(
        "in", 0.1, 0.1, supervision_edge_types=types)(edges)
    want = ref.HashedNodeAnchorLinkSplitter(
        "in", 0.1, 0.1, supervision_edge_types=[
            t for t in ref_edges if t.dst_node_type == "paper"])(ref_edges)
    assert list(got) == ["paper"] == list(want)
    _same_splits(got["paper"], want["paper"])
    union = np.unique(np.concatenate([edges[t][1] for t in types]))
    _same(np.sort(np.concatenate(got["paper"])), union)


def test_a_missing_supervision_type_raises():
    edges, _ = _typed_graph(0)
    absent = EdgeType("paper", "reviews", "paper")
    with pytest.raises(ValueError, match="Missing supervision edge types"):
        port.HashedNodeAnchorLinkSplitter(
            supervision_edge_types=[absent, *edges])(edges)
    # the default supervision type is the homogeneous one, absent here too
    with pytest.raises(ValueError, match="Missing supervision edge types"):
        port.HashedNodeAnchorLinkSplitter()(edges)


def test_homogeneous_map_and_array_agree():
    edges = np.random.default_rng(4).integers(0, 500, (2, 2000))
    sp = port.HashedNodeAnchorLinkSplitter("in", 0.1, 0.1)
    typed = sp({DEFAULT_HOMOGENEOUS_EDGE_TYPE: edges})
    assert list(typed) == [DEFAULT_HOMOGENEOUS_EDGE_TYPE.dst_node_type]
    _same_splits(typed["default"], sp(edges))
    _same_splits(sp(edges), ref.HashedNodeAnchorLinkSplitter(
        "in", 0.1, 0.1)(edges))


def test_no_training_nodes_left_raises_per_type():
    edges, _ = _typed_graph(0)
    venue = [EdgeType("paper", "at", "venue")]
    with pytest.raises(ValueError, match="No training nodes left for 'venue'"):
        port.HashedNodeAnchorLinkSplitter(
            "in", 30, 30, supervision_edge_types=venue)(edges)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("num_edges", [0, 1, 37, 5000])
def test_ssl_positive_edges_are_bit_equal(ratio, seed, num_edges):
    edges = np.random.default_rng(seed).integers(0, 100, (2, num_edges))
    got = port.select_ssl_positive_edges(edges, ratio, seed=seed)
    _same(got, ref.select_ssl_positive_edges(edges, ratio, seed=seed))
    assert len(got) == (max(1, int(num_edges * ratio)) if num_edges else 0)


@pytest.mark.parametrize("ratio", [0.0, -0.5, 1.5])
def test_ssl_positive_ratio_out_of_range_raises(ratio):
    with pytest.raises(ValueError, match="positive_ratio"):
        port.select_ssl_positive_edges(np.zeros((2, 4), np.int64), ratio)
