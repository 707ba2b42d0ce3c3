"""Parity of the port's typed (heterogeneous) serving paths with the JAX
reference: typed sampling, HeteroDeviceGraph, the HGT / SimpleHGN / RGCN
convs in block and ``coo`` form, HeteroGNNEncoder (``forward`` and
``encode_full``), ``run_full_graph_inference_hetero``,
``HeteroNALPTrainer.encode_batch`` (live and tabularized) and the typed
``init_params``.

The graph has the shape of ``examples/configs/dblp_hetero_nalp_task_config
.yaml`` at a small size: 40 authors (feature width 6) and 80 papers (width
10), author-writes-paper (200 random edges), its reverse, and
paper-cites-paper (300 random edges plus a hub paper cited 60 times); one
author writes nothing and one paper has no in-edge. Features are scaled by
3 so that pre-activations reach past +-3, where the tanh GELU of the
reference and an exact GELU differ (a test below checks that they are told
apart). The sampling paths are the yaml's own ``message_passing_paths``.

Integer outputs (ids, masks, tables, op trees) are bit-equal. fp32 float
outputs: the same sums in another order, and in the port's ``coo`` forms
the relation maps applied per node rather than per edge, within 1e-5 of
the output's largest entry. Params move from flax through
``params_from_flax`` after ``init(..., method="warmup")``.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gigl_tpu.config.task_config import SamplingOp as RefSamplingOp
from gigl_tpu.graph.csr import HeteroGraph as RefHeteroGraph
from gigl_tpu.inference.inferencer import (
    exact_full_neighborhood_paths as ref_exact_paths,
)
from gigl_tpu.inference.inferencer import (
    run_full_graph_inference_hetero as ref_run_hetero,
)
from gigl_tpu.models import hetero_convs as ref_convs
from gigl_tpu.models.hetero_encoders import HeteroGNNEncoder as RefEncoder
from gigl_tpu.models.link_prediction import (
    HeteroLinkPredictionGNN as RefHeteroLP,
)
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as RefDecoder,
)
from gigl_tpu.sampling.hetero_sampler import resolve_path as ref_resolve
from gigl_tpu.training.hetero_dataset import (
    HeteroDeviceGraph as RefHeteroDeviceGraph,
)
from gigl_tpu.training.hetero_dataset import (
    paths_from_config as ref_paths_from_config,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainer as RefTrainer,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainerConfig as RefTrainerConfig,
)
from gigl_tpu.types.graph import EdgeType as RefEdgeType
from gigl_tpu.types.graph import GraphMetadata as RefGraphMetadata
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import (
    exact_full_neighborhood_paths,
    run_full_graph_inference_hetero,
)
from gigl_tpu_torch.models import hetero_convs
from gigl_tpu_torch.models.hetero_encoders import (
    HeteroGNNEncoder,
    hetero_encoder_from_config,
)
from gigl_tpu_torch.models.init import init_params
from gigl_tpu_torch.ops import segment as seg_ops
from gigl_tpu_torch.models.link_prediction import (
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
)
from gigl_tpu_torch.sampling.hetero_sampler import SamplingOp, resolve_path
from gigl_tpu_torch.training.hetero_dataset import (
    HeteroDeviceGraph,
    paths_from_config,
)
from gigl_tpu_torch.training.hetero_trainer import (
    HeteroNALPTrainer,
    HeteroNALPTrainerConfig,
)
from gigl_tpu_torch.types.graph import EdgeType, GraphMetadata

torch.set_num_threads(1)

A, P = 40, 80
DIMS = {"author": 6, "paper": 10}
WRITES, REV, CITES = ("author-writes-paper", "paper-rev_writes-author",
                      "paper-cites-paper")
EDGE_TYPES = (WRITES, REV, CITES)
NODE_TYPES = ("author", "paper")
HID, OUT, HEADS = 16, 8, 2
YAML = (Path(__file__).resolve().parent.parent / "examples" / "configs"
        / "dblp_hetero_nalp_task_config.yaml")
CONVS = [("hgt", 0), ("simple_hgn", 0), ("rgcn", 0), ("rgcn", 2)]
TOL = 1e-5


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    w_src = rng.integers(1, A, 200)               # author 0 writes nothing
    w_dst = rng.integers(0, P, 200)
    c_src = np.concatenate([rng.integers(0, P, 300), rng.integers(0, P, 60)])
    c_dst = np.concatenate([rng.integers(0, P, 300), np.full(60, 3)])
    c_src, c_dst = c_src[c_dst != 7], c_dst[c_dst != 7]  # paper 7: no
    w_src, w_dst = w_src[w_dst != 7], w_dst[w_dst != 7]  # in-edge
    edges = {WRITES: np.stack([w_src, w_dst]),
             REV: np.stack([w_dst, w_src]),
             CITES: np.stack([c_src, c_dst])}
    feats = {nt: (3.0 * rng.normal(size=(n, DIMS[nt]))).astype(np.float32)
             for nt, n in (("author", A), ("paper", P))}
    return edges, feats


def _graphs(seed=0):
    edges, feats = _arrays(seed)
    port = HeteroGraph(
        metadata=GraphMetadata(NODE_TYPES, EDGE_TYPES),
        num_nodes={"author": A, "paper": P},
        edges={EdgeType.from_str(k): v for k, v in edges.items()},
        node_features=dict(feats))
    ref = RefHeteroGraph(
        metadata=RefGraphMetadata(NODE_TYPES, EDGE_TYPES),
        num_nodes={"author": A, "paper": P},
        edges={RefEdgeType.from_str(k): v for k, v in edges.items()})
    for nt, f in feats.items():
        ref.node_features[nt] = f
    return port, ref


def _yaml_paths():
    mpp = yaml.safe_load(YAML.read_text())["dataset"]["sampling"][
        "message_passing_paths"]
    port, ref = {}, {}
    for nt, ops in mpp.items():
        kw = [dict(op_name=o["op_name"], edge_type=o["edge_type"],
                   num_nodes_to_sample=o["num_nodes_to_sample"],
                   input_op_names=tuple(o["input_op_names"]),
                   sampling_method=o["sampling_method"],
                   sampling_direction=o["sampling_direction"]) for o in ops]
        port[nt] = resolve_path(nt, [SamplingOp(**k) for k in kw])
        ref[nt] = ref_resolve(nt, [RefSamplingOp(**k) for k in kw])
    return port, ref


def _spec_tuple(spec):
    return [dataclasses.astuple(op) for op in spec]


@functools.lru_cache(maxsize=None)
def _ref_encoder(conv, num_bases):
    ref = RefEncoder(hid_dim=HID, out_dim=OUT, node_types=NODE_TYPES,
                     edge_types=EDGE_TYPES, num_layers=2, conv=conv,
                     heads=HEADS, num_bases=num_bases)
    params = jax.jit(lambda key: ref.init(key, DIMS, method="warmup"))(
        jax.random.PRNGKey(0))
    return ref, params


def _encoders(conv, num_bases):
    """The reference encoder, its warmed-up params, and the port's encoder
    carrying them."""
    ref, params = _ref_encoder(conv, num_bases)
    port = HeteroGNNEncoder(HID, OUT, NODE_TYPES, EDGE_TYPES, DIMS,
                            conv=conv, heads=HEADS, num_bases=num_bases)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    return ref, params, port.eval()


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _full_inputs(port_graph):
    feats = {nt: torch.from_numpy(np.asarray(f))
             for nt, f in port_graph.node_features.items()}
    edges = {str(et): tuple(torch.from_numpy(np.asarray(r)).to(torch.int32)
                            for r in coo) for et, coo in
             port_graph.edges.items()}
    return feats, edges, {"author": A, "paper": P}


def _ref_encode_full(ref_enc, params, ref_graph):
    feats, edges, nn_ = _ref_full_inputs(ref_graph)
    return jax.jit(lambda p_, f_, e_: ref_enc.apply(
        p_, f_, e_, nn_, method="encode_full"))(params, feats, edges)


def _ref_full_inputs(ref_graph):
    feats = {nt: jnp.asarray(ref_graph.node_features[nt])
             for nt in NODE_TYPES}
    edges = {str(et): (jnp.asarray(coo[0], jnp.int32),
                       jnp.asarray(coo[1], jnp.int32))
             for et, coo in ref_graph.edges.items()}
    return feats, edges, {"author": A, "paper": P}


# -- sampling -------------------------------------------------------------------
def test_resolved_paths_match_the_reference():
    port, ref = _yaml_paths()
    for nt in ("paper", "author"):
        assert _spec_tuple(port[nt]) == _spec_tuple(ref[nt])
    assert port["paper"][2].parent == 0 and port["paper"][2].depth == 2
    with pytest.raises(ValueError, match="frontier type"):
        resolve_path("author", [SamplingOp("x", CITES, 3)])
    with pytest.raises(ValueError, match="cycle"):
        resolve_path("paper", [SamplingOp("a", CITES, 3, ("b",)),
                               SamplingOp("b", CITES, 3, ("a",))])


@pytest.mark.parametrize("seed", [0, 5])
def test_typed_draws_and_tables_bit_equal(seed):
    port_g, ref_g = _graphs()
    paths, ref_paths = _yaml_paths()
    dg = HeteroDeviceGraph.from_hetero(port_g, paths, device="cpu")
    rdg = RefHeteroDeviceGraph.from_hetero(ref_g, ref_paths)
    assert sorted(dg.csrs) == sorted(rdg.csrs)
    roots = {"paper": np.array([3, 7, 0, 11, 79, 3], np.int32),
             "author": np.array([0, 5, 39, 5, 12], np.int32)}
    for nt in ("paper", "author"):
        got = dg.sample(torch.from_numpy(roots[nt]), nt, paths[nt],
                        seed=seed)
        want = jax.jit(lambda g, r: g.sample(r, nt, ref_paths[nt],
                                             seed=seed))(
            rdg, jnp.asarray(roots[nt]))
        for g, w in zip(got.node_ids + got.masks,
                        want.node_ids + want.masks):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        feats, _ = dg.hydrate(got)
        rfeats, _ = jax.jit(lambda g, b: g.hydrate(b))(rdg, want)
        for g, w in zip(feats, rfeats):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dg_t = dg.with_sample_tables(paths, seed=seed + 1)
    rdg_t = rdg.with_sample_tables(ref_paths, seed=seed + 1)
    assert sorted(dg_t.sample_tables) == sorted(rdg_t.sample_tables)
    for k, v in dg_t.sample_tables.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(rdg_t.sample_tables[k]))
    for nt in ("paper", "author"):
        got = dg_t.sample_tabularized(torch.from_numpy(roots[nt]), nt,
                                      paths[nt])
        want = jax.jit(lambda g, r: g.sample_tabularized(
            r, nt, ref_paths[nt]))(rdg_t, jnp.asarray(roots[nt]))
        for g, w in zip(got.node_ids + got.masks,
                        want.node_ids + want.masks):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_exact_paths_and_config_paths_match_the_reference():
    port_g, ref_g = _graphs()
    got, want = exact_full_neighborhood_paths(port_g, 2), ref_exact_paths(
        ref_g, 2)
    assert got.keys() == want.keys()
    for nt in got:
        assert _spec_tuple(got[nt]) == _spec_tuple(want[nt])
    cfg = type("Sampling", (), {"fanouts": (4, 2),
                                "message_passing_paths": {}})()
    got = paths_from_config(port_g, cfg, NODE_TYPES)
    want = ref_paths_from_config(ref_g, cfg, NODE_TYPES)
    for nt in NODE_TYPES:
        assert _spec_tuple(got[nt]) == _spec_tuple(want[nt])


def test_unported_options_raise():
    port_g, _ = _graphs()
    paths, _ = _yaml_paths()
    weighted = {"paper": tuple(dataclasses.replace(op, method="weighted")
                               for op in paths["paper"])}
    # weighted ops are ported (tests/test_torch_weighted_sampling.py); an
    # edge type without features raises the reference's ValueError, and
    # with them the CSR carries column 0 as its weights
    with pytest.raises(ValueError, match="no edge features"):
        HeteroDeviceGraph.from_hetero(port_g, weighted, device="cpu")
    with_w = HeteroGraph(metadata=port_g.metadata, num_nodes=port_g.num_nodes,
                         edges=port_g.edges,
                         node_features=port_g.node_features,
                         edge_features={
                             str(k): np.stack([np.arange(v.shape[1]),
                                               np.zeros(v.shape[1])], 1)
                             for k, v in port_g.edges.items()})
    wg = HeteroDeviceGraph.from_hetero(with_w, weighted, device="cpu")
    for key, csr in wg.csrs.items():
        et = EdgeType.from_str(key.rsplit("|", 1)[0])
        eids = with_w.csr(et, anchor=key.rsplit("|", 1)[1]).edge_ids
        np.testing.assert_array_equal(csr.edge_weights.numpy(),
                                      eids.astype(np.float32))
    # label-edge features are ported (the graph keeps them in slot order)
    n_writes = port_g.edges[EdgeType.from_str(WRITES)].shape[1]
    with_ef = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        supervision_edges=port_g.edges[EdgeType.from_str(WRITES)],
        supervision_edge_features=np.zeros((n_writes, 2)), device="cpu")
    assert with_ef.sup_edge_features.shape == (n_writes, 2)
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        supervision_edges=port_g.edges[EdgeType.from_str(WRITES)],
        device="cpu")
    assert dg.supervision_csr.num_anchor_nodes == P
    model = HeteroLinkPredictionGNN(
        HeteroGNNEncoder(HID, OUT, NODE_TYPES, EDGE_TYPES, DIMS),
        LinkPredictionDecoder())
    # typed training runs (tests/test_torch_hetero_training.py); a model
    # without a label-edge scorer has no edge_score, as the reference's
    tr = HeteroNALPTrainer(model, dg, paths, HeteroNALPTrainerConfig(
        "paper", "author", num_random_negs=8), device="cpu")
    state = tr.init_state(0)
    state, loss = tr.train_step(state, np.arange(6))
    assert state.step == 1 and np.isfinite(float(loss))
    with pytest.raises(ValueError, match="without an edge_scorer"):
        model.edge_score(torch.zeros(1, 2))


# -- convs ----------------------------------------------------------------------
def _ref_conv(conv, num_bases, heads=HEADS):
    cls = {"hgt": ref_convs.HGTConv, "simple_hgn": ref_convs.SimpleHGNConv,
           "rgcn": ref_convs.RGCNConv}[conv]
    kw = {"num_bases": num_bases} if conv == "rgcn" else {"heads": heads}
    return cls(out_dim=HID, node_types=NODE_TYPES, edge_types=EDGE_TYPES,
               **kw)


@pytest.mark.parametrize("backward", [False, True])
def test_hgt_layer_coo_over_the_relation_indexes_matches_jax(backward):
    """One exact HGT layer end to end (layer 2 of a warmed-up encoder over
    the whole graph, edges in their random order): K10 walks each
    relation's destination index of the TypedSegments passed (built for
    inference, or with the backward's indexes), K9 and K8 the type's; the
    output and the inputs' gradient against the reference's coo form and
    its jax.vjp, fp32 within 1e-5 of the scale."""
    _, params, port = _encoders("hgt", 0)
    p_conv = jax.tree_util.tree_map(np.asarray, params["params"]["conv_1"])
    ref = _ref_conv("hgt", 0)
    mine = port.convs[1]
    rng = np.random.default_rng(14)
    port_g, ref_g = _graphs()
    h = {"author": (2 * rng.normal(size=(A, HID))).astype(np.float32),
         "paper": (2 * rng.normal(size=(P, HID))).astype(np.float32)}
    _, r_edges, nn_ = _ref_full_inputs(ref_g)
    _, edges, _ = _full_inputs(port_g)
    assert (np.diff(edges[CITES][1].numpy()) < 0).any()     # not sorted
    segs = hetero_convs.TypedSegments.build(edges, nn_, "dst", "cpu",
                                            backward=backward)
    assert all(d_ is not None and (s_ is not None) == backward
               for d_, s_ in segs.rel.values())
    want, vjp = jax.vjp(lambda h_: ref.apply(
        {"params": p_conv}, h_, r_edges, nn_, method="coo"),
        {nt: jnp.asarray(v) for nt, v in h.items()})
    ht = {nt: torch.from_numpy(v).requires_grad_() for nt, v in h.items()}
    got = mine.coo(ht, edges, nn_, segments=segs)
    cot = {nt: rng.normal(size=np.shape(want[nt])).astype(np.float32)
           for nt in NODE_TYPES}
    (dh,) = vjp({nt: jnp.asarray(c) for nt, c in cot.items()})
    torch.autograd.backward([got[nt] for nt in NODE_TYPES],
                            [torch.from_numpy(cot[nt]) for nt in NODE_TYPES])
    for nt in NODE_TYPES:
        _close(got[nt], want[nt])
        _close(ht[nt].grad, dh[nt])


@pytest.mark.parametrize("by", ["dst", "relation"])
def test_typed_segments_compose_each_destination_index(by):
    """Each destination index of TypedSegments keeps the source ids its
    edges gather, composed in walk order, so that K8 reads them (the
    composed mode): ``src_stack`` per destination type (by="dst", and each
    relation's own index with the relation's src), the caller's own source
    tensor per relation (by="relation")."""
    port_g, _ = _graphs()
    _, edges, nn_ = _full_inputs(port_g)
    segs = hetero_convs.TypedSegments.build(edges, nn_, by, "cpu")
    if by == "dst":
        pairs = [(segs.index[nt], segs.src_stack[nt]) for nt in segs.index]
        pairs += [(segs.rel[et][0], edges[et][0]) for et in EDGE_TYPES]
    else:
        pairs = [(segs.index[et], edges[et][0]) for et in EDGE_TYPES]
    for idx, src in pairs:
        assert idx.gather is src
        assert seg_ops.gather_mode(src, idx) == "composed"
        np.testing.assert_array_equal(
            idx.gathered.numpy(), src.numpy()[idx.order.numpy()])
    assert all(seg_ops.gather_mode(src.clone(), idx) == "chained"
               for idx, src in pairs)


@pytest.mark.parametrize("by", ["dst", "relation"])
def test_typed_segments_compose_each_source_index(by):
    """Each source index of TypedSegments keeps the destination ids its
    edges add to, composed in walk order, so that K8b reads them (the
    composed mode): ``dst_ids`` per destination type, stacked as
    ``src_stack`` is (by="dst", and each relation's own source index with
    the relation's dst), the caller's own destination tensor per relation
    (by="relation"). Built without the backward, there are none."""
    port_g, _ = _graphs()
    _, edges, nn_ = _full_inputs(port_g)
    segs = hetero_convs.TypedSegments.build(edges, nn_, by, "cpu")
    if by == "dst":
        pairs = [(segs.src_index[nt], segs.dst_ids[nt])
                 for nt in segs.src_index]
        pairs += [(segs.rel[et][1], edges[et][1]) for et in EDGE_TYPES]
    else:
        pairs = [(segs.src_index[et], edges[et][1]) for et in EDGE_TYPES]
    assert pairs
    for idx, dst in pairs:
        assert idx.gather is dst
        assert seg_ops.gather_mode(dst, idx) == "composed"
        np.testing.assert_array_equal(
            idx.gathered.numpy(), dst.numpy()[idx.order.numpy()])
    assert all(seg_ops.gather_mode(dst.clone(), idx) == "chained"
               for idx, dst in pairs)
    bare = hetero_convs.TypedSegments.build(edges, nn_, by, "cpu",
                                            backward=False)
    assert not bare.src_index


def test_hgt_layer_coo_reads_composed_indexes_matches_jax(monkeypatch):
    """One exact HGT layer end to end (layer 2 of a warmed-up encoder)
    over TypedSegments built from the edges it reads: every K8 call
    (the messages' sum, and dq's in the logits' backward) is given the
    gather its index was built from, and every K8b call (the messages'
    and dk's cotangents) the destination ids its source index was built
    from; the output and the inputs' gradient
    against the reference's coo form and its jax.vjp, fp32 within 1e-5 of
    the scale."""
    _, params, port = _encoders("hgt", 0)
    p_conv = jax.tree_util.tree_map(np.asarray, params["params"]["conv_1"])
    ref = _ref_conv("hgt", 0)
    rng = np.random.default_rng(15)
    port_g, ref_g = _graphs()
    h = {"author": (2 * rng.normal(size=(A, HID))).astype(np.float32),
         "paper": (2 * rng.normal(size=(P, HID))).astype(np.float32)}
    _, r_edges, nn_ = _ref_full_inputs(ref_g)
    _, edges, _ = _full_inputs(port_g)
    segs = port.segments(edges, nn_)
    modes = []
    fwd = seg_ops._segment_reduce_fwd

    def spy(x, ids, n, op="sum", src=None, weight=None, index=None):
        modes.append(seg_ops.gather_mode(src, index))
        return fwd(x, ids, n, op, src, weight, index)

    monkeypatch.setattr(seg_ops, "_segment_reduce_fwd", spy)
    bwd_modes = []
    bwd = seg_ops.segment_reduce_bwd

    def bwd_spy(g, ids, num_rows, **kw):
        bwd_modes.append(seg_ops.gather_mode(ids, kw["src_index"]))
        return bwd(g, ids, num_rows, **kw)

    monkeypatch.setattr(seg_ops, "segment_reduce_bwd", bwd_spy)
    want, vjp = jax.vjp(lambda h_: ref.apply(
        {"params": p_conv}, h_, r_edges, nn_, method="coo"),
        {nt: jnp.asarray(v) for nt, v in h.items()})
    ht = {nt: torch.from_numpy(v).requires_grad_() for nt, v in h.items()}
    got = port.convs[1].coo(ht, edges, nn_, segments=segs)
    cot = {nt: rng.normal(size=np.shape(want[nt])).astype(np.float32)
           for nt in NODE_TYPES}
    (dh,) = vjp({nt: jnp.asarray(c) for nt, c in cot.items()})
    torch.autograd.backward([got[nt] for nt in NODE_TYPES],
                            [torch.from_numpy(cot[nt]) for nt in NODE_TYPES])
    gathered = [m for m in modes if m is not None]
    assert gathered and set(gathered) == {"composed"}, modes
    assert bwd_modes and set(bwd_modes) == {"composed"}, bwd_modes
    for nt in NODE_TYPES:
        _close(got[nt], want[nt])
        _close(ht[nt].grad, dh[nt])


@pytest.mark.parametrize("conv,num_bases", CONVS)
def test_conv_block_and_coo_forms_match_jax(conv, num_bases):
    """Layer 2 of a warmed-up encoder on random [*, HID] inputs: the block
    form on a paper row with two child relations (one fully masked row),
    and the coo form over the whole graph (childless author 0's and
    in-edge-less paper 7's rows included)."""
    _, params, port = _encoders(conv, num_bases)
    p_conv = jax.tree_util.tree_map(np.asarray, params["params"]["conv_1"])
    ref = _ref_conv(conv, num_bases)
    mine = port.convs[1]
    rng = np.random.default_rng(3)
    m, k1, k2 = 12, 5, 4
    x_dst = (2 * rng.normal(size=(m, HID))).astype(np.float32)
    xa = (2 * rng.normal(size=(m, k1, HID))).astype(np.float32)
    xp = (2 * rng.normal(size=(m, k2, HID))).astype(np.float32)
    ma, mp = rng.random((m, k1)) < 0.7, rng.random((m, k2)) < 0.6
    ma[4], mp[4] = False, False
    want = jax.jit(lambda p_, x_, a_, ma_, b_, mb_: ref.apply(
        p_, x_, "paper", [(a_, ma_, WRITES, "author"),
                          (b_, mb_, CITES, "paper")]))(
        {"params": p_conv}, x_dst, xa, ma, xp, mp)
    with torch.inference_mode():
        got = mine(torch.from_numpy(x_dst), "paper", [
            (torch.from_numpy(xa), torch.from_numpy(ma), WRITES, "author"),
            (torch.from_numpy(xp), torch.from_numpy(mp), CITES, "paper")])
    _close(got, want)
    want0 = ref.apply({"params": p_conv}, jnp.asarray(x_dst), "author", [])
    _close(mine(torch.from_numpy(x_dst), "author", []), want0)

    port_g, ref_g = _graphs()
    h = {"author": (2 * rng.normal(size=(A, HID))).astype(np.float32),
         "paper": (2 * rng.normal(size=(P, HID))).astype(np.float32)}
    _, r_edges, nn_ = _ref_full_inputs(ref_g)
    _, edges, _ = _full_inputs(port_g)
    want = jax.jit(lambda p_, h_, e_: ref.apply(p_, h_, e_, nn_,
                                                 method="coo"))(
        {"params": p_conv}, h, r_edges)
    with torch.inference_mode():
        got = mine.coo({k: torch.from_numpy(v) for k, v in h.items()},
                       edges, nn_)
    for nt in NODE_TYPES:
        _close(got[nt], want[nt])


def test_hgt_parity_tells_tanh_gelu_from_exact(monkeypatch):
    """The reference's GELU is the tanh approximation; on these inputs an
    exact GELU misses the tolerance (so the parity tests would catch it)."""
    ref_enc, params, port = _encoders("hgt", 0)
    port_g, ref_g = _graphs()
    want = _ref_encode_full(ref_enc, params, ref_g)
    monkeypatch.setattr(hetero_convs, "_gelu",
                        lambda x: torch.nn.functional.gelu(x))
    with torch.inference_mode():
        got = port.encode_full(*_full_inputs(port_g))
    err = max(float(np.abs(got[nt].numpy() - np.asarray(want[nt])).max()
                    / np.abs(np.asarray(want[nt])).max())
              for nt in NODE_TYPES)
    assert err > 10 * TOL


# -- encoders and the entry points ----------------------------------------------
@pytest.mark.parametrize("conv,num_bases", CONVS)
def test_encoder_forward_and_encode_full_match_jax(conv, num_bases):
    ref_enc, params, port = _encoders(conv, num_bases)
    port_g, ref_g = _graphs()
    want = _ref_encode_full(ref_enc, params, ref_g)
    feats, edges, nn_ = _full_inputs(port_g)
    # inference's segments leave out the indexes only a gradient walks:
    # of the relations' pairs they keep the destination index (K10's walk)
    fwd_only = port.segments(edges, nn_, backward=False)
    assert fwd_only.src_index == {}
    assert all(d_ is not None and s_ is None
               for d_, s_ in fwd_only.rel.values())
    assert port.segments(edges, nn_).src_index
    with torch.inference_mode():
        got = port.encode_full(feats, edges, nn_)
        got_fwd_only = port.encode_full(feats, edges, nn_,
                                        segments=fwd_only)
    for nt in NODE_TYPES:
        _close(got[nt], want[nt])
        assert torch.equal(got_fwd_only[nt], got[nt])
    paths, ref_paths = _yaml_paths()
    dg = HeteroDeviceGraph.from_hetero(port_g, paths, device="cpu")
    rdg = RefHeteroDeviceGraph.from_hetero(ref_g, ref_paths)
    roots = np.arange(0, P, 7, dtype=np.int32)
    for nt in ("paper", "author"):
        def ref_fwd(p_, g_, r_, nt=nt):
            blocks = g_.sample(r_, nt, ref_paths[nt], seed=1)
            return ref_enc.apply(p_, blocks, g_.hydrate(blocks)[0])

        want = jax.jit(ref_fwd)(params, rdg, jnp.asarray(
            roots % (A if nt == "author" else P)))
        pb = dg.sample(torch.from_numpy(roots % (A if nt == "author"
                                                 else P)),
                       nt, paths[nt], seed=1)
        pf, _ = dg.hydrate(pb)
        with torch.inference_mode():
            got = port(pb, pf)
        _close(got, want)


class _Sink:
    def __init__(self):
        self.ids, self.embs = [], []

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb, np.float32))

    def flush(self):
        pass

    def table(self):
        ids = np.concatenate(self.ids)
        return np.concatenate(self.embs)[np.argsort(ids)], np.sort(ids)


@pytest.mark.parametrize("conv,num_bases", CONVS)
def test_run_full_graph_inference_hetero_matches_jax(conv, num_bases):
    ref_enc, params, port = _encoders(conv, num_bases)
    port_g, ref_g = _graphs()
    ref_sinks = {nt: _Sink() for nt in NODE_TYPES}
    sinks = {nt: _Sink() for nt in NODE_TYPES}
    want = ref_run_hetero(ref_enc, params, ref_g, ref_sinks)
    got = run_full_graph_inference_hetero(
        port, params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
        port_g, sinks, device="cpu")
    assert got == want == {"author": A, "paper": P}
    for nt in NODE_TYPES:
        g_emb, g_ids = sinks[nt].table()
        w_emb, w_ids = ref_sinks[nt].table()
        np.testing.assert_array_equal(g_ids, w_ids)
        _close(g_emb, w_emb)
    with pytest.raises(ValueError, match="unknown node type"):
        run_full_graph_inference_hetero(port, None, port_g, {},
                                        node_types=("venue",), device="cpu")


@pytest.mark.parametrize("tabularized", [False, True])
def test_encode_batch_matches_jax(tabularized):
    port_g, ref_g = _graphs()
    paths, ref_paths = _yaml_paths()
    ref_enc, enc_params = _ref_encoder("hgt", 0)
    params = {"params": {"encoder": enc_params["params"]}}
    cfg = dict(anchor_node_type="paper", candidate_node_type="author",
               seed=3, tabularized=tabularized)
    ref_tr = RefTrainer(RefHeteroLP(encoder=ref_enc, decoder=RefDecoder()),
                        RefHeteroDeviceGraph.from_hetero(ref_g, ref_paths),
                        ref_paths, RefTrainerConfig(**cfg))
    model = HeteroLinkPredictionGNN(
        HeteroGNNEncoder(HID, OUT, NODE_TYPES, EDGE_TYPES, DIMS,
                         heads=HEADS), LinkPredictionDecoder())
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    tr = HeteroNALPTrainer(model, HeteroDeviceGraph.from_hetero(
        port_g, paths, device="cpu"), paths, HeteroNALPTrainerConfig(**cfg),
        device="cpu")
    for nt, n in (("paper", P), ("author", A)):
        ids = np.arange(n, dtype=np.int32)
        want = ref_tr.encode_batch(params, ids, nt)
        got = tr.encode_batch(ids, nt)
        assert got.shape == (n, OUT)
        _close(got, want)
    if tabularized:
        for k, v in tr.graph.sample_tables.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(ref_tr.graph.sample_tables[k]))


def test_encoder_from_config_and_init_params():
    args = yaml.safe_load(YAML.read_text())["trainer"]["trainer_args"]
    enc = hetero_encoder_from_config(args, NODE_TYPES, EDGE_TYPES,
                                     {"author": 128, "paper": 128})
    assert (enc.conv, len(enc.convs), enc.convs[0].heads) == ("hgt", 2, 4)
    assert enc.out_proj.out_features == 64 and enc.final_linear
    assert not enc.l2_normalize_output and enc.dtype == torch.float32
    init_params(enc, 0)
    conv = enc.convs[0]
    h, dk = 4, 32
    for et in EDGE_TYPES:
        for p in ("watt", "wmsg"):
            w = conv._get(p, et).detach().double()
            limit = np.sqrt(6.0 / (2 * h * dk))   # flax fans: h*dk each
            assert float(w.abs().max()) <= limit
            assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.05 * limit
        assert torch.equal(conv._get("prior", et), torch.ones(h))
    for nt in NODE_TYPES:
        assert torch.equal(conv._get("skip", nt), torch.ones(1))
        w = conv._get("k", nt).weight.detach().double()
        assert abs(float(w.std()) - np.sqrt(1 / 128)) < 0.05 * np.sqrt(
            1 / 128)
        assert not conv._get("k", nt).bias.any()
    hgn = HeteroGNNEncoder(HID, OUT, NODE_TYPES, EDGE_TYPES, DIMS,
                           conv="simple_hgn", heads=4)
    rg = HeteroGNNEncoder(HID, OUT, NODE_TYPES, EDGE_TYPES, DIMS,
                          conv="rgcn", num_bases=2)
    init_params(hgn, 1)
    init_params(rg, 1)
    c = hgn.convs[0].requires_grad_(False)
    assert abs(float(c.edge_emb.std()) - 0.02) < 0.01
    assert float(c.att_src.abs().max()) <= np.sqrt(6.0 / (4 + 4))
    assert float(c.w_rel.abs().max()) <= np.sqrt(6.0 / (16 + HID))
    coeff = rg.convs[0].basis_coeff.detach()
    assert coeff.shape == (3, 2) and float(coeff.abs().max()) <= np.sqrt(
        6.0 / 5)
