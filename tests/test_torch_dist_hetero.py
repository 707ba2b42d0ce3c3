"""The port's typed partitioned trainer (gigl_tpu_torch.training.
dist_hetero: PartitionedHeteroGraph, PartitionedHeteroNALPTrainer) and the
typed run_partitioned_inference against the JAX reference on the virtual
CPU mesh, on the CPU, where every kernel runs its plain twin.

The graph is the DBLP yaml's shape at a small size
(tests/test_torch_hetero_training.py: 40 authors with 6 features, 80
papers with 10, writes / rev_writes / cites, the yaml's message-passing
paths), papers anchored on ``author-writes-paper``'s dst, authors as
candidates (bipartite anchor and candidate types), 150 hard-negative
edges; HGT (2 heads) and RGCN (2 bases), hidden 16, out 8; batch 16, 24
random negatives, 4 shards (and 1), capacity factor 8. The label-edge
case gives the supervision and hard-negative edges 3 features and the
model an EdgeFeatureScorer of hidden 8
(tests/test_torch_label_edge_features.py); the weighted case samples the
papers' first hop weighted and the authors' top-k over [E, 2] edge
features.

Tolerances: the partitioned graph's blocks, weights, label-edge rows and
sample tables BIT-EQUAL to the reference's; the routed typed trees
BIT-EQUAL to the port's replicated draws (held bit-equal to the
reference's in tests/test_torch_hetero.py); the overflow counts EQUAL.
3-step fp32 trajectories within 1e-5 relative (the same math, sums in
another order, through Adam); evaluate's metrics within 1e-6 absolute;
encode_batch and the exported rows of run_partitioned_inference within
1e-5 of the embeddings' scale.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from gigl_tpu.inference.inferencer import (
    InferenceConfig as JaxInferenceConfig,
    run_partitioned_inference as jax_run_partitioned_inference,
)
from gigl_tpu.models.hetero_encoders import HeteroGNNEncoder as RefEncoder
from gigl_tpu.models.link_prediction import (
    EdgeFeatureScorer as RefScorer,
    HeteroLinkPredictionGNN as RefHeteroLP,
    LinkPredictionDecoder as RefDecoder,
)
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training.dist_hetero import (
    PartitionedHeteroGraph as RefPartitionedHeteroGraph,
    PartitionedHeteroNALPTrainer as RefPartitionedHeteroTrainer,
)
from gigl_tpu.training.hetero_dataset import (
    HeteroDeviceGraph as RefHeteroDeviceGraph,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainerConfig as RefConfig,
)
from gigl_tpu.types.graph import EdgeType as RefEdgeType
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.inference.inferencer import (
    InferenceConfig,
    run_partitioned_inference,
)
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    EdgeFeatureScorer,
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dist_hetero import (
    PartitionedHeteroGraph,
    PartitionedHeteroNALPTrainer,
)
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import HeteroNALPTrainerConfig
from gigl_tpu_torch.types.graph import EdgeType
from tests.test_torch_hetero_training import (
    A,
    DBLP_CFG,
    DBLP_OPT,
    DIMS,
    EDGE_TYPES,
    NODE_TYPES,
    P as PAPERS,
    WRITES,
    _dblp_graphs,
    _yaml_paths,
)
from tests.test_torch_label_edge_features import DS, _typed_graphs

torch.set_num_threads(1)

B, STEPS = 16, 3
WEIGHTED_OPS = {"authors": "weighted", "papers": "top_k"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    """(reference HeteroDeviceGraph, port HeteroDeviceGraph, reference
    paths, port paths) of the DBLP-shaped toy: ``plain`` (hard negatives),
    ``label_edges`` (their features too) or ``weighted``."""
    if kind == "label_edges":
        return _typed_graphs()
    port_g, ref_g, edges, hard = _dblp_graphs()
    paths, ref_paths = _yaml_paths()
    if kind == "weighted":
        rng = np.random.default_rng(11)
        for et, coo in port_g.edges.items():
            ef = np.stack([rng.integers(0, 3, coo.shape[1]),
                           rng.random(coo.shape[1])], 1).astype(np.float32)
            port_g.edge_features[str(et)] = ef
            ref_g.edge_features[str(et)] = ef

        def weigh(ps):
            return {nt: tuple(dataclasses.replace(
                op, method=WEIGHTED_OPS.get(op.name, op.method))
                for op in ops) for nt, ops in ps.items()}

        paths, ref_paths = weigh(paths), weigh(ref_paths)
    sup = dict(supervision_edges=edges[WRITES], hard_neg_edges=hard,
               supervision_anchor="dst")
    rdg = RefHeteroDeviceGraph.from_hetero(
        ref_g, ref_paths, supervision_edge_type=RefEdgeType.from_str(WRITES),
        **sup)
    dg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        device="cpu", **sup)
    return rdg, dg, ref_paths, paths


def _built(kind, num_shards, tabularized=False, seed=2):
    """(reference, port) partitioned graphs."""
    rdg, dg, ref_paths, paths = _graphs(kind)
    jm, mesh = jax_make_mesh(num_shards), Mesh(num_shards, "cpu")
    rpg = RefPartitionedHeteroGraph.build(rdg, ref_paths, jm,
                                          anchor_node_type="paper")
    pg = PartitionedHeteroGraph.build(dg, paths, mesh,
                                      anchor_node_type="paper")
    if tabularized:
        rpg = rpg.with_sample_tables(rdg, ref_paths, jm, seed=seed)
        pg = pg.with_sample_tables(dg, paths, mesh, seed=seed)
    return rpg, pg, jm, mesh


def _conv_kw(conv):
    return dict(num_bases=2) if conv == "rgcn" else dict(heads=2)


def _pair(conv="hgt", kind="plain", num_shards=4, tabularized=False,
          capacity_factor=8.0, overflow_policy="silent", **cfg):
    """A reference and a port typed partitioned trainer over the same
    graph from the same params: (ref trainer, ref state, port trainer,
    port state)."""
    kw = {**DBLP_CFG, "tabularized": tabularized, **cfg}
    rpg, pg, jm, mesh = _built(kind, num_shards, tabularized, kw["seed"])
    _, _, ref_paths, paths = _graphs(kind)
    scorer = kind == "label_edges"
    rt = RefPartitionedHeteroTrainer(
        RefHeteroLP(encoder=RefEncoder(
            hid_dim=16, out_dim=8, num_layers=2, conv=conv,
            node_types=NODE_TYPES, edge_types=EDGE_TYPES, **_conv_kw(conv)),
            decoder=RefDecoder(),
            edge_scorer=RefScorer(hidden_dim=8) if scorer else None),
        rpg, ref_paths, RefConfig(**kw), jm, optimizer_args=DBLP_OPT,
        capacity_factor=capacity_factor, overflow_policy=overflow_policy)
    js = rt.init_state(jax.random.PRNGKey(1), batch_size=B)
    pt = PartitionedHeteroNALPTrainer(
        HeteroLinkPredictionGNN(
            HeteroGNNEncoder(16, 8, NODE_TYPES, EDGE_TYPES, DIMS, conv=conv,
                             **_conv_kw(conv)), LinkPredictionDecoder(),
            EdgeFeatureScorer(DS, hidden_dim=8) if scorer else None),
        pg, paths, HeteroNALPTrainerConfig(**kw), mesh,
        optimizer_args=DBLP_OPT, capacity_factor=capacity_factor,
        overflow_policy=overflow_policy)
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return rt, js, pt, ps


def _anchors(k, seed=1):
    return np.random.default_rng(seed).integers(0, PAPERS, (k, B)).astype(
        np.int32)


# -- the partitioned graph ---------------------------------------------------------------
@pytest.mark.parametrize("kind", ["plain", "label_edges", "weighted"])
@pytest.mark.parametrize("num_shards", [4, 1])
def test_partitioned_hetero_graph_bit_equal(kind, num_shards):
    rpg, pg, _, _ = _built(kind, num_shards)
    assert pg.rows == rpg.rows and pg.feat_dims == rpg.feat_dims
    assert pg.num_nodes == rpg.num_nodes and pg.num_shards == num_shards
    for nt, f in pg.feats.items():
        np.testing.assert_array_equal(torch.cat(f).numpy(),
                                      np.asarray(rpg.feats[nt]))
    assert sorted(pg.csr_ip) == sorted(rpg.csr_ip)
    for key in pg.csr_ip:
        for mine, ref in ((pg.csr_ip, rpg.csr_ip), (pg.csr_ix, rpg.csr_ix)):
            np.testing.assert_array_equal(torch.stack(mine[key]).numpy(),
                                          np.asarray(ref[key]), err_msg=key)
    assert sorted(pg.csr_w or {}) == sorted(rpg.csr_w or {})
    if kind == "weighted":
        assert pg.csr_w
    for key, w in (pg.csr_w or {}).items():
        np.testing.assert_array_equal(torch.stack(w).numpy(),
                                      np.asarray(rpg.csr_w[key]))
    for name in ("sup_ip", "sup_ix", "hard_ip", "hard_ix", "sup_ef",
                 "hard_ef"):
        mine, ref = getattr(pg, name), getattr(rpg, name)
        assert (mine is None) == (ref is None), name
        if mine is not None:
            g = torch.stack(mine).numpy()
            assert g.dtype == np.asarray(ref).dtype
            np.testing.assert_array_equal(g, np.asarray(ref), err_msg=name)
    assert (pg.sup_ef is not None) == (kind == "label_edges")


@pytest.mark.parametrize("kind", ["plain", "weighted"])
def test_sample_tables_bit_equal_and_refresh(kind):
    rpg, pg, _, _ = _built(kind, 4, tabularized=True, seed=5)
    assert sorted(pg.sample_tables) == sorted(rpg.sample_tables)
    for key, t in pg.sample_tables.items():
        np.testing.assert_array_equal(torch.cat(t).numpy(),
                                      np.asarray(rpg.sample_tables[key]))
    rt, _, pt, _ = _pair(kind=kind, tabularized=True)
    rdg, dg, _, _ = _graphs(kind)
    before = {k: torch.cat(v) for k, v in pt.pg.sample_tables.items()}
    rt.refresh_tables(rdg, epoch=1)
    pt.refresh_tables(dg, epoch=1)
    assert any(not torch.equal(before[k], torch.cat(v))
               for k, v in pt.pg.sample_tables.items())
    for key, t in pt.pg.sample_tables.items():
        np.testing.assert_array_equal(torch.cat(t).numpy(),
                                      np.asarray(rt.pg.sample_tables[key]))


@pytest.mark.parametrize("num_shards", [4, 1])
def test_features_on_device_false_builds_the_topology(num_shards):
    """Both typed graphs built with host-resident features: the
    HeteroDeviceGraph keeps each type's table as the host array (dims
    intact), and the partitioned graph uploads none; their CSRs, label
    CSRs, sample tables and feat_dims bit-equal to the device-feature
    build's (and to the reference's host-feature build)."""
    rdg, dg, ref_paths, paths = _graphs("plain")
    _, _, edges, hard = _dblp_graphs()
    port_g = _dblp_graphs()[0]
    hdg = HeteroDeviceGraph.from_hetero(
        port_g, paths, supervision_edge_type=EdgeType.from_str(WRITES),
        supervision_edges=edges[WRITES], hard_neg_edges=hard,
        supervision_anchor="dst", features_on_device=False, device="cpu")
    assert not hdg.features_on_device and dg.features_on_device
    assert hdg.device == dg.device
    for nt, f in dg.node_features.items():
        assert isinstance(hdg.node_features[nt], np.ndarray)
        np.testing.assert_array_equal(hdg.node_features[nt], f.numpy())
    for key, csr in dg.csrs.items():
        assert torch.equal(hdg.csrs[key].indptr, csr.indptr)
        assert torch.equal(hdg.csrs[key].indices, csr.indices)
    mesh, jm = Mesh(num_shards, "cpu"), jax_make_mesh(num_shards)
    want = PartitionedHeteroGraph.build(dg, paths, mesh,
                                        anchor_node_type="paper"
                                        ).with_sample_tables(dg, paths, mesh)
    ref = RefPartitionedHeteroGraph.build(rdg, ref_paths, jm,
                                          anchor_node_type="paper",
                                          features_on_device=False)
    for src in (dg, hdg):
        got = PartitionedHeteroGraph.build(
            src, paths, mesh, anchor_node_type="paper",
            features_on_device=False).with_sample_tables(hdg, paths, mesh)
        assert got.feats is None and ref.feats == {}
        assert got.feat_dims == want.feat_dims == ref.feat_dims
        assert got.rows == want.rows and got.num_shards == num_shards
        assert got.device == want.device
        for name in ("csr_ip", "csr_ix", "sample_tables"):
            mine, theirs = getattr(got, name), getattr(want, name)
            assert sorted(mine) == sorted(theirs), name
            for key in mine:
                assert all(torch.equal(a, b) for a, b in zip(
                    mine[key], theirs[key])), (name, key)
        for name in ("sup_ip", "sup_ix", "hard_ip", "hard_ix"):
            assert all(torch.equal(a, b) for a, b in zip(
                getattr(got, name), getattr(want, name))), name
            np.testing.assert_array_equal(
                torch.stack(getattr(got, name)).numpy(),
                np.asarray(getattr(ref, name)), err_msg=name)


def test_host_feature_graphs_refuse_device_reads():
    """Reading the device features of a graph built without them raises
    with a clear message, never reads the host arrays."""
    _, _, _, paths = _graphs("plain")
    hdg = HeteroDeviceGraph.from_hetero(_dblp_graphs()[0], paths,
                                        features_on_device=False,
                                        device="cpu")
    with pytest.raises(ValueError, match="features_on_device=False"):
        hdg.device_features("paper")
    blocks = hdg.sample(torch.arange(4, dtype=torch.int32), "paper",
                        paths["paper"], seed=1)
    with pytest.raises(ValueError, match="host-resident"):
        hdg.hydrate(blocks)
    mesh = Mesh(4, "cpu")
    pg = PartitionedHeteroGraph.build(hdg, paths, mesh,
                                      anchor_node_type="paper",
                                      features_on_device=False)
    with pytest.raises(ValueError, match="features_on_device=False"):
        pg.device_feats("paper")
    pt = PartitionedHeteroNALPTrainer(
        HeteroLinkPredictionGNN(HeteroGNNEncoder(
            16, 8, NODE_TYPES, EDGE_TYPES, DIMS, heads=2),
            LinkPredictionDecoder()), pg, paths,
        HeteroNALPTrainerConfig(**DBLP_CFG), mesh)
    with pytest.raises(ValueError, match="StreamingPartitionedHetero"):
        pt.encode_batch(np.arange(8))


# -- the routed typed trees ----------------------------------------------------------------
@pytest.mark.parametrize("kind,tabularized", [
    ("plain", False), ("plain", True), ("weighted", False)],
    ids=["live", "tabularized", "weighted_live"])
@pytest.mark.parametrize("num_shards", [4, 1])
def test_routed_trees_are_the_replicated_draws(kind, tabularized,
                                               num_shards):
    """Each node type's routed tree over every shard's roots, bit-equal to
    the replicated graph's draw (live: sample_typed_blocks, keyed by global
    id; tabularized: the replicated frozen tables)."""
    _, pg, _, mesh = _built(kind, num_shards, tabularized, seed=4)
    _, dg, _, paths = _graphs(kind)
    cfg = HeteroNALPTrainerConfig(**{**DBLP_CFG, "tabularized": tabularized})
    pt = PartitionedHeteroNALPTrainer(
        HeteroLinkPredictionGNN(HeteroGNNEncoder(
            16, 8, NODE_TYPES, EDGE_TYPES, DIMS, heads=2),
            LinkPredictionDecoder()), pg, paths, cfg, mesh,
        capacity_factor=8.0)
    rep = dg.with_sample_tables(paths, seed=4) if tabularized else dg
    for nt, n in (("paper", PAPERS), ("author", A)):
        roots = (np.arange(4 * 12, dtype=np.int32) * 7) % n
        trees, ovf = pt._sample_tree(
            list(torch.from_numpy(roots).reshape(num_shards, -1)), nt,
            cfg.seed + 1)
        assert int(ovf) == 0
        want = (rep.sample_tabularized(torch.from_numpy(roots), nt, paths[nt])
                if tabularized else
                rep.sample(torch.from_numpy(roots), nt, paths[nt],
                           seed=cfg.seed + 1))
        for lvl in range(len(paths[nt]) + 1):
            for got_l, want_l in ((torch.cat([t.node_ids[lvl] for t in trees]),
                                   want.node_ids[lvl]),
                                  (torch.cat([t.masks[lvl] for t in trees]),
                                   want.masks[lvl])):
                assert torch.equal(got_l, want_l), (nt, lvl)


# -- training --------------------------------------------------------------------------------
CONFIGS = {
    "hgt_live": dict(),
    "hgt_tabularized": dict(tabularized=True),
    "rgcn_live": dict(conv="rgcn"),
    "rgcn_tabularized": dict(conv="rgcn", tabularized=True),
    "hgt_hard": dict(num_hard_negs=2),
    "hgt_weighted_live": dict(kind="weighted"),
    "hgt_label_edges": dict(kind="label_edges", num_hard_negs=1),
    "hgt_label_edges_ring": dict(kind="label_edges", num_hard_negs=1,
                                 global_candidate_pool=True),
    "rgcn_ring_tabularized": dict(conv="rgcn", tabularized=True,
                                  global_candidate_pool=True),
    "rgcn_one_shard": dict(conv="rgcn", num_shards=1, num_hard_negs=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_matches_jax(name):
    """3 steps of both typed partitioned trainers from the same params."""
    rt, js, pt, ps = _pair(**CONFIGS[name])
    akb = _anchors(STEPS)
    js, want = rt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    assert np.isfinite(want).all() and ps.step == STEPS
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert pt.overflow_total == 0 == rt.overflow_total
    if name in ("hgt_live", "hgt_label_edges", "rgcn_ring_tabularized"):
        val = [np.arange(16, dtype=np.int32), np.arange(20, 38,
                                                        dtype=np.int32)]
        got_m = pt.evaluate(val, step=2)
        want_m = rt.evaluate(js.params, val, step=2)
        assert set(got_m) == set(want_m)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("tabularized", [False, True],
                         ids=["live", "tabularized"])
@pytest.mark.parametrize("conv", ["hgt", "rgcn"])
def test_encode_batch_both_types_matches_jax(conv, tabularized):
    rt, js, pt, _ = _pair(conv=conv, tabularized=tabularized)
    for nt, n in (("paper", PAPERS), ("author", A)):
        ids = (np.arange(n - 3, dtype=np.int32) * 3) % n   # padded to 4s
        _close(pt.encode_batch(ids, nt),
               rt.encode_batch(js.params, ids, nt))
    _close(pt.encode_batch(np.arange(8)), rt.encode_batch(js.params,
                                                          np.arange(8)))


def test_grow_policy_overflow_counts_match_jax():
    """Skewed anchors at a tiny capacity: both trainers drop the same
    requests, grow the capacity alike and train on at the larger one."""
    rt, js, pt, ps = _pair(capacity_factor=0.05, overflow_policy="grow")
    akb = np.zeros((1, B), np.int32)
    js, want = rt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    assert pt.overflow_total == rt.overflow_total > 0
    assert pt.capacity_factor == rt.capacity_factor == 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    js, want = rt.train_steps(js, akb, jax.random.PRNGKey(2))
    ps, got = pt.train_steps(ps, akb)
    assert pt.overflow_total == rt.overflow_total
    assert pt.capacity_factor == rt.capacity_factor
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_fit_matches_jax():
    """The shared fit loop over the typed partitioned trainer (val cadence
    and early stopping): the same final val metrics as the reference's."""
    rt, js, pt, ps = _pair(conv="rgcn")
    papers = np.arange(PAPERS)
    kw = dict(batch_size=B, num_epochs=2, val_every_n_batches=3,
              num_val_batches=2, early_stop_patience=3, log_every=0)
    _, want = rt.fit(js, papers, papers[:40], **kw)
    ps, got = pt.fit(ps, papers, papers[:40], **kw)
    assert set(got) == set(want) and ps.step > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    with pytest.raises(ValueError, match="divide"):
        pt.fit(ps, papers, papers[:8], batch_size=10)


def test_bad_configs_raise():
    rpg, pg, _, mesh = _built("weighted", 4)
    _, _, _, paths = _graphs("weighted")
    model = HeteroLinkPredictionGNN(HeteroGNNEncoder(
        16, 8, NODE_TYPES, EDGE_TYPES, DIMS, heads=2),
        LinkPredictionDecoder())
    cfg = HeteroNALPTrainerConfig(**DBLP_CFG)
    with pytest.raises(ValueError, match="no edge weights"):
        PartitionedHeteroNALPTrainer(model, dataclasses.replace(
            pg, csr_w=None), paths, cfg, mesh)
    with pytest.raises(ValueError, match="with_sample_tables"):
        PartitionedHeteroNALPTrainer(model, pg, paths, dataclasses.replace(
            cfg, tabularized=True), mesh)
    with pytest.raises(ValueError, match="num_random_negs"):
        PartitionedHeteroNALPTrainer(model, pg, paths, dataclasses.replace(
            cfg, num_random_negs=7), mesh)
    with pytest.raises(ValueError, match="no sampling path"):
        PartitionedHeteroNALPTrainer(model, pg, {"paper": paths["paper"]},
                                     cfg, mesh)
    with pytest.raises(ValueError, match="overflow_policy"):
        PartitionedHeteroNALPTrainer(model, pg, paths, cfg, mesh,
                                     overflow_policy="drop")
    with pytest.raises(ValueError, match="mesh"):
        PartitionedHeteroNALPTrainer(model, pg, paths, cfg, Mesh(2, "cpu"))


# -- typed partitioned inference ---------------------------------------------------------
class _Sink:
    def __init__(self):
        self.ids, self.embs, self.flushed = [], [], 0

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb))

    def flush(self):
        self.flushed += 1


@pytest.mark.parametrize("node_type,n", [("paper", PAPERS), ("author", A)])
def test_typed_run_partitioned_inference_matches_jax(node_type, n):
    """Every node of the type through each trainer's encode_batch into an
    exporter (batch 24: a padded tail), from the same params; the rows
    equal to the port's encode_batch's."""
    rt, js, pt, _ = _pair(conv="hgt", tabularized=True)
    want, got = _Sink(), _Sink()
    n_want = jax_run_partitioned_inference(
        rt, js.params, n, want, JaxInferenceConfig(batch_size=24),
        node_type=node_type)
    n_got = run_partitioned_inference(
        pt, n, got, InferenceConfig(batch_size=24), node_type=node_type,
        device="cpu")
    assert n_got == n_want == n and got.flushed == 1
    assert all(np.array_equal(a, b) for a, b in zip(got.ids, want.ids))
    g, w = np.concatenate(got.embs), np.concatenate(want.embs)
    assert g.shape == w.shape == (n, 8) and g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    ids = np.concatenate(got.ids)
    assert np.array_equal(g, pt.encode_batch(ids, node_type).numpy())
