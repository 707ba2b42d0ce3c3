"""The weighted and top-k draws on the port's sampled paths against the JAX
reference on the CPU, where every kernel runs its plain twin: NALP
training over a graph from ``from_hetero(sampling_weight_index=0)``, live
and tabularized (the sample tables and the aggregate cache through K19's
and K2's twins), ``run_inference``, node classification over the
weight-sorted graph, the typed sampler over weighted CSRs (unsorted rows,
column 0 of the edge type's features) through ``sample_typed_blocks``,
the typed tables and ``encode_batch``, and the partitioned trainer's
routed weighted draw.

Tolerances: draws and tables are bit-equal; fp32 losses over 20 NALP steps
within 1e-3 relative and the tabularized tables bit-equal, as
tests/test_torch_training.py (measured ~1e-5: the same math, sums in
another order, drifting through Adam); run_inference's embeddings within
1e-5, as tests/test_torch_inference.py; node-classification losses within
1e-4 relative, as tests/test_torch_nc_trainer.py; typed embeddings within
1e-5 of their scale, as tests/test_torch_hetero.py; the partitioned first
step within 1e-6 relative and its 3-step trajectory within rtol 1e-5, as
tests/test_torch_dist_sampled.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
from gigl_tpu.inference.inferencer import (
    InferenceConfig as JaxInferenceConfig,
    run_inference as jax_run_inference,
)
from gigl_tpu.models.encoders import GNNEncoder as JaxGNNEncoder
from gigl_tpu.models.link_prediction import (
    LinkPredictionDecoder as JaxDecoder,
    LinkPredictionGNN as JaxLPGNN,
)
from gigl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigl_tpu.training.dataset import DeviceGraph as JaxDeviceGraph
from gigl_tpu.training.dist_sampled import (
    PartitionedGraph as JaxPartitionedGraph,
    PartitionedNALPTrainer as JaxPartitionedNALPTrainer,
)
from gigl_tpu.training.hetero_dataset import (
    HeteroDeviceGraph as RefHeteroDeviceGraph,
)
from gigl_tpu.training.hetero_trainer import (
    HeteroNALPTrainer as RefHeteroTrainer,
    HeteroNALPTrainerConfig as RefHeteroConfig,
)
from gigl_tpu.models.link_prediction import (
    HeteroLinkPredictionGNN as RefHeteroLP,
)
from gigl_tpu.training.trainer import (
    NALPTrainer as JaxNALPTrainer,
    NALPTrainerConfig as JaxNALPTrainerConfig,
    NodeClassificationTrainer as JaxNCTrainer,
    NodeClassificationTrainerConfig as JaxNCConfig,
)
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.inference.inferencer import InferenceConfig, run_inference
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    HeteroLinkPredictionGNN,
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.dist_sampled import (
    PartitionedGraph,
    PartitionedNALPTrainer,
)
from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
from gigl_tpu_torch.training.hetero_trainer import (
    HeteroNALPTrainer,
    HeteroNALPTrainerConfig,
)
from gigl_tpu_torch.training.trainer import (
    NALPTrainer,
    NALPTrainerConfig,
    NodeClassificationTrainer,
    NodeClassificationTrainerConfig,
)
from tests.test_torch_hetero import (
    A,
    DIMS,
    EDGE_TYPES,
    HEADS,
    NODE_TYPES,
    OUT as TYPED_OUT,
    HID as TYPED_HID,
    _close,
    _graphs as _typed_graphs,
    _ref_encoder,
    _yaml_paths,
)
from tests.test_torch_hetero import P as PAPERS

torch.set_num_threads(1)

N, E, D, HID, OUT, B = 512, 4096, 16, 32, 16, 64
FANOUTS = (4, 3)
OPT = {"learning_rate": "0.01"}


def _arrays(seed=0, labels=False):
    """A graph whose edge features' column 0 holds the sampling weights
    (uniform in [0, 1), ogbn-proteins' association scores) and whose node
    9 is a hub of 200 in-edges."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, N, E), rng.integers(0, N, 200)])
    dst = np.concatenate([rng.integers(0, N, E), np.full(200, 9)])
    keep = ~np.isin(dst, (5, 77))           # two nodes without in-edges
    src, dst = src[keep], dst[keep]
    ef = rng.random((len(src), 2)).astype(np.float32)
    kw = dict(src=src, dst=dst, num_nodes=N,
              node_features=rng.normal(size=(N, D)).astype(np.float32),
              edge_features=ef)
    if labels:
        kw["node_labels"] = rng.integers(0, 4, N)
    return src, dst, kw


def _graphs(labels=False, supervision=True):
    src, dst, kw = _arrays(labels=labels)
    sup = {"supervision_edges": np.stack([src, dst])} if supervision else {}
    jg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(**kw),
                                    sampling_weight_index=0, **sup)
    pg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(**kw),
                                 sampling_weight_index=0, device="cpu", **sup)
    return jg, pg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nalp_pair(**cfg):
    kw = dict(fanouts=FANOUTS, num_random_negs=B, seed=3, eval_ks=(1, 10))
    kw.update(cfg)
    jg, pg = _graphs()
    jt = JaxNALPTrainer(JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID,
                                                       out_dim=OUT),
                                 decoder=JaxDecoder()),
                        jg, JaxNALPTrainerConfig(**kw), optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = NALPTrainer(LinkPredictionGNN(GNNEncoder(D, HID, OUT),
                                       LinkPredictionDecoder()),
                     pg, NALPTrainerConfig(**kw), optimizer_args=OPT,
                     device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    return jt, js, pt, ps


def _anchors(k, seed=1):
    return np.random.default_rng(seed).integers(0, N, (k, B))


@pytest.mark.parametrize("method,cached", [
    ("weighted", False), ("weighted", True), ("top_k", True)],
    ids=["weighted-live", "weighted-cached", "top_k-cached"])
def test_nalp_trajectory_matches_jax(method, cached):
    jt, js, pt, ps = _nalp_pair(sampling_method=method, cached_hop=cached,
                                fused_cache=cached)
    if cached:
        for k, v in pt.graph.sample_tables.items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jt.graph.sample_tables[k]))
        np.testing.assert_allclose(
            pt.graph.fused_table.numpy(), np.asarray(jt.graph.fused_table),
            rtol=1e-5, atol=1e-6)
    akb = _anchors(20)
    _, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.isfinite(want).all() and want[-5:].mean() < want[:5].mean()


class _Sink:
    def __init__(self):
        self.ids, self.embs = [], []

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(np.asarray(emb, np.float32))

    def flush(self):
        pass


class _JaxInferencer:
    def __init__(self, trainer, params):
        self.trainer, self.params = trainer, params

    def infer_batch(self, ids):
        return self.trainer.encode_batch(self.params, ids)


@pytest.mark.parametrize("method,cached", [("top_k", True),
                                           ("weighted", False)])
def test_run_inference_matches_jax(method, cached):
    jt, js, pt, _ = _nalp_pair(sampling_method=method, cached_hop=cached,
                               fused_cache=cached)
    jsink, psink = _Sink(), _Sink()
    jax_run_inference(_JaxInferencer(jt, js.params), N, jsink,
                      JaxInferenceConfig(batch_size=B))
    run_inference(pt, N, psink, InferenceConfig(batch_size=B),
                  device="cpu")
    np.testing.assert_array_equal(np.concatenate(psink.ids),
                                  np.concatenate(jsink.ids))
    got = np.concatenate(psink.embs)
    np.testing.assert_allclose(got, np.concatenate(jsink.embs), rtol=1e-5,
                               atol=1e-5)
    # the export is encode_batch's
    ids = np.concatenate(psink.ids)[:B]
    np.testing.assert_array_equal(
        got[:B], pt.encode_batch(ids).detach().numpy())


def test_node_classification_steps_match_jax():
    """The reference's node-classification trainer samples uniformly over
    the weight-sorted CSR; the port does the same."""
    jg, pg = _graphs(labels=True, supervision=False)
    cfg = dict(fanouts=FANOUTS, seed=2, sampling_method="weighted")
    jt = JaxNCTrainer(JaxGNNEncoder(hid_dim=HID, out_dim=4), jg,
                      JaxNCConfig(**cfg), optimizer_args=OPT)
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=32)
    pt = NodeClassificationTrainer(GNNEncoder(D, HID, 4), pg,
                                   NodeClassificationTrainerConfig(**cfg),
                                   optimizer_args=OPT, device="cpu")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    nodes = np.random.default_rng(4).integers(0, N, (5, 32))
    for k in range(5):
        js, want = jt._train_step(jt.graph, js,
                                  jnp.asarray(nodes[k], jnp.int32),
                                  jax.random.PRNGKey(k))
        ps, got = pt.train_step(ps, nodes[k])
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def _weighted_typed(method):
    """The DBLP-shaped toy with every op weighted (or top-k) and every edge
    type carrying [E, 2] features; column 0 are the weights, with ties."""
    port_g, ref_g = _typed_graphs()
    rng = np.random.default_rng(11)
    for et, coo in port_g.edges.items():
        ef = np.stack([rng.integers(0, 3, coo.shape[1]),
                       rng.random(coo.shape[1])], 1).astype(np.float32)
        port_g.edge_features[str(et)] = ef
        ref_g.edge_features[str(et)] = ef
    paths, ref_paths = _yaml_paths()
    paths = {nt: tuple(dataclasses.replace(op, method=method) for op in ops)
             for nt, ops in paths.items()}
    ref_paths = {nt: tuple(dataclasses.replace(op, method=method)
                           for op in ops) for nt, ops in ref_paths.items()}
    return port_g, ref_g, paths, ref_paths


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_typed_weighted_draws_tables_and_encode_batch(method):
    port_g, ref_g, paths, ref_paths = _weighted_typed(method)
    dg = HeteroDeviceGraph.from_hetero(port_g, paths, device="cpu")
    rdg = RefHeteroDeviceGraph.from_hetero(ref_g, ref_paths)
    for key, csr in dg.csrs.items():   # column 0, rows NOT sorted
        np.testing.assert_array_equal(csr.edge_weights.numpy(),
                                      np.asarray(rdg.csrs[key].edge_weights))
        np.testing.assert_array_equal(csr.indices.numpy(),
                                      np.asarray(rdg.csrs[key].indices))
    roots = {"paper": np.array([3, 7, 0, 11, PAPERS - 1, 3], np.int32),
             "author": np.array([0, 5, A - 1, 5, 12], np.int32)}
    for nt in NODE_TYPES:
        got = dg.sample(torch.from_numpy(roots[nt]), nt, paths[nt], seed=4)
        want = jax.jit(lambda g, r: g.sample(r, nt, ref_paths[nt], seed=4))(
            rdg, jnp.asarray(roots[nt]))
        for g, w in zip(got.node_ids + got.masks,
                        want.node_ids + want.masks):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dg_t = dg.with_sample_tables(paths, seed=1)
    rdg_t = rdg.with_sample_tables(ref_paths, seed=1)
    assert sorted(dg_t.sample_tables) == sorted(rdg_t.sample_tables)
    for k, v in dg_t.sample_tables.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(rdg_t.sample_tables[k]))
    ref_enc, enc_params = _ref_encoder("hgt", 0)
    params = {"params": {"encoder": enc_params["params"]}}
    model = HeteroLinkPredictionGNN(
        HeteroGNNEncoder(TYPED_HID, TYPED_OUT, NODE_TYPES, EDGE_TYPES, DIMS,
                         heads=HEADS), LinkPredictionDecoder())
    model.load_state_dict(params_from_flax(_np(params)))
    for tabularized in (False, True):
        cfg = dict(anchor_node_type="paper", candidate_node_type="author",
                   seed=3, tabularized=tabularized)
        ref_tr = RefHeteroTrainer(
            RefHeteroLP(encoder=ref_enc, decoder=JaxDecoder()), rdg,
            ref_paths, RefHeteroConfig(**cfg))
        tr = HeteroNALPTrainer(model, dg, paths,
                               HeteroNALPTrainerConfig(**cfg), device="cpu")
        for nt, n in (("paper", PAPERS), ("author", A)):
            ids = np.arange(n, dtype=np.int32)
            _close(tr.encode_batch(ids, nt),
                   ref_tr.encode_batch(params, ids, nt))


@pytest.mark.parametrize("method", ["weighted", "top_k"])
def test_partitioned_weighted_steps_match_jax(method):
    """Four shards, the per-shard weights [P, E_pad] zero-padded, the
    owner-side draw K19's row-offset twin."""
    jg, pg = _graphs()
    kw = dict(fanouts=FANOUTS, num_random_negs=B, eval_ks=(1, 10),
              sampling_method=method)
    jm = jax_make_mesh(4)
    jpg = JaxPartitionedGraph.build(jg, jm)
    jt = JaxPartitionedNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT,
                                       dropout=0.0), decoder=JaxDecoder()),
        jpg, jm, JaxNALPTrainerConfig(**kw), optimizer_args=OPT,
        capacity_factor=8.0, overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    mesh = Mesh(4, "cpu")
    ppg = PartitionedGraph.build(pg, mesh)
    np.testing.assert_array_equal(torch.stack(ppg.msg_weights).numpy(),
                                  np.asarray(jpg.msg_weights))
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(D, HID, OUT), LinkPredictionDecoder()),
        ppg, mesh, NALPTrainerConfig(**kw), optimizer_args=OPT,
        capacity_factor=8.0, overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(_np(js.params)))
    akb = _anchors(3).astype(np.int32)
    _, want = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, got = pt.train_steps(ps, akb)
    want = np.asarray(want)
    assert abs(got.numpy()[0] - want[0]) <= 1e-6 * abs(want[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert pt.overflow_total == 0 == jt.overflow_total
