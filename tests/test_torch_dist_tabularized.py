"""The port's tabularized partitioned layout (gigl_tpu_torch.training.
dist_sampled PartitionedGraph.with_tabularized and PartitionedNALPTrainer
(cached_hop=True)) against the JAX reference on the CPU, where K1 / K19's
row-offset modes, K3, K4, K15, K16 and the int8 modes run their plain
twins. The toy is the multi-chip dryrun's: 512 nodes, 4,096 edges, D 16
(and an odd D 13), fanouts (5, 3), GraphSAGE hidden 32, out 16, batch 64,
64 random negatives, capacity factor 8, at 1 and 4 shards, fp32 and int8
rows.

Tolerances: the frozen sample tables BIT-EQUAL to the reference's and to
the port's replicated ``DeviceGraph.with_neighbor_cache(hop_key=2,
table_fanouts=(5,))``, uniform and weighted; refresh_cache's tables
BIT-EQUAL to the reference's refresh; the overflow counts EQUAL. The fp32
cache within 1e-5 absolute and relative of the reference's (as
tests/test_dist_sampled.py holds the reference to the replicated builder;
measured: mean and sum bit-equal, gcn within 2.4e-7: ``rsqrt`` and K4's sum
against XLA's); the features and degrees of the fused rows bit-equal. The
int8 cache: values within 1 (measured equal) and scales within 1e-6
relative (measured 2.7e-7: the reference's compiled ``absmax / 127``
rounds as a multiply by the reciprocal on some rows); features, feature
scales and degrees bit-equal. The cached trainer's first-step loss, fp32
and int8, against the reference's train_steps on the same params and
anchors within 1e-5 relative (measured up to 8e-8), 3-step trajectories
within 1e-5 (the same math, sums in another order, through Adam).
"""

import numpy as np
import pytest
import torch

import jax

from gigl_tpu.graph.csr import HeteroGraph as JaxHeteroGraph
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
from gigl_tpu.training.trainer import NALPTrainerConfig as JaxConfig
from gigl_tpu_torch.convert import params_from_flax
from gigl_tpu_torch.graph.csr import HeteroGraph
from gigl_tpu_torch.models.encoders import GNNEncoder
from gigl_tpu_torch.models.link_prediction import (
    LinkPredictionDecoder,
    LinkPredictionGNN,
)
from gigl_tpu_torch.parallel.mesh import Mesh
from gigl_tpu_torch.training.dataset import DeviceGraph
from gigl_tpu_torch.training.dist_sampled import (
    PartitionedGraph,
    PartitionedNALPTrainer,
)
from gigl_tpu_torch.training.trainer import NALPTrainerConfig

torch.set_num_threads(1)

N, E, HID, OUT, B, R = 512, 4096, 32, 16, 64, 64
FANOUTS = (5, 3)
OPT = {"learning_rate": "0.01"}


def _graphs(d=16, weighted=False, seed=0):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, N, E), rng.integers(0, N, 100)])
    dst = np.concatenate([rng.integers(0, N, E), np.full(100, 9)])  # a hub
    keep = ~np.isin(dst, (5, 77))              # two nodes without in-edges
    src, dst = src[keep], dst[keep]
    kw = dict(src=src, dst=dst, num_nodes=N,
              node_features=rng.normal(size=(N, d)).astype(np.float32))
    extra = {}
    if weighted:
        kw["edge_features"] = rng.random((len(src), 2)).astype(np.float32)
        extra["sampling_weight_index"] = 0
    sup = np.stack([src, dst])
    jdg = JaxDeviceGraph.from_hetero(JaxHeteroGraph.homogeneous(**kw),
                                     supervision_edges=sup, **extra)
    dg = DeviceGraph.from_hetero(HeteroGraph.homogeneous(**kw),
                                 supervision_edges=sup, device="cpu", **extra)
    return jdg, dg


def _both(num_shards, quantize, d=16, weighted=False, **tab):
    """The reference's and the port's tabularized graphs over the same
    inputs: (jax graph, port graph, port replicated graph)."""
    jdg, dg = _graphs(d, weighted)
    jm, mesh = jax_make_mesh(num_shards), Mesh(num_shards, "cpu")
    kw = dict(fanouts=FANOUTS, capacity_factor=8.0, **tab)
    want = JaxPartitionedGraph.build(jdg, jm, quantize_features=quantize
                                     ).with_tabularized(jm, **kw)
    got = PartitionedGraph.build(dg, mesh, quantize_features=quantize
                                 ).with_tabularized(mesh, **kw)
    return want, got, dg


def _cache_parts(rows, d, quantize):
    """(features, degrees or scales, cache) columns of fused rows."""
    if not quantize:
        return rows[:, :d + 1], rows[:, d + 1:]
    return rows[:, :d], rows[:, d:2 * d]


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("d", [16, 13])
def test_sample_tables_bit_equal(num_shards, quantize, d):
    want, got, dg = _both(num_shards, quantize, d)
    assert got.cache_dim == want.cache_dim == d
    assert got.table_fanouts == want.table_fanouts == (5,)
    table = torch.cat(got.sample_tables[0]).numpy()
    assert table.dtype == np.int32 and table.shape == (N, 5)
    np.testing.assert_array_equal(table, np.asarray(want.sample_tables[0]))
    rep = dg.with_neighbor_cache(fanout=3, seed=0, hop_key=2, agg="mean",
                                 table_fanouts=(5,))
    np.testing.assert_array_equal(table, rep.sample_tables[5].numpy())
    assert (table[[5, 77]] == -1).all()


@pytest.mark.parametrize("method", ["weighted", "top_k"])
@pytest.mark.parametrize("num_shards", [1, 4])
def test_weighted_tables_and_cache(method, num_shards):
    """The weighted / top-k draws (K19's row-offset twin) over the shards'
    edge weights: tables bit-equal, the cache within 1e-5."""
    want, got, dg = _both(num_shards, False, weighted=True, method=method)
    np.testing.assert_array_equal(torch.cat(got.sample_tables[0]).numpy(),
                                  np.asarray(want.sample_tables[0]))
    np.testing.assert_allclose(torch.cat(got.feat_deg).numpy(),
                               np.asarray(want.feat_deg), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("agg", ["mean", "sum", "gcn"])
@pytest.mark.parametrize("quantize,d", [(False, 16), (True, 16),
                                        (True, 13)])
def test_cache_matches_jax(num_shards, agg, quantize, d):
    want, got, dg = _both(num_shards, quantize, d, agg=agg)
    g_rows = torch.cat(got.feat_deg).numpy()
    w_rows = np.asarray(want.feat_deg)
    assert g_rows.dtype == w_rows.dtype and g_rows.shape == w_rows.shape
    g_head, g_cache = _cache_parts(g_rows, d, quantize)
    w_head, w_cache = _cache_parts(w_rows, d, quantize)
    np.testing.assert_array_equal(g_head, w_head)
    if not quantize:
        np.testing.assert_allclose(g_cache, w_cache, rtol=1e-5, atol=1e-5)
        rep = dg.with_neighbor_cache(fanout=3, seed=0, hop_key=2, agg=agg)
        np.testing.assert_allclose(g_cache[:N], rep.nbr_cache.numpy(),
                                   rtol=1e-5, atol=1e-5)
        return
    assert np.abs(g_cache.astype(np.int32)
                  - w_cache.astype(np.int32)).max() <= 1
    g_tail = np.ascontiguousarray(g_rows[:, 2 * d:]).view(np.float32)
    w_tail = np.ascontiguousarray(w_rows[:, 2 * d:]).view(np.float32)
    np.testing.assert_array_equal(g_tail[:, [0, 2]], w_tail[:, [0, 2]])
    np.testing.assert_allclose(g_tail[:, 1], w_tail[:, 1], rtol=1e-6, atol=0)


def _pair(num_shards, quantize, d=16, pg=None, capacity_factor=8.0,
          **cfg):
    """A JAX and a port cached trainer over the same graph and params
    (``pg``: (jax, port) tabularized graphs to train over)."""
    kw = dict(fanouts=FANOUTS, num_random_negs=R, eval_ks=(1, 10),
              cached_hop=True)
    kw.update(cfg)
    jm, mesh = jax_make_mesh(num_shards), Mesh(num_shards, "cpu")
    if pg is None:
        jdg, dg = _graphs(d)
        pg = (JaxPartitionedGraph.build(jdg, jm, quantize_features=quantize),
              PartitionedGraph.build(dg, mesh, quantize_features=quantize))
    jt = JaxPartitionedNALPTrainer(
        JaxLPGNN(encoder=JaxGNNEncoder(hid_dim=HID, out_dim=OUT,
                                       dropout=0.0), decoder=JaxDecoder()),
        pg[0], jm, JaxConfig(**kw), optimizer_args=OPT,
        capacity_factor=capacity_factor, overflow_policy="silent")
    js = jt.init_state(jax.random.PRNGKey(0), batch_size=B)
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(d, HID, OUT), LinkPredictionDecoder()),
        pg[1], mesh, NALPTrainerConfig(**kw), optimizer_args=OPT,
        capacity_factor=capacity_factor, overflow_policy="silent")
    ps = pt.init_state(params=params_from_flax(
        jax.tree_util.tree_map(np.asarray, js.params)))
    return jt, js, pt, ps


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("quantize,d", [(False, 16), (True, 16),
                                        (True, 13)])
def test_cached_trainer_matches_jax(num_shards, quantize, d):
    """The cached NALP trainer (the sketch on, a hard negative): the first
    loss and a 3-step trajectory against the reference's train_steps,
    zero overflow; evaluate and encode_batch on the trained weights."""
    jt, js, pt, ps = _pair(num_shards, quantize, d, use_cms_correction=True)
    akb = np.random.default_rng(1).integers(0, N, (3, B)).astype(np.int32)
    js, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    ps, pl = pt.train_steps(ps, akb)
    jl, pl = np.asarray(jl), pl.numpy()
    assert abs(pl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pt.overflow_total == 0 == jt.overflow_total
    np.testing.assert_array_equal(ps.cms.table.numpy(),
                                  np.asarray(js.cms.table))
    batches = [np.arange(64, dtype=np.int32)]
    want = jt.evaluate(js.params, batches, step=2)
    got = pt.evaluate(batches, step=2)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, k
    ids = (np.arange(50, dtype=np.int32) * 7) % N
    w = np.asarray(jt.encode_batch(js.params, ids))
    g = pt.encode_batch(ids).numpy()
    assert g.shape == (50, OUT)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_refresh_cache_draws_the_references_new_tables():
    """refresh_cache(epoch) rebuilds from pg_base with seed + 1_299_709 *
    epoch: the tables bit-equal to the reference's refresh, not epoch 0's;
    the fp32 cache within 1e-5."""
    jt, _, pt, _ = _pair(4, False)
    t0 = torch.cat(pt.pg.sample_tables[0]).numpy()
    jt.refresh_cache(epoch=1)
    pt.refresh_cache(epoch=1)
    t1 = torch.cat(pt.pg.sample_tables[0]).numpy()
    assert t0.shape == t1.shape and (t0 != t1).any()
    np.testing.assert_array_equal(t1, np.asarray(jt.pg.sample_tables[0]))
    np.testing.assert_allclose(torch.cat(pt.pg.feat_deg).numpy(),
                               np.asarray(jt.pg.feat_deg), rtol=1e-5,
                               atol=1e-5)
    assert pt.pg_base.cache_dim == 0


def test_overflow_counts_match_jax():
    """Tables built at capacity factor 8, a trainer at 0.3: both drop the
    same table and feature requests (the int8 rows' decode masks them)."""
    want, got, _ = _both(4, True)
    jt, js, pt, ps = _pair(4, True, pg=(want, got), capacity_factor=0.3)
    akb = np.random.default_rng(4).integers(0, N, (1, B)).astype(np.int32)
    _, jl = jt.train_steps(js, akb, jax.random.PRNGKey(1))
    _, pl = pt.train_steps(ps, akb)
    assert pt.overflow_total == jt.overflow_total > 0
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_cache_build_overflow_raises_with_the_references_count(quantize):
    jdg, dg = _graphs()
    jm, mesh = jax_make_mesh(4), Mesh(4, "cpu")
    msgs = []
    for build in (
            lambda: JaxPartitionedGraph.build(
                jdg, jm, quantize_features=quantize).with_tabularized(
                    jm, fanouts=FANOUTS, capacity_factor=0.1),
            lambda: PartitionedGraph.build(
                dg, mesh, quantize_features=quantize).with_tabularized(
                    mesh, fanouts=FANOUTS, capacity_factor=0.1)):
        with pytest.raises(RuntimeError, match="dropped") as err:
            build()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_refusals():
    dg = _graphs()[1]
    mesh = Mesh(4, "cpu")
    pg = PartitionedGraph.build(dg, mesh)
    with pytest.raises(ValueError, match="not in"):
        pg.with_tabularized(mesh, fanouts=FANOUTS, agg="max")
    with pytest.raises(ValueError, match=">= 2 hops"):
        pg.with_tabularized(mesh, fanouts=(5,))
    with pytest.raises(ValueError, match="edge weights"):
        pg.with_tabularized(mesh, fanouts=FANOUTS, method="weighted")
    tab = pg.with_tabularized(mesh, fanouts=FANOUTS, capacity_factor=8.0)
    with pytest.raises(ValueError, match="already tabularized"):
        tab.with_tabularized(mesh, fanouts=FANOUTS)
    with pytest.raises(ValueError, match="mesh"):
        pg.with_tabularized(Mesh(2, "cpu"), fanouts=FANOUTS)
    model = LinkPredictionGNN(GNNEncoder(16, HID, OUT, conv="gat"),
                              LinkPredictionDecoder())
    with pytest.raises(ValueError, match="not hop-cacheable"):
        PartitionedNALPTrainer(model, pg, mesh, NALPTrainerConfig(
            fanouts=FANOUTS, num_random_negs=R, cached_hop=True))


def test_cached_trainer_keeps_a_tabularized_graph():
    """A graph tabularized beforehand is trained over as given."""
    mesh = Mesh(4, "cpu")
    tab = PartitionedGraph.build(_graphs()[1], mesh).with_tabularized(
        mesh, fanouts=FANOUTS, seed=5, capacity_factor=8.0)
    pt = PartitionedNALPTrainer(
        LinkPredictionGNN(GNNEncoder(16, HID, OUT), LinkPredictionDecoder()),
        tab, mesh, NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                                     cached_hop=True), capacity_factor=8.0)
    assert pt.pg is tab and pt.pg_base is tab
    state = pt.init_state(0)
    _, losses = pt.train_steps(state, np.arange(2 * B).reshape(2, B) % N)
    assert np.isfinite(losses.numpy()).all()
